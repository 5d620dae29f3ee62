"""The port's model served through the port's Serve, held against the
JAX package's Transformer.apply on the CPU.

A scoring deployment (the user code chip_smoke.py serves on the card,
here at a narrow width, f32, device="cpu"): its replica builds the
port's Transformer, loads the JAX package's init params (passed as a
numpy tree), and scores prompts in batches coalesced by @serve.batch,
right-padded to the longest, one forward each. A prompt's answer: the
sum of its next-token log-probs, the argmax after its last position and
that token's log-prob. The JAX side runs Transformer.apply on each
prompt alone in the test process and scores its logits in f64 numpy.
Answers through the handle, over HTTP through the ingress fleet and
from a compiled DAG of the same scorer equal the JAX scores within 1e-5
relative, with identical argmaxes. The config takes the flash path
("auto", head_dim 128), whose CPU path is the plain version of the CUDA
kernels. One cluster for the module (ray_tpu_torch.init(num_cpus=4)).
"""

import functools
import json
import sys
import threading
import urllib.request

import cloudpickle
import numpy as np
import pytest

import jax

import ray_tpu_torch
from ray_tpu.models import TINY as JTINY
from ray_tpu.models import Transformer as JTransformer
from ray_tpu_torch import serve
from ray_tpu_torch.models import TINY

WIDTH = dict(dtype="float32", d_model=256, n_heads=2, n_kv_heads=None,
             d_ff=512, attention_impl="auto")
LENGTHS = (17, 40, 64)
N_PROMPTS = 12
RTOL = 1e-5

# the scorer is user code of this module: it rides to the replica and
# the DAG's actor by value (the workers cannot import a test module)
cloudpickle.register_pickle_by_value(sys.modules[__name__])


def score_prompts(torch, model, prompts):
    """One forward of the prompts right-padded to the longest; each
    prompt's (logprob_sum, next_token, next_logprob)."""
    lens = [len(p) for p in prompts]
    host = np.zeros((len(prompts), max(lens)), dtype=np.int64)
    for i, p in enumerate(prompts):
        host[i, :lens[i]] = p
    with torch.inference_mode():
        tokens = torch.from_numpy(host)
        logits = model(tokens)
        logp = (logits - torch.logsumexp(logits, -1, keepdim=True)).double()
        out = []
        for i, n in enumerate(lens):
            picked = logp[i, :n - 1].gather(-1, tokens[i, 1:n, None])
            top = int(logp[i, n - 1].argmax())
            out.append({"logprob_sum": float(picked.sum()),
                        "next_token": top,
                        "next_logprob": float(logp[i, n - 1, top])})
    return out


class Scorer:
    """The served model: the port's Transformer with the JAX params."""

    def __init__(self, tree, cfg):
        import torch

        from ray_tpu_torch.models import Transformer
        torch.set_num_threads(1)
        self.model = Transformer(cfg, device="cpu")
        self.model.load_jax_params(tree)
        self.batch_sizes = []

    def score(self, prompts):
        import torch
        return score_prompts(torch, self.model, prompts)


class ServedScorer(Scorer):
    """Scorer as a class deployment: __call__ takes a prompt (or
    "stats"), its prompts coalesced by @serve.batch."""

    def __call__(self, request):
        if isinstance(request, str) and request == "stats":
            return {"batch_sizes": list(self.batch_sizes)}
        return self.batched(request)

    @serve.batch(max_batch_size=N_PROMPTS, batch_wait_timeout_s=0.2)
    def batched(self, prompts):
        self.batch_sizes.append(len(prompts))
        return self.score(prompts)


@functools.lru_cache(maxsize=None)
def _reference():
    """(numpy params, config, prompts, the JAX package's scores)."""
    jcfg = JTINY.replace(**WIDTH)
    params = JTransformer.init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, int(n)).astype(np.int64)
               for n in rng.choice(LENGTHS, N_PROMPTS)]
    apply = jax.jit(lambda p, t: JTransformer.apply(p, t, jcfg))
    want = []
    for p in prompts:
        logits = np.asarray(apply(params, p[None].astype(np.int32)),
                            np.float64)[0]
        m = logits.max(-1, keepdims=True)
        logp = logits - m - np.log(np.exp(logits - m).sum(-1,
                                                          keepdims=True))
        top = int(logp[-1].argmax())
        want.append({"logprob_sum": float(logp[np.arange(len(p) - 1),
                                               p[1:]].sum()),
                     "next_token": top,
                     "next_logprob": float(logp[-1, top])})
    tree = jax.tree.map(np.asarray, params)
    return tree, TINY.replace(**WIDTH), prompts, want


def _assert_matches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["logprob_sum"], w["logprob_sum"],
                                   rtol=RTOL)
        np.testing.assert_allclose(g["next_logprob"], w["next_logprob"],
                                   rtol=RTOL)
        assert g["next_token"] == w["next_token"]


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def handle(cluster):
    tree, cfg, _, _ = _reference()
    app = serve.deployment(name="scorer", max_concurrent_queries=16)(
        ServedScorer)
    yield serve.run(app.bind(tree, cfg))
    serve.shutdown()


def test_handle_scores_match_jax_and_batch(handle):
    _, _, prompts, want = _reference()
    got = ray_tpu_torch.get([handle.remote(p) for p in prompts],
                            timeout=120)
    _assert_matches(got, want)
    sizes = ray_tpu_torch.get(handle.remote("stats"), timeout=60)[
        "batch_sizes"]
    assert sum(sizes) >= N_PROMPTS
    assert max(sizes) > 1, f"no batching happened: {sizes}"


def test_http_scores_match_jax(handle):
    _, _, prompts, want = _reference()
    st = serve.start_fleet(http_port=0)
    port = st["proxies"][0]["http_port"]
    got = [None] * len(prompts)

    def post(i):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/scorer",
            data=json.dumps(prompts[i].tolist()).encode(),
            headers={"Content-Type": "application/json",
                     "X-Request-Id": f"scorer{i:04d}"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.headers.get("X-Request-Id") == f"scorer{i:04d}"
            got[i] = json.loads(resp.read())["result"]

    threads = [threading.Thread(target=post, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    _assert_matches(got, want)


def test_compiled_dag_scores_match_jax(cluster):
    from ray_tpu_torch.dag import InputNode
    tree, cfg, prompts, want = _reference()
    with InputNode() as inp:
        dag = ray_tpu_torch.remote(Scorer).options(num_cpus=0.1).bind(
            tree, cfg).score.bind(inp)
    compiled = dag.experimental_compile()
    try:
        got = []
        for i in range(0, len(prompts), 4):
            got += ray_tpu_torch.get(compiled.execute(prompts[i:i + 4]),
                                     timeout=120)
        assert compiled.executions == 3 and compiled.fallbacks == 0
    finally:
        compiled.teardown()
    _assert_matches(got, want)
