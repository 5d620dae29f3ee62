"""dryrun_multichip (ray_tpu_torch/entry.py) against the JAX package's
dry run (__graft_entry__.py), on the CPU.

One spawn of dryrun_multichip(4, device="cpu") (4 forked gloo ranks) on
the JAX package's own inputs: Transformer.init(PRNGKey(0|2|4)) and
jax.random.randint(PRNGKey(1|3|5)) tokens. The three variants' losses
(the sharded step's ring attention on tensor 2 x seq 2, the pipe=2
pipeline, the expert=2 MoE) against the JAX package's single-device
Transformer.loss on the same params and tokens (dense attention: the
same function), rtol 1e-5, the MoE aux term included; each prints its
"ok" line with the JAX mesh's shape.
"""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np

import jax

from ray_tpu.models import TINY as JTINY
from ray_tpu.models import Transformer as JTransformer
from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu.parallel.mesh import get_abstract_mesh as jabstract_mesh
from test_torch_entry import _reference_split

REPO = Path(__file__).resolve().parent.parent
DRYRUN_N = 4
DRYRUN_TIMEOUT_S = 240


def _jax_inputs(n):
    """The JAX dry run's configs, params and tokens for n devices."""
    seq = _reference_split(n)["seq"]
    cfgs = {"sharded": JTINY.replace(dtype="float32", attention_impl="ring"),
            "pipe": JTINY.replace(dtype="float32", attention_impl="dense",
                                  loss_chunk=0),
            "expert": JTINY.replace(dtype="float32", moe_experts=4,
                                    moe_top_k=2, loss_chunk=0)}
    shapes = {"sharded": (max(4, 2 * n), 32 * seq + 1), "pipe": (8, 33),
              "expert": (8, 33)}
    keys = {"sharded": (0, 1), "pipe": (2, 3), "expert": (4, 5)}
    out = {}
    for name, cfg in cfgs.items():
        pk, tk = keys[name]
        params = jax.tree.map(np.asarray, JTransformer.init(
            jax.random.PRNGKey(pk), cfg))
        tokens = np.asarray(jax.random.randint(
            jax.random.PRNGKey(tk), shapes[name], 0, cfg.vocab_size))
        out[name] = (cfg, params, tokens)
    return out


def test_dryrun_multichip_matches_jax_losses(tmp_path):
    jax_inputs = _jax_inputs(DRYRUN_N)
    path = tmp_path / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump({name: (params, tokens) for name, (_, params, tokens)
                     in jax_inputs.items()}, f)
    code = ("import json, pickle, sys\n"
            "from ray_tpu_torch.entry import dryrun_multichip\n"
            f"inputs = pickle.load(open({str(path)!r}, 'rb'))\n"
            f"losses = dryrun_multichip({DRYRUN_N}, device='cpu', "
            "inputs=inputs)\n"
            "print('LOSSES ' + json.dumps(losses), flush=True)\n")
    proc = subprocess.Popen(
        [sys.executable, "-c", code], cwd=REPO, text=True,
        env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        # the JAX package's single-device losses while the ranks run
        want = {}
        for name, (cfg, params, tokens) in jax_inputs.items():
            cfg = cfg.replace(attention_impl="dense")
            want[name] = float(jax.jit(lambda p, t, cfg=cfg: JTransformer.loss(
                p, {"tokens": t}, cfg))(params, tokens))
        out, _ = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
    finally:
        proc.kill()
        proc.wait()
    assert proc.returncode == 0, out[-4000:]
    lines = [line for line in out.splitlines()
             if line.startswith("dryrun_multichip(")]
    losses = json.loads(next(line for line in out.splitlines()
                             if line.startswith("LOSSES "))[len("LOSSES "):])
    assert sorted(losses) == sorted(want)
    for name in want:
        np.testing.assert_allclose(losses[name], want[name], rtol=1e-5,
                                   err_msg=name)
    half = DRYRUN_N // 2
    meshes = [JMeshConfig(**_reference_split(DRYRUN_N)),
              JMeshConfig(data=half, pipe=2), JMeshConfig(data=half, expert=2)]
    name_order = ("sharded", "pipe", "expert")
    assert lines == [
        f"dryrun_multichip({DRYRUN_N}): "
        f"mesh={dict(jabstract_mesh(mc, DRYRUN_N).shape)} "
        f"loss={losses[name]:.4f} ok"
        for mc, name in zip(meshes, name_order)]
