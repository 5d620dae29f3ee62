"""The port's thin client (client/, copies of the JAX package's under the
rename rule, and init()'s ray:// branch) on the CPU.

The proxy runs in this process, a driver of the module's cluster
(ray_tpu_torch.init(num_cpus=4)); each thin client is a separate process
that imports ray_tpu_torch only and reaches the cluster through the
proxy's one socket. Mirrors of tests/test_client_mode.py's three cases,
and a parity case: through the proxy, an actor holds the port's TINY
Transformer in f32, loaded by params_from_jax from the JAX package's
parameters (numpy, saved by this process), and its logits agree with the
JAX package's Transformer.apply on the same tokens within 1e-5.
"""

import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.client import ClientProxyServer, connect
from ray_tpu_torch.util import state as state_api

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CLIENT_SCRIPT = """
import ray_tpu_torch

# decorated BEFORE init: client-vs-direct routing resolves at call time
@ray_tpu_torch.remote
def double(x):
    return x * 2

ray_tpu_torch.init("ray://127.0.0.1:{port}")
assert ray_tpu_torch.is_initialized()

# tasks, and client refs nested in arguments
ref = double.remote(21)
assert ray_tpu_torch.get(ref) == 42
ref2 = double.remote(5)
@ray_tpu_torch.remote
def add_refs(refs):
    return sum(ray_tpu_torch.get(refs))
assert ray_tpu_torch.get(add_refs.remote([ref, ref2])) == 52

# put / wait
p = ray_tpu_torch.put("hello")
ready, rest = ray_tpu_torch.wait([p], num_returns=1, timeout=30)
assert len(ready) == 1 and not rest
assert ray_tpu_torch.get(ready[0]) == "hello"

# actors
@ray_tpu_torch.remote
class Counter:
    def __init__(self, start):
        self.v = start
    def incr(self, by=1):
        self.v += by
        return self.v

c = Counter.options(num_cpus=0.1).remote(10)
assert ray_tpu_torch.get(c.incr.remote()) == 11
assert ray_tpu_torch.get(c.incr.remote(by=5)) == 16
ray_tpu_torch.kill(c)

# refs nested inside user objects survive the proxy boundary
class Box:
    def __init__(self, ref):
        self.ref = ref

@ray_tpu_torch.remote
def open_box(box):
    return ray_tpu_torch.get(box.ref) + 1

assert ray_tpu_torch.get(open_box.remote(Box(ray_tpu_torch.put(41)))) == 42

# dynamic generator returns: the handle resolves to client refs
@ray_tpu_torch.remote(num_returns="dynamic")
def gen(n):
    for i in range(n):
        yield i * 10

refs = ray_tpu_torch.get(gen.remote(3))
assert [ray_tpu_torch.get(r) for r in refs] == [0, 10, 20]
ray_tpu_torch.shutdown()
import sys
assert not any(m.split(".")[0] in ("jax", "ray_tpu") for m in sys.modules)
print("CLIENT_OK")
"""

# the parity client: an actor on the cluster holds the port's TINY f32
# model, loaded from the JAX package's parameters (numpy); the client
# writes the logits it gets back
PARITY_SCRIPT = """
import pickle, sys
import numpy as np
import ray_tpu_torch

class Holder:
    def __init__(self, path):
        import torch
        from ray_tpu_torch.models import TINY, Transformer
        from ray_tpu_torch.models.convert import params_from_jax
        torch.set_num_threads(1)
        with open(path, "rb") as f:
            tree = pickle.load(f)
        cfg = TINY.replace(dtype="float32")
        self.model = Transformer(cfg, device="cpu")
        self.model.load_state_dict(params_from_jax(tree, cfg, device="cpu"))

    def logits(self, tokens):
        import torch
        with torch.no_grad():
            return self.model(torch.from_numpy(tokens)).numpy()

ray_tpu_torch.init("ray://127.0.0.1:{port}")
holder = ray_tpu_torch.remote(Holder).options(num_cpus=0.1).remote({params!r})
tokens = np.load({tokens!r})
logits = ray_tpu_torch.get(holder.logits.remote(tokens), timeout=120)
assert isinstance(logits, np.ndarray), type(logits)
np.save({out!r}, logits)
ray_tpu_torch.shutdown()
assert not any(m.split(".")[0] in ("jax", "ray_tpu") for m in sys.modules)
print("PARITY_OK")
"""


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.fixture()
def proxy(cluster):
    server = ClientProxyServer(ray_tpu_torch.get_gcs_address(), port=0)
    yield server
    server.stop()


def _run_client(script, timeout=120):
    out = subprocess.run([sys.executable, "-u", "-c", script],
                         capture_output=True, text=True, timeout=timeout,
                         cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_thin_client_end_to_end(proxy):
    out = _run_client(CLIENT_SCRIPT.format(port=proxy.address[1]))
    assert "CLIENT_OK" in out


def test_client_disconnect_releases_actors(proxy):
    ctx = connect(f"127.0.0.1:{proxy.address[1]}")

    class Holder:
        def ping(self):
            return "pong"

    handle = ctx.remote(Holder, num_cpus=0.1).remote()
    assert ctx.get(handle.ping.remote()) == "pong"
    assert ctx.cluster_info()["nodes"] >= 1
    ctx.disconnect()
    deadline = time.time() + 30
    alive = True
    while time.time() < deadline and alive:
        alive = any(a["class_name"] == "Holder" and a["state"] == "ALIVE"
                    for a in state_api.list_actors())
        time.sleep(0.5)
    assert not alive, "client's actor survived disconnect"


def test_client_named_actor_lookup(proxy):
    @ray_tpu_torch.remote
    class Registry:
        def __init__(self):
            self.items = []

        def add(self, x):
            self.items.append(x)
            return len(self.items)

    direct = Registry.options(name="shared_reg", num_cpus=0.1).remote()
    assert ray_tpu_torch.get(direct.add.remote("from-cluster")) == 1
    script = f"""
import ray_tpu_torch
ray_tpu_torch.init("ray://127.0.0.1:{proxy.address[1]}")
reg = ray_tpu_torch.get_actor("shared_reg")
assert ray_tpu_torch.get(reg.add.remote("from-client")) == 2
ray_tpu_torch.shutdown()
print("NAMED_OK")
"""
    assert "NAMED_OK" in _run_client(script)
    assert ray_tpu_torch.get(direct.add.remote("x")) == 3
    ray_tpu_torch.kill(direct)


def test_client_actor_logits_match_jax(proxy, tmp_path):
    import jax

    from ray_tpu.models import TINY as JTINY
    from ray_tpu.models import Transformer as JTransformer

    jcfg = JTINY.replace(dtype="float32")
    params = jax.jit(lambda k: JTransformer.init(k, jcfg))(
        jax.random.PRNGKey(0))
    tokens = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    want = np.asarray(jax.jit(lambda p: JTransformer.apply(
        p, tokens, jcfg))(params))
    with open(tmp_path / "params.pkl", "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, params), f)
    np.save(tmp_path / "tokens.npy", tokens)
    out = _run_client(PARITY_SCRIPT.format(
        port=proxy.address[1], params=str(tmp_path / "params.pkl"),
        tokens=str(tmp_path / "tokens.npy"),
        out=str(tmp_path / "logits.npy")))
    assert "PARITY_OK" in out
    got = np.load(tmp_path / "logits.npy")
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
