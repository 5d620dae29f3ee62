"""The port's sentinel (ray_tpu_torch/util/cuda_sentinel.py) against the
JAX package's (ray_tpu/util/jax_sentinel.py), on the CPU.

The watchdog probes that read the sentinel's counters are jax-free in
both packages: the same series go through both, and must give the same
alerts. The live sentinel is held to the numbers the JAX package's own
tests expect (tests/test_jax_sentinel.py): its builds are nvcc builds
(ops/_build.py) made here by a stand-in nvcc script that writes empty
libraries, and its forcing points are counted on CPU tensors by widening
`on_device` (on the card, CUDA tensors are the device's). Inputs come
from np.random.default_rng; nothing here needs a card.
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from ray_tpu._private import metrics_plane as ref_mp
from ray_tpu_torch._private import goodput
from ray_tpu_torch._private import metrics_plane as mp
from ray_tpu_torch._private import spans
from ray_tpu_torch.ops import _build
from ray_tpu_torch.util import cuda_sentinel
from ray_tpu_torch.util import metrics as um

COMPILES = "ray_tpu_jit_compiles_total"
XFER = "ray_tpu_host_transfer_bytes_total"


def _series(name):
    """{sorted-tag-tuple: value} for one metric from the process
    registry (counters accumulate across tests — assert deltas)."""
    out = {}
    for m in um.collect_wire():
        if m["name"] != name:
            continue
        for s in m["series"]:
            out[tuple(sorted(s["tags"].items()))] = s["value"]
    return out


def _flat_series():
    """collect_wire() flattened to the harvest's `name{k=v,...}` keys."""
    out = {}
    for m in um.collect_wire():
        for s in m["series"]:
            if "value" not in s:
                continue  # histogram bucket rows
            tags = ",".join(f"{k}={v}"
                            for k, v in sorted(s["tags"].items()))
            out[f"{m['name']}{{{tags}}}" if tags else m["name"]] = \
                s["value"]
    return out


def _delta(before, after, key):
    return after.get(key, 0.0) - before.get(key, 0.0)


# ---- watchdog probes: the JAX package's and the port's -----------------

def _make_watchdog(plane, events, **kw):
    kw.setdefault("jit_recompiles", 3)
    kw.setdefault("jit_recompile_warmup_s", 0.0)
    kw.setdefault("host_transfer_bytes", 100.0)
    return plane.Watchdog(
        emit=lambda et, msg, severity="INFO", **f:
            events.append((et, msg, severity, f)),
        cooldown_s=0.0, wait_edge_age_s=600.0,
        store_occupancy_frac=0.95, queue_depth=1000, **kw)


def _alerts(events, probe):
    return [(m, s, f) for _t, m, s, f in events
            if f.get("probe") == probe]


STORM = "ray_tpu_jit_compiles_total{fn=learner.update,kind=recompile}"
BYTES = "ray_tpu_host_transfer_bytes_total{region=learner.update}"
UNTRACKED = "ray_tpu_host_transfer_bytes_total{region=untracked}"

# the five watchdog cases of tests/test_jax_sentinel.py:68-132: watchdog
# knobs, the harvests' series in order, the probe, and the alerts'
# (severity, field, value, text in the message) the JAX tests expect
PROBE_CASES = {
    "recompile_storm_within_two_harvests": (
        {}, [{STORM: 5.0}, {STORM: 9.0}], "jit_recompile_storm",
        [("ERROR", "fn", "learner.update", 4.0, "RT020")]),
    "recompile_skips_untracked_first_and_small": (
        {}, [{"ray_tpu_jit_compiles_total{fn=untracked,kind=recompile}":
              0.0,
              "ray_tpu_jit_compiles_total{fn=learner.update,kind=first}":
              0.0,
              "ray_tpu_jit_compiles_total{fn=train.step,kind=recompile}":
              0.0},
             {"ray_tpu_jit_compiles_total{fn=untracked,kind=recompile}":
              10.0,
              "ray_tpu_jit_compiles_total{fn=learner.update,kind=first}":
              10.0,
              "ray_tpu_jit_compiles_total{fn=train.step,kind=recompile}":
              2.0}],
        "jit_recompile_storm", []),
    "recompile_warmup_grace": (
        {"jit_recompile_warmup_s": 600.0}, [{STORM: 0.0}, {STORM: 50.0}],
        "jit_recompile_storm", []),
    "host_transfer_within_two_harvests": (
        {}, [{BYTES: 0.0, UNTRACKED: 0.0}, {BYTES: 500.0, UNTRACKED: 1e9}],
        "unexpected_host_transfer",
        [("ERROR", "region", "learner.update", 500.0, "RT021")]),
    "host_transfer_below_floor_quiet": (
        {}, [{BYTES: 0.0}, {BYTES: 99.0}], "unexpected_host_transfer", []),
}


def _probe_alerts(plane, case):
    knobs, harvests, probe, _want = PROBE_CASES[case]
    events = []
    wd = _make_watchdog(plane, events, **knobs)
    seen = []
    for series in harvests:
        wd.evaluate([], series, [], interval_s=0.01)
        seen.append(list(_alerts(events, probe)))
    return seen


@pytest.mark.parametrize("plane", ["reference", "port"])
@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_watchdog_probes_match_the_reference(case, plane):
    """The JAX tests' expected alerts, from either package's watchdog;
    and the same series give the same alerts in both."""
    got = _probe_alerts(ref_mp if plane == "reference" else mp, case)
    assert got == _probe_alerts(ref_mp if plane == "port" else mp, case)
    assert got[0] == []  # a first appearance only baselines
    want = PROBE_CASES[case][3]
    assert len(got[-1]) == len(want)
    for (msg, severity, fields), (sev, key, label, value, rule) in zip(
            got[-1], want):
        assert severity == sev and fields[key] == label
        assert fields["value"] == value and rule in msg


def test_metrics_plane_configure_exposes_sentinel_knobs():
    wd = _make_watchdog(mp, [], jit_recompiles=7,
                        jit_recompile_warmup_s=5.0, host_transfer_bytes=42.0)
    assert wd.jit_recompiles == 7
    assert wd.jit_recompile_warmup_s == 5.0
    assert wd.host_transfer_bytes == 42.0


# ---- the live sentinel --------------------------------------------------

FAKE_NVCC = """#!/bin/sh
# stands in for nvcc: writes an empty library at -o (or fails, with $FAIL)
[ -n "$FAIL" ] && { echo "fake nvcc: failing" ; exit 1 ; }
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then shift; : > "$1"; fi
  shift
done
"""


@pytest.fixture
def sentinel(monkeypatch):
    """The sentinel installed, with CPU tensors counted as device ones."""
    monkeypatch.setenv("RAY_TPU_JAX_SENTINEL", "1")
    monkeypatch.delenv("RAY_TPU_JAX_SENTINEL_GUARD", raising=False)
    monkeypatch.setattr(cuda_sentinel, "on_device", lambda t: True)
    cuda_sentinel.uninstall()  # a step elsewhere in this process installs
    assert cuda_sentinel.install()
    try:
        yield cuda_sentinel
    finally:
        cuda_sentinel.uninstall()


class FakeBuild:
    """ops/_build.py's build() through a stand-in nvcc, into a temporary
    root; each bump() changes the source, so the next build compiles."""

    def __init__(self, tmp_path, monkeypatch):
        home = tmp_path / "cuda"
        (home / "bin").mkdir(parents=True)
        nvcc = home / "bin" / "nvcc"
        nvcc.write_text(FAKE_NVCC)
        nvcc.chmod(0o755)
        monkeypatch.setenv("CUDA_HOME", str(home))
        self.csrc = tmp_path / "csrc"
        self.csrc.mkdir()
        self.root = tmp_path / "build"
        self.n = 0
        self.seconds = []
        self.bump()
        monkeypatch.setattr(_build, "build_listeners",
                            [*_build.build_listeners, self.seconds.append])

    def bump(self):
        self.n += 1
        (self.csrc / "k.cu").write_text(f"// version {self.n}\n")

    def __call__(self):
        return _build.build(self.csrc, self.root, sources=("k.cu",))


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    return FakeBuild(tmp_path, monkeypatch)


def test_compile_counter_first_warm_recompile(sentinel, fake_build):
    first_key = (("fn", "sentinel.t1"), ("kind", "first"))
    rec_key = (("fn", "sentinel.t1"), ("kind", "recompile"))

    before = _series(COMPILES)
    with cuda_sentinel.step_region("sentinel.t1"):
        fake_build()
    cold = _series(COMPILES)
    assert _delta(before, cold, first_key) == 1.0

    with cuda_sentinel.step_region("sentinel.t1"):
        fake_build()  # warm: every library of this hash exists
    warm = _series(COMPILES)
    assert warm.get(first_key, 0.0) == cold.get(first_key, 0.0)
    assert warm.get(rec_key, 0.0) == cold.get(rec_key, 0.0)

    fake_build.bump()
    with cuda_sentinel.step_region("sentinel.t1"):
        fake_build()  # a new source hash: a real rebuild
    hot = _series(COMPILES)
    assert _delta(warm, hot, rec_key) == 1.0
    assert len(fake_build.seconds) == 2


def test_failed_build_is_not_counted(sentinel, fake_build, monkeypatch):
    key = (("fn", "sentinel.fail"), ("kind", "first"))
    before = _series(COMPILES)
    monkeypatch.setenv("FAIL", "1")
    with cuda_sentinel.step_region("sentinel.fail"):
        with pytest.raises(_build.KernelBuildError):
            fake_build()
    assert _delta(before, _series(COMPILES), key) == 0.0
    assert fake_build.seconds == []


def test_transfer_accounting_bytes_and_spans(sentinel):
    """The JAX test's numbers: a 4-byte scalar through .item() and a
    64-byte array through the sanctioned copy to the host, 68 bytes in
    the region; the same .item() outside it, 4 bytes untracked."""
    x = torch.arange(16, dtype=torch.float32)  # 64 bytes
    s = torch.tensor(1.0)                      # 4 bytes
    key = (("region", "sentinel.t2"),)
    unk = (("region", "untracked"),)

    before = _series(XFER)
    with cuda_sentinel.step_region("sentinel.t2"):
        assert s.item() == 1.0
        host = x.to("cpu", copy=True)
    assert host.shape == (16,)
    after = _series(XFER)
    assert _delta(before, after, key) == 68.0

    assert s.item() == 1.0
    outside = _series(XFER)
    assert outside.get(key, 0.0) == after.get(key, 0.0)
    assert _delta(after, outside, unk) == 4.0

    recs = [r for r in spans.ring().snapshot_records()
            if r[1].startswith("host_sync.")
            and (r[6] or {}).get("region") == "sentinel.t2"]
    assert {r[1] for r in recs} == {"host_sync.item", "host_sync.to"}


def _x():
    return torch.from_numpy(
        np.random.default_rng(0).standard_normal(16).astype(np.float32))


# each forcing point: the call, the bytes it moves, its span's name
FORCING = {
    "item": (lambda x: x[3].item(), 4, "item"),
    "tolist": (lambda x: x.tolist(), 64, "tolist"),
    "numpy": (lambda x: x.numpy(), 64, "numpy"),
    "asarray": (lambda x: np.asarray(x), 64, "asarray"),
    "float": (lambda x: float(x[0]), 4, "float"),
    "int": (lambda x: int(x[0]), 4, "int"),
    "bool": (lambda x: bool(x[0]), 4, "bool"),
    "index": (lambda x: range(x[:2].long()[1]), 8, "index"),
    "to_host_copy": (lambda x: x.to("cpu", copy=True), 64, "to"),
    "to_device_kw": (lambda x: x.to(device="cpu", copy=True), 64, "to"),
    "to_other": (lambda x: x.double().to(x, copy=True), 128, "to"),
    # moved nothing: a copy to the host that returns its own tensor, a
    # cast, a non-blocking copy (its event wait is where the host blocks)
    "cpu_self": (lambda x: x.cpu(), 0, None),
    "to_self": (lambda x: x.to("cpu"), 0, None),
    "to_dtype": (lambda x: x.to(torch.float64), 0, None),
    "to_non_blocking": (lambda x: x.to("cpu", non_blocking=True,
                                       copy=True), 0, None),
    "to_non_blocking_positional": (
        lambda x: x.to("cpu", torch.float32, True, True), 0, None),
}


@pytest.mark.parametrize("point", sorted(FORCING))
def test_each_forcing_point(sentinel, point):
    fn, nbytes, via = FORCING[point]
    x = _x()
    label = f"sentinel.fp.{point}"
    before = _series(XFER)
    with cuda_sentinel.step_region(label):
        fn(x)
    assert _delta(before, _series(XFER), (("region", label),)) == nbytes
    recs = [r for r in spans.ring().snapshot_records()
            if (r[6] or {}).get("region") == label]
    assert [r[1] for r in recs] == ([f"host_sync.{via}"] if via else [])
    if via:
        assert recs[0][6]["bytes"] == nbytes and recs[0][3] >= 0.0


def test_cpu_copy_is_a_forcing_point(sentinel):
    """cpu() of a device tensor copies, and is accounted (a stand-in
    for the card's copy: on the CPU, cpu() returns its own tensor)."""
    copy = cuda_sentinel._forcing_point(lambda t: t.clone(), "cpu", True)
    before = _series(XFER)
    with cuda_sentinel.step_region("sentinel.cpu"):
        copy(_x())
    assert _delta(before, _series(XFER), (("region", "sentinel.cpu"),)) \
        == 64.0


def test_default_predicate_counts_only_cuda_tensors(monkeypatch):
    """Unwidened, a CPU tensor is host memory: its coercions move
    nothing from a device."""
    monkeypatch.setenv("RAY_TPU_JAX_SENTINEL", "1")
    cuda_sentinel.uninstall()
    assert cuda_sentinel.install()
    try:
        before = _series(XFER)
        with cuda_sentinel.step_region("sentinel.host"):
            x = _x()
            x.tolist(), float(x[0]), x.numpy()
        assert _delta(before, _series(XFER),
                      (("region", "sentinel.host"),)) == 0.0
        assert not cuda_sentinel.on_device(x)
    finally:
        cuda_sentinel.uninstall()


def test_snapshot_extra_rides_process_snapshot(sentinel, fake_build):
    with cuda_sentinel.step_region("sentinel.t3"):
        fake_build()
    extra = mp.snapshot_process()[cuda_sentinel.SNAPSHOT_KEY]
    assert extra["installed"] is True
    assert extra["compiles"].get("sentinel.t3", 0) >= 1


def test_live_breach_alerts_within_two_harvests(sentinel):
    x = torch.arange(64, dtype=torch.float32)  # 256 bytes a copy
    events = []
    wd = _make_watchdog(mp, events, host_transfer_bytes=200.0)
    with cuda_sentinel.step_region("sentinel.live"):
        x.to("cpu", copy=True)  # breach begins
    wd.evaluate([], _flat_series(), [], interval_s=0.01)  # baselined
    assert not _alerts(events, "unexpected_host_transfer")
    with cuda_sentinel.step_region("sentinel.live"):
        x.to("cpu", copy=True)  # breach continues into the next window
    wd.evaluate([], _flat_series(), [], interval_s=0.01)  # judged
    alerts = _alerts(events, "unexpected_host_transfer")
    assert [f["region"] for _m, _s, f in alerts] == ["sentinel.live"]


def test_live_recompile_storm_alerts_within_two_harvests(sentinel,
                                                         fake_build):
    events = []
    wd = _make_watchdog(mp, events, jit_recompiles=3)
    with cuda_sentinel.step_region("sentinel.storm"):
        fake_build()       # first build
        fake_build.bump()
        fake_build()       # storm begins
    wd.evaluate([], _flat_series(), [], interval_s=0.01)  # baselined
    assert not _alerts(events, "jit_recompile_storm")
    with cuda_sentinel.step_region("sentinel.storm"):
        for _ in range(3):
            fake_build.bump()
            fake_build()   # 3 rebuilds in one window
    wd.evaluate([], _flat_series(), [], interval_s=0.01)  # judged
    alerts = _alerts(events, "jit_recompile_storm")
    assert [f2["fn"] for _m, _s, f2 in alerts] == ["sentinel.storm"]


def test_off_switch_disables_everything():
    """RAY_TPU_JAX_SENTINEL=0: install() refuses, step_region is a
    shared no-op, nothing is patched — in a subprocess, so the variable
    is read fresh (and torch is never even imported)."""
    code = (
        "from ray_tpu_torch.util import cuda_sentinel\n"
        "import sys\n"
        "assert not cuda_sentinel.enabled()\n"
        "assert not cuda_sentinel.install()\n"
        "assert not cuda_sentinel.installed()\n"
        "assert cuda_sentinel.step_region('x') is cuda_sentinel.NOOP\n"
        "assert 'torch' not in sys.modules\n"
        "print('SENTINEL-OFF-OK')\n")
    env = dict(os.environ, RAY_TPU_JAX_SENTINEL="0")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "SENTINEL-OFF-OK" in out.stdout


def test_build_seconds_charged_to_goodput_compile(sentinel, fake_build):
    """A build inside a productive window moves its wall seconds into
    `compile`; the buckets still sum to the ledger's wall time."""
    goodput._reset_for_tests()
    try:
        clock = [0.0]
        led = goodput.ledger("sentinel.goodput",
                             time_fn=lambda: clock[0]).bind()
        with goodput.bucket(goodput.PRODUCTIVE):
            clock[0] = 10.0
            with cuda_sentinel.step_region("sentinel.gp"):
                fake_build()
            clock[0] = 12.0
        (seconds,) = fake_build.seconds
        totals = led.totals()
        assert 0.0 < seconds < 10.0
        assert totals["compile"] == seconds
        assert totals[goodput.PRODUCTIVE] == pytest.approx(12.0 - seconds)
        assert sum(totals.values()) == pytest.approx(12.0)
    finally:
        goodput._reset_for_tests()


def test_regions_nest_innermost_wins_across_threads(sentinel):
    """Each thread keeps its own stack: a transfer attributes to its
    thread's innermost region, never to another thread's."""
    barrier = threading.Barrier(2, timeout=30)
    errors = []

    def worker(outer, inner):
        try:
            x = torch.ones(8)  # 32 bytes
            with cuda_sentinel.step_region(outer):
                barrier.wait()
                with cuda_sentinel.step_region(inner):
                    barrier.wait()
                    x.tolist()
                    barrier.wait()
                x.numpy()
            assert cuda_sentinel.current_region() is None
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    before = _series(XFER)
    threads = [threading.Thread(target=worker, args=(f"nest.{t}.outer",
                                                     f"nest.{t}.inner"))
               for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    after = _series(XFER)
    for t in "ab":
        assert _delta(before, after, (("region", f"nest.{t}.inner"),)) \
            == 32.0
        assert _delta(before, after, (("region", f"nest.{t}.outer"),)) \
            == 32.0


def test_uninstall_restores_every_patched_method(monkeypatch):
    monkeypatch.setenv("RAY_TPU_JAX_SENTINEL", "1")
    names = ("item", "tolist", "numpy", "__array__", "__float__", "__int__",
             "__bool__", "__index__", "cpu", "to")
    cuda_sentinel.uninstall()
    own = {n: torch.Tensor.__dict__.get(n) for n in names}
    seen = {n: getattr(torch.Tensor, n) for n in names}
    for _ in range(3):
        assert cuda_sentinel.install()
        assert all(getattr(torch.Tensor, n) is not seen[n] for n in names)
        cuda_sentinel.uninstall()
        assert {n: torch.Tensor.__dict__.get(n) for n in names} == own
        assert all(getattr(torch.Tensor, n) is seen[n] for n in names)
    # and the restored methods behave: the slots went back to TensorBase
    assert bool(torch.tensor(1.0)) and float(torch.tensor(2.5)) == 2.5
    assert torch.Tensor.item is torch._C.TensorBase.item


def test_guard_needs_cuda(sentinel, monkeypatch):
    """RAY_TPU_JAX_SENTINEL_GUARD asks for torch.cuda's sync debug mode;
    without CUDA the region raises rather than carry on unguarded, and
    leaves no region behind."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("RAY_TPU_JAX_SENTINEL_GUARD", "disallow")
    with pytest.raises(RuntimeError, match="CUDA"):
        with cuda_sentinel.step_region("sentinel.guard"):
            pass
    assert cuda_sentinel.current_region() is None


def test_guard_sets_and_restores_the_process_mode(sentinel, monkeypatch):
    """Two threads in guarded regions: the first sets the mode, the last
    restores the one it found, even when its body raises (torch.cuda's
    mode calls are stood in for: they need a card)."""
    mode = [0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: mode[0])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: mode.__setitem__(0, m))
    monkeypatch.setenv("RAY_TPU_JAX_SENTINEL_GUARD", "log")
    inside = threading.Event()
    release = threading.Event()

    def other():
        with cuda_sentinel.step_region("guard.b"):
            inside.set()
            release.wait(30)

    t = threading.Thread(target=other)
    t.start()
    assert inside.wait(30)
    assert mode[0] == "warn"
    with pytest.raises(ValueError):
        with cuda_sentinel.step_region("guard.a"):
            raise ValueError("body")
    assert mode[0] == "warn"  # the other thread's region still holds it
    release.set()
    t.join(30)
    assert not t.is_alive() and mode[0] == 0


# ---- the step regions at their call sites --------------------------------

def test_train_step_runs_in_its_region(sentinel):
    """The TINY step (make_train_step) runs under "train.step": a forcing
    point in its loss lands there; the step itself forces nothing."""
    from ray_tpu_torch.models import TINY, Transformer
    from ray_tpu_torch.parallel.train_step import make_train_step
    torch.set_num_threads(1)
    model = Transformer(TINY, seed=0, device="cpu")
    reads = []

    def loss_fn(params, batch):
        loss = model.loss(batch)
        reads.append(loss.item())  # 4 bytes, inside the step
        return loss

    init_state, train_step = make_train_step(loss_fn, device="cpu")
    state = init_state(dict(model.named_parameters()))
    tokens = np.random.default_rng(0).integers(
        0, TINY.vocab_size, (2, 17)).astype(np.int32)
    key = (("region", "train.step"),)
    before = _series(XFER)
    for _ in range(3):
        state, metrics = train_step(state, {"tokens": tokens})
    assert _delta(before, _series(XFER), key) == 3 * 4.0
    assert cuda_sentinel.current_region() is None
    assert np.isfinite(reads).all()


def test_learner_update_stats_read_in_its_region(sentinel):
    """PPO's Learner.update reads its stats once, at the end of the sweep:
    a [minibatches, keys] f64 block under "learner.update". On the CPU,
    torch's Adam also reads each param's step counter (a CPU scalar,
    never a device one) once a minibatch."""
    from ray_tpu_torch.rllib import DiscreteMLPModule
    from ray_tpu_torch.rllib.algorithms.ppo.ppo import PPOConfig, PPOLearner
    from ray_tpu_torch.rllib.core.learner import index_matrix
    torch.set_num_threads(1)
    learner = PPOLearner(DiscreteMLPModule(4, 2, (32, 32)),
                         PPOConfig().training(lr=1e-3).learners(
                             device="cpu"))
    learner.build(seed=0)
    rng = np.random.default_rng(0)
    n, mb, iters = 64, 16, 2
    batch = {"obs": rng.standard_normal((n, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, n).astype(np.int32),
             "advantages": rng.standard_normal(n).astype(np.float32),
             "value_targets": rng.standard_normal(n).astype(np.float32),
             "action_logp": (-0.7 + 0.2 * rng.standard_normal(n)).astype(
                 np.float32),
             "vf_preds": rng.standard_normal(n).astype(np.float32)}
    label = (("region", "learner.update"),)
    before = _series(XFER)
    t0 = time.perf_counter()
    stats = learner.update(batch, minibatch_size=mb, num_iters=iters)
    steps = len(index_matrix(n, mb, iters, 0))
    block = steps * len(stats) * 8
    n_params = len(list(learner.module.parameters()))
    assert _delta(before, _series(XFER), label) == \
        block + steps * n_params * 4
    reads = [r for r in spans.ring().snapshot_records()
             if r[1] == "host_sync.numpy" and r[2] >= t0
             and (r[6] or {}).get("region") == "learner.update"]
    assert [r[6]["bytes"] for r in reads] == [block]


def test_impala_learner_loop_runs_in_its_region(sentinel):
    """IMPALA's learner thread wraps each update in "learner.step"."""
    import queue

    from ray_tpu_torch.rllib.algorithms.impala.impala import Impala

    class Group:
        def update(self, batch):
            loop._stop_event.set()
            return {"total_loss": torch.tensor(batch).sum().item()}

    class Loop:
        _feed = None
        _stop_event = threading.Event()
        _stats_lock = threading.Lock()
        _train_queue = queue.Queue()
        _learner_error = None
        _steps_trained = _updates_done = _weights_version = 0
        learner_group = Group()

    loop = Loop()
    loop._train_queue.put(([1.0, 2.0], 2))
    before = _series(XFER)
    try:
        Impala._learner_loop(loop)
    finally:
        goodput.unbind()
    assert loop._learner_error is None
    assert loop._learner_stats == {"total_loss": 3.0}
    assert _delta(before, _series(XFER), (("region", "learner.step"),)) \
        == 4.0
