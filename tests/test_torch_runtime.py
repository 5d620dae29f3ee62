"""The port's copy of the runtime (tasks, actors, objects, placement
groups), its GPU accelerator manager and the trainer's GPU visibility,
on the CPU.

The copy guard holds every module the port keeps verbatim equal to the
JAX package's after the rename rule; the modules the port edits are
listed in CHANGES.md. The cluster is one ray_tpu_torch.init(num_cpus=4)
for the module, with RAY_TPU_FAKE_NUM_GPUS=2 so that its node reports
two GPUs through the GPU manager; nothing here touches CUDA.
"""

import ast
import os
import re
import time
from pathlib import Path

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private.accelerators import detect_node_accelerators
from ray_tpu_torch._private.accelerators.nvidia_gpu import (
    GPU_FAKE_NUM_ENV, NvidiaGPUAcceleratorManager)

REPO = Path(__file__).resolve().parent.parent

# The rename rule: imports and strings that name the JAX package's
# modules name the port's, and so does a bare use of the module object
# that `import ray_tpu` bound (`return ray_tpu`). Environment variables
# (RAY_TPU_*), session directory prefixes and CLI names (`ray_tpu logs`)
# stay as they are.
def rename(src: str) -> str:
    src = re.sub(r"\bray_tpu\.", "ray_tpu_torch.", src)
    src = re.sub(r"\bfrom ray_tpu import\b", "from ray_tpu_torch import",
                 src)
    src = re.sub(r"\bimport ray_tpu\b(?![.\w])", "import ray_tpu_torch",
                 src)
    lines = src.split("\n")
    # right to left, so that an edit leaves the next site's column valid
    for lineno, col in sorted(bare_module_names(src), reverse=True):
        line = lines[lineno - 1].encode()  # ast columns count utf-8 bytes
        lines[lineno - 1] = (line[:col] + b"ray_tpu_torch"
                             + line[col + len("ray_tpu"):]).decode()
    return "\n".join(lines)


def bare_module_names(src: str) -> list:
    """(line, column) of each `ray_tpu` that the source uses as a value
    of its own: a name that is not the object of an attribute access."""
    tree = ast.parse(src)
    objects = {id(n.value) for n in ast.walk(tree)
               if isinstance(n, ast.Attribute)}
    return [(n.lineno, n.col_offset) for n in ast.walk(tree)
            if isinstance(n, ast.Name) and n.id == "ray_tpu"
            and id(n) not in objects]


# every module the port copies without an edit (paths under both
# packages); the edited ones are listed, with reasons, in CHANGES.md
VERBATIM = [
    "_private/accelerators/accelerator.py", "_private/chaos.py",
    "_private/config.py", "_private/core_worker.py", "_private/events.py",
    "_private/gcs.py", "_private/goodput.py", "_private/ids.py",
    "_private/log_monitor.py", "_private/log_plane.py",
    "_private/memory_monitor.py", "_private/memory_plane.py",
    "_private/metrics_history.py", "_private/metrics_plane.py",
    "_private/node_main.py",
    "_private/node_manager.py", "_private/object_ref.py",
    "_private/object_store.py", "_private/ownership.py", "_private/rpc.py",
    "_private/runtime_env.py", "_private/scheduler.py",
    "_private/serialization.py", "_private/shm_channel.py",
    "_private/spans.py", "_private/state.py", "_private/task_events.py",
    "_private/usage.py", "_private/wait_graph.py", "_private/worker_main.py",
    "api.py", "chaos.py", "exceptions.py",
    "lint/__init__.py", "lint/__main__.py", "lint/concurrency.py",
    "lint/engine.py",
    "native/Makefile", "native/__init__.py", "native/store_arena.cpp",
    "train/backend.py", "train/checkpoint_manager.py",
    "train/data_parallel_trainer.py", "train/elastic.py",
    "train/heartbeat.py", "train/session.py", "train/worker_group.py",
    "util/actor_manager.py", "util/actor_pool.py", "util/locks.py",
    "util/metrics.py", "util/placement_group.py", "util/queue.py",
    "util/scheduling_strategies.py",
    "rllib/algorithms/__init__.py", "rllib/algorithms/appo/__init__.py",
    "rllib/algorithms/impala/__init__.py", "rllib/algorithms/ppo/__init__.py",
    "rllib/core/__init__.py", "rllib/env/__init__.py", "rllib/env/base.py",
    "rllib/env/cartpole.py", "rllib/env/minipong.py",
    "rllib/env/multi_agent.py", "rllib/env/spaces.py",
    "rllib/env/vector.py", "rllib/env/wrappers.py", "rllib/utils/__init__.py",
    "rllib/utils/postprocessing.py", "rllib/utils/schedules.py",
    "rllib/utils/replay_buffers.py", "rllib/utils/replay/__init__.py",
    "rllib/utils/replay/shard.py", "rllib/utils/replay/writer.py",
    "rllib/algorithms/dqn/__init__.py", "rllib/algorithms/dqn/simple_q.py",
    "rllib/algorithms/sac/__init__.py", "rllib/algorithms/td3/__init__.py",
    "rllib/algorithms/ddpg/__init__.py", "rllib/algorithms/ddpg/ddpg.py",
    "rllib/offline/__init__.py", "rllib/offline/json_io.py",
    "rllib/connectors/__init__.py", "rllib/env/catch_pixels.py",
    "rllib/algorithms/a2c/__init__.py", "rllib/algorithms/a2c/a2c.py",
    "rllib/algorithms/pg/__init__.py", "rllib/algorithms/marwil/__init__.py",
    "rllib/algorithms/cql/__init__.py", "rllib/algorithms/es/__init__.py",
    "data/__init__.py", "data/block.py", "data/dataset.py",
    "data/executor.py", "data/grouped.py", "data/io.py", "data/iterator.py",
    "data/shuffle.py",
    "tune/__init__.py", "tune/schedulers.py", "tune/search.py",
    "tune/trainable.py", "tune/tune_controller.py", "tune/tuner.py",
    "util/collective.py",
    "util/tracing.py", "dag/__init__.py",
    "serve/batching.py", "serve/_telemetry.py", "serve/controller.py",
    "serve/api.py", "serve/proxy.py", "serve/grpc_proxy.py",
    "serve/_private/__init__.py",
    "serve/_private/proxy_fleet/admission.py",
    "serve/_private/proxy_fleet/async_bridge.py",
    "serve/_private/proxy_fleet/http.py",
    "serve/_private/proxy_fleet/proxy.py",
    "serve/_private/proxy_fleet/fleet.py",
    "serve/_private/proxy_fleet/__init__.py", "serve/__init__.py",
    "cluster_utils.py", "_private/worker.py",
    "job/manager.py", "job/__init__.py", "client/worker.py",
    "client/server.py", "client/__init__.py", "workflow/__init__.py",
    "dashboard/metrics.py", "dashboard/head.py", "dashboard/__init__.py",
    "scripts/__init__.py", "scripts/cli.py", "__main__.py",
    "autoscaler/__init__.py", "autoscaler/autoscaler.py",
    "autoscaler/demand_scheduler.py", "autoscaler/v2.py",
    "train/sklearn_trainer.py", "train/tensorflow_trainer.py",
    "train/accelerate_trainer.py", "train/transformers_trainer.py",
    # the repo-root tools (reference_path): the port's lie under
    # ray_tpu_torch/tools/
    "tools/perf_report.py", "tools/fuzz_ownership.py", "tools/lint.py",
]


def reference_path(path: str) -> Path:
    """The JAX package's module of VERBATIM entry `path`: under ray_tpu/,
    or for tools/ at the repo root."""
    if path.startswith("tools/"):
        return REPO / path
    return REPO / "ray_tpu" / path

# the lines a copy repairs (reference text -> the port's), each a fault of
# the reference that the port fixes in its copy only: the transition
# ring's lock is reentrant (a garbage collection inside record() can run
# an ObjectRef.__del__ that records on the same thread); the CLI's head
# file lies under TMPDIR, not at a path every checkout shares, and goes
# with its head (test_torch_ops_tooling.py's test_head_file_*). The
# tools moved one directory down: each names its own command and the
# port's files, the fuzz harness puts the repo root on sys.path (not the
# package directory, whose data/ and tune/ would shadow top-level
# modules), and the lint runner lints the port into a cache file of its
# own (tests/test_lint.py writes the reference's).
REPAIRED = {
    "_private/ownership.py": [(
        "        self._lock = threading.Lock()\n",
        "        # reentrant: a garbage collection inside record() can run an\n"
        "        # ObjectRef.__del__ whose release records a transition on this\n"
        "        # same thread (decr_local -> transition -> record)\n"
        "        self._lock = threading.RLock()\n")],
    "scripts/cli.py": [
        ("import signal\nimport sys\n",
         "import signal\nimport sys\nimport tempfile\n"),
        ('HEAD_INFO_PATH = "/tmp/ray_tpu_head.json"\n',
         "# under TMPDIR (/tmp when it is unset), so that heads run with "
         "TMPDIRs of\n"
         "# their own do not share one file\n"
         'HEAD_INFO_PATH = os.path.join(tempfile.gettempdir(), '
         '"ray_tpu_head.json")\n'),
        ("        head.shutdown()\n        return 0\n",
         "        head.shutdown()\n"
         "        # the file goes with its head: a later `stop` would signal "
         "its\n"
         "        # pid, which another process may hold by then\n"
         "        try:\n"
         "            with open(HEAD_INFO_PATH) as f:\n"
         "                if json.load(f).get(\"pid\") == info[\"pid\"]:\n"
         "                    os.unlink(HEAD_INFO_PATH)\n"
         "        except (OSError, ValueError):\n"
         "            pass\n"
         "        return 0\n")],
    "tools/perf_report.py": [
        ("    python tools/perf_report.py TRACE.json [--format=json] "
         "[--out FILE]\n",
         "    python -m ray_tpu_torch.tools.perf_report TRACE.json "
         "[--format=json] \\\n        [--out FILE]\n"),
        ("    # device\u2192host syncs recorded by the jax sentinel inside step\n"
         "    # regions (util/jax_sentinel.py): wall time blocked on a forced\n",
         "    # device\u2192host syncs recorded by the CUDA sentinel inside step\n"
         "    # regions (util/cuda_sentinel.py): wall time blocked on a forced\n"
         )],
    "tools/fuzz_ownership.py": [
        ("    python tools/fuzz_ownership.py --seed 7 --steps 500 \\\n",
         "    python -m ray_tpu_torch.tools.fuzz_ownership --seed 7 "
         "--steps 500 \\\n"),
        ("    python tools/fuzz_ownership.py --seeds 50 --steps 500  # sweep\n",
         "    python -m ray_tpu_torch.tools.fuzz_ownership --seeds 50 \\\n"
         "        --steps 500  # sweep\n"),
        ("(tests/test_ownership_fuzz.py runs 3 short seeds in tier-1 and the\n"
         "50x500 sweep behind -m slow).\n",
         "(tests/test_torch_fuzz_ownership.py runs 3 short seeds, each in a\n"
         "process of its own under a timeout).\n"),
        ("sys.path.insert(0, os.path.dirname(os.path.dirname(\n"
         "    os.path.abspath(__file__))))\n",
         "sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(\n"
         "    os.path.abspath(__file__)))))\n")],
    "tools/lint.py": [
        ('"""CI lint runner: `python tools/lint.py [paths...]`.\n\n'
         "Thin wrapper over `python -m ray_tpu_torch.lint` that defaults to "
         "linting the\n"
         "ray_tpu package itself (the checked-in zero-findings baseline) WITH "
         "the\n"
         "on-disk incremental cache enabled (.graftlint-cache.json at the "
         "repo\n"
         "root, keyed by file content hash + rule-set fingerprint), so the "
         "tier-1\n",
         '"""CI lint runner: `python -m ray_tpu_torch.tools.lint '
         '[paths...]`.\n\n'
         "Thin wrapper over `python -m ray_tpu_torch.lint` that defaults to\n"
         "linting the ray_tpu_torch package itself, its examples/ and "
         "tools/\n"
         "apart (the JAX package keeps those at the repo root, outside what\n"
         "tools/lint.py lints), the zero-findings baseline, WITH the on-disk\n"
         "incremental cache enabled (.graftlint-torch-cache.json at the "
         "repo\n"
         "root, a file of its own: tests/test_lint.py writes the JAX "
         "package's),\n"
         "keyed by file content hash + rule-set fingerprint, so the tier-1\n"),
        ("_REPO_ROOT = os.path.dirname(os.path.dirname("
         "os.path.abspath(__file__)))\n"
         'CACHE_PATH = os.path.join(_REPO_ROOT, ".graftlint-cache.json")\n',
         "_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(\n"
         "    os.path.abspath(__file__))))\n"
         'CACHE_PATH = os.path.join(_REPO_ROOT, '
         '".graftlint-torch-cache.json")\n'
         "# what lies outside the JAX package, at the repo root\n"
         'OUTSIDE = ("examples", "tools")\n'),
        ('        argv.append(os.path.join(_REPO_ROOT, "ray_tpu"))\n',
         '        pkg = os.path.join(_REPO_ROOT, "ray_tpu_torch")\n'
         "        argv += sorted(os.path.join(pkg, n) for n in os.listdir(pkg)\n"
         "                       if n not in OUTSIDE)\n")],
}


@pytest.mark.parametrize("path", VERBATIM)
def test_copy_equals_reference_under_the_rename_rule(path):
    ref = reference_path(path).read_text()
    port = (REPO / "ray_tpu_torch" / path).read_text()
    want = rename(ref) if path.endswith(".py") else ref
    for before, after in REPAIRED.get(path, []):
        assert want.count(before) == 1, f"{path}: {before!r}"
        want = want.replace(before, after)
    assert port == want


def test_rename_rule_leaves_no_bare_module_name():
    """The reference uses the module object bare in three places, each
    renamed by the rule; no renamed module and no module of the port
    keeps one."""
    sites = sorted(
        (str(p.relative_to(REPO)), lineno)
        for p in (REPO / "ray_tpu").rglob("*.py")
        for lineno, _col in bare_module_names(p.read_text()))
    assert sites == [("ray_tpu/client/server.py", 25),
                     ("ray_tpu/job/manager.py", 90),
                     ("ray_tpu/scripts/cli.py", 38)]
    for p in (REPO / "ray_tpu").rglob("*.py"):
        assert bare_module_names(rename(p.read_text())) == [], p
    for p in (REPO / "ray_tpu_torch").rglob("*.py"):
        assert bare_module_names(p.read_text()) == [], p
    assert "self._rt = ray_tpu_torch\n" in rename(
        (REPO / "ray_tpu/client/server.py").read_text())


def _function_source(path, qualname):
    """The source lines of function `qualname` ("Class.method" or
    "function") in the module at `path` (under the rename rule when the
    module is the JAX package's)."""
    src = (REPO / path).read_text()
    if path.startswith("ray_tpu/"):
        src = rename(src)
    tree = ast.parse(src)
    *owner, name = qualname.split(".")
    for node in ast.walk(tree):
        if owner and not (isinstance(node, ast.ClassDef)
                          and node.name == owner[0]):
            continue
        body = node.body if owner else tree.body
        for fn in body:
            if isinstance(fn, ast.FunctionDef) and fn.name == name:
                lines = src.splitlines(keepends=True)
                return "".join(lines[fn.lineno - 1:fn.end_lineno])
    raise AssertionError(f"{qualname} not in {path}")


@pytest.mark.parametrize("path,qualname", [
    ("actor.py", "ActorClass.bind"),
    ("remote_function.py", "RemoteFunction.bind"),
    ("util/state.py", "serve_fleet")])
def test_restored_bodies_equal_the_reference(path, qualname):
    """The lazy constructors and the fleet view, edited modules
    otherwise, have the JAX package's bodies under the rename rule."""
    assert _function_source(f"ray_tpu_torch/{path}", qualname) == \
        _function_source(f"ray_tpu/{path}", qualname)


def test_rename_rule_reaches_the_worker_command():
    """The node manager spawns the port's workers, not the JAX
    package's."""
    src = (REPO / "ray_tpu_torch/_private/node_manager.py").read_text()
    assert '"-m", "ray_tpu_torch._private.worker_main"' in src
    assert "RAY_TPU_WORKER_ID" in src  # env names stay


@pytest.fixture(scope="module")
def cluster():
    old = os.environ.get(GPU_FAKE_NUM_ENV)
    os.environ[GPU_FAKE_NUM_ENV] = "2"  # the node and its workers see 2
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()
    if old is None:
        del os.environ[GPU_FAKE_NUM_ENV]
    else:
        os.environ[GPU_FAKE_NUM_ENV] = old


def test_tasks(cluster):
    @ray_tpu_torch.remote
    def add(a, b):
        return a + b

    @ray_tpu_torch.remote(num_returns=2)
    def divmod_(a, b=3):
        return a // b, a % b

    assert ray_tpu_torch.get(add.remote(1, 2)) == 3
    refs = [add.remote(i, i) for i in range(25)]
    assert ray_tpu_torch.get(refs) == [2 * i for i in range(25)]
    q, r = divmod_.remote(10, b=4)
    assert ray_tpu_torch.get([q, r]) == [2, 2]

    @ray_tpu_torch.remote
    def boom():
        raise ValueError("boom")

    with pytest.raises(exc.RayTaskError):
        ray_tpu_torch.get(boom.remote())


def test_put_get(cluster):
    for value in [1, "x", {"a": [1, 2]}, None, np.arange(10)]:
        out = ray_tpu_torch.get(ray_tpu_torch.put(value))
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(out, value)
        else:
            assert out == value
    big = np.random.default_rng(0).standard_normal(1 << 18)  # object store
    np.testing.assert_array_equal(ray_tpu_torch.get(ray_tpu_torch.put(big)),
                                  big)


def test_wait(cluster):
    @ray_tpu_torch.remote
    def sleepy(t):
        time.sleep(t)
        return t

    fast = sleepy.remote(0.01)
    slow = sleepy.remote(1.2)
    ready, rest = ray_tpu_torch.wait([fast, slow], num_returns=1, timeout=10)
    assert ready == [fast] and rest == [slow]
    assert ray_tpu_torch.get(slow) == 1.2


def test_actor(cluster):
    @ray_tpu_torch.remote
    class Counter:
        def __init__(self, start=0):
            self.n = start

        def incr(self, k=1):
            self.n += k
            return self.n

    c = Counter.remote(10)
    assert ray_tpu_torch.get([c.incr.remote() for _ in range(5)]) == \
        [11, 12, 13, 14, 15]
    ray_tpu_torch.kill(c)


def test_placement_group(cluster):
    from ray_tpu_torch.util import (PlacementGroupSchedulingStrategy,
                                    placement_group, remove_placement_group)

    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    assert pg.wait(30)

    @ray_tpu_torch.remote
    def where():
        return ray_tpu_torch.get_runtime_context().get_node_id()

    refs = [where.options(scheduling_strategy=PlacementGroupSchedulingStrategy(
        pg, placement_group_bundle_index=i)).remote() for i in range(2)]
    assert len(set(ray_tpu_torch.get(refs))) == 1
    remove_placement_group(pg)


def test_lazy_graphs_and_fleet_view_without_serve(cluster):
    """The lazy graphs and the fleet view: f.bind() is a FunctionNode
    that executes, and with Serve not running the fleet view says so."""
    @ray_tpu_torch.remote
    def f():
        return 1

    from ray_tpu_torch.dag import FunctionNode
    node = f.bind()
    assert isinstance(node, FunctionNode)
    assert ray_tpu_torch.get(node.execute(), timeout=60) == 1
    from ray_tpu_torch.util import state
    assert state.serve_fleet() == {"enabled": False, "proxies": []}


def test_replay_shards_lists_live_shards(cluster):
    """util.state.replay_shards(): each live ReplayShardActor of a
    ReplayGroup, with its own stats."""
    from ray_tpu_torch.rllib.utils.replay import ReplayGroup
    from ray_tpu_torch.util import state
    group = ReplayGroup(2, 100, prioritized=True, batch_size=4, seed=0,
                        name="state_test", shard_num_cpus=0.1)
    try:
        handles = dict(group.shard_handles())
        assert ray_tpu_torch.get([h.ping.remote() for h in handles.values()],
                                 timeout=120) == ["pong", "pong"]
        ray_tpu_torch.get(handles[1].push.remote(
            {"obs": np.arange(6, dtype=np.float32)}), timeout=60)
        view = state.replay_shards()
        mine = [s for s in view["shards"]
                if (s["stats"] or {}).get("group") == "state_test"]
        assert len(mine) == 2 and all(s["state"] == "ALIVE" for s in mine)
        assert sorted(s["stats"]["size"] for s in mine) == [0, 6]
        assert view["total_added"] >= 6
    finally:
        group.stop()


def test_device_profile_through_the_cluster(cluster):
    """util.state.profile(device=True): one device_profile entry per
    worker (and the driver), each skipped here, where no process has
    initialized CUDA; an actor's worker is among them. Every worker alive
    both before and after the profile is among them: one that leaves in
    between (an idle worker the pool retires, the module's earlier tests'
    tasks ending) cannot answer, and is not asked for."""
    from ray_tpu_torch.util import state

    @ray_tpu_torch.remote
    class Pid:
        def pid(self):
            return os.getpid()

    def alive():
        return {w["worker_id"] for w in state.list_workers()
                if w.get("alive", True)}

    actor = Pid.remote()
    pid = ray_tpu_torch.get(actor.pid.remote(), timeout=60)
    before = alive()
    out = state.profile(duration=0.1, device=True)
    workers = before & alive()
    profiles = out["profiles"]
    assert out["unreachable"] == []
    assert len({p["proc_uid"] for p in profiles}) == len(profiles)
    assert all("CUDA not initialized" in p["skipped"] for p in profiles)
    by_worker = [p["worker_id"] for p in profiles if p["worker_id"]]
    assert sorted(by_worker) == sorted(set(by_worker))
    assert workers <= set(by_worker)
    assert pid in {p["pid"] for p in profiles}
    ray_tpu_torch.kill(actor)


def test_gpu_manager_counts_fake_visible_and_nvidia_smi(monkeypatch):
    gpus = NvidiaGPUAcceleratorManager
    assert gpus.get_resource_name() == "GPU"
    assert gpus.get_visible_accelerator_ids_env_var() == \
        "CUDA_VISIBLE_DEVICES"
    monkeypatch.setenv(GPU_FAKE_NUM_ENV, "2")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "5")
    assert detect_node_accelerators() == {"GPU": 2.0}  # fake wins
    monkeypatch.delenv(GPU_FAKE_NUM_ENV)
    assert detect_node_accelerators() == {"GPU": 1.0}
    assert gpus.get_current_node_accelerator_ids() == ["5"]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert detect_node_accelerators() == {}
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    # no variable: one card a line of `nvidia-smi -L`; none here
    from ray_tpu_torch._private.accelerators import nvidia_gpu
    monkeypatch.setattr(nvidia_gpu, "_nvidia_smi", lambda *a: [
        "GPU 0: NVIDIA H100 80GB HBM3 (UUID: GPU-1)",
        "GPU 1: NVIDIA H100 80GB HBM3 (UUID: GPU-2)"]
        if a == ("-L",) else ["NVIDIA H100 80GB HBM3"])
    assert gpus.get_current_node_num_accelerators() == 2
    assert gpus.get_current_node_accelerator_type() == "H100"


@pytest.mark.parametrize("per_worker, seen", [
    ({"CPU": 1, "GPU": 1}, ["0", "1"]),       # ScalingConfig()'s demand
    ({"CPU": 1, "GPU": 0.5}, ["0", "0"]),     # a share of one card each
    ({"CPU": 1}, ["", ""]),                   # use_gpu=False: no card
])
def test_node_reports_gpus_and_workers_split_them(cluster, per_worker, seen):
    """The node's GPUs come from the GPU manager; co-located workers of a
    gang see the cards of their local rank's share, and a worker that
    asked for none sees none."""
    from ray_tpu_torch.train import ScalingConfig
    from ray_tpu_torch.train.backend import BackendConfig
    from ray_tpu_torch.train.backend_executor import BackendExecutor

    assert ScalingConfig()._resources_per_worker_not_none == \
        {"CPU": 1, "GPU": 1}
    assert ray_tpu_torch.cluster_resources()["GPU"] == 2.0
    ex = BackendExecutor(BackendConfig(), ScalingConfig(
        num_workers=2, resources_per_worker=per_worker))
    ex._form_group()
    try:
        assert [c.local_rank for c in ex._contexts] == [0, 1]
        assert ex.worker_group.execute(
            lambda: os.environ.get("CUDA_VISIBLE_DEVICES")) == seen
        # the split touched no torch (so no CUDA) in the workers
        assert ex.worker_group.execute(
            lambda: "torch" in __import__("sys").modules) == [False, False]
    finally:
        ex.shutdown()
