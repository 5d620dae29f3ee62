"""Rules of the port package: it imports neither jax nor ray_tpu, its
entry points default to CUDA and raise without it, its kernel path never
falls back to the plain version, and its build says so when nvcc is
missing."""

import ast
import importlib.util
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.models import TINY, Transformer
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import flash_attention as pflash
from ray_tpu_torch.parallel.train_step import make_train_step

PKG = Path(ray_tpu_torch.__file__).resolve().parent
REPO = PKG.parent


def _is_forbidden(module):
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "optax", "orbax", "ray_tpu")


def test_fresh_import_pulls_in_no_jax_and_no_ray_tpu():
    # every Python module of the package; the runtime's ctypes library
    # (native/libraytpustore.so, built at first use) is not one
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import ray_tpu_torch\n"
        "for m in pkgutil.walk_packages(ray_tpu_torch.__path__, "
        "'ray_tpu_torch.'):\n"
        "    if m.name == 'ray_tpu_torch.__main__':\n"
        "        continue\n"  # importing it runs the CLI
        "    if importlib.util.find_spec(m.name).origin.endswith('.py'):\n"
        "        importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'orbax', 'ray_tpu'))\n"
        "print('IMPORTED', len([n for n in sys.modules "
        "if n.startswith('ray_tpu_torch')]))\n"
        "print('RLLIB', 'ray_tpu_torch.rllib' in sys.modules)\n"
        "print('SHARDING', 'ray_tpu_torch.parallel.sharding' in sys.modules)\n"
        "print('BAD', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert "RLLIB True" in out.stdout, out.stdout
    assert "SHARDING True" in out.stdout, out.stdout
    # every source file but the CLI's __main__ was imported (the
    # runtime's _private/ included)
    imported = int(out.stdout.split("IMPORTED ")[1].split()[0])
    assert imported >= len(SOURCES) - 1, (imported, len(SOURCES))


@pytest.mark.parametrize("module", ["ray_tpu_torch.data",
                                    "ray_tpu_torch.tune",
                                    "ray_tpu_torch.util.collective",
                                    "ray_tpu_torch.serve",
                                    "ray_tpu_torch.dag",
                                    "ray_tpu_torch.util.tracing",
                                    "ray_tpu_torch.client",
                                    "ray_tpu_torch.job",
                                    "ray_tpu_torch.workflow",
                                    "ray_tpu_torch.dashboard",
                                    "ray_tpu_torch.scripts.cli",
                                    "ray_tpu_torch.autoscaler",
                                    "ray_tpu_torch.tools.chaos_sweep",
                                    "ray_tpu_torch.entry",
                                    "ray_tpu_torch.tools.perf_report",
                                    "ray_tpu_torch.tools.fuzz_ownership",
                                    "ray_tpu_torch.tools.lint"])
def test_data_tune_collective_import_alone_without_jax(module):
    """Each of Data, Tune, the host collectives, Serve, the lazy task
    graphs, trace propagation, the thin client, jobs, workflows, the
    dashboard, the CLI, the autoscaler, the chaos sweep, the entry
    points, the perf report, the ownership fuzz harness and the lint
    runner, imported alone in a fresh process, loads its modules and no
    jax, optax or ray_tpu."""
    code = (f"import importlib, sys\n"
            f"importlib.import_module({module!r})\n"
            f"print('MODS', len([n for n in sys.modules "
            f"if n.startswith({module!r})]))\n"
            f"print('BAD', sorted(n for n in sys.modules if n.split('.')[0] "
            f"in ('jax', 'jaxlib', 'optax', 'orbax', 'ray_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert int(out.stdout.split("MODS ")[1].split()[0]) >= 1


TRAINER_LIBRARIES = ("sklearn", "tensorflow", "transformers", "accelerate",
                     "yaml")


def test_train_and_examples_import_without_the_trainers_libraries():
    """As on the card's machine, where none of the extra trainers'
    libraries is installed: ray_tpu_torch.train (with its six extra
    names) and every example import, and pull in neither jax nor
    ray_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"for m in {TRAINER_LIBRARIES!r}:\n"
        "    sys.modules[m] = None\n"   # `import m` raises ImportError
        "import ray_tpu_torch.train as train\n"
        "import ray_tpu_torch.examples as examples\n"
        "mods = [m.name for m in pkgutil.iter_modules(examples.__path__,\n"
        "        'ray_tpu_torch.examples.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "print('EXAMPLES', len(mods))\n"
        "print('NAMES', all(callable(getattr(train, n)) for n in (\n"
        "    'SklearnTrainer', 'TensorflowConfig', 'TensorflowTrainer',\n"
        "    'AccelerateTrainer', 'TransformersTrainer', 'prepare_trainer')))\n"
        "print('BAD', sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'orbax', 'ray_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "EXAMPLES 14" in out.stdout, out.stdout
    assert "NAMES True" in out.stdout, out.stdout
    assert "BAD []" in out.stdout, out.stdout


# the package's own sources; _build/ holds build outputs, never sources
SOURCES = sorted(str(p.relative_to(REPO)) for p in PKG.rglob("*.py")
                 if "_build" not in p.relative_to(PKG).parts)


@pytest.mark.parametrize("path", SOURCES + ["chip_smoke.py"])
def test_source_imports_no_jax_and_no_ray_tpu(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_is_forbidden(n) for n in names), (path, names)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Transformer(TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(lambda p, b: 0.0)


def test_rllib_learner_defaults_to_cuda_and_raises_without_it(monkeypatch):
    """PPO with no learner device asks for the card, and raises without
    one before it starts any runner."""
    from ray_tpu_torch.rllib import PPOConfig
    from ray_tpu_torch.rllib.algorithms.algorithm import EnvRunnerSet
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    started = []
    monkeypatch.setattr(EnvRunnerSet, "__init__",
                        lambda *a: started.append(a))
    with pytest.raises(RuntimeError, match="CUDA"):
        PPOConfig().environment("CartPole-v1").build()
    assert not started


def test_impala_learner_defaults_to_cuda_and_raises_without_it(
        monkeypatch):
    """IMPALA with no learner device asks for the card, and raises
    without one before it starts any runner."""
    from ray_tpu_torch.rllib import ImpalaConfig
    from ray_tpu_torch.rllib.algorithms.algorithm import EnvRunnerSet
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    started = []
    monkeypatch.setattr(EnvRunnerSet, "__init__",
                        lambda *a: started.append(a))
    with pytest.raises(RuntimeError, match="CUDA"):
        ImpalaConfig().environment("CartPole-v1").env_runners(
            num_env_runners=2).build()
    assert not started


def test_learner_gang_claims_cards_by_local_rank(monkeypatch):
    """A gang rank claims the card of its local rank on its node: two
    ranks on one two-card node take cards 0 and 1, and two ranks on two
    one-card nodes take card 0 each (by global rank the second would ask
    a one-card node for its card 1)."""
    from ray_tpu_torch._private.accelerators.nvidia_gpu import \
        GPU_FAKE_NUM_ENV
    from ray_tpu_torch.rllib.core.learner_group import local_ranks
    from ray_tpu_torch.train.backend_executor import _claim_gpus
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")  # _claim_gpus sets it
    monkeypatch.setenv(GPU_FAKE_NUM_ENV, "2")
    assert [_claim_gpus([r]) for r in local_ranks(["a", "a"])] == \
        [["0"], ["1"]]
    monkeypatch.setenv(GPU_FAKE_NUM_ENV, "1")
    assert local_ranks(["a", "b"]) == [0, 0]
    assert [_claim_gpus([r]) for r in local_ranks(["a", "b"])] == \
        [["0"], ["0"]]
    assert local_ranks(["a", "b", "a", "b", "a"]) == [0, 0, 1, 1, 2]
    with pytest.raises(IndexError):
        _claim_gpus([1])


# name -> the module under ray_tpu_torch.rllib.algorithms that defines it:
# every name of the JAX package's registry
RLLIB_PORTED = {"IMPALA": "impala.impala", "APPO": "appo.appo",
                "DQN": "dqn.dqn", "SAC": "sac.sac", "TD3": "td3.td3",
                "DDPG": "ddpg.ddpg", "SimpleQ": "dqn.simple_q",
                "CQL": "cql.cql", "MARWIL": "marwil.marwil",
                "BC": "marwil.marwil", "ES": "es.es", "PG": "pg.pg",
                "A2C": "a2c.a2c"}


@pytest.mark.parametrize("name", list(RLLIB_PORTED))
def test_rllib_ported_algorithms_resolve(name):
    from ray_tpu_torch.rllib import get_algorithm_class
    algo, config = get_algorithm_class(name.lower(), return_config=True)
    assert config.algo_class is algo
    assert algo.__module__ == \
        f"ray_tpu_torch.rllib.algorithms.{RLLIB_PORTED[name]}"


def test_rllib_registry_lists_the_jax_registry():
    from ray_tpu.rllib import registered_algorithms as jax_registered
    from ray_tpu_torch.rllib import registered_algorithms
    assert registered_algorithms() == jax_registered()
    assert len(registered_algorithms()) == 14
    assert {n.upper() for n in RLLIB_PORTED} | {"PPO"} == \
        set(registered_algorithms())


def test_rllib_unported_paths_raise_naming_roadmap():
    """No RLlib path raises NotImplementedError any more; an elastic
    learner gang (the last that did) checks its bounds before it spawns
    a rank, as the JAX package's does."""
    from ray_tpu_torch.rllib import LearnerGroup
    for kw, match in (
            ({"num_learners": 2, "elastic_min_learners": 3},
             r"elastic_min_learners=3 not in \[1, num_learners=2\]"),
            ({"num_learners": 2, "elastic_min_learners": 0},
             "elastic_min_learners=0 not in"),
            ({"num_learners": 0, "elastic_min_learners": 1},
             "requires a remote gang"),
            ({"num_learners": 2, "elastic_min_learners": 1,
              "step_deadline_s": 0.0}, "step_deadline_s must be > 0"),
            ({"num_learners": 2, "elastic_min_learners": 1,
              "state_refresh_every": 0}, "state_refresh_every")):
        with pytest.raises(ValueError, match=match):
            LearnerGroup(lambda: None, **kw)
    src = (PKG / "rllib" / "core" / "learner_group.py").read_text()
    assert "NotImplementedError" not in src


def test_rllib_once_unported_paths_build(tmp_path):
    """The connectors, multi-agent and offline-output paths that raised
    before build and run one iteration."""
    from ray_tpu_torch.rllib import (MultiAgentRLModule, PPOConfig,
                                     make_multi_agent, register_env)
    from ray_tpu_torch.rllib.algorithms.ppo.ppo import MultiAgentPPOLearner
    from ray_tpu_torch.rllib.connectors import MeanStdFilterConnector
    register_env("ma_cartpole_package", make_multi_agent("CartPole-v1"))
    base = (PPOConfig().environment("CartPole-v1")
            .env_runners(rollout_fragment_length=16)
            .training(train_batch_size=32, minibatch_size=16, num_epochs=1)
            .learners(device="cpu"))
    out = tmp_path / "out"
    for config in (base.copy().env_runners(
                       env_connectors=[MeanStdFilterConnector()]),
                   base.copy().environment(
                       "ma_cartpole_package", env_config={"num_agents": 2})
                   .multi_agent(policies={"p": None},
                                policy_mapping_fn=lambda a: "p"),
                   base.copy().offline_data(output=str(out))):
        algo = config.build()
        try:
            assert algo.train()["num_env_steps_trained"] >= 32
            if config.policies:
                assert isinstance(algo.module, MultiAgentRLModule)
                assert isinstance(algo.learner_group._local,
                                  MultiAgentPPOLearner)
        finally:
            algo.stop()
    assert sorted(p.name for p in out.iterdir()) == ["output-00000.jsonl"]


def test_unported_paths_raise_naming_their_slice():
    """Once raising paths, ported now (Queue 1 item 4): the Transformer
    builds with MoE layers, ring and Ulysses attention, each of which
    runs a CPU loss equal to the dense model's (ring and Ulysses on an
    unsharded seq are one flash block); pipeline_loss on one stage equals
    loss."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, TINY.vocab_size, (2, 17))
    base = TINY.replace(dtype="float32", loss_chunk=0)
    torch.manual_seed(0)
    dense = Transformer(base, device="cpu")
    want = dense.loss({"tokens": tokens}).item()
    for over in (dict(attention_impl="ring"), dict(attention_impl="ulysses")):
        model = Transformer(base.replace(**over), device="cpu")
        model.load_state_dict(dense.state_dict())
        assert abs(model.loss({"tokens": tokens}).item() - want) < 1e-5
    moe = Transformer(base.replace(moe_experts=4), device="cpu")
    assert moe.layers["w_router"].dtype == torch.float32
    assert tuple(moe.layers["w_moe_up"].shape) == (2, 4, 64, 128)
    assert math.isfinite(moe.loss({"tokens": tokens}).item())
    got = dense.pipeline_loss({"tokens": tokens}, mesh=None, n_stages=1,
                              n_micro=2).item()
    assert abs(got - want) < 1e-5


@pytest.mark.parametrize("axis", ["seq", "pipe", "expert"])
def test_unported_mesh_axes_raise_naming_queue_1_item_4(axis):
    """Once raising, ported now: a mesh with the axis above size 1 builds
    (8 ranks of torch's fake process group, in this process) and holds
    it among its dims in the JAX order; at size 1 the axis is left
    out."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from ray_tpu_torch.parallel import MeshConfig, make_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=5, world_size=8)
    try:
        mesh = make_mesh(MeshConfig(data=2, tensor=2, **{axis: 2}),
                         device="cpu")
        order = ("data", "fsdp", "pipe", "expert", "seq", "tensor")
        assert mesh.mesh_dim_names == tuple(
            a for a in order if a in ("data", "fsdp", "tensor", axis))
        assert dict(zip(mesh.mesh_dim_names, mesh.shape))[axis] == 2
        one = make_mesh(MeshConfig(data=-1, **{axis: 1}), device="cpu")
        assert one.mesh_dim_names == ("data", "fsdp", "tensor")
    finally:
        dist.destroy_process_group()


def test_sharded_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch):
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.parallel import MeshConfig, make_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(MeshConfig(data=1, fsdp=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(lambda p, b: 0.0, Transformer.param_specs(TINY))
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({}, TINY)


@pytest.mark.parametrize("kernel", ["fwd", "dkv", "dq"])
def test_kernel_path_raises_on_cpu_tensors(kernel):
    q = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16)
    stats = torch.zeros(1, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        if kernel == "fwd":
            pflash._flash_fwd_cuda(q, q, q, 0.125, True)
        elif kernel == "dkv":
            pflash._flash_bwd_dkv_cuda(q, q, q, q, stats, stats, 0.125, True)
        else:
            pflash._flash_bwd_dq_cuda(q, q, q, q, stats, stats, 0.125, True)


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor on neither the CPU nor CUDA is refused, not sent to the
    plain version."""
    q = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pflash.flash_fwd(q, q, q, 0.125, True)


def test_build_raises_clearly_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.find_nvcc()
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.kernel("flash_fwd")
    assert not (tmp_path / "build").exists()


def test_build_hash_follows_the_sources():
    h = _build.source_hash()
    assert len(h) == 16 and h == _build.source_hash()
    assert set(_build.SOURCES) <= {p.name for p in _build.CSRC.iterdir()}
    assert set(_build.SIGNATURES) == {s[:-3] for s in _build.SOURCES}


def test_every_kernel_is_a_hopper_kernel_under_the_sass_gate():
    """Every source the build compiles includes hopper_common.cuh and is
    one chip_smoke.py's build phase holds to HGMMA and UTMALDG (and no
    HMMA)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert set(_build.SOURCES) <= set(chip_smoke.HOPPER_SOURCES)
    for src in _build.SOURCES:
        text = (_build.CSRC / src).read_text()
        assert '#include "hopper_common.cuh"' in text, src
    headers = {p.name for p in _build.CSRC.iterdir() if p.suffix == ".cuh"}
    assert headers == {"hopper_common.cuh"}


def test_chip_smoke_fails_without_cuda_and_alone(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                           capture_output=True, text=True, timeout=120,
                           env=dict(env, PYTHONPATH=""))
    assert alone.returncode != 0
    assert '"ok": true' not in alone.stdout


# a few lines of `cuobjdump -sass` of a Hopper kernel: predicated and
# unpredicated instructions, uniform predicates, and the encoding comments
SASS = """
        /*0200*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;  /* 0x00000000000079f0 */
                                                                                      /* 0x000fe20008000818 */
        /*0210*/              @P0 SYNCS.ARRIVE.TRANS64.RED.A1T0 RZ, [UR4], RZ ;
        /*0220*/                   UTMALDG.4D [UR8], [UR10] ;
        /*0230*/             @!P0 BRA 0x1f0 ;
        /*1a2b0*/           @!UPT SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R3+URZ], R4 ;
        /*1a2c0*/                   HGMMA.64x64x16.F32.BF16 R88, R152, gdesc[UR8].tnspB, R88 ;
        /*0240*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0250*/                   LDSM.16.M88.4 R8, [R2] ;
"""


def test_sass_counts_read_cuobjdump_text():
    assert _build.sass_counts(SASS) == {"HGMMA": 2, "UTMALDG": 1, "HMMA": 1,
                                        "SYNCS": 2}
    assert _build.sass_counts("") == dict.fromkeys(_build.SASS_OPS, 0)


def test_sass_raises_without_cuobjdump(monkeypatch, tmp_path):
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    with pytest.raises(_build.KernelBuildError, match="cuobjdump not found"):
        _build.sass("flash_fwd.cu", tmp_path)
