"""TorchTrainer on the port's runtime, on the CPU (gloo), against the JAX
package.

Parity: a 2-worker TorchTrainer runs make_train_step over a data mesh
(parallel.make_mesh) for 3 AdamW steps (lr 1e-3, weight decay 0.01) on
one global batch of 4 rows, from TINY params made by the JAX package's
Transformer.init (f32), once unmasked and once with a loss mask whose
sum differs between the two ranks' rows (so the global masked mean is
not the mean of the ranks' means); the JAX make_train_step runs the same
steps on a 2-device data mesh. Per-step loss and grad norm agree to rtol 1e-4 (f32
sums in another order), the tolerance of test_torch_train_step.py; the
checkpointed params to rtol 1e-4, atol 1e-5 as there. Also: a GPU demand
on this GPU-less box fails the run naming GPU, and a chaos kill during a
checkpoint save resumes from the newest complete checkpoint (the mirror
of tests/test_elastic.py's test on the port's backend).
"""

import os
import time

import numpy as np
import pytest

import jax
import optax

import ray_tpu_torch
from ray_tpu.models import TINY as JTINY
from ray_tpu.models import Transformer as JTransformer
from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu.parallel import make_mesh as jax_make_mesh
from ray_tpu.parallel.train_step import make_train_step as jax_make_train_step
from ray_tpu_torch import chaos, train
from ray_tpu_torch.train import (Checkpoint, FailureConfig, RunConfig,
                                 ScalingConfig, TorchConfig, TorchTrainer)
from ray_tpu_torch.train.backend_executor import TrainingWorkerError

STEPS = 3
WORKERS = 2
# loss-mask density of each of the 4 rows: ranks 0 and 1 hold unequal sums
MASK_DENSITY = (0.15, 0.3, 0.8, 1.0)


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _flat(tree):
    out = {}
    for k, v in tree.items():
        if k == "layers":
            out.update({f"layers.{n}": np.asarray(a) for n, a in v.items()})
        else:
            out[k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def dp_run(cluster, tmp_path_factory):
    """The 2-worker gloo run; rank 0 checkpoints its final params."""
    jcfg = JTINY.replace(dtype="float32")
    params = jax.tree.map(np.asarray, jax.jit(
        JTransformer.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (4, 33)).astype(np.int32)
    mask = (rng.random((4, 32))
            < np.asarray(MASK_DENSITY)[:, None]).astype(np.float32)
    assert mask[:2].sum() != mask[2:].sum()
    batches = {"unmasked": {"tokens": tokens},
               "masked": {"tokens": tokens, "mask": mask}}
    tmp = tmp_path_factory.mktemp("dp")

    def loop(config):
        import torch
        import torch.distributed as dist

        from ray_tpu_torch.models import TINY, Transformer
        from ray_tpu_torch.parallel import MeshConfig, make_mesh
        from ray_tpu_torch.parallel.train_step import adamw, make_train_step

        # two workers share the box's cores: one thread each, not 2 x all
        torch.set_num_threads(1)
        mesh = make_mesh(MeshConfig(data=-1), device="cpu")
        runs = {}
        for name in config["batches"]:
            model = Transformer(TINY.replace(dtype="float32"), device="cpu")
            model.load_jax_params(config["params"])
            init, step = make_train_step(
                lambda p, b, model=model: model.loss(b), None, mesh,
                optimizer=adamw(1e-3, weight_decay=0.01), device="cpu")
            runs[name] = [init(dict(model.named_parameters())), step]
        rank = train.get_context().get_world_rank()
        for i in range(STEPS):
            metrics = {"backend": dist.get_backend(),
                       "world": dist.get_world_size()}
            for name, run in runs.items():
                run[0], m = run[1](run[0], config["batches"][name])
                metrics[name] = {"loss": m["loss"].item(),
                                 "grad_norm": m["grad_norm"].item()}
            ckpt = None
            if rank == 0 and i == STEPS - 1:
                state = runs["unmasked"][0]
                ckpt = Checkpoint(config["ckpt_dir"])
                ckpt.save_pytree({"params": state["params"],
                                  "step": state["step"]})
            train.report(metrics, checkpoint=ckpt)

    os.makedirs(tmp / "ckpt")
    result = TorchTrainer(
        loop,
        train_loop_config={"params": params, "batches": batches,
                           "ckpt_dir": str(tmp / "ckpt")},
        scaling_config=ScalingConfig(num_workers=WORKERS, use_gpu=False),
        run_config=RunConfig(storage_path=str(tmp), name="dp")).fit()
    assert result.error is None, result.error
    return params, batches, result


@pytest.fixture(scope="module")
def jax_run(dp_run):
    """Per batch: the JAX step's losses, grad norms and final params."""
    params, batches, _ = dp_run
    jcfg = JTINY.replace(dtype="float32")
    mesh = jax_make_mesh(JMeshConfig(data=WORKERS),
                         devices=jax.devices()[:WORKERS])
    j_init, j_step = jax_make_train_step(
        lambda p, b: JTransformer.loss(p, b, jcfg, mesh=mesh),
        JTransformer.param_specs(jcfg), mesh,
        optimizer=optax.adamw(1e-3, weight_decay=0.01))
    out = {}
    for name, batch in batches.items():
        state = j_init(jax.tree.map(jax.numpy.asarray, params))
        losses, gnorms = [], []
        for _ in range(STEPS):
            state, m = j_step(state, batch)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        out[name] = (losses, gnorms, _flat(jax.device_get(state["params"])))
    return out


@pytest.mark.parametrize("batch", ["unmasked", "masked"])
def test_data_parallel_trainer_matches_jax_data_mesh(dp_run, jax_run, batch):
    _, _, result = dp_run
    hist = result.metrics_history
    assert [h["backend"] for h in hist] == ["gloo"] * STEPS
    assert [h["world"] for h in hist] == [WORKERS] * STEPS
    j_loss, j_gnorm, _ = jax_run[batch]
    np.testing.assert_allclose([h[batch]["loss"] for h in hist], j_loss,
                               rtol=1e-4)
    np.testing.assert_allclose([h[batch]["grad_norm"] for h in hist],
                               j_gnorm, rtol=1e-4)
    assert hist[-1][batch]["loss"] < hist[0][batch]["loss"]


def test_checkpoint_round_trip_through_result(dp_run, jax_run):
    import torch

    _, _, result = dp_run
    final = jax_run["unmasked"][2]
    target = {"params": {n: torch.zeros(a.shape) for n, a in final.items()},
              "step": 0}
    tree = result.checkpoint.load_pytree(target=target)
    assert tree["step"] == STEPS
    for name, want in final.items():
        np.testing.assert_allclose(tree["params"][name].numpy(), want,
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    with pytest.raises(ValueError, match="shape"):
        bad = dict(target["params"], embed=torch.zeros(1))
        result.checkpoint.load_pytree(target={"params": bad, "step": 0})
    with pytest.raises(ValueError, match="keys"):
        result.checkpoint.load_pytree(target={"params": {}, "step": 0})


def test_gpu_demand_without_gpus_raises_naming_gpu(cluster, tmp_path):
    """ScalingConfig() asks each worker for a GPU; on a cluster without
    one the run fails within its reform deadline and never carries on
    on the CPU (the mirror of tests/test_elastic.py's bounded re-form)."""
    assert ScalingConfig()._resources_per_worker_not_none == \
        {"CPU": 1, "GPU": 1}
    assert ray_tpu_torch.cluster_resources().get("GPU", 0) == 0
    ran = tmp_path / "ran"

    def loop():
        ran.write_text("on the CPU")

    t0 = time.monotonic()
    with pytest.raises(TrainingWorkerError, match="GPU"):
        TorchTrainer(loop, scaling_config=ScalingConfig(
            num_workers=1, elastic_min_workers=1,
            elastic_reform_timeout_s=1.0),
            run_config=RunConfig(storage_path=str(tmp_path))).fit()
    assert time.monotonic() - t0 < 60
    assert not ran.exists()


def test_chaos_kill_during_save_resumes_from_valid_checkpoint(
        cluster, tmp_path):
    """The worker is killed while its loop is inside a slow checkpoint
    save; the run restarts, on a fresh gang and process group, from the
    newest fully persisted checkpoint and completes."""
    chaos.clear()
    steps_log = tmp_path / "executed"

    def loop():
        import torch.distributed as dist
        assert dist.get_backend() == "gloo"
        start = 0
        ckpt = train.get_checkpoint()
        if ckpt:
            meta = ckpt.get_metadata()
            blob = open(os.path.join(ckpt.path, "payload_b.txt")).read()
            assert blob == f"step={meta['step']}", (blob, meta)
            start = meta["step"] + 1
        for step in range(start, 4):
            with open(steps_log, "a") as f:
                f.write(f"{step}\n")
            cdir = str(tmp_path / f"wip_{step}")
            os.makedirs(cdir, exist_ok=True)
            with open(os.path.join(cdir, "payload_a.txt"), "w") as f:
                f.write(f"step={step}")
            time.sleep(0.25)
            with open(os.path.join(cdir, "payload_b.txt"), "w") as f:
                f.write(f"step={step}")
            c = Checkpoint(cdir)
            c.update_metadata({"step": step})
            train.report({"step": step}, checkpoint=c)

    # pushes into the worker: node_info, the GPU split, the backend's
    # probe, node address, port and process-group init (6), then
    # init_session (7), start_training_session (8) and one next_result
    # per round: after_n=10 kills on the step-2 round's push, which lands
    # while the loop is inside step 2's slow save
    rid = chaos.inject("kill_worker", actor_class="RayTrainWorker",
                       after_n=10, max_fires=1)
    try:
        result = TorchTrainer(
            loop,
            torch_config=TorchConfig(),
            scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
            run_config=RunConfig(
                storage_path=str(tmp_path), name="atomic",
                failure_config=FailureConfig(max_failures=3))).fit()
        assert result.error is None, f"run failed: {result.error!r}"
        assert result.metrics["step"] == 3
        fired = [r["fired"] for r in chaos.list_rules()
                 if r["rule_id"] == rid]
        assert fired and fired[0] >= 1, "kill_worker rule never fired"
        executed = [int(x) for x in steps_log.read_text().split()]
        assert executed[0] == 0 and executed.count(0) == 1, executed
        assert len(executed) > len(set(executed)), \
            f"no step re-ran after the kill: {executed}"
        run_dir = os.path.join(str(tmp_path), "atomic")
        from ray_tpu_torch.train.checkpoint_manager import (
            latest_checkpoint_path, read_latest_pointer)
        names = sorted(d for d in os.listdir(run_dir)
                       if d.startswith("checkpoint_"))
        assert names, "no checkpoints persisted"
        for name in names:
            cdir = os.path.join(run_dir, name)
            meta = Checkpoint(cdir).get_metadata()
            for payload in ("payload_a.txt", "payload_b.txt"):
                with open(os.path.join(cdir, payload)) as f:
                    assert f.read() == f"step={meta['step']}", cdir
        assert read_latest_pointer(run_dir) is not None
        assert latest_checkpoint_path(run_dir) == \
            os.path.join(run_dir, names[-1])
        assert not [d for d in os.listdir(run_dir)
                    if d.startswith(".tmp-")]
    finally:
        chaos.clear()
