"""TransformersTrainer: HF Transformers fine-tuning over the worker gang.

reference parity: python/ray/train/huggingface/transformers —
TransformersTrainer wraps a `trainer_init_per_worker` returning a
`transformers.Trainer`; the Ray side gangs the workers, wires the torch
process group (gloo here; the reference prepares the same env), injects
a report callback translating HF logs into `ray_tpu_torch.train.report`
calls, and runs `trainer.train()` on every rank. TPU-first note: this
exists for parity with torch-side HF workloads — the first-class path
for transformer training on TPU is JaxTrainer + the in-tree model stack.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.data_parallel_trainer import DataParallelTrainer
from ray_tpu_torch.train.torch_backend import TorchConfig


def prepare_trainer(trainer):
    """Attach the report callback bridging HF logging to
    ray_tpu_torch.train.report (reference: RayTrainReportCallback).
    Idempotent: TransformersTrainer also calls this automatically, and
    user init functions following the reference pattern call it too —
    the callback must not attach twice (doubled report streams)."""
    from transformers import TrainerCallback

    import ray_tpu_torch.train as train_mod

    class _RayTpuReportCallback(TrainerCallback):
        def on_log(self, args, state, control, logs=None, **kwargs):
            if logs:
                metrics = {k: v for k, v in logs.items()
                           if isinstance(v, (int, float))}
                metrics["step"] = state.global_step
                train_mod.report(metrics)

        def on_save(self, args, state, control, **kwargs):
            # bridge HF checkpoint saves into the session's checkpoint
            # stream (reference RayTrainReportCallback does the same),
            # so fit() returns real checkpoints and resume works
            import os
            from ray_tpu_torch.train.checkpoint import Checkpoint
            ckpt_dir = os.path.join(
                args.output_dir, f"checkpoint-{state.global_step}")
            if os.path.isdir(ckpt_dir):
                train_mod.report({"step": state.global_step,
                                  "hf_checkpoint": True},
                                 checkpoint=Checkpoint(ckpt_dir))

    if not any(type(cb).__name__ == "_RayTpuReportCallback"
               for cb in trainer.callback_handler.callbacks):
        trainer.add_callback(_RayTpuReportCallback())
    return trainer


class TransformersTrainer(DataParallelTrainer):
    """`trainer_init_per_worker(config) -> transformers.Trainer`; each
    rank builds its trainer inside the torch process group and trains."""

    _backend_config_cls = TorchConfig

    def __init__(self,
                 trainer_init_per_worker: Callable,
                 *,
                 trainer_init_config: Optional[Dict[str, Any]] = None,
                 torch_config: Optional[TorchConfig] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None):
        init_fn = trainer_init_per_worker

        def train_loop(config: Dict[str, Any]) -> None:
            import logging
            import os
            import ray_tpu_torch.train as train_mod
            trainer = init_fn(config)
            prepare_trainer(trainer)
            ckpt = train_mod.get_checkpoint()
            resume = None
            if ckpt is not None:
                # only hand HF a dir it can actually resume from; a
                # non-HF checkpoint (user-reported dir, older run)
                # would raise inside trainer.train on EVERY restart,
                # turning a recoverable failure into a crash loop
                if os.path.exists(os.path.join(ckpt.path,
                                               "trainer_state.json")):
                    resume = ckpt.path
                else:
                    logging.getLogger(__name__).warning(
                        "checkpoint %s is not an HF trainer "
                        "checkpoint; training from scratch", ckpt.path)
            trainer.train(resume_from_checkpoint=resume)

        super().__init__(
            train_loop,
            train_loop_config=trainer_init_config,
            backend_config=torch_config or TorchConfig(),
            scaling_config=scaling_config,
            run_config=run_config,
            datasets=datasets,
            resume_from_checkpoint=resume_from_checkpoint)
