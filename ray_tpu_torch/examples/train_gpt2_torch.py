"""TorchTrainer: sharded GPT-2-class training.

Runs a decoder on the available mesh (data+fsdp+tensor axes) via the
Train worker-group machinery: gang-scheduled workers, the torch process
group (NCCL on the card, gloo on the CPU), session report flow. On the
card a config whose attention_impl is "auto" or "flash" runs attention
forward and backward through the flash-attention kernels.

    python -m ray_tpu_torch.examples.train_gpt2_torch   # TINY, on the card
"""

import ray_tpu_torch
from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer


def train_loop(config):
    import torch

    import ray_tpu_torch.train as train
    from ray_tpu_torch import models
    from ray_tpu_torch.models import Transformer
    from ray_tpu_torch.parallel import MeshConfig, make_mesh
    from ray_tpu_torch.parallel.train_step import adamw, make_train_step

    # a preset's name in ray_tpu_torch.models, or a TransformerConfig
    cfg = config.get("model", "TINY")
    if isinstance(cfg, str):
        cfg = getattr(models, cfg)
    device = config.get("device")
    mesh = make_mesh(MeshConfig(data=-1), device=device)
    model = Transformer(cfg, device, seed=0)
    init_state, step = make_train_step(
        lambda p, b: model.loss(b, mesh=mesh),
        Transformer.param_specs(cfg), mesh,
        optimizer=adamw(3e-4), device=device)
    state = init_state(model)
    tokens = torch.randint(
        0, cfg.vocab_size, (8, cfg.max_seq_len + 1),
        generator=torch.Generator().manual_seed(1))
    for i in range(config.get("steps", 10)):
        state, metrics = step(state, {"tokens": tokens})
        train.report({"step": i, "loss": float(metrics["loss"])})


def main(model="TINY", steps=10, device=None):
    ray_tpu_torch.init(num_cpus=4)
    trainer = TorchTrainer(
        train_loop,
        train_loop_config={"steps": steps, "model": model, "device": device},
        scaling_config=ScalingConfig(num_workers=1,
                                     use_gpu=device != "cpu"),
        run_config=RunConfig(name="gpt2_tiny_demo"))
    result = trainer.fit()
    print("final:", result.metrics)
    ray_tpu_torch.shutdown()
    return result


if __name__ == "__main__":
    main()
