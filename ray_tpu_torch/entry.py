"""Entry points of the port (counterpart of __graft_entry__.py).

entry(cfg=None, device=None) -> (fn, example_args): the forward of the
    flagship decoder (GPT2_125M unless `cfg` names another) as a
    function of (params, tokens), with seed-0 params and zero tokens
    [4, max_seq_len]. GPT2_125M's attention_impl is "dense", so the
    default forward takes the port's dense attention, as the JAX
    package's takes XLA's.
dryrun_multichip(n, device=None) -> {variant: loss}: builds the n-rank
    mesh of the JAX package's dry run and runs ONE step of the sharded
    training step (data/fsdp/tensor/seq axes, the params and AdamW's
    moments sharded by Transformer.param_specs, ring attention over
    `seq`); for an even n also one step of the layer stack as a
    pipeline over pipe=2 and one of MoE layers over expert=2. Each step
    prints `dryrun_multichip(n): mesh={...} loss=... ok`.

Both run on the card unless the caller names another device.
"""

from __future__ import annotations

import datetime
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ray_tpu_torch._device import DeviceLike, resolve_device

# the JAX package's dry run: TINY in f32, its keys 0|2|4 (params) and
# 1|3|5 (tokens), here torch generators of those seeds
VARIANTS = ("sharded", "pipe", "expert")
PARAM_SEEDS = {"sharded": 0, "pipe": 2, "expert": 4}
TOKEN_SEEDS = {"sharded": 1, "pipe": 3, "expert": 5}
PIPE_STAGES, PIPE_MICRO = 2, 4
LR = 1e-3
COLLECTIVE_TIMEOUT_S = 300


def entry(cfg=None, device: DeviceLike = None
          ) -> Tuple[Callable, Tuple[Dict[str, torch.Tensor], torch.Tensor]]:
    """(forward, (params, tokens)): forward(params, tokens) -> logits
    [B, T, vocab] f32 of the decoder `cfg` (GPT2_125M when None) with
    `params` (name -> tensor, the Transformer's parameters), through
    torch.func.functional_call; params from seed 0, tokens int32 zeros
    [4, cfg.max_seq_len], both on `device` (the card when None)."""
    from ray_tpu_torch.models import GPT2_125M, Transformer
    cfg = GPT2_125M if cfg is None else cfg
    dev = resolve_device(device)
    model = Transformer(cfg, dev, seed=0)
    tokens = torch.zeros((4, cfg.max_seq_len), dtype=torch.int32, device=dev)

    def forward(params, tokens):
        return torch.func.functional_call(model, params, (tokens,))

    return forward, (dict(model.named_parameters()), tokens)


def mesh_sizes(n_devices: int) -> Dict[str, int]:
    """n_devices over the parallelism axes innermost first: 2 to
    tensor, then seq, then fsdp while the count stays even, the rest to
    data (4 -> tensor 2 x seq 2; 8 -> tensor 2 x seq 2 x fsdp 2)."""
    remaining = n_devices
    sizes = {}
    for axis in ("tensor", "seq", "fsdp", "data"):
        take = 2 if remaining % 2 == 0 and remaining >= 2 else 1
        if axis == "data":
            take = remaining
        sizes[axis] = take
        remaining //= take
    return sizes


def variant_configs(device_type: str):
    """{variant: TransformerConfig}. On the CPU the JAX dry run's TINY
    in f32 (ring attention for the sharded step; dense for the pipeline
    and the MoE layers). On the card the same variants at bf16 and
    d_model 256 (4 heads of 64, 2 kv heads, d_ff 512): the flash kernels
    behind ring attention take bf16 and head_dim 64 or 128 only, and
    this is TINY's narrowest width they take."""
    from ray_tpu_torch.models import TINY
    base = TINY.replace(dtype="float32")
    if device_type == "cuda":
        base = TINY.replace(dtype="bfloat16", d_model=256, d_ff=512)
    return {"sharded": base.replace(attention_impl="ring"),
            "pipe": base.replace(attention_impl="dense", loss_chunk=0),
            "expert": base.replace(moe_experts=4, moe_top_k=2,
                                   loss_chunk=0)}


def variant_inputs(n_devices: int, device_type: str):
    """{variant: (params, tokens)}: the port's seeded init of each
    variant's model (its state_dict, on the CPU) and tokens [B, T + 1]
    int64: B = max(4, 2 n) and T = 32 x seq for the sharded step,
    8 x 33 for the others."""
    from ray_tpu_torch.models import Transformer
    seq = mesh_sizes(n_devices)["seq"]
    shapes = {"sharded": (max(4, 2 * n_devices), 32 * seq + 1),
              "pipe": (8, 33), "expert": (8, 33)}
    out = {}
    for name, cfg in variant_configs(device_type).items():
        if name != "sharded" and n_devices % 2:
            continue
        params = Transformer(cfg, "cpu", seed=PARAM_SEEDS[name]).state_dict()
        gen = torch.Generator().manual_seed(TOKEN_SEEDS[name])
        out[name] = (params, torch.randint(0, cfg.vocab_size, shapes[name],
                                           generator=gen))
    return out


def _mesh_line(n_devices, mesh, loss):
    from ray_tpu_torch.parallel.mesh import MESH_AXIS_ORDER, mesh_shape
    shape = mesh_shape(mesh)
    full = {a: shape.get(a, 1) for a in MESH_AXIS_ORDER}
    return f"dryrun_multichip({n_devices}): mesh={full} loss={loss:.4f} ok"


def _one_step(mesh, params, tokens, cfg, loss_fn):
    """One make_train_step step of `cfg`'s model on `mesh` from `params`
    (a state_dict or a JAX Transformer.init tree), AdamW(1e-3); the
    loss, checked plausible."""
    from ray_tpu_torch.models import Transformer
    from ray_tpu_torch.parallel.train_step import adamw, make_train_step
    model = Transformer(cfg, device="meta")
    model.load_jax_params(params, mesh=mesh)
    init_state, train_step = make_train_step(
        lambda p, b: loss_fn(model, b), Transformer.param_specs(cfg), mesh,
        optimizer=adamw(LR), device=mesh.device_type)
    state = init_state(model)
    state, metrics = train_step(state, {"tokens": tokens})
    loss = float(metrics["loss"].cpu())
    if not 0.0 < loss < 20.0:
        raise AssertionError(f"implausible loss {loss}")
    return loss


def sharded_step(mesh, params, tokens, cfg) -> float:
    """Transformer.loss on the mesh: the sharded step over data, fsdp,
    seq and tensor (ring attention over `seq`), and the MoE layers'
    step with the experts split over `expert`."""
    return _one_step(mesh, params, tokens, cfg,
                     lambda m, b: m.loss(b, mesh=mesh))


def pipeline_step(mesh, params, tokens, cfg) -> float:
    """The layer stack as a pipeline: Transformer.pipeline_loss over
    pipe=2 in 4 microbatches. The port's pipeline splits each data
    rank's own rows into microbatches, so past 4 data ranks (8 rows) a
    rank runs as many as it has rows; the loss, a mean over equal
    microbatches, is the same."""
    from ray_tpu_torch.parallel.mesh import mesh_shape
    rows = len(tokens) // mesh_shape(mesh)["data"]
    return _one_step(mesh, params, tokens, cfg,
                     lambda m, b: m.pipeline_loss(
                         b, mesh=mesh, n_stages=PIPE_STAGES,
                         n_micro=min(PIPE_MICRO, rows)))


def _run_rank(rank, n_devices, device_type, inputs, ports, results):
    import torch.distributed as dist

    from ray_tpu_torch.parallel import MeshConfig, make_mesh
    timeout = datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)
    if rank == 0:   # the group's store, on a port the kernel picks
        store = dist.TCPStore("127.0.0.1", 0, n_devices, is_master=True,
                              timeout=timeout, wait_for_workers=False)
        for _ in range(n_devices - 1):
            ports.put(store.port)
    else:
        store = dist.TCPStore("127.0.0.1", ports.get(), n_devices,
                              is_master=False, timeout=timeout)
    if device_type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", store=store, rank=rank,
                                world_size=n_devices, timeout=timeout,
                                device_id=dev)
    else:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=n_devices, timeout=timeout)
    say = print if rank == 0 else (lambda *args, **kw: None)
    try:
        sizes = mesh_sizes(n_devices)
        cfgs = variant_configs(device_type)
        meshes = {"sharded": MeshConfig(**sizes),
                  "pipe": MeshConfig(data=n_devices // 2, pipe=PIPE_STAGES),
                  "expert": MeshConfig(data=n_devices // 2, expert=2)}
        steps = {"sharded": sharded_step, "pipe": pipeline_step,
                 "expert": sharded_step}
        losses = {}
        for name in VARIANTS:
            if name not in inputs:
                continue
            params, tokens = inputs[name]
            mesh = make_mesh(meshes[name], device=device_type)
            losses[name] = steps[name](mesh, params, tokens, cfgs[name])
            say(_mesh_line(n_devices, mesh, losses[name]), flush=True)
        if rank == 0:
            results.put(losses)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: DeviceLike = None, *,
                     inputs: Optional[Dict[str, Tuple[Any, Any]]] = None
                     ) -> Dict[str, float]:
    """One step of each dry-run variant on `n_devices` ranks; returns
    {variant: loss} ("sharded", and for an even n "pipe" and "expert").

    device="cpu": the ranks are n forked processes over gloo. The card
    (None or "cuda"): n spawned processes over NCCL, rank r on card r,
    raising with fewer than n cards. `inputs` ({variant: (params,
    tokens)}, params a state_dict or a JAX Transformer.init tree, tokens
    [B, T + 1]) replaces variant_inputs' seeded ones."""
    import torch.multiprocessing as mp
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) takes one card a "
                           f"rank; {torch.cuda.device_count()} visible")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"dryrun_multichip runs on cuda or cpu, not "
                         f"{dev.type}")
    if inputs is None:
        inputs = variant_inputs(n_devices, dev.type)
    if dev.type == "cuda":   # once here, not in every rank at once
        from ray_tpu_torch.ops import _build
        _build.build()
    # fork shares the parent's imports; a CUDA context does not survive
    # a fork, so card ranks start fresh
    method = "spawn" if dev.type == "cuda" else "fork"
    ctx = mp.get_context(method)
    ports, results = ctx.SimpleQueue(), ctx.SimpleQueue()
    mp.start_processes(_run_rank, args=(n_devices, dev.type, inputs, ports,
                                        results),
                       nprocs=n_devices, start_method=method)
    return results.get()
