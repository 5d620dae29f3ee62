"""Gloo ranks of the port's multi-rank tests (tests/test_torch_sharded_*.py,
test_torch_seq_parallel.py, test_torch_moe.py, test_torch_pipeline.py,
test_torch_multislice.py, test_torch_vocab_parallel.py,
test_torch_mesh_steps.py).

    python tests/_torch_sharded_workers.py JOB INPUT RANK WORLD RENDEZVOUS OUTPUT

Each process is one rank of a CPU process group. INPUT is a pickle of
numpy data (JAX Transformer.init params, batches) written by the test;
rank 0 pickles what JOB returns to OUTPUT. Rank 0's store listens on a
port the kernel picks and writes it to the file RENDEZVOUS, where the
other ranks read it: a free port picked before the bind could be taken
by another process in between. The module imports torch and
the port only, never jax, so a rank starts in a few seconds. `start`
launches the ranks from a test and `Ranks.result` waits for them; a
collective that waits longer than COLLECTIVE_TIMEOUT_S raises in its
rank, so a hang fails its test within the job's own timeout.
"""

import datetime
import os
import pickle
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STEPS = 3
COLLECTIVE_TIMEOUT_S = 60


def _build(cfg, params, mesh, lr=1e-3, weight_decay=0.01, loss=None):
    from ray_tpu_torch.models import Transformer
    from ray_tpu_torch.parallel.train_step import adamw, make_train_step
    model = Transformer(cfg, device="meta")
    model.load_jax_params(params, mesh=mesh)
    loss = loss or (lambda m, b: m.loss(b, mesh=mesh))
    init, step = make_train_step(
        lambda p, b: loss(model, b), Transformer.param_specs(cfg),
        mesh, optimizer=adamw(lr, weight_decay=weight_decay), device="cpu")
    return model, init(model), step


def _run(state, step, batch, steps):
    losses, gnorms = [], []
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(m["loss"].item())
        gnorms.append(m["grad_norm"].item())
    return state, losses, gnorms


def _full(tree):
    return {n: t.full_tensor().detach().numpy() for n, t in tree.items()}


def fsdp_tensor(data):
    """fsdp=2 x tensor=2 (and tensor=4, fsdp=4) on 4 ranks."""
    import torch

    from ray_tpu_torch.models import TINY, Transformer
    from ray_tpu_torch.models.transformer import _Sharded
    from ray_tpu_torch.parallel import (MeshConfig, ShardingRules, make_mesh,
                                        with_logical_constraint)
    from ray_tpu_torch.parallel.sharding import (flatten_specs,
                                                 logical_sharding, place)
    from ray_tpu_torch.train.checkpoint import Checkpoint

    cfg = TINY.replace(dtype="float32")
    mesh = make_mesh(MeshConfig(data=1, fsdp=2, tensor=2), device="cpu")
    out = {}
    for name, batch in data["batches"].items():
        _, state, step = _build(cfg, data["params"], mesh)
        state, losses, gnorms = _run(state, step, batch, STEPS)
        out[name] = {"loss": losses, "grad_norm": gnorms,
                     "params": _full(state["params"])}
        if name != "unmasked":
            continue
        params, opt = state["params"], state["opt_state"]
        out["local_shapes"] = {n: tuple(p.to_local().shape)
                               for n, p in params.items()}
        out["placements"] = {
            n: {"param": tuple(p.placements),
                "grad": tuple(p.grad.placements),
                "exp_avg": tuple(opt.state[p]["exp_avg"].placements),
                "exp_avg_sq": tuple(opt.state[p]["exp_avg_sq"].placements)}
            for n, p in params.items()}
        # embed's ("vocab", "embed") placements redistributed to
        # ("vocab", None): the embed dim gathered over fsdp
        moved = with_logical_constraint(params["embed"], ("vocab", None),
                                        mesh)
        out["constrained"] = {
            "placements": tuple(moved.placements),
            "equal": bool(torch.equal(moved.full_tensor(),
                                      params["embed"].full_tensor()))}
        # a sharded checkpoint of the params and a moment, read back onto
        # the same mesh and onto fsdp=4
        tree = {"params": params,
                "exp_avg": {n: opt.state[p]["exp_avg"]
                            for n, p in params.items()}}
        ckpt = Checkpoint(data["ckpt_dir"])
        ckpt.save_pytree(tree)
        mesh4 = make_mesh(MeshConfig(data=1, fsdp=4), device="cpu")
        specs = flatten_specs(Transformer.param_specs(cfg))

        def on_fsdp4(t, n):
            return place(torch.zeros(t.shape), mesh4,
                         logical_sharding(specs[n], mesh4, shape=t.shape))

        want = {k: _full(v) for k, v in tree.items()}
        for label, target in (
                ("same mesh", tree),
                ("fsdp=4", {k: {n: on_fsdp4(t, n) for n, t in v.items()}
                            for k, v in tree.items()})):
            got = ckpt.load_pytree(target=target)
            out.setdefault("checkpoint", {})[label] = {
                "max_abs_diff": max(float(np.abs(_full(got[k])[n] - a).max())
                                    for k, v in want.items()
                                    for n, a in v.items()),
                "placements": {n: tuple(t.placements)
                               for n, t in got["params"].items()},
                "fresh": all(got[k][n] is not tree[k][n] for k in tree
                             for n in tree[k])}

    # one step's grads with each remat policy, from the same params
    grads = {}
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        _, state, step = _build(cfg.replace(remat=remat, remat_policy=policy),
                                data["params"], mesh)
        step(state, data["batches"]["masked"])
        grads[policy if remat else "none"] = {
            n: p.grad.full_tensor().numpy()
            for n, p in state["params"].items()}
    out["remat_grads"] = grads

    # tensor=4: 2 kv heads do not divide it, so k and v are widened
    mesh_t4 = make_mesh(MeshConfig(data=1, tensor=4), device="cpu")
    model, state, step = _build(cfg, data["params"], mesh_t4)
    state, losses, gnorms = _run(state, step, data["batches"]["unmasked"],
                                 STEPS)
    out["tensor4"] = {"loss": losses, "grad_norm": gnorms,
                      "params": _full(state["params"]),
                      "widen": _Sharded(model, mesh_t4, ShardingRules()).widen,
                      "wkv_placements": tuple(
                          state["params"]["layers.wkv"].placements)}
    return out


def three_d(data):
    """data=2 x fsdp=2 x tensor=2 on 8 ranks: 10 Adam steps on one batch."""
    from ray_tpu_torch.models import TINY
    from ray_tpu_torch.parallel import MeshConfig, make_mesh

    cfg = TINY.replace(dtype="float32")
    mesh = make_mesh(MeshConfig(data=2, fsdp=2, tensor=2), device="cpu")
    _, state, step = _build(cfg, data["params"], mesh, lr=1e-2,
                            weight_decay=0.0)
    state, losses, _ = _run(state, step, data["batch"], 10)
    return {"loss": losses, "step": state["step"],
            "placements": {n: tuple(p.placements)
                           for n, p in state["params"].items()}}


def vocab_parallel(data):
    """The vocab-parallel embedding, head and cross-entropy on fsdp=2 x
    tensor=2, 4 ranks: for tied and untied embeddings, chunked and not,
    STEPS steps (the first step's grads too), and the widths of every
    head the loss multiplied by; the logits of forward."""
    from ray_tpu_torch.models import TINY
    from ray_tpu_torch.models import transformer as tmod
    from ray_tpu_torch.parallel import MeshConfig, make_mesh

    mesh = make_mesh(MeshConfig(data=1, fsdp=2, tensor=2), device="cpu")
    out = {}
    dot = tmod._dot_f32
    for case, (tie, chunk) in data["cases"].items():
        cfg = TINY.replace(dtype="float32", tie_embeddings=tie,
                           loss_chunk=chunk)
        widths = []

        def recording(x, w):
            widths.append(tuple(w.shape))
            return dot(x, w)

        model, state, step = _build(cfg, data["params"][case], mesh)
        if case == "untied":
            logits = model(_block(data["batch"]["tokens"][:, :-1], mesh,
                                  {0: ("data", "fsdp")}), mesh=mesh)
            out["logits"] = _assemble(logits, mesh, {0: ("data", "fsdp")})
        tmod._dot_f32 = recording
        try:
            state, m = step(state, data["batch"])
        finally:
            tmod._dot_f32 = dot
        grads = {n: p.grad.full_tensor().numpy()
                 for n, p in state["params"].items()}
        state, losses, gnorms = _run(state, step, data["batch"], STEPS - 1)
        out[case] = {"loss": [m["loss"].item()] + losses,
                     "grad_norm": [m["grad_norm"].item()] + gnorms,
                     "grads": grads, "params": _full(state["params"]),
                     "head_widths": widths}
    return out


def mesh_steps(data):
    """On 2 x (data=2 x tensor=2), 8 ranks: the replicated-params step
    (param_specs None) and the sharded step with "dcn" in the batch rules,
    STEPS steps each from the same params."""
    from ray_tpu_torch.models import TINY, Transformer
    from ray_tpu_torch.parallel import (MeshConfig, MultiSliceConfig,
                                        ShardingRules, make_multislice_mesh)
    from ray_tpu_torch.parallel.train_step import adamw, make_train_step

    cfg = TINY.replace(dtype="float32")
    mesh = make_multislice_mesh(MultiSliceConfig(
        num_slices=2, per_slice=MeshConfig(data=2, tensor=2)), device="cpu")
    out = {}
    model = Transformer(cfg, device="cpu")
    model.load_jax_params(data["params"])
    init, step = make_train_step(lambda p, b: model.loss(b), None, mesh,
                                 optimizer=adamw(1e-3, weight_decay=0.01),
                                 device="cpu")
    state, losses, gnorms = _run(init(model), step, data["batch"], STEPS)
    out["replicated"] = {
        "loss": losses, "grad_norm": gnorms,
        "params": {n: p.detach().numpy().copy()
                   for n, p in state["params"].items()}}

    rules = ShardingRules().replace(batch=("dcn", "data", "fsdp"))
    model = Transformer(cfg, device="meta")
    model.load_jax_params(data["params"], mesh=mesh, rules=rules)
    init, step = make_train_step(
        lambda p, b: model.loss(b, mesh=mesh, rules=rules),
        Transformer.param_specs(cfg), mesh,
        optimizer=adamw(1e-3, weight_decay=0.01), rules=rules, device="cpu")
    state, losses, gnorms = _run(init(model), step, data["batch"], STEPS)
    out["dcn"] = {"loss": losses, "grad_norm": gnorms,
                  "params": _full(state["params"])}
    return out


def _coord(mesh):
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def _block(a, mesh, split):
    """This rank's block of numpy array `a`: `split` maps each array dim
    to the mesh axes splitting it, major first (absent axes: size 1)."""
    sizes, coord = dict(zip(mesh.mesh_dim_names, mesh.shape)), _coord(mesh)
    index = []
    for dim, n in enumerate(a.shape):
        i, c = 0, 1
        for axis in split.get(dim, ()):
            i, c = i * sizes.get(axis, 1) + coord.get(axis, 0), \
                c * sizes.get(axis, 1)
        index.append(slice(i * (n // c), (i + 1) * (n // c)))
    return a[tuple(index)]


def _assemble(local, mesh, split):
    """Every rank's block of one array (split as in _block), put together
    on every rank as a numpy array."""
    import numpy as np
    import torch.distributed as dist
    items = [None] * dist.get_world_size()
    dist.all_gather_object(items, (_coord(mesh), local.detach().numpy()))
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    counts = [1] * local.dim()
    for dim, axes in split.items():
        for axis in axes:
            counts[dim] *= sizes.get(axis, 1)
    out = np.zeros([n * c for n, c in zip(local.shape, counts)],
                   dtype=items[0][1].dtype)
    for coord, block in items:
        index = []
        for dim, n in enumerate(block.shape):
            i = 0
            for axis in split.get(dim, ()):
                i = i * sizes.get(axis, 1) + coord.get(axis, 0)
            index.append(slice(i * n, (i + 1) * n))
        out[tuple(index)] = block
    return out


def _attention_case(fn, mesh, inputs, causal):
    """fn (ring_attention or ulysses_attention) on this rank's block of
    q, k, v ([B, T, H, D], rows over data, columns over seq), and the
    grads of sum(o * do): each assembled whole."""
    import torch
    split = {0: ("data",), 1: ("seq",)}
    q, k, v, do = (torch.tensor(_block(inputs[n], mesh, split),
                                requires_grad=n != "do")
                   for n in ("q", "k", "v", "do"))
    o = fn(q, k, v, mesh=mesh, causal=causal)
    (o * do).sum().backward()
    return {n: _assemble(t, mesh, split)
            for n, t in (("o", o), ("dq", q.grad), ("dk", k.grad),
                         ("dv", v.grad))}


def seq_parallel(data):
    """Ring and Ulysses attention, the model's logits over seq and the
    fsdp=2 x seq=2 x tensor=2 ring step, on 8 ranks."""
    from ray_tpu_torch.models import TINY
    from ray_tpu_torch.parallel import (MeshConfig, make_mesh, ring_attention,
                                        ulysses_attention)
    import ray_tpu_torch.parallel.ring as ring_mod

    out = {}
    seq8 = make_mesh(MeshConfig(data=1, seq=8), device="cpu")
    for causal in (True, False):
        out[f"ring causal={causal}"] = _attention_case(
            ring_attention, seq8, data["ring"], causal)
    mesh = make_mesh(MeshConfig(data=2, seq=4), device="cpu")
    out["ulysses"] = _attention_case(ulysses_attention, mesh,
                                     data["ulysses"], True)
    # GQA: record what the ring's exchange carries
    carried, exchange = [], ring_mod.exchange

    def recording(tensors, axis, shift=1):
        carried.extend(tuple(t.shape) for t in tensors)
        return exchange(tensors, axis, shift)

    ring_mod.exchange = recording
    try:
        out["ring gqa"] = _attention_case(ring_attention, mesh, data["gqa"],
                                          True)
    finally:
        ring_mod.exchange = exchange
    out["ring gqa carried"] = carried
    out["ulysses gqa"] = _attention_case(ulysses_attention, mesh,
                                         data["gqa"], True)

    # the model's logits over data=2 x seq=4
    from ray_tpu_torch.models import Transformer
    cfg = TINY.replace(dtype="float32")
    split = {0: ("data",), 1: ("seq",)}
    tokens = _block(data["tokens"], mesh, split)
    for impl in ("ring", "ulysses"):
        model = Transformer(cfg.replace(attention_impl=impl), device="meta")
        model.load_jax_params(data["params"], mesh=mesh)
        logits = model(tokens, mesh=mesh)
        out[f"logits {impl}"] = _assemble(logits, mesh, split)

    # the ring step on fsdp=2 x seq=2 x tensor=2
    mesh3 = make_mesh(MeshConfig(data=1, fsdp=2, seq=2, tensor=2),
                      device="cpu")
    for remat in (False, True):
        _, state, step = _build(cfg.replace(attention_impl="ring",
                                            remat=remat),
                                data["params"], mesh3)
        state, losses, gnorms = _run(state, step, data["batch"], STEPS)
        out[f"step remat={remat}"] = {"loss": losses, "grad_norm": gnorms,
                                      "params": _full(state["params"])}
    return out


def moe_step(data):
    """The Transformer MoE step on data=2 x expert=4, 8 ranks: one step's
    grads, 3 steps' losses and params, placements, a sharded checkpoint
    read back."""
    from ray_tpu_torch.models import TINY
    from ray_tpu_torch.parallel import MeshConfig, make_mesh
    from ray_tpu_torch.train.checkpoint import Checkpoint

    cfg = TINY.replace(dtype="float32", moe_experts=4, moe_top_k=2,
                       loss_chunk=0,
                       moe_capacity_factor=data["capacity_factor"])
    mesh = make_mesh(MeshConfig(data=2, expert=4), device="cpu")
    out = {}
    model, state, step = _build(cfg, data["params"], mesh, lr=1e-2,
                                weight_decay=1e-4)
    state, metrics = step(state, data["batch"])
    out["grads"] = {n: p.grad.full_tensor().numpy()
                    for n, p in state["params"].items()}
    out["dropped"] = model.moe_dropped.numpy()
    state, losses, _ = _run(state, step, data["batch"], STEPS - 1)
    out["loss"] = [metrics["loss"].item()] + losses
    out["params"] = _full(state["params"])
    params = state["params"]
    out["placements"] = {n: tuple(p.placements) for n, p in params.items()}
    out["local_up"] = tuple(params["layers.w_moe_up"].to_local().shape)
    ckpt = Checkpoint(data["ckpt_dir"])
    ckpt.save_pytree({"params": params})
    got = ckpt.load_pytree(target={"params": params})
    out["checkpoint"] = max(
        float(abs(got["params"][n].full_tensor() - p.full_tensor()).max())
        for n, p in params.items())
    return out


def pipeline_job(data):
    """make_pipeline_fn on pipe=2 x tensor=4, then pipeline_loss, the
    gathered-stack loss and the pipelined step on data=4 x pipe=2, and a
    checkpoint of pipe-placed params, on 8 ranks."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    from ray_tpu_torch.models import TINY, Transformer
    from ray_tpu_torch.parallel import MeshConfig, make_mesh
    from ray_tpu_torch.parallel.pipeline import (make_pipeline_fn,
                                                 stack_stage_params)
    from ray_tpu_torch.parallel.sharding import place, spec_placements
    from ray_tpu_torch.train.checkpoint import Checkpoint

    out = {}
    mlp = data["mlp"]
    mesh = make_mesh(MeshConfig(data=1, pipe=2, tensor=4), device="cpu")

    def stage(p, x):
        return torch.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]

    run = make_pipeline_fn(stage, 2, 4, mesh,
                           loss_fn=lambda o, t: torch.mean((o - t) ** 2))
    x, y = torch.tensor(mlp["x"]), torch.tensor(mlp["y"])
    on_pipe = spec_placements(("pipe",), mesh)
    stacked = stack_stage_params([{k: torch.tensor(v) for k, v in s.items()}
                                  for s in mlp["stages"]])
    for kind in ("dtensor", "plain"):
        if kind == "dtensor":
            params = {k: torch.nn.Parameter(place(v, mesh, on_pipe))
                      for k, v in stacked.items()}
        else:
            params = {k: v.clone().requires_grad_()
                      for k, v in stacked.items()}
        loss = run(params, x, y)
        loss.backward()
        grads = {}
        for k, p in params.items():
            if kind == "dtensor":
                grads[k] = p.grad.full_tensor().numpy()
            else:   # each stage's rows: summed over pipe
                g = p.grad.clone()
                dist.all_reduce(g, group=mesh.get_group("pipe"))
                grads[k] = g.numpy()
        out[f"mlp {kind}"] = {"loss": loss.item(), "grads": grads}

    cfg = TINY.replace(dtype="float32", attention_impl="dense", loss_chunk=0)
    mesh = make_mesh(MeshConfig(data=4, pipe=2), device="cpu")
    model = Transformer(cfg, device="meta")
    model.load_jax_params(data["params"], mesh=mesh)
    batch = {"tokens": torch.tensor(data["tokens"])}
    with torch.no_grad():
        out["pipeline_loss"] = model.pipeline_loss(
            batch, mesh=mesh, n_stages=2, n_micro=4).item()
    # loss on a pipe mesh: the stack gathered at use; its grads. Each of
    # the 4 data ranks holds the whole batch, so weighs it by 1/4, as
    # make_train_step weighs a rank's share (the model sums the grads
    # over data)
    loss = model.loss(batch, mesh=mesh)
    (loss / 4).backward()
    out["loss"] = loss.item()
    out["loss grads"] = {n: p.grad.full_tensor().numpy()
                         for n, p in model.named_parameters()}
    out["layers placement"] = tuple(model.layers["wo"].placements)

    _, state, step = _build(cfg, data["params"], mesh, lr=1e-2,
                            weight_decay=1e-4,
                            loss=lambda m, b: m.pipeline_loss(
                                b, mesh=mesh, n_stages=2, n_micro=4))
    state, losses, gnorms = _run(state, step, data["batch"], STEPS)
    out["step"] = {"loss": losses, "grad_norm": gnorms,
                   "params": _full(state["params"]),
                   "placements": {n: tuple(p.placements)
                                  for n, p in state["params"].items()}}
    assert isinstance(state["params"]["layers.wo"].placements[2], Shard)
    ckpt = Checkpoint(data["ckpt_dir"])
    ckpt.save_pytree({"params": state["params"]})
    got = ckpt.load_pytree(target={"params": state["params"]})
    out["checkpoint"] = max(
        float(abs(got["params"][n].full_tensor() - p.full_tensor()).max())
        for n, p in state["params"].items())
    return out


def multislice(data):
    """The 2-slice mesh 2 x (data=2 x tensor=2) on 8 ranks: its layout, a
    tensor-split matmul, and a data-parallel grad over dcn x data."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from ray_tpu_torch.parallel import (MeshConfig, MultiSliceConfig,
                                        make_multislice_mesh)
    from ray_tpu_torch.parallel.sharding import place
    from ray_tpu_torch.parallel.train_step import make_train_step

    mesh = make_multislice_mesh(MultiSliceConfig(
        num_slices=2, per_slice=MeshConfig(data=2, tensor=2)), device="cpu")
    out = {"names": mesh.mesh_dim_names, "shape": tuple(mesh.shape),
           "ranks": mesh.mesh.tolist(),
           "tensor group": sorted(
               torch.distributed.get_process_group_ranks(
                   mesh.get_group("tensor")))}
    # replicated params: the rows split over dcn x data, the tensor ranks
    # sharing theirs
    w = torch.nn.Parameter(torch.tensor(data["w"]))
    init, step = make_train_step(
        lambda p, b: torch.mean((b["x"] @ p["w"] - b["y"]) ** 2), None, mesh,
        optimizer=lambda ps: torch.optim.SGD(ps, lr=0.0), device="cpu")
    state, metrics = step(init({"w": w}), {"x": data["x"], "y": data["y"]})
    out["grad"] = w.grad.numpy()
    out["loss"] = metrics["loss"].item()
    # x split over dcn (rows), w over tensor (columns): x @ w whole
    x = place(torch.tensor(data["x2"]), mesh,
              (Shard(0), Replicate(), Replicate(), Replicate()))
    w2 = place(torch.tensor(data["w2"]), mesh,
               (Replicate(), Replicate(), Replicate(), Shard(1)))
    prod = x @ w2
    out["matmul"] = prod.full_tensor().numpy()
    out["matmul is dtensor"] = isinstance(prod, DTensor)
    return out


def hang(data):
    """Rank 0 waits in a barrier that rank 1 never reaches (a hung
    collective, for the harness's own timeout)."""
    import time

    import torch.distributed as dist
    if dist.get_rank() == 0:
        dist.barrier()
    else:
        time.sleep(data["seconds"])


JOBS = {"fsdp_tensor": fsdp_tensor, "three_d": three_d, "hang": hang,
        "seq_parallel": seq_parallel, "moe_step": moe_step,
        "pipeline": pipeline_job, "multislice": multislice,
        "vocab_parallel": vocab_parallel, "mesh_steps": mesh_steps}


class Ranks:
    """The processes of one job, started by `start`."""

    def __init__(self, procs, out):
        self.procs, self.out = procs, out

    def result(self, timeout: float):
        """Rank 0's result; raises with every rank's output if one
        failed or the job outlived `timeout` seconds (all are killed)."""
        try:
            logs = [p.communicate(timeout=timeout)[0] for p in self.procs]
        finally:
            for p in self.procs:
                p.kill()
            for p in self.procs:
                p.wait()
        if any(p.returncode for p in self.procs):
            raise RuntimeError("\n".join(
                f"rank {r} exit {p.returncode}:\n{log[-3000:]}"
                for r, (p, log) in enumerate(zip(self.procs, logs))))
        with open(self.out, "rb") as f:
            return pickle.load(f)


def start(job: str, data, world: int, tmp: str) -> Ranks:
    """Launch JOB on `world` gloo ranks, each a fresh process."""
    inp = os.path.join(tmp, f"{job}.in")
    out = os.path.join(tmp, f"{job}.out")
    with open(inp, "wb") as f:
        pickle.dump(data, f)
    rendezvous = os.path.join(tmp, f"{job}.port")
    if os.path.exists(rendezvous):
        os.unlink(rendezvous)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), job, inp, str(r),
         str(world), rendezvous, out], cwd=REPO, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    return Ranks(procs, out)


def _store(rendezvous: str, rank: int, world: int):
    """The group's TCPStore: rank 0 listens on a port the kernel picks
    and writes it to `rendezvous`; the other ranks read it there."""
    import time

    import torch.distributed as dist
    timeout = datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)
    if rank == 0:
        store = dist.TCPStore("127.0.0.1", 0, world, is_master=True,
                              timeout=timeout, wait_for_workers=False)
        with open(rendezvous + ".tmp", "w") as f:
            f.write(str(store.port))
        os.replace(rendezvous + ".tmp", rendezvous)
        return store
    deadline = time.monotonic() + COLLECTIVE_TIMEOUT_S
    while not os.path.exists(rendezvous):
        if time.monotonic() > deadline:
            raise TimeoutError(f"rank 0 wrote no port to {rendezvous}")
        time.sleep(0.05)
    with open(rendezvous) as f:
        port = int(f.read())
    return dist.TCPStore("127.0.0.1", port, world, is_master=False,
                         timeout=timeout)


def main(argv):
    job, inp, rank, world, rendezvous, out = argv
    rank, world = int(rank), int(world)
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    with open(inp, "rb") as f:
        data = pickle.load(f)
    dist.init_process_group(
        "gloo", store=_store(rendezvous, rank, world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        result = JOBS[job](data)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(result, f)


if __name__ == "__main__":
    main(sys.argv[1:])
