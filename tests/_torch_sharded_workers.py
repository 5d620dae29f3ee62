"""Gloo ranks of the port's sharded-step tests (tests/test_torch_sharded_*.py).

    python tests/_torch_sharded_workers.py JOB INPUT RANK WORLD PORT OUTPUT

Each process is one rank of a CPU process group. INPUT is a pickle of
numpy data (JAX Transformer.init params, batches) written by the test;
rank 0 pickles what JOB returns to OUTPUT. The module imports torch and
the port only, never jax, so a rank starts in a few seconds. `start`
launches the ranks from a test and `Ranks.result` waits for them.
"""

import os
import pickle
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STEPS = 3


def _build(cfg, params, mesh, lr=1e-3, weight_decay=0.01):
    from ray_tpu_torch.models import Transformer
    from ray_tpu_torch.parallel.train_step import adamw, make_train_step
    model = Transformer(cfg, device="meta")
    model.load_jax_params(params, mesh=mesh)
    init, step = make_train_step(
        lambda p, b: model.loss(b, mesh=mesh), Transformer.param_specs(cfg),
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


JOBS = {"fsdp_tensor": fsdp_tensor, "three_d": three_d}


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
        if any(p.returncode for p in self.procs):
            raise RuntimeError("\n".join(
                f"rank {r} exit {p.returncode}:\n{log[-3000:]}"
                for r, (p, log) in enumerate(zip(self.procs, logs))))
        with open(self.out, "rb") as f:
            return pickle.load(f)


def start(job: str, data, world: int, tmp: str) -> Ranks:
    """Launch JOB on `world` gloo ranks, each a fresh process."""
    from ray_tpu_torch._private.rpc import find_free_port
    inp = os.path.join(tmp, f"{job}.in")
    out = os.path.join(tmp, f"{job}.out")
    with open(inp, "wb") as f:
        pickle.dump(data, f)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    port = str(find_free_port())
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), job, inp, str(r),
         str(world), port, out], cwd=REPO, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    return Ranks(procs, out)


def main(argv):
    job, inp, rank, world, port, out = argv
    rank, world = int(rank), int(world)
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    with open(inp, "rb") as f:
        data = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        result = JOBS[job](data)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(result, f)


if __name__ == "__main__":
    main(sys.argv[1:])
