"""Multi-slice training mesh: the fast link inside a slice, the slow one across.

Card-free demo: 8 gloo ranks on the CPU stand in for 2 slices x 4 cards.
On GPUs a slice is the ranks of one node (NVLink inside, the network
across), and the same code groups the ranks by node.
"""

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ray_tpu_torch.parallel import (MeshConfig, MultiSliceConfig,
                                    dcn_batch_spec, make_multislice_mesh,
                                    validate_multislice_sharding)
from ray_tpu_torch.parallel.sharding import place, spec_placements

WORLD = 8


def rank_main(rank, ports):
    torch.set_num_threads(1)
    if rank == 0:   # the group's store, on a port the kernel picks
        store = dist.TCPStore("127.0.0.1", 0, WORLD, is_master=True,
                              wait_for_workers=False)
        for _ in range(WORLD - 1):
            ports.put(store.port)
    else:
        store = dist.TCPStore("127.0.0.1", ports.get(), WORLD,
                              is_master=False)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=WORLD)
    try:
        show(rank)
    finally:
        dist.destroy_process_group()


def show(rank):
    say = print if rank == 0 else (lambda *args: None)
    cfg = MultiSliceConfig(num_slices=2,
                           per_slice=MeshConfig(data=2, tensor=2))
    mesh = make_multislice_mesh(cfg, device="cpu")
    say("mesh:", dict(zip(mesh.mesh_dim_names, mesh.shape)))

    # model axes must stay inside a slice — this one is fine:
    validate_multislice_sharding((None, "tensor"))
    # ... and this would raise (tensor collectives over DCN):
    try:
        validate_multislice_sharding((("dcn", "tensor"),))
    except ValueError as e:
        say("rejected:", str(e)[:60], "...")

    # data-parallel gradient step across slices: batch shards over
    # (dcn, data), each rank takes its rows' share of the mean, and an
    # all-reduce over dcn and data (the cross-slice one among them) sums
    # the shares
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((16, 16)).astype(np.float32))
    x, y = (place(torch.from_numpy(
        rng.standard_normal((32, 16)).astype(np.float32)), mesh,
        spec_placements(dcn_batch_spec(), mesh)).to_local()
        for _ in range(2))
    w.requires_grad_(True)
    (torch.sum((x @ w - y) ** 2) / (32 * 16)).backward()
    for axis in ("dcn", "data"):
        dist.all_reduce(w.grad, group=mesh.get_group(axis))
    say("grad norm:", float(torch.linalg.norm(w.grad)))


def main():
    # forked ranks start without importing torch again
    ctx = mp.get_context("fork")
    mp.start_processes(rank_main, args=(ctx.SimpleQueue(),), nprocs=WORLD,
                       start_method="fork")


if __name__ == "__main__":
    main()
