"""The port's host-RAM collective group (util/collective.py, a copy of the
JAX package's under the rename rule), on the CPU.

Mirrors of tests/test_collective.py on ray_tpu_torch, with its
assertions: every collective across three actors, the weight-broadcast
pattern across two, and a pure-numpy reduction whose results equal the
JAX package's on the same inputs. One cluster for the module
(ray_tpu_torch.init(num_cpus=4)).
"""

import numpy as np
import pytest

import ray_tpu_torch


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_collective_ops_across_actors(cluster):
    @ray_tpu_torch.remote
    class Member:
        def __init__(self, world, rank):
            from ray_tpu_torch.util import collective as c
            c.init_collective_group(world, rank, group_name="t1")
            self.rank = rank

        def run(self):
            import numpy as np
            from ray_tpu_torch.util import collective as c
            r = self.rank
            out = {}
            out["allreduce"] = c.allreduce(
                np.full(4, r + 1.0), group_name="t1")
            out["allgather"] = c.allgather(
                np.array([r, r]), group_name="t1")
            out["bcast"] = c.broadcast(
                np.arange(3.0) if r == 1 else None, src_rank=1,
                group_name="t1")
            out["rs"] = c.reducescatter(
                np.arange(6.0), group_name="t1")
            c.barrier(group_name="t1")
            if r == 0:
                c.send(np.array([42.0]), dst_rank=2, group_name="t1")
            if r == 2:
                out["recv"] = c.recv(0, group_name="t1")
            out["reduce"] = c.reduce(np.full(2, 1.0), dst_rank=0,
                                     group_name="t1")
            return out

    world = 3
    members = [Member.options(num_cpus=0.2).remote(world, r)
               for r in range(world)]
    outs = ray_tpu_torch.get([m.run.remote() for m in members], timeout=300)

    # allreduce(sum of 1,2,3) = 6
    for o in outs:
        np.testing.assert_array_equal(o["allreduce"], np.full(4, 6.0))
        gathered = o["allgather"]
        assert [list(g) for g in gathered] == [[0, 0], [1, 1], [2, 2]]
        np.testing.assert_array_equal(o["bcast"], np.arange(3.0))
    # reducescatter: sum = arange*3, rank r gets chunk r
    np.testing.assert_array_equal(outs[0]["rs"], np.array([0.0, 3.0]))
    np.testing.assert_array_equal(outs[1]["rs"], np.array([6.0, 9.0]))
    np.testing.assert_array_equal(outs[2]["rs"], np.array([12.0, 15.0]))
    np.testing.assert_array_equal(outs[2]["recv"], np.array([42.0]))
    np.testing.assert_array_equal(outs[0]["reduce"], np.full(2, 3.0))
    assert outs[1]["reduce"] is None
    for m in members:
        ray_tpu_torch.kill(m)


def test_weight_broadcast_pattern(cluster):
    """The intended use: learner broadcasts a weight pytree to samplers."""

    @ray_tpu_torch.remote
    class Node:
        def __init__(self, world, rank):
            from ray_tpu_torch.util import collective as c
            c.init_collective_group(world, rank, group_name="wb")
            self.rank = rank

        def round_trip(self):
            import numpy as np
            from ray_tpu_torch.util import collective as c
            if self.rank == 0:
                w = np.random.default_rng(0).standard_normal(64)
                out = c.broadcast(w, src_rank=0, group_name="wb")
            else:
                out = c.broadcast(None, src_rank=0, group_name="wb")
            return float(out.sum())

    nodes = [Node.options(num_cpus=0.2).remote(2, r) for r in range(2)]
    sums = ray_tpu_torch.get([n.round_trip.remote() for n in nodes],
                             timeout=300)
    assert abs(sums[0] - sums[1]) < 1e-9
    for n in nodes:
        ray_tpu_torch.kill(n)


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min",
                                "reducescatter", "allgather", "broadcast"])
def test_combine_equals_the_jax_package(op):
    """The coordinator's reduction of three ranks' seeded arrays equals
    the JAX package's coordinator's, element for element."""
    from ray_tpu.util.collective import CollectiveCoordinator as JCoord
    from ray_tpu_torch.util.collective import CollectiveCoordinator

    rng = np.random.default_rng(7)
    data = {r: rng.standard_normal((6, 5)) for r in range(3)}
    if op == "broadcast":
        data = {0: None, 1: data[1], 2: None}
    got = CollectiveCoordinator(3)._combine(op, data)
    want = JCoord(3)._combine(op, data)
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_array_equal(got, want)
