"""The port's multi-slice meshes (parallel/multislice.py) against the JAX
package's, on the CPU (the cases of tests/test_multislice.py).

In this process, over torch's fake process group of 8 ranks (a
DeviceMesh without peers): the 2 x (fsdp=2 x tensor=2) mesh's axes with
"dcn" outermost, slices as contiguous partitions of the ranks on one
node and grouped by node where the ranks span nodes, uneven slices
rejected, the DCN validation, and MultiSliceConfig.resolve and
per_slice_process_groups equal to the JAX ones.

One spawn of 8 gloo ranks (tests/_torch_sharded_workers.py, job
"multislice") on the JAX test's 2 x (data=2 x tensor=2) mesh: a
data-parallel grad over dcn x data (make_train_step with replicated
params, the batch's rows over both axes, the tensor ranks sharing
theirs) equals the whole batch's grad (jax.grad on one device, rtol
2e-5, atol 2e-6: the JAX test's bars); each tensor group lies inside a
slice, and a matmul with the rows split over dcn and the columns over
tensor (DTensors on the mesh) equals the dense product.
"""

import subprocess
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_sharded_workers as workers
from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu.parallel import MultiSliceConfig as JMultiSliceConfig
from ray_tpu.parallel.multislice import \
    per_slice_process_groups as jper_slice_process_groups
from ray_tpu_torch.parallel import (AXIS_DCN, MeshConfig, MultiSliceConfig,
                                    dcn_batch_spec, make_multislice_mesh,
                                    validate_multislice_sharding)
from ray_tpu_torch.parallel.multislice import (per_slice_process_groups,
                                               slice_ranks)
from ray_tpu_torch.parallel.sharding import spec_placements


@pytest.fixture
def fake_world():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    yield
    dist.destroy_process_group()


def test_2x4_mesh_axes(fake_world):
    cfg = MultiSliceConfig(num_slices=2,
                           per_slice=MeshConfig(data=1, fsdp=2, tensor=2))
    mesh = make_multislice_mesh(cfg, node_ids=["n"] * 8, device="cpu")
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    assert mesh.mesh_dim_names[0] == AXIS_DCN
    assert (shape["dcn"], shape["fsdp"], shape["tensor"]) == (2, 2, 2)
    assert mesh.mesh.numel() == 8


def test_uneven_slices_rejected():
    with pytest.raises(ValueError, match="divisible"):
        MultiSliceConfig(num_slices=3).resolve(8)
    with pytest.raises(ValueError, match="equal slices"):
        slice_ranks(["a", "a", "a", "b"], 2)


@pytest.mark.parametrize("per_slice", [dict(data=-1), dict(data=2, tensor=2),
                                       dict(data=1, fsdp=2, seq=2)])
def test_resolve_equals_jax(per_slice):
    assert MultiSliceConfig(2, MeshConfig(**per_slice)).resolve(8) == \
        JMultiSliceConfig(2, JMeshConfig(**per_slice)).resolve(8)


def test_slices_are_contiguous_partitions(fake_world):
    mesh = make_multislice_mesh(
        MultiSliceConfig(num_slices=2, per_slice=MeshConfig(data=-1)),
        node_ids=["n"] * 8, device="cpu")
    ranks = mesh.mesh.reshape(2, 4)
    assert set(ranks[0].tolist()) == {0, 1, 2, 3}
    assert set(ranks[1].tolist()) == {4, 5, 6, 7}


def test_slices_group_by_node_where_ranks_span_nodes(fake_world):
    mesh = make_multislice_mesh(
        MultiSliceConfig(num_slices=2, per_slice=MeshConfig(data=-1)),
        node_ids=["a", "b"] * 4, device="cpu")
    ranks = mesh.mesh.reshape(2, 4)
    assert ranks[0].tolist() == [0, 2, 4, 6]
    assert ranks[1].tolist() == [1, 3, 5, 7]


def test_model_axis_on_dcn_rejected():
    with pytest.raises(ValueError, match="tensor"):
        validate_multislice_sharding((("dcn", "tensor"),))


def test_data_axis_on_dcn_ok(fake_world):
    validate_multislice_sharding(dcn_batch_spec())
    validate_multislice_sharding((("dcn", "data"), None))
    validate_multislice_sharding((None, "tensor"))
    mesh = make_multislice_mesh(
        MultiSliceConfig(2, MeshConfig(data=2, tensor=2)),
        node_ids=["n"] * 8, device="cpu")
    assert spec_placements(dcn_batch_spec(None), mesh) == tuple(
        torch.distributed.tensor.Shard(0) if a in ("dcn", "data")
        else torch.distributed.tensor.Replicate()
        for a in mesh.mesh_dim_names)


def test_per_slice_process_groups_equal_jax():
    assert per_slice_process_groups(2, 4) == jper_slice_process_groups(2, 4)
    with pytest.raises(ValueError):
        per_slice_process_groups(0, 4)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    rng = np.random.default_rng(0)
    data = {n: rng.standard_normal(s).astype(np.float32) for n, s in
            (("w", (8, 8)), ("x", (16, 8)), ("y", (16, 8)),
             ("x2", (4, 16)), ("w2", (16, 32)))}
    ranks = workers.start("multislice", data, 8,
                          str(tmp_path_factory.mktemp("multislice")))
    grad = jax.grad(lambda w, x, y: jnp.mean((x @ w - y) ** 2))(
        data["w"], data["x"], data["y"])
    return ranks.result(timeout=90), data, np.asarray(grad)


def test_dcn_data_parallel_matches_single_device(run):
    got, data, grad = run
    assert got["names"] == ("dcn", "data", "fsdp", "tensor")
    assert got["shape"] == (2, 2, 1, 2)
    np.testing.assert_allclose(got["grad"], grad, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(
        got["loss"], np.mean((data["x"] @ data["w"] - data["y"]) ** 2),
        rtol=1e-5)


def test_tensor_parallel_stays_in_slice(run):
    got, data, _ = run
    slices = [sorted(np.asarray(s).ravel().tolist()) for s in got["ranks"]]
    assert slices == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert any(set(got["tensor group"]) <= set(s) for s in slices)
    assert got["matmul is dtensor"]
    np.testing.assert_allclose(got["matmul"], data["x2"] @ data["w2"],
                               rtol=2e-5, atol=1e-5)


def test_a_hanging_rank_job_fails_within_its_timeout(tmp_path):
    """The harness these tests share: a rank job that hangs (rank 0 in a
    barrier rank 1 never reaches) fails its test when the job's own
    timeout runs out, its ranks killed, well before the hang would end."""
    ranks = workers.start("hang", {"seconds": 600}, 2, str(tmp_path))
    t0 = time.monotonic()
    with pytest.raises(subprocess.TimeoutExpired):
        ranks.result(timeout=8)
    assert time.monotonic() - t0 < 30
    assert all(p.poll() is not None for p in ranks.procs)
