"""The port's sharded train step on a 3-D mesh: 8 gloo ranks, data=2 x
fsdp=2 x tensor=2, on the CPU (the mirror of
tests/test_models.py::TestTrainStep::test_loss_decreases_sharded).

One spawn of 8 ranks (tests/_torch_sharded_workers.py, job "three_d")
takes 10 Adam steps (lr 1e-2, no decay: optax.adam(1e-2)) with TINY
(f32) from the JAX package's Transformer.init params on one 4 x 33
batch: the batch splits into 4 row blocks over data x fsdp, each block
on the 2 ranks of a tensor pair. The step memorizes the batch, as the
JAX step does (the last loss under 0.7 of the first), and w_gateup sits
on the fsdp and tensor axes (the mirror of test_param_shardings_applied).
"""

import numpy as np

import jax
from torch.distributed.tensor import Replicate, Shard

import _torch_sharded_workers as workers
from ray_tpu.models import TINY as JTINY
from ray_tpu.models import Transformer as JTransformer


def test_3d_mesh_memorizes_a_batch(tmp_path):
    jcfg = JTINY.replace(dtype="float32")
    params = jax.tree.map(np.asarray,
                          JTransformer.init(jax.random.PRNGKey(0), jcfg))
    tokens = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (4, 33)).astype(np.int32)
    got = workers.start("three_d", {"params": params,
                                    "batch": {"tokens": tokens}},
                        8, str(tmp_path)).result(timeout=240)
    losses = got["loss"]
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0] * 0.7, losses
    assert got["step"] == 10
    # (data, fsdp, tensor): embed -> fsdp on dim 1, mlp -> tensor on dim 3
    assert got["placements"]["layers.w_gateup"] == (Replicate(), Shard(1),
                                                     Shard(3))
