"""The port's logical sharding rules against the JAX package's, and the
Llama-2-7B model on the meta device, on the CPU with no process group.

Rules: DEFAULT_RULES is the JAX table, and for every param of TINY and
LLAMA2_7B on fsdp=8, data=2 x fsdp=2 x tensor=2 and tensor=4 (shape-only
meshes, get_abstract_mesh) the port's spec equals the JAX
logical_sharding(...).spec of the same logical spec and shape, and its
DTensor placements are what that spec says: Shard(d) on each mesh axis
behind dim d. The cases include size-1 axes dropped and non-dividing
entries replicated (TINY's 2 kv heads over tensor=4; TINY's d_model 64
over fsdp=8 divides, LLAMA2_7B's 32000 vocab over tensor=4 too).

Meta device (mirroring tests/test_7b_fsdp.py): LLAMA2_7B builds with no
memory, holds 6.5e9-7.5e9 params, at least 5 of which fsdp=8 shards, and
its loss runs at full size on the meta device through the flash
operator's fake (the counterpart of lowering the JAX step).
"""

import jax
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from ray_tpu.models import LLAMA2_7B as JLLAMA2_7B
from ray_tpu.models import TINY as JTINY
from ray_tpu.models import Transformer as JTransformer
from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu.parallel import make_mesh as jax_make_mesh
from ray_tpu.parallel.sharding import DEFAULT_RULES as JAX_DEFAULT_RULES
from ray_tpu.parallel.sharding import logical_sharding as jax_logical_sharding
from ray_tpu_torch.models import LLAMA2_7B, TINY, Transformer
from ray_tpu_torch.parallel import (MeshConfig, ShardingRules,
                                    get_abstract_mesh, shard_pytree,
                                    with_logical_constraint)
from ray_tpu_torch.parallel.sharding import (DEFAULT_RULES, flatten_specs,
                                             logical_sharding, logical_spec)

MESHES = {"fsdp=8": dict(data=1, fsdp=8),
          "data=2 fsdp=2 tensor=2": dict(data=2, fsdp=2, tensor=2),
          "tensor=4": dict(data=1, tensor=4)}
CONFIGS = {"TINY": (TINY, JTINY), "LLAMA2_7B": (LLAMA2_7B, JLLAMA2_7B)}


def _shapes(cfg):
    """Each param's shape, from a model on the meta device."""
    return {n: tuple(p.shape) for n, p in
            Transformer(cfg, device="meta").named_parameters()}


def test_default_rules_are_the_jax_table():
    assert DEFAULT_RULES == JAX_DEFAULT_RULES
    assert ShardingRules().rules == JAX_DEFAULT_RULES
    assert flatten_specs(Transformer.param_specs(LLAMA2_7B)) == \
        flatten_specs(JTransformer.param_specs(JLLAMA2_7B))
    assert flatten_specs(Transformer.param_specs(TINY)) == \
        flatten_specs(JTransformer.param_specs(JTINY))


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_placements_follow_the_jax_specs(config, mesh_name):
    cfg, jcfg = CONFIGS[config]
    sizes = MESHES[mesh_name]
    n = 8 if mesh_name != "tensor=4" else 4
    jmesh = jax_make_mesh(JMeshConfig(**sizes), devices=jax.devices()[:n])
    mesh = get_abstract_mesh(MeshConfig(**sizes), n)
    specs = flatten_specs(Transformer.param_specs(cfg))
    degraded = 0
    for name, shape in _shapes(cfg).items():
        want = tuple(jax_logical_sharding(specs[name], jmesh,
                                          shape=shape).spec)
        got = logical_spec(specs[name], mesh, shape=shape)
        assert got == want, name
        degraded += got != logical_spec(specs[name], mesh)
        placements = [Replicate()] * len(mesh.axis_names)
        for dim, entry in enumerate(want):
            for axis in (entry if isinstance(entry, tuple) else (entry,)):
                if axis is not None:
                    placements[mesh.axis_names.index(axis)] = Shard(dim)
        assert logical_sharding(specs[name], mesh, shape=shape) == \
            tuple(placements), name
    # TINY's 2 kv heads do not divide tensor=4: wkv's entry is replicated
    assert degraded == (config == "TINY" and mesh_name == "tensor=4")


def test_batch_over_data_and_fsdp_and_size_one_axes_dropped():
    rules = ShardingRules()
    mesh = get_abstract_mesh(MeshConfig(data=2, fsdp=2, tensor=2), 8)
    assert logical_spec(("batch", None), mesh, rules) == (("data", "fsdp"),
                                                          None)
    assert logical_sharding(("batch", None), mesh, rules) == (
        Shard(0), Shard(0), Replicate())
    one = get_abstract_mesh(MeshConfig(data=1, fsdp=-1), 1)
    assert logical_spec(("batch", "embed"), one, rules) == (None, None)
    assert logical_sharding(("vocab", "embed"), one, rules) == \
        (Replicate(),) * 3
    tree = shard_pytree(Transformer.param_specs(TINY), mesh, rules)
    assert tree["layers"]["w_gateup"] == (Replicate(), Shard(1), Shard(3))


def test_with_logical_constraint_is_a_no_op_on_plain_tensors():
    x = torch.ones(2, 3)
    assert with_logical_constraint(x, ("batch", "act_embed")) is x
    mesh = get_abstract_mesh(MeshConfig(data=1, fsdp=8), 8)
    assert with_logical_constraint(x, ("batch", None), mesh=mesh) is x
    with pytest.raises(KeyError, match="bacth"):
        with_logical_constraint(x, ("bacth", None))


def test_unported_mesh_axes_raise_naming_queue_1_item_4():
    """Once raising, ported now: the seq, pipe and expert axes above size
    1 are dims of the mesh, in the JAX order, and the rules place over
    them as the JAX package's do (the layer stack over pipe)."""
    for name in ("seq", "pipe", "expert"):
        mesh = get_abstract_mesh(MeshConfig(data=1, **{name: 2}), 2)
        assert mesh.axis_names == tuple(
            a for a in ("data", "fsdp", "pipe", "expert", "seq", "tensor")
            if a in ("data", "fsdp", "tensor", name))
        assert mesh.shape[name] == 2
    mesh = get_abstract_mesh(MeshConfig(data=1, pipe=2), 2)
    assert logical_sharding(("layers", "norm"), mesh) == (
        Replicate(), Replicate(), Shard(0), Replicate())


def test_llama2_7b_on_the_meta_device():
    cfg = LLAMA2_7B.replace(attention_impl="flash", loss_chunk=512)
    model = Transformer(cfg, device="meta")
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == cfg.num_params
    assert 6.5e9 < n_params < 7.5e9, n_params
    mesh = get_abstract_mesh(MeshConfig(data=1, fsdp=8), 8)
    placements = shard_pytree(Transformer.param_specs(cfg), mesh)
    n_sharded = sum(any(isinstance(pl, Shard) for pl in p)
                    for p in _leaves(placements))
    assert n_sharded >= 5, "FSDP rules left everything replicated"
    tokens = torch.zeros((8, cfg.max_seq_len + 1), dtype=torch.long,
                         device="meta")
    loss = model.loss({"tokens": tokens})
    assert loss.shape == () and loss.device.type == "meta"


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
