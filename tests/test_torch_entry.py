"""The port's entry points (ray_tpu_torch/entry.py) against the JAX
package's (__graft_entry__.py), on the CPU.

- entry(cfg=narrow, device="cpu"): the forward of a narrow GPT-2-shaped
  decoder (2 layers, d_model 64, f32) from JAX Transformer.init params
  (params_from_jax) on its zero tokens and on random ones, against JAX
  Transformer.apply, rtol/atol 1e-5; its own seed-0 params have the JAX
  tree's names and shapes.
- entry()'s default: GPT2_125M, field by field the JAX package's, its
  params (on the meta device) the JAX init's shapes, tokens [4, 1024].
- With no device both entry points raise here (no CUDA).
- mesh_sizes(n) for n in {1, 2, 4, 8, 16} equals the split
  __graft_entry__.py's dryrun_multichip runs (its own statements, read
  from the file and run here).

dryrun_multichip's steps against the JAX package's losses are in
test_torch_entry_dryrun.py.
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from ray_tpu.models import GPT2_125M as JGPT2_125M
from ray_tpu.models import Transformer as JTransformer
from ray_tpu_torch import entry as port_entry
from ray_tpu_torch.models import GPT2_125M
from ray_tpu_torch.models.convert import params_from_jax

REPO = Path(__file__).resolve().parent.parent
NARROW = dict(d_model=64, n_layers=2, n_heads=2, d_ff=128, vocab_size=256,
              max_seq_len=32, dtype="float32")


def _flat(tree):
    out = {}
    for k, v in tree.items():
        if k == "layers":
            out.update({f"layers.{n}": np.asarray(a) for n, a in v.items()})
        else:
            out[k] = np.asarray(v)
    return out


def test_entry_forward_matches_jax_apply():
    cfg, jcfg = GPT2_125M.replace(**NARROW), JGPT2_125M.replace(**NARROW)
    fn, (params, tokens) = port_entry.entry(cfg, device="cpu")
    jparams = JTransformer.init(jax.random.PRNGKey(0), jcfg)
    want_shapes = {n: a.shape for n, a in _flat(jparams).items()}
    assert {n: tuple(p.shape) for n, p in params.items()} == want_shapes
    assert tokens.dtype == torch.int32 and tuple(tokens.shape) == (4, 32)
    assert not tokens.any()
    converted = params_from_jax(jparams, cfg, "cpu")
    rand = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int32)
    apply = jax.jit(lambda p, t: JTransformer.apply(p, t, jcfg))
    for toks in (tokens.numpy(), rand):
        with torch.no_grad():
            got = fn(converted, torch.from_numpy(toks))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(apply(jparams, toks)),
                                   rtol=1e-5, atol=1e-5)
    # its own params give finite logits of the vocabulary's width
    with torch.no_grad():
        own = fn(params, tokens)
    assert own.shape == (4, 32, cfg.vocab_size) and torch.isfinite(own).all()


def test_entry_default_is_the_jax_gpt2_125m():
    assert dataclasses.asdict(GPT2_125M) == dataclasses.asdict(JGPT2_125M)
    assert GPT2_125M.attention_impl == "dense"
    _, (params, tokens) = port_entry.entry(device="meta")
    shapes = jax.eval_shape(lambda k: JTransformer.init(k, JGPT2_125M),
                            jax.random.PRNGKey(0))
    want = {n: a.shape for n, a in shapes["layers"].items()}
    want = {f"layers.{n}": s for n, s in want.items()}
    want.update({n: a.shape for n, a in shapes.items() if n != "layers"})
    assert {n: tuple(p.shape) for n, p in params.items()} == want
    assert tuple(tokens.shape) == (4, 1024) and tokens.dtype == torch.int32


def test_entry_points_raise_without_a_device():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no"):
        port_entry.entry()
    with pytest.raises(RuntimeError, match="no"):
        port_entry.dryrun_multichip(4)


def _reference_split(n):
    """The sizes dict __graft_entry__.py's dryrun_multichip builds for n
    devices: its own statements from `remaining = n_devices` through
    the loop over the axes, run here."""
    src = (REPO / "__graft_entry__.py").read_text()
    fn = next(node for node in ast.parse(src).body
              if isinstance(node, ast.FunctionDef)
              and node.name == "dryrun_multichip")
    body = fn.body
    start = next(i for i, s in enumerate(body)
                 if isinstance(s, ast.Assign)
                 and getattr(s.targets[0], "id", None) == "remaining")
    end = next(i for i, s in enumerate(body)
               if i > start and isinstance(s, ast.For))
    scope = {"n_devices": n}
    exec(compile(ast.Module(body[start:end + 1], type_ignores=[]),
                 "__graft_entry__.py", "exec"), scope)
    return scope["sizes"]


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16])
def test_mesh_split_is_the_reference_split(n):
    assert port_entry.mesh_sizes(n) == _reference_split(n)
