"""Decoder-only transformer (counterpart of ray_tpu/models/transformer.py).

An nn.Module holding the JAX package's parameter layout unchanged:
stacked layers (leading dim n_layers), fused ``wqkv (l, d, 3, nh, hd)``
for MHA or ``wq`` plus ``wkv (l, d, 2, nkv, hd)`` for GQA, fused
``w_gateup (l, d, 2, f)``, ``w_down (l, f, d)``, ``wo (l, nh, hd, d)``, and
an ``embed`` table the head reuses when embeddings are tied. So weights
move between the two by a rename (models/convert.py).

Params stay in cfg.param_dtype and are cast to cfg.dtype at each use, as
the JAX layer body does. RMSNorm runs in f32, RoPE is half-split, the
attention products and the lm-head logits accumulate in f32, and the
logits come out f32.

Sharded (``mesh=`` on hidden/forward/loss, the params DTensors placed by
Transformer.param_specs: make_train_step's init_state or
load_jax_params(mesh=)): each rank runs its own rows of the batch
(split over the rules' "batch" axes) and, over a `seq` axis, its own
columns [r T/n, (r+1) T/n) at their global RoPE positions. A layer's
slice of each stacked param is cast and all-gathered over the batch
axes only when the layer runs (FSDP; its grad reduce-scattered back,
summed over `seq` too), wqkv/wq/wkv/w_gateup are column-parallel and
wo/w_down row-parallel over the `tensor` axis, and the attention kernels
run per shard on the rank's own heads, as JAX's shard_map around Pallas
does: over `seq` as ring or Ulysses attention (parallel/ring.py,
parallel/ulysses.py). MoE layers (ops/moe.py) hold their experts split
over `expert`. The embedding and the head are gathered whole at use. A
layer stack split over `pipe` is gathered whole at use by hidden and
loss (the GSPMD meaning of the rules), and runs one stage a rank in
pipeline_loss (parallel/pipeline.py).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Shard
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models.configs import TransformerConfig, torch_dtype
from ray_tpu_torch.ops.attention import dense_attention, flash_attention
from ray_tpu_torch.ops.moe import MoEAxes, moe
from ray_tpu_torch.parallel.mesh import (AXIS_EXPERT, AXIS_PIPE, AXIS_SEQ,
                                         AXIS_TENSOR)
from ray_tpu_torch.parallel.pipeline import pipeline
from ray_tpu_torch.parallel.ring import ring_attention
from ray_tpu_torch.parallel.sharding import (MeshAxis, ShardingRules,
                                             gather_at_use, mesh_axes,
                                             mesh_axis, sum_over, to_parallel)
from ray_tpu_torch.parallel.ulysses import ulysses_attention

_ATTENTION_IMPLS = ("auto", "dense", "flash", "ring", "ulysses")
_NO_SEQ = MeshAxis(AXIS_SEQ, 1, 0, None)

# what the "dots" remat policy saves: the matmuls' outputs (JAX's
# checkpoint_dots) and the flash kernel's (its "attn_out" name); the rest
# of a layer is recomputed in the backward
_DOTS_SAVED = [torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
               torch.ops.ray_tpu_torch.flash_fwd.default]


def _rope_tables(positions, head_dim: int, theta: float):
    """cos/sin tables [..., T, half] (f32) for explicit positions."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=positions.device) / half))
    angles = positions[..., None].to(torch.float32) * freqs
    return torch.cos(angles), torch.sin(angles)


def _rope(x, cos, sin):
    """Rotary embedding of [..., T, H, D] given [..., T, half] tables; the
    two halves of D rotate together (half-split, not interleaved)."""
    half = x.shape[-1] // 2
    c = cos[..., None, :]  # broadcast over heads: [..., T, 1, half]
    s = sin[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.to(x.dtype)


def _rmsnorm(x, w, eps: float):
    """f32 mean of squares, cast to x's dtype, then times w cast to it."""
    x32 = x.to(torch.float32)
    scale = torch.reciprocal(
        torch.sqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps))
    return (x32 * scale).to(x.dtype) * w.to(x.dtype)


class _DotF32(torch.autograd.Function):
    """x2 [M, d] @ w [d, n] -> f32 [M, n] for bf16 (or f16) operands, the
    counterpart of einsum(..., preferred_element_type=f32).

    A bf16 torch.matmul would round its f32 sums to bf16. On the card the
    product runs as a bf16 GEMM whose output type is f32 (torch.mm with
    out_dtype, which has no derivative of its own); on the CPU the
    operands are widened to f32 first, which gives the same exact
    products and f32 sums. The backward rounds the f32 cotangent to the
    operands' dtype and runs two plain GEMMs, as the TPU's default matmul
    precision rounds f32 operands to bf16."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        if x2.is_cuda:
            return torch.mm(x2, w, out_dtype=torch.float32)
        return x2.to(torch.float32) @ w.to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(x2.dtype)
        return g @ w.t(), x2.t() @ g


def _dot_f32(x, w):
    """x [..., d] @ w [d, n] -> f32 logits [..., n], sums in f32."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return x @ w
    out = _DotF32.apply(x.reshape(-1, x.shape[-1]), w)
    return out.view(*x.shape[:-1], w.shape[-1])


def _nll(logits, targets):
    """Next-token negative log-likelihood per position, f32."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    return logz - gold


def _attention_fn(impl: str, mesh):
    """attn(q, k, v, scale) for a resolved impl (JAX _make_attention):
    ring and Ulysses over the mesh's `seq` axis (one block, the flash
    kernels, where it has size 1 or there is no mesh), flash or dense on
    a rank's whole sequence."""
    if impl in ("ring", "ulysses"):
        sp = ring_attention if impl == "ring" else ulysses_attention
        return lambda q, k, v, scale: sp(q, k, v, mesh=mesh, scale=scale)
    local = dense_attention if impl == "dense" else flash_attention
    return lambda q, k, v, scale: local(q, k, v, causal=True, scale=scale)


class _Unsharded:
    """How a layer reads its params with no mesh: cast at use."""

    seq = _NO_SEQ
    pipe = MeshAxis(AXIS_PIPE, 1, 0, None)
    moe_axes = MoEAxes()

    def __init__(self, cfg: TransformerConfig):
        impl = "flash" if cfg.attention_impl == "auto" else cfg.attention_impl
        self.attention = _attention_fn(impl, None)

    def local(self, p):
        return p

    def stack(self, name, p):
        return p

    def use(self, name, p, dtype):
        return p.to(dtype)

    use_whole = use

    def to_tp(self, x, block):
        return x

    def sum_tp(self, x, block):
        return x

    def kv_heads(self, k):
        return k


class _Sharded:
    """How a layer reads its params on a mesh: each param a DTensor placed
    by the rules; the batch split over the rules' "batch" axes, so each
    rank holds its own rows, and over `seq`, so it holds its own columns;
    see the module docstring. `pipelined`: the layers run one stage a
    rank (pipeline_loss), else a stack split over `pipe` is gathered."""

    def __init__(self, model: "Transformer", mesh, rules: ShardingRules,
                 pipelined: bool = False):
        cfg = model.cfg
        self.axes = mesh_axes(mesh)
        self.tensor = mesh_axis(mesh, AXIS_TENSOR)
        self.seq = mesh_axis(mesh, AXIS_SEQ)
        self.pipe = mesh_axis(mesh, AXIS_PIPE)
        self.pipelined = pipelined
        batch = rules.mesh_axes("batch")
        self.batch = tuple(batch) if isinstance(batch, tuple) else (batch,)
        # a grad is partial over the axes that split the tokens (each rank
        # computes it from its own); in a pipeline the embedding, final
        # norm and head are also partial over `pipe` (one stage uses each)
        self.partial = self.batch + ((AXIS_SEQ,) if self.seq.size > 1
                                     else ())
        self.partial_whole = self.partial + (
            (AXIS_PIPE,) if pipelined and self.pipe.size > 1 else ())
        impl = cfg.attention_impl
        if impl == "auto":
            impl = "flash" if self.seq.size == 1 else "ring"
        if impl in ("flash", "dense") and self.seq.size > 1:
            raise ValueError(f"attention_impl={impl!r} requires an unsharded "
                             f"seq axis; use ring/ulysses for SP")
        self.attention = _attention_fn(impl, mesh)
        by_name = {a.name: a for a in self.axes}
        tokens = [(self.seq, 1)] + [(by_name[a], 0)
                                    for a in reversed(self.batch)
                                    if a in by_name]
        self.placements = {}
        for name, p in model.named_parameters():
            if not isinstance(p, DTensor) or p.device_mesh != mesh:
                raise ValueError(
                    f"param {name} is not placed on this mesh: place the "
                    f"params first (make_train_step's init_state, or "
                    f"load_jax_params(mesh=...))")
            self.placements[name] = tuple(p.placements)
        # a block is tensor-parallel where the rules shard its heads (mlp)
        # over the tensor axis; a weight's placements say so
        heads = "layers.wqkv" if cfg.kv_heads == cfg.n_heads else "layers.wq"
        up, down = (("layers.w_moe_up", "layers.w_moe_down")
                    if cfg.moe_experts else ("layers.w_gateup",
                                             "layers.w_down"))
        self.tp = {"attn": self._split(heads), "mlp": self._split(up)}
        if self._split("layers.wo") != self.tp["attn"] or \
                self._split(down) != self.tp["mlp"]:
            raise ValueError("wo and w_down must split over the tensor axis "
                             "as the projections before them do")
        self.moe_axes = MoEAxes(
            expert=mesh_axis(mesh, AXIS_EXPERT),
            tensor=self.tensor if self.tp["mlp"] else MoEAxes.tensor,
            tokens=tuple((a, d) for a, d in tokens if a.size > 1))
        # GQA: k and v keep their kv heads where the tensor axis divides
        # them, and are repeated up to the query heads where it does not
        # (then wkv is replicated over it, and each rank's grad of it is a
        # partial sum: the rank's own query heads)
        self.widen = (self.tp["attn"] and cfg.kv_heads != cfg.n_heads
                      and not self._split("layers.wkv"))
        self.n_heads, self.kv_rep = cfg.n_heads, cfg.n_heads // cfg.kv_heads

    def _split(self, name: str) -> bool:
        """Whether param `name` is sharded over a tensor axis above 1."""
        m = self.axes.index(self.tensor)
        return self.tensor.size > 1 and isinstance(self.placements[name][m],
                                                   Shard)

    def local(self, p):
        return p.to_local()

    def stack(self, name, p):
        """A layer stack's local tensor as the layers read it: split over
        `pipe` outside a pipeline, gathered whole (every pipe rank runs
        every layer on the same rows, so its grad is sliced back)."""
        if self.pipelined or self.pipe.size == 1:
            return p
        return gather_at_use(p, p.dtype, self.placements[f"layers.{name}"],
                             self.axes, gather=[AXIS_PIPE])

    def use(self, name, shard, dtype):
        """A layer's weight (`name` in model.layers): gathered over the
        batch axes, tensor-sharded (experts expert-sharded) as placed."""
        key = f"layers.{name}"
        partial = self.partial + ((AXIS_TENSOR,) if name == "wkv"
                                  and self.widen else ())
        return gather_at_use(shard, dtype, self.placements[key], self.axes,
                             gather=self.batch, partial=partial,
                             dim_offset=1)

    def use_whole(self, name, shard, dtype):
        """A top-level param gathered whole; the same on every rank of the
        tensor axis, so its grad is partial over the token axes only."""
        return gather_at_use(shard, dtype, self.placements[name], self.axes,
                             gather=[a.name for a in self.axes],
                             partial=self.partial_whole)

    def to_tp(self, x, block):
        return to_parallel(x, self.tensor) if self.tp[block] else x

    def sum_tp(self, x, block):
        return sum_over(x, self.tensor) if self.tp[block] else x

    def kv_heads(self, k):
        if not self.widen:
            return k
        n = self.n_heads // self.tensor.size
        return k.repeat_interleave(self.kv_rep, dim=2).narrow(
            2, self.tensor.coord * n, n)


class Transformer(nn.Module):
    """The flagship decoder. ``Transformer(cfg, device=None)`` builds it on
    the card (raising without CUDA) unless a device is named, and fills
    its params from a torch.Generator seeded with ``seed`` (on the meta
    device it only has their shapes)."""

    def __init__(self, cfg: TransformerConfig, device: DeviceLike = None,
                 *, seed: int = 0):
        super().__init__()
        if cfg.attention_impl not in _ATTENTION_IMPLS:
            raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")
        if cfg.remat_policy not in ("full", "dots"):
            raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
        self.cfg = cfg
        dev = resolve_device(device)
        pdt = torch_dtype(cfg.param_dtype)

        def param(*shape, dtype=pdt):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=dev))

        d, hd = cfg.d_model, cfg.head_dim
        nh, nkv, f, l = cfg.n_heads, cfg.kv_heads, cfg.ff_dim, cfg.n_layers
        layers = {
            "attn_norm": param(l, d),
            "wo": param(l, nh, hd, d),
            "mlp_norm": param(l, d),
        }
        if cfg.moe_experts:
            # routed expert FFN (ops/moe.py): a per-layer router, f32
            # whatever param_dtype is (as the JAX init makes it), and
            # stacked expert weights, the expert dim split over `expert`
            e = cfg.moe_experts
            layers["w_router"] = param(l, d, e, dtype=torch.float32)
            layers["w_moe_up"] = param(l, e, d, f)
            layers["w_moe_down"] = param(l, e, f, d)
        else:
            layers["w_gateup"] = param(l, d, 2, f)
            layers["w_down"] = param(l, f, d)
        if nkv == nh:
            layers["wqkv"] = param(l, d, 3, nh, hd)
        else:
            layers["wq"] = param(l, d, nh, hd)
            layers["wkv"] = param(l, d, 2, nkv, hd)
        self.embed = param(cfg.vocab_size, d)
        self.layers = nn.ParameterDict(layers)
        # each MoE layer's share of (token, slot) pairs dropped over its
        # capacity in the last forward (None before one)
        self.moe_dropped = None
        self.final_norm = param(d)
        if not cfg.tie_embeddings:
            self.lm_head = param(d, cfg.vocab_size)
        if dev.type != "meta":
            self.init(torch.Generator(device=dev).manual_seed(seed))

    @staticmethod
    def param_specs(cfg: TransformerConfig) -> Dict[str, Any]:
        """Logical sharding spec tree, the JAX Transformer.param_specs's:
        the structure of its init() tree ("layers" nested), whose dotted
        names are this module's parameter names."""
        layers = {
            "attn_norm": ("layers", "norm"),
            "wo": ("layers", "heads", "head_dim", "embed"),
            "mlp_norm": ("layers", "norm"),
        }
        if cfg.moe_experts:
            layers["w_router"] = ("layers", "embed", None)
            layers["w_moe_up"] = ("layers", "expert", "embed", "mlp")
            layers["w_moe_down"] = ("layers", "expert", "mlp", "embed")
        else:
            layers["w_gateup"] = ("layers", "embed", None, "mlp")
            layers["w_down"] = ("layers", "mlp", "embed")
        if cfg.kv_heads == cfg.n_heads:
            layers["wqkv"] = ("layers", "embed", None, "heads", "head_dim")
        else:
            layers["wq"] = ("layers", "embed", "heads", "head_dim")
            layers["wkv"] = ("layers", "embed", None, "kv_heads",
                             "head_dim")
        specs = {
            "embed": ("vocab", "embed"),
            "layers": layers,
            "final_norm": ("norm",),
        }
        if not cfg.tie_embeddings:
            specs["lm_head"] = ("embed", "vocab")
        return specs

    # ---- parameter construction ------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """Fill the params with Transformer.init's distributions (the
        values differ from JAX's: another generator)."""
        cfg = self.cfg
        d, f = cfg.d_model, cfg.ff_dim
        stddev = {
            "embed": 0.02,
            "layers.wo": (cfg.n_heads * cfg.head_dim) ** -0.5,
            "layers.w_gateup": d ** -0.5,
            "layers.w_down": f ** -0.5,
            "layers.wqkv": d ** -0.5,
            "layers.wq": d ** -0.5,
            "layers.wkv": d ** -0.5,
            "layers.w_router": 0.02,
            "layers.w_moe_up": d ** -0.5,
            "layers.w_moe_down": f ** -0.5,
            "lm_head": d ** -0.5,
        }
        for name, p in self.named_parameters():
            if name in stddev:
                noise = torch.randn(p.shape, generator=generator,
                                    dtype=torch.float32, device=p.device)
                p.copy_(noise * stddev[name])
            else:  # the three norms
                p.fill_(1.0)

    def load_jax_params(self, tree: Dict[str, Any], *, mesh=None,
                        rules: Optional[ShardingRules] = None) -> None:
        """Load a JAX Transformer.init tree (numpy or jax arrays). With a
        mesh, each param becomes a DTensor placed by param_specs holding
        only this rank's slice (params_from_jax) on the mesh's device, so
        a model built on the meta device never holds the whole tree."""
        from ray_tpu_torch.models.convert import params_from_jax
        device = self.embed.device if mesh is None else mesh.device_type
        self.load_state_dict(
            params_from_jax(tree, self.cfg, device, mesh=mesh, rules=rules),
            assign=mesh is not None)

    def _plan(self, mesh, rules, pipelined: bool = False):
        if mesh is None:
            if isinstance(self.embed, DTensor):
                raise ValueError("the params are placed on a mesh: pass "
                                 "mesh= to hidden, forward and loss")
            return _Unsharded(self.cfg)
        return _Sharded(self, mesh, rules or ShardingRules(), pipelined)

    # ---- forward ----------------------------------------------------
    def hidden(self, tokens, positions=None, *, mesh=None,
               rules: Optional[ShardingRules] = None, with_aux: bool = False):
        """tokens [B, T] -> final-norm hidden states [B, T, d] in the
        compute dtype (on a mesh: this rank's rows, and over `seq` its
        columns, at global positions by default). with_aux=True returns
        (hidden, aux), aux the summed MoE load-balancing loss (None for a
        dense FFN)."""
        x, aux = self._hidden(tokens, positions, self._plan(mesh, rules))
        return (x, aux) if with_aux else x

    def _embed(self, tokens, plan):
        tokens = torch.as_tensor(tokens, device=self.embed.device).long()
        embed = plan.local(self.embed)
        x = F.embedding(tokens, plan.use_whole("embed", embed, embed.dtype))
        return x.to(torch_dtype(self.cfg.dtype))

    def _layer_fn(self):
        """The layer body, under jax.checkpoint's counterpart when
        cfg.remat: "full" keeps only the layer's inputs, "dots" also the
        matmul and attention outputs."""
        cfg = self.cfg
        if not cfg.remat:
            return self._layer
        ctx = {} if cfg.remat_policy == "full" else {
            "context_fn": functools.partial(
                create_selective_checkpoint_contexts, _DOTS_SAVED)}
        return functools.partial(checkpoint, self._layer,
                                 use_reentrant=False, **ctx)

    def _hidden(self, tokens, positions, plan):
        """(final-norm hidden states, summed MoE aux or None)."""
        cfg = self.cfg
        cdt = torch_dtype(cfg.dtype)
        x = self._embed(tokens, plan)
        t = x.shape[1]
        if positions is None:   # global positions of this rank's columns
            positions = plan.seq.coord * t + torch.arange(t, device=x.device)
            positions = positions[None, :]
        cos, sin = _rope_tables(torch.as_tensor(positions, device=x.device),
                                cfg.head_dim, cfg.rope_theta)
        # one unbind per stacked param: its backward stacks the per-layer
        # grads once (indexing p[i] per layer would add a full-size zero
        # tensor per layer in backward)
        per_layer = {name: plan.stack(name, plan.local(p)).unbind(0)
                     for name, p in self.layers.items()}
        layer = self._layer_fn()
        aux_total, dropped = None, []
        for i in range(cfg.n_layers):
            x, aux, drop = layer(x, {n: ps[i] for n, ps in per_layer.items()},
                                 cos, sin, plan)
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
                dropped.append(drop)
        if dropped:
            self.moe_dropped = torch.stack(dropped).detach()
        out = _rmsnorm(x, plan.use_whole("final_norm",
                                         plan.local(self.final_norm), cdt),
                       cfg.norm_eps)
        return out, aux_total

    def _layer(self, x, lp, cos, sin, plan):
        cfg = self.cfg
        cdt = x.dtype
        b, t, d = x.shape
        hd = cfg.head_dim
        h = _rmsnorm(x, plan.use("attn_norm", lp["attn_norm"], cdt),
                     cfg.norm_eps)
        h = plan.to_tp(h, "attn")
        # on a mesh the heads are this rank's (nh over the tensor axis)
        if "wqkv" in lp:
            w = plan.use("wqkv", lp["wqkv"], cdt)
            nh = w.shape[2]
            qkv = h @ w.reshape(d, 3 * nh * hd)
            q, k, v = qkv.view(b, t, 3, nh, hd).unbind(2)
        else:
            w = plan.use("wq", lp["wq"], cdt)
            nh = w.shape[1]
            q = (h @ w.reshape(d, nh * hd)).view(b, t, nh, hd)
            w = plan.use("wkv", lp["wkv"], cdt)
            nkv = w.shape[2]
            kv = h @ w.reshape(d, 2 * nkv * hd)
            k, v = kv.view(b, t, 2, nkv, hd).unbind(2)
        q = _rope(q, cos, sin)
        k = plan.kv_heads(_rope(k, cos, sin))
        v = plan.kv_heads(v)
        o = plan.attention(q, k, v, hd ** -0.5)
        wo = plan.use("wo", lp["wo"], cdt)
        x = x + plan.sum_tp(o.reshape(b, t, nh * hd) @ wo.reshape(nh * hd, d),
                            "attn")

        h = _rmsnorm(x, plan.use("mlp_norm", lp["mlp_norm"], cdt),
                     cfg.norm_eps)
        if cfg.moe_experts:
            y, aux, dropped = moe(
                h, plan.use("w_router", lp["w_router"], torch.float32),
                plan.use("w_moe_up", lp["w_moe_up"], cdt),
                plan.use("w_moe_down", lp["w_moe_down"], cdt),
                num_selected=cfg.moe_top_k,
                capacity_factor=cfg.moe_capacity_factor, axes=plan.moe_axes)
            return x + y.to(cdt), aux, dropped
        h = plan.to_tp(h, "mlp")
        w = plan.use("w_gateup", lp["w_gateup"], cdt)
        f = w.shape[2]
        gate, up = (h @ w.reshape(d, 2 * f)).view(b, t, 2, f).unbind(2)
        ff = F.silu(gate) * up
        down = ff @ plan.use("w_down", lp["w_down"], cdt)
        return x + plan.sum_tp(down, "mlp"), None, None

    def _head(self, dtype, plan):
        """The lm head as a [d, vocab] matrix in `dtype` (a transposed view
        of embed when tied)."""
        if self.cfg.tie_embeddings:
            return plan.use_whole("embed", plan.local(self.embed), dtype).t()
        return plan.use_whole("lm_head", plan.local(self.lm_head), dtype)

    def forward(self, tokens, positions=None, *, mesh=None,
                rules: Optional[ShardingRules] = None):
        """tokens [B, T] -> logits [B, T, vocab] (f32; on a mesh: this
        rank's rows)."""
        plan = self._plan(mesh, rules)
        x, _ = self._hidden(tokens, positions, plan)
        return _dot_f32(x, self._head(x.dtype, plan))

    apply = forward

    def pipeline_loss(self, batch: Dict[str, Any], *, mesh, n_stages: int,
                      n_micro: int, rules: Optional[ShardingRules] = None):
        """Next-token loss with the layer stack run as a microbatched
        pipeline over the `pipe` axis (parallel/pipeline.py), the
        alternative execution of the stacked layers loss() runs.

        The embedding runs outside the pipeline; stage s runs layers
        [s L/n, (s+1) L/n) (its shard of the "layers" -> "pipe" stack,
        under remat if cfg says so), the last stage the final norm, the
        unchunked head and the cross-entropy of each microbatch. The
        batch is this rank's rows (make_train_step's), split into n_micro
        microbatches; n_stages is the mesh's pipe size. Requires rows
        divisible by n_micro, n_layers by n_stages, stage-local attention
        (dense/flash: the sequence unsharded), a dense FFN and no mask."""
        cfg = self.cfg
        dev = self.embed.device
        if "targets" in batch:
            tokens = torch.as_tensor(batch["tokens"], device=dev)
            targets = torch.as_tensor(batch["targets"], device=dev)
        else:
            full = torch.as_tensor(batch["tokens"], device=dev)
            tokens, targets = full[:, :-1], full[:, 1:]
        b, t = tokens.shape
        if b % n_micro or cfg.n_layers % n_stages:
            raise ValueError(
                f"batch {b} % n_micro {n_micro} or n_layers "
                f"{cfg.n_layers} % n_stages {n_stages} != 0")
        if cfg.attention_impl in ("ring", "ulysses"):
            raise ValueError("pipeline stages need stage-local attention "
                             "(dense/flash), not ring/ulysses")
        if cfg.moe_experts:
            raise ValueError(
                "pipeline_loss does not thread the MoE aux "
                "(load-balancing) loss out of the pipeline yet; train "
                "MoE configs via Transformer.loss (expert axis), or set "
                "moe_experts=0 for the pipe axis")
        if "mask" in batch:
            raise ValueError("pipeline_loss takes no loss mask: its loss "
                             "is the mean over every token")
        plan = self._plan(mesh, rules, pipelined=True)
        if plan.seq.size > 1:
            raise ValueError("pipeline stages need the seq axis unsharded")
        cdt = torch_dtype(cfg.dtype)
        x = self._embed(tokens, plan)
        x_micro = x.view(n_micro, b // n_micro, t, x.shape[-1])
        y_micro = targets.long().view(n_micro, b // n_micro, t)
        cos, sin = _rope_tables(torch.arange(t, device=dev)[None, :],
                                cfg.head_dim, cfg.rope_theta)
        per_stage = cfg.n_layers // n_stages
        # this stage's layers, unbound once (see _hidden)
        staged = {name: plan.local(p).unbind(0)
                  for name, p in self.layers.items()}
        if len(staged["wo"]) != per_stage:
            raise ValueError(f"the layer stack is not split over "
                             f"{n_stages} pipe stages on this mesh")
        layer = self._layer_fn()

        def stage_fn(params, h):
            for i in range(per_stage):
                h, _, _ = layer(h, {n: ps[i] for n, ps in params.items()},
                                cos, sin, plan)
            return h

        def mb_loss(out, y, extras):
            h = _rmsnorm(out, extras["final_norm"], cfg.norm_eps)
            return torch.mean(_nll(_dot_f32(h, extras["head"]), y))

        extras = {"final_norm": plan.use_whole(
                      "final_norm", plan.local(self.final_norm), cdt),
                  "head": self._head(cdt, plan)}
        return pipeline(stage_fn, staged, x_micro, y_micro, extras,
                        axis=plan.pipe, n_stages=n_stages, n_micro=n_micro,
                        loss_fn=mb_loss)

    # ---- loss -------------------------------------------------------
    def loss(self, batch: Dict[str, Any], *, mesh=None,
             rules: Optional[ShardingRules] = None):
        """Next-token cross-entropy. batch = {"tokens": [B,T+1]} or
        {"tokens", "targets"}, with an optional "mask" [B,T]; returns the
        scalar mean loss (f32), plus moe_aux_coeff x the MoE aux loss for
        a MoE config. On a mesh the batch is this rank's rows (over `seq`
        its columns, as tokens and targets) and the mean is over them
        (make_train_step weighs the ranks)."""
        plan = self._plan(mesh, rules)
        dev = self.embed.device
        if plan.seq.size > 1 and "targets" not in batch:
            raise ValueError("over a seq axis the batch is this rank's "
                             "columns as tokens and targets "
                             "(make_train_step splits them)")
        if "targets" in batch:
            tokens = torch.as_tensor(batch["tokens"], device=dev)
            targets = torch.as_tensor(batch["targets"], device=dev)
        else:
            full = torch.as_tensor(batch["tokens"], device=dev)
            tokens, targets = full[:, :-1], full[:, 1:]
        targets = targets.long()
        mask = batch.get("mask")
        if mask is not None:
            mask = torch.as_tensor(mask, device=dev).to(torch.float32)
        b, t = tokens.shape
        x, aux = self._hidden(tokens, None, plan)
        aux_term = self.cfg.moe_aux_coeff * aux if aux is not None else 0.0
        head = self._head(x.dtype, plan)
        chunk = self.cfg.loss_chunk
        if not (chunk and t > chunk and t % chunk == 0):
            nll = _nll(_dot_f32(x, head), targets)
            if mask is not None:
                return torch.sum(nll * mask) / torch.clamp(
                    mask.sum(), min=1.0) + aux_term
            return torch.mean(nll) + aux_term

        # Chunked head + cross-entropy: one [B, chunk, vocab] f32 logits
        # block at a time, recomputed in backward (torch.utils.checkpoint
        # in place of jax.checkpoint).
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(t // chunk):
            sl = slice(i * chunk, (i + 1) * chunk)
            nll = checkpoint(lambda xc, tc: _nll(_dot_f32(xc, head), tc),
                             x[:, sl], targets[:, sl], use_reentrant=False)
            total = total + torch.sum(nll if mask is None else nll * mask[:, sl])
        if mask is None:
            return total / (b * t) + aux_term
        return total / torch.clamp(mask.sum(), min=1.0) + aux_term
