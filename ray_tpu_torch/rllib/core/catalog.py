"""Catalog: default network builders per observation/action space.

The port's counterpart of ray_tpu/rllib/core/catalog.py (reference
parity: rllib/core/models/catalog.py:33 and the legacy ModelCatalog,
rllib/models/catalog.py:205): the tanh MLP actor-critic for vector
observations and the Nature CNN for [H, W, C] uint8 frames, each with a
policy and a value head. Layers sit in ModuleLists named as the JAX
package's params pytree ({"torso"|"convs"|"dense"|"pi"|"vf": [layer]}),
so params_from_jax maps one onto the other layer by layer, and flat_order
walks a module's params in the JAX pytree's leaf order and layout (what
ravel_pytree flattens, and what ES and parameter noise perturb).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn.utils import skip_init

from ray_tpu_torch.rllib.core.marl_module import MultiAgentRLModule
from ray_tpu_torch.rllib.core.rl_module import Categorical, RLModule
from ray_tpu_torch.rllib.env.spaces import Box, Discrete


def _mlp(sizes: Sequence[int]) -> nn.ModuleList:
    return nn.ModuleList(skip_init(nn.Linear, fan_in, fan_out)
                         for fan_in, fan_out in zip(sizes[:-1], sizes[1:]))


def _he_init(layers: nn.ModuleList, gen: torch.Generator,
             scale_last=None) -> None:
    """The JAX package's init (catalog.py _mlp_init): weights N(0, 1)
    times sqrt(2 / fan_in), the last layer's times `scale_last` in its
    place where given; biases 0. Drawn on the CPU from `gen`, so a seed
    gives the same params on every device."""
    for i, layer in enumerate(layers):
        w = layer.weight
        fan_in = w[0].numel()
        scale = (2.0 / fan_in) ** 0.5
        if i == len(layers) - 1 and scale_last is not None:
            scale = scale_last
        with torch.no_grad():
            w.copy_(torch.randn(w.shape, generator=gen) * scale)
            layer.bias.zero_()


def _mlp_apply(layers: nn.ModuleList, x: torch.Tensor,
               detach: bool = False) -> torch.Tensor:
    """The JAX package's _mlp_apply: dense layers with tanh between them.
    With `detach`, the layers' params take no gradient while `x` still
    does (the JAX package's stop_gradient on a params subtree)."""
    for i, layer in enumerate(layers):
        if detach:
            x = nn.functional.linear(x, layer.weight.detach(),
                                     layer.bias.detach())
        else:
            x = layer(x)
        if i < len(layers) - 1:
            x = torch.tanh(x)
    return x


class DiscreteMLPModule(RLModule):
    """Actor-critic MLP for Discrete action spaces."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hiddens: Sequence[int] = (64, 64)):
        super().__init__()
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hiddens = tuple(hiddens)
        self.torso = _mlp([obs_dim, *self.hiddens])
        self.pi = _mlp([self.hiddens[-1], num_actions])
        self.vf = _mlp([self.hiddens[-1], 1])
        self.init_params(0)

    def init_params(self, seed: int) -> None:
        gen = torch.Generator().manual_seed(seed)
        _he_init(self.torso, gen)
        _he_init(self.pi, gen, scale_last=0.01)
        _he_init(self.vf, gen, scale_last=1.0)

    def forward_train(self, batch):
        h = torch.tanh(_mlp_apply(self.torso,
                                  batch["obs"].to(self.pi[0].weight.dtype)))
        logits = _mlp_apply(self.pi, h)
        vf = _mlp_apply(self.vf, h)[..., 0]
        return {"action_dist_inputs": logits, "vf_preds": vf}

    def action_dist(self, dist_inputs) -> Categorical:
        return Categorical(dist_inputs)


class DiscreteConvModule(RLModule):
    """Actor-critic conv net for image observations ([H, W, C] uint8).

    The classic Atari torso (reference models/catalog.py CNN defaults /
    the Nature-DQN stack used by the Pong tuned examples): conv 32@8s4,
    64@4s2, 64@3s1 → dense 512 → policy/value heads. uint8 pixels are
    normalized to [0,1] inside the forward (in the params' dtype, f32 as
    in the JAX module), so frames cross the object store and the
    host-to-device copy as compact uint8. The convs run on
    an NCHW view of the NHWC frames; the conv output is permuted back to
    NHWC before it is flattened, so the dense layer's rows are in the
    JAX module's H, W, C order.
    """

    CONVS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))  # (out_ch, kernel, stride)

    def __init__(self, obs_shape: Sequence[int], num_actions: int,
                 dense: int = 512):
        super().__init__()
        assert len(obs_shape) == 3, f"need [H,W,C] obs, got {obs_shape}"
        self.obs_shape = tuple(obs_shape)
        self.num_actions = num_actions
        in_ch = self.obs_shape[-1]
        convs = []
        for out_ch, k, s in self.CONVS:
            convs.append(skip_init(nn.Conv2d, in_ch, out_ch, k, stride=s))
            in_ch = out_ch
        self.convs = nn.ModuleList(convs)
        self.dense = _mlp([self._conv_out_size(), dense])
        self.pi = _mlp([dense, num_actions])
        self.vf = _mlp([dense, 1])
        self.init_params(0)

    def _conv_out_size(self) -> int:
        h, w, _ = self.obs_shape
        for _, k, s in self.CONVS:
            h = (h - k) // s + 1
            w = (w - k) // s + 1
        return h * w * self.CONVS[-1][0]

    def init_params(self, seed: int) -> None:
        gen = torch.Generator().manual_seed(seed)
        _he_init(self.convs, gen)
        _he_init(self.dense, gen)
        _he_init(self.pi, gen, scale_last=0.01)
        _he_init(self.vf, gen, scale_last=1.0)

    def forward_train(self, batch):
        x = batch["obs"].to(self.pi[0].weight.dtype) / 255.0
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view
        for conv in self.convs:
            x = torch.relu(conv(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # H, W, C order
        h = torch.relu(_mlp_apply(self.dense, x))
        logits = _mlp_apply(self.pi, h)
        vf = _mlp_apply(self.vf, h)[..., 0]
        return {"action_dist_inputs": logits, "vf_preds": vf}

    def action_dist(self, dist_inputs) -> Categorical:
        return Categorical(dist_inputs)


def _to_jax_layout(value: np.ndarray) -> np.ndarray:
    """A param in the port's layout -> the JAX package's: nn.Linear's
    [out, in] -> [in, out], nn.Conv2d's OIHW -> HWIO."""
    if value.ndim == 4:
        return value.transpose(2, 3, 1, 0)
    return value.T if value.ndim == 2 else value


def _from_jax_layout(value: np.ndarray) -> np.ndarray:
    if value.ndim == 4:
        return value.transpose(3, 2, 0, 1)
    return value.T if value.ndim == 2 else value


def params_from_jax(module: RLModule, jax_params: Dict[str, Any]
                    ) -> Dict[str, torch.Tensor]:
    """The JAX package's params pytree (numpy leaves) -> this module's
    state_dict: dense weights [in, out] become nn.Linear's [out, in],
    conv kernels HWIO become nn.Conv2d's OIHW. A group is a list of
    layers (torso, pi, the dueling adv/val heads, SAC's and TD3's q1/q2)
    or one array leaf, a param of its own (SAC's log_alpha). A
    MultiAgentRLModule takes the multi-agent tree {module_id: tree}, its
    keys "<module_id>.<key>"."""
    if isinstance(module, MultiAgentRLModule):
        if set(jax_params) != set(module.module_ids):
            raise KeyError(f"JAX modules {sorted(jax_params)} do not match "
                           f"the module's {module.module_ids}")
        return {f"{mid}.{k}": v for mid in module.module_ids
                for k, v in params_from_jax(module[mid],
                                            jax_params[mid]).items()}
    out = {}
    for group, layers in jax_params.items():
        if not isinstance(layers, (list, tuple)):
            out[group] = torch.tensor(np.asarray(layers))
            continue
        for i, layer in enumerate(layers):
            w = _from_jax_layout(np.asarray(layer["w"]))
            out[f"{group}.{i}.weight"] = torch.tensor(w)
            out[f"{group}.{i}.bias"] = torch.tensor(np.asarray(layer["b"]))
    want = module.state_dict()
    if set(out) != set(want):
        raise KeyError(f"JAX params {sorted(out)} do not match the "
                       f"module's {sorted(want)}")
    for k, v in out.items():
        if v.shape != want[k].shape:
            raise ValueError(f"{k}: {tuple(v.shape)} from JAX, "
                             f"{tuple(want[k].shape)} in the module")
    return out


def _jax_path(key: str) -> Tuple:
    """A state_dict key -> its leaf's path in the JAX params pytree:
    "torso.0.weight" -> ("torso", 0, "w"), "log_alpha" -> ("log_alpha",),
    "pol_a.pi.1.bias" -> ("pol_a", "pi", 1, "b"). Sorting by it is the
    pytree's leaf order: dict keys sorted, list items by index."""
    names = {"weight": "w", "bias": "b"}
    return tuple(int(p) if p.isdigit() else names.get(p, p)
                 for p in key.split("."))


class FlatOrder:
    """A module's params as one flat vector in the JAX leaf order and
    layout (flatten), and back (unflatten); leaves() walks them one by
    one in that order."""

    def __init__(self, module: torch.nn.Module):
        state = module.state_dict()
        self.keys: List[str] = sorted(state, key=_jax_path)
        self.jax_shapes = {
            k: _to_jax_layout(np.empty(tuple(state[k].shape), np.int8)).shape
            for k in self.keys}
        self.sizes = {k: int(np.prod(self.jax_shapes[k], dtype=np.int64))
                      for k in self.keys}
        self.dim = sum(self.sizes.values())

    def leaves(self, state: Dict[str, Any]):
        """(key, the param in the JAX layout as numpy) in leaf order."""
        for k in self.keys:
            v = state[k]
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            yield k, _to_jax_layout(np.asarray(v))

    @staticmethod
    def from_jax(value: np.ndarray) -> np.ndarray:
        """One leaf in the JAX layout -> the module's layout (a
        contiguous copy)."""
        return np.ascontiguousarray(_from_jax_layout(value))

    def flatten(self, state: Dict[str, Any]) -> np.ndarray:
        """A state_dict (tensors on any device, or numpy) -> the f32
        vector ravel_pytree gives of the same params in the JAX tree."""
        return np.concatenate([v.reshape(-1) for _, v in
                               self.leaves(state)]).astype(np.float32)

    def unflatten(self, flat: np.ndarray) -> Dict[str, np.ndarray]:
        """flatten's inverse: a state_dict of numpy arrays."""
        out, at = {}, 0
        for k in self.keys:
            n = self.sizes[k]
            out[k] = self.from_jax(
                np.asarray(flat[at:at + n]).reshape(self.jax_shapes[k]))
            at += n
        if at != len(flat):
            raise ValueError(f"{len(flat)} values for {at} params")
        return out


def flat_order(module: torch.nn.Module) -> FlatOrder:
    """The JAX leaf order and layout of `module`'s params (FlatOrder)."""
    return FlatOrder(module)


def default_module_for(observation_space, action_space,
                       hiddens: Sequence[int] = (64, 64)) -> RLModule:
    """reference Catalog._get_encoder_config dispatch, reduced to the
    spaces this build ships."""
    if isinstance(action_space, Discrete) and \
            isinstance(observation_space, Box):
        if len(observation_space.shape) == 1:
            return DiscreteMLPModule(
                observation_space.shape[0], action_space.n, hiddens)
        if len(observation_space.shape) == 3:
            return DiscreteConvModule(
                observation_space.shape, action_space.n)
    raise NotImplementedError(
        f"no default module for obs={observation_space} "
        f"act={action_space}; pass a custom RLModule via config.rl_module()")
