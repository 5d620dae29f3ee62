"""Learner: the gradient engine, on an explicit device.

The port's counterpart of ray_tpu/rllib/core/learner.py (reference
parity: rllib/core/learner/learner.py:231 and TorchLearner,
torch_learner.py:53). An algorithm overrides compute_loss; the engine
runs the minibatch update around it: autograd, the global grad norm
(reported before clipping), optax's clip_by_global_norm where the
config sets grad_clip (scale by max_norm / norm when norm >= max_norm,
with no epsilon, unlike torch.nn.utils.clip_grad_norm_), and Adam with
optax.adam's update (torch.optim.Adam, eps 1e-8); postprocess_updates
drops a param group's step where optax's hook would zero its update.
additional_update handles KL-coeff style schedules and target nets.

The learner's device is the config's learner_device: None is the card,
and raises where there is none. Weights and state leave the learner as
CPU numpy, so a pickled weight sync never carries a CUDA tensor (which
would initialise CUDA in every EnvRunner process that unpickles it).
"""

from __future__ import annotations

import copy
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rllib.core.rl_module import RLModule


def _to_numpy(tree):
    """Tensors in nested dicts/lists -> CPU numpy copies."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True).numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    return tree


def _to_torch(tree):
    """numpy arrays in nested dicts/lists -> CPU tensors."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return tree


def index_matrix(n: int, minibatch_size: int, num_iters: int,
                 seed: int) -> np.ndarray:
    """[steps, minibatch] row indices of a sweep, as the JAX package's
    Learner._update_impl draws them: num_iters epochs of shuffled
    minibatches from np.random.default_rng(seed), ragged tails dropped;
    one shuffled full batch when it is smaller than one minibatch."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(num_iters):
        perm = rng.permutation(n)
        for start in range(0, n - minibatch_size + 1, minibatch_size):
            rows.append(perm[start:start + minibatch_size])
    if not rows:
        rows = [rng.permutation(n)]
    return np.stack(rows)


def sweep_stats(pending: List[Dict[str, torch.Tensor]]) -> Dict[str, Any]:
    """A sweep's per-minibatch stats -> the reported ones, as the JAX
    package's Learner._sweep_stats gives them: a scalar stat averages over
    the minibatches; an array stat (per-sample TD errors and their
    buffer indexes) keeps the last minibatch's values, in its own dtype.
    Everything crosses to the host in one f64 block (one forcing point);
    integer stats are exact there below 2**53."""
    keys = list(pending[0])
    scalars = [k for k in keys if pending[0][k].dim() == 0]
    arrays = [k for k in keys if pending[0][k].dim() > 0]
    parts = [torch.stack([torch.stack([st[k].double() for k in scalars])
                          for st in pending]).reshape(-1)] if scalars else []
    parts += [pending[-1][k].double().reshape(-1) for k in arrays]
    host = torch.cat(parts).cpu().numpy()
    n = len(pending) * len(scalars)
    means = host[:n].reshape(len(pending), len(scalars)).mean(axis=0)
    out: Dict[str, Any] = {k: float(v) for k, v in zip(scalars, means)}
    for k in arrays:
        last = pending[-1][k]
        size = last.numel()
        np_dtype = torch.empty(0, dtype=last.dtype).numpy().dtype
        out[k] = host[n:n + size].reshape(tuple(last.shape)).astype(np_dtype)
        n += size
    return out


class Learner:
    def __init__(self, module: RLModule, config):
        # the learner's own copy: it moves to the learner's device, while
        # the caller's module (and a local EnvRunner's) stays on the CPU
        self.module = copy.deepcopy(module)
        self.config = config
        self.device: Optional[torch.device] = None
        self._optimizer = None
        self._world = 1
        # serializes updates against weight reads and writes
        self._state_lock = threading.Lock()
        # mutable state for additional_update (e.g. kl coeff)
        self.curr_kl_coeff = getattr(config, "kl_coeff", 0.0)

    # ---- build ------------------------------------------------------
    def target_device(self) -> torch.device:
        """Where build() puts the module: the config's learner_device
        (None is the card, raising where there is none)."""
        return resolve_device(getattr(self.config, "learner_device", None))

    def build(self, seed: int = 0) -> None:
        self.device = self.target_device()
        with self._state_lock:
            self.module.init_params(seed)
            self.module.to(self.device)
            self._optimizer = torch.optim.Adam(
                self.module.parameters(), lr=self.config.lr, eps=1e-8)

    # ---- distributed (gang) build -----------------------------------
    def data_axis_for(self, key: str) -> int:
        """Which axis of a batch column is the data-parallel axis (row
        batches: 0; time-major IMPALA sequences override it to 1)."""
        return 0

    def build_distributed(self, seed: int = 0) -> None:
        """Build after torch.distributed.init_process_group: every rank
        draws the same params from the same seed on the CPU (so they are
        replicated), and every update step averages the ranks' grads with
        one all-reduce: the grad of the mean loss over the global
        minibatch, as the JAX package's sharded global-mean loss gives
        (reference: torch DDP, torch_learner.py:378-390)."""
        import torch.distributed as dist
        self.build(seed)
        self._world = dist.get_world_size()

    def update_distributed(self, local_batch: Dict[str, np.ndarray],
                           minibatch_size: Optional[int] = None,
                           num_iters: int = 1,
                           seed: int = 0) -> Dict[str, Any]:
        """Minibatch SGD on this rank's shard: every rank runs the same
        number of steps (collectives wedge otherwise); each step's global
        minibatch is the union of the ranks' local ones."""
        first = next(iter(local_batch))
        n = local_batch[first].shape[self.data_axis_for(first)]
        local_mb = max(1, (minibatch_size or n * self._world)
                       // self._world)
        return self.update(local_batch, local_mb, num_iters, seed)

    # ---- algorithm contract ----------------------------------------
    def compute_loss(self, batch: Dict[str, torch.Tensor],
                     extra: Dict[str, Any]
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def additional_update(self, **kwargs) -> Dict[str, Any]:
        return {}

    def extra_inputs(self) -> Dict[str, Any]:
        """Inputs passed to the loss (kl coeff, target nets etc.), read
        once an update."""
        return {}

    def postprocess_updates(self, extra: Dict[str, Any]) -> Tuple[str, ...]:
        """The JAX package's hook between optimizer.update and
        apply_updates (TD3 zeroes the actor's update on the steps its
        policy delay gates). Here it names the module's top-level param
        groups whose update this step drops: step() advances every Adam
        moment, as optax's update does, and then those params are put
        back. Default: none."""
        return ()

    # ---- one step ---------------------------------------------------
    def _step(self, mb: Dict[str, torch.Tensor], extra: Dict[str, Any]
              ) -> Dict[str, torch.Tensor]:
        params = [p for p in self.module.parameters()]
        loss, stats = self.compute_loss(mb, extra)
        grads = list(torch.autograd.grad(loss, params))
        if self._world > 1:
            grads = self._all_reduce_mean(grads)
        # optax.global_norm: the square root of the sum of squares
        g_norm = torch.stack([torch.sum(g * g) for g in grads]).sum().sqrt()
        clip = getattr(self.config, "grad_clip", None)
        if clip:
            # optax.clip_by_global_norm, on the device (no host sync)
            grads = [torch.where(g_norm < clip, g, g / g_norm * clip)
                     for g in grads]
        for p, g in zip(params, grads):
            p.grad = g
        held = self.postprocess_updates(extra)
        kept = [(p, p.detach().clone())
                for name, p in self.module.named_parameters()
                if name.split(".", 1)[0] in held] if held else []
        self._optimizer.step()
        with torch.no_grad():
            for p, before in kept:
                p.copy_(before)
        out = {k: v.detach() for k, v in stats.items()}
        out["total_loss"] = loss.detach()
        out["grad_norm"] = g_norm
        return out

    def _all_reduce_mean(self, grads: List[torch.Tensor]
                         ) -> List[torch.Tensor]:
        import torch.distributed as dist
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        flat /= self._world
        return [t.view_as(g) for t, g in
                zip(flat.split([g.numel() for g in grads]), grads)]

    # ---- update loop ------------------------------------------------
    def _on_device(self, column) -> torch.Tensor:
        """A batch column on the learner's device: a numpy column
        crosses once (arrays from the object store are read-only: copied
        then); a tensor already there (a DeviceFeed's output) is used as
        it is."""
        if isinstance(column, torch.Tensor):
            return column.to(self.device)
        return torch.from_numpy(np.require(column, None, "CW")).to(
            self.device)

    def update(self, batch: Dict[str, Any],
               minibatch_size: Optional[int] = None,
               num_iters: int = 1,
               seed: int = 0) -> Dict[str, Any]:
        """Minibatch SGD over the batch (reference Learner.update /
        TorchLearner._update loop): the batch crosses to the device once
        (numpy columns, or tensors already on the device), each minibatch
        is gathered there from an index tensor, and the stats are read
        once, at the end of the sweep (sweep_stats)."""
        from ray_tpu_torch._private import spans as _spans
        from ray_tpu_torch.util import cuda_sentinel
        with _spans.span("learner.update", num_iters=num_iters), \
                cuda_sentinel.step_region("learner.update"):
            assert self._optimizer is not None, "call build() first"
            n = len(batch["obs"])
            idx = torch.from_numpy(index_matrix(
                n, minibatch_size or n, num_iters, seed)).to(self.device)
            dev_batch = {k: self._on_device(v) for k, v in batch.items()}
            extra = self.extra_inputs()
            pending = []
            with self._state_lock:
                for rows in idx:
                    pending.append(self._step(
                        {k: v.index_select(0, rows)
                         for k, v in dev_batch.items()}, extra))
            return sweep_stats(pending)

    # ---- weights (CPU numpy) ----------------------------------------
    def get_weights(self) -> Dict[str, np.ndarray]:
        with self._state_lock:
            return _to_numpy(dict(self.module.state_dict()))

    def set_weights(self, weights: Dict[str, np.ndarray]) -> None:
        with self._state_lock:
            self.module.load_state_dict(_to_torch(weights))

    def get_state(self) -> Dict[str, Any]:
        with self._state_lock:
            return {"params": _to_numpy(dict(self.module.state_dict())),
                    "opt_state": _to_numpy(self._optimizer.state_dict()),
                    "kl_coeff": self.curr_kl_coeff}

    def set_state(self, state: Dict[str, Any]) -> None:
        with self._state_lock:
            self.module.load_state_dict(_to_torch(state["params"]))
            self._optimizer.load_state_dict(_to_torch(state["opt_state"]))
            self.curr_kl_coeff = state.get("kl_coeff", self.curr_kl_coeff)
