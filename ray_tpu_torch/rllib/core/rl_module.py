"""RLModule: the policy/value network contract, as a torch module.

The port's counterpart of ray_tpu/rllib/core/rl_module.py (reference
parity: rllib/core/rl_module/rl_module.py:229 — forward_exploration /
forward_inference / forward_train). The JAX package's modules are
stateless describers over an explicit params pytree; here a module is an
nn.Module that holds its params, so the Learner trains it with autograd
on its device and an EnvRunner runs its own CPU copy, loaded from the
learner's weights as CPU numpy.

Output column names follow the reference's SampleBatch/Columns contract
(rllib/policy/sample_batch.py): actions, action_logp,
action_dist_inputs, vf_preds.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn


class RLModule(nn.Module):
    """Subclasses define the network and init_params."""

    def init_params(self, seed: int) -> None:
        """(Re)initialise every param in place from `seed`."""
        raise NotImplementedError

    def forward_train(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """-> {"action_dist_inputs": logits, "vf_preds": values}."""
        raise NotImplementedError

    def forward(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        return self.forward_train(batch)

    def forward_exploration(self, batch: Dict[str, Any],
                            generator: torch.Generator) -> Dict[str, Any]:
        """Stochastic acting: adds sampled actions + their logp."""
        out = self.forward_train(batch)
        dist = self.action_dist(out["action_dist_inputs"])
        actions, logp = dist.sample_and_logp(generator)
        out["actions"] = actions
        out["action_logp"] = logp
        return out

    def forward_inference(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """Greedy acting."""
        out = self.forward_train(batch)
        dist = self.action_dist(out["action_dist_inputs"])
        out["actions"] = dist.mode()
        return out

    def action_dist(self, dist_inputs):
        raise NotImplementedError


class Categorical:
    """Categorical over logits [..., n]."""

    def __init__(self, logits: torch.Tensor):
        self.logits = logits

    def sample_and_logp(self, generator: torch.Generator
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        probs = torch.softmax(self.logits, dim=-1)
        flat = probs.reshape(-1, probs.shape[-1])
        actions = torch.multinomial(flat, 1, generator=generator)
        actions = actions.reshape(probs.shape[:-1])
        return actions, self.logp(actions)

    def logp(self, actions: torch.Tensor) -> torch.Tensor:
        logp_all = torch.log_softmax(self.logits, dim=-1)
        return torch.gather(logp_all, -1,
                            actions.long().unsqueeze(-1)).squeeze(-1)

    def entropy(self) -> torch.Tensor:
        p = torch.softmax(self.logits, dim=-1)
        logp = torch.log_softmax(self.logits, dim=-1)
        return -torch.sum(p * logp, dim=-1)

    def mode(self) -> torch.Tensor:
        return torch.argmax(self.logits, dim=-1)

    def kl(self, other: "Categorical") -> torch.Tensor:
        p = torch.softmax(self.logits, dim=-1)
        return torch.sum(
            p * (torch.log_softmax(self.logits, dim=-1)
                 - torch.log_softmax(other.logits, dim=-1)), dim=-1)
