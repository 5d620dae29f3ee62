"""MultiAgentRLModule: independently-parameterized policies in one module.

The port's counterpart of ray_tpu/rllib/core/marl_module.py (reference
parity: rllib/core/rl_module/marl_module.py:40 (MultiAgentRLModule — a
container of RLModules keyed by module_id, routed by
AlgorithmConfig.policy_mapping_fn) and rllib/policy/sample_batch.py
MultiAgentBatch (per-module sub-batches)).

Here the container is an nn.ModuleDict, its members inserted in sorted
module-id order, so its state_dict keys are "<module_id>.<key>" and one
optimizer over its parameters() is one Adam over the union of the
modules' params. The learner sums every module's loss over its own
sub-batch, which gives each module its own gradients.
"""

from __future__ import annotations

from typing import Dict, List

from torch import nn

from ray_tpu_torch.rllib.core.rl_module import RLModule


class MultiAgentRLModule(nn.ModuleDict):
    """Container of per-policy RLModules keyed by module_id."""

    def __init__(self, modules: Dict[str, RLModule]):
        if not modules:
            raise ValueError("MultiAgentRLModule needs at least one module")
        super().__init__({mid: modules[mid] for mid in sorted(modules)})

    @property
    def module_ids(self) -> List[str]:
        return sorted(self.keys())

    def init_params(self, seed: int) -> None:
        """(Re)initialise every module in place, module i (in module_ids
        order) from seed + i."""
        for i, mid in enumerate(self.module_ids):
            self[mid].init_params(seed + i)
