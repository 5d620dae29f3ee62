"""ray_tpu_torch.parallel: the port's counterpart of ray_tpu.parallel.

Only the single-device training step (train_step.make_train_step) is
ported so far. The mesh, sharding rules, ring and Ulysses attention and
multi-slice helpers that ray_tpu.parallel exports come with later slices
(ROADMAP.md), so nothing is re-exported here yet.
"""

__all__: list = []
