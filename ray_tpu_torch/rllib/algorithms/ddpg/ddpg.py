"""DDPG: deep deterministic policy gradient.

reference parity: rllib/algorithms/ddpg/ddpg.py — the ancestor TD3
refines (the reference implements TD3 on top of DDPG's policy; this
build inverts the inheritance, same math): every-step policy updates
(policy_delay=1) and NO target-action smoothing noise; twin critics
remain (clipped double-Q hurts nothing and shares the TD3 learner).
"""

from __future__ import annotations

from ray_tpu_torch.rllib.algorithms.td3.td3 import TD3, TD3Config


class DDPGConfig(TD3Config):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or DDPG)
        self.policy_delay = 1      # actor steps every update
        self.target_noise = 0.0    # no smoothing on target actions
        self.target_noise_clip = 0.0


class DDPG(TD3):
    pass
