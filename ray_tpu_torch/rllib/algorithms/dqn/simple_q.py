"""SimpleQ: plain deep Q-learning.

reference parity: rllib/algorithms/simple_q/simple_q.py — DQN stripped
of the extensions: no dueling head, no double-Q action selection, no
n-step windows, no prioritized replay; a target network refreshed on a
fixed interval and epsilon-greedy exploration. Exists as the smallest
correctness reference for the value-learning stack (the reference keeps
it for the same reason).
"""

from __future__ import annotations

from ray_tpu_torch.rllib.algorithms.dqn.dqn import DQN, DQNConfig


class SimpleQConfig(DQNConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or SimpleQ)
        self.dueling = False
        self.double_q = False
        self.n_step = 1
        self.prioritized_replay = False
        self.lr = 5e-4
        self.train_batch_size = 32

    _FROZEN = {"dueling": False, "double_q": False, "n_step": 1,
               "prioritized_replay": False}

    def training(self, **kwargs):
        # validate BEFORE applying so a rejected call leaves the config
        # untouched; re-stating the frozen value is fine
        for key, frozen_value in self._FROZEN.items():
            if key in kwargs and kwargs[key] != frozen_value:
                raise ValueError(
                    f"SimpleQ fixes {key}={frozen_value!r}; use "
                    f"DQNConfig for the extended variant")
        return super().training(**kwargs)


class SimpleQ(DQN):
    pass
