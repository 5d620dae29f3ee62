"""Trial schedulers: FIFO, ASHA, median stopping, PBT.

reference parity: python/ray/tune/schedulers/ — FIFOScheduler,
AsyncHyperBandScheduler/ASHA (async_hyperband.py: rungs at
grace_period * reduction_factor^k; a trial reaching a rung must be in the
top 1/reduction_factor of completed results at that rung or it stops),
MedianStoppingRule (median_stopping_rule.py), and
PopulationBasedTraining (pbt.py: bottom-quantile trials clone a
top-quantile trial's checkpoint and perturb its hyperparams).

Decision protocol: on_result returns CONTINUE, STOP, or an exploit dict
{"action": "exploit", "source": trial_id, "config": {...}} that the
controller executes by cloning the source's checkpoint into the trial.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np

CONTINUE = "CONTINUE"
STOP = "STOP"


class FIFOScheduler:
    def on_result(self, trial_id: str, result: Dict[str, Any]) -> str:
        return CONTINUE


class ASHAScheduler:
    def __init__(self, *, metric: str, mode: str = "max",
                 time_attr: str = "training_iteration",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: int = 4):
        assert mode in ("max", "min")
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.max_t = max_t
        self.grace = grace_period
        self.rf = reduction_factor
        # rung milestone -> list of recorded metric values at that rung
        self._rungs: Dict[int, list] = defaultdict(list)
        milestones = []
        t = grace_period
        while t < max_t:
            milestones.append(t)
            t *= reduction_factor
        self._milestones = milestones

    def on_result(self, trial_id: str, result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr, 0)
        value = result.get(self.metric)
        if value is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP
        decision = CONTINUE
        for milestone in self._milestones:
            if t == milestone:
                recorded = self._rungs[milestone]
                recorded.append(value)
                ranked = sorted(recorded, reverse=(self.mode == "max"))
                # Keep the top len//rf (>=1) at this rung; an early arrival
                # with no peers is promoted optimistically (async ASHA).
                keep = max(1, len(ranked) // self.rf)
                if len(ranked) >= self.rf and \
                        ranked.index(value) >= keep:
                    decision = STOP
        return decision


class MedianStoppingRule:
    """Stop a trial whose running-average metric falls below the median
    of other trials' running averages at the same step (reference
    schedulers/median_stopping_rule.py)."""

    def __init__(self, *, metric: str, mode: str = "max",
                 time_attr: str = "training_iteration",
                 grace_period: int = 1, min_samples_required: int = 3):
        assert mode in ("max", "min")
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.grace = grace_period
        self.min_samples = min_samples_required
        # per trial: list of (step, value) so comparisons are
        # step-aligned (a late-starting trial is judged against what
        # others had achieved BY the same step, not their mature means)
        self._history: Dict[str, List[tuple]] = defaultdict(list)

    def _mean_up_to(self, trial_id: str, t: float) -> Optional[float]:
        vals = [v for (s, v) in self._history[trial_id] if s <= t]
        return float(np.mean(vals)) if vals else None

    def on_result(self, trial_id: str, result: Dict[str, Any]) -> str:
        value = result.get(self.metric)
        t = result.get(self.time_attr, 0)
        if value is None:
            return CONTINUE
        self._history[trial_id].append((t, float(value)))
        if t < self.grace:
            return CONTINUE
        others = [m for k in self._history if k != trial_id
                  for m in [self._mean_up_to(k, t)] if m is not None]
        if len(others) < self.min_samples:
            return CONTINUE
        median = float(np.median(others))
        mine = self._mean_up_to(trial_id, t)
        worse = mine < median if self.mode == "max" else mine > median
        return STOP if worse else CONTINUE


MutationSpace = Union[Sequence[Any], Callable[[], Any]]


class PopulationBasedTraining:
    """PBT (reference schedulers/pbt.py): every perturbation_interval, a
    bottom-quantile trial exploits (clones checkpoint + config of) a
    random top-quantile trial and explores (perturbs the hyperparams —
    resample from the mutation space with resample_probability, else
    scale numerics by 1.2/0.8 or hop to a neighboring choice)."""

    def __init__(self, *, metric: str, mode: str = "max",
                 time_attr: str = "training_iteration",
                 perturbation_interval: int = 4,
                 hyperparam_mutations: Dict[str, MutationSpace],
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 seed: Optional[int] = None):
        assert mode in ("max", "min")
        assert 0 < quantile_fraction <= 0.5
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = dict(hyperparam_mutations)
        self.quantile = quantile_fraction
        self.resample_prob = resample_probability
        self._rng = np.random.default_rng(seed)
        self._configs: Dict[str, Dict[str, Any]] = {}
        self._scores: Dict[str, float] = {}
        self._last_perturb: Dict[str, float] = {}
        self.num_perturbations = 0

    # controller calls this for every trial before the loop starts
    def on_trial_add(self, trial_id: str,
                     config: Dict[str, Any]) -> None:
        self._configs[trial_id] = dict(config)
        self._last_perturb.setdefault(trial_id, 0)

    # controller calls this when a trial terminates/errors so the
    # population gate tracks LIVE trials (a dead trial that never
    # reports would otherwise freeze PBT into FIFO forever)
    def on_trial_remove(self, trial_id: str) -> None:
        self._configs.pop(trial_id, None)
        self._scores.pop(trial_id, None)

    # controller confirms a successfully-applied exploit; only then
    # does the scheduler's config view (and the perturb counter) move
    def confirm_exploit(self, trial_id: str,
                        config: Dict[str, Any]) -> None:
        self._configs[trial_id] = dict(config)
        self.num_perturbations += 1

    def _resample(self, space: MutationSpace) -> Any:
        if callable(space):
            return space()
        return space[self._rng.integers(len(space))]

    def _explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        out = dict(config)
        for key, space in self.mutations.items():
            cur = out.get(key)
            if self._rng.random() < self.resample_prob or cur is None:
                out[key] = self._resample(space)
            elif not callable(space) and cur in list(space):
                # choice list: hop to a neighboring value (reference
                # pbt explore picks an adjacent index for lists)
                ix = list(space).index(cur)
                ix = int(np.clip(
                    ix + self._rng.choice([-1, 1]), 0, len(space) - 1))
                out[key] = list(space)[ix]
            elif isinstance(cur, (int, float)):
                # continuous space: scale by 1.2 / 0.8
                factor = 1.2 if self._rng.random() < 0.5 else 0.8
                if isinstance(cur, float):
                    out[key] = type(cur)(cur * factor)
                else:
                    nxt = int(round(cur * factor))
                    if nxt == cur:
                        # small ints: truncation would pin the value
                        # forever; force a step of 1 in the chosen
                        # direction instead
                        nxt = cur + 1 if factor > 1 else cur - 1
                    out[key] = max(1, nxt)
            else:
                out[key] = self._resample(space)
        return out

    def on_result(self, trial_id: str, result: Dict[str, Any]):
        value = result.get(self.metric)
        t = result.get(self.time_attr, 0)
        if value is None:
            return CONTINUE
        self._scores[trial_id] = float(value)
        self._configs.setdefault(trial_id, {})
        if t - self._last_perturb.get(trial_id, 0) < self.interval:
            return CONTINUE
        self._last_perturb[trial_id] = t
        # wait until the whole registered population has reported —
        # quantiles over a partial population exploit prematurely
        population = max(2, len(self._configs))
        if len(self._scores) < population:
            return CONTINUE
        ordered = sorted(self._scores,
                         key=lambda k: self._scores[k],
                         reverse=(self.mode == "max"))
        k = max(1, int(len(ordered) * self.quantile))
        top, bottom = ordered[:k], ordered[-k:]
        if trial_id not in bottom or trial_id in top:
            return CONTINUE
        candidates = [s for s in top if s != trial_id]
        src = candidates[self._rng.integers(len(candidates))]
        new_config = self._explore(self._configs[src])
        # proposal only — the controller calls confirm_exploit once the
        # checkpoint clone actually succeeds
        return {"action": "exploit", "source": src,
                "config": new_config}
