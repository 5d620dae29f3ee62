"""Parameter schedules (epsilon, lr, entropy coeff ... as f(timestep)).

reference parity: rllib/utils/schedules/ — ConstantSchedule,
LinearSchedule (schedules/linear_schedule.py), PiecewiseSchedule
(piecewise_schedule.py, endpoints + interpolation), ExponentialSchedule
(exponential_schedule.py). Pure host-side floats: schedules drive
exploration and optimizer hyperparams from the driver loop; anything that
must live *inside* a jitted update is threaded through
Learner.extra_inputs instead.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple


class Schedule:
    """value(t) for a global timestep t >= 0."""

    def value(self, t: float) -> float:
        raise NotImplementedError

    def __call__(self, t: float) -> float:
        return self.value(t)


class ConstantSchedule(Schedule):
    def __init__(self, value: float):
        self._v = float(value)

    def value(self, t: float) -> float:
        return self._v


class LinearSchedule(Schedule):
    """Linear from initial_p to final_p over schedule_timesteps, then
    clamped at final_p (reference linear_schedule.py)."""

    def __init__(self, schedule_timesteps: int, final_p: float,
                 initial_p: float = 1.0):
        assert schedule_timesteps > 0
        self.schedule_timesteps = schedule_timesteps
        self.initial_p = float(initial_p)
        self.final_p = float(final_p)

    def value(self, t: float) -> float:
        frac = min(max(float(t), 0.0) / self.schedule_timesteps, 1.0)
        return self.initial_p + frac * (self.final_p - self.initial_p)


class PiecewiseSchedule(Schedule):
    """Endpoint list [(t, v), ...] with interpolation between adjacent
    endpoints; outside the range returns outside_value (reference
    piecewise_schedule.py)."""

    def __init__(self, endpoints: Sequence[Tuple[float, float]],
                 interpolation: Callable[[float, float, float], float]
                 = None,
                 outside_value: float = None):
        ends: List[Tuple[float, float]] = sorted(
            (float(t), float(v)) for t, v in endpoints)
        assert len(ends) >= 1
        self.endpoints = ends
        self.interpolation = interpolation or (
            lambda l, r, alpha: l + alpha * (r - l))
        self.outside_value = outside_value

    def value(self, t: float) -> float:
        t = float(t)
        for (lt, lv), (rt, rv) in zip(self.endpoints[:-1],
                                      self.endpoints[1:]):
            if lt <= t < rt:
                alpha = (t - lt) / (rt - lt)
                return self.interpolation(lv, rv, alpha)
        if self.outside_value is not None:
            return self.outside_value
        # clamp to nearest endpoint
        if t < self.endpoints[0][0]:
            return self.endpoints[0][1]
        return self.endpoints[-1][1]


class ExponentialSchedule(Schedule):
    """initial_p * decay_rate ** (t / schedule_timesteps)."""

    def __init__(self, schedule_timesteps: int, initial_p: float = 1.0,
                 decay_rate: float = 0.1):
        assert schedule_timesteps > 0
        self.schedule_timesteps = schedule_timesteps
        self.initial_p = float(initial_p)
        self.decay_rate = float(decay_rate)

    def value(self, t: float) -> float:
        return self.initial_p * self.decay_rate ** (
            float(t) / self.schedule_timesteps)
