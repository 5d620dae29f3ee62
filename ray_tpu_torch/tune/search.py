"""Search spaces + variant generation (grid + random sampling).

reference parity: python/ray/tune/search/ — BasicVariantGenerator
(search/basic_variant.py) expanding tune.grid_search over the cross
product and sampling Domain objects (search/sample.py: choice/uniform/
loguniform/randint) num_samples times.
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Dict, Iterator, List, Optional


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Choice(Domain):
    def __init__(self, categories: List[Any]):
        self.categories = list(categories)

    def sample(self, rng: random.Random) -> Any:
        return rng.choice(self.categories)


class Uniform(Domain):
    def __init__(self, low: float, high: float):
        self.low, self.high = low, high

    def sample(self, rng: random.Random) -> float:
        return rng.uniform(self.low, self.high)


class LogUniform(Domain):
    def __init__(self, low: float, high: float):
        import math
        self._lo, self._hi = math.log(low), math.log(high)

    def sample(self, rng: random.Random) -> float:
        import math
        return math.exp(rng.uniform(self._lo, self._hi))


class RandInt(Domain):
    def __init__(self, low: int, high: int):
        self.low, self.high = low, high

    def sample(self, rng: random.Random) -> int:
        return rng.randrange(self.low, self.high)


class GridSearch:
    def __init__(self, values: List[Any]):
        self.values = list(values)


# -- public space constructors (reference tune.grid_search/choice/...) ----

def grid_search(values: List[Any]) -> GridSearch:
    return GridSearch(values)


def choice(categories: List[Any]) -> Choice:
    return Choice(categories)


def uniform(low: float, high: float) -> Uniform:
    return Uniform(low, high)


def loguniform(low: float, high: float) -> LogUniform:
    return LogUniform(low, high)


def randint(low: int, high: int) -> RandInt:
    return RandInt(low, high)


class BasicVariantGenerator:
    """Cross product of grid_search entries × num_samples random draws of
    Domain entries (reference search/basic_variant.py)."""

    def __init__(self, param_space: Dict[str, Any], num_samples: int = 1,
                 seed: Optional[int] = None):
        self.param_space = dict(param_space)
        self.num_samples = num_samples
        self._rng = random.Random(seed)

    def variants(self) -> Iterator[Dict[str, Any]]:
        grid_keys = [k for k, v in self.param_space.items()
                     if isinstance(v, GridSearch)]
        grid_values = [self.param_space[k].values for k in grid_keys]
        has_domains = any(isinstance(v, Domain)
                          for v in self.param_space.values())
        repeats = self.num_samples if (has_domains or not grid_keys) else 1
        for _ in range(repeats):
            for combo in itertools.product(*grid_values) if grid_keys \
                    else [()]:
                cfg: Dict[str, Any] = {}
                for k, v in self.param_space.items():
                    if isinstance(v, GridSearch):
                        cfg[k] = combo[grid_keys.index(k)]
                    elif isinstance(v, Domain):
                        cfg[k] = v.sample(self._rng)
                    else:
                        cfg[k] = v
                yield cfg


# -- Searcher interface (reference tune/search/searcher.py) ---------------

class Searcher:
    """Sequential search algorithm: the controller asks for one config
    per new trial and reports results back (reference Searcher ABC —
    the adapter surface optuna/hyperopt integrations plug into)."""

    def __init__(self, metric: str = "score", mode: str = "max"):
        assert mode in ("max", "min")
        self.metric = metric
        self.mode = mode

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]] = None,
                          error: bool = False) -> None:
        pass

    def save(self) -> Dict[str, Any]:
        return {}

    def restore(self, state: Dict[str, Any]) -> None:
        pass


class TPESearcher(Searcher):
    """Tree-structured Parzen Estimator over Domain spaces — in-tree
    Bayesian-style search with no external dependency (the reference
    delegates to optuna/hyperopt behind the same Searcher interface).

    Per key (independence assumption, as in TPE): observations split
    into the top `gamma` fraction ("good") and the rest; numeric
    domains draw candidates from a Parzen (gaussian-kernel) density
    over good values and keep the candidate maximizing the good/bad
    density ratio; categorical domains sample from smoothed good
    counts. Below `n_initial` observations it falls back to random
    sampling.
    """

    def __init__(self, param_space: Dict[str, Any], metric: str,
                 mode: str = "max", *, n_initial: int = 5,
                 gamma: float = 0.25, n_candidates: int = 24,
                 seed: Optional[int] = None):
        super().__init__(metric, mode)
        if any(isinstance(v, GridSearch) for v in param_space.values()):
            raise ValueError("TPESearcher does not support grid_search "
                             "entries; use BasicVariantGenerator")
        self.param_space = dict(param_space)
        self.n_initial = n_initial
        self.gamma = gamma
        self.n_candidates = n_candidates
        self._rng = random.Random(seed)
        self._live: Dict[str, Dict[str, Any]] = {}
        self._obs: List[Any] = []  # (config, score)

    # numeric transform: LogUniform works in log space
    def _to_x(self, key: str, v: float) -> float:
        import math
        return math.log(v) if isinstance(self.param_space[key],
                                         LogUniform) else float(v)

    def _from_x(self, key: str, x: float) -> Any:
        import math
        dom = self.param_space[key]
        if isinstance(dom, LogUniform):
            return float(min(max(math.exp(x), math.exp(dom._lo)),
                             math.exp(dom._hi)))
        if isinstance(dom, RandInt):
            return int(min(max(round(x), dom.low), dom.high - 1))
        return float(min(max(x, dom.low), dom.high))

    def _random_config(self) -> Dict[str, Any]:
        return {k: (v.sample(self._rng) if isinstance(v, Domain) else v)
                for k, v in self.param_space.items()}

    def suggest(self, trial_id: str) -> Dict[str, Any]:
        if len(self._obs) < self.n_initial:
            cfg = self._random_config()
            self._live[trial_id] = cfg
            return dict(cfg)
        sign = 1.0 if self.mode == "max" else -1.0
        ranked = sorted(self._obs, key=lambda o: sign * o[1],
                        reverse=True)
        n_good = max(1, int(len(ranked) * self.gamma))
        good = [o[0] for o in ranked[:n_good]]
        bad = [o[0] for o in ranked[n_good:]] or good
        cfg: Dict[str, Any] = {}
        for k, dom in self.param_space.items():
            if isinstance(dom, Choice):
                counts = {c: 1.0 for c in dom.categories}
                for g in good:
                    counts[g[k]] = counts.get(g[k], 1.0) + 1.0
                total = sum(counts.values())
                r = self._rng.random() * total
                acc = 0.0
                for c, w in counts.items():
                    acc += w
                    if r <= acc:
                        cfg[k] = c
                        break
            elif isinstance(dom, Domain):
                import math
                gx = [self._to_x(k, g[k]) for g in good]
                bx = [self._to_x(k, b[k]) for b in bad]
                spread = (max(gx + bx) - min(gx + bx)) or 1.0
                bw = max(spread / max(3, len(gx)) * 2.0, 1e-6)

                def density(x, pts, bw=bw):
                    return sum(math.exp(-0.5 * ((x - p) / bw) ** 2)
                               for p in pts) / (len(pts) * bw) + 1e-12

                best_x, best_score = None, -1.0
                for _ in range(self.n_candidates):
                    seed_pt = self._rng.choice(gx)
                    x = self._rng.gauss(seed_pt, bw)
                    score = density(x, gx) / density(x, bx)
                    if score > best_score:
                        best_x, best_score = x, score
                cfg[k] = self._from_x(k, best_x)
            else:
                cfg[k] = dom
        self._live[trial_id] = cfg
        return dict(cfg)

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]] = None,
                          error: bool = False) -> None:
        cfg = self._live.pop(trial_id, None)
        if cfg is None or error or not result or \
                self.metric not in result:
            return
        self._obs.append((cfg, float(result[self.metric])))

    def save(self) -> Dict[str, Any]:
        return {"obs": list(self._obs)}

    def restore(self, state: Dict[str, Any]) -> None:
        self._obs = list(state.get("obs", []))


class OptunaSearcher(Searcher):
    """Adapter for optuna's TPE/CMA samplers behind the same Searcher
    interface (reference tune/search/optuna). Importable without
    optuna; constructing it without the package raises with guidance
    (the interface is the parity surface — environments with optuna
    plug it in unchanged)."""

    def __init__(self, param_space: Dict[str, Any], metric: str,
                 mode: str = "max", **optuna_kwargs: Any):
        super().__init__(metric, mode)
        try:
            import optuna
        except ImportError as e:
            raise ImportError(
                "OptunaSearcher requires the 'optuna' package; use "
                "TPESearcher for the in-tree equivalent") from e
        direction = "maximize" if mode == "max" else "minimize"
        self._study = optuna.create_study(direction=direction,
                                          **optuna_kwargs)
        self.param_space = dict(param_space)
        self._trials: Dict[str, Any] = {}

    def suggest(self, trial_id: str) -> Dict[str, Any]:
        t = self._study.ask()
        cfg: Dict[str, Any] = {}
        for k, dom in self.param_space.items():
            if isinstance(dom, Choice):
                cfg[k] = t.suggest_categorical(k, dom.categories)
            elif isinstance(dom, LogUniform):
                import math
                cfg[k] = t.suggest_float(k, math.exp(dom._lo),
                                         math.exp(dom._hi), log=True)
            elif isinstance(dom, RandInt):
                cfg[k] = t.suggest_int(k, dom.low, dom.high - 1)
            elif isinstance(dom, Uniform):
                cfg[k] = t.suggest_float(k, dom.low, dom.high)
            else:
                cfg[k] = dom
        self._trials[trial_id] = t
        return cfg

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]] = None,
                          error: bool = False) -> None:
        t = self._trials.pop(trial_id, None)
        if t is None:
            return
        if error or not result or self.metric not in result:
            import optuna
            self._study.tell(t, state=optuna.trial.TrialState.FAIL)
            return
        self._study.tell(t, float(result[self.metric]))
