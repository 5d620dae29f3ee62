"""ray_tpu_torch.tune: trial-based experiment execution (Tune equivalent).

reference parity: python/ray/tune — Tuner/TuneController over the
Trainable step/save/restore contract, grid+random search, ASHA scheduler,
per-trial failure retry from checkpoint.
"""

from ray_tpu_torch.tune.schedulers import (ASHAScheduler, FIFOScheduler,  # noqa: F401
                                     MedianStoppingRule,
                                     PopulationBasedTraining)
from ray_tpu_torch.tune.search import (OptunaSearcher, Searcher,  # noqa: F401
                                 TPESearcher)
from ray_tpu_torch.tune.search import (choice, grid_search, loguniform,  # noqa: F401
                                 randint, uniform)
from ray_tpu_torch.tune.trainable import (FunctionTrainable, Trainable,  # noqa: F401
                                    report, wrap_function)
from ray_tpu_torch.tune.tuner import (ResultGrid, TrialResult, TuneConfig,  # noqa: F401
                                TuneRunConfig, Tuner)

__all__ = [
    "Tuner", "TuneConfig", "TuneRunConfig", "ResultGrid", "TrialResult",
    "Trainable", "FunctionTrainable", "wrap_function", "report",
    "grid_search", "choice", "uniform", "loguniform", "randint",
    "ASHAScheduler", "FIFOScheduler", "MedianStoppingRule",
    "PopulationBasedTraining",
]

from ray_tpu_torch._private.usage import record_library_usage as _rlu
_rlu('tune')
del _rlu
