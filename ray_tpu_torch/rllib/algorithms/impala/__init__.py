from ray_tpu_torch.rllib.algorithms.impala.impala import (Impala, ImpalaConfig,  # noqa: F401
                                                    ImpalaLearner)
from ray_tpu_torch.rllib.algorithms.impala.vtrace import from_importance_weights  # noqa: F401
