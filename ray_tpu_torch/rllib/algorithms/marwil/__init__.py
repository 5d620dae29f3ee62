from ray_tpu_torch.rllib.algorithms.marwil.marwil import (BC, MARWIL, BCConfig,
                                                    MARWILConfig,
                                                    MARWILLearner)

__all__ = ["MARWIL", "MARWILConfig", "BC", "BCConfig", "MARWILLearner"]
