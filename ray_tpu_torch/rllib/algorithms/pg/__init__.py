from ray_tpu_torch.rllib.algorithms.pg.pg import PG, PGConfig, PGLearner

__all__ = ["PG", "PGConfig", "PGLearner"]
