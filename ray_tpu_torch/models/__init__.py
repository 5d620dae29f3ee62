"""ray_tpu_torch.models: the port's model zoo (counterpart of
ray_tpu.models): the flagship decoder-only transformer and its configs."""

from ray_tpu_torch.models.configs import (GPT2_125M, LLAMA2_7B, TINY,  # noqa: F401
                                          TransformerConfig)
from ray_tpu_torch.models.transformer import Transformer  # noqa: F401

__all__ = [
    "TransformerConfig", "Transformer", "TINY", "GPT2_125M", "LLAMA2_7B",
]
