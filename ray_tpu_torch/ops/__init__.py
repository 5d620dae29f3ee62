"""ray_tpu_torch.ops: compute primitives of the port.

Attention ops used by the model, and the hand-written CUDA kernels for
Hopper (sm_90a) that replace the JAX package's Pallas TPU kernels
(ops/flash_attention.py, sources in ops/csrc/), each with a plain PyTorch
version beside it that runs on the CPU.
"""

from ray_tpu_torch.ops.attention import dense_attention  # noqa: F401

__all__ = ["dense_attention"]
