"""ray_tpu_torch: the PyTorch and CUDA port of ray_tpu for NVIDIA Hopper.

The JAX package ``ray_tpu`` is the reference; this package does the same
work with PyTorch on an H100, and its one Pallas kernel family (flash
attention: forward, dK/dV, dQ) is hand-written CUDA C++ for sm_90a. It
imports torch, numpy and the standard library, never jax or ray_tpu.

Ported so far: the flagship decoder's single-device training step
(models/, ops/, parallel/train_step.py). Entry points run on the card
unless the caller names another device (``device="cpu"``), and raise when
there is no CUDA.
"""

__version__ = "0.1.0"
