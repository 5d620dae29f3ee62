"""Runnable end-to-end scripts on the port, one counterpart for each of
the JAX package's examples/ (README.md lists them). Each runs as
``python -m ray_tpu_torch.examples.<name>``; its main() takes keyword
arguments for depth and, where a learner or a model runs, its device."""
