"""The port's operator tools (the JAX package's live under tools/):
`python -m ray_tpu_torch.tools.chaos_sweep`."""
