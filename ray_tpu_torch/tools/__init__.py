"""The port's operator tools (the JAX package's live under tools/):
`python -m ray_tpu_torch.tools.<name>` for chaos_sweep, fuzz_ownership,
lint and perf_report."""
