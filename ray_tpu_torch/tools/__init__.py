"""The port's operator and measurement tools (the JAX package's live
under tools/): `python -m ray_tpu_torch.tools.<name>` for chaos_sweep,
fuzz_ownership, lint and perf_report, and the benchmarks bench_core
(the core runtime's tasks, actor calls, put/get and wait),
transport_bench (object transport), bench_replay (the replay plane),
bench_serve (Serve under load), bench_rl (PPO and IMPALA with their
learners on the card) and bench_ablate (the GPT-2 train step's
variants on the card)."""
