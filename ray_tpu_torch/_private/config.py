"""Runtime config flags, overridable via RAY_TPU_<NAME> env vars.

reference parity: src/ray/common/ray_config_def.h — a single X-macro list of
RAY_CONFIG(type, name, default) entries, each overridable by env var. Same
idea here with a plain registry.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict

_REGISTRY: Dict[str, Any] = {}


def _define(name: str, default: Any, cast: Callable[[str], Any]) -> Any:
    env = os.environ.get(f"RAY_TPU_{name}")
    value = cast(env) if env is not None else default
    _REGISTRY[name] = value
    return value


def _bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes")


class Config:
    # Object store
    object_store_capacity_bytes = _define(
        "object_store_capacity_bytes", 4 << 30, int)
    # Below this size task returns / puts are inlined into the owner's
    # in-process memory store (reference: max_direct_call_object_size 100KB).
    max_inline_object_size = _define("max_inline_object_size", 100 * 1024, int)
    # Worker pool
    max_workers_per_node = _define("max_workers_per_node", 32, int)
    worker_register_timeout_s = _define("worker_register_timeout_s", 60.0, float)
    idle_worker_kill_timeout_s = _define("idle_worker_kill_timeout_s", 300.0, float)
    # keep this many idle workers warm regardless of the timeout
    # (reference worker_pool soft limit ~ num_cpus)
    idle_worker_pool_floor = _define("idle_worker_pool_floor", 2, int)
    # Scheduling
    lease_request_timeout_s = _define("lease_request_timeout_s", 120.0, float)
    resource_report_period_s = _define("resource_report_period_s", 0.5, float)
    # Health (reference gcs_health_check_manager.h): probe period and the
    # number of CONSECUTIVE failed probes before a node is declared dead —
    # one chaos-delayed or GC-paused probe must never kill a healthy node.
    health_check_period_s = _define("health_check_period_s", 2.0, float)
    health_check_failure_threshold = _define(
        "health_check_failure_threshold", 3, int)
    # Task retries (reference: default max_retries=3 for tasks)
    default_task_max_retries = _define("default_task_max_retries", 3, int)
    # DEPRECATED (compat shim): random RPC handler delays up to this many
    # micros (reference RAY_testing_asio_delay_us, asio_chaos.cc). Now a
    # startup-installed `delay` rule in the chaos plane — use
    # ray_tpu_torch.chaos.inject("delay", delay_ms=..., jitter=True, seed=...)
    # instead; see _private/chaos.py.
    testing_rpc_delay_us = _define("testing_rpc_delay_us", 0, int)
    # OOM defense (reference memory_usage_threshold, ray_config_def.h:77)
    memory_usage_threshold = _define("memory_usage_threshold", 0.95, float)
    memory_monitor_refresh_ms = _define("memory_monitor_refresh_ms",
                                        1000, int)
    # Cluster metrics plane (_private/metrics_plane.py): GCS harvest
    # cadence (0 disables the sampler; /metrics then harvests on
    # demand), in-memory history depth, and watchdog thresholds. All
    # runtime-tunable via the GCS `metrics_configure` RPC.
    metrics_sample_interval_s = _define(
        "metrics_sample_interval_s", 2.0, float)
    metrics_history_samples = _define("metrics_history_samples", 300, int)
    # Durable tiered history (_private/metrics_history.py): segment
    # directory (empty = derive from the GCS persist path, or stay
    # memory-only without one), total on-disk retention budget split
    # across the raw/30s/5min tiers, and how many buffered samples a
    # tier accumulates before writing one fsync'd segment.
    metrics_history_dir = _define("metrics_history_dir", "", str)
    metrics_history_retention_bytes = _define(
        "metrics_history_retention_bytes", 32 << 20, int)
    metrics_history_segment_samples = _define(
        "metrics_history_segment_samples", 32, int)
    # Goodput ledger (_private/goodput.py): the `goodput_regression`
    # probe alerts when a job's productive_step fraction of its
    # accounted wall time over the sliding window drops below the
    # floor, naming the dominant badput bucket. Both
    # metrics_configure-tunable at runtime.
    watchdog_goodput_floor = _define(
        "watchdog_goodput_floor", 0.5, float)
    watchdog_goodput_window_s = _define(
        "watchdog_goodput_window_s", 120.0, float)
    watchdog_cooldown_s = _define("watchdog_cooldown_s", 30.0, float)
    watchdog_wait_edge_age_s = _define(
        "watchdog_wait_edge_age_s", 120.0, float)
    watchdog_store_occupancy_frac = _define(
        "watchdog_store_occupancy_frac", 0.95, float)
    watchdog_queue_depth = _define("watchdog_queue_depth", 256, int)
    # Lockdep plane (ray_tpu/util/locks.py): the watchdog's
    # long-hold-with-waiters probe alerts when a traced lock has been
    # held longer than this while at least this many threads queue.
    watchdog_lock_hold_s = _define("watchdog_lock_hold_s", 5.0, float)
    watchdog_lock_waiters = _define("watchdog_lock_waiters", 1, int)
    # Serve request telemetry (serve/_telemetry.py): per-request handle
    # wait bound at the ingress proxies (timeouts surface as 504 /
    # DEADLINE_EXCEEDED), and the SLO watchdog probes over the
    # harvested RED metrics — p99 latency threshold (computed from
    # per-harvest histogram deltas) and error-rate threshold (5xx
    # fraction of the per-harvest request delta). Runtime-tunable via
    # the GCS `metrics_configure` RPC.
    serve_request_timeout_s = _define(
        "serve_request_timeout_s", 120.0, float)
    watchdog_serve_p99_s = _define("watchdog_serve_p99_s", 2.0, float)
    watchdog_serve_error_rate = _define(
        "watchdog_serve_error_rate", 0.1, float)
    # Serve ingress fleet (serve/_private/proxy_fleet/): admission
    # control + load shedding at the per-node asyncio proxies. A
    # deployment admits up to replicas x max_concurrent_queries
    # in-flight requests plus this many queued beyond capacity before
    # shedding (503 + Retry-After / RESOURCE_EXHAUSTED); -1 on the
    # deployment means "use this default". Rate limit is a per-proxy
    # per-deployment token bucket in requests/s (0 = unlimited).
    serve_max_queued_per_deployment = _define(
        "serve_max_queued_per_deployment", 128, int)
    serve_rate_limit_rps = _define("serve_rate_limit_rps", 0.0, float)
    # Retry-After seconds advertised on shed responses.
    serve_shed_retry_after_s = _define(
        "serve_shed_retry_after_s", 1.0, float)
    # Proxy drain: max wait for in-flight requests to finish before a
    # draining proxy gives up and reports itself drained anyway.
    serve_drain_timeout_s = _define("serve_drain_timeout_s", 30.0, float)
    # Proxy-side request coalescing into @serve.batch deployments: max
    # requests fused into one replica submit, and how long the first
    # request in a forming batch waits for stragglers.
    serve_coalesce_max_batch = _define("serve_coalesce_max_batch", 32, int)
    serve_coalesce_wait_s = _define("serve_coalesce_wait_s", 0.002, float)
    # SLO watchdog: shed fraction of a harvest window's admitted+shed
    # request delta above this sustains a `serve_shed_burn` alert.
    watchdog_serve_shed_rate = _define(
        "watchdog_serve_shed_rate", 0.5, float)
    # Elastic training plane (train/elastic.py): an in-flight gang
    # reconfiguration older than this raises `elastic_stuck_reconfig` —
    # a gang that can neither re-form nor fail looks exactly like
    # training, minus the progress. Size it past the WORST legitimate
    # reconfiguration, not the typical one: a learner gang stepping
    # down from target to min can spend elastic_reform_timeout_s
    # (default 60s) PER attempted world size, and a large-model
    # reshard adds its state-transfer time on top — raise this (it is
    # metrics_configure-tunable at runtime) for wide target-min gaps
    # rather than treating a slow-but-progressing recovery as stuck.
    watchdog_elastic_reconfig_s = _define(
        "watchdog_elastic_reconfig_s", 120.0, float)
    # Gang heartbeat plane (train/heartbeat.py): a rank whose
    # ray_tpu_gang_heartbeat_age_seconds exceeds this raises
    # `gang_rank_wedged` — the sidecar beats every ~0.5s even while the
    # main thread sits inside a collective, so ~20 missed beats means
    # the PROCESS is stopped (SIGSTOP, hard GIL stall), not merely a
    # slow step. The gang supervisor uses the same threshold as the
    # second factor of its wedge trip (step deadline expired AND a
    # heartbeat this stale). metrics_configure-tunable at runtime.
    watchdog_gang_heartbeat_s = _define(
        "watchdog_gang_heartbeat_s", 10.0, float)
    # JAX sentinel probes (util/jax_sentinel.py; static twins are
    # graftlint RT020/RT021): a step-region label whose kind=recompile
    # counter grows by >= watchdog_jit_recompiles within one harvest
    # window — after the label's first compile is older than the warmup
    # grace — raises `jit_recompile_storm`; host-transfer bytes
    # accounted INSIDE a step region growing by >=
    # watchdog_host_transfer_bytes per window raise
    # `unexpected_host_transfer` (hot steps sync at sanctioned forcing
    # points outside their jitted bodies). All three are
    # metrics_configure-tunable at runtime.
    watchdog_jit_recompiles = _define("watchdog_jit_recompiles", 3, int)
    watchdog_jit_recompile_warmup_s = _define(
        "watchdog_jit_recompile_warmup_s", 60.0, float)
    watchdog_host_transfer_bytes = _define(
        "watchdog_host_transfer_bytes", float(1 << 20), float)
    # Debug plane (_private/log_plane.py + log_monitor.py): per-worker
    # in-memory tail index depth, driver-stream flood control (per-source
    # token bucket), and crash-postmortem bundle sizes.
    log_tail_lines = _define("log_tail_lines", 2000, int)
    log_stream_rate_lps = _define("log_stream_rate_lps", 500.0, float)
    log_stream_burst = _define("log_stream_burst", 1000, int)
    postmortem_log_lines = _define("postmortem_log_lines", 100, int)
    postmortem_span_tail = _define("postmortem_span_tail", 200, int)
    postmortems_max = _define("postmortems_max", 256, int)
    # Task-path batching (ROADMAP item 1): coalesce per-key lease
    # requests into multi-grant nm_lease_request_batch RPCs, and batch
    # cw_task_done reports off the worker's report drainer (many
    # completions -> one flush-coalesced write). Both default on; the
    # flags exist for the measured ablation (tools/bench_ablate.py
    # --suite lease) and as kill switches.
    task_lease_batching = _define("task_lease_batching", True, _bool)
    task_done_batching = _define("task_done_batching", True, _bool)
    # Same-node shm fast path: a task pushed to a worker on the owner's
    # node rides an mmap'd SPSC byte-ring (_private/shm_channel.py)
    # instead of the loopback socket, with a doorbell one-way only when
    # the consumer ring is parked. Rings live next to the native store
    # arena; silently degrades to RPC without one. Geometry: payload
    # bytes per directed (producer -> consumer) ring.
    shm_task_channel = _define("shm_task_channel", True, _bool)
    shm_ring_bytes = _define("shm_ring_bytes", 1 << 20, int)
    # Spec-blob interning: owner-side LRU of hash-dedup'd pickled
    # function/arg blobs so 250k queued copies of the same closure cost
    # one blob, not 250k (scale envelope, ROADMAP item 1).
    spec_blob_cache_entries = _define("spec_blob_cache_entries", 256, int)
    # Transit pins on ObjectRefs embedded in task results: fallback TTL
    # used only when the owner's ack never arrives (the normal path
    # releases on ack — see _Executor._report_done).
    transit_pin_ttl_s = _define("transit_pin_ttl_s", 30.0, float)
    # Profiling plane (_private/profiler.py): default sampling rate for
    # `ray_tpu profile` and the cap on DISTINCT folded stacks one
    # sampler session aggregates (beyond it samples are counted into
    # the drop counter, never allocated — memory stays O(cap), not
    # O(duration)).
    profile_default_hz = _define("profile_default_hz", 100.0, float)
    profile_max_stacks = _define("profile_max_stacks", 2000, int)
    # Memory attribution plane (_private/memory_plane.py): per-snapshot
    # object cap for the full `ray_tpu memory` gather and the (smaller)
    # digest cap riding every metrics harvest. Callsite capture records
    # the put()/.remote() source line that created each owned object —
    # one stack walk per object creation (~a few µs), so it is opt-in.
    memory_callsite_capture = _define(
        "memory_callsite_capture", False, _bool)
    memory_snapshot_max_objects = _define(
        "memory_snapshot_max_objects", 4096, int)
    memory_digest_max_objects = _define(
        "memory_digest_max_objects", 512, int)


if Config.testing_rpc_delay_us:
    import warnings

    warnings.warn(
        "RAY_TPU_testing_rpc_delay_us/_seed are deprecated; use the chaos "
        "plane (ray_tpu_torch.chaos.inject('delay', delay_ms=..., jitter=True, "
        "seed=...)) instead", DeprecationWarning, stacklevel=2)


def get(name: str) -> Any:
    return _REGISTRY[name]
