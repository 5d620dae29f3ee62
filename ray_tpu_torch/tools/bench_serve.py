"""Serve load harness: closed/open-loop multi-worker bench + brownout.

reference parity: the reference's serve release suite (proxy/handle
throughput tests + overload tests). Three stages:

  1. **handle path** — pipelined DeploymentHandle client (window 32),
     the r07 baseline methodology: the ceiling the proxy must reach.
  2. **HTTP proxy, closed loop** — N worker threads, each with ONE
     persistent keep-alive connection, next request issued when the
     previous answers; swept over a concurrency ladder. Runs against a
     @serve.batch echo so proxy-side coalescing fuses single requests
     into batched replica submits (the asyncio fleet's headline path).
  3. **brownout (open loop)** — offered load = factor x measured
     saturation against a bounded-capacity deployment with admission
     limits; a pacer thread releases request tokens at the offered
     rate, workers fire them. Records goodput, shed rate, and the p99
     of ADMITTED requests at 1x/3x/10x — shed-don't-collapse is the
     acceptance shape (goodput >= ~70% of saturation at 10x, shed
     requests answered fast with 503 + Retry-After).

    python -m ray_tpu_torch.tools.bench_serve [--seconds 8] [--out FILE]
        [--format json|text] [--sweep 4,16,32] [--overload 1,3,10]
        [--workers 48] [--skip-brownout]
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import queue
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def _percentiles(samples, points=(50, 95, 99)):
    if not samples:
        return {f"p{p}": None for p in points}
    s = sorted(samples)
    out = {}
    for p in points:
        idx = min(len(s) - 1, max(0, round(p / 100.0 * len(s)) - 1))
        out[f"p{p}"] = round(s[idx] * 1e3, 3)  # ms
    return out


class _Worker(threading.Thread):
    """One closed-loop client: a persistent keep-alive connection,
    next request after the previous response. In open-loop mode it
    waits for a token from the pacer before each request."""

    def __init__(self, port: str, dep: str, stop: threading.Event,
                 tokens: "queue.Queue | None" = None):
        super().__init__(daemon=True)
        self.port = port
        self.dep = dep
        self.stop_ev = stop
        self.tokens = tokens
        self.lat_ok = []      # latency of 2xx responses
        self.n_ok = 0
        self.n_shed = 0
        self.n_err = 0
        self.retry_after_seen = 0

    def _connect(self):
        return http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=60)

    def run(self):
        conn = self._connect()
        body = b"1"
        while not self.stop_ev.is_set():
            if self.tokens is not None:
                try:
                    self.tokens.get(timeout=0.2)
                except queue.Empty:
                    continue
            t0 = time.perf_counter()
            try:
                conn.request("POST", f"/{self.dep}", body=body)
                resp = conn.getresponse()
                resp.read()
                if resp.status == 200:
                    self.n_ok += 1
                    self.lat_ok.append(time.perf_counter() - t0)
                elif resp.status == 503:
                    self.n_shed += 1
                    ra = resp.getheader("Retry-After")
                    if ra:
                        self.retry_after_seen += 1
                    if self.tokens is not None:
                        # honor the Retry-After contract (capped at
                        # 500ms so a stage still cycles): a shed
                        # client backs off instead of hammering the
                        # proxy's core with refusal round-trips — the
                        # worker pool stays larger than the admission
                        # window, so backoff never starves the pipe
                        try:
                            time.sleep(min(float(ra or 0.01), 0.5))
                        except ValueError:
                            time.sleep(0.01)
                else:
                    self.n_err += 1
                if resp.getheader("Connection") == "close":
                    conn.close()
                    conn = self._connect()
            except Exception:  # noqa: BLE001 - reconnect and continue
                self.n_err += 1
                try:
                    conn.close()
                except Exception:  # noqa: BLE001
                    pass
                conn = self._connect()
        try:
            conn.close()
        except Exception:  # noqa: BLE001
            pass


def _run_stage(port: int, dep: str, seconds: float, workers: int,
               offered_rps: float = 0.0) -> dict:
    """One load stage. offered_rps > 0 = open loop (paced tokens);
    0 = closed loop (back-to-back)."""
    stop = threading.Event()
    tokens: "queue.Queue | None" = None
    pacer = None
    overflow = [0]
    if offered_rps > 0:
        # bounded token backlog (wrk2-style): once every worker is
        # saturated, further offered requests are counted as overflow
        # instead of churning the token queue — the client fleet can
        # only ATTEMPT what its connections can carry
        tokens = queue.Queue(maxsize=max(64, 4 * workers))

        def pace():
            period = 1.0 / offered_rps
            nxt = time.perf_counter()
            while not stop.is_set():
                now = time.perf_counter()
                due = 0
                while nxt <= now:
                    due += 1
                    nxt += period
                if due:
                    # one capacity check per tick, not one exception
                    # per token — at 10x offered the pacer must stay
                    # cheap or it becomes the bottleneck it offers
                    free = tokens.maxsize - tokens.qsize()
                    for _ in range(min(due, max(0, free))):
                        try:
                            tokens.put_nowait(1)
                        except queue.Full:  # raced a worker: rare
                            overflow[0] += 1
                            break
                    overflow[0] += max(0, due - free)
                time.sleep(min(0.002, max(0.0, nxt - now)))

        pacer = threading.Thread(target=pace, daemon=True)
    ws = [_Worker(port, dep, stop, tokens) for _ in range(workers)]
    t0 = time.perf_counter()
    for w in ws:
        w.start()
    if pacer:
        pacer.start()
    time.sleep(seconds)
    stop.set()
    for w in ws:
        w.join(timeout=30)
    dt = time.perf_counter() - t0
    lat = [x for w in ws for x in w.lat_ok]
    n_ok = sum(w.n_ok for w in ws)
    n_shed = sum(w.n_shed for w in ws)
    n_err = sum(w.n_err for w in ws)
    return {
        "workers": workers,
        "offered_rps": round(offered_rps, 1) if offered_rps else None,
        "goodput_rps": round(n_ok / dt, 1),
        "shed_rps": round(n_shed / dt, 1),
        "requests_ok": n_ok, "requests_shed": n_shed,
        "errors": n_err,
        "client_overflow": overflow[0] or None,
        "retry_after_on_all_sheds":
            (sum(w.retry_after_seen for w in ws) == n_shed),
        "latency_ms_admitted": {
            **_percentiles(lat),
            "mean": round(sum(lat) / max(1, len(lat)) * 1e3, 3)},
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=8.0,
                    help="wall time per load stage")
    ap.add_argument("--out", default=None)
    ap.add_argument("--format", choices=("json", "text"),
                    default="json")
    ap.add_argument("--sweep", default="4,16,32",
                    help="closed-loop concurrency ladder")
    ap.add_argument("--overload", default="1,3,10",
                    help="open-loop offered-load factors")
    ap.add_argument("--workers", type=int, default=40,
                    help="worker pool for open-loop stages")
    ap.add_argument("--skip-brownout", action="store_true")
    args = ap.parse_args()

    import ray_tpu_torch
    from ray_tpu_torch import serve

    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)

    # ---- handle path (r07 baseline methodology) ---------------------
    @serve.deployment(name="bench_echo", num_replicas=2)
    def echo(x=0):
        return x

    handle = serve.run(echo)
    assert ray_tpu_torch.get(handle.remote(1), timeout=60) == 1  # warm
    window = 32
    submit_ts = {}
    lat_handle = []
    refs = []
    for i in range(window):
        r = handle.remote(i)
        submit_ts[r.hex()] = time.perf_counter()
        refs.append(r)
    n = 0
    errors_handle = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        done, refs = ray_tpu_torch.wait(refs, num_returns=1, timeout=10)
        now = time.perf_counter()
        for d in done:
            lat_handle.append(now - submit_ts.pop(d.hex(), now))
            try:
                ray_tpu_torch.get(d, timeout=10)
            except Exception:  # noqa: BLE001 — counted, not fatal: one
                errors_handle += 1  # transient must not abort the run
        n += len(done)
        r = handle.remote(n)
        submit_ts[r.hex()] = time.perf_counter()
        refs.append(r)
    handle_rps = n / (time.perf_counter() - t0)

    # ---- proxy path: coalescing batch echo, closed-loop sweep -------
    @serve.deployment(name="bench_becho", num_replicas=2,
                      max_concurrent_queries=8)
    class BatchEcho:
        @serve.batch(max_batch_size=64, batch_wait_timeout_s=0.002)
        def __call__(self, items):
            return items

    serve.run(BatchEcho)
    proxy = serve.start_http(port=0)
    port = ray_tpu_torch.get(proxy.ready.remote(), timeout=60)
    # warm both the connection path and the routing/coalesce flag
    _run_stage(port, "bench_becho", 1.0, 4)
    sweep = []
    for c in [int(x) for x in args.sweep.split(",") if x]:
        sweep.append(_run_stage(port, "bench_becho", args.seconds, c))
    best = max(sweep, key=lambda s: s["goodput_rps"])
    proxy_rps = best["goodput_rps"]

    result = {
        "suite": "serve_fleet_throughput",
        "seconds_per_stage": args.seconds,
        "note": "asyncio proxy fleet",
        "handle": {
            "requests_per_sec": round(handle_rps, 1),
            "requests": n,
            "errors": errors_handle,
            "latency_ms": {**_percentiles(lat_handle),
                           "mean": round(sum(lat_handle)
                                         / max(1, len(lat_handle))
                                         * 1e3, 3)},
            "note": "pipelined window 32, plain echo x2 replicas",
        },
        "http_proxy": {
            "mode": "closed-loop keep-alive, proxy-coalesced "
                    "@serve.batch echo (max_batch_size=64) x2 replicas",
            "best_requests_per_sec": proxy_rps,
            "best_concurrency": best["workers"],
            "sweep": sweep,
        },
        "acceptance": {
            "proxy_ge_handle": proxy_rps >= handle_rps,
            "proxy_over_handle": round(proxy_rps / handle_rps, 3)
            if handle_rps else None,
        },
    }

    # ---- brownout: offered load vs bounded capacity -----------------
    if not args.skip_brownout:
        # admission limit (2x8 capacity + 16 queued = 32) sits BELOW
        # the worker pool so a 10x overload actually hits it: excess
        # concurrency sheds fast instead of queueing into timeout
        @serve.deployment(name="bench_work", num_replicas=2,
                          max_concurrent_queries=8,
                          max_queued_requests=16)
        def work(x=0):
            time.sleep(0.004)  # bounded service rate
            return x

        serve.run(work)
        _run_stage(port, "bench_work", 1.0, 4)  # warm
        # saturation measured BELOW the admission boundary (16 < 32):
        # the ceiling itself, not the ceiling minus shed churn.
        # PAIRED before/after the overload ladder: this box degrades
        # monotonically under sustained load (ROADMAP Health), so the
        # pre-ladder sample runs on a colder box than the 10x stage —
        # judging brownout against it conflates box drift with
        # shedding losses. The post-ladder sample shares the 10x
        # stage's box state; both are recorded.
        sat_pre = _run_stage(port, "bench_work", args.seconds, 16)
        saturation = sat_pre["goodput_rps"]
        levels = []
        for factor in [float(x) for x in args.overload.split(",") if x]:
            st = _run_stage(port, "bench_work", args.seconds,
                            args.workers,
                            offered_rps=saturation * factor)
            st["factor"] = factor
            levels.append(st)
        sat_post = _run_stage(port, "bench_work", args.seconds, 16)
        # brownout reference = same-box-state saturation (post), never
        # below the best sustained goodput any stage demonstrated
        saturation_ref = max(sat_post["goodput_rps"],
                             *(s["goodput_rps"] for s in levels))
        for st in levels:
            st["goodput_frac_of_saturation"] = round(
                st["goodput_rps"] / saturation_ref, 3) \
                if saturation_ref else None
        at10 = next((s for s in levels if s["factor"] >= 10), None)
        result["brownout"] = {
            "saturation_rps_pre_ladder": saturation,
            "saturation_rps_post_ladder": sat_post["goodput_rps"],
            "saturation_rps": saturation_ref,
            "saturation_latency_ms": sat_pre["latency_ms_admitted"],
            "levels": levels,
            "deployment": "sleep(4ms) echo x2 replicas x8 slots, "
                          "max_queued_requests=16",
            "note": "goodput fractions reference the POST-ladder "
                    "saturation (same box state as the overload "
                    "stages; this 1-core box degrades monotonically "
                    "under sustained load)",
        }
        result["acceptance"]["goodput_frac_at_10x"] = (
            at10["goodput_frac_of_saturation"] if at10 else None)
        result["acceptance"]["sheds_carry_retry_after"] = (
            at10["retry_after_on_all_sheds"] if at10 else None)

    if args.format == "json":
        print(json.dumps(result, indent=1))
    else:
        print(f"handle: {result['handle']['requests_per_sec']}/s  "
              f"proxy(best): {proxy_rps}/s "
              f"@c={best['workers']}")
        for s in result.get("brownout", {}).get("levels", []):
            print(f"  {s['factor']}x offered={s['offered_rps']}/s "
                  f"goodput={s['goodput_rps']}/s "
                  f"shed={s['shed_rps']}/s "
                  f"p99={s['latency_ms_admitted']['p99']}ms")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    serve.shutdown()
    ray_tpu_torch.shutdown()


if __name__ == "__main__":
    main()
