"""Training stall attribution from a merged `--spans` Chrome trace.

Consumes the JSON that `ray_tpu timeline --spans` (or
`ray_tpu_torch.timeline(spans=True)`) writes and attributes the training
loop's wall time into named buckets:

    learner_compute   learner.step / learner.update spans
    device_feed       feed.stage / feed.ship / feed.xfer / feed.unfuse
    rollout_wait      feed.wait (consumer starved: upstream sampling or
                      the learner queue is the bottleneck)
    store_rpc         rpc.* / store.* / cw.* / envelope.*
    idle              window time covered by none of the above

Attribution runs over ONE thread — by default the thread with the most
learner.* span time (the IMPALA learner thread); pass --thread/--process
to pick another. Overlapping spans are resolved by specificity (a
store_rpc span nested inside learner compute counts as store_rpc), so
every wall-clock microsecond lands in exactly one bucket and the bucket
percentages sum to 100. This replaces the hand-derived
feed_xfer_stall_pct numbers in the RL bench with trace-derived ones.

Usage:
    python -m ray_tpu_torch.tools.perf_report TRACE.json [--format=json] \
        [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Tuple

# bucket -> (priority, span-name prefixes); higher priority wins overlap.
# task.run is deliberately NOT bucketed: it is an umbrella covering a
# whole task body (including any nested learner.update), and ranking it
# would let it claim time that belongs to the spans inside it.
BUCKETS: Dict[str, Tuple[int, Tuple[str, ...]]] = {
    # elastic reconfiguration phases (train/elastic.py: detect/drain/
    # checkpoint/reform/reshard/resume) outrank everything: wall time
    # inside a re-form is recovery cost, not compute/transport, even
    # when store/rpc spans nest inside it
    "elastic_reconfig": (5, ("elastic.",)),
    # device→host syncs recorded by the CUDA sentinel inside step
    # regions (util/cuda_sentinel.py): wall time blocked on a forced
    # transfer is stall, not compute, even though the spans nest
    # inside learner.* — so host_sync outranks every work bucket
    "host_sync": (4, ("host_sync.",)),
    "store_rpc": (3, ("rpc.", "store.", "cw.", "envelope.")),
    "device_feed": (2, ("feed.stage", "feed.ship", "feed.xfer",
                        "feed.unfuse")),
    "rollout_wait": (1, ("feed.wait", "runner.sample")),
    "learner_compute": (0, ("learner.",)),
}


def _bucket_of(name: str) -> Optional[str]:
    for bucket, (_prio, prefixes) in BUCKETS.items():
        if name.startswith(prefixes):
            return bucket
    return None


def _union(intervals: List[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    if not intervals:
        return []
    intervals = sorted(intervals)
    out = [list(intervals[0])]
    for a, b in intervals[1:]:
        if a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _subtract(base: List[Tuple[float, float]],
              cut: List[Tuple[float, float]]
              ) -> List[Tuple[float, float]]:
    """base minus cut (both interval unions)."""
    out: List[Tuple[float, float]] = []
    for a, b in base:
        cur = a
        for c, d in cut:
            if d <= cur or c >= b:
                continue
            if c > cur:
                out.append((cur, min(c, b)))
            cur = max(cur, d)
            if cur >= b:
                break
        if cur < b:
            out.append((cur, b))
    return out


def _length(intervals: List[Tuple[float, float]]) -> float:
    return sum(b - a for a, b in intervals)


def pick_thread(events: List[Dict[str, Any]],
                process: Optional[str] = None,
                thread: Optional[str] = None) -> Tuple[Any, Any]:
    """(pid, tid) to attribute: the thread with the most learner.* span
    time, else the thread with the most span time overall."""
    learner_time: Dict[Tuple[Any, Any], float] = {}
    span_time: Dict[Tuple[Any, Any], float] = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "span":
            continue
        if process is not None and str(e.get("pid")) != process:
            continue
        if thread is not None and str(e.get("tid")) != thread:
            continue
        key = (e.get("pid"), e.get("tid"))
        dur = float(e.get("dur", 0.0))
        span_time[key] = span_time.get(key, 0.0) + dur
        if str(e.get("name", "")).startswith("learner."):
            learner_time[key] = learner_time.get(key, 0.0) + dur
    pool = learner_time or span_time
    if not pool:
        raise SystemExit("no span events in trace (was it exported "
                         "with --spans / spans=True?)")
    return max(pool, key=pool.get)


def attribute(events: List[Dict[str, Any]],
              process: Optional[str] = None,
              thread: Optional[str] = None) -> Dict[str, Any]:
    pid, tid = pick_thread(events, process, thread)
    per_bucket: Dict[str, List[Tuple[float, float]]] = {
        b: [] for b in BUCKETS}
    t_min, t_max = None, None
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "span":
            continue
        if (e.get("pid"), e.get("tid")) != (pid, tid):
            continue
        t0 = float(e["ts"]) / 1e6
        t1 = t0 + float(e.get("dur", 0.0)) / 1e6
        t_min = t0 if t_min is None else min(t_min, t0)
        t_max = t1 if t_max is None else max(t_max, t1)
        bucket = _bucket_of(str(e.get("name", "")))
        if bucket is not None:
            per_bucket[bucket].append((t0, t1))
    window = (t_max - t_min) if t_min is not None else 0.0
    # resolve overlap by priority: each instant lands in exactly one
    # bucket (the most specific span covering it)
    unions = {b: _union(iv) for b, iv in per_bucket.items()}
    exclusive: Dict[str, List[Tuple[float, float]]] = {}
    by_prio = sorted(BUCKETS, key=lambda b: -BUCKETS[b][0])
    claimed: List[Tuple[float, float]] = []
    for b in by_prio:
        exclusive[b] = _subtract(unions[b], claimed)
        claimed = _union(claimed + unions[b])
    seconds = {b: _length(iv) for b, iv in exclusive.items()}
    attributed = sum(seconds.values())
    seconds["idle"] = max(0.0, window - attributed)
    report = {
        "process": str(pid),
        "thread": str(tid),
        "window_s": round(window, 6),
        "buckets": {
            b: {"seconds": round(s, 6),
                "pct": round(100.0 * s / window, 2) if window else 0.0}
            for b, s in seconds.items()},
        # share of the window covered by SOME span (idle excluded):
        # the flight recorder's coverage of this thread's time
        "attributed_pct": round(100.0 * attributed / window, 2)
        if window else 0.0,
    }
    report["goodput"] = goodput_view(report)
    return report


# trace bucket -> goodput ledger bucket (_private/goodput.py). The two
# accountings observe the same loop from different vantages — the trace
# from span coverage of the learner thread, the ledger from its own
# wall-clock classifier — so on a chaos-free run they must agree within
# tolerance (tests/test_goodput.py keeps that as a standing check).
# Compute spans all map to productive_step: from the ledger's vantage
# the gang is stepping whether the step-internal microsecond went to
# XLA, the feed pipeline, or a store RPC.
GOODPUT_MAP: Dict[str, str] = {
    "learner_compute": "productive_step",
    "device_feed": "productive_step",
    "store_rpc": "productive_step",
    "host_sync": "productive_step",
    "rollout_wait": "feed_stall",
    "elastic_reconfig": "elastic_reconfig",
    "idle": "idle",
}


def goodput_view(report: Dict[str, Any]) -> Dict[str, Any]:
    """Project the trace attribution into the goodput ledger's bucket
    taxonomy so the two can be reconciled (see README "Goodput &
    metrics history")."""
    buckets: Dict[str, float] = {}
    for b, rec in report["buckets"].items():
        gb = GOODPUT_MAP.get(b, "idle")
        buckets[gb] = buckets.get(gb, 0.0) + rec["seconds"]
    window = report.get("window_s") or 0.0
    productive = buckets.get("productive_step", 0.0)
    return {
        "window_s": window,
        "buckets": {b: round(s, 6) for b, s in sorted(buckets.items())},
        "productive_frac": round(productive / window, 4)
        if window else None,
    }


def format_text(report: Dict[str, Any]) -> str:
    lines = [f"perf report — process {report['process']} "
             f"thread {report['thread']}",
             f"window: {report['window_s'] * 1e3:.1f} ms"]
    for b, rec in sorted(report["buckets"].items(),
                         key=lambda kv: -kv[1]["seconds"]):
        lines.append(f"  {b:<16} {rec['seconds'] * 1e3:10.1f} ms "
                     f"{rec['pct']:6.2f}%")
    lines.append(f"  attributed: {report['attributed_pct']:.2f}% "
                 f"(idle = {report['buckets']['idle']['pct']:.2f}%)")
    gp = report.get("goodput")
    if gp and gp.get("productive_frac") is not None:
        lines.append("  goodput: productive "
                     f"{100 * gp['productive_frac']:.1f}% of window "
                     "(ledger taxonomy; `ray_tpu goodput` compares)")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trace", help="Chrome-trace JSON from "
                                  "`ray_tpu timeline --spans`")
    ap.add_argument("--process", default=None,
                    help="restrict to one process row (pid label)")
    ap.add_argument("--thread", default=None,
                    help="restrict to one thread id")
    ap.add_argument("--format", choices=["text", "json"], default="text")
    ap.add_argument("--out", default=None, help="write JSON report here")
    args = ap.parse_args(argv)

    with open(args.trace) as f:
        events = json.load(f)
    report = attribute(events, process=args.process, thread=args.thread)
    if args.format == "json":
        print(json.dumps(report, indent=1))
    else:
        print(format_text(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
