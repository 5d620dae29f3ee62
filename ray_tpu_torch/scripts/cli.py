"""The ray_tpu CLI: `python -m ray_tpu <command>`.

reference parity: python/ray/scripts/scripts.py — start (:548), stop
(:1024), status (:1971), timeline (:1856), memory (:1921),
microbenchmark (:1842), plus `list ...`/`summary` from the state CLI
(util/state/state_cli.py) and `job ...` from dashboard/modules/job/cli.py.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import tempfile
import time
from typing import Any, Dict, List

ADDRESS_ENV = "RAY_TPU_ADDRESS"
# under TMPDIR (/tmp when it is unset), so that heads run with TMPDIRs of
# their own do not share one file
HEAD_INFO_PATH = os.path.join(tempfile.gettempdir(), "ray_tpu_head.json")


def _address(args) -> str:
    addr = getattr(args, "address", None) or os.environ.get(ADDRESS_ENV)
    if not addr and os.path.exists(HEAD_INFO_PATH):
        with open(HEAD_INFO_PATH) as f:
            addr = json.load(f).get("gcs_address")
    if not addr:
        raise SystemExit(
            "no cluster address: pass --address, set RAY_TPU_ADDRESS, or "
            "run `ray_tpu start --head` on this machine first")
    return addr


def _connect(args):
    import ray_tpu_torch
    ray_tpu_torch.init(_address(args), ignore_reinit_error=True)
    return ray_tpu_torch


def _print_table(rows: List[Dict[str, Any]], columns: List[str]) -> None:
    if not rows:
        print("(none)")
        return
    widths = {c: max(len(c), *(len(str(r.get(c, ""))) for r in rows))
              for c in columns}
    header = "  ".join(c.ljust(widths[c]) for c in columns)
    print(header)
    print("-" * len(header))
    for r in rows:
        print("  ".join(str(r.get(c, "")).ljust(widths[c])
                        for c in columns))


# ---- commands --------------------------------------------------------


def cmd_start(args) -> int:
    if args.head:
        from ray_tpu_torch._private.worker import HeadNode
        head = HeadNode(
            num_cpus=args.num_cpus,
            resources=json.loads(args.resources) if args.resources else None)
        info = {
            "gcs_address": f"{head.gcs.address[0]}:{head.gcs.address[1]}",
            "node_manager_address":
                f"{head.node_manager.address[0]}:{head.node_manager.address[1]}",
            "session_dir": head.session_dir,
            "pid": os.getpid(),
        }
        with open(HEAD_INFO_PATH, "w") as f:
            json.dump(info, f)
        print(json.dumps(info))
        print(f"head started; connect with ray_tpu_torch.init("
              f"\"{info['gcs_address']}\")", flush=True)
        if not args.block:
            print("(running until killed; use --block in scripts)")
        stop = []
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda *_: stop.append(1))
        while not stop:
            time.sleep(0.2)
        head.shutdown()
        # the file goes with its head: a later `stop` would signal its
        # pid, which another process may hold by then
        try:
            with open(HEAD_INFO_PATH) as f:
                if json.load(f).get("pid") == info["pid"]:
                    os.unlink(HEAD_INFO_PATH)
        except (OSError, ValueError):
            pass
        return 0
    # joining node: delegate to node_main
    from ray_tpu_torch._private import node_main
    argv = ["--gcs-address", _address(args)]
    if args.resources:
        argv += ["--resources", args.resources]
    return node_main.main(argv)


def cmd_stop(args) -> int:
    import subprocess
    patterns = ["ray_tpu_torch._private.worker_main",
                "ray_tpu_torch._private.node_main",
                "ray_tpu_torch.*start --head"]
    for pat in patterns:
        subprocess.run(["pkill", "-f", pat], check=False)
    if os.path.exists(HEAD_INFO_PATH):
        try:
            with open(HEAD_INFO_PATH) as f:
                pid = json.load(f).get("pid")
            if pid:
                os.kill(pid, signal.SIGTERM)
        except (OSError, ValueError):
            pass
        os.unlink(HEAD_INFO_PATH)
    print("stopped")
    return 0


def cmd_status(args) -> int:
    rt = _connect(args)
    nodes = rt.nodes()
    total = rt.cluster_resources()
    avail = rt.available_resources()
    print(f"nodes: {sum(1 for n in nodes if n['Alive'])} alive / "
          f"{len(nodes)} total")
    for k in sorted(total):
        print(f"  {k}: {avail.get(k, 0.0):g} / {total[k]:g} available")
    return 0


def cmd_list(args) -> int:
    _connect(args)
    from ray_tpu_torch.util import state as s
    kind = args.kind.replace("-", "_")
    if kind in ("task", "tasks"):
        rows = s.list_tasks()
        cols = ["task_id", "name", "state", "type", "node_id"]
        rows = [{**r, "task_id": r.get("task_id", "")[:16],
                 "node_id": (r.get("node_id") or "")[:12]} for r in rows]
    elif kind in ("actor", "actors"):
        rows = s.list_actors()
        cols = ["actor_id", "class_name", "state", "name", "num_restarts"]
        rows = [{**r, "actor_id": r["actor_id"][:16]} for r in rows]
    elif kind in ("node", "nodes"):
        rows = s.list_nodes()
        cols = ["node_id", "state", "is_head", "resources_total"]
        rows = [{**r, "node_id": r["node_id"][:16]} for r in rows]
    elif kind in ("worker", "workers"):
        rows = s.list_workers()
        cols = ["worker_id", "pid", "is_actor", "idle", "current_task"]
        rows = [{**r, "worker_id": r["worker_id"][:16]} for r in rows]
    elif kind in ("object", "objects"):
        listing = s.list_objects()
        rows = listing["objects"]
        cols = ["object_id", "size", "pinned", "spilled", "node_id"]
        rows = [{**r, "object_id": r["object_id"][:20],
                 "node_id": r["node_id"][:12]} for r in rows]
        _warn_unreachable(listing.get("unreachable"))
    elif kind in ("placement_group", "placement_groups"):
        rows = s.list_placement_groups()
        cols = ["placement_group_id", "state", "strategy", "bundles"]
        rows = [{**r, "placement_group_id": r["placement_group_id"][:16]}
                for r in rows]
    else:
        raise SystemExit(f"unknown list kind {args.kind!r}")
    _print_table(rows, cols)
    return 0


def cmd_summary(args) -> int:
    _connect(args)
    from ray_tpu_torch.util import state as s
    for state, count in sorted(s.summarize_tasks().items()):
        print(f"{state}: {count}")
    return 0


def cmd_stack(args) -> int:
    """Live all-thread stack dumps (reference scripts.py:1810 ray
    stack; py-spy equivalent via SIGUSR1 faulthandler)."""
    _connect(args)
    from ray_tpu_torch.util import state as s
    if args.worker_id:
        dumps = [s.profile_worker_stack(args.worker_id)]
    else:
        dumps = s.profile_all_worker_stacks()
    for dump in dumps:
        print(f"== worker {dump['worker_id'][:12]} "
              f"pid={dump.get('pid')} "
              f"node={str(dump.get('node_id', '?'))[:12]}")
        print(dump.get("stack") or dump.get("error")
              or "(no dump captured)")
    return 0


def cmd_timeline(args) -> int:
    rt = _connect(args)
    # --trace-id promises the block's task records AND span records as
    # a standalone trace, so it implies --spans
    spans = args.spans or args.trace_id is not None
    events = rt.timeline(args.output, spans=spans,
                         trace_id=args.trace_id)
    n_spans = sum(1 for e in events if e.get("cat") == "span")
    extra = f" ({n_spans} spans)" if spans else ""
    print(f"wrote {len(events)} events{extra} to {args.output}")
    return 0


def _warn_unreachable(unreachable) -> None:
    if unreachable:
        print(f"(warning: {len(unreachable)} node(s) unreachable — "
              f"results are incomplete: "
              f"{[str(n)[:12] for n in unreachable]})", file=sys.stderr)


def _fmt_bytes(n) -> str:
    n = float(n or 0)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024.0
    return f"{n:.1f}GiB"


def cmd_memory(args) -> int:
    """Owner-attributed memory accounting (see README "Profiling &
    memory attribution"): per-node store stats plus the cluster object
    table — who owns each object, what holds it alive (pins / borrows
    / leases), where bytes are resident — optionally grouped by
    callsite / actor / node / owner."""
    _connect(args)
    from ray_tpu_torch.util import state as s
    table = s.memory_table(group_by=args.group_by, top=args.top,
                           timeout=args.timeout)
    stats = s.object_store_stats()
    if args.format == "json":
        print(json.dumps({**table, "store_stats": stats["stats"],
                          "stats_unreachable": stats["unreachable"]},
                         default=str))
        return 0
    for st in stats["stats"]:
        print(f"node {st['node_id'][:12]}: "
              f"{st['used']}/{st['capacity']} bytes, "
              f"{st['num_objects']} objects, "
              f"spilled {st['num_spilled']}, restored {st['num_restored']}")
    if args.group_by:
        print(f"\n== objects by {args.group_by}")
        _print_table(
            [{**g, "bytes": _fmt_bytes(g["bytes"])}
             for g in table["groups"]],
            [args.group_by, "objects", "bytes", "pinned", "leases",
             "borrower_pins"])
    else:
        rows = table["objects"][:args.top or 20]
        total = table.get("total_objects", len(table["objects"]))
        print(f"\n== top {len(rows)} objects (of {total})")
        _print_table(
            [{"object_id": r["object_id"][:20],
              "size": _fmt_bytes(r.get("size")),
              "owner": (r.get("owner") or "?"),
              "state": r.get("owner_state") or "?",
              "refs": r["local_refs"],
              "pins": sum(int(res.get("pinned") or 0)
                          for res in r["residency"]),
              "borrowers": r["borrowers"],
              "leases": r["replica_leases"],
              "nodes": ",".join(sorted(
                  {str(res["node_id"])[:8] for res in r["residency"]
                   if res.get("node_id")})) or "-",
              "callsite": (r.get("callsite") or "-")[-40:]}
             for r in rows],
            ["object_id", "size", "owner", "state", "refs", "pins",
             "borrowers", "leases", "nodes", "callsite"])
    if table.get("objects_dropped"):
        print(f"({table['objects_dropped']} object record(s) over the "
              f"per-process snapshot cap were dropped)", file=sys.stderr)
    _warn_unreachable(
        list(table.get("unreachable") or [])
        + [n for n in stats["unreachable"]
           if n not in (table.get("unreachable") or [])])
    return 0


def cmd_locks(args) -> int:
    """Runtime lockdep plane (see README "Concurrency analysis"):
    per-process traced-lock stats (holds, hold time, current holder,
    waiters) plus the acquisition-order graph — a cycle means two code
    paths take the same locks in opposite orders and will deadlock
    under the right interleaving."""
    _connect(args)
    from ray_tpu_torch.util import state as s
    out = s.locks(timeout=args.timeout)
    if args.format == "json":
        print(json.dumps(out, default=str))
        return 0
    for snap in out["procs"]:
        locks = snap.get("locks") or []
        edges = snap.get("edges") or []
        if not locks and not snap.get("cycle"):
            continue
        print(f"\n== {snap.get('proc')} (pid {snap.get('pid')})")
        _print_table(
            [{"lock": a["name"], "holds": a["holds"],
              "hold_total_s": f"{a['hold_total_s']:.3f}",
              "waiters": a["waiters"],
              "held_s": (f"{a['held_s']:.3f}" if a["held_now"]
                         else "-"),
              "held_by": ",".join(
                  str(h.get("thread_name") or h.get("thread"))
                  for h in a.get("held_by", ())) or "-"}
             for a in locks],
            ["lock", "holds", "hold_total_s", "waiters", "held_s",
             "held_by"])
        if edges:
            print("order edges: " + "; ".join(
                f"{a}->{b} x{n}" for a, b, n in edges))
        if snap.get("cycle"):
            print("!! ORDER INVERSION: "
                  + " -> ".join(snap["cycle"]))
    _warn_unreachable(list(out.get("unreachable") or []))
    return 0


def cmd_autoscaler(args) -> int:
    """Autoscaler v2 lifecycle plane (see README "Elastic training"):
    the instance table (QUEUED -> REQUESTED -> ALLOCATED ->
    RAY_RUNNING -> TERMINATING -> TERMINATED) and recent lifecycle
    transitions the autoscaler reported to the GCS."""
    _connect(args)
    from ray_tpu_torch.util import state as s
    out = s.autoscaler_instances(limit=args.limit)
    if args.format == "json":
        print(json.dumps(out, default=str))
        return 0
    instances = out.get("instances") or []
    if instances:
        _print_table(
            [{"instance": i["instance_id"], "type": i["node_type"],
              "status": i["status"],
              "node": (i.get("node_id_hex") or "-")[:12],
              "retries": i.get("retries", 0),
              "in_state_s": f"{i.get('age_in_state_s', 0):.0f}"}
             for i in instances],
            ["instance", "type", "status", "node", "retries",
             "in_state_s"])
    else:
        print("no autoscaler v2 instances reported")
    events = out.get("events") or []
    if events:
        print(f"\nrecent lifecycle transitions ({len(events)}):")
        for e in events[-args.limit:]:
            reason = f"  ({e['reason']})" if e.get("reason") else ""
            print(f"  {e.get('instance_id', '?')} "
                  f"[{e.get('node_type', '?')}] "
                  f"{e.get('from', '?')} -> {e.get('to', '?')}{reason}")
    return 0


def cmd_ownership(args) -> int:
    """Ownership protocol plane (see README "Ownership protocol"):
    per-process RefState rows (what holds each object alive), lease
    slot/parked/pipeline accounting per scheduling key, node managers'
    held leases + store reader leases, and the transition-ring tail —
    `--object <hex prefix>` makes one stuck object explain itself."""
    _connect(args)
    from ray_tpu_torch.util import state as s
    out = s.ownership(object_id=args.object, limit=args.limit,
                      timeout=args.timeout)
    if args.format == "json":
        print(json.dumps(out, default=str))
        return 0
    if out.get("anomalies"):
        print("!! protocol anomalies (unmatched/illegal transitions):")
        for ev, n in sorted(out["anomalies"].items()):
            print(f"   {ev}: {n}")
    for node in out.get("nodes", ()):
        held = node.get("store_held") or []
        leases = node.get("nm_leases") or {}
        print(f"\n== node {str(node.get('node_id'))[:12]}: "
              f"{len(leases)} held lease(s), "
              f"{len(held)} leased/pinned store object(s)")
        if held:
            _print_table(
                [{"object_id": e["object_id"][:20], "size": e.get("size"),
                  "pinned": e.get("pinned"), "leases": e.get("leases"),
                  "spilled": e.get("spilled")} for e in held[:20]],
                ["object_id", "size", "pinned", "leases", "spilled"])
    for snap in out.get("procs", ()):
        objs = snap.get("objects") or []
        keys = [k for k in (snap.get("lease_keys") or ())
                if k["queued"] or k["requests_in_flight"] or k["leases"]
                or k["inflight"]]
        if not objs and not keys and not args.verbose:
            continue
        print(f"\n== {snap.get('label')} (pid {snap.get('pid')}, "
              f"{snap.get('mode')})")
        if objs:
            _print_table(
                [{"object_id": r["object_id"][:20], "loc": r["loc"],
                  "refs": r["local_refs"], "pins": r["arg_pins"],
                  "borrowers": len(r["borrower_pins"]),
                  "leases": r["replica_leases"],
                  "borrowed_from": (":".join(map(str, r["borrowed_from"]))
                                    if r["borrowed_from"] else "-")}
                 for r in objs[:args.limit]],
                ["object_id", "loc", "refs", "pins", "borrowers",
                 "leases", "borrowed_from"])
        if keys:
            _print_table(
                [{"key": k["key"], "queued": k["queued"],
                  "slots": k["requests_in_flight"],
                  "parked": k["parked"], "leases": k["leases"],
                  "inflight": sum(k["inflight"].values())}
                 for k in keys],
                ["key", "queued", "slots", "parked", "leases",
                 "inflight"])
        if args.object or args.verbose:
            for t in (snap.get("transitions") or ())[-args.limit:]:
                print(f"  {t['seq']:>6} {t['kind']:<13} "
                      f"{str(t['key'])[:16]:<16} {t['event']:<22} "
                      f"{t['old']} -> {t['new']}"
                      + (f"  [{t['detail']}]" if t.get("detail")
                         else ""))
    _warn_unreachable(list(out.get("unreachable") or []))
    return 0


def cmd_profile(args) -> int:
    """Cluster flamegraph (see README "Profiling & memory
    attribution"): sample every process for --duration seconds at
    --hz, task/actor/trace-attributed, and write speedscope JSON (load
    at https://www.speedscope.app) or collapsed folded text
    (flamegraph.pl). --device runs jax profiler traces instead."""
    _connect(args)
    from ray_tpu_torch._private import profiler as profiler_lib
    from ray_tpu_torch.util import state as s
    out = s.profile(duration=args.duration, hz=args.hz,
                    device=args.device, node_id=args.node_id,
                    worker_id=args.worker_id, actor=args.actor,
                    trace_id=args.trace_id)
    if args.device:
        for p in out["profiles"]:
            tag = p.get("xplane_dir") or p.get("skipped") \
                or p.get("error") or "?"
            print(f"{p.get('label', '?')}: {tag}")
        _warn_unreachable(out.get("unreachable"))
        return 0
    profiles = out["profiles"]
    samples = sum(p.get("samples", 0) for p in profiles)
    dropped = sum(p.get("dropped", 0) for p in profiles)
    if args.format == "folded":
        output = args.output or "/tmp/ray_tpu_profile.folded"
        with open(output, "w") as f:
            f.write(profiler_lib.to_folded(profiles))
    else:
        output = args.output or "/tmp/ray_tpu_profile.json"
        with open(output, "w") as f:
            json.dump(profiler_lib.to_speedscope(profiles), f)
    print(f"profiled {len(profiles)} process(es): {samples} samples "
          f"@ {out['hz']:g}hz over {out['duration_s']:g}s"
          + (f" ({dropped} samples over the stack cap dropped)"
             if dropped else ""))
    print(f"wrote {output}"
          + ("" if args.format == "folded"
             else " (load at https://www.speedscope.app)"))
    _warn_unreachable(out.get("unreachable"))
    return 0


def cmd_microbenchmark(args) -> int:
    """reference _private/ray_perf.py:93 suites, reduced."""
    import numpy as np

    import ray_tpu_torch
    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)

    def bench(name, fn, n):
        fn()  # warm
        t0 = time.perf_counter()
        fn()
        dt = time.perf_counter() - t0
        print(f"{name}: {n / dt:,.0f} /s")

    @ray_tpu_torch.remote
    def tiny():
        return b"ok"

    n = args.num_ops
    bench("tasks (submit+get, serial batches)",
          lambda: ray_tpu_torch.get([tiny.remote() for _ in range(n)]), n)

    @ray_tpu_torch.remote
    class A:
        def m(self):
            return b"ok"

    a = A.options(num_cpus=0.1).remote()
    bench("actor calls (pipelined)",
          lambda: ray_tpu_torch.get([a.m.remote() for _ in range(n)]), n)

    arr = np.zeros(1 << 20, dtype=np.uint8)  # 1 MiB
    bench("put 1MiB",
          lambda: [ray_tpu_torch.put(arr) for _ in range(n // 10)], n // 10)
    refs = [ray_tpu_torch.put(arr) for _ in range(n // 10)]
    bench("get 1MiB", lambda: ray_tpu_torch.get(refs), n // 10)
    ray_tpu_torch.shutdown()
    return 0


def cmd_client_server(args) -> int:
    from ray_tpu_torch.client import serve_forever
    serve_forever(_address(args), host=args.host, port=args.port)
    return 0


def cmd_job(args) -> int:
    from ray_tpu_torch.job import JobSubmissionClient
    client = JobSubmissionClient(_address(args))
    if args.job_cmd == "submit":
        # argparse puts the first entrypoint token into job_id's slot
        tokens = ([args.job_id] if args.job_id else []) + args.entrypoint
        job_id = client.submit_job(
            entrypoint=" ".join(tokens),
            working_dir=args.working_dir)
        print(f"submitted: {job_id}")
        if args.wait:
            status = client.wait(job_id)
            print(f"status: {status}")
            print(client.get_job_logs(job_id))
            return 0 if status == "SUCCEEDED" else 1
        return 0
    if args.job_cmd == "status":
        print(client.get_job_status(args.job_id))
        return 0
    if args.job_cmd == "logs":
        print(client.get_job_logs(args.job_id))
        return 0
    if args.job_cmd == "list":
        _print_table(client.list_jobs(),
                     ["job_id", "status", "entrypoint"])
        return 0
    raise SystemExit(f"unknown job command {args.job_cmd!r}")


def cmd_chaos(args) -> int:
    """Chaos plane control (see README "Chaos testing"): list installed
    rules + fired counts, inject a rule, or clear rules."""
    _connect(args)
    from ray_tpu_torch import chaos
    if args.chaos_cmd == "list":
        rules = chaos.list_rules()
        if args.format == "json":
            print(json.dumps(rules, default=str))
            return 0
        _print_table(
            [{**r, "nodes": ",".join(n for n in r.get("nodes", ()) if n)
              or "-", "selector": r.get("method", "*")}
             for r in rules],
            ["rule_id", "fault", "selector", "actor_class", "after_n",
             "max_fires", "probability", "disabled", "fired"])
        return 0
    if args.chaos_cmd == "inject":
        kwargs = {}
        if args.method:
            kwargs["method"] = args.method
        if args.nodes:
            a, _, b = args.nodes.partition(",")
            kwargs["nodes"] = (a, b)
        rid = chaos.inject(
            args.fault, node_id=args.node_id,
            actor_class=args.actor_class, object_glob=args.object_glob,
            probability=args.probability, seed=args.seed,
            after_n=args.after_n, max_fires=args.max_fires,
            delay_ms=args.delay_ms, jitter=args.jitter,
            error_message=args.error_message, **kwargs)
        print(rid)
        return 0
    if args.chaos_cmd == "clear":
        n = chaos.clear(args.rule_ids or None)
        print(f"cleared {n} rule(s)")
        return 0
    raise SystemExit(f"unknown chaos command {args.chaos_cmd!r}")


def _fmt_log_record(rec: Dict[str, Any]) -> str:
    ids = " ".join(x for x in (
        f"n:{rec['node_id'][:8]}" if rec.get("node_id") else "",
        f"w:{rec['worker_id'][:8]}" if rec.get("worker_id") else "",
        f"t:{rec['task_id'][:8]}" if rec.get("task_id") else "",
        f"a:{rec['actor_id'][:8]}" if rec.get("actor_id") else "",
        f"tr:{rec['trace_id']}" if rec.get("trace_id") else "",
    ) if x)
    return f"[{ids}] {rec.get('level', '?')} {rec.get('msg', '')}"


def cmd_logs(args) -> int:
    """Debug plane (see README "Debug plane"): query the cluster's
    attributed log tails (one GCS fan-out round, server-side filters),
    follow the live stream, or fetch crash postmortems."""
    _connect(args)
    from ray_tpu_torch.util import state as s
    if args.postmortem:
        bundle = s.get_postmortem(args.postmortem)
        if bundle is None:
            raise SystemExit(f"no postmortem {args.postmortem!r} "
                             f"(aged out of the ring?)")
        if args.format == "json":
            print(json.dumps(bundle, default=str))
            return 0
        for k in ("postmortem_id", "kind", "worker_id", "node_id",
                  "actor_id", "task", "reason", "gauges"):
            print(f"{k}: {bundle.get(k)}")
        print(f"-- last {len(bundle.get('log_tail') or ())} log lines:")
        for rec in bundle.get("log_tail") or ():
            print(_fmt_log_record(rec))
        print(f"-- span-ring tail "
              f"({len(bundle.get('span_tail') or ())} records):")
        for sp in (bundle.get("span_tail") or ())[-40:]:
            print(f"  {sp}")
        return 0
    if args.postmortems:
        rows = s.postmortems()
        if args.format == "json":
            print(json.dumps(rows, default=str))
            return 0
        _print_table(
            [{**r, "worker_id": (r.get("worker_id") or "")[:12],
              "node_id": (r.get("node_id") or "")[:12],
              "reason": str(r.get("reason", ""))[:60]} for r in rows],
            ["postmortem_id", "kind", "worker_id", "node_id", "task",
             "reason", "log_lines", "span_records"])
        return 0
    kwargs = dict(node_id=args.node_id, worker_id=args.worker_id,
                  actor=args.actor, task_id=args.task_id,
                  trace_id=args.trace_id, level=args.level,
                  match=args.match)
    if args.follow:
        try:
            for rec in s.follow_logs(**kwargs):
                print(_fmt_log_record(rec), flush=True)
        except KeyboardInterrupt:
            pass
        return 0
    out = s.logs(tail=args.tail, timeout=args.timeout, **kwargs)
    if args.format == "json":
        print(json.dumps(out, default=str))
        return 0
    for rec in out["records"]:
        print(_fmt_log_record(rec))
    if out.get("unreachable"):
        print(f"(warning: {len(out['unreachable'])} node(s) unreachable "
              f"within the deadline: "
              f"{[n[:12] for n in out['unreachable']]})",
              file=sys.stderr)
    return 0


def cmd_replay(args) -> int:
    """Distributed replay plane: one row per ReplayShardActor with the
    shard's live occupancy, lifetime adds/evictions, priority-update
    counts, and stale-ticket drops (see README "Distributed replay")."""
    _connect(args)
    from ray_tpu_torch.util import state as s
    out = s.replay_shards()
    if args.format == "json":
        print(json.dumps(out, default=str))
        return 0
    print(f"replay shards: {out['num_alive']}/{out['num_shards']} "
          f"alive  size={out['total_size']} "
          f"added={out['total_added']} "
          f"unmatched_updates={out['total_unmatched_priority_updates']}")
    rows = []
    for sh in out["shards"]:
        st = sh.get("stats") or {}
        rows.append({
            "shard": st.get("shard_id", "?"),
            "name": sh.get("name", ""),
            "state": sh.get("state", "?"),
            "restarts": sh.get("num_restarts", 0),
            "size": st.get("size", ""),
            "capacity": st.get("capacity", ""),
            "added": st.get("added", ""),
            "evicted": st.get("evicted", ""),
            "updates": st.get("update_rpcs", ""),
            "unmatched": st.get("unmatched_priority_updates", ""),
        })
    _print_table(rows, ["shard", "name", "state", "restarts", "size",
                        "capacity", "added", "evicted", "updates",
                        "unmatched"])
    return 0


def cmd_serve(args) -> int:
    """Serve request telemetry (see README "Serve request telemetry"):
    the slowest + all errored requests captured by every ingress proxy,
    with trace ids (feed them to `ray_tpu timeline --trace-id`) and
    per-stage latency breakdowns."""
    _connect(args)
    from ray_tpu_torch.util import state as s
    if args.serve_cmd == "fleet":
        out = s.serve_fleet()
        if args.format == "json":
            print(json.dumps(out, default=str))
            return 0
        print(f"ingress fleet: enabled={out.get('enabled')} "
              f"version={out.get('version')}")
        for p in out.get("proxies", ()):
            adm = p.get("admission") or {}
            sheds = p.get("shed_total", "?")
            print(f"  node {p['node_id'][:12]}  http:{p['http_port']}"
                  f"{'  grpc:' + str(p['grpc_port']) if p.get('grpc_port') else ''}"
                  f"  {'DRAINING' if p.get('draining') else ('healthy' if p.get('healthy') else 'UNHEALTHY')}"
                  f"  inflight={p.get('inflight', '?')} shed={sheds}")
            for dep, a in adm.items():
                print(f"    {dep}: inflight={a['inflight']:g}"
                      f"/{a['capacity']:g}+{a['max_queued']:g}"
                      f"{('  rate=' + format(a['rate_limit_rps'], 'g') + '/s') if a['rate_limit_rps'] else ''}")
        return 0
    if args.serve_cmd != "requests":
        raise SystemExit(f"unknown serve command {args.serve_cmd!r}")
    out = s.serve_requests(deployment=args.deployment,
                           errors=args.errors, slowest=args.slowest,
                           timeout=args.timeout)
    if args.format == "json":
        print(json.dumps(out, default=str))
        return 0
    rows = []
    for e in out["requests"]:
        stages = e.get("stages") or {}
        rows.append({
            "trace_id": e.get("trace_id", ""),
            "deployment": e.get("deployment", "?"),
            "method": e.get("method", "?"),
            "code": e.get("code", "?"),
            "total_ms": f"{1e3 * (e.get('total_s') or 0.0):.1f}",
            "stages": " ".join(
                f"{k[:-2]}={1e3 * v:.1f}ms"
                for k, v in sorted(stages.items())),
            # tracebacks are multi-line; one table row per request
            "error": " ".join(str(e.get("error") or "").split())[:60],
        })
    _print_table(rows, ["trace_id", "deployment", "method", "code",
                        "total_ms", "stages", "error"])
    print(f"({out['proxies']} prox{'y' if out['proxies'] == 1 else 'ies'}"
          f" answered)")
    _warn_unreachable(out.get("unreachable"))
    return 0


def cmd_metrics(args) -> int:
    """Cluster metrics plane (see README "Cluster metrics"): dump the
    merged registry (text exposition or JSON harvest), or print the
    watchdog's recent HEALTH_ALERT events."""
    _connect(args)
    from ray_tpu_torch.util import state as s
    if args.metrics_cmd == "dump":
        # an operator dumping wants the cluster as of NOW, not the
        # sampler's last round
        if args.format == "json":
            print(json.dumps(s.cluster_metrics(fresh=True),
                             default=str))
        else:
            print(s.cluster_metrics_text(fresh=True), end="")
        return 0
    if args.metrics_cmd == "alerts":
        alerts = s.health_alerts()
        if args.format == "json":
            print(json.dumps(alerts, default=str))
            return 0
        _print_table(
            [{**a, "ts": f"{a.get('ts', 0):.0f}"} for a in alerts],
            ["ts", "severity", "probe", "series", "message"])
        return 0
    raise SystemExit(f"unknown metrics command {args.metrics_cmd!r}")


_SPARK_BLOCKS = "▁▂▃▄▅▆▇█"


def _sparkline(values) -> str:
    vals = [v for v in values if v is not None]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(
        " " if v is None else
        _SPARK_BLOCKS[int((v - lo) / span * (len(_SPARK_BLOCKS) - 1))]
        for v in values)


def cmd_top(args) -> int:
    """Curses-free cluster watch over the GCS's in-memory time-series
    ring: last value, rate over the sample window, and a sparkline of
    recent history per series — no external Prometheus needed."""
    _connect(args)
    from ray_tpu_torch.util import state as s
    for i in range(args.iterations):
        if i:
            time.sleep(args.interval)
        hist = s.metrics_history(
            names=[args.filter] if args.filter else None)
        samples = hist["samples"]
        if not samples:
            print("(no samples yet — the GCS harvests every "
                  f"{hist['interval_s']:g}s)")
            continue
        if sys.stdout.isatty() and args.iterations != 1:
            print("\x1b[2J\x1b[H", end="")
        ts, latest = samples[-1]
        keys = sorted(latest)
        window = samples[-30:]
        # rates come from the sampler's CADENCED rounds only: forced
        # harvests (metrics dump, tests) land in the ring for the
        # sparklines but their sub-interval spacing would turn a rate
        # into noise
        forced = hist.get("forced") or [False] * len(samples)
        paced = [smp for smp, f in zip(samples, forced) if not f] \
            or samples
        rows = []
        for k in keys:
            vals = [smp.get(k) for _t, smp in window]
            rate = ""
            if len(paced) >= 2:
                (t0, prev), (t1, cur) = paced[-2], paced[-1]
                if k in prev and k in cur and t1 > t0:
                    rate = f"{(cur[k] - prev[k]) / (t1 - t0):+.1f}/s"
            rows.append({"series": k, "value": f"{latest[k]:g}",
                         "rate": rate,
                         "history": _sparkline(vals)})
        print(f"== ray_tpu top · {len(keys)} series · "
              f"sample interval {hist['interval_s']:g}s")
        _print_table(rows, ["series", "value", "rate", "history"])
    return 0


def cmd_goodput(args) -> int:
    """Per-job wall-time ledger: every second of gang lifetime bucketed
    into productive_step / compile / checkpoint / reconfig / stalls /
    idle (see README "Goodput & metrics history")."""
    _connect(args)
    from ray_tpu_torch.util import state as s
    from ray_tpu_torch._private import goodput as gp
    report = s.goodput(job=args.job, window_s=args.window, fresh=True)
    if args.format == "json":
        print(json.dumps(report, default=str))
        return 0
    jobs = report.get("jobs") or {}
    if not jobs:
        print("(no goodput ledgers yet — training loops create them "
              "on their first step)")
        return 0
    window = (f"last {report['window_s']:g}s"
              if report.get("window_s") else "job lifetime")
    for job, rec in sorted(jobs.items()):
        frac = rec.get("productive_frac")
        frac_txt = f"{100 * frac:.1f}%" if frac is not None else "n/a"
        print(f"== job {job} · {window} · "
              f"accounted {rec['accounted_s']:.1f}s · "
              f"productive {frac_txt}")
        buckets = rec.get("buckets") or {}
        total = rec.get("accounted_s") or 0.0
        rows = []
        for name in gp.BUCKETS:
            secs = buckets.get(name, 0.0)
            if not secs and name != gp.PRODUCTIVE:
                continue
            share = f"{100 * secs / total:.1f}%" if total else ""
            rows.append({"bucket": name, "seconds": f"{secs:.2f}",
                         "share": share})
        _print_table(rows, ["bucket", "seconds", "share"])
        inflight = rec.get("in_flight")
        if inflight:
            print(f"   in-flight: {inflight.get('bucket') or 'idle'} "
                  f"for {inflight.get('bucket_age_s', 0.0):.1f}s "
                  f"(proc {inflight.get('proc', '?')})")
    return 0


def cmd_lint(args) -> int:
    """graftlint passthrough (same engine as `python -m ray_tpu_torch.lint`)."""
    from ray_tpu_torch.lint.__main__ import main as lint_main
    argv = list(args.paths)
    if args.format != "text":
        argv.append(f"--format={args.format}")
    if args.select:
        argv.append(f"--select={args.select}")
    if args.ignore:
        argv.append(f"--ignore={args.ignore}")
    return lint_main(argv)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="ray_tpu", description="ray_tpu cluster CLI")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("start", help="start a head or joining node")
    p.add_argument("--head", action="store_true")
    p.add_argument("--address", default=None,
                   help="GCS address to join (non-head)")
    p.add_argument("--num-cpus", type=float, default=None)
    p.add_argument("--resources", default=None, help="JSON dict")
    p.add_argument("--block", action="store_true")
    p.set_defaults(fn=cmd_start)

    p = sub.add_parser("stop", help="stop local ray_tpu processes")
    p.set_defaults(fn=cmd_stop)

    for name, fn in (("status", cmd_status), ("summary", cmd_summary)):
        p = sub.add_parser(name)
        p.add_argument("--address", default=None)
        p.set_defaults(fn=fn)

    p = sub.add_parser("memory", help="owner-attributed memory "
                                      "accounting: cluster object table "
                                      "+ per-node store stats")
    p.add_argument("--address", default=None)
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--group-by", choices=("callsite", "actor", "node",
                                          "owner"), default=None,
                   help="aggregate objects (callsite needs "
                        "RAY_TPU_memory_callsite_capture=1)")
    p.add_argument("--top", type=int, default=None,
                   help="largest N objects/groups (default 20 objects)")
    p.add_argument("--timeout", type=float, default=None,
                   help="overall fan-out deadline (seconds)")
    p.set_defaults(fn=cmd_memory)

    p = sub.add_parser("profile", help="task-attributed cluster "
                                       "flamegraph (speedscope/folded)")
    p.add_argument("--address", default=None)
    p.add_argument("--duration", type=float, default=5.0,
                   help="sampling window in seconds")
    p.add_argument("--hz", type=float, default=None,
                   help="samples per second (default "
                        "Config.profile_default_hz = 100)")
    p.add_argument("--format", choices=("speedscope", "folded"),
                   default="speedscope")
    p.add_argument("--output", "-o", default=None,
                   help="default /tmp/ray_tpu_profile.{json,folded}")
    p.add_argument("--node-id", default=None, help="node id prefix")
    p.add_argument("--worker-id", default=None, help="worker id prefix")
    p.add_argument("--actor", default=None,
                   help="actor NAME or actor id prefix")
    p.add_argument("--trace-id", default=None,
                   help="keep only samples inside this trace")
    p.add_argument("--device", action="store_true",
                   help="jax profiler traces on device-hosting workers "
                        "(reports xplane dirs) instead of CPU sampling")
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser("autoscaler", help="autoscaler v2 lifecycle: "
                                          "instance table + recent "
                                          "transitions (see README "
                                          "\"Elastic training\")")
    p.add_argument("--address", default=None)
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--limit", type=int, default=50,
                   help="max lifecycle transitions to print")
    p.set_defaults(fn=cmd_autoscaler)

    p = sub.add_parser("ownership", help="ownership protocol: RefState/"
                                         "LeaseState per process, held "
                                         "leases + store reader leases, "
                                         "transition ring tail")
    p.add_argument("--address", default=None)
    p.add_argument("--object", default=None,
                   help="object id hex prefix: explain this object's "
                        "state + last transitions")
    p.add_argument("--limit", type=int, default=200,
                   help="max transitions/rows per process")
    p.add_argument("--timeout", type=float, default=None,
                   help="overall fan-out deadline (seconds)")
    p.add_argument("--verbose", action="store_true",
                   help="print every process + its transition tail")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.set_defaults(fn=cmd_ownership)

    p = sub.add_parser("locks", help="runtime lockdep: per-process "
                                     "traced-lock stats + acquisition-"
                                     "order graph (cycle = deadlock "
                                     "in waiting)")
    p.add_argument("--address", default=None)
    p.add_argument("--timeout", type=float, default=None)
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.set_defaults(fn=cmd_locks)

    p = sub.add_parser("list", help="list cluster state")
    p.add_argument("kind", help="tasks|actors|nodes|workers|objects|"
                                "placement-groups")
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser("stack", help="live stack dump of workers "
                                     "(reference `ray stack`)")
    p.add_argument("--worker-id", default=None,
                   help="one worker id; default: all live workers")
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_stack)

    p = sub.add_parser("timeline", help="dump Chrome-trace timeline")
    p.add_argument("--output", "-o", default="/tmp/ray_tpu_timeline.json")
    p.add_argument("--address", default=None)
    p.add_argument("--spans", action="store_true",
                   help="merge every process's flight-recorder span ring "
                        "into the trace (clock-aligned)")
    p.add_argument("--trace-id", default=None,
                   help="export only this start_trace block's records "
                        "as a standalone trace (implies --spans)")
    p.set_defaults(fn=cmd_timeline)

    p = sub.add_parser("lint", help="framework-aware static analysis "
                                    "(graftlint; see README)")
    p.add_argument("paths", nargs="*", default=["."])
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--select", default=None, help="rule ids to run")
    p.add_argument("--ignore", default=None, help="rule ids to skip")
    p.set_defaults(fn=cmd_lint)

    p = sub.add_parser("logs", help="query/follow attributed cluster "
                                    "logs and crash postmortems "
                                    "(debug plane; see README)")
    p.add_argument("--address", default=None)
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--node-id", default=None, help="node id prefix")
    p.add_argument("--worker-id", default=None, help="worker id prefix")
    p.add_argument("--actor", default=None,
                   help="actor NAME or actor id prefix")
    p.add_argument("--task-id", default=None, help="task id prefix")
    p.add_argument("--trace-id", default=None,
                   help="util.tracing trace id (lines stamp it)")
    p.add_argument("--level", default=None,
                   help="OUT|ERR|INFO|WARNING|ERROR|RAW")
    p.add_argument("--match", default=None, help="regex over messages")
    p.add_argument("--tail", type=int, default=500,
                   help="last N records across the cluster")
    p.add_argument("--timeout", type=float, default=None,
                   help="overall fan-out deadline (seconds)")
    p.add_argument("--follow", action="store_true",
                   help="stream new records (pubsub) until ^C")
    p.add_argument("--postmortem", default=None,
                   help="print one crash bundle by id (pm-...)")
    p.add_argument("--postmortems", action="store_true",
                   help="list recent crash postmortems")
    p.set_defaults(fn=cmd_logs)

    p = sub.add_parser("serve", help="serve ops: request telemetry "
                                     "(requests) + ingress fleet "
                                     "state (fleet) — see README")
    p.add_argument("serve_cmd", choices=["requests", "fleet"])
    p.add_argument("--address", default=None)
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--deployment", default=None,
                   help="filter to one deployment")
    p.add_argument("--errors", action="store_true",
                   help="only errored requests")
    p.add_argument("--slowest", type=int, default=None,
                   help="the N slowest requests across all proxies")
    p.add_argument("--timeout", type=float, default=10.0,
                   help="overall proxy fan-out deadline (seconds)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("replay", help="distributed replay plane: "
                                      "per-shard occupancy, adds, "
                                      "priority updates, stale tickets")
    p.add_argument("--address", default=None)
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.set_defaults(fn=cmd_replay)

    p = sub.add_parser("metrics", help="cluster metrics plane: dump the "
                                       "merged registry / watchdog alerts")
    p.add_argument("metrics_cmd", choices=["dump", "alerts"])
    p.add_argument("--address", default=None)
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.set_defaults(fn=cmd_metrics)

    p = sub.add_parser("top", help="watch cluster series (rates + "
                                   "sparklines from the GCS history ring)")
    p.add_argument("--address", default=None)
    p.add_argument("--interval", type=float, default=2.0,
                   help="refresh period between iterations")
    p.add_argument("--iterations", type=int, default=1,
                   help="refresh count (use a large value to watch)")
    p.add_argument("--filter", default="ray_tpu_",
                   help="series name prefix ('' for everything)")
    p.set_defaults(fn=cmd_top)

    p = sub.add_parser("goodput", help="per-job productive/badput "
                                       "wall-time ledger")
    p.add_argument("--address", default=None)
    p.add_argument("--job", default=None,
                   help="only this job (default: all jobs)")
    p.add_argument("--window", type=float, default=None,
                   help="report the trailing N seconds instead of "
                        "job lifetime (needs the GCS history ring)")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.set_defaults(fn=cmd_goodput)

    p = sub.add_parser("chaos", help="fault injection: list/inject/clear "
                                     "chaos rules (see README)")
    p.add_argument("chaos_cmd", choices=["list", "inject", "clear"])
    p.add_argument("rule_ids", nargs="*", help="clear: rule ids "
                                               "(default: all)")
    p.add_argument("--address", default=None)
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--fault", default="delay",
                   help="inject: delay|drop_connection|partition|"
                        "kill_worker|error|evict_object")
    p.add_argument("--method", default=None, help="RPC/store-op glob")
    p.add_argument("--node-id", default="", help="node id hex prefix")
    p.add_argument("--nodes", default="",
                   help="partition pair 'hexA,hexB'")
    p.add_argument("--actor-class", default="", help="actor class glob")
    p.add_argument("--object-glob", default="", help="object id glob")
    p.add_argument("--probability", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--after-n", type=int, default=0,
                   help="skip the first N matching calls")
    p.add_argument("--max-fires", type=int, default=-1,
                   help="stop after N fires (1 = one-shot; -1 = inf)")
    p.add_argument("--delay-ms", type=float, default=0.0)
    p.add_argument("--jitter", action="store_true",
                   help="delay: uniform(0, delay_ms) from the seeded rng")
    p.add_argument("--error-message", default="")
    p.set_defaults(fn=cmd_chaos)

    p = sub.add_parser("microbenchmark")
    p.add_argument("--num-ops", type=int, default=200)
    p.set_defaults(fn=cmd_microbenchmark)

    p = sub.add_parser("client-server",
                       help="serve thin clients (ray:// mode)")
    p.add_argument("--address", default=None)
    p.add_argument("--port", type=int, default=10001)
    p.add_argument("--host", default="0.0.0.0",
                   help="bind host (remote thin clients need non-loopback)")
    p.set_defaults(fn=cmd_client_server)

    p = sub.add_parser("job", help="job submission")
    p.add_argument("job_cmd", choices=["submit", "status", "logs", "list"])
    p.add_argument("job_id", nargs="?", default=None)
    p.add_argument("--address", default=None)
    p.add_argument("--working-dir", default=None)
    p.add_argument("--wait", action="store_true")
    p.add_argument("entrypoint", nargs="*",
                   help="after --: the command to run")
    p.set_defaults(fn=cmd_job)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
