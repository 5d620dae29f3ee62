"""Seeded chaos-fuzz harness for the ownership protocol.

Jepsen-style fault-schedule testing for `_private/ownership.py` and the
code that drives it (core_worker refcounts/pins/borrows/leases, store
reader leases, NM lease grants): a SEEDED random workload program
(puts / gets / nested-ref tasks / borrow chains / dels / actor calls)
runs against a SEEDED chaos schedule (delay / drop_connection /
kill_worker / evict_object via the chaos plane), while a cluster-wide
invariant checker runs every N steps and a post-quiesce
"everything-drains-to-zero" assertion closes each run.

Invariants checked (the protocol's conservation laws):

  - no `illegal:*` transition anywhere (the transition() choke point's
    strict rejections — double release, negative count, free-while-
    pinned — must never fire on a legal workload, chaos included)
  - refcount conservation: at every owner, borrower registrations are
    a subset of arg pins (Σ borrower_pins <= arg_pins, per object)
  - lease slots bounded: requests_in_flight <= MAX_PENDING_LEASE_REQUESTS
  - no leaked request slot: a slot held with no queued work and nothing
    parked, persisting across checks, is the ADVICE-r5 stall leak
  - store reader leases are claimed: a store entry's lease count never
    exceeds the replica leases live processes account for (persisting)
  - wait graph stays acyclic
  - post-quiesce: every ref resolves (no stalled task), then local
    refs, arg/transit pins, borrower pins, replica leases, lease slots,
    pipeline depths and held leases all drain to zero cluster-wide

Every violation reproduces from `--seed` alone (same seed -> same
workload program and same chaos-rule schedule). Usage:

    python -m ray_tpu_torch.tools.fuzz_ownership --seed 7 --steps 500 \
        --schedule mixed --format=json
    python -m ray_tpu_torch.tools.fuzz_ownership --seeds 50 \
        --steps 500  # sweep

Library entry point for tests: `run_fuzz(seed, steps, schedule, ...)`
(tests/test_torch_fuzz_ownership.py runs 3 short seeds, each in a
process of its own under a timeout).
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import os
import random
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

# Methods worth delaying/dropping: the ownership protocol's own edges.
DELAY_METHODS = ("cw_task_done", "nm_request_lease", "w_push_task",
                 "cw_add_ref", "store_wait", "*")
DROP_METHODS = ("cw_task_done", "cw_add_ref", "cw_remove_ref",
                "nm_return_worker", "store_pull", "cw_lease_granted")
SCHEDULES = ("none", "delay", "drop", "kill", "evict", "mixed")

MAX_PENDING_LEASE_REQUESTS = 4  # mirrors CoreWorker's cap


class FuzzViolation(AssertionError):
    """An ownership-protocol invariant failed under the seeded run."""


def build_schedule(rng: random.Random, schedule: str
                   ) -> List[Dict[str, Any]]:
    """Chaos rules for one run, fully determined by the rng's seed."""
    rules: List[Dict[str, Any]] = []

    def rule(fault: str, **kw: Any) -> None:
        kw.setdefault("seed", rng.randrange(1 << 30))
        kw.setdefault("rule_id", f"fuzz-{fault}-{len(rules)}")
        rules.append({"fault": fault, **kw})

    if schedule in ("delay", "mixed"):
        for _ in range(2):
            rule("delay", method=rng.choice(DELAY_METHODS),
                 delay_ms=rng.uniform(1.0, 12.0), jitter=True,
                 probability=rng.uniform(0.1, 0.3),
                 max_fires=rng.randrange(10, 40))
    if schedule in ("drop", "mixed"):
        for _ in range(2):
            rule("drop_connection", method=rng.choice(DROP_METHODS),
                 probability=rng.uniform(0.1, 0.3),
                 max_fires=rng.randrange(3, 10))
    if schedule in ("kill", "mixed"):
        rule("kill_worker", after_n=rng.randrange(4, 25),
             max_fires=rng.randrange(1, 3))
    if schedule in ("evict", "mixed"):
        rule("evict_object",
             method=rng.choice(("store_wait", "store_create")),
             probability=rng.uniform(0.05, 0.2),
             max_fires=rng.randrange(1, 4))
    return rules


# ---------------------------------------------------------------------
# Invariant checker (reads the ownership query plane as its oracle)
# ---------------------------------------------------------------------


def _collect():
    from ray_tpu_torch.util import state as state_api
    return state_api.ownership(limit=64)


def _effective_anomalies(out: Dict[str, Any],
                         baseline: Optional[Dict[str, int]]
                         ) -> Dict[str, int]:
    """Cluster anomaly counts minus the driver's pre-run baseline: the
    ring is process-global and cumulative, so anomalies a PREVIOUS run
    (or a unit test deliberately exercising illegal edges) recorded in
    this long-lived driver process must not fail this run."""
    eff = {}
    for ev, n in (out.get("anomalies") or {}).items():
        n = int(n) - int((baseline or {}).get(ev, 0))
        if n > 0:
            eff[ev] = n
    return eff


def check_invariants(out: Dict[str, Any], prev_suspects: set,
                     allow_orphans: bool,
                     anomaly_baseline: Optional[Dict[str, int]] = None
                     ) -> Tuple[List[str], set]:
    """One mid-run invariant pass. Hard invariants (consistent under
    the owner's own lock) violate immediately; cross-process ones must
    persist across two consecutive checks (messages in flight make a
    single observation racy). Returns (violations, suspects)."""
    violations: List[str] = []
    suspects: set = set()

    for ev, n in _effective_anomalies(out, anomaly_baseline).items():
        if ev.startswith("illegal:"):
            violations.append(f"anomaly {ev} x{n}")

    claimed_leases: Dict[str, int] = collections.Counter()
    for snap in out.get("procs", ()):
        label = snap.get("label")
        for row in snap.get("objects", ()):
            borrow_total = sum((row.get("borrower_pins") or {}).values())
            if borrow_total > (row.get("arg_pins") or 0):
                violations.append(
                    f"conservation: {row['object_id'][:16]} at {label}: "
                    f"borrower pins {borrow_total} > arg pins "
                    f"{row.get('arg_pins')}")
            claimed_leases[row["object_id"]] += \
                int(row.get("replica_leases") or 0)
        for key in snap.get("lease_keys", ()):
            if key["requests_in_flight"] > MAX_PENDING_LEASE_REQUESTS:
                violations.append(
                    f"slots: key {key['key']} at {label} holds "
                    f"{key['requests_in_flight']} > cap")
            if key["requests_in_flight"] > 0 and key["queued"] == 0 \
                    and key["parked"] == 0:
                suspects.add(("slot_leak", label, key["key"],
                              key["requests_in_flight"]))

    if not allow_orphans:
        for node in out.get("nodes", ()):
            for ent in node.get("store_held", ()):
                leased = int(ent.get("leases") or 0)
                if leased > claimed_leases.get(ent["object_id"], 0):
                    suspects.add(("orphan_lease", node.get("node_id"),
                                  ent["object_id"], leased))

    # wait graph must stay acyclic (cycles are rejected at add time)
    try:
        from ray_tpu_torch.util import state as state_api
        wg = state_api.wait_graph()
        adj: Dict[str, set] = {}
        for e in wg.get("edges", ()):
            adj.setdefault(e["waiter"], set()).add(e["target"])

        def cyclic(start: str) -> bool:
            seen, stack = set(), [(start, iter(adj.get(start, ())))]
            on_path = {start}
            while stack:
                node, it = stack[-1]
                nxt = next(it, None)
                if nxt is None:
                    stack.pop()
                    on_path.discard(node)
                    continue
                if nxt in on_path:
                    return True
                if nxt not in seen:
                    seen.add(nxt)
                    on_path.add(nxt)
                    stack.append((nxt, iter(adj.get(nxt, ()))))
            return False

        if any(cyclic(n) for n in adj):
            suspects.add(("wait_cycle",))
    except Exception:  # noqa: BLE001 - GCS briefly unreachable mid-chaos
        pass

    # persistence rule: a cross-process suspect seen twice in a row is real
    for s in suspects & prev_suspects:
        violations.append(f"persistent: {s}")
    return violations, suspects


def quiesce_check(deadline_s: float, allow_orphans: bool,
                  anomaly_baseline: Optional[Dict[str, int]] = None
                  ) -> Tuple[List[str], Dict[str, Any]]:
    """Post-quiesce drains-to-zero: with every ref dropped and chaos
    cleared, all ownership accounting must reach zero cluster-wide."""
    deadline = time.monotonic() + deadline_s
    # progress-aware extension: on a slammed box recovery tails are
    # long but MOVING (retries + respawns draining one by one) — keep
    # waiting while the leak set keeps changing, up to a hard cap; a
    # true wedge goes static and fails at the base deadline
    hard_deadline = time.monotonic() + 3 * deadline_s
    prev_leaks: Optional[List[str]] = None
    leaks: List[str] = []
    last: Dict[str, Any] = {}
    while time.monotonic() < deadline:
        gc.collect()
        leaks = []
        try:
            out = _collect()
        except Exception as e:  # noqa: BLE001 - cluster still settling
            leaks = [f"ownership_collect failed: {e}"]
            time.sleep(0.5)
            continue
        last = out
        for ev, n in _effective_anomalies(out, anomaly_baseline).items():
            if ev.startswith("illegal:"):
                leaks.append(f"anomaly {ev} x{n}")
        for snap in out.get("procs", ()):
            label = snap.get("label")
            for row in snap.get("objects", ()):
                for field in ("local_refs", "arg_pins",
                              "replica_leases"):
                    if row.get(field):
                        leaks.append(
                            f"{field}={row[field]} on "
                            f"{row['object_id'][:16]} at {label}")
                if row.get("borrower_pins"):
                    leaks.append(
                        f"borrower_pins={row['borrower_pins']} on "
                        f"{row['object_id'][:16]} at {label}")
            for key in snap.get("lease_keys", ()):
                if key["requests_in_flight"] or \
                        any(key["inflight"].values()):
                    leaks.append(
                        f"lease key {key['key']} at {label}: "
                        f"slots={key['requests_in_flight']} "
                        f"inflight={key['inflight']}")
            if snap.get("running_leases"):
                leaks.append(f"running leases at {label}: "
                             f"{snap['running_leases']}")
            if snap.get("ttl_pins"):
                leaks.append(f"{snap['ttl_pins']} ttl pin handle(s) "
                             f"at {label}")
        if not allow_orphans:
            for node in out.get("nodes", ()):
                if node.get("nm_leases"):
                    leaks.append(f"NM {str(node.get('node_id'))[:12]} "
                                 f"still holds {node['nm_leases']}")
                for ent in node.get("store_held", ()):
                    leaks.append(
                        f"store entry {ent['object_id'][:16]} on "
                        f"{str(node.get('node_id'))[:12]} still "
                        f"pinned={ent.get('pinned')} "
                        f"leases={ent.get('leases')}")
        if not leaks:
            return [], last
        if prev_leaks is not None and leaks != prev_leaks:
            deadline = min(hard_deadline,
                           time.monotonic() + deadline_s)
        prev_leaks = leaks
        time.sleep(0.5)
    return [f"drains-to-zero failed after {deadline_s:.0f}s: " + l
            for l in leaks], last


# ---------------------------------------------------------------------
# Workload interpreter
# ---------------------------------------------------------------------


def _tolerated_exceptions():
    import ray_tpu_torch
    from ray_tpu_torch._private.chaos import ChaosError
    from ray_tpu_torch._private.object_store import ObjectStoreFullError
    from ray_tpu_torch._private.rpc import ConnectionLost
    exc = ray_tpu_torch.exceptions
    return (ChaosError, ConnectionLost, ObjectStoreFullError,
            exc.RayTaskError, exc.WorkerCrashedError,
            exc.ObjectLostError, exc.ObjectFreedError,
            exc.OwnerDiedError, exc.ActorDiedError,
            exc.ActorUnavailableError, exc.RaySystemError)


def run_fuzz(seed: int, steps: int = 200, schedule: str = "mixed",
             check_every: int = 50, num_cpus: int = 2,
             get_timeout_s: float = 60.0,
             quiesce_timeout_s: float = 25.0,
             verbose: bool = False) -> Dict[str, Any]:
    """One seeded run: fresh cluster, seeded chaos schedule, seeded
    workload, invariant checks every `check_every` steps, post-quiesce
    drain assertion. Returns a JSON-able report; raises nothing —
    violations land in report["violations"]."""
    import os

    import numpy as np

    # transit-pin TTLs default to 30s (the no-ack fallback); the drain
    # phase would wait them out on every chaos-dropped ack, so shorten
    # them for fuzz runs — in this process AND in spawned workers
    os.environ["RAY_TPU_transit_pin_ttl_s"] = "2.0"

    import ray_tpu_torch
    from ray_tpu_torch import chaos
    from ray_tpu_torch._private.config import Config
    Config.transit_pin_ttl_s = 2.0

    rng = random.Random(seed)
    report: Dict[str, Any] = {
        "seed": seed, "steps": steps, "schedule": schedule,
        "ops": collections.Counter(),
        "tolerated_errors": collections.Counter(),
        "violations": [], "checks": 0,
    }
    t_start = time.monotonic()

    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=num_cpus)
    tolerated = _tolerated_exceptions()
    allow_orphans = schedule in ("kill", "mixed")
    if allow_orphans:
        # kill schedules converge slowly on small boxes: worker respawn
        # is serial (~1s each), actor restarts re-run __init__, and
        # retry backoffs compound — refless tasks mid-retry are
        # legitimate for tens of seconds after chaos clears, and a
        # drain deadline that fires inside that tail reads recovery as
        # a leak
        quiesce_timeout_s = max(quiesce_timeout_s, 60.0)
    # this (long-lived) driver process's anomaly counters are
    # cumulative; only growth during THIS run counts
    from ray_tpu_torch._private import ownership as ownership_lib
    anomaly_baseline = dict(ownership_lib.anomaly_counts())

    @ray_tpu_torch.remote(max_retries=3)
    def produce(n, size):
        import numpy as _np
        return _np.full(size, n % 251, dtype=_np.uint8)

    @ray_tpu_torch.remote(max_retries=3)
    def consume(arr, salt):
        # borrow chain: the executing worker borrows the ref's value
        return int(arr[0]) + salt % 7

    @ray_tpu_torch.remote(max_retries=3)
    def nest(n):
        # nested refs: the result embeds refs this WORKER owns
        return [ray_tpu_torch.put(n), ray_tpu_torch.put(n + 1)]

    @ray_tpu_torch.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def bump(self, delta):
            self.n += delta
            return self.n

        def hold(self, arr):
            # actor-side borrow: keeps the value alive past the call
            self.kept = arr
            return int(arr.nbytes)

    def tolerate(op: str, fn):
        try:
            return fn()
        except tolerated as e:
            report["tolerated_errors"][
                f"{op}:{type(e).__name__}"] += 1
            return None
        except ray_tpu_torch.exceptions.GetTimeoutError:
            report["tolerated_errors"][f"{op}:GetTimeout"] += 1
            return None

    def workload(refs: List[Any], actors: List[Any]) -> None:
        # NOTE: runs in its own frame so loop locals (src/inner/...)
        # release their ObjectRefs before the quiesce drain check —
        # a leftover local here read as a false protocol leak
        prev_suspects: set = set()
        for step in range(steps):
            op = rng.choices(
                ("put_small", "put_store", "task", "chain", "nest",
                 "deref_nest", "get", "wait", "drop", "actor_call",
                 "actor_hold"),
                weights=(10, 6, 14, 10, 6, 5, 16, 5, 14, 8, 4))[0]
            report["ops"][op] += 1
            if op == "put_small":
                refs.append(ray_tpu_torch.put(rng.randrange(1 << 20)))
            elif op == "put_store":
                refs.append(tolerate(op, lambda: ray_tpu_torch.put(
                    np.full(rng.randrange(200_000, 400_000),
                            step % 251, dtype=np.uint8))))
            elif op == "task":
                refs.append(produce.remote(step,
                                           rng.randrange(1024, 4096)))
            elif op == "chain" and refs:
                src = rng.choice(refs)
                if src is not None and hasattr(src, "hex"):
                    refs.append(consume.remote(src, step))
            elif op == "nest":
                refs.append(nest.remote(step))
            elif op == "deref_nest" and refs:
                src = rng.choice(refs)
                if src is not None and hasattr(src, "hex"):
                    inner = tolerate(op, lambda: ray_tpu_torch.get(
                        src, timeout=get_timeout_s))
                    if isinstance(inner, list) and inner and \
                            hasattr(inner[0], "hex"):
                        refs.append(rng.choice(inner))
            elif op == "get" and refs:
                src = rng.choice(refs)
                if src is not None and hasattr(src, "hex"):
                    tolerate(op, lambda: ray_tpu_torch.get(
                        src, timeout=get_timeout_s))
            elif op == "wait" and refs:
                live = [r for r in refs if r is not None
                        and hasattr(r, "hex")]
                if live:
                    sample = rng.sample(live,
                                        min(len(live), 4))
                    tolerate(op, lambda: ray_tpu_torch.wait(
                        sample, num_returns=1, timeout=5.0))
            elif op == "drop" and refs:
                refs.pop(rng.randrange(len(refs)))
            elif op == "actor_call":
                if len(actors) < 2:
                    actors.append(Counter.options(
                        num_cpus=0.05, max_restarts=1).remote())
                a = rng.choice(actors)
                tolerate(op, lambda: ray_tpu_torch.get(
                    a.bump.remote(1), timeout=get_timeout_s))
            elif op == "actor_hold" and refs:
                src = rng.choice(refs)
                if src is not None and hasattr(src, "hex") and actors:
                    a = rng.choice(actors)
                    tolerate(op, lambda: ray_tpu_torch.get(
                        a.hold.remote(src), timeout=get_timeout_s))
            # bound the live set so the run doesn't just accumulate
            while len(refs) > 48:
                refs.pop(rng.randrange(len(refs)))

            if check_every and (step + 1) % check_every == 0:
                try:
                    out = _collect()
                except Exception as e:  # noqa: BLE001 - mid-chaos blip
                    report["tolerated_errors"][
                        f"check:{type(e).__name__}"] += 1
                    continue
                report["checks"] += 1
                violations, prev_suspects = check_invariants(
                    out, prev_suspects, allow_orphans,
                    anomaly_baseline)
                report["violations"].extend(violations)
                if verbose:
                    print(f"[seed {seed}] step {step + 1}: "
                          f"{len(violations)} violation(s)",
                          file=sys.stderr)

    def resolve_and_release(refs: List[Any], actors: List[Any]) -> None:
        """Quiesce phase 1 (own frame, like workload): chaos off, every
        surviving ref must still resolve — a get that times out with no
        chaos running is a stalled task (leaked lease slot / lost
        completion report), the ADVICE-r5 class."""
        try:
            chaos.clear()
        except Exception:  # noqa: BLE001 - no rules installed
            pass
        for r in refs:
            if r is None or not hasattr(r, "hex"):
                continue
            try:
                ray_tpu_torch.get(r, timeout=get_timeout_s)
            except tolerated as e:
                report["tolerated_errors"][
                    f"quiesce:{type(e).__name__}"] += 1
            except ray_tpu_torch.exceptions.GetTimeoutError:
                report["violations"].append(
                    f"post-chaos stall: ref {r.hex()[:20]} never "
                    f"resolved (leaked lease slot / lost completion?)")
        for a in actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:  # noqa: BLE001 - already dead
                pass
        refs.clear()
        actors.clear()

    try:
        if schedule != "none":
            chaos.inject_many(build_schedule(rng, schedule))
        refs: List[Any] = []
        actors: List[Any] = []
        workload(refs, actors)
        resolve_and_release(refs, actors)
        del refs, actors
        gc.collect()
        leaks, final = quiesce_check(quiesce_timeout_s, allow_orphans,
                                     anomaly_baseline)
        report["violations"].extend(leaks)
        report["final_anomalies"] = _effective_anomalies(
            final, anomaly_baseline)
    finally:
        try:
            chaos.clear()
        except Exception:  # noqa: BLE001 - cluster already down
            pass
        ray_tpu_torch.shutdown()

    report["duration_s"] = round(time.monotonic() - t_start, 2)
    report["ops"] = dict(report["ops"])
    report["tolerated_errors"] = dict(report["tolerated_errors"])
    report["ok"] = not report["violations"]
    return report


# ---------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="seeded chaos-fuzz harness for the ownership "
                    "protocol (any violation reproduces from --seed)")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seeds", type=int, default=1,
                    help="sweep this many consecutive seeds")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--schedule", choices=SCHEDULES, default="mixed")
    ap.add_argument("--check-every", type=int, default=50)
    ap.add_argument("--num-cpus", type=int, default=2)
    ap.add_argument("--quiesce-timeout", type=float, default=25.0)
    ap.add_argument("--format", choices=("text", "json"),
                    default="text")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    reports = []
    for seed in range(args.seed, args.seed + args.seeds):
        report = run_fuzz(seed, steps=args.steps,
                          schedule=args.schedule,
                          check_every=args.check_every,
                          num_cpus=args.num_cpus,
                          quiesce_timeout_s=args.quiesce_timeout,
                          verbose=args.verbose)
        reports.append(report)
        if args.format == "text":
            status = "OK" if report["ok"] else "VIOLATIONS"
            print(f"seed {seed} [{args.schedule} x{args.steps}]: "
                  f"{status} in {report['duration_s']}s "
                  f"(checks={report['checks']}, tolerated="
                  f"{sum(report['tolerated_errors'].values())})")
            for v in report["violations"]:
                print(f"  !! {v}")
    if args.format == "json":
        print(json.dumps(reports if args.seeds > 1 else reports[0],
                         default=str))
    bad = [r for r in reports if not r["ok"]]
    if bad and args.format == "text":
        print(f"\n{len(bad)}/{len(reports)} seed(s) violated "
              f"invariants; reproduce with --seed "
              f"{bad[0]['seed']} --steps {args.steps} "
              f"--schedule {args.schedule}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
