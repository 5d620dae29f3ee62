"""Chaos plane: deterministic, targeted fault injection.

reference parity: asio_chaos.cc (randomized handler delays behind
RAY_testing_asio_delay_us) generalized into a cluster-wide policy the
way the reference's NodeKillerActor / test_utils kill helpers are used —
but as a first-class control-plane object instead of ad-hoc test code.

A ChaosPolicy is an ordered list of ChaosRule records hosted by the GCS
and distributed to every process over the existing pubsub ("chaos"
channel). Each rule is fault x selector x trigger:

    fault     delay | drop_connection | partition | kill_worker |
              error | evict_object | stall_worker
    selector  RPC-method glob, node id (hex prefix), node pair
              (partition), actor class glob, object id glob
    trigger   seeded probability, after-N-matching-calls counter,
              max-fires cap (max_fires=1 == one-shot)

Every process consults its local copy at cheap hook points:

    rpc client call      drop_connection, partition
    rpc server dispatch  delay, kill_worker, stall_worker
    store create/get/pull  error, evict_object

`stall_worker` is the hung-collective fault (ISSUE 17): SIGSTOP a
matching worker for delay_ms, then SIGCONT it — every thread freezes
(heartbeat sidecars included), which is exactly what a wedged XLA
collective looks like from the outside. It is NODE-MANAGER-ACTUATED
ONLY: a stopped process cannot resume itself, so the worker self-fault
path that kill_worker has does not exist here; rules fire on NM
dispatch (method="nm_*" — harvest RPCs arrive every couple of
seconds) via the stall actuator, with the same record-after-confirm +
refund-on-miss accounting as daemon kills.

Counters and seeded RNG streams are PER PROCESS (each process draws the
same seeded stream, like the reference asio randomization), so a
counter-triggered rule is deterministic for the process it targets.
`evict_object` honors the store's reader leases: a leased object (a
zero-copy view is outstanding — see object_store.py pin/unpin) has its
eviction DEFERRED to the last unpin instead of rewriting memory under a
live array; the fire is still recorded when the rule triggers.
Every fire increments a prometheus counter, is reported to the GCS
(which aggregates fired counts, emits a CHAOS_FAULT_INJECTED cluster
event, and disables the rule cluster-wide once max_fires is reached).
"""

from __future__ import annotations

import fnmatch
import logging
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple
from ray_tpu_torch.util.locks import TracedLock

logger = logging.getLogger(__name__)

FAULT_TYPES = ("delay", "drop_connection", "partition", "kill_worker",
               "error", "evict_object", "stall_worker")

# Chaos control-plane traffic is never itself a chaos target (a drop rule
# matching "*" must not sever the channel that could clear it).
_EXEMPT_PREFIXES = ("chaos_", "cw_pubsub_push", "add_events", "subscribe")


@dataclass
class ChaosRule:
    """One injection rule. See module docstring for semantics."""

    fault: str
    rule_id: str = ""
    # ---- target selectors (empty = match anything) -------------------
    method: str = "*"            # RPC method / store op glob
    node_id: str = ""            # node id hex prefix (peer/local node)
    nodes: Tuple[str, str] = ("", "")  # partition pair (hex prefixes)
    actor_class: str = ""        # actor class glob (kill_worker)
    object_glob: str = ""        # object id glob (store faults)
    # ---- trigger -----------------------------------------------------
    probability: float = 1.0     # seeded probability per matching call
    seed: int = 0                # RNG seed (same stream in every process)
    after_n: int = 0             # skip the first N matching calls
    max_fires: int = -1          # per-process cap; 1 == one-shot; -1 inf
    # ---- fault parameters --------------------------------------------
    delay_ms: float = 0.0        # delay: sleep this long on fire
    jitter: bool = False         # delay: uniform(0, delay_ms) instead
    error_message: str = ""      # error: message of the injected error
    # ---- filled in by the GCS at install time ------------------------
    # node id hex -> [(host, port), ...] of that node's RPC endpoints
    # (node manager + object store), for partition/peer matching.
    node_addrs: Dict[str, List[Tuple[str, int]]] = field(
        default_factory=dict)
    disabled: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return {
            "fault": self.fault, "rule_id": self.rule_id,
            "method": self.method, "node_id": self.node_id,
            "nodes": tuple(self.nodes), "actor_class": self.actor_class,
            "object_glob": self.object_glob,
            "probability": self.probability, "seed": self.seed,
            "after_n": self.after_n, "max_fires": self.max_fires,
            "delay_ms": self.delay_ms, "jitter": self.jitter,
            "error_message": self.error_message,
            "node_addrs": {k: [tuple(a) for a in v]
                           for k, v in self.node_addrs.items()},
            "disabled": self.disabled,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ChaosRule":
        d = dict(d)
        d["nodes"] = tuple(d.get("nodes") or ("", ""))
        d["node_addrs"] = {k: [tuple(a) for a in v]
                           for k, v in (d.get("node_addrs") or {}).items()}
        known = {f for f in cls.__dataclass_fields__}  # tolerate newer
        return cls(**{k: v for k, v in d.items() if k in known})


class ChaosError(Exception):
    """Injected by an `error` rule (store ops). Distinct type so tests
    and logs can tell injected faults from organic ones."""


@dataclass
class _RuleState:
    """Per-process trigger state for one rule."""

    rule: ChaosRule
    matches: int = 0
    fires: int = 0
    rng: random.Random = None  # type: ignore[assignment]
    # precomputed partition sides: addresses of each node-pair side
    side_a: frozenset = frozenset()
    side_b: frozenset = frozenset()
    peer_addrs: frozenset = frozenset()  # node_id selector -> its addrs

    def __post_init__(self) -> None:
        self.rng = random.Random(self.rule.seed)
        a, b = self.rule.nodes
        self.side_a = frozenset(
            addr for hexid, addrs in self.rule.node_addrs.items()
            if a and hexid.startswith(a) for addr in addrs)
        self.side_b = frozenset(
            addr for hexid, addrs in self.rule.node_addrs.items()
            if b and hexid.startswith(b) for addr in addrs)
        self.peer_addrs = frozenset(
            addr for hexid, addrs in self.rule.node_addrs.items()
            if self.rule.node_id and hexid.startswith(self.rule.node_id)
            for addr in addrs)


class ChaosClient:
    """Per-process view of the cluster ChaosPolicy + local trigger state.

    Hook entry points are cheap no-ops until a policy with live rules is
    installed (module-level `active` flag, no lock on the fast path).
    """

    def __init__(self) -> None:
        self._lock = TracedLock("chaos")
        self._rules: List[_RuleState] = []
        self._version = -1
        self.active = False
        # process context
        self.node_id: str = ""
        self.actor_class: str = ""
        self.is_worker = False
        self.gcs_address: Optional[Tuple[str, int]] = None
        # NM-registered actuator: fn(actor_class_glob) -> None
        self._kill_actuator: Optional[Callable[[str], None]] = None
        # NM-registered actuator: fn(actor_class_glob, duration_ms) ->
        # bool (SIGSTOP a matching local worker, SIGCONT after duration)
        self._stall_actuator: Optional[Callable[[str, float], bool]] = None
        # worker-registered black-box hook: fn(reason) runs just before
        # a chaos self-kill so the dying process can persist its flight
        # dump (log_plane.write_flight_dump)
        self._predeath_hook: Optional[Callable[[str], Any]] = None
        self._tls = threading.local()
        self._counter = None  # lazy prometheus counter
        self._report_client = None
        self._env_rule_installed = False
        self._install_env_compat_rule()

    # ---- context / wiring -------------------------------------------

    def set_context(self, *, node_id: str = "", is_worker: bool = False,
                    gcs_address: Optional[Tuple[str, int]] = None) -> None:
        """Record this process's identity. node_id only fills in if not
        already set (first daemon wins: in-process head node and test
        clusters share one process across roles)."""
        with self._lock:
            if node_id and not self.node_id:
                self.node_id = node_id
            if is_worker:
                self.is_worker = True
            if gcs_address is not None and self.gcs_address is None:
                self.gcs_address = tuple(gcs_address)

    def set_actor_class(self, class_name: str) -> None:
        with self._lock:
            self.actor_class = class_name

    def reset(self) -> None:
        """Forget cluster-scoped state (context + distributed rules) so
        a later init against a DIFFERENT cluster starts clean — without
        this, a driver that shut one cluster down would keep matching
        the old cluster's node ids and policy version. The env-var
        compat rule is process-local and survives."""
        with self._lock:
            self.node_id = ""
            self.actor_class = ""
            self.is_worker = False
            self.gcs_address = None
            self._kill_actuator = None
            self._stall_actuator = None
            self._predeath_hook = None
            self._version = -1
            self._rules = [st for st in self._rules
                           if st.rule.rule_id == "env-rpc-delay"]
            self.active = bool(self._rules)
            report_client, self._report_client = self._report_client, None
        if report_client is not None:
            try:
                report_client.close()
            except Exception:  # noqa: BLE001 - old report client; already severed
                pass

    def set_kill_actuator(self, fn: Callable[[str], None]) -> None:
        """Node manager registers how kill_worker rules targeting its
        node take effect (kill a matching local worker process)."""
        with self._lock:
            self._kill_actuator = fn

    def set_stall_actuator(self, fn: Callable[[str, float], bool]) -> None:
        """Node manager registers how stall_worker rules take effect
        (SIGSTOP a matching local worker, SIGCONT after the duration).
        Daemon-side only: a stopped process cannot resume itself."""
        with self._lock:
            self._stall_actuator = fn

    def set_predeath_hook(self, fn: Callable[[str], Any]) -> None:
        """Worker registers its black-box flight-dump writer, run just
        before a self-kill fault exits the process."""
        with self._lock:
            self._predeath_hook = fn

    # ---- policy install ----------------------------------------------

    def _install_env_compat_rule(self) -> None:
        """Compat shim: RAY_TPU_testing_rpc_delay_us(_seed) becomes a
        process-local startup-installed delay rule (deprecated; see
        _private/config.py)."""
        try:
            from ray_tpu_torch._private.config import Config
            max_us = Config.testing_rpc_delay_us
        except Exception:  # noqa: BLE001 - config import must never break rpc
            max_us = 0
        if max_us <= 0:
            return
        seed = os.environ.get("RAY_TPU_testing_rpc_delay_seed")
        rule = ChaosRule(
            fault="delay", rule_id="env-rpc-delay", method="*",
            delay_ms=max_us / 1000.0, jitter=True,
            seed=int(seed) if seed is not None else
            random.randrange(1 << 30))
        self._rules.append(_RuleState(rule))
        self._env_rule_installed = True
        self.active = True

    def install(self, policy: Dict[str, Any]) -> None:
        """Replace the cluster-distributed rules with a new policy
        version; per-rule local counters survive (keyed by rule id) so a
        version bump that merely disables one rule doesn't reset the
        others' deterministic counters."""
        version = int(policy.get("version", 0))
        with self._lock:
            if version <= self._version:
                return
            self._version = version
            prior = {st.rule.rule_id: st for st in self._rules}
            rules: List[_RuleState] = []
            # the env compat rule is local-only: keep it at the front
            env = prior.get("env-rpc-delay")
            if env is not None and self._env_rule_installed:
                rules.append(env)
            for rec in policy.get("rules", []):
                rule = ChaosRule.from_dict(rec)
                if rule.disabled:
                    continue
                st = prior.get(rule.rule_id)
                if st is not None and st.rule.to_dict() == rule.to_dict():
                    # unchanged rule riding a version bump (e.g. a
                    # sibling was disabled): carry counters + rng
                    # position over so its schedule stays deterministic
                    rules.append(st)
                else:
                    # new or RE-INJECTED rule: fresh state, so the
                    # precomputed selector sets match the new content
                    # and its counter/rng schedule starts from zero
                    rules.append(_RuleState(rule))
            self._rules = rules
            self.active = bool(rules)

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [{**st.rule.to_dict(), "matches": st.matches,
                     "fires": st.fires} for st in self._rules]

    # ---- trigger evaluation ------------------------------------------

    def _should_fire(self, st: _RuleState) -> bool:
        """Evaluate a rule's trigger for one matching call. Caller holds
        self._lock."""
        st.matches += 1
        if st.matches <= st.rule.after_n:
            return False
        if 0 <= st.rule.max_fires <= st.fires:
            return False
        if st.rule.probability < 1.0 and \
                st.rng.random() >= st.rule.probability:
            return False
        st.fires += 1
        return True

    def _record_fire(self, st: _RuleState, where: str) -> None:
        """Metrics + audit trail for one fired rule: bump the local
        prometheus counter and (one-way, best-effort) tell the GCS so it
        can aggregate counts, emit the CHAOS_FAULT_INJECTED event, and
        enforce cluster-wide max_fires."""
        rule = st.rule
        logger.warning("chaos: rule %s fired %s at %s",
                       rule.rule_id, rule.fault, where)
        try:
            counter = self._counter
            if counter is None:
                from ray_tpu_torch.util.metrics import Counter
                counter = Counter(
                    "ray_tpu_chaos_faults_injected_total",
                    "chaos faults fired in this process",
                    tag_keys=("fault", "rule_id"))
                self._counter = counter
            counter.inc(tags={"fault": rule.fault,
                              "rule_id": rule.rule_id})
        except Exception:  # noqa: BLE001 - telemetry must never block a fault
            pass
        if self.gcs_address is None:
            return
        try:
            client = self._report_client
            if client is None:
                from ray_tpu_torch._private import rpc as rpc_lib
                client = rpc_lib.RpcClient(self.gcs_address, timeout=5)
                self._report_client = client
            client.send_oneway("chaos_report_fired", rule_id=rule.rule_id,
                               fault=rule.fault, where=where,
                               node_id=self.node_id)
        except Exception:  # noqa: BLE001 - GCS gone; local effect stands
            pass

    def _entered(self) -> bool:
        """Reentrancy guard: hooks triggered while handling a hook (the
        fire-report RPC, actuator kills) must pass through untouched."""
        return getattr(self._tls, "in_hook", False)

    # ---- hook points -------------------------------------------------

    def on_client_call(self, method: str,
                       address: Tuple[str, int]) -> None:
        """RPC client hook: drop_connection + partition faults. Raises
        rpc.ConnectionLost on fire (before anything is sent, so the
        failure is deterministic and not absorbed by send retries)."""
        if not self.active or self._entered() or \
                method.startswith(_EXEMPT_PREFIXES):
            return
        address = tuple(address)
        fired: Optional[_RuleState] = None
        with self._lock:
            for st in self._rules:
                rule = st.rule
                if rule.fault == "drop_connection":
                    if not fnmatch.fnmatchcase(method, rule.method):
                        continue
                    if st.peer_addrs and address not in st.peer_addrs:
                        continue
                elif rule.fault == "partition":
                    if not fnmatch.fnmatchcase(method, rule.method):
                        continue
                    mine, (a, b) = self.node_id, rule.nodes
                    if not mine or not a or not b:
                        continue
                    if mine.startswith(a) and address in st.side_b:
                        pass
                    elif mine.startswith(b) and address in st.side_a:
                        pass
                    else:
                        continue
                else:
                    continue
                if self._should_fire(st):
                    fired = st
                    break
        if fired is None:
            return
        self._tls.in_hook = True
        try:
            self._record_fire(fired, f"client:{method}->{address}")
        finally:
            self._tls.in_hook = False
        from ray_tpu_torch._private import rpc as rpc_lib
        raise rpc_lib.ConnectionLost(
            f"chaos {fired.rule.fault} rule {fired.rule.rule_id} "
            f"dropped {method} to {address}")

    def on_server_dispatch(self, method: str) -> None:
        """RPC server hook: delay + kill_worker + stall_worker faults."""
        if not self.active or self._entered() or \
                method.startswith(_EXEMPT_PREFIXES):
            return
        sleep_s = 0.0
        kill: Optional[_RuleState] = None
        stall: Optional[_RuleState] = None
        fired: List[Tuple[_RuleState, str]] = []
        with self._lock:
            for st in self._rules:
                rule = st.rule
                if rule.fault == "stall_worker" and stall is None:
                    # NM-actuated only (a SIGSTOP'd process cannot
                    # SIGCONT itself): workers never self-stall, and a
                    # daemon without the actuator skips the rule. Like
                    # daemon kills, the fire is recorded only after the
                    # actuator confirms a victim (refunded on a miss).
                    if self.is_worker or self._stall_actuator is None:
                        continue
                    if not fnmatch.fnmatchcase(method, rule.method):
                        continue
                    if rule.node_id and not \
                            self.node_id.startswith(rule.node_id):
                        continue
                    if self._should_fire(st):
                        stall = st
                    continue
                if rule.fault == "delay":
                    if not fnmatch.fnmatchcase(method, rule.method):
                        continue
                    if rule.node_id and not \
                            self.node_id.startswith(rule.node_id):
                        continue
                    if self._should_fire(st):
                        sleep_s += (st.rng.uniform(0, rule.delay_ms)
                                    if rule.jitter else rule.delay_ms) \
                            / 1000.0
                        if rule.rule_id != "env-rpc-delay":
                            fired.append((st, f"server:{method}"))
                elif rule.fault == "kill_worker" and kill is None:
                    if not fnmatch.fnmatchcase(method, rule.method):
                        continue
                    if rule.node_id and not \
                            self.node_id.startswith(rule.node_id):
                        continue
                    if self.is_worker:
                        if rule.actor_class and not (
                                self.actor_class and fnmatch.fnmatchcase(
                                    self.actor_class, rule.actor_class)):
                            continue
                    elif not (self._kill_actuator is not None
                              and rule.node_id):
                        # daemon-side kills need an actuator AND an
                        # explicit node target; anything else is the
                        # worker's own self-kill path
                        continue
                    if self._should_fire(st):
                        kill = st
                        if self.is_worker:
                            fired.append((st, f"server:{method}"))
                        # daemon-side kills record only AFTER the
                        # actuator confirms a victim (below): a no-op
                        # "fire" must not spend a one-shot budget
        self._tls.in_hook = True
        try:
            for st, where in fired:
                self._record_fire(st, where)
        finally:
            self._tls.in_hook = False
        if sleep_s > 0:
            time.sleep(sleep_s)
        if stall is not None:
            self._tls.in_hook = True
            try:
                stalled = bool(self._stall_actuator(
                    stall.rule.actor_class, stall.rule.delay_ms))
            except Exception:  # noqa: BLE001 - actuator crashed
                stalled = False
            finally:
                self._tls.in_hook = False
            if stalled:
                self._tls.in_hook = True
                try:
                    self._record_fire(stall, f"server:{method}")
                finally:
                    self._tls.in_hook = False
            else:
                # refund: no worker matched the selector right now
                with self._lock:
                    if stall.fires > 0:
                        stall.fires -= 1
        if kill is None:
            return
        if self.is_worker:
            # simulate preemption: die hard, mid-dispatch, like a real
            # SIGKILL'd TPU worker — the node manager's death report and
            # the recovery machinery take it from here
            logger.warning("chaos: rule %s killing this worker (%s)",
                           kill.rule.rule_id, self.actor_class or "task")
            try:
                if self._predeath_hook is not None:
                    # persist the span-ring tail + log tail so the node
                    # manager's postmortem bundle can explain this death
                    try:
                        self._predeath_hook(
                            f"chaos rule {kill.rule.rule_id} kill_worker")
                    except Exception:  # noqa: BLE001 - dying anyway
                        pass
                self._flush_report()
            finally:
                os._exit(1)
        else:
            self._tls.in_hook = True
            try:
                killed = bool(self._kill_actuator(kill.rule.actor_class))
            except Exception:  # noqa: BLE001 - actuator crashed
                killed = False
            finally:
                self._tls.in_hook = False
            if killed:
                self._tls.in_hook = True
                try:
                    self._record_fire(kill, f"server:{method}")
                finally:
                    self._tls.in_hook = False
            else:
                # refund the consumed fire: nothing matched the victim
                # selector right now, and the rule must stay armed
                with self._lock:
                    if kill.fires > 0:
                        kill.fires -= 1

    def on_store_op(self, op: str, object_ids: List[str],
                    store: Any) -> None:
        """Object store hook (create/get/pull): error + evict_object."""
        if not self.active or self._entered():
            return
        evict: List[Tuple[_RuleState, str]] = []
        err: Optional[_RuleState] = None
        with self._lock:
            for st in self._rules:
                rule = st.rule
                if rule.fault not in ("error", "evict_object"):
                    continue
                if not fnmatch.fnmatchcase(op, rule.method):
                    continue
                if rule.object_glob and not any(
                        fnmatch.fnmatchcase(oid, rule.object_glob)
                        for oid in object_ids):
                    continue
                if not self._should_fire(st):
                    continue
                if rule.fault == "error" and err is None:
                    err = st
                elif rule.fault == "evict_object":
                    evict.append((st, rule.object_glob))
        self._tls.in_hook = True
        try:
            for st, glob in evict:
                self._record_fire(st, f"store:{op}")
                try:
                    store.chaos_evict(glob or None, object_ids)
                except Exception:  # noqa: BLE001 - object already gone
                    pass
            if err is not None:
                self._record_fire(err, f"store:{op}")
        finally:
            self._tls.in_hook = False
        if err is not None:
            raise ChaosError(
                err.rule.error_message
                or f"chaos rule {err.rule.rule_id} failed store op {op}")

    def _flush_report(self) -> None:
        """Best-effort: let the in-flight oneway fire report reach the
        socket before os._exit truncates the process."""
        time.sleep(0.02)


_CLIENT = ChaosClient()


def client() -> ChaosClient:
    return _CLIENT


# Module-level hook wrappers (what rpc.py / object_store.py call).

def on_client_call(method: str, address: Tuple[str, int]) -> None:
    if _CLIENT.active:
        _CLIENT.on_client_call(method, address)


def on_server_dispatch(method: str) -> None:
    if _CLIENT.active:
        _CLIENT.on_server_dispatch(method)


def on_store_op(op: str, object_ids: List[str], store: Any) -> None:
    if _CLIENT.active:
        _CLIENT.on_store_op(op, object_ids, store)


def on_policy_message(message: Any) -> None:
    """Pubsub callback for the "chaos" channel."""
    try:
        _CLIENT.install(dict(message))
    except Exception:  # noqa: BLE001 - malformed policy must not kill pubsub
        logger.exception("bad chaos policy message")


def fetch_policy(gcs_call: Callable[..., Any]) -> None:
    """Pull the current policy at process startup (pubsub only covers
    processes alive at publish time)."""
    try:
        policy = gcs_call("chaos_get_policy")
        if policy:
            _CLIENT.install(policy)
    except Exception:  # noqa: BLE001 - old GCS / unreachable: no chaos
        pass
