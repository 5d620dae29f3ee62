"""ProxyFleetManager: one asyncio ingress proxy per alive node.

reference parity: serve/_private/proxy_state.py (ProxyStateManager):
the controller reconciles the proxy fleet exactly like it reconciles
replicas — one proxy per alive node (NodeAffinity-pinned), periodic
health checks, replacements for dead proxies, and a drain lifecycle
(stop accepting → finish in-flight → deregister → stop) for rolling
updates and node removal.

Runs INSIDE the ServeController actor (its reconcile loop calls
`reconcile()` each period); all state is controller-local, published
to callers via `status()` / the routing long-poll.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

PROXY_NAME_PREFIX = "SERVE_PROXY_FLEET_"
_NAMESPACE = "serve"


@dataclass
class _ProxyState:
    node_id: str
    actor: Any
    http_port: int = 0
    grpc_port: Optional[int] = None
    healthy: bool = False
    consecutive_failures: int = 0
    draining: bool = False
    started_at: float = field(default_factory=time.monotonic)


class ProxyFleetManager:
    """Controller-side fleet reconciliation. Thread-safe for the
    controller's RPC threads + reconcile thread."""

    # consecutive failed pings before a proxy is declared dead and
    # replaced (mirrors gcs health_check_failure_threshold: one slow
    # ping on a loaded box must not churn the ingress)
    FAILURE_THRESHOLD = 3
    PING_TIMEOUT_S = 10.0

    def __init__(self) -> None:
        self._proxies: Dict[str, _ProxyState] = {}
        self._lock = threading.Lock()
        # serializes whole reconcile rounds: the fleet loop and a
        # synchronous start_proxy_fleet call must not race a node's
        # proxy creation (the actor name would bounce via adopt paths)
        self._round_lock = threading.Lock()
        self._enabled = False
        self._http_port = 0
        self._grpc_port: Optional[int] = None
        self._request_timeout_s: Optional[float] = None
        self._version = 0  # bumped on every fleet config change
        # operator-drained nodes (pending removal): reconcile must not
        # resurrect their proxies; cleared by the next ensure()
        self._cordoned: set = set()
        # proxy-start backoff: node_id -> (consecutive failures,
        # monotonic next-retry). A node that can't host a proxy (e.g.
        # fixed port already bound on a shared-host test cluster) must
        # not churn an actor spawn + stack trace every 1s round.
        self._start_backoff: Dict[str, tuple] = {}

    # ---- config -----------------------------------------------------

    def ensure(self, *, http_port: Optional[int] = None,
               grpc_port: Optional[int] = None,
               request_timeout_s: Optional[float] = None) -> None:
        """Turn the fleet on (idempotent). A CHANGED config (new ports
        or timeout) rolls the fleet: each node's proxy is drained and
        replaced on the next reconcile rounds. Every parameter is
        keep-if-None, so arming one knob (say grpc) never rolls the
        others onto new values."""
        with self._lock:
            # compare EFFECTIVE config (defaulted args keep the stored
            # value): serve.start_fleet(grpc_port=9001) after
            # serve.start_http(8000) must not roll HTTP off :8000
            http_keep = self._http_port if http_port is None else \
                http_port
            grpc_keep = self._grpc_port if grpc_port is None else \
                grpc_port
            timeout_keep = self._request_timeout_s \
                if request_timeout_s is None else request_timeout_s
            changed = (self._enabled
                       and (http_keep != self._http_port
                            or grpc_keep != self._grpc_port
                            or timeout_keep != self._request_timeout_s))
            self._enabled = True
            self._http_port = http_keep
            self._grpc_port = grpc_keep
            self._request_timeout_s = timeout_keep
            self._cordoned.clear()  # re-arming lifts node cordons
            if changed:
                self._version += 1
                for st in self._proxies.values():
                    st.draining = True  # rolled on upcoming rounds

    # ---- queries ----------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "enabled": self._enabled,
                "version": self._version,
                "http_port": self._http_port,
                "grpc_port": self._grpc_port,
                "proxies": [
                    {"node_id": nid, "http_port": st.http_port,
                     "grpc_port": st.grpc_port, "healthy": st.healthy,
                     "draining": st.draining,
                     "consecutive_failures": st.consecutive_failures}
                    for nid, st in self._proxies.items()],
            }

    # ---- lifecycle --------------------------------------------------

    def _start_proxy(self, node_id: str,
                     allow_adopt: bool = True) -> Optional[_ProxyState]:
        import ray_tpu_torch
        from ray_tpu_torch.serve._private.proxy_fleet.proxy import (
            AsyncProxyActor)
        from ray_tpu_torch.util.scheduling_strategies import (
            NodeAffinitySchedulingStrategy)
        cls = ray_tpu_torch.remote(AsyncProxyActor)
        name = f"{PROXY_NAME_PREFIX}{node_id[:12]}"
        try:
            actor = cls.options(
                num_cpus=0.05, max_concurrency=4,
                concurrency_groups={"control": 4},
                name=name, namespace=_NAMESPACE,
                scheduling_strategy=NodeAffinitySchedulingStrategy(
                    node_id=node_id, soft=False)).remote(
                http_port=self._http_port, grpc_port=self._grpc_port,
                request_timeout_s=self._request_timeout_s,
                node_id=node_id)
        except ValueError:
            # name taken: a previous-generation proxy is still
            # registered (e.g. user killed the controller mid-roll).
            # The rolling path passes allow_adopt=False — adopting the
            # predecessor it JUST stopped would register a dead
            # listener as healthy; the next round creates cleanly.
            if not allow_adopt:
                return None
            try:
                actor = ray_tpu_torch.get_actor(name, namespace=_NAMESPACE)
                # a stopped/draining predecessor is no adoption target.
                # _round_lock is singleflight BY DESIGN: a whole fleet
                # round (blocking health checks included) must finish
                # before the next begins; only the two reconcile entry
                # points ever contend
                if ray_tpu_torch.get(  # graftlint: disable=RT015
                        actor.ping.remote(),
                        timeout=self.PING_TIMEOUT_S) != "pong":
                    ray_tpu_torch.kill(actor)
                    return None
                # config check: a live registered predecessor may be a
                # condemned zombie (user-killed, the kill not yet
                # delivered) from an OLDER fleet generation — adopting
                # it would serve stale ports/timeouts under the new
                # config. Mismatch → replace, same as a dead ping.
                armed = ray_tpu_torch.get(  # graftlint: disable=RT015
                    actor.armed_config.remote(),
                    timeout=self.PING_TIMEOUT_S)
                if armed != {"http_port": self._http_port,
                             "grpc_port": self._grpc_port,
                             "request_timeout_s":
                                 self._request_timeout_s}:
                    ray_tpu_torch.kill(actor)
                    return None
            except Exception:  # noqa: BLE001 - raced a dying actor
                return None
        except Exception:  # noqa: BLE001 — node vanished mid-start;
            logger.exception("proxy start failed on %s", node_id[:12])
            return None
        st = _ProxyState(node_id=node_id, actor=actor)
        try:
            # singleflight round lock by design (see adopt note above)
            ports = ray_tpu_torch.get(  # graftlint: disable=RT015
                actor.ports.remote(), timeout=60)
            st.http_port = ports["http"]
            st.grpc_port = ports["grpc"]
            st.healthy = True
        except Exception:  # noqa: BLE001 — bind failure / node died:
            # reconcile retries next round
            logger.exception("proxy on %s failed readiness",
                             node_id[:12])
            try:
                ray_tpu_torch.kill(actor)
            except Exception:  # noqa: BLE001 - already dead
                pass
            return None
        logger.info("serve fleet: proxy up on node %s (http:%d, "
                    "request timeout %ss)", node_id[:12], st.http_port,
                    self._request_timeout_s)
        return st

    def _drain_and_stop(self, st: _ProxyState) -> None:
        """Graceful removal: drain (stop accepting, finish in-flight),
        then stop + kill. Runs on the reconcile thread."""
        import ray_tpu_torch
        from ray_tpu_torch._private.config import Config
        try:
            ray_tpu_torch.get(st.actor.drain.remote(),
                        timeout=Config.serve_drain_timeout_s + 15)
        except Exception:  # noqa: BLE001 — already dead / wedged: the
            pass           # kill below is the backstop
        try:
            ray_tpu_torch.get(st.actor.stop.remote(), timeout=15)
        except Exception:  # noqa: BLE001 - stop is best-effort
            pass
        try:
            ray_tpu_torch.kill(st.actor)
        except Exception:  # noqa: BLE001 - already dead
            pass

    def reconcile(self, alive_node_ids: List[str]) -> None:
        """One fleet round: start proxies for uncovered alive nodes,
        drop proxies for dead nodes, health-check the rest, roll
        draining proxies. At most ONE drain-replace per round so a
        config change rolls node-by-node (capacity stays up). Rounds
        are serialized (fleet loop vs synchronous start_proxy_fleet)."""
        with self._round_lock:
            self._reconcile_round(alive_node_ids)

    def _reconcile_round(self, alive_node_ids: List[str]) -> None:
        alive = set(alive_node_ids)
        with self._lock:
            if not self._enabled:
                return
            alive -= self._cordoned  # drained-for-removal stays down
            known = dict(self._proxies)
        # dead nodes: deregister (the actor died with its node)
        for nid in list(known):
            if nid not in alive:
                with self._lock:
                    st = self._proxies.pop(nid, None)
                if st is not None:
                    logger.info("serve fleet: node %s gone, proxy "
                                "deregistered", nid[:12])
                known.pop(nid, None)
        # health checks + at most one rolling replacement per round
        rolled = False
        for nid, st in known.items():
            if st.draining and not rolled:
                rolled = True
                self._drain_and_stop(st)
                with self._lock:
                    self._proxies.pop(nid, None)
                # no adoption here: the name may still be held by the
                # predecessor we just killed — better one round with
                # no proxy than a registered-dead one
                replacement = self._start_proxy(nid, allow_adopt=False)
                if replacement is not None:
                    with self._lock:
                        self._proxies[nid] = replacement
                continue
            health = self._ping(st)
            if health != "ok":
                st.consecutive_failures += (
                    self.FAILURE_THRESHOLD if health == "dead" else 1)
                if st.consecutive_failures >= self.FAILURE_THRESHOLD:
                    logger.warning(
                        "serve fleet: proxy on %s failed %d health "
                        "checks — replacing", nid[:12],
                        st.consecutive_failures)
                    with self._lock:
                        self._proxies.pop(nid, None)
                    try:
                        import ray_tpu_torch
                        ray_tpu_torch.kill(st.actor)
                    except Exception:  # noqa: BLE001 - already dead
                        pass
                    replacement = self._start_proxy(nid)
                    if replacement is not None:
                        with self._lock:
                            self._proxies[nid] = replacement
                else:
                    st.healthy = False
            else:
                st.healthy = True
                st.consecutive_failures = 0
        # uncovered alive nodes (exponential start backoff: a node
        # that can't host a proxy — fixed port already bound on a
        # shared-host cluster — retries at 2s/4s/.../30s, not every
        # round)
        now = time.monotonic()
        for nid in alive - set(known):
            failures, next_retry = self._start_backoff.get(nid, (0, 0.0))
            if now < next_retry:
                continue
            st = self._start_proxy(nid)
            if st is not None:
                self._start_backoff.pop(nid, None)
                with self._lock:
                    self._proxies[nid] = st
            else:
                failures += 1
                self._start_backoff[nid] = (
                    failures, now + min(30.0, 2.0 ** failures))
                if failures == 1:
                    logger.warning(
                        "serve fleet: proxy start failed on %s — "
                        "backing off (see exception above)", nid[:12])
        # backoff records for departed nodes must not accumulate
        self._start_backoff = {k: v for k, v in
                               self._start_backoff.items() if k in alive}

    def _ping(self, st: _ProxyState) -> str:
        """'ok' | 'slow' (counts toward the failure threshold) |
        'dead' (actor is gone — replaced immediately; a user-killed or
        node-crashed proxy must not ride out three rounds of grace)."""
        import ray_tpu_torch
        try:
            # singleflight round lock by design (_reconcile_round)
            ray_tpu_torch.get(  # graftlint: disable=RT015
                st.actor.ping.remote(), timeout=self.PING_TIMEOUT_S)
            return "ok"
        except (ray_tpu_torch.exceptions.RayActorError,
                ray_tpu_torch.exceptions.WorkerCrashedError):
            return "dead"
        except Exception:  # noqa: BLE001 — slow/timeout: grace applies
            return "slow"

    def drain_node(self, node_id: str) -> bool:
        """Operator-initiated drain of one node's proxy (node removal
        path): drain + stop + deregister WITHOUT replacement."""
        with self._lock:
            st = self._proxies.pop(node_id, None)
            self._cordoned.add(node_id)
        if st is None:
            return False
        self._drain_and_stop(st)
        return True

    def stop_all(self) -> None:
        with self._lock:
            states = list(self._proxies.values())
            self._proxies.clear()
            self._enabled = False
        for st in states:
            self._drain_and_stop(st)
