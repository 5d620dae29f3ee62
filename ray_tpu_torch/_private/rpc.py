"""Tiny length-prefixed RPC layer over TCP sockets.

TPU-native rebuild of the reference's gRPC control plane (reference:
src/ray/rpc/grpc_server.h, grpc_client.h). The reference wraps gRPC services;
we use a minimal framed-pickle protocol: every process that serves RPCs hosts
an RpcServer with named handlers; clients hold pooled persistent connections.

Wire format: 8-byte big-endian length | pickled (method, kwargs) request,
same framing for the pickled (status, payload) reply.
"""

from __future__ import annotations

import logging
import pickle
import random
import socket
import socketserver
import struct
import threading
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

import itertools

from ray_tpu_torch._private import chaos as chaos_lib
from ray_tpu_torch._private import spans as _spans

_LEN = struct.Struct(">Q")

# Server-handle spans are edge-sampled (Dapper-style): most handlers are
# tens of µs and a per-dispatch record would tax every RPC by ~1%; one
# in K still shows where server time goes, scaled by the rate. Blocking
# ops keep their own always-on spans (store.wait / store.pull).
_SERVER_SPAN_SAMPLE_K = 16
_server_span_tick = itertools.count()


def find_free_port(host: str = "127.0.0.1") -> int:
    """Bind-and-release a port (rendezvous endpoints: jax coordinator,
    torch MASTER_PORT, learner gangs)."""
    sock = socket.socket()
    sock.bind((host, 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


class RpcError(Exception):
    """Remote handler raised; carries the remote traceback string."""


class ConnectionLost(Exception):
    """Peer went away mid-call."""


def _send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 4 << 20))
        if not chunk:
            raise ConnectionLost("socket closed")
        buf += chunk
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> bytes:
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    return _recv_exact(sock, n)


def _chaos_delay() -> None:
    """Compat shim. The randomized handler delay that used to live here
    (reference asio_chaos.cc:29-40, env RAY_TPU_testing_rpc_delay_us) is
    now a startup-installed `delay` rule in the chaos plane
    (_private/chaos.py; the env vars still work but are deprecated —
    see _private/config.py). Kept for callers/tests that invoke the
    delay point directly."""
    chaos_lib.on_server_dispatch("_legacy_delay_hook")


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        server: RpcServer = self.server.rpc_server  # type: ignore[attr-defined]
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # track live connections so stop() can close them — otherwise
        # handler threads outlive the server and keep ANSWERING against
        # the stopped instance (a restarted server on the same port then
        # never sees those clients). The stopping flag closes the race
        # where a connection accepted around stop() registers after the
        # snapshot and lingers anyway.
        with self.server.conn_lock:  # type: ignore[attr-defined]
            if self.server.stopping:  # type: ignore[attr-defined]
                try:
                    sock.close()
                except OSError:
                    pass
                return
            self.server.conns.add(sock)  # type: ignore[attr-defined]
        try:
            while True:
                req = _recv_frame(sock)
                item = pickle.loads(req)
                if len(item) == 3:
                    method, kwargs, oneway = item
                else:
                    (method, kwargs), oneway = item, False
                with _spans.span("rpc.server", method=method,
                                 bytes=len(req),
                                 sampled=_SERVER_SPAN_SAMPLE_K) \
                        if next(_server_span_tick) \
                        % _SERVER_SPAN_SAMPLE_K == 0 else _spans.NOOP:
                    # chaos plane server hook: delay / kill_worker rules
                    # (subsumes the old _chaos_delay env-var injection)
                    chaos_lib.on_server_dispatch(method)
                    try:
                        handler = server.handlers[method]
                    except KeyError:
                        reply = ("err", f"no such rpc method: {method}")
                    else:
                        try:
                            result = handler(**kwargs)
                            reply = ("ok", result)
                        except Exception as e:  # noqa: BLE001 - to caller
                            # Typed propagation: the client re-raises the
                            # real exception class (e.g.
                            # ObjectStoreFullError from a store handler) so
                            # callers can catch specifically; the traceback
                            # string rides along for diagnostics.
                            try:
                                blob = pickle.dumps(e, protocol=5)
                            except Exception:  # noqa: BLE001 - unpicklable
                                blob = None
                            reply = ("err", (blob, traceback.format_exc()))
                    if oneway:
                        # fire-and-forget frame: no reply; surface handler
                        # errors in the server log (callers detect failures
                        # out-of-band — death pubsub, connection loss)
                        if reply[0] == "err":
                            logging.getLogger(__name__).warning(
                                "oneway rpc %s failed: %s", method,
                                reply[1])
                        continue
                    _send_frame(sock, pickle.dumps(reply, protocol=5))
        except (ConnectionLost, ConnectionResetError, BrokenPipeError, OSError):
            return
        finally:
            with self.server.conn_lock:  # type: ignore[attr-defined]
                self.server.conns.discard(sock)  # type: ignore[attr-defined]


class _ThreadingTCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.conns: set = set()
        self.conn_lock = threading.Lock()
        self.stopping = False


class RpcServer:
    """Threaded RPC server; one thread per client connection."""

    def __init__(self, handlers: Dict[str, Callable], host: str = "127.0.0.1",
                 port: int = 0):
        self.handlers = dict(handlers)
        self._server = _ThreadingTCPServer((host, port), _Handler)
        self._server.rpc_server = self  # type: ignore[attr-defined]
        self.address: Tuple[str, int] = self._server.server_address[:2]
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.1},
            daemon=True, name=f"rpc-server-{self.address[1]}")
        self._thread.start()

    def register(self, method: str, fn: Callable) -> None:
        self.handlers[method] = fn

    def stop(self) -> None:
        try:
            self._server.shutdown()
            self._server.server_close()
        except Exception:  # noqa: BLE001 - server already stopped
            pass
        # sever live connections so clients fail over immediately
        # (e.g. to a restarted server on the same port) instead of
        # talking to this zombie's handler threads
        with self._server.conn_lock:
            self._server.stopping = True
            conns = list(self._server.conns)
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass


# Methods safe to RESEND even after a send apparently succeeded (the
# peer may have executed them): reads, pings, and naturally-idempotent
# writes. A send into a dead peer's kernel buffer "succeeds" locally, so
# without this the first call after a server restart always fails.
_IDEMPOTENT_PREFIXES = ("get_", "list_", "kv_get", "kv_keys", "nm_get",
                        "nm_list", "cl_get", "cl_list",
                        # token-keyed add/remove + snapshot reads
                        "wait_graph_",
                        # metrics plane: harvest/exposition/history
                        # reads and last-writer-wins tuning
                        "metrics_")
_IDEMPOTENT_METHODS = frozenset({
    "ping", "nm_ping", "report_resources", "register_node", "subscribe",
    "unsubscribe",
    "next_job_id", "cluster_resources", "available_resources",
    # object-store reads (store_wait is excluded: pin=True takes a
    # lease, and a blind resend would double-count it)
    "store_contains", "store_stats", "store_list", "store_arena_info",
    # metrics-plane snapshot reads (registry reads; samplers only
    # overwrite gauges, so a retried snapshot is harmless)
    "cw_metrics_snapshot", "nm_metrics_snapshot",
    # debug-plane reads (tail-index/postmortem-ring queries)
    "logs_query", "nm_logs_snapshot", "cw_logs_snapshot",
    "postmortem_list", "postmortem_get",
    # memory-plane reads (reference-table/residency snapshots). The
    # profile RPCs are deliberately NOT here: a blind resend of a
    # collect would run a second multi-second sampling window, and
    # cw_profile_snapshot(reset=True) is destructive — a retry after a
    # dropped reply would find the already-handed-over table and
    # silently return an empty profile.
    "memory_collect", "nm_memory_snapshot", "cw_memory_snapshot",
    "nm_profile_workers",
    # ownership-plane reads (RefState/LeaseState + transition-ring
    # snapshots)
    "ownership_collect", "nm_ownership_snapshot",
    "cw_ownership_snapshot",
    # ownership-protocol writes that are duplicate-safe BY DESIGN, so a
    # retry after a sent-but-reply-lost attempt cannot corrupt state:
    # cw_task_done/cw_task_failed dedup on the owner's entry.done (a
    # duplicate settle is a recorded no-op in the lease machine),
    # nm_return_worker releases a lease id at most once. A lost
    # completion report used to strand the task (and its arg pins)
    # forever — the ownership fuzzer's drop schedules hit exactly this.
    "cw_task_done", "cw_task_failed", "nm_return_worker",
    # batched forms of the above: each element dedups exactly like its
    # singleton twin, so replaying a whole batch is as safe as replaying
    # one report. cw_lease_granted_batch rides note_grant's dedup ring;
    # nm_lease_request_batch re-queues under the SAME lease ids only on
    # the client's resend-after-send-failure path (the NM never saw the
    # first copy), and a duplicate grant for an id is dropped by the
    # owner anyway.
    "cw_task_done_batch", "nm_lease_request_batch", "cw_lease_granted_batch",
    # pure read: the borrower's current claim set (anti-entropy sweep)
    "cw_claims",
    # actor-creation push (the NM's only call-form w_push_task): the
    # executor dedups creation specs by task_id, so a resend after a
    # lost reply queues nothing. Without the retry budget, two
    # back-to-back connect failures against a freshly-spawned worker
    # (loaded box, listener backlog) declared the actor dead before it
    # ever ran. Lease-path pushes ride send_oneway and are unaffected.
    "w_push_task",
})


def _is_idempotent(method: str) -> bool:
    return method.startswith(_IDEMPOTENT_PREFIXES) or \
        method in _IDEMPOTENT_METHODS


class RpcClient:
    """Client with one persistent connection, thread-safe via a lock.

    For concurrent calls from many threads use one client per thread or a
    ClientPool; a single in-flight call holds the lock end-to-end (the
    protocol is strictly request/reply per connection).
    """

    def __init__(self, address: Tuple[str, int], timeout: Optional[float] = None):
        self.address = tuple(address)
        self._timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()

    def _connect(self) -> socket.socket:
        # Holding _lock across the connect is this class's CONTRACT:
        # the lock serializes the one request/reply channel, and every
        # caller queued behind it needs the connection up anyway.
        # Concurrency comes from one-client-per-thread / ClientPool.
        sock = socket.create_connection(  # graftlint: disable=RT015
            self.address, timeout=self._timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    # Reconnect-retry budget for idempotent control-plane calls: a
    # transient drop (server restart, chaos drop_connection on the peer,
    # GC pause) must not cascade into OwnerDiedError/ConnectionLost at
    # the caller. Capped exponential backoff with full jitter; the first
    # retry is immediate (the common case is a stale pooled connection).
    IDEMPOTENT_RETRIES = 4
    _BACKOFF_BASE_S = 0.05
    _BACKOFF_CAP_S = 1.0

    def call(self, method: str, **kwargs: Any) -> Any:
        payload = pickle.dumps((method, kwargs), protocol=5)
        # always-on span via the cheap begin/end pair; covers lock wait
        # + send + recv — the latency the CALLER observes (lock
        # contention on a shared client is real stall)
        _t0 = _spans.begin()
        try:
            return self._call_locked(method, payload)
        finally:
            _spans.end("rpc.client", _t0, method=method,
                       bytes=len(payload))

    def _call_locked(self, method: str, payload: bytes) -> Any:
        idempotent = _is_idempotent(method)
        max_attempts = 1 + (self.IDEMPOTENT_RETRIES if idempotent else 1)
        with self._lock:
            for attempt in range(max_attempts):
                sent = False
                try:
                    # chaos plane client hook: drop_connection /
                    # partition rules raise ConnectionLost here, before
                    # anything is sent — each retry attempt re-consults
                    # the policy, so an injected drop behaves exactly
                    # like a real broken socket (retried with backoff
                    # for idempotent methods, surfaced otherwise)
                    chaos_lib.on_client_call(method, self.address)
                    if self._sock is None:
                        self._sock = self._connect()
                    _send_frame(self._sock, payload)
                    sent = True
                    reply = _recv_frame(self._sock)
                    break
                except (ConnectionLost, ConnectionResetError, BrokenPipeError,
                        OSError):
                    self.close_locked()
                    # Retry when the request never left this client
                    # (stale pooled connection / refused connect) OR the
                    # method is idempotent. After a successful send a
                    # non-idempotent handler may have executed —
                    # re-sending would duplicate it.
                    if attempt + 1 >= max_attempts or \
                            (sent and not idempotent):
                        raise ConnectionLost(
                            f"rpc to {self.address} failed: {method}")
                    if attempt >= 1:
                        backoff = min(self._BACKOFF_CAP_S,
                                      self._BACKOFF_BASE_S * (2 ** (attempt - 1)))
                        # backoff keeps the channel lock: the connection
                        # is down, so queued callers could only fail the
                        # same way — sleeping unlocked would just let
                        # them interleave doomed reconnect attempts
                        time.sleep(  # graftlint: disable=RT015
                            backoff * random.uniform(0.5, 1.0))
        status, result = pickle.loads(reply)
        if status != "ok":
            if isinstance(result, tuple) and len(result) == 2:
                blob, tb = result
                if blob is not None:
                    try:
                        remote_exc = pickle.loads(blob)
                    except Exception:  # noqa: BLE001
                        remote_exc = None
                    if remote_exc is not None:
                        raise remote_exc from RpcError(
                            f"remote error from {self.address}.{method}:\n{tb}")
                result = tb
            raise RpcError(f"remote error from {self.address}.{method}:\n{result}")
        return result

    def send_oneway(self, method: str, **kwargs: Any) -> None:
        """Fire-and-forget: the server runs the handler without replying,
        so the caller never blocks on a round trip. Send failures raise
        (full-frame resend on a fresh connection is safe — a partial
        frame on a dead socket was never dispatched); handler errors are
        logged server-side only. Use for pushes whose failure is
        detected out-of-band (actor-death pubsub, worker connection
        loss), never for requests whose reply carries state."""
        payload = pickle.dumps((method, kwargs, True), protocol=5)
        # span only for sends big enough that the kernel copy is worth
        # measuring; tiny fire-and-forget frames (store_register, ref
        # bookkeeping) are visible server-side as rpc.server records
        with _spans.span("rpc.client.oneway", method=method,
                         bytes=len(payload)) \
                if len(payload) >= (1 << 16) else _spans.NOOP, \
                self._lock:
            for attempt in (0, 1):
                try:
                    chaos_lib.on_client_call(method, self.address)
                    if self._sock is None:
                        self._sock = self._connect()
                    _send_frame(self._sock, payload)
                    return
                except (ConnectionLost, ConnectionResetError,
                        BrokenPipeError, OSError):
                    self.close_locked()
                    if attempt == 1:
                        raise ConnectionLost(
                            f"oneway rpc to {self.address} failed: "
                            f"{method}")

    def send_oneways(self, items) -> None:
        """Flush-coalesced fire-and-forget: ship N queued one-way frames
        in ONE sendall. `items` is a list of (method, kwargs) pairs; each
        becomes its own wire frame (the server's frame loop needs no
        change), but the kernel sees a single write — one syscall, one
        TCP segment train, instead of N per-message round trips through
        the socket layer.

        Failure semantics: a send error resends the WHOLE batch on a
        fresh connection, so every element must be duplicate-safe (the
        same contract as retrying an idempotent call). Callers batch
        only methods from the duplicate-safe set (cw_task_done et al) —
        and a batch that fails both attempts raises with NO element
        delivered-or-not knowledge, exactly like a lost singleton
        one-way: the out-of-band failure path (death pubsub, lease
        reclaim) owns recovery for every sibling, not just the first.
        """
        if not items:
            return
        if len(items) == 1:
            method, kwargs = items[0]
            self.send_oneway(method, **kwargs)
            return
        frames = []
        for method, kwargs in items:
            payload = pickle.dumps((method, kwargs, True), protocol=5)
            frames.append(_LEN.pack(len(payload)))
            frames.append(payload)
        blob = b"".join(frames)
        with _spans.span("rpc.client.oneway_batch", n=len(items),
                         bytes=len(blob)) \
                if len(blob) >= (1 << 16) else _spans.NOOP, \
                self._lock:
            for attempt in (0, 1):
                try:
                    chaos_lib.on_client_call(items[0][0], self.address)
                    if self._sock is None:
                        self._sock = self._connect()
                    # the lock IS the per-connection serializer (same
                    # contract as send_oneway/_send_frame): writers
                    # queued behind it would interleave frames on the
                    # shared socket if this moved outside
                    self._sock.sendall(blob)  # graftlint: disable=RT015
                    return
                except (ConnectionLost, ConnectionResetError,
                        BrokenPipeError, OSError):
                    self.close_locked()
                    if attempt == 1:
                        raise ConnectionLost(
                            f"oneway batch ({len(items)} frames) to "
                            f"{self.address} failed")

    def close_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        with self._lock:
            self.close_locked()


class ClientPool:
    """Cache of RpcClients keyed by address."""

    def __init__(self, timeout: Optional[float] = None):
        self._clients: Dict[Tuple[str, int], RpcClient] = {}
        self._lock = threading.Lock()
        self._timeout = timeout

    def get(self, address: Tuple[str, int]) -> RpcClient:
        address = tuple(address)
        with self._lock:
            client = self._clients.get(address)
            if client is None:
                client = RpcClient(address, timeout=self._timeout)
                self._clients[address] = client
            return client

    def invalidate(self, address: Tuple[str, int]) -> None:
        with self._lock:
            client = self._clients.pop(tuple(address), None)
        if client is not None:
            client.close()

    def close_all(self) -> None:
        with self._lock:
            clients = list(self._clients.values())
            self._clients.clear()
        for c in clients:
            c.close()
