"""Minimal asyncio HTTP/1.1 server for the ingress fleet.

The stdlib ships no asyncio HTTP server and the image bakes no
uvicorn/aiohttp, so the fleet carries its own ~150-line HTTP/1.1
subset: request line + headers, Content-Length bodies, keep-alive
(the throughput path — a closed-loop client reuses its connection for
every request), and streaming writes. Exactly what the ingress needs,
nothing more; TLS/chunked-upload/pipelining are out of scope.

Zero-copy streaming: `Response.body` may be bytes OR a memoryview —
large `bytes` deployment results come out of `ray_tpu_torch.get` as views
backed by the PR-3 store envelope (leased, no copy), and `write_to`
slices them straight into `transport.write` in bounded chunks with
back-pressure (`await drain()`) between chunks, so a multi-MB payload
streams without ever being copied into a Python-level response
buffer.
"""

from __future__ import annotations

import asyncio
import logging
import time as _time
from typing import Any, Awaitable, Callable, Dict, Optional

logger = logging.getLogger(__name__)

MAX_HEADER_BYTES = 64 * 1024
MAX_BODY_BYTES = 512 * 1024 * 1024
STREAM_CHUNK = 256 * 1024

REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
           405: "Method Not Allowed", 413: "Payload Too Large",
           500: "Internal Server Error", 503: "Service Unavailable",
           504: "Gateway Timeout", 499: "Client Closed Request"}


class BadRequest(Exception):
    pass


class Request:
    __slots__ = ("method", "path", "headers", "body")

    def __init__(self, method: str, path: str,
                 headers: Dict[str, str], body: bytes):
        self.method = method
        self.path = path
        self.headers = headers  # keys lower-cased
        self.body = body


class Response:
    """status + headers + body (bytes or memoryview for zero-copy
    streaming). Content-Length is always set; the connection stays
    keep-alive unless `close` is set. `on_written(nbytes, write_s,
    error)` — when set — fires after the write attempt (telemetry must
    record write time AND write failures, and only once the entry is
    complete)."""

    __slots__ = ("status", "headers", "body", "close", "on_written")

    def __init__(self, status: int, body: Any = b"",
                 headers: Optional[Dict[str, str]] = None,
                 close: bool = False):
        self.status = status
        self.headers = headers or {}
        self.body = body
        self.close = close
        self.on_written: Optional[Callable] = None

    async def write_to(self, writer: asyncio.StreamWriter) -> int:
        body = self.body
        view = memoryview(body) if not isinstance(body, memoryview) \
            else body
        head = [f"HTTP/1.1 {self.status} "
                f"{REASONS.get(self.status, 'Unknown')}"]
        hdrs = dict(self.headers)
        hdrs.setdefault("Content-Type", "application/json")
        hdrs["Content-Length"] = str(view.nbytes)
        hdrs["Connection"] = "close" if self.close else "keep-alive"
        for k, v in hdrs.items():
            head.append(f"{k}: {v}")
        head.append("\r\n")
        writer.write("\r\n".join(head).encode("latin-1"))
        # bounded chunks with drain between them: back-pressure from a
        # slow client pauses THIS response coroutine, never the loop
        for off in range(0, view.nbytes, STREAM_CHUNK):
            writer.write(view[off:off + STREAM_CHUNK])
            await writer.drain()
        if view.nbytes == 0:
            await writer.drain()
        return view.nbytes


async def read_request(reader: asyncio.StreamReader
                       ) -> Optional[Request]:
    """One request off a keep-alive connection; None on clean EOF
    (client closed between requests). Raises BadRequest on garbage."""
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            return None  # clean close between requests
        raise BadRequest("truncated request head") from e
    except asyncio.LimitOverrunError as e:
        raise BadRequest("oversized request head") from e
    if len(head) > MAX_HEADER_BYTES:
        raise BadRequest("oversized request head")
    try:
        lines = head.decode("latin-1").split("\r\n")
        method, path, _version = lines[0].split(" ", 2)
    except ValueError as e:
        raise BadRequest(f"malformed request line {lines[0]!r}") from e
    headers: Dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        k, _sep, v = line.partition(":")
        headers[k.strip().lower()] = v.strip()
    try:
        n = int(headers.get("content-length", 0))
    except ValueError as e:
        raise BadRequest("bad Content-Length") from e
    if n < 0:
        raise BadRequest("negative Content-Length")
    if n > MAX_BODY_BYTES:
        raise BadRequest(f"body of {n} bytes over the "
                         f"{MAX_BODY_BYTES}-byte cap")
    body = await reader.readexactly(n) if n else b""
    return Request(method.upper(), path, headers, body)


Handler = Callable[[Request], Awaitable[Response]]


class HTTPServer:
    """asyncio HTTP/1.1 server dispatching every request to one async
    handler. `drain()` stops accepting new connections, lets in-flight
    requests finish (keep-alive connections get `Connection: close` on
    their final response), and resolves when the last one is done."""

    def __init__(self, handler: Handler, host: str = "127.0.0.1"):
        self._handler = handler
        self._host = host
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()
        self._inflight = 0
        self._draining = False
        self._idle = asyncio.Event()
        self._idle.set()
        self.port = 0

    async def start(self, port: int) -> int:
        self._server = await asyncio.start_server(
            self._serve_conn, self._host, port,
            limit=MAX_HEADER_BYTES)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def inflight(self) -> int:
        return self._inflight

    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        self._conns.add(writer)
        try:
            while True:
                try:
                    req = await read_request(reader)
                except BadRequest as e:
                    await Response(
                        400, b'{"error": "' +
                        str(e).replace('"', "'").encode() + b'"}',
                        close=True).write_to(writer)
                    return
                if req is None:
                    return
                # in-flight covers handler AND response write: a drain
                # that resolved mid-write would let stop() truncate a
                # response that was already streaming to the client
                self._inflight += 1
                self._idle.clear()
                try:
                    resp = await self._handler(req)
                    if self._draining:
                        # each connection serves out the request it
                        # already carried, then closes: clients
                        # reconnect and land on the replacement proxy
                        # (drain never hangs on a chatty client)
                        resp.close = True
                    t0 = _time.perf_counter()
                    nbytes, write_err = 0, None
                    try:
                        nbytes = await resp.write_to(writer)
                    except (ConnectionError,
                            asyncio.CancelledError) as e:
                        write_err = str(e) or type(e).__name__
                        raise
                    finally:
                        if resp.on_written is not None:
                            try:
                                resp.on_written(
                                    nbytes,
                                    _time.perf_counter() - t0,
                                    write_err)
                            except Exception:  # noqa: BLE001 -
                                # telemetry must never kill the conn
                                logger.exception(
                                    "on_written callback failed")
                finally:
                    self._inflight -= 1
                    if self._inflight == 0:
                        self._idle.set()
                if resp.close:
                    return
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # client went away; per-request accounting already done
        finally:
            self._conns.discard(writer)
            try:
                writer.close()
            except Exception:  # noqa: BLE001 - transport already gone
                pass

    async def drain(self, timeout_s: float) -> bool:
        """Stop accepting, finish in-flight; True if fully drained
        within `timeout_s`."""
        self._draining = True
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        try:
            await asyncio.wait_for(self._idle.wait(), timeout_s)
            return True
        except asyncio.TimeoutError:
            return False

    async def stop(self) -> None:
        if not self._draining and self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        for w in list(self._conns):
            try:
                w.close()
            except Exception:  # noqa: BLE001 - transport already gone
                pass
        self._conns.clear()
