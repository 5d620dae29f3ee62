"""ObjectRef -> asyncio bridge: await task results without per-request
threads.

The threading proxy parked one handler thread per request in
`ray_tpu_torch.get` — its thread pool was the throughput ceiling (VERDICT
Weak §8). Here the core worker's completion callback
(`CoreWorker.add_done_callback`, PR-12) wakes the proxy's event loop
instead: the event loop never blocks on remote work, and a node's whole
ingress runs on ONE loop thread plus a small bounded submit pool for
the handle's (blocking) routing calls.

reference parity: serve/_private/proxy.py drives handles through
asyncio natively; this bridge is the equivalent seam for a sync core
worker API.
"""

from __future__ import annotations

import asyncio
from typing import Any, Optional


async def await_ref(ref: Any, loop: asyncio.AbstractEventLoop,
                    timeout: Optional[float] = None) -> None:
    """Block THIS COROUTINE (never the loop) until `ref` resolves.

    Raises asyncio.TimeoutError past `timeout`. Resolution includes
    error results — the subsequent materialize surfaces them."""
    from ray_tpu_torch._private import worker as worker_mod
    fut: "asyncio.Future" = loop.create_future()

    def _done() -> None:  # fires on a completion-handling thread
        try:
            loop.call_soon_threadsafe(_resolve)
        except RuntimeError:  # loop already closed (proxy stopping)
            pass

    def _resolve() -> None:
        if not fut.done():
            fut.set_result(None)

    cw = worker_mod.global_worker().core_worker
    start = loop.time()
    cw.add_done_callback(ref, _done)
    await asyncio.wait_for(fut, timeout)
    # budget enforced on wake, not just by the timer: when a loaded
    # box stalls the loop past BOTH the timeout timer and the result's
    # call_soon_threadsafe, the resolve callback is queued first and
    # wait_for reports success for a request that blew its deadline —
    # the caller (e.g. the ingress 504 path) must still see a timeout
    if timeout is not None and loop.time() - start > timeout:
        raise asyncio.TimeoutError
