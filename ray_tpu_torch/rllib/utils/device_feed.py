"""Double-buffered host-to-device batch feed for the learner.

The port's counterpart of ray_tpu/rllib/utils/device_feed.py (reference
parity: SURVEY.md §7.3 names "EnvRunner→Learner throughput" a hard part;
the reference keeps its GPU fed with torch pinned-memory prefetch inside
the learner). HostStage packs each train batch into reusable per-dtype
host segments, pinned when the learner is on the card; DeviceFeed ships
them on a feeder thread, one non_blocking copy a segment on a side CUDA
stream, while the card runs the previous update, and carves the columns
back out of the device segments as views (no copy, no kernel). The
learner's device picks the route: a CUDA learner gets pinned slots and
the side stream, a CPU learner plain host tensors. A failed pin or copy
raises; nothing falls back to pageable memory. Residual blocking time is
accounted so runs report an honest feed-stall %, and the copied-bytes
counter + transfer-time histogram (`ray_tpu_transport_*`) make
`feed_xfer_stall_pct` attributable.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch._private import spans as _spans

# transfers in flight (double buffering): enough to hide the copy behind
# an update, few enough not to pile batches up on the card
_DEPTH = 2


def _feed_metrics():
    from ray_tpu_torch.util.metrics import Counter, Histogram, get_or_create
    counter = get_or_create(
        Counter, "ray_tpu_transport_feed_bytes_total",
        description="host->device bytes shipped by DeviceFeed")
    hist = get_or_create(
        Histogram, "ray_tpu_transport_feed_xfer_seconds",
        description="host->device transfer time per batch (seconds)",
        boundaries=[0.0005, 0.002, 0.01, 0.05, 0.2, 1.0, 5.0])
    return counter, hist


def _torch_dtype(name: str) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np.dtype(name))).dtype


class StagedBatch:
    """One train batch packed into per-dtype contiguous host segments.

    `segments` maps dtype name -> 1-D CPU tensor holding every column of
    that dtype back to back; `layout` maps column key -> (dtype_name,
    offset_elems, n_elems, shape). The feed ships the segments (a handful
    of copies regardless of column count) and carves the columns out of
    them on the device.
    """

    __slots__ = ("segments", "layout", "_release_cb")

    def __init__(self, segments: Dict[str, torch.Tensor],
                 layout: Dict[str, Tuple[str, int, int, Tuple[int, ...]]],
                 release_cb=None):
        self.segments = segments
        self.layout = layout
        self._release_cb = release_cb

    @property
    def nbytes(self) -> int:
        return sum(s.numel() * s.element_size()
                   for s in self.segments.values())

    def as_dict(self) -> Dict[str, np.ndarray]:
        """Host-side column views into the staging segments, as numpy
        (valid until release()): the path with no local learner ships
        them through the object store."""
        return {k: self.segments[dt].numpy()[off:off + n].reshape(shape)
                for k, (dt, off, n, shape) in self.layout.items()}

    def release(self) -> None:
        """Hand the staging slot back to its HostStage for reuse. Call
        only when the segments' contents are no longer referenced (the
        copy landed)."""
        cb, self._release_cb = self._release_cb, None
        if cb is not None:
            cb()


class HostStage:
    """Pool of reusable per-dtype staging buffers.

    assemble() copies a list of same-structure fragments into ONE
    contiguous buffer per dtype — the copy that np.concatenate would do
    anyway, but into preallocated memory that is reused batch after
    batch (steady state: zero allocations on the trajectory hot path).
    Slots cycle through a bounded free list; if consumers fall behind
    the pool grows a fresh slot rather than deadlocking. On a CUDA
    consumer every segment is pinned (page-locked), so its copy to the
    card is one DMA that need not wait for the host.
    """

    def __init__(self, slots: int, device):
        self._slots = max(1, slots)
        self._pin = torch.device(device).type == "cuda"
        self._free: "queue.Queue[Dict[str, torch.Tensor]]" = queue.Queue()
        for _ in range(self._slots):
            self._free.put({})
        # segments allocated (grown or made larger) since construction;
        # constant once every slot has seen the batch's sizes
        self.segments_allocated = 0

    def _acquire(self) -> Dict[str, torch.Tensor]:
        try:
            return self._free.get_nowait()
        except queue.Empty:
            # all slots in flight (consumer stalled): grow immediately
            # rather than blocking the trajectory assembly hot path
            return {}

    def _release(self, segments: Dict[str, torch.Tensor]) -> None:
        # drop oversized pools silently (the grown slot replaces a lost one)
        if self._free.qsize() < self._slots:
            self._free.put(segments)

    def assemble(self, frags: Sequence[Dict[str, np.ndarray]],
                 axis_for) -> StagedBatch:
        """Stack same-structure fragments along axis_for(key) into a
        StagedBatch backed by a pooled slot."""
        with _spans.span("feed.stage", nfrags=len(frags)) as _sp:
            sb = self._assemble_impl(frags, axis_for)
            _sp["bytes"] = sb.nbytes
            return sb

    def _assemble_impl(self, frags: Sequence[Dict[str, np.ndarray]],
                       axis_for) -> StagedBatch:
        keys = list(frags[0].keys())
        plans: List[Tuple[str, str, int, Tuple[int, ...], int]] = []
        totals: Dict[str, int] = {}
        for k in keys:
            axis = axis_for(k)
            parts = [np.asarray(f[k]) for f in frags]
            shape = list(parts[0].shape)
            shape[axis] = sum(p.shape[axis] for p in parts)
            n = int(np.prod(shape))
            dt = parts[0].dtype.name
            plans.append((k, dt, totals.get(dt, 0), tuple(shape), axis))
            totals[dt] = totals.get(dt, 0) + n
        slot = self._acquire()
        try:
            # the slot keeps whole buffers; the batch sees their used
            # prefix, so a feed ships only the batch's bytes
            segments: Dict[str, torch.Tensor] = {}
            for dt, n in totals.items():
                buf = slot.get(dt)
                if buf is None or buf.numel() < n:
                    # pin_memory raises where it cannot pin: no pageable
                    # segment ever reaches a CUDA consumer
                    buf = torch.empty(max(n, 1), dtype=_torch_dtype(dt),
                                      pin_memory=self._pin)
                    self.segments_allocated += 1
                    slot[dt] = buf
                segments[dt] = buf[:n]
            layout: Dict[str, Tuple[str, int, int, Tuple[int, ...]]] = {}
            for k, dt, off, shape, axis in plans:
                n = int(np.prod(shape))
                dest = segments[dt].numpy()[off:off + n].reshape(shape)
                parts = [np.asarray(f[k]) for f in frags]
                if len(parts) == 1:
                    np.copyto(dest, parts[0])
                else:
                    np.concatenate(parts, axis=axis, out=dest)
                layout[k] = (dt, off, n, shape)
        except BaseException:
            # the StagedBatch below takes slot ownership; until then a
            # failed assembly (mismatched frag shape/dtype) must hand
            # the slot back or the stage permanently loses capacity
            self._release(slot)
            raise
        return StagedBatch(segments, layout,
                           release_cb=lambda: self._release(slot))


class DeviceFeed:
    """Pulls (StagedBatch, meta) items from a host queue, eagerly
    dispatches the host→device copy, and hands device-resident column
    dicts to the consumer.

    On a CUDA device each segment crosses in one copy_(non_blocking=True)
    on a side stream; the feeder records an event there and waits for it
    before it recycles the slot (the copy must land first), and get()
    makes the consumer's current stream wait on that event and records
    the segments on that stream, so the caching allocator does not hand
    their memory out while the consumer still reads them. On the CPU the
    segments are cloned (the slot is reused) and the columns are views
    of the clones.

    Stall accounting (all in seconds, monotonically increasing):
      - wait_s: total consumer time blocked in get() — includes upstream
        sample starvation, i.e. the true EnvRunner→Learner gap.
      - xfer_s: the part of wait_s spent after a batch was dequeued,
        ordering the consumer's stream after its copy.
      - busy_s: consumer-reported compute time (add via add_busy).
    """

    def __init__(self, host_queue: "queue.Queue", device,
                 stop_event: Optional[threading.Event] = None,
                 stall_bucket: str = "feed_stall"):
        self._host = host_queue
        # goodput bucket the consumer's blocked get() time charges to
        # (replay learners pass "replay_stall")
        self._stall_bucket = stall_bucket
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        if self._cuda and self.device.index is None:
            # "cuda" is the current card: name it, as set_device needs
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self._cuda else None)
        self._out: "queue.Queue" = queue.Queue(maxsize=_DEPTH)
        self._stop = stop_event or threading.Event()
        self._error: Optional[BaseException] = None
        self.wait_s = 0.0
        self.xfer_s = 0.0
        self.busy_s = 0.0
        self.batches = 0
        self.fused_batches = 0
        self.bytes_fed = 0
        # the feeder's seconds in _ship (copy issued to copy landed): the
        # feed's own rate is bytes_fed / ship_s
        self.ship_s = 0.0
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="device-feed")
        self._thread.start()

    # -- fused transfer ------------------------------------------------

    def _ship(self, batch: StagedBatch
              ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor],
                         Optional[torch.cuda.Event]]:
        """Host→device for one batch: (columns, device segments, the
        copy's event on the side stream or None on the CPU)."""
        event = None
        try:
            with _spans.span("feed.ship", bytes=batch.nbytes, fused=True):
                if self._cuda:
                    segs = {}
                    with torch.cuda.stream(self._stream):
                        for dt, seg in sorted(batch.segments.items()):
                            if not seg.is_pinned():
                                raise RuntimeError(
                                    "DeviceFeed: a CUDA feed ships pinned "
                                    f"segments only; {dt} is pageable")
                            dst = torch.empty(seg.shape, dtype=seg.dtype,
                                              device=self.device)
                            dst.copy_(seg, non_blocking=True)
                            segs[dt] = dst
                        event = torch.cuda.Event()
                        event.record(self._stream)
                    # intentional barrier: the copy must land before the
                    # slot is reused
                    event.synchronize()
                else:
                    segs = {dt: seg.clone()
                            for dt, seg in sorted(batch.segments.items())}
            with _spans.span("feed.unfuse"):
                cols = {k: segs[dt].narrow(0, off, n).view(shape)
                        for k, (dt, off, n, shape)
                        in sorted(batch.layout.items())}
        finally:
            # a failed copy must still return the slot to the stage, or
            # the stage loses it
            batch.release()
        self.fused_batches += 1
        return cols, segs, event

    def _run(self) -> None:
        try:
            if self._cuda:
                torch.cuda.set_device(self.device)
            self._feed()
        except BaseException as e:  # noqa: BLE001 - surfaced by get()
            self._error = e

    def _feed(self) -> None:
        counter = hist = None
        while not self._stop.is_set():
            try:
                batch, meta = self._host.get(timeout=0.2)
            except queue.Empty:
                continue
            nbytes = batch.nbytes
            t0 = time.perf_counter()
            shipped = self._ship(batch)
            dt = time.perf_counter() - t0
            self.ship_s += dt
            self.bytes_fed += nbytes
            if counter is None:
                try:
                    counter, hist = _feed_metrics()
                except Exception:  # noqa: BLE001 - metrics best-effort
                    counter, hist = False, False
            if counter:
                counter.inc(nbytes)
                hist.observe(dt)
            while not self._stop.is_set():
                try:
                    self._out.put((shipped, meta), timeout=0.2)
                    break
                except queue.Full:
                    continue

    def get(self, timeout: float = 0.2) -> Tuple[Dict[str, torch.Tensor],
                                                 Any]:
        """Next device-resident batch (a dict of columns); raises
        queue.Empty on timeout, and the feeder's error if it died.
        Starvation (nothing queued — the upstream sampler is the
        bottleneck) and the ordering after the copy both accumulate into
        wait_s; xfer_s isolates the latter."""
        if self._error is not None:
            raise self._error
        t0 = time.perf_counter()
        # feed.wait = consumer blocked on the feed (starvation: upstream
        # sampling is the bottleneck); feed.xfer isolates the tail spent
        # after a batch was dequeued
        from ray_tpu_torch._private import goodput
        with _spans.span("feed.wait") as _sp:
            try:
                (cols, segs, event), meta = self._out.get(timeout=timeout)
            except queue.Empty:
                waited = time.perf_counter() - t0
                self.wait_s += waited
                # starvation is badput on the consumer's ledger even
                # when the get comes back empty
                goodput.charge(self._stall_bucket, waited)
                _sp["empty"] = True
                raise
            t1 = time.perf_counter()
            with _spans.span("feed.xfer"):
                if event is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(event)
                    for seg in segs.values():
                        seg.record_stream(stream)
            t2 = time.perf_counter()
        self.wait_s += t2 - t0
        self.xfer_s += t2 - t1
        goodput.charge(self._stall_bucket, t2 - t0)
        self.batches += 1
        return cols, meta

    def add_busy(self, seconds: float) -> None:
        self.busy_s += seconds

    def stats(self) -> dict:
        total = self.wait_s + self.busy_s
        return {
            "feed_wait_s": self.wait_s,
            "feed_xfer_s": self.xfer_s,
            "learner_busy_s": self.busy_s,
            "feed_stall_pct": (100.0 * self.wait_s / total) if total else 0.0,
            "feed_xfer_stall_pct": (
                100.0 * self.xfer_s / total) if total else 0.0,
            "batches_fed": self.batches,
            "fused_batches": self.fused_batches,
            "feed_bytes": self.bytes_fed,
        }

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)
