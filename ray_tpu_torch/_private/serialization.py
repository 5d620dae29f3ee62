"""Serialization: cloudpickle for code, pickle5 + out-of-band buffers for data.

reference parity: python/ray/_private/serialization.py (SerializationContext).
Values are serialized to a (meta, buffers) envelope so large numpy/jax arrays
travel as raw buffers that can land in (and be read zero-copy out of) the
shared-memory object store.

Envelope layout (the on-shm format of a stored object):

    u32 meta_len | u32 nbuf                      -- 8-byte fixed header
    (u64 buf_offset | u64 buf_len) * nbuf        -- buffer table
    meta bytes                                   -- pickle stream (in-band)
    ...padding...                                -- to 64-byte alignment
    buffer payloads at their table offsets       -- each 64-byte aligned

Offsets are absolute from the envelope start. Because the arena allocator
hands out 64-byte-aligned blocks and maps the arena at a page boundary,
aligned-relative means aligned-absolute: zero-copy numpy views over the
buffers are SIMD/cacheline aligned. Writers size the envelope with
plan_envelope() and scatter-write it straight into the destination
(`store.create` view) with write_envelope() — one copy from the source
arrays into shm, no intermediate joined blob. Readers (`unpack`) slice
buffer views out of the envelope without copying.
"""

from __future__ import annotations

import io
import itertools
import pickle
import struct
from typing import Any, List, Sequence, Tuple

import cloudpickle

from ray_tpu_torch._private import spans as _spans

try:
    import numpy as _np
except Exception:  # noqa: BLE001 - numpy-less env: slower copies only
    _np = None

_HDR = struct.Struct(">II")      # meta_len, nbuf
_BUF = struct.Struct(">QQ")      # offset, length (per buffer)
BUFFER_ALIGN = 64
# numpy's copy loop moves large buffers into the shm mapping ~3x faster
# than memoryview slice assignment on this class of box; below this size
# the frombuffer setup costs more than it saves
_NP_COPY_MIN = 1 << 14
# Envelope spans only for payloads big enough to be worth measuring —
# tiny inline envelopes (task args) would pay more to be measured than
# to be processed.
_SPAN_MIN_BYTES = 1 << 16
# Both envelope spans are edge-sampled (Dapper): they sit INSIDE the
# always-on cw.store_value / cw.get umbrella spans, and a recorder call
# next to a MB-scale copy runs with a cold cache (~10µs, not the ~2µs
# tight-loop cost), which would alone break the <1% put-path budget.
# One in K still shows the serialize-vs-copy split, scaled by the rate.
_WRITE_SAMPLE_K = 16
_READ_SAMPLE_K = 32
_write_tick = itertools.count()
_read_tick = itertools.count()


_mp_main_registered: set = set()


def _ensure_mp_main_by_value() -> None:
    """multiprocessing-spawn drivers load the user script as
    `__mp_main__` (aliased to `__main__` only inside spawn CHILDREN):
    cloudpickle special-cases just `__main__` as unimportable, so
    without this registration it pickles `__mp_main__` functions BY
    REFERENCE — and workers, whose `__main__` is worker_main and which
    have no `__mp_main__` at all, cannot resolve the reference."""
    import sys
    mod = sys.modules.get("__mp_main__")
    if mod is None or id(mod) in _mp_main_registered:
        return
    try:
        cloudpickle.register_pickle_by_value(mod)
    except Exception:  # noqa: BLE001 - odd module shape; fall through
        return
    _mp_main_registered.add(id(mod))


def dumps_function(fn: Any) -> bytes:
    """Serialize a function/class by value (for export to the GCS fn table)."""
    _ensure_mp_main_by_value()
    return cloudpickle.dumps(fn)


def loads_function(blob: bytes) -> Any:
    return cloudpickle.loads(blob)


def serialize(value: Any) -> Tuple[bytes, List[pickle.PickleBuffer]]:
    """pickle5 with out-of-band buffers; cloudpickle where it matters.

    Plain pickle serializes driver-script (__main__) functions *by
    reference* without error, and the reference breaks only at
    deserialization time inside a worker whose __main__ is worker_main;
    CloudPickler pickles unimportable objects (closures, __main__
    functions, lambdas) by value. But CloudPickler construction costs
    ~25µs per call — real money on the task-submission hot path where
    args are almost always plain data. So: plain C pickler first, and
    fall back to cloudpickle when it fails OR when the blob contains a
    by-reference __main__ marker (a string arg merely containing
    "__main__" just pays the cloudpickle price — safe, not wrong).
    """
    buffers: List[pickle.PickleBuffer] = []
    try:
        blob = pickle.dumps(value, protocol=5,
                            buffer_callback=buffers.append)
        # __mp_main__ is __main__'s alias under multiprocessing-spawn
        # drivers (and NOT a substring of "__main__", so it needs its
        # own check): a by-reference __mp_main__ function deserializes
        # only in processes spawned from the same parent — workers
        # aren't, so such blobs must route through cloudpickle too.
        if b"__main__" not in blob and b"__mp_main__" not in blob:
            return b"P" + blob, buffers
    except Exception:  # noqa: BLE001 — unpicklable by plain pickle
        pass
    buffers = []
    _ensure_mp_main_by_value()
    f = io.BytesIO()
    cloudpickle.CloudPickler(
        f, protocol=5, buffer_callback=buffers.append).dump(value)
    return b"C" + f.getvalue(), buffers


def deserialize(meta: Any, buffers: List[Any]) -> Any:
    tag = bytes(meta[:1])
    if tag in (b"P", b"C"):
        return pickle.loads(meta[1:], buffers=buffers)
    raise ValueError(f"bad serialization tag {tag!r}")


def raw_buffers(buffers: Sequence[pickle.PickleBuffer]) -> List[memoryview]:
    """Flat C-contiguous views of the out-of-band buffers (raw() raises
    on non-contiguous data, but pickle5 only emits contiguous ones)."""
    return [b.raw() for b in buffers]


def plan_envelope(meta: bytes, raws: Sequence[memoryview]
                  ) -> Tuple[int, List[int]]:
    """(total envelope size, per-buffer offsets) for write_envelope.

    Computing the size up front lets the writer allocate the destination
    (shm block or bytearray) exactly once and scatter the parts in.
    """
    off = _HDR.size + _BUF.size * len(raws) + len(meta)
    offsets: List[int] = []
    for r in raws:
        off = (off + BUFFER_ALIGN - 1) & ~(BUFFER_ALIGN - 1)
        offsets.append(off)
        off += r.nbytes
    return off, offsets


def write_envelope(dest: Any, meta: bytes, raws: Sequence[memoryview],
                   offsets: Sequence[int]) -> None:
    """Scatter-write header + meta + buffers into `dest` (a writable
    bytes-like of plan_envelope() size): each source buffer is copied
    exactly once, directly to its final (aligned) location."""
    sampled = (len(dest) >= _SPAN_MIN_BYTES
               and next(_write_tick) % _WRITE_SAMPLE_K == 0)
    with _spans.span("envelope.write", bytes=len(dest),
                     sampled=_WRITE_SAMPLE_K) if sampled else _spans.NOOP:
        _HDR.pack_into(dest, 0, len(meta), len(raws))
        pos = _HDR.size
        for off, r in zip(offsets, raws):
            _BUF.pack_into(dest, pos, off, r.nbytes)
            pos += _BUF.size
        dest[pos:pos + len(meta)] = meta
        np_dest = None
        for off, r in zip(offsets, raws):
            n = r.nbytes
            if _np is not None and n >= _NP_COPY_MIN:
                if np_dest is None:
                    np_dest = _np.frombuffer(dest, dtype=_np.uint8)
                _np.copyto(np_dest[off:off + n],
                           _np.frombuffer(r, dtype=_np.uint8))
            else:
                dest[off:off + n] = r


def pack(value: Any) -> bytes:
    """Serialize into one contiguous envelope blob (inline objects, task
    args — payloads that travel in-band over RPC rather than through
    the shm store)."""
    meta, buffers = serialize(value)
    raws = raw_buffers(buffers)
    total, offsets = plan_envelope(meta, raws)
    out = bytearray(total)
    write_envelope(out, meta, raws, offsets)
    return bytes(out)


def unpack(buf: memoryview) -> Any:
    """Zero-copy deserialize from an envelope (buffers view into `buf`)."""
    sampled = (len(buf) >= _SPAN_MIN_BYTES
               and next(_read_tick) % _READ_SAMPLE_K == 0)
    with _spans.span("envelope.read", bytes=len(buf),
                     sampled=_READ_SAMPLE_K) if sampled else _spans.NOOP:
        meta_len, nbuf = _HDR.unpack_from(buf, 0)
        pos = _HDR.size
        buffers = []
        for _ in range(nbuf):
            off, blen = _BUF.unpack_from(buf, pos)
            pos += _BUF.size
            buffers.append(buf[off:off + blen])
        meta = buf[pos:pos + meta_len]
        return deserialize(meta, buffers)
