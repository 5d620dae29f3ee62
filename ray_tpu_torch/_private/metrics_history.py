"""Durable tiered time-series store for the GCS metrics plane.

Grows metrics_plane.SeriesHistory's 300-sample in-memory ring into a
crash-safe store that survives GCS restarts and holds hours of history
in bounded space:

  - **raw tier**: every harvested (wall_ts, merged flat series) sample
    at the harvest cadence (~2s), including FORCED rounds (CLI dumps,
    tests) tagged `forced=True` — present in the ring so `ray_tpu top`
    sparklines have no gaps, excluded from rate computation by readers.
  - **downsample tiers** ("30s", "5min"): one sample per aligned window,
    counters as intra-window DELTAS (what actually happened in the
    window — directly chartable as a rate), gauges as [min, mean, max].
    Built online as raw samples arrive; each tier's windows close
    independently.
  - **durability**: per tier, an append-only segment directory
    (`<dir>/<tier>/seg-*.json`). Segments are written
    tmp+fsync+rename — a crash mid-write loses at most the open
    segment's buffered samples, never corrupts an existing one — and
    replayed on construction so the GCS comes back with its
    pre-restart history queryable.
  - **retention**: a byte budget split across tiers (raw half, each
    downsample tier a quarter); oldest segments evicted first. The
    coarse tiers cover long windows in few bytes, so the budget buys
    roughly: minutes raw, hours at 30s, a day at 5min.

Pure data structure — no threads; the caller (MetricsPlane's sampler
round) provides serialization. All disk I/O failures degrade to
in-memory-only operation rather than breaking the harvest.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

# downsample tier name -> window seconds
DOWNSAMPLE_TIERS: Dict[str, float] = {"30s": 30.0, "5min": 300.0}

TIERS: Tuple[str, ...] = ("raw",) + tuple(DOWNSAMPLE_TIERS)


def _series_name(key: str) -> str:
    i = key.find("{")
    return key if i < 0 else key[:i]


class _Downsampler:
    """Online aggregator for one tier: folds raw samples into aligned
    windows, emitting one sample per closed window."""

    def __init__(self, interval_s: float) -> None:
        self.interval_s = interval_s
        self._wid: Optional[int] = None
        # key -> [min, sum, count, max] (gauges) / last value (counters)
        self._gauges: Dict[str, List[float]] = {}
        self._counters: Dict[str, float] = {}
        # key -> last value of the PREVIOUS window (counter delta base)
        self._base: Dict[str, float] = {}
        # key -> first value seen in the current window (fallback base
        # for keys whose previous window never saw them)
        self._first: Dict[str, float] = {}

    def _finalize(self) -> Optional[Tuple[float, Dict[str, Any]]]:
        if self._wid is None:
            return None
        series: Dict[str, Any] = {}
        for key, last in self._counters.items():
            base = self._base.get(key, self._first.get(key, last))
            series[key] = max(0.0, last - base)
        for key, (mn, total, n, mx) in self._gauges.items():
            series[key] = [mn, total / max(1, n), mx]
        ts = (self._wid + 1) * self.interval_s
        self._base = dict(self._counters)
        self._gauges = {}
        self._counters = {}
        self._first = {}
        self._wid = None
        return (ts, series) if series else None

    def add(self, ts: float, series: Dict[str, float],
            is_counter) -> Optional[Tuple[float, Dict[str, Any]]]:
        """Fold one raw sample; returns the closed window's sample when
        `ts` crosses into a new window, else None."""
        wid = int(ts // self.interval_s)
        emitted = None
        if self._wid is not None and wid != self._wid:
            emitted = self._finalize()
        if self._wid is None:
            self._wid = wid
        for key, v in series.items():
            if isinstance(v, (list, tuple)):
                continue  # already-downsampled value (replay artifact)
            if is_counter(key):
                self._first.setdefault(key, float(v))
                self._counters[key] = float(v)
            else:
                agg = self._gauges.get(key)
                if agg is None:
                    self._gauges[key] = [float(v), float(v), 1, float(v)]
                else:
                    agg[0] = min(agg[0], v)
                    agg[1] += v
                    agg[2] += 1
                    agg[3] = max(agg[3], v)
        return emitted


class TieredHistory:
    """Raw + downsampled series history with optional on-disk segments.

    API mirrors (and supersets) metrics_plane.SeriesHistory: `append` /
    `query` keep their shapes so every existing reader (`ray_tpu top`,
    dashboard sparklines, `util.state.metrics_history`) works
    unchanged; `range_query` adds lookback-window reads across tiers
    that reach back through the on-disk segments past the in-memory
    ring.
    """

    def __init__(self, max_samples: int,
                 dir: Optional[str] = None,  # noqa: A002
                 retention_bytes: int = 32 << 20,
                 segment_samples: int = 32) -> None:
        self._max = max(2, int(max_samples))
        self._dir = dir or None
        self._retention = max(1 << 16, int(retention_bytes))
        self._segment_samples = max(1, int(segment_samples))
        self._lock = threading.Lock()
        # tier -> list of samples; raw entries are (ts, series, forced),
        # downsample entries (ts, series)
        self._rings: Dict[str, List[Tuple]] = {t: [] for t in TIERS}
        self._pending: Dict[str, List[Tuple]] = {t: [] for t in TIERS}
        self._down = {name: _Downsampler(iv)
                      for name, iv in DOWNSAMPLE_TIERS.items()}
        self._kinds: Dict[str, str] = {}
        self._seq = 0
        self.write_errors = 0
        self.segments_written = 0
        self.segments_evicted = 0
        if self._dir is not None:
            try:
                for tier in TIERS:
                    os.makedirs(os.path.join(self._dir, tier),
                                exist_ok=True)
                self._replay()
            except Exception:  # noqa: BLE001 - a bad disk must not
                logger.exception(  # keep the metrics plane from starting
                    "metrics history replay failed; starting empty")

    # -- kind resolution ----------------------------------------------

    def _is_counter(self, key: str) -> bool:
        name = _series_name(key)
        kind = self._kinds.get(name)
        if kind is None and (name.endswith("_sum")
                             or name.endswith("_count")):
            base = name.rsplit("_", 1)[0]
            if self._kinds.get(base) == "histogram":
                return True
            kind = self._kinds.get(base)
        if kind is not None:
            return kind in ("counter", "histogram")
        # unknown metric: *_total/_sum/_count is the prometheus counter
        # naming convention this codebase follows throughout
        return name.endswith(("_total", "_sum", "_count"))

    # -- writes --------------------------------------------------------

    def append(self, ts: float, series: Dict[str, float],
               kinds: Optional[Dict[str, str]] = None,
               forced: bool = False) -> None:
        with self._lock:
            if kinds:
                self._kinds.update(kinds)
            self._rings["raw"].append((ts, series, bool(forced)))
            self._pending["raw"].append((ts, series, bool(forced)))
            self._trim_raw_locked()
            for tier, ds in self._down.items():
                emitted = ds.add(ts, series, self._is_counter)
                if emitted is not None:
                    self._rings[tier].append(emitted)
                    del self._rings[tier][:-self._max]
                    self._pending[tier].append(emitted)
            flush_tiers = [t for t, p in self._pending.items()
                           if len(p) >= self._segment_samples]
        for tier in flush_tiers:
            self._flush_tier(tier)

    def _trim_raw_locked(self) -> None:
        """Bound the raw ring: at most max_samples NON-forced samples
        (the retention contract `samples x interval_s` the readers
        assume), and a 2x hard cap on total entries so a forced-dump
        loop can't grow it without bound."""
        ring = self._rings["raw"]
        plain = sum(1 for s in ring if not s[2])
        while ring and (plain > self._max or len(ring) > 2 * self._max):
            if ring[0][2]:
                ring.pop(0)
            else:
                ring.pop(0)
                plain -= 1

    def flush(self) -> None:
        """Write every buffered sample out (shutdown path: the GCS
        flushes before exiting so a restart replays right up to the
        last harvest)."""
        for tier in TIERS:
            self._flush_tier(tier)

    def _flush_tier(self, tier: str) -> None:
        if self._dir is None:
            with self._lock:
                # memory-only mode: pending buffers must not grow
                self._pending[tier] = []
            return
        with self._lock:
            pending, self._pending[tier] = self._pending[tier], []
            if not pending:
                return
            self._seq += 1
            seq = self._seq
        first_ts = pending[0][0]
        payload = {"v": 1, "tier": tier,
                   "samples": [list(s) for s in pending]}
        tdir = os.path.join(self._dir, tier)
        path = os.path.join(
            tdir, f"seg-{int(first_ts * 1000):015d}-{seq:06d}.json")
        try:
            fd, tmp = tempfile.mkstemp(prefix=".seg-", dir=tdir)
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(payload, f, separators=(",", ":"))
                    f.flush()
                    os.fsync(f.fileno())
                os.rename(tmp, path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
            self.segments_written += 1
            self._enforce_retention()
        except Exception:  # noqa: BLE001 - disk trouble degrades to
            # memory-only for this batch; the harvest must not fail
            self.write_errors += 1
            logger.warning("metrics history segment write failed "
                           "(%s)", path, exc_info=True)

    # -- retention -----------------------------------------------------

    def _tier_budget(self, tier: str) -> int:
        return self._retention // 2 if tier == "raw" \
            else self._retention // (2 * len(DOWNSAMPLE_TIERS))

    def _segment_files(self, tier: str) -> List[str]:
        tdir = os.path.join(self._dir, tier)
        try:
            names = [n for n in os.listdir(tdir)
                     if n.startswith("seg-") and n.endswith(".json")]
        except OSError:
            return []
        return [os.path.join(tdir, n) for n in sorted(names)]

    def _enforce_retention(self) -> None:
        for tier in TIERS:
            files = self._segment_files(tier)
            sizes = []
            for p in files:
                try:
                    sizes.append(os.path.getsize(p))
                except OSError:
                    sizes.append(0)
            total = sum(sizes)
            budget = self._tier_budget(tier)
            i = 0
            # never evict the newest segment, whatever its size
            while total > budget and i < len(files) - 1:
                try:
                    os.unlink(files[i])
                    self.segments_evicted += 1
                except OSError:
                    pass
                total -= sizes[i]
                i += 1

    def disk_usage(self) -> int:
        if self._dir is None:
            return 0
        total = 0
        for tier in TIERS:
            for p in self._segment_files(tier):
                try:
                    total += os.path.getsize(p)
                except OSError:
                    pass
        return total

    # -- replay --------------------------------------------------------

    def _replay(self) -> None:
        """Rebuild the in-memory rings from the segment directories.
        Unparsable segments (torn by a crash predating the tmp+rename
        discipline, or hand-edited) are skipped, not fatal."""
        for tier in TIERS:
            samples: List[Tuple] = []
            for path in self._segment_files(tier):
                try:
                    with open(path) as f:
                        payload = json.load(f)
                    for s in payload.get("samples", ()):
                        if tier == "raw":
                            samples.append((float(s[0]), s[1],
                                            bool(s[2]) if len(s) > 2
                                            else False))
                        else:
                            samples.append((float(s[0]), s[1]))
                except Exception:  # noqa: BLE001 - torn/garbled segment
                    logger.warning("skipping unreadable metrics "
                                   "history segment %s", path)
            samples.sort(key=lambda s: s[0])
            self._rings[tier] = samples[-2 * self._max:]
        if self._rings["raw"]:
            self._trim_raw_locked()

    # -- reads ---------------------------------------------------------

    def query(self, names: Optional[List[str]] = None,
              limit: Optional[int] = None) -> List[Tuple[float, Dict]]:
        """SeriesHistory-compatible read of the raw ring: [(ts,
        series)], oldest first, prefix-matched on names. Forced samples
        are INCLUDED (no sparkline gaps); rate-computing callers use
        query_ex to skip them."""
        return [(ts, series)
                for ts, series, _f in self.query_ex(names, limit)]

    def query_ex(self, names: Optional[List[str]] = None,
                 limit: Optional[int] = None
                 ) -> List[Tuple[float, Dict, bool]]:
        with self._lock:
            samples = list(self._rings["raw"])
        if limit is not None:
            samples = samples[-int(limit):]
        if names:
            samples = [
                (ts, {k: v for k, v in series.items()
                      if any(k.startswith(n) for n in names)}, forced)
                for ts, series, forced in samples]
        return samples

    def range_query(self, names: Optional[List[str]] = None,
                    since_s: float = 600.0,
                    tier: str = "raw") -> List[Tuple[float, Dict]]:
        """Samples with wall ts >= now - since_s from `tier`, oldest
        first, reaching through on-disk segments when the lookback
        exceeds the in-memory ring. Raw-tier forced samples are
        included (value samples, not rate samples)."""
        if tier not in TIERS:
            raise ValueError(
                f"unknown history tier {tier!r} (have {list(TIERS)})")
        # Wall clock on purpose: sample timestamps are wall time so the
        # series stays comparable across GCS restarts (monotonic resets).
        cutoff = time.time() - max(0.0, float(since_s))  # graftlint: disable=RT010
        with self._lock:
            ring = list(self._rings[tier])
        by_ts: Dict[float, Dict] = {}
        ring_oldest = ring[0][0] if ring else None
        if self._dir is not None and \
                (ring_oldest is None
                 or ring_oldest > cutoff):  # graftlint: disable=RT010
            for path in self._segment_files(tier):
                try:
                    with open(path) as f:
                        payload = json.load(f)
                except Exception:  # noqa: BLE001 - torn segment
                    continue
                for s in payload.get("samples", ()):
                    ts = float(s[0])
                    if ts >= cutoff:  # graftlint: disable=RT010
                        by_ts[ts] = s[1]
        for entry in ring:
            if entry[0] >= cutoff:  # graftlint: disable=RT010
                by_ts[entry[0]] = entry[1]
        out = sorted(by_ts.items())
        if names:
            out = [(ts, {k: v for k, v in series.items()
                         if any(k.startswith(n) for n in names)})
                   for ts, series in out]
        return out

    def stop(self) -> None:
        self.flush()
