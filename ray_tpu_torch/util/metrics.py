"""Application metrics: Counter / Gauge / Histogram.

reference parity: python/ray/util/metrics.py (Counter/Gauge/Histogram over
the OpenCensus-based native registry, src/ray/stats/metric.h). Here metrics
live in a per-process registry; `collect()` snapshots them, and node-level
aggregation rides the existing state API instead of a Prometheus agent.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence, Tuple

_REGISTRY: Dict[str, "Metric"] = {}
_REGISTRY_LOCK = threading.Lock()


class Metric:
    """Base: named metric with optional tag keys; values kept per tag-set."""

    kind = "metric"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None):
        if not name:
            raise ValueError("metric name must be non-empty")
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys or ())
        self._default_tags: Dict[str, str] = {}
        self._lock = threading.Lock()
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {}
        with _REGISTRY_LOCK:
            if name in _REGISTRY:
                # Silent replacement would orphan the earlier instance:
                # increments through it would vanish from collect().
                raise ValueError(
                    f"metric {name!r} already registered in this process")
            _REGISTRY[name] = self

    def set_default_tags(self, tags: Dict[str, str]) -> "Metric":
        self._default_tags = dict(tags)
        return self

    def _key(self, tags: Optional[Dict[str, str]]
             ) -> Tuple[Tuple[str, str], ...]:
        merged = dict(self._default_tags)
        if tags:
            merged.update(tags)
        extra = set(merged) - set(self.tag_keys)
        if extra:
            raise ValueError(f"undeclared tag keys {sorted(extra)} for "
                             f"metric {self.name} (declared: {self.tag_keys})")
        return tuple(sorted(merged.items()))

    def snapshot(self) -> Dict:
        with self._lock:
            return {"name": self.name, "kind": self.kind,
                    "description": self.description,
                    "values": {k: v for k, v in self._values.items()}}


class Counter(Metric):
    kind = "counter"

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        if value < 0:
            raise ValueError("counters only increase")
        k = self._key(tags)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + value


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float, tags: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._values[self._key(tags)] = float(value)

    def reset(self) -> None:
        """Drop every tagged series. For gauges whose tag population is
        dynamic (e.g. per-gang heartbeat ages): a rebuild-per-sample
        exporter resets then re-sets the live series so series for
        departed members stop exporting stale values forever."""
        with self._lock:
            self._values.clear()


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[Sequence[float]] = None,
                 tag_keys: Optional[Sequence[str]] = None):
        super().__init__(name, description, tag_keys)
        self.boundaries = sorted(boundaries or
                                 [0.001, 0.01, 0.1, 1, 10, 100, 1000])
        self._buckets: Dict[Tuple, List[int]] = {}
        self._sums: Dict[Tuple, float] = {}
        self._counts: Dict[Tuple, int] = {}

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None) -> None:
        k = self._key(tags)
        with self._lock:
            buckets = self._buckets.setdefault(
                k, [0] * (len(self.boundaries) + 1))
            buckets[bisect.bisect_left(self.boundaries, value)] += 1
            self._sums[k] = self._sums.get(k, 0.0) + value
            self._counts[k] = self._counts.get(k, 0) + 1

    def snapshot(self) -> Dict:
        with self._lock:
            return {"name": self.name, "kind": self.kind,
                    "description": self.description,
                    "boundaries": list(self.boundaries),
                    "buckets": {k: list(v) for k, v in self._buckets.items()},
                    "sum": dict(self._sums), "count": dict(self._counts)}


def get_or_create(cls, name: str, **kwargs) -> "Metric":
    """Idempotent registration for library-internal metrics (the
    transport plane's counters are created on first use from whichever
    hot path runs first): returns the existing instance when `name` is
    already registered — raising TypeError if its kind differs — and
    constructs it otherwise. User code should construct metrics directly
    so accidental name collisions still fail loudly."""
    with _REGISTRY_LOCK:
        existing = _REGISTRY.get(name)
    if existing is not None:
        if not isinstance(existing, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(existing).__name__}, not {cls.__name__}")
        return existing
    try:
        return cls(name, **kwargs)
    except ValueError:
        # a lost registration race leaves the winner in the registry;
        # any other ValueError (bad kwargs) must propagate untouched
        with _REGISTRY_LOCK:
            winner = _REGISTRY.get(name)
        if winner is None:
            raise
        return winner


def collect() -> List[Dict]:
    """Snapshot every metric registered in this process."""
    with _REGISTRY_LOCK:
        metrics = list(_REGISTRY.values())
    return [m.snapshot() for m in metrics]


def _to_wire(snap: Dict) -> Dict:
    """Convert one snapshot() record to the JSON-safe wire format the
    cluster metrics plane ships over RPC: tag tuples become plain dicts
    so snapshots survive json.dumps on the dashboard routes."""
    out = {"name": snap["name"], "kind": snap["kind"],
           "description": snap.get("description", "")}
    if snap["kind"] == "histogram":
        out["boundaries"] = list(snap["boundaries"])
        out["series"] = [{"tags": dict(k), "buckets": list(b),
                          "sum": snap["sum"][k], "count": snap["count"][k]}
                         for k, b in snap["buckets"].items()]
    else:
        out["series"] = [{"tags": dict(k), "value": v}
                         for k, v in snap["values"].items()]
    return out


def collect_wire() -> List[Dict]:
    """collect() in wire format (see _to_wire)."""
    return [_to_wire(s) for s in collect()]


def _esc_label(v: str) -> str:
    """Prometheus exposition label escaping (\\ " and newline): one bad
    label value would otherwise abort the entire scrape."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _fmt_tags(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_esc_label(v)}"' for k, v in key)
    return "{" + inner + "}"


def render_prometheus(metrics: List[Dict]) -> str:
    """Prometheus exposition text from wire-format metric snapshots
    (collect_wire()-shaped). The cluster metrics plane concatenates many
    processes' snapshots, each carrying an ``extra_tags`` dict (proc/node
    labels), so HELP/TYPE are emitted once per metric NAME while series
    of the same name from different processes stay adjacent — Prometheus
    rejects exposition with a repeated TYPE line for one metric."""
    by_name: Dict[str, List[Dict]] = {}
    order: List[str] = []
    for m in metrics:
        if m["name"] not in by_name:
            order.append(m["name"])
        by_name.setdefault(m["name"], []).append(m)
    lines: List[str] = []
    for name in order:
        group = by_name[name]
        kind = group[0]["kind"]
        desc = next((g["description"] for g in group
                     if g.get("description")), "")
        if desc:
            desc = str(desc).replace("\n", " ")
            lines.append(f"# HELP {name} {desc}")
        lines.append(f"# TYPE {name} {kind}")

        def bucket_line(tags: Dict[str, str], le: str, cum: int) -> str:
            key = tuple(sorted({**tags, "le": le}.items()))
            return f"{name}_bucket{_fmt_tags(key)} {cum}"

        for m in group:
            if m["kind"] != kind:
                continue  # conflicting registration; first kind wins
            extra = m.get("extra_tags") or {}
            if kind == "histogram":
                for s in m["series"]:
                    tags = {**s["tags"], **extra}
                    base = tuple(sorted(tags.items()))
                    cum = 0
                    for bound, count in zip(m["boundaries"],
                                            s["buckets"]):
                        cum += count
                        lines.append(bucket_line(tags, str(bound), cum))
                    cum += s["buckets"][-1]
                    lines.append(bucket_line(tags, "+Inf", cum))
                    lines.append(f"{name}_sum{_fmt_tags(base)} "
                                 f"{s['sum']}")
                    lines.append(f"{name}_count{_fmt_tags(base)} "
                                 f"{s['count']}")
            else:
                for s in m["series"]:
                    tags = tuple(sorted({**s["tags"], **extra}.items()))
                    lines.append(f"{name}{_fmt_tags(tags)} {s['value']}")
    return "\n".join(lines) + "\n"


def prometheus_text() -> str:
    """This process's metrics in Prometheus exposition format (reference:
    the per-node metrics agent exporting to Prometheus,
    _private/metrics_agent.py + prometheus_exporter.py). The cluster-wide
    equivalent is the dashboard /metrics endpoint, which serves the
    harvested-and-merged registry of every process (_private/
    metrics_plane.py)."""
    return render_prometheus(collect_wire())


def clear() -> None:
    with _REGISTRY_LOCK:
        _REGISTRY.clear()
