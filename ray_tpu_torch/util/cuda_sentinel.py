"""Always-on kernel-build/transfer sentinel of the port.

Runtime half of the hot-path lint pairing (lint/torchrules.py is the
static half): the lint rules catch the hazards visible in source —
hidden device→host syncs (RT021) — and this module catches the ones only
the live process can see, exporting them through the per-process metrics
registry so they ride the cluster harvest onto /metrics and the
watchdog's `jit_recompile_storm` / `unexpected_host_transfer` probes.
It is the counterpart of ray_tpu/util/jax_sentinel.py, with its metric
names, environment variables and snapshot key.

Two signals:

  - **compiles** — what compiles on the port's path is the nvcc build
    of the CUDA kernels (ops/_build.py:build). Its listener fires once
    per build that compiled something (a warm build directory, or a
    library already loaded, is silent, as jax's compile event is on a
    cache hit), with the build's wall seconds, on the building thread.
    Counting it per step-region label splits the first build
    (`kind="first"`) from later ones (`kind="recompile"`), and the
    seconds are charged to goodput's `compile` bucket:
        ray_tpu_jit_compiles_total{fn=<region>, kind=first|recompile}
  - **host transfers** — the Python-level forcing points of a tensor
    on the device (`item`, `tolist`, `numpy`, `__array__`, `__float__`,
    `__int__`, `__bool__`, `__index__`, and `cpu()` / `to(<cpu>)` when
    the copy blocks) are patched to account the bytes they pull across,
    tagged by step region:
        ray_tpu_host_transfer_bytes_total{region=<region>}
    Inside a region each forcing point also records a flight-recorder
    span (`host_sync.<via>`) whose duration is the blocked wall time.
    A non-blocking copy into pinned memory is not a forcing point (the
    event wait that follows it is where the host blocks), and a `cpu()`
    or `to()` that returns its own tensor moved nothing. `on_device`
    decides which tensors are on the device; tests widen it to CPU
    tensors.

    As an escalation, RAY_TPU_JAX_SENTINEL_GUARD=log|disallow applies
    `torch.cuda.set_sync_debug_mode("warn"|"error")` for the region's
    scope: "warn" names every synchronizing call, "error" turns it into
    a hard error at the offending line. Unlike jax's transfer guard that
    mode is process-wide, not per thread: the first region to enter
    sets it, the last to leave restores the mode it found, even when
    the body raises, so two threads in regions (IMPALA's learner thread
    beside the driver) never leave it set. The guard needs CUDA and
    raises without it. Off by default: it flags the *sanctioned*
    forcing points too.

Scoping: training loops wrap their step in `step_region(name)` —
Learner.update, IMPALA's learner loop and both train_step closures of
parallel/train_step.py do. Transfers outside any region account under
region="untracked" and are never judged by the watchdog; transfers
INSIDE a region alert once their per-harvest delta crosses
`Config.watchdog_host_transfer_bytes`. On the CPU a region counts builds
and nothing else: a CPU tensor is host memory, so no forcing point on
it moves bytes from a device.

Off switch: RAY_TPU_JAX_SENTINEL=0 makes install() refuse and
step_region() return a shared no-op — nothing is patched, no listener
registered, call sites pay one flag check. Installation is lazy and
idempotent; importing this module never imports torch.
"""

from __future__ import annotations

import os
import threading
from time import perf_counter
from typing import Any, Dict, Optional

# the key operators read in `ray_tpu metrics dump`, as the JAX package's
SNAPSHOT_KEY = "jax_sentinel"

# the patched forcing points of torch.Tensor, each with its span's name
_FORCING = {"item": "item", "tolist": "tolist", "numpy": "numpy",
            "__array__": "asarray", "__float__": "float",
            "__int__": "int", "__bool__": "bool", "__index__": "index",
            "cpu": "cpu", "to": "to"}
_GUARD_MODES = {"log": "warn", "disallow": "error"}

_lock = threading.Lock()
_tls = threading.local()

_installed = False
_listener_registered = False

# region label -> lifetime build count (splits first vs recompile)
_compiles: Dict[str, int] = {}

_compile_counter: Any = None
_xfer_counter: Any = None

# name -> (was it in torch.Tensor.__dict__, the attribute before install)
_orig: Dict[str, Any] = {}

# the process-wide sync debug mode: regions holding it, and the mode the
# first of them found
_guard_depth = 0
_guard_prev: Any = None


def enabled() -> bool:
    return os.environ.get("RAY_TPU_JAX_SENTINEL", "1").lower() not in (
        "0", "false", "no", "off")


def installed() -> bool:
    return _installed


def current_region() -> Optional[str]:
    stack = getattr(_tls, "regions", None)
    return stack[-1] if stack else None


def on_device(t) -> bool:
    """Whether a forcing point on tensor `t` moves bytes device→host."""
    return t.is_cuda


# ---------------------------------------------------------------------
# Accounting funnel
# ---------------------------------------------------------------------


def _account(nbytes: int, via: str, t0: float) -> None:
    """One observed device→host transfer: count the bytes against the
    current step region, and inside a region also record the blocked
    wall time as a host_sync span."""
    if not _installed:
        return
    try:
        region = current_region()
        _xfer_counter.inc(float(max(0, nbytes)),
                          tags={"region": region or "untracked"})
        if region is not None:
            from ray_tpu_torch._private import spans as _spans
            _spans.end(f"host_sync.{via}", t0,
                       bytes=int(nbytes), region=region)
    except Exception:  # noqa: BLE001 - accounting must never break the
        pass           # transfer it observes


def _in_xfer() -> bool:
    return getattr(_tls, "in_xfer", False)


def _on_build(seconds: float) -> None:
    """ops/_build.py listener: fires once per build that compiled a
    kernel, on the building thread — so the thread-local region label
    attributes it. It stays registered for the process lifetime;
    _installed gates its body."""
    if not _installed:
        return
    try:
        fn = current_region() or "untracked"
        with _lock:
            n = _compiles.get(fn, 0)
            _compiles[fn] = n + 1
        _compile_counter.inc(
            1.0, tags={"fn": fn,
                       "kind": "first" if n == 0 else "recompile"})
        # goodput: re-attribute the build's wall seconds out of whatever
        # ledger bucket is open on this thread (typically
        # productive_step) into `compile`
        from ray_tpu_torch._private import goodput
        goodput.charge("compile", float(seconds))
    except Exception:  # noqa: BLE001 - telemetry is best-effort
        pass


def _snapshot_extra() -> Dict[str, Any]:
    """Rides every metrics harvest: which regions this process has
    built kernels under."""
    with _lock:
        return {"installed": _installed, "compiles": dict(_compiles)}


# ---------------------------------------------------------------------
# Install / uninstall
# ---------------------------------------------------------------------


def _nbytes(t) -> int:
    try:
        return t.numel() * t.element_size()
    except Exception:  # noqa: BLE001 - an odd subclass
        return 0


def _to_host(a, kw) -> bool:
    """Whether Tensor.to's arguments ask for a blocking copy to the
    host. The first bool among the positional arguments after the first
    is non_blocking in each of to()'s signatures."""
    d = a[0] if a else kw.get("device", kw.get("other"))
    if d is None or d.__class__.__name__ == "dtype":
        return False
    if hasattr(d, "device"):   # to(other)
        d = d.device
    if getattr(d, "type", None) != "cpu" and not (
            isinstance(d, str) and d.split(":")[0] == "cpu"):
        return False
    nb = kw.get("non_blocking")
    if nb is None:
        nb = next((x for x in a[1:] if isinstance(x, bool)), False)
    return not nb


def _forcing_point(orig, via: str, copies: bool, moves=None):
    """A wrapper of the torch.Tensor method `orig` that accounts the
    tensor's bytes when it is on the device (and, for `to`, when
    `moves(args, kwargs)` says the copy goes to the host, blocking).
    `copies`: the method returns its own tensor when it moved nothing.
    A forcing point reached inside another (np.asarray through numpy, a
    subclass's __torch_function__ calling back) is accounted once."""
    def forcing(self, *a, **kw):
        if (moves is not None and not moves(a, kw)) or _in_xfer() \
                or not on_device(self):
            return orig(self, *a, **kw)
        _tls.in_xfer = True
        t0 = perf_counter()
        try:
            out = orig(self, *a, **kw)
        finally:
            _tls.in_xfer = False
        if not (copies and out is self):
            _account(_nbytes(self), via, t0)
        return out
    forcing.__name__ = getattr(orig, "__name__", via)
    forcing.__doc__ = getattr(orig, "__doc__", None)
    return forcing


def install() -> bool:
    """Idempotent lazy install: metrics, the build listener, and the
    torch.Tensor transfer funnel. Returns False (and patches nothing)
    when RAY_TPU_JAX_SENTINEL=0."""
    global _installed, _listener_registered
    global _compile_counter, _xfer_counter
    if _installed:
        return True
    if not enabled():
        return False
    with _lock:
        if _installed:
            return True
        import torch

        from ray_tpu_torch._private import metrics_plane
        from ray_tpu_torch.ops import _build
        from ray_tpu_torch.util.metrics import Counter, get_or_create
        _compile_counter = get_or_create(
            Counter, "ray_tpu_jit_compiles_total",
            description="CUDA kernel builds (nvcc) by step-region label; "
                        "kind=first is warmup, kind=recompile a build "
                        "after the first under that label",
            tag_keys=("fn", "kind"))
        _xfer_counter = get_or_create(
            Counter, "ray_tpu_host_transfer_bytes_total",
            description="device->host bytes forced through tensor "
                        "coercions and blocking copies to the host, by "
                        "step region (region=untracked outside "
                        "step_region scopes; see graftlint RT021)",
            tag_keys=("region",))
        if not _listener_registered:
            _build.build_listeners.append(_on_build)
            _listener_registered = True
        metrics_plane.register_snapshot_extra(
            SNAPSHOT_KEY, _snapshot_extra)

        cls = torch.Tensor
        for name, via in _FORCING.items():
            _orig[name] = (name in cls.__dict__, getattr(cls, name))
        for name, via in _FORCING.items():
            copies = name in ("cpu", "to")
            setattr(cls, name, _forcing_point(
                _orig[name][1], via, copies,
                _to_host if name == "to" else None))
        _installed = True
        return True


def uninstall() -> None:
    """Restore torch.Tensor's forcing points exactly as install() found
    them (tests). The build listener stays registered — _installed
    gates its body — so a later install() never double-registers."""
    global _installed
    with _lock:
        if not _installed:
            return
        import torch

        from ray_tpu_torch._private import metrics_plane
        cls = torch.Tensor
        for name, (own, attr) in _orig.items():
            if own:
                setattr(cls, name, attr)
            else:   # inherited from torch._C.TensorBase
                delattr(cls, name)
        _orig.clear()
        metrics_plane.unregister_snapshot_extra(SNAPSHOT_KEY)
        _installed = False


# ---------------------------------------------------------------------
# Step regions
# ---------------------------------------------------------------------


class _NoopRegion:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


NOOP = _NoopRegion()


def _guard_mode() -> Optional[str]:
    mode = os.environ.get("RAY_TPU_JAX_SENTINEL_GUARD", "").lower()
    return _GUARD_MODES.get(mode)


def _guard_enter(mode: str) -> None:
    global _guard_depth, _guard_prev
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError(
            "RAY_TPU_JAX_SENTINEL_GUARD sets torch.cuda's sync debug "
            "mode, which needs a CUDA device; none is available")
    with _lock:
        if _guard_depth == 0:
            _guard_prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(mode)
        _guard_depth += 1


def _guard_exit() -> None:
    global _guard_depth
    import torch
    with _lock:
        _guard_depth -= 1
        if _guard_depth == 0:
            torch.cuda.set_sync_debug_mode(_guard_prev)


class _StepRegion:
    """Labels builds/transfers on this thread with `name`; with
    RAY_TPU_JAX_SENTINEL_GUARD set, also sets torch.cuda's sync debug
    mode for the scope (process-wide: see the module docstring).
    Regions nest; the innermost label wins (a learner.update inside an
    IMPALA learner.step attributes to learner.update)."""

    __slots__ = ("name", "_guarded")

    def __init__(self, name: str):
        self.name = name
        self._guarded = False

    def __enter__(self):
        mode = _guard_mode()
        if mode is not None:
            _guard_enter(mode)
            self._guarded = True
        stack = getattr(_tls, "regions", None)
        if stack is None:
            stack = _tls.regions = []
        stack.append(self.name)
        return self

    def __exit__(self, *exc):
        stack = getattr(_tls, "regions", None)
        if stack:
            stack.pop()
        if self._guarded:
            self._guarded = False
            _guard_exit()
        return None


def step_region(name: str):
    """Context manager marking a hot training-step scope. First use
    installs the sentinel (lazy); with RAY_TPU_JAX_SENTINEL=0 this is
    a shared no-op and nothing is ever patched."""
    if not install():
        return NOOP
    return _StepRegion(name)
