"""Native (C++) runtime components + ctypes bindings.

reference parity: the reference's object-store core is C++
(object_manager/plasma/: PlasmaAllocator over a dlmalloc shm arena);
here the arena allocator is C++ (store_arena.cpp) loaded via ctypes —
no pybind11 in the image. The library builds on first use with g++ (see
Makefile); when the toolchain is unavailable the Python store falls
back to its file-per-object layout.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional

logger = logging.getLogger(__name__)

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "libraytpustore.so")
_build_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _build() -> bool:
    src = os.path.join(_DIR, "store_arena.cpp")
    if os.path.exists(_LIB_PATH) and \
            os.path.getmtime(_LIB_PATH) >= os.path.getmtime(src):
        return True
    # Build to a per-process temp name + atomic rename: multiple node
    # processes may race this build and g++ writing one output file
    # concurrently would corrupt it.
    tmp = f"{_LIB_PATH}.{os.getpid()}"
    try:
        out = subprocess.run(
            ["g++", "-O2", "-Wall", "-fPIC", "-std=c++17", "-shared",
             "-o", tmp, src, "-lpthread"],
            capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        logger.warning("native store build unavailable: %s", e)
        return False
    if out.returncode != 0:
        logger.warning("native store build failed:\n%s", out.stderr)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False
    os.replace(tmp, _LIB_PATH)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """Build (if needed) + load the native library; None on failure."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _build_lock:
        if _lib is not None or _load_failed:
            return _lib
        if os.environ.get("RAY_TPU_DISABLE_NATIVE_STORE") == "1" \
                or not _build():
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError as e:
            logger.warning("native store load failed: %s", e)
            _load_failed = True
            return None
        lib.arena_init.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.arena_init.restype = ctypes.c_int
        lib.arena_attach.argtypes = [ctypes.c_char_p]
        lib.arena_attach.restype = ctypes.c_void_p
        lib.arena_detach.argtypes = [ctypes.c_void_p]
        lib.arena_alloc.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.arena_alloc.restype = ctypes.c_uint64
        lib.arena_free.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.arena_free.restype = ctypes.c_int
        lib.arena_used.argtypes = [ctypes.c_void_p]
        lib.arena_used.restype = ctypes.c_uint64
        lib.arena_capacity.argtypes = [ctypes.c_void_p]
        lib.arena_capacity.restype = ctypes.c_uint64
        lib.arena_check.argtypes = [ctypes.c_void_p]
        lib.arena_check.restype = ctypes.c_int64
        _lib = lib
        return _lib


class NativeArena:
    """One process's view of a shared arena (server or client side)."""

    def __init__(self, path: str, capacity: Optional[int] = None):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native store library unavailable")
        self._lib = lib
        self.path = path
        if capacity is not None:
            rc = lib.arena_init(path.encode(), capacity)
            if rc != 0:
                raise OSError(f"arena_init({path}) failed: {rc}")
        self._h = lib.arena_attach(path.encode())
        if not self._h:
            raise OSError(f"arena_attach({path}) failed")
        import mmap as mmap_mod
        fd = os.open(path, os.O_RDWR)
        try:
            self._mm = mmap_mod.mmap(fd, 0)
        finally:
            os.close(fd)
        self._view = memoryview(self._mm)

    def alloc(self, size: int) -> int:
        """Payload offset, or 0 when the arena can't fit `size`."""
        return self._lib.arena_alloc(self._h, size)

    def free(self, offset: int) -> None:
        rc = self._lib.arena_free(self._h, offset)
        if rc != 0:
            raise ValueError(f"arena_free({offset}) -> {rc}")

    def view(self, offset: int, size: int) -> memoryview:
        """Zero-copy view of a payload slice."""
        return self._view[offset:offset + size]

    @property
    def used(self) -> int:
        return self._lib.arena_used(self._h)

    @property
    def capacity(self) -> int:
        return self._lib.arena_capacity(self._h)

    def check(self) -> int:
        """Validate allocator invariants; returns block count."""
        n = self._lib.arena_check(self._h)
        if n < 0:
            raise AssertionError(f"arena corrupt: {n}")
        return int(n)

    def close(self) -> None:
        try:
            self._view.release()
            self._mm.close()
        except (BufferError, ValueError):
            pass
        if self._h:
            self._lib.arena_detach(self._h)
            self._h = None
