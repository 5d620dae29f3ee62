"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under ``csrc/`` is compiled on its own, all at once, by
``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library with a
plain ``extern "C"`` interface (no PyTorch headers, so a build takes
seconds). The libraries go to ``ray_tpu_torch/_build/<hash>/``, keyed on a
hash of the sources and the flags, and are reused while that hash holds.
A build happens at the first call of a kernel, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
# one shared library per kernel source
SOURCES = ("flash_fwd.cu", "flash_bwd_dkv.cu", "flash_bwd_dq.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# argument types of each C entry point (see the extern "C" functions)
SIGNATURES = {
    "flash_fwd": [_P] * 5 + [_I] * 4 + [_L] * 9 + [_F, _I, _P],
    "flash_bwd_dkv": [_P] * 8 + [_I] * 4 + [_L] * 12 + [_F, _I, _P],
    "flash_bwd_dq": [_P] * 7 + [_I] * 4 + [_L] * 12 + [_F, _I, _P],
}

_loaded: Dict[str, object] = {}  # C entry point name -> ctypes function


class KernelBuildError(RuntimeError):
    """nvcc is missing, or a kernel source failed to compile or load."""


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append(os.path.join(DEFAULT_CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        f"{DEFAULT_CUDA_HOME}/bin): the port's flash-attention kernels are "
        "CUDA C++ for sm_90a and are compiled at first use, so a CUDA "
        "toolkit is required to run them on the GPU")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source not yet built for the current hash; returns
    the build directory. Raises KernelBuildError on any failure."""
    out = BUILD_ROOT / source_hash()
    todo = [s for s in SOURCES if not (out / _lib_name(s)).exists()]
    if not todo:
        return out
    nvcc = find_nvcc()
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in todo:
        tmp = out / f"{_lib_name(src)}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / src)]
        procs.append((src, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, tmp, cmd, proc in procs:
        log, _ = proc.communicate()
        (out / f"{src}.log").write_text(" ".join(cmd) + "\n" + log)
        if proc.returncode != 0:
            failed.append(f"{src} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out / _lib_name(src))
    if failed:
        raise KernelBuildError("nvcc failed for " + "\n".join(failed))
    return out


def kernel(name: str):
    """The C entry point `name`, building and loading its library on the
    first call."""
    fn = _loaded.get(name)
    if fn is not None:
        return fn
    src = name + ".cu"
    out = build()
    try:
        lib = ctypes.CDLL(str(out / _lib_name(src)))
    except OSError as e:
        raise KernelBuildError(f"cannot load {src}'s library: {e}") from e
    fn = getattr(lib, name)
    fn.argtypes = SIGNATURES[name]
    fn.restype = ctypes.c_int
    _loaded[name] = fn
    return fn


def build_logs() -> Dict[str, str]:
    """nvcc's output per source (registers, shared memory and spills from
    -Xptxas -v) of the current build."""
    out = BUILD_ROOT / source_hash()
    return {s: (out / f"{s}.log").read_text()
            for s in SOURCES if (out / f"{s}.log").exists()}


def _lib_name(src: str) -> str:
    return "lib" + src.replace(".cu", ".so")
