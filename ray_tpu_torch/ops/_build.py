"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under ``csrc/`` is compiled on its own, all at once, by
``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library with a
plain ``extern "C"`` interface (no PyTorch headers, so a build takes
seconds). The libraries go to ``ray_tpu_torch/_build/<hash>/``, keyed on a
hash of the sources and the flags, and are reused while that hash holds.
A build happens at the first call of a kernel, never at import.

Every source includes ``hopper_common.cuh`` (TMA, mbarriers, wgmma); it
looks up libcuda's tensor-map encoder through the CUDA runtime, so no link
flag beyond nvcc's defaults is needed.
``sass_counts`` reads ``cuobjdump -sass`` of a built library, from the same
toolkit as nvcc, to show which instructions a kernel was compiled to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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

# SASS opcodes counted per library: Hopper's warpgroup MMA and TMA load,
# Ampere's mma.sync, and the mbarrier operations
SASS_OPS = ("HGMMA", "UTMALDG", "HMMA", "SYNCS")
# one instruction of `cuobjdump -sass`: "/*0a30*/  @!P0 OPCODE.MODS ..."
_SASS_LINE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)")

_loaded: Dict[str, object] = {}  # C entry point name -> ctypes function


class KernelBuildError(RuntimeError):
    """nvcc is missing, or a kernel source failed to compile or load."""


def find_cuobjdump() -> str:
    """cuobjdump from the same toolkit bin as nvcc; raises if missing."""
    path = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    if not (os.path.isfile(path) and os.access(path, os.X_OK)):
        raise KernelBuildError(f"cuobjdump not found beside nvcc ({path})")
    return path


def sass_counts(text: str) -> Dict[str, int]:
    """Instructions per opcode in SASS_OPS in `cuobjdump -sass` output."""
    counts = dict.fromkeys(SASS_OPS, 0)
    for m in _SASS_LINE.finditer(text):
        if m.group(1) in counts:
            counts[m.group(1)] += 1
    return counts


def sass(src: str, out: Path = None) -> Dict[str, int]:
    """sass_counts of the built library of `src` (in `out`, by default the
    current build)."""
    lib = (out or BUILD_ROOT / source_hash()) / _lib_name(src)
    proc = subprocess.run([find_cuobjdump(), "-sass", str(lib)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(f"cuobjdump -sass {lib} failed:\n{proc.stderr}")
    return sass_counts(proc.stdout)


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


def source_hash(csrc: Path = CSRC) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(csrc.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(csrc: Path = CSRC, root: Path = BUILD_ROOT,
          sources=SOURCES) -> Path:
    """Compile every source of `csrc` not yet built for the current hash
    into `root`/<hash>; returns that directory. Raises KernelBuildError on
    any failure."""
    out = root / source_hash(csrc)
    todo = [s for s in sources if not (out / _lib_name(s)).exists()]
    if not todo:
        return out
    nvcc = find_nvcc()
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in todo:
        tmp = out / f"{_lib_name(src)}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(csrc), "-o", str(tmp),
               str(csrc / src)]
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
    _loaded[name] = fn = load(name, build())
    return fn


def load(name: str, out: Path):
    """The C entry point `name` from its library in build directory
    `out`, with its argument types set."""
    src = name + ".cu"
    try:
        lib = ctypes.CDLL(str(out / _lib_name(src)))
    except OSError as e:
        raise KernelBuildError(f"cannot load {src}'s library: {e}") from e
    fn = getattr(lib, name)
    fn.argtypes = SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def build_logs(out: Path = None) -> Dict[str, str]:
    """nvcc's output per source (registers, shared memory and spills from
    -Xptxas -v) of build directory `out`, by default the current build."""
    out = out or BUILD_ROOT / source_hash()
    return {s: (out / f"{s}.log").read_text()
            for s in SOURCES if (out / f"{s}.log").exists()}


def _lib_name(src: str) -> str:
    return "lib" + src.replace(".cu", ".so")
