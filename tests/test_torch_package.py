"""Rules of the port package: it imports neither jax nor ray_tpu, its
entry points default to CUDA and raise without it, its kernel path never
falls back to the plain version, and its build says so when nvcc is
missing."""

import ast
import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.models import TINY, Transformer
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import flash_attention as pflash
from ray_tpu_torch.parallel.train_step import make_train_step

PKG = Path(ray_tpu_torch.__file__).resolve().parent
REPO = PKG.parent


def _is_forbidden(module):
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "optax", "ray_tpu")


def test_fresh_import_pulls_in_no_jax_and_no_ray_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import ray_tpu_torch\n"
        "for m in pkgutil.walk_packages(ray_tpu_torch.__path__, "
        "'ray_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'ray_tpu'))\n"
        "print('IMPORTED', len([n for n in sys.modules "
        "if n.startswith('ray_tpu_torch')]))\n"
        "print('BAD', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


# the package's own sources; _build/ holds build outputs, never sources
SOURCES = sorted(str(p.relative_to(REPO)) for p in PKG.rglob("*.py")
                 if "_build" not in p.relative_to(PKG).parts)


@pytest.mark.parametrize("path", SOURCES)
def test_source_imports_no_jax_and_no_ray_tpu(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_is_forbidden(n) for n in names), (path, names)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Transformer(TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(lambda p, b: 0.0)


def test_unported_paths_raise_naming_their_slice():
    for over in (dict(moe_experts=4), dict(remat=True),
                 dict(attention_impl="ring"), dict(attention_impl="ulysses")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Transformer(TINY.replace(**over), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Transformer(TINY, device="cpu").pipeline_loss()


@pytest.mark.parametrize("kernel", ["fwd", "dkv", "dq"])
def test_kernel_path_raises_on_cpu_tensors(kernel):
    q = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16)
    stats = torch.zeros(1, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        if kernel == "fwd":
            pflash._flash_fwd_cuda(q, q, q, 0.125, True)
        elif kernel == "dkv":
            pflash._flash_bwd_dkv_cuda(q, q, q, q, stats, stats, 0.125, True)
        else:
            pflash._flash_bwd_dq_cuda(q, q, q, q, stats, stats, 0.125, True)


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor on neither the CPU nor CUDA is refused, not sent to the
    plain version."""
    q = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pflash.flash_fwd(q, q, q, 0.125, True)


def test_build_raises_clearly_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.find_nvcc()
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.kernel("flash_fwd")
    assert not (tmp_path / "build").exists()


def test_build_hash_follows_the_sources():
    h = _build.source_hash()
    assert len(h) == 16 and h == _build.source_hash()
    assert set(_build.SOURCES) <= {p.name for p in _build.CSRC.iterdir()}
    assert set(_build.SIGNATURES) == {s[:-3] for s in _build.SOURCES}


def test_every_kernel_is_a_hopper_kernel_under_the_sass_gate():
    """Every source the build compiles includes hopper_common.cuh and is
    one chip_smoke.py's build phase holds to HGMMA and UTMALDG (and no
    HMMA)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert set(_build.SOURCES) <= set(chip_smoke.HOPPER_SOURCES)
    for src in _build.SOURCES:
        text = (_build.CSRC / src).read_text()
        assert '#include "hopper_common.cuh"' in text, src
    headers = {p.name for p in _build.CSRC.iterdir() if p.suffix == ".cuh"}
    assert headers == {"hopper_common.cuh"}


def test_chip_smoke_fails_without_cuda_and_alone(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                           capture_output=True, text=True, timeout=120,
                           env=dict(env, PYTHONPATH=""))
    assert alone.returncode != 0
    assert '"ok": true' not in alone.stdout


# a few lines of `cuobjdump -sass` of a Hopper kernel: predicated and
# unpredicated instructions, uniform predicates, and the encoding comments
SASS = """
        /*0200*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;  /* 0x00000000000079f0 */
                                                                                      /* 0x000fe20008000818 */
        /*0210*/              @P0 SYNCS.ARRIVE.TRANS64.RED.A1T0 RZ, [UR4], RZ ;
        /*0220*/                   UTMALDG.4D [UR8], [UR10] ;
        /*0230*/             @!P0 BRA 0x1f0 ;
        /*1a2b0*/           @!UPT SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R3+URZ], R4 ;
        /*1a2c0*/                   HGMMA.64x64x16.F32.BF16 R88, R152, gdesc[UR8].tnspB, R88 ;
        /*0240*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0250*/                   LDSM.16.M88.4 R8, [R2] ;
"""


def test_sass_counts_read_cuobjdump_text():
    assert _build.sass_counts(SASS) == {"HGMMA": 2, "UTMALDG": 1, "HMMA": 1,
                                        "SYNCS": 2}
    assert _build.sass_counts("") == dict.fromkeys(_build.SASS_OPS, 0)


def test_sass_raises_without_cuobjdump(monkeypatch, tmp_path):
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    with pytest.raises(_build.KernelBuildError, match="cuobjdump not found"):
        _build.sass("flash_fwd.cu", tmp_path)
