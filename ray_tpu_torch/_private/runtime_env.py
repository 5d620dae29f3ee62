"""Runtime-env plugins with URI caching.

reference parity: python/ray/_private/runtime_env/pip.py (pip plugin:
per-env package installs), plugin.py (plugin protocol), and the URI
cache (uri_cache.py / working_dir URI reuse): each distinct pip spec
hashes to a content URI; the install happens ONCE per node into a
cache directory keyed by that URI, and every worker whose env carries
the same spec just gets the cached site prepended to PYTHONPATH. The
reference runs this in a per-node runtime-env agent; here the node
manager calls it in-process before spawning the worker (same
serialization point — worker spawn already happens on the node
manager's spawn path).

Installs run `pip install --target <cache>/<uri>` with
`--no-build-isolation` so local source trees install without network
(this environment has no egress; callers ship wheels/source dirs and
pass `--no-index --find-links ...` via pip_args).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

_DEFAULT_CACHE = os.path.expanduser("~/.cache/ray_tpu/runtime_env")


def pip_spec(renv: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Normalize the pip field: list of requirements or
    {"packages": [...], "pip_args": [...]} -> canonical dict."""
    pip = (renv or {}).get("pip")
    if pip is None:
        return None
    if isinstance(pip, (list, tuple)):
        return {"packages": [str(p) for p in pip], "pip_args": []}
    if isinstance(pip, dict):
        return {"packages": [str(p) for p in pip.get("packages") or ()],
                "pip_args": [str(a) for a in pip.get("pip_args") or ()]}
    raise ValueError(f"runtime_env pip must be a list or dict, got {pip!r}")


def pip_uri(spec: Dict[str, Any]) -> str:
    """Content-hash URI for a pip spec (reference: pip.py get_uri)."""
    blob = json.dumps(spec, sort_keys=True).encode()
    py = f"py{sys.version_info.major}.{sys.version_info.minor}"
    return f"pip-{py}-{hashlib.sha1(blob).hexdigest()[:20]}"


# ---------------------------------------------------------------------------
# conda plugin (reference _private/runtime_env/conda.py): the env
# materializes ONCE per node into the URI cache; workers of that env run
# with <prefix>/bin/python and CONDA_PREFIX set. The create command is a
# module-level hook so chip-/binary-free CI can fake materialization
# (this box has no conda); production uses `conda env create --prefix`.
# ---------------------------------------------------------------------------


_CONDA_KEYS = {"name", "dependencies", "channels"}


def conda_spec(renv: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Normalize the conda field: env NAME (str) or an environment.yml-
    style dict -> canonical dict. Unknown dict keys fail fast — a typo
    like {'deps': [...]} must not materialize an empty environment."""
    conda = (renv or {}).get("conda")
    if conda is None:
        return None
    if isinstance(conda, str):
        return {"name": conda, "dependencies": None, "channels": None}
    if isinstance(conda, dict):
        bad = set(conda) - _CONDA_KEYS
        if bad:
            raise ValueError(
                f"unknown runtime_env conda key(s) {sorted(bad)}; "
                f"supported: {sorted(_CONDA_KEYS)}")
        return {"name": conda.get("name"),
                "dependencies": conda.get("dependencies"),
                "channels": conda.get("channels")}
    raise ValueError(
        f"runtime_env conda must be an env name or dict, got {conda!r}")


def conda_uri(spec: Dict[str, Any]) -> str:
    blob = json.dumps(spec, sort_keys=True).encode()
    return f"conda-{hashlib.sha1(blob).hexdigest()[:20]}"


def _default_conda_create(target: str, spec: Dict[str, Any]) -> None:
    """Materialize a conda prefix at `target` (production path)."""
    if spec.get("dependencies") is None and spec.get("name"):
        cmd = ["conda", "create", "--yes", "--prefix", target,
               "--clone", spec["name"]]
    else:
        env_yaml = os.path.join(os.path.dirname(target),
                                os.path.basename(target) + ".yml")
        body = {"dependencies": spec.get("dependencies") or []}
        if spec.get("channels"):
            body["channels"] = spec["channels"]
        with open(env_yaml, "w", encoding="utf-8") as f:
            json.dump(body, f)
        cmd = ["conda", "env", "create", "--prefix", target,
               "--file", env_yaml]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(
            f"conda env create failed: {proc.stderr[-2000:]}")


# test seam (reference: the runtime-env agent's conda handler is mocked
# the same way in its unit tests)
CONDA_CREATE_HOOK = _default_conda_create


def container_spec(renv: Optional[Dict[str, Any]]
                   ) -> Optional[Dict[str, Any]]:
    """Normalize the container field (reference container.py):
    {"image": ..., "run_options": [...]}; image is required."""
    container = (renv or {}).get("container")
    if container is None:
        return None
    if not isinstance(container, dict) or not container.get("image"):
        raise ValueError(
            "runtime_env container must be a dict with an 'image' key, "
            f"got {container!r}")
    return {"image": str(container["image"]),
            "run_options": [str(o) for o in
                            container.get("run_options") or ()]}


def _default_container_wrap(cmd: List[str], image: str,
                            run_options: List[str],
                            env: Optional[Dict[str, str]] = None
                            ) -> List[str]:
    """Wrap a worker command in a container runtime invocation
    (production path; host networking so the worker's RPC server is
    reachable, repo mounted for the package, the worker's RAY_TPU_* /
    PYTHONPATH / env_vars forwarded — Popen's env only reaches the
    docker CLIENT, not the container)."""
    import ray_tpu_torch
    pkg_root = os.path.dirname(os.path.dirname(
        os.path.abspath(ray_tpu_torch.__file__)))
    env_flags: List[str] = []
    for k, v in (env or {}).items():
        env_flags += ["--env", f"{k}={v}"]
    return (["docker", "run", "--rm", "--network=host",
             f"--volume={pkg_root}:{pkg_root}:ro", *env_flags,
             *run_options, image] + cmd)


CONTAINER_WRAP_HOOK = _default_container_wrap


class RuntimeEnvManager:
    """Per-node plugin resolver with a content-addressed install cache."""

    def __init__(self, cache_dir: str = _DEFAULT_CACHE):
        self.cache_dir = cache_dir
        self._locks: Dict[str, threading.Lock] = {}
        self._guard = threading.Lock()
        # failed URIs fail fast on retry instead of re-running a long
        # doomed install per task-retry attempt
        self._failed: Dict[str, str] = {}

    def _lock_for(self, uri: str) -> threading.Lock:
        with self._guard:
            return self._locks.setdefault(uri, threading.Lock())

    def setup_pip(self, renv: Optional[Dict[str, Any]]) -> Optional[str]:
        """Ensure the env's pip packages are installed in the cache;
        returns the site dir to prepend to PYTHONPATH (None if no pip
        field). Concurrent workers for the same URI serialize on a
        lock; a `.ready` marker makes completed installs reusable
        across node-manager restarts."""
        spec = pip_spec(renv)
        if spec is None or not spec["packages"]:
            return None
        uri = pip_uri(spec)
        target = os.path.join(self.cache_dir, uri)
        marker = os.path.join(target, ".ready")
        with self._lock_for(uri):
            prior = self._failed.get(uri)
            if prior is not None:
                raise RuntimeError(
                    f"runtime_env pip install previously failed for "
                    f"{spec['packages']}: {prior}")
            if os.path.exists(marker):
                self._touch(marker)
                return target
            os.makedirs(target, exist_ok=True)
            cmd = [sys.executable, "-m", "pip", "install",
                   "--quiet", "--no-build-isolation",
                   "--target", target, *spec["pip_args"],
                   *spec["packages"]]
            logger.info("runtime_env pip install (%s): %s", uri,
                        " ".join(spec["packages"]))
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=600)
            if proc.returncode != 0:
                self._failed[uri] = proc.stderr[-500:]
                raise RuntimeError(
                    f"runtime_env pip install failed "
                    f"({spec['packages']}): {proc.stderr[-2000:]}")
            self._touch(marker)
            return target

    def setup_conda(self, renv: Optional[Dict[str, Any]]
                    ) -> Optional[str]:
        """Ensure the env's conda prefix exists in the cache; returns
        the prefix path (None if no conda field). Same URI-cache
        contract as setup_pip: one create per spec per node, `.ready`
        marker, failure memo. The worker then runs with
        <prefix>/bin/python when present (module hook materializes —
        fake in chip-free CI, `conda env create` in production)."""
        spec = conda_spec(renv)
        if spec is None:
            return None
        uri = conda_uri(spec)
        target = os.path.join(self.cache_dir, uri)
        marker = os.path.join(target, ".ready")
        with self._lock_for(uri):
            prior = self._failed.get(uri)
            if prior is not None:
                raise RuntimeError(
                    f"runtime_env conda create previously failed for "
                    f"{spec}: {prior}")
            if os.path.exists(marker):
                self._touch(marker)
                return target
            os.makedirs(target, exist_ok=True)
            logger.info("runtime_env conda create (%s)", uri)
            try:
                CONDA_CREATE_HOOK(target, spec)
            except Exception as e:  # noqa: BLE001
                self._failed[uri] = str(e)[-500:]
                raise RuntimeError(
                    f"runtime_env conda create failed ({spec}): {e}")
            self._touch(marker)
            return target

    @staticmethod
    def wrap_container(renv: Optional[Dict[str, Any]],
                       cmd: List[str],
                       env: Optional[Dict[str, str]] = None
                       ) -> List[str]:
        """Wrap a worker command per the env's container field (no-op
        without one). `env` is the spawn environment; the wrap forwards
        the worker-contract subset (RAY_TPU_*, PYTHONPATH) plus the
        env's declared env_vars into the container."""
        spec = container_spec(renv)
        if spec is None:
            return cmd
        # forward the worker contract + the env's declared env_vars —
        # NOT the whole host environment
        src = env or {}
        fwd = {k: v for k, v in src.items()
               if k.startswith("RAY_TPU_") or k in ("PYTHONPATH",
                                                    "CONDA_PREFIX")}
        for k in (renv or {}).get("env_vars") or {}:
            if str(k) in src:
                fwd[str(k)] = src[str(k)]
        return CONTAINER_WRAP_HOOK(list(cmd), spec["image"],
                                   spec["run_options"], fwd)

    @staticmethod
    def _touch(marker: str) -> None:
        with open(marker, "w", encoding="utf-8") as f:
            f.write(str(time.time()))

    def gc(self, max_entries: int = 10) -> List[str]:
        """Drop least-recently-used cached envs beyond max_entries
        (reference: URI cache eviction). Returns removed URIs."""
        import shutil
        if not os.path.isdir(self.cache_dir):
            return []
        entries = []
        for name in os.listdir(self.cache_dir):
            marker = os.path.join(self.cache_dir, name, ".ready")
            try:
                with open(marker, encoding="utf-8") as f:
                    stamp = float(f.read().strip() or 0)
            except OSError:
                stamp = 0.0
            entries.append((stamp, name))
        entries.sort(reverse=True)
        removed = []
        for _, name in entries[max_entries:]:
            shutil.rmtree(os.path.join(self.cache_dir, name),
                          ignore_errors=True)
            removed.append(name)
        return removed
