"""Checkpoint: a directory-of-files abstraction.

reference parity: python/ray/train/_checkpoint.py:55 — Checkpoint with
from_directory/to_directory/as_directory over a storage URI. Storage here
is a filesystem path (local or NFS); a nested dict of tensors rides
torch.save inside the directory when the caller uses the save helpers
(the JAX package writes its pytrees with orbax there).
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import uuid
from typing import Any, Dict, Iterator, Optional


class Checkpoint:
    """A reference to a directory containing a checkpoint."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        if not os.path.isdir(path):
            raise ValueError(f"not a directory: {path}")
        return cls(path)

    def to_directory(self, path: Optional[str] = None) -> str:
        """Materialize into `path` (copy); returns the path."""
        dest = path or os.path.join(
            tempfile.gettempdir(), f"ckpt_{uuid.uuid4().hex[:8]}")
        if os.path.abspath(dest) == self.path:
            return self.path
        os.makedirs(dest, exist_ok=True)
        shutil.copytree(self.path, dest, dirs_exist_ok=True)
        return dest

    @contextlib.contextmanager
    def as_directory(self) -> Iterator[str]:
        """Context manager view; local paths are yielded directly without
        copying (reference _checkpoint.py as_directory fast path)."""
        yield self.path

    # -- convenience for nested dicts of tensors ----------------------
    def save_pytree(self, tree: Any, name: str = "state") -> None:
        """Write a nested dict of tensors (host copies) into this
        checkpoint dir as `<name>.pt`."""
        import torch
        dest = os.path.join(self.path, f"{name}.pt")
        tmp = f"{dest}.{os.getpid()}.tmp"
        torch.save(_map_leaves(tree, lambda t: t.detach().cpu()), tmp)
        os.replace(tmp, dest)

    def load_pytree(self, name: str = "state",
                    target: Optional[Any] = None) -> Any:
        """Read what save_pytree wrote (tensors on the CPU). With a
        `target` tree, its keys and every tensor's shape must match, and
        each tensor lands on its target's device and dtype."""
        import torch
        tree = torch.load(os.path.join(self.path, f"{name}.pt"),
                          map_location="cpu", weights_only=True)
        if target is None:
            return tree
        return _fit_to_target(tree, target, name)

    def update_metadata(self, metadata: Dict[str, Any]) -> None:
        import json
        with open(os.path.join(self.path, ".metadata.json"), "w") as f:
            json.dump(metadata, f)

    def get_metadata(self) -> Dict[str, Any]:
        import json
        p = os.path.join(self.path, ".metadata.json")
        if not os.path.exists(p):
            return {}
        with open(p) as f:
            return json.load(f)

    def __repr__(self) -> str:
        return f"Checkpoint(path={self.path!r})"


def _map_leaves(tree: Any, fn) -> Any:
    import torch
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _fit_to_target(tree: Any, target: Any, path: str) -> Any:
    import torch
    if isinstance(target, dict):
        if not isinstance(tree, dict) or set(tree) != set(target):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"checkpoint {path}: keys {got} do not match "
                             f"the target's {sorted(target)}")
        return {k: _fit_to_target(tree[k], target[k], f"{path}.{k}")
                for k in target}
    if isinstance(target, torch.Tensor):
        if not isinstance(tree, torch.Tensor) or tree.shape != target.shape:
            got = tree.shape if isinstance(tree, torch.Tensor) else type(tree)
            raise ValueError(f"checkpoint {path}: shape {got} does not "
                             f"match the target's {tuple(target.shape)}")
        return tree.to(device=target.device, dtype=target.dtype)
    return tree
