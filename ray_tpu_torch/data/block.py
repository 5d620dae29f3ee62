"""Block format + accessors for ray_tpu_torch.data.

reference parity: python/ray/data/block.py (Block/BlockAccessor). The
reference's blocks are Arrow tables or pandas frames; here a block is a
columnar dict {column: np.ndarray} — the natural zero-copy format for the
shared-memory object store and for feeding jax (device_put of a dict of
arrays is one hop).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Sequence

import numpy as np

Block = Dict[str, np.ndarray]


def rows_to_block(rows: Sequence[Any]) -> Block:
    """List of dicts (or scalars → column 'item') → columnar block."""
    if not rows:
        return {}
    if not isinstance(rows[0], dict):
        rows = [{"item": r} for r in rows]
    cols: Dict[str, List[Any]] = {}
    for r in rows:
        for k, v in r.items():
            cols.setdefault(k, []).append(v)
    out: Block = {}
    for k, vals in cols.items():
        arr = np.asarray(vals)
        out[k] = arr
    return out


def block_num_rows(block: Block) -> int:
    for v in block.values():
        return len(v)
    return 0


def block_to_rows(block: Block) -> Iterator[Dict[str, Any]]:
    keys = list(block.keys())
    for i in range(block_num_rows(block)):
        yield {k: block[k][i] for k in keys}


def slice_block(block: Block, start: int, stop: int) -> Block:
    return {k: v[start:stop] for k, v in block.items()}


def take_rows(block: Block, indices: np.ndarray) -> Block:
    return {k: v[indices] for k, v in block.items()}


def concat_blocks(blocks: Sequence[Block]) -> Block:
    blocks = [b for b in blocks if block_num_rows(b) > 0]
    if not blocks:
        return {}
    keys = list(blocks[0].keys())
    return {k: np.concatenate([b[k] for b in blocks]) for k in keys}


def block_schema(block: Block) -> Dict[str, str]:
    return {k: str(v.dtype) for k, v in block.items()}


def block_size_bytes(block: Block) -> int:
    return sum(int(v.nbytes) for v in block.values())
