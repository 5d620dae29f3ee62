"""GroupedData: hash-partitioned groupby + aggregations.

reference parity: python/ray/data/grouped_data.py (Dataset.groupby ->
GroupedData.count/sum/min/max/mean/std/aggregate/map_groups) and the
hash-shuffle exchange in _internal/planner/exchange/. Execution shape is
the standard two-phase exchange: a map task per input block splits it
into one piece per output partition by key hash (each block crosses the
object store once), then a reduce task per partition merges its pieces
and aggregates locally with pandas (the reference's pandas-block path
does the same per-partition combine).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Union

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import block as block_mod
from ray_tpu_torch.data.block import Block

_AGG_FUNCS = ("count", "sum", "min", "max", "mean", "std")


def _split_by_hash(blk: Block, key: str, n: int):
    """Map phase: one piece per hash partition; empty-block safe."""
    if not block_mod.block_num_rows(blk):
        return tuple({} for _ in range(n))
    import pandas as pd
    hashes = pd.util.hash_array(np.asarray(blk[key])) % n
    return tuple(
        block_mod.take_rows(blk, np.nonzero(hashes == p)[0])
        for p in range(n))


def _merge_pieces(refs: List[Any]) -> Block:
    pieces = [b for b in ray_tpu_torch.get(list(refs))
              if block_mod.block_num_rows(b)]
    return block_mod.concat_blocks(pieces)


def _agg_pieces(refs: List[Any], key: str,
                spec: Dict[str, List[str]]) -> Block:
    import pandas as pd
    merged = _merge_pieces(refs)
    if not block_mod.block_num_rows(merged):
        return {}
    # only the key + aggregated columns enter pandas: other columns may
    # be multi-dimensional (jax feature arrays), which DataFrame rejects
    cols = [key, *spec.keys()]
    df = pd.DataFrame({c: merged[c] for c in dict.fromkeys(cols)})
    if spec:
        out = df.groupby(key, sort=True).agg(spec)
        out.columns = [f"{fn}({col})" for col, fn in out.columns]
        out = out.reset_index()
    else:  # count()
        out = df.groupby(key, sort=True).size().rename("count()") \
            .reset_index()
    return {c: out[c].to_numpy() for c in out.columns}


def _map_groups_pieces(refs: List[Any], key: str,
                       fn: Callable[[Block], Block]) -> Block:
    merged = _merge_pieces(refs)
    if not block_mod.block_num_rows(merged):
        return {}
    order = np.argsort(merged[key], kind="stable")
    merged = block_mod.take_rows(merged, order)
    keys = merged[key]
    change = np.nonzero(keys[1:] != keys[:-1])[0] + 1
    bounds = [0, *change.tolist(), len(keys)]
    outs = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        outs.append(fn(block_mod.slice_block(merged, lo, hi)))
    return block_mod.concat_blocks(outs)


class GroupedData:
    def __init__(self, dataset, key: str):
        self._ds = dataset
        self._key = key

    def _exchange(self, reduce_fn, *args) -> "Any":
        from ray_tpu_torch.data.dataset import MaterializedDataset
        mat = self._ds.materialize()
        n = max(1, len(mat._refs))
        split = ray_tpu_torch.remote(_split_by_hash).options(num_returns=n)
        pieces = [split.remote(r, self._key, n) for r in mat._refs]
        if n == 1:
            pieces = [[p] for p in pieces]
        reduce_remote = ray_tpu_torch.remote(reduce_fn)
        refs = [reduce_remote.remote([pc[p] for pc in pieces],
                                     self._key, *args)
                for p in range(n)]
        return MaterializedDataset(refs)

    def aggregate(self, spec: Dict[str, Union[str, Sequence[str]]]):
        """spec: {column: agg | [aggs]} with aggs from
        count/sum/min/max/mean/std -> columns named 'agg(column)'."""
        norm: Dict[str, List[str]] = {}
        for col, fns in spec.items():
            if col == self._key:
                raise ValueError(
                    f"cannot aggregate the grouping key {col!r}; "
                    f"use count() for group sizes")
            fns = [fns] if isinstance(fns, str) else list(fns)
            for fn in fns:
                if fn not in _AGG_FUNCS:
                    raise ValueError(
                        f"unknown aggregation {fn!r}; "
                        f"supported: {_AGG_FUNCS}")
            norm[col] = fns
        return self._exchange(_agg_pieces, norm)

    agg = aggregate

    def count(self):
        return self._exchange(_agg_pieces, {})

    def sum(self, on: str):
        return self.aggregate({on: "sum"})

    def min(self, on: str):
        return self.aggregate({on: "min"})

    def max(self, on: str):
        return self.aggregate({on: "max"})

    def mean(self, on: str):
        return self.aggregate({on: "mean"})

    def std(self, on: str):
        return self.aggregate({on: "std"})

    def map_groups(self, fn: Callable[[Block], Block]):
        """Apply fn to each whole group's block (reference
        GroupedData.map_groups)."""
        return self._exchange(_map_groups_pieces, fn)
