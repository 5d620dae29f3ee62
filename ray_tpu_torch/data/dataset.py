"""Dataset: lazy block-based data pipeline feeding trainers.

reference parity: python/ray/data/dataset.py — lazy logical plan over
blocks executed by a streaming executor (streaming_executor.py:60) with
map/map_batches/filter/flat_map/repartition/random_shuffle/split, iteration
(iter_rows/iter_batches), and Train integration via per-worker shards
(train/_internal/session.py:1017 get_dataset_shard). Blocks here are
columnar numpy dicts (see block.py) — the shape jax wants.
"""

from __future__ import annotations

import builtins
import math
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import block as block_mod
from ray_tpu_torch.data.block import Block
from ray_tpu_torch.data.executor import StreamingExecutor, _execute_chain
from ray_tpu_torch.data.iterator import DataIterator


class Dataset:
    """A lazy pipeline: input block sources + a chain of per-block ops.

    Per-block ops (map/map_batches/filter/flat_map) fuse into one task per
    block. All-to-all ops (repartition/random_shuffle) materialize.
    """

    def __init__(self, inputs: List[Any], ops: Optional[List] = None):
        self._inputs = inputs
        self._ops = list(ops or [])

    # -- transforms (lazy, fused per block) ---------------------------

    def map(self, fn: Callable[[Dict[str, Any]], Dict[str, Any]], *,
            num_cpus: Optional[float] = None) -> "Dataset":
        return Dataset(self._inputs,
                       self._boundary(num_cpus) + [("map", fn)])

    def map_batches(self, fn: Callable[[Block], Block], *,
                    batch_size: Optional[int] = None,
                    num_cpus: Optional[float] = None) -> "Dataset":
        return Dataset(self._inputs,
                       self._boundary(num_cpus)
                       + [("map_batches", fn, batch_size)])

    def _boundary(self, num_cpus: Optional[float]) -> List:
        """Ops with their own resource request start a new (unfused)
        pipeline stage — the reference's operator-fusion rule (operators
        with unequal resource requests don't fuse; streaming_executor
        then runs them as separate bounded operators)."""
        if num_cpus is None:
            return list(self._ops)
        return self._ops + [("boundary", num_cpus)]

    def flat_map(self, fn: Callable[[Dict[str, Any]], Sequence[Dict]]
                 ) -> "Dataset":
        return Dataset(self._inputs, self._ops + [("flat_map", fn)])

    def filter(self, fn: Callable[[Dict[str, Any]], bool]) -> "Dataset":
        return Dataset(self._inputs, self._ops + [("filter", fn)])

    # -- all-to-all ops (materializing) -------------------------------

    def repartition(self, num_blocks: int) -> "MaterializedDataset":
        """Redistribute rows into `num_blocks` equal-ish blocks."""
        return self._redistribute(num_blocks, shuffle_seed=None)

    def random_shuffle(self, *, seed: Optional[int] = None
                       ) -> "MaterializedDataset":
        """Global row permutation (reference Dataset.random_shuffle)."""
        if seed is None:
            # Fresh entropy per call — a fixed default seed would hand
            # training the same "random" permutation every epoch.
            import os as _os
            seed = int.from_bytes(_os.urandom(4), "big")
        n_out = max(1, len(self._inputs))
        return self._redistribute(n_out, shuffle_seed=seed)

    def _redistribute(self, num_blocks: int,
                      shuffle_seed: Optional[int]) -> "MaterializedDataset":
        mat = self.materialize()
        # Row counts via tiny tasks — don't pull whole blocks to the driver.
        count_remote = ray_tpu_torch.remote(_count_rows)
        counts = ray_tpu_torch.get([count_remote.remote(r) for r in mat._refs])
        total = sum(counts)
        n = num_blocks
        # Balanced bounds (sizes differ by at most 1): ceil-sized partitions
        # would leave trailing partitions empty (e.g. 9 rows / 4 parts →
        # [3,3,3,0]), breaking the every-rank-gets-data invariant SPMD
        # training shards rely on.
        base, extra = divmod(total, n)
        bounds = []
        lo = 0
        for j in builtins.range(n):
            hi = lo + base + (1 if j < extra else 0)
            bounds.append((lo, hi))
            lo = hi
        out_refs = []
        if shuffle_seed is None:
            # Plain repartition keeps global row order, so partition j is
            # the contiguous row range [j*size,(j+1)*size): each task only
            # needs the input blocks overlapping its range — NOT the whole
            # dataset n times over.
            starts = [0]
            for c in counts[:-1]:
                starts.append(starts[-1] + c)
            remote = ray_tpu_torch.remote(_build_partition_contig)
            for lo, hi in bounds:
                sel = [i for i, (s, c) in enumerate(zip(starts, counts))
                       if s < hi and s + c > lo]
                refs_j = [mat._refs[i] for i in sel]
                counts_j = [counts[i] for i in sel]
                gstart = starts[sel[0]] if sel else 0
                out_refs.append(remote.remote(refs_j, counts_j, gstart,
                                              lo, hi))
        else:
            # Global permutation: a true all-to-all; every output needs
            # rows from (potentially) every input.
            remote = ray_tpu_torch.remote(_build_partition)
            out_refs = [
                remote.remote(mat._refs, counts, lo, hi, shuffle_seed)
                for lo, hi in bounds
            ]
        return MaterializedDataset(out_refs)

    def sort(self, key: str, *, descending: bool = False
             ) -> "MaterializedDataset":
        """Distributed sort as a two-phase exchange (reference
        Dataset.sort — sort_sample_keys + map/reduce tasks in
        _internal/planner/exchange/sort_task_spec.py): a map task per
        block range-partitions it by sampled cut points (each block
        crosses the store once, not once per partition), then a reduce
        task per partition merges + locally sorts its pieces."""
        mat = self.materialize()
        n = max(1, len(mat._refs))
        sample_remote = ray_tpu_torch.remote(_sample_keys)
        got = [s for s in ray_tpu_torch.get(
            [sample_remote.remote(r, key) for r in mat._refs])
            if s.size]
        if not got:
            return mat
        samples = np.sort(np.concatenate(got))
        # index-based cut points (works for every comparable dtype,
        # incl. strings, unlike interpolated quantiles)
        cuts = [samples[min(len(samples) - 1,
                            (j * len(samples)) // n)]
                for j in builtins.range(1, n)]
        bounds = np.asarray(cuts)
        split_remote = ray_tpu_torch.remote(_split_by_range) \
            .options(num_returns=n)
        # push-based shuffle (reference _internal/push_based_shuffle.py):
        # map-side range splits tree-merge into per-partition partials
        # round by round, overlapping with later map rounds, so each
        # reducer gets O(maps/merge_factor) refs instead of one per map
        from ray_tpu_torch.data.shuffle import push_based_shuffle
        partials = push_based_shuffle(
            mat._refs, n, split_remote, (key, bounds, n))
        merge_remote = ray_tpu_torch.remote(_merge_sorted)
        refs = [merge_remote.remote(partials[p], key, descending)
                for p in builtins.range(n)]
        if descending:
            refs = refs[::-1]
        return MaterializedDataset(refs)

    def groupby(self, key: str):
        """reference Dataset.groupby -> GroupedData."""
        from ray_tpu_torch.data.grouped import GroupedData
        return GroupedData(self, key)

    def zip(self, other: "Dataset") -> "MaterializedDataset":
        """Column-wise zip of equal-length datasets (reference
        Dataset.zip); the other side is re-sliced to this side's block
        boundaries."""
        left = self.materialize()
        right = other.materialize()
        count_remote = ray_tpu_torch.remote(_count_rows)
        lcounts = ray_tpu_torch.get([count_remote.remote(r)
                               for r in left._refs])
        rcounts = ray_tpu_torch.get([count_remote.remote(r)
                               for r in right._refs])
        if sum(lcounts) != sum(rcounts):
            raise ValueError(
                f"zip needs equal row counts: {sum(lcounts)} vs "
                f"{sum(rcounts)}")
        zip_remote = ray_tpu_torch.remote(_zip_partition)
        refs = []
        lo = 0
        for ref, cnt in zip(left._refs, lcounts):
            refs.append(zip_remote.remote(ref, right._refs, rcounts,
                                          lo, lo + cnt))
            lo += cnt
        return MaterializedDataset(refs)

    def union(self, *others: "Dataset") -> "MaterializedDataset":
        """Row concat (reference Dataset.union)."""
        refs = list(self.materialize()._refs)
        for o in others:
            refs.extend(o.materialize()._refs)
        return MaterializedDataset(refs)

    # -- consumption --------------------------------------------------

    def materialize(self, *, max_in_flight_blocks: int = 4
                    ) -> "MaterializedDataset":
        if isinstance(self, MaterializedDataset) and not self._ops:
            return self
        ex = StreamingExecutor(self._inputs, self._ops,
                               max_in_flight_blocks=max_in_flight_blocks)
        return MaterializedDataset(list(ex.execute()))

    def iter_blocks(self, *, max_in_flight_blocks: int = 4) -> Iterator[Block]:
        ex = StreamingExecutor(self._inputs, self._ops,
                               max_in_flight_blocks=max_in_flight_blocks)
        for ref in ex.execute():
            # streaming: one block in memory at a time is the point
            # graftlint: disable=RT002
            yield ray_tpu_torch.get(ref) if isinstance(ref, ray_tpu_torch.ObjectRef) \
                else ref

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for blk in self.iter_blocks():
            yield from block_mod.block_to_rows(blk)

    def iter_batches(self, *, batch_size: int = 256, drop_last: bool = False,
                     max_in_flight_blocks: int = 4) -> Iterator[Block]:
        it = DataIterator(blocks=self.iter_blocks(
            max_in_flight_blocks=max_in_flight_blocks))
        yield from it.iter_batches(batch_size=batch_size, drop_last=drop_last)

    def iter_torch_batches(self, *, batch_size: int = 256,
                           drop_last: bool = False,
                           device: Optional[str] = None):
        """Batches as dicts of torch tensors (reference
        Dataset.iter_torch_batches)."""
        import torch
        for blk in self.iter_batches(batch_size=batch_size,
                                     drop_last=drop_last):
            out = {}
            for k, v in blk.items():
                arr = np.ascontiguousarray(v)
                if not arr.flags.writeable:
                    # store-backed blocks are read-only shm views;
                    # torch requires writable memory
                    arr = arr.copy()
                t = torch.as_tensor(arr)
                out[k] = t.to(device) if device else t
            yield out

    def take(self, k: int = 20) -> List[Dict[str, Any]]:
        out = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= k:
                break
        return out

    def count(self) -> int:
        # Counting never needs block payloads in the driver: materialize,
        # then sum row counts via tiny tasks.
        mat = self.materialize()
        refs = [r for r in mat._refs if isinstance(r, ray_tpu_torch.ObjectRef)]
        if len(refs) != len(mat._refs):
            return sum(block_mod.block_num_rows(b)
                       for b in mat.iter_blocks())
        count_remote = ray_tpu_torch.remote(_count_rows)
        return sum(ray_tpu_torch.get([count_remote.remote(r) for r in refs]))

    # whole-dataset aggregates (reference Dataset.sum/min/max/mean/std):
    # per-block partials via tiny tasks, combined on the driver
    def _agg(self, on: str, kind: str):
        mat = self.materialize()
        remote = ray_tpu_torch.remote(_block_partial_agg)
        parts = [p for p in ray_tpu_torch.get(
            [remote.remote(r, on, kind) for r in mat._refs])
            if p is not None]
        if not parts:
            raise ValueError(f"cannot aggregate empty dataset on {on!r}")
        if kind == "sum":
            return sum(p[0] for p in parts)
        if kind == "min":
            return min(p[0] for p in parts)
        if kind == "max":
            return max(p[0] for p in parts)
        if kind == "mean":
            n = sum(p[1] for p in parts)
            return sum(p[0] for p in parts) / n
        # std: merge per-block (n, mean, M2) with Chan's parallel
        # update — a global E[x^2]-mean^2 would cancel catastrophically
        # for large-mean data. ddof=1 (sample std) matches the
        # reference Dataset.std and this repo's GroupedData.std.
        n, mean, m2 = parts[0]
        for nb, mb, m2b in parts[1:]:
            delta = mb - mean
            tot = n + nb
            mean += delta * nb / tot
            m2 += m2b + delta * delta * n * nb / tot
            n = tot
        if n < 2:
            return 0.0
        return float(np.sqrt(m2 / (n - 1)))

    def sum(self, on: str):  # noqa: A003
        return self._agg(on, "sum")

    def min(self, on: str):  # noqa: A003
        return self._agg(on, "min")

    def max(self, on: str):  # noqa: A003
        return self._agg(on, "max")

    def mean(self, on: str):
        return self._agg(on, "mean")

    def std(self, on: str):
        return self._agg(on, "std")

    def schema(self) -> Dict[str, str]:
        for blk in self.iter_blocks():
            if block_mod.block_num_rows(blk):
                return block_mod.block_schema(blk)
        return {}

    # -- train integration --------------------------------------------

    def split(self, n: int, *, equal: bool = False
              ) -> List["MaterializedDataset"]:
        """N disjoint shards, one per train worker (reference
        Dataset.split / streaming_split feeding get_dataset_shard)."""
        mat = self.repartition(n) if equal else self.materialize()
        shards: List[List[Any]] = [[] for _ in builtins.range(n)]
        for i, ref in enumerate(mat._refs):
            shards[i % n].append(ref)
        return [MaterializedDataset(refs) for refs in shards]

    def num_blocks(self) -> int:
        return len(self._inputs)

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(num_blocks={len(self._inputs)}, "
                f"ops={[o[0] for o in self._ops]})")


class MaterializedDataset(Dataset):
    """All blocks computed and living in the object store as refs."""

    def __init__(self, refs: List[Any]):
        super().__init__(refs, [])
        self._refs = refs

    def iterator(self) -> DataIterator:
        return DataIterator(refs=list(self._refs))


def _count_rows(blk: Block) -> int:
    return block_mod.block_num_rows(blk)


def _block_partial_agg(blk: Block, on: str, kind: str):
    """Per-block partials; None if empty. sum/min/max: (value,);
    mean: (total, count); std: (count, mean, M2)."""
    if not block_mod.block_num_rows(blk):
        return None
    col = np.asarray(blk[on])
    if kind == "sum":
        return (col.sum(),)
    if kind == "min":
        return (col.min(),)
    if kind == "max":
        return (col.max(),)
    if kind == "mean":
        return (float(col.sum()), int(col.size))
    mean = float(col.mean())
    m2 = float(((col.astype(np.float64) - mean) ** 2).sum())
    return (int(col.size), mean, m2)


def _sample_keys(blk: Block, key: str, max_samples: int = 100
                 ) -> np.ndarray:
    if not block_mod.block_num_rows(blk):
        return np.asarray([])
    col = np.asarray(blk[key])
    if len(col) <= max_samples:
        return col
    idx = np.random.default_rng(0).choice(len(col), max_samples,
                                          replace=False)
    return col[idx]


def _split_by_range(blk: Block, key: str, bounds: np.ndarray, n: int):
    """Map phase: one piece per output partition. NaN keys fall through
    searchsorted to the last partition (never silently dropped)."""
    if not block_mod.block_num_rows(blk):
        return tuple({} for _ in builtins.range(n))
    part_ids = np.searchsorted(bounds, np.asarray(blk[key]),
                               side="right")
    return tuple(
        block_mod.take_rows(blk, np.nonzero(part_ids == p)[0])
        for p in builtins.range(n))


def _merge_sorted(refs: List[Any], key: str, descending: bool) -> Block:
    """Reduce phase: merge this partition's pieces and sort locally."""
    pieces = [b for b in ray_tpu_torch.get(list(refs))
              if block_mod.block_num_rows(b)]
    merged = block_mod.concat_blocks(pieces)
    if not block_mod.block_num_rows(merged):
        return merged
    order = np.argsort(merged[key], kind="stable")
    if descending:
        order = order[::-1]
    return block_mod.take_rows(merged, order)


def _zip_partition(left_blk: Block, right_refs: List[Any],
                   rcounts: List[int], lo: int, hi: int) -> Block:
    """Zip the left block with the right side's global rows [lo,hi)."""
    overlaps = []
    pos = 0
    for ref, cnt in zip(right_refs, rcounts):
        s, e = max(lo, pos), min(hi, pos + cnt)
        if e > s:
            overlaps.append((ref, s - pos, e - pos))
        pos += cnt
    # one batched get for every overlapping block (found by graftlint
    # RT002: a get per block serialized the fetches)
    blocks = ray_tpu_torch.get([ref for ref, _, _ in overlaps])
    pieces = [block_mod.slice_block(blk, s0, e0)
              for blk, (_, s0, e0) in zip(blocks, overlaps)]
    right = block_mod.concat_blocks(pieces)
    out = dict(left_blk)
    for k, v in right.items():
        name = k
        suffix = 1
        while name in out:  # probe a free suffix, never clobber
            name = f"{k}_{suffix}"
            suffix += 1
        out[name] = v
    return out


def _build_partition_contig(refs: List[Any], counts: List[int],
                            gstart: int, lo: int, hi: int) -> Block:
    """Assemble contiguous global row range [lo,hi) from the (overlapping)
    input blocks, whose first block starts at global row `gstart`."""
    blocks = ray_tpu_torch.get(list(refs))
    pieces = []
    pos = gstart
    for blk, cnt in zip(blocks, counts):
        s, e = max(lo, pos), min(hi, pos + cnt)
        if e > s:
            pieces.append(block_mod.slice_block(blk, s - pos, e - pos))
        pos += cnt
    return block_mod.concat_blocks(pieces)


def _build_partition(refs: List[Any], counts: List[int], lo: int, hi: int,
                     shuffle_seed: Optional[int]) -> Block:
    """Worker-side: assemble the output rows [lo,hi) of the (optionally
    permuted) global row order from all input blocks."""
    blocks = ray_tpu_torch.get(list(refs))
    total = sum(counts)
    ids = np.arange(total)
    if shuffle_seed is not None:
        ids = np.random.default_rng(shuffle_seed).permutation(total)
    mine = ids[lo:hi]
    mine_sorted = np.sort(mine) if shuffle_seed is None else mine
    # map global row id -> (block, local row)
    starts = np.cumsum([0] + counts[:-1])
    pieces = []
    for blk, start, cnt in zip(blocks, starts, counts):
        sel = mine_sorted[(mine_sorted >= start) & (mine_sorted < start + cnt)]
        if len(sel):
            pieces.append(block_mod.take_rows(blk, sel - start))
    return block_mod.concat_blocks(pieces)


# -- creation APIs (reference ray.data.from_items / range / from_numpy) ----

def _chunk_bounds(n: int, parallelism: int) -> List[tuple]:
    parallelism = max(1, min(parallelism, n)) if n else 1
    size = math.ceil(n / parallelism) if n else 0
    # builtins.range: the module-level `range` below shadows the builtin
    return [(i, min(i + size, n))
            for i in builtins.range(0, n, size)] if n else []


def from_items(items: Sequence[Any], *, parallelism: int = 8) -> Dataset:
    bounds = _chunk_bounds(len(items), parallelism)
    inputs = [_ItemsSource(list(items[a:b])) for a, b in bounds]
    return Dataset(inputs)


def range(n: int, *, parallelism: int = 8) -> Dataset:  # noqa: A001
    bounds = _chunk_bounds(n, parallelism)
    return Dataset([_RangeSource(a, b) for a, b in bounds])


def from_numpy(arrays: Dict[str, np.ndarray], *,
               parallelism: int = 8) -> Dataset:
    n = len(next(iter(arrays.values()))) if arrays else 0
    bounds = _chunk_bounds(n, parallelism)
    return Dataset([
        _ItemsBlockSource({k: v[a:b] for k, v in arrays.items()})
        for a, b in bounds])


def from_blocks(blocks: Sequence[Block]) -> Dataset:
    return Dataset([_ItemsBlockSource(dict(b)) for b in blocks])


class _RangeSource:
    """Picklable lazy block: np.arange slice built inside the task."""

    def __init__(self, start: int, stop: int):
        self.start, self.stop = start, stop

    def __call__(self) -> Block:
        return {"id": np.arange(self.start, self.stop)}


class _ItemsSource:
    def __init__(self, items: List[Any]):
        self.items = items

    def __call__(self) -> Block:
        return block_mod.rows_to_block(self.items)


class _ItemsBlockSource:
    def __init__(self, blk: Block):
        self.blk = blk

    def __call__(self) -> Block:
        return self.blk
