"""Push-based shuffle: tree-merged all-to-all exchange.

reference parity: python/ray/data/_internal/push_based_shuffle.py — the
reference's large-scale shuffle pipelines map tasks with intermediate
MERGE tasks: map outputs are pushed into per-partition partial merges
round by round, so (a) reducer inputs are a handful of merged partials
instead of one piece per map task (O(maps) -> O(maps/merge_factor)
refs per reducer), and (b) partial merges for round k run while round
k+1's map tasks execute — map and merge overlap instead of a full
barrier between stages.
"""

from __future__ import annotations

from typing import Any, Callable, List

import ray_tpu_torch
from ray_tpu_torch.data import block as block_mod


def _concat_pieces(refs: List[Any]):
    """Partial merge: concat this round's pieces for one partition."""
    blocks = [b for b in ray_tpu_torch.get(list(refs))
              if block_mod.block_num_rows(b)]
    return block_mod.concat_blocks(blocks)


_concat_remote = None


def push_based_shuffle(input_refs: List[Any], num_partitions: int,
                       map_remote: Callable,
                       map_args: tuple = (),
                       *, merge_factor: int = 4) -> List[List[Any]]:
    """Run `map_remote(ref, *map_args)` (num_returns=num_partitions)
    over every input block, tree-merging each partition's pieces in
    rounds of `merge_factor`. Returns, per partition, the list of
    merged-partial refs for the final reduce.

    The driver only ever tracks refs; each round's pieces become one
    partial per partition as soon as that round's maps finish, while
    the next round's maps are already running.
    """
    global _concat_remote
    if _concat_remote is None:
        _concat_remote = ray_tpu_torch.remote(_concat_pieces)
    partials: List[List[Any]] = [[] for _ in range(num_partitions)]
    n = len(input_refs)
    for lo in range(0, n, max(1, merge_factor)):
        group = input_refs[lo:lo + merge_factor]
        pieces = [map_remote.remote(r, *map_args) for r in group]
        if num_partitions == 1:
            pieces = [[p] for p in pieces]
        for p in range(num_partitions):
            round_refs = [pc[p] for pc in pieces]
            if len(round_refs) == 1:
                partials[p].append(round_refs[0])
            else:
                partials[p].append(_concat_remote.remote(round_refs))
    return partials
