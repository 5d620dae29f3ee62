"""DataIterator: re-batching iteration over blocks / block refs.

reference parity: python/ray/data/iterator.py (DataIterator.iter_batches)
— the object handed to train workers by get_dataset_shard
(train/_internal/session.py:1017); pulls blocks (prefetching one ahead)
and re-slices them into exact-size batches.
"""

from __future__ import annotations

from typing import Any, Iterator, List, Optional

import ray_tpu_torch
from ray_tpu_torch.data import block as block_mod
from ray_tpu_torch.data.block import Block


class DataIterator:
    """Iterates blocks (given as refs or an iterator of blocks) as batches.

    Picklable when constructed from refs — this is what ships to train
    workers; the refs ride the object store and register as borrows.
    """

    def __init__(self, refs: Optional[List[Any]] = None,
                 blocks: Optional[Iterator[Block]] = None):
        assert (refs is None) != (blocks is None)
        self._refs = refs
        self._blocks = blocks

    def _block_iter(self) -> Iterator[Block]:
        if self._blocks is not None:
            yield from self._blocks
            return
        for ref in self._refs:
            # streaming: one block in memory at a time is the point
            # graftlint: disable=RT002
            yield ray_tpu_torch.get(ref) if isinstance(ref, ray_tpu_torch.ObjectRef) \
                else ref

    def iter_batches(self, *, batch_size: int = 256,
                     drop_last: bool = False) -> Iterator[Block]:
        # Track an offset into the current merged block instead of
        # re-concatenating the remainder per batch (slice_block returns
        # views, so in-block batching is copy-free; the only copies are one
        # remainder+next-block concat per input block).
        carry: Block = {}
        offset = 0
        for blk in self._block_iter():
            left = block_mod.block_num_rows(carry) - offset
            if left <= 0:
                carry, offset = blk, 0
            else:
                carry = block_mod.concat_blocks([
                    block_mod.slice_block(
                        carry, offset, block_mod.block_num_rows(carry)),
                    blk])
                offset = 0
            n = block_mod.block_num_rows(carry)
            while n - offset >= batch_size:
                yield block_mod.slice_block(carry, offset,
                                            offset + batch_size)
                offset += batch_size
        rest_rows = block_mod.block_num_rows(carry) - offset
        if rest_rows > 0 and not drop_last:
            yield block_mod.slice_block(
                carry, offset, block_mod.block_num_rows(carry))

    def iter_rows(self) -> Iterator[dict]:
        for blk in self._block_iter():
            yield from block_mod.block_to_rows(blk)

    def count(self) -> int:
        return sum(block_mod.block_num_rows(b) for b in self._block_iter())

    def materialize(self):
        """Back to a dataset (only for ref-backed iterators)."""
        from ray_tpu_torch.data.dataset import MaterializedDataset
        assert self._refs is not None
        return MaterializedDataset(list(self._refs))

    def __reduce__(self):
        if self._refs is None:
            raise TypeError("only ref-backed DataIterators are picklable")
        return (DataIterator, (list(self._refs),))
