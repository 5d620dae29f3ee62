"""Pull-based streaming operator pipeline with per-stage backpressure.

reference parity: python/ray/data/_internal/execution/streaming_executor.py
:60 and execution/interfaces/physical_operator.py:120 — the reference
streams RefBundles between physical operators, each operator holding a
bounded number of running tasks, with backpressure propagating upstream.

Here the plan is a list of *stages*. Consecutive per-block ops
(map/map_batches/filter/flat_map) FUSE into one stage = one task per
block (the reference's map-operator fusion); a stage boundary appears
when an op requests different resources (the reference's fusion rule:
operators with unequal resource requests don't fuse). Stages chain as
generators, so execution is pull-based end to end: nothing runs until
the consumer pulls, stage k+1's tasks start as soon as individual
stage-k blocks finish (no barrier), and each stage's
`max_in_flight` cap propagates backpressure to its upstream — a slow
tail stage stalls the whole pipeline at bounded memory.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Iterator, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.data import block as block_mod


def _apply_op(block, op: Tuple) -> Any:
    kind = op[0]
    if kind == "map_batches":
        _, fn, batch_size = op
        if batch_size is None:
            return fn(block)
        n = block_mod.block_num_rows(block)
        outs = [fn(block_mod.slice_block(block, i, min(i + batch_size, n)))
                for i in range(0, n, batch_size)]
        return block_mod.concat_blocks(outs)
    if kind == "map":
        _, fn = op
        return block_mod.rows_to_block(
            [fn(r) for r in block_mod.block_to_rows(block)])
    if kind == "flat_map":
        _, fn = op
        out: List[Any] = []
        for r in block_mod.block_to_rows(block):
            out.extend(fn(r))
        return block_mod.rows_to_block(out)
    if kind == "filter":
        _, fn = op
        return block_mod.rows_to_block(
            [r for r in block_mod.block_to_rows(block) if fn(r)])
    raise ValueError(f"unknown op {kind}")


def _execute_chain(source: Any, ops: List[Tuple]) -> Any:
    """One fused task: build/fetch the input block, run every per-block op."""
    blk = source() if callable(source) else source
    for op in ops:
        blk = _apply_op(blk, op)
    return blk


# Lazily decorated so importing ray_tpu_torch.data stays cheap.
_remote_chain = None


def _get_remote_chain():
    global _remote_chain
    if _remote_chain is None:
        _remote_chain = ray_tpu_torch.remote(_execute_chain)
    return _remote_chain


def split_stages(ops: List[Tuple], default_num_cpus: float
                 ) -> List["MapStage"]:
    """Split an op chain into fused stages at ("boundary", num_cpus)
    markers (inserted when a map op requests its own resources)."""
    stages: List[MapStage] = []
    cur: List[Tuple] = []
    cur_cpus = default_num_cpus
    for op in ops:
        if op[0] == "boundary":
            new_cpus = op[1] if op[1] is not None else default_num_cpus
            if new_cpus == cur_cpus:
                continue  # equal resource requests fuse
            if cur:
                stages.append(MapStage(cur, num_cpus=cur_cpus))
                cur = []
            cur_cpus = new_cpus
        else:
            cur.append(op)
    if cur or not stages:
        stages.append(MapStage(cur, num_cpus=cur_cpus))
    return stages


class MapStage:
    """One fused map operator: a bounded pool of per-block tasks.

    reference parity: physical_operator.py:120 (PhysicalOperator with
    num_active_tasks bounded by the resource budget).
    """

    def __init__(self, ops: List[Tuple], *, num_cpus: float = 1.0,
                 max_in_flight: int = 4):
        self.ops = ops
        self.num_cpus = num_cpus
        self.max_in_flight = max(1, max_in_flight)

    def run(self, upstream: Iterator[Any],
            executor: "StreamingExecutor",
            force_tasks: bool = False) -> Iterator[Any]:
        if not self.ops and not force_tasks:
            yield from upstream
            return
        remote = _get_remote_chain().options(num_cpus=self.num_cpus)
        pending: "deque[Any]" = deque()
        for source in upstream:
            while len(pending) >= self.max_in_flight:
                executor._dec()
                yield pending.popleft()
            pending.append(remote.remote(source, self.ops))
            executor._inc()
        while pending:
            executor._dec()
            yield pending.popleft()


class StreamingExecutor:
    """Streams (index-ordered) result block refs for `inputs` x `ops`.

    `ops` may contain ("boundary", num_cpus) markers splitting the chain
    into separately-scheduled stages; per stage, `max_in_flight_blocks`
    bounds submitted-but-unconsumed blocks, and generator chaining makes
    the whole pipeline pull-based — the executor holds at most
    sum(stage caps) live intermediate refs at any moment
    (`peak_in_flight` instruments this; backpressure tests assert on it).
    """

    def __init__(self, inputs: List[Any], ops: List[Tuple], *,
                 max_in_flight_blocks: int = 4,
                 num_cpus_per_task: float = 1.0):
        self.inputs = inputs
        self.ops = ops
        self.max_in_flight = max(1, max_in_flight_blocks)
        self.num_cpus = num_cpus_per_task
        self.stages = split_stages(ops, num_cpus_per_task)
        for st in self.stages:
            st.max_in_flight = self.max_in_flight
        # instrumentation (asserted by backpressure tests): live
        # intermediate refs held across ALL stages
        self.peak_in_flight = 0
        self._in_flight = 0

    def _inc(self):
        self._in_flight += 1
        self.peak_in_flight = max(self.peak_in_flight, self._in_flight)

    def _dec(self):
        self._in_flight -= 1

    def execute(self) -> Iterator[Any]:
        """Yield one block ref per input, in input order."""
        if not any(st.ops for st in self.stages):
            # No per-block work: pass through without spawning tasks
            # (materialized refs) or run creation-only tasks for lazy inputs.
            lazy = any(callable(s) for s in self.inputs)
            if not lazy:
                yield from self.inputs
                return
        lazy = any(callable(s) for s in self.inputs)
        stream: Iterator[Any] = iter(self.inputs)
        for i, st in enumerate(self.stages):
            # lazy sources need a creation task even for an op-less
            # stage so downstream sees block refs, not callables
            stream = st.run(stream, self, force_tasks=(i == 0 and lazy))
        yield from stream
