"""Host-RAM collective communication between actors/processes.

reference parity: python/ray/util/collective/collective.py:120-651 —
init_collective_group / allreduce / allgather / reducescatter /
broadcast / reduce / barrier / send / recv over NCCL (GPU) or Gloo
(CPU) groups, with rendezvous through a named store actor
(collective_group/nccl_collective_group.py:28 Rendezvous).

TPU-native split (SURVEY.md §5.8): device arrays NEVER use this — they
live in HBM and reduce over ICI via XLA collectives inside jit. This
module is the HOST plane: numpy weight broadcast to sampler actors,
checkpoint resharding, metric reduction. Ranks rendezvous at a named
coordinator actor; every rank must issue the same collective ops in the
same order (standard collective-group contract).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

_GROUP_STATE: Dict[str, "_LocalGroup"] = {}


class _LocalGroup:
    def __init__(self, coordinator: Any, world_size: int, rank: int,
                 group_name: str):
        self.coordinator = coordinator
        self.world_size = world_size
        self.rank = rank
        self.group_name = group_name
        self.seq = 0
        # p2p rounds are tracked per (src, dst) pair, NOT on the shared
        # collective sequence: a send/recv only advances the two
        # participants, and mixing it into the collective counter would
        # desynchronize round ids for everyone else.
        self.p2p_seq: Dict[Any, int] = {}

    def next_round(self) -> int:
        self.seq += 1
        return self.seq

    def next_p2p_round(self, src: int, dst: int) -> int:
        key = (src, dst)
        self.p2p_seq[key] = self.p2p_seq.get(key, 0) + 1
        return self.p2p_seq[key]


class CollectiveCoordinator:
    """Named rendezvous + reduction actor (reference Rendezvous /
    the named store actor). Runs with max_concurrency >= world_size so
    every rank's blocking contribute() can park concurrently."""

    def __init__(self, world_size: int):
        self.world_size = world_size
        self._lock = threading.Lock()
        # (round, op) -> {"data": {rank: array}, "event": Event, "result": _}
        self._rounds: Dict[Any, Dict[str, Any]] = {}
        self._mailbox: Dict[Any, Any] = {}   # (round, dst) -> payload
        self._mailbox_cv = threading.Condition(self._lock)

    def ping(self) -> str:
        return "pong"

    def contribute(self, round_id: int, op: str, rank: int,
                   data: Any, timeout: float = 300.0) -> Any:
        key = (round_id, op)
        with self._lock:
            st = self._rounds.get(key)
            if st is None:
                st = {"data": {}, "event": threading.Event(),
                      "result": None}
                self._rounds[key] = st
            st["data"][rank] = data
            complete = len(st["data"]) == self.world_size
            if complete:
                st["result"] = self._combine(op, st["data"])
                st["event"].set()
        if not st["event"].wait(timeout=timeout):
            raise TimeoutError(
                f"collective {op} round {round_id}: only "
                f"{len(st['data'])}/{self.world_size} ranks arrived")
        result = st["result"]
        with self._lock:
            # last reader cleans up
            st.setdefault("readers", 0)
            st["readers"] += 1
            if st["readers"] == self.world_size:
                self._rounds.pop(key, None)
        if op == "allgather":
            return result
        if op in ("sum", "mean", "max", "min", "barrier"):
            return result
        if op == "reducescatter":
            return result[rank]
        if op == "broadcast":
            return result
        raise ValueError(f"unknown op {op}")

    def _combine(self, op: str, data: Dict[int, Any]) -> Any:
        ordered = [data[r] for r in sorted(data)]
        if op == "barrier":
            return True
        if op == "allgather":
            return ordered
        if op == "broadcast":
            # exactly one rank supplied a non-None payload (the src)
            payload = [d for d in ordered if d is not None]
            return payload[0]
        arrays = [np.asarray(d) for d in ordered]
        if op == "sum":
            return sum(arrays[1:], arrays[0].copy())
        if op == "mean":
            return sum(arrays[1:], arrays[0].copy()) / len(arrays)
        if op == "max":
            return np.maximum.reduce(arrays)
        if op == "min":
            return np.minimum.reduce(arrays)
        if op == "reducescatter":
            total = sum(arrays[1:], arrays[0].copy())
            return np.array_split(total, self.world_size)
        raise ValueError(f"unknown op {op}")

    # -- point to point ------------------------------------------------

    def put_p2p(self, tag: Any, payload: Any) -> None:
        with self._mailbox_cv:
            self._mailbox[tag] = payload
            self._mailbox_cv.notify_all()

    def get_p2p(self, tag: Any, timeout: float = 300.0) -> Any:
        deadline = time.monotonic() + timeout
        with self._mailbox_cv:
            while tag not in self._mailbox:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"recv timed out for {tag}")
                self._mailbox_cv.wait(timeout=min(remaining, 1.0))
            return self._mailbox.pop(tag)


def _coordinator_name(group_name: str) -> str:
    return f"COLLECTIVE_GROUP::{group_name}"


def init_collective_group(world_size: int, rank: int, *,
                          group_name: str = "default") -> None:
    """Join a collective group (reference collective.py:120). Call once
    per participating process/actor; rank 0's call may create the
    coordinator, every call rendezvouses on the same named actor."""
    import ray_tpu_torch

    if group_name in _GROUP_STATE:
        raise ValueError(f"group {group_name!r} already initialized here")
    name = _coordinator_name(group_name)
    coordinator = None
    try:
        coordinator = ray_tpu_torch.get_actor(name, namespace="collective")
    except Exception:  # noqa: BLE001 - first joiner creates it
        pass
    if coordinator is None:
        cls = ray_tpu_torch.remote(CollectiveCoordinator)
        try:
            coordinator = cls.options(
                name=name, namespace="collective", num_cpus=0,
                max_concurrency=max(4, world_size * 2)).remote(world_size)
        except ValueError:  # raced another creator
            coordinator = ray_tpu_torch.get_actor(name, namespace="collective")
    ray_tpu_torch.get(coordinator.ping.remote(), timeout=120)
    _GROUP_STATE[group_name] = _LocalGroup(coordinator, world_size, rank,
                                           group_name)


def destroy_collective_group(group_name: str = "default") -> None:
    state = _GROUP_STATE.pop(group_name, None)
    if state is not None and state.rank == 0:
        import ray_tpu_torch
        try:
            ray_tpu_torch.kill(state.coordinator)
        except Exception:  # noqa: BLE001 - coordinator already dead
            pass


def _group(group_name: str) -> _LocalGroup:
    if group_name not in _GROUP_STATE:
        raise RuntimeError(
            f"collective group {group_name!r} not initialized in this "
            "process; call init_collective_group first")
    return _GROUP_STATE[group_name]


def _collective(op: str, data: Any, group_name: str) -> Any:
    import ray_tpu_torch
    g = _group(group_name)
    round_id = g.next_round()
    return ray_tpu_torch.get(
        g.coordinator.contribute.remote(round_id, op, g.rank, data),
        timeout=600)


def allreduce(array: np.ndarray, *, op: str = "sum",
              group_name: str = "default") -> np.ndarray:
    """reference collective.py:258."""
    assert op in ("sum", "mean", "max", "min")
    return _collective(op, np.asarray(array), group_name)


def allgather(array: np.ndarray, *,
              group_name: str = "default") -> List[np.ndarray]:
    return _collective("allgather", np.asarray(array), group_name)


def reducescatter(array: np.ndarray, *,
                  group_name: str = "default") -> np.ndarray:
    """reference collective.py:472: sum-reduce then return this rank's
    1/world chunk (split along axis 0)."""
    return _collective("reducescatter", np.asarray(array), group_name)


def broadcast(array: Optional[np.ndarray], src_rank: int = 0, *,
              group_name: str = "default") -> np.ndarray:
    g = _group(group_name)
    payload = np.asarray(array) if g.rank == src_rank else None
    return _collective("broadcast", payload, group_name)


def reduce(array: np.ndarray, dst_rank: int = 0, *, op: str = "sum",
           group_name: str = "default") -> Optional[np.ndarray]:
    """Reduction delivered to dst only (others get None)."""
    g = _group(group_name)
    out = _collective(op, np.asarray(array), group_name)
    return out if g.rank == dst_rank else None


def barrier(group_name: str = "default") -> None:
    _collective("barrier", None, group_name)


def send(array: np.ndarray, dst_rank: int, *,
         group_name: str = "default") -> None:
    """reference collective.py:531. Pair each send with exactly one recv
    on the destination; rounds count per (src, dst) pair."""
    import ray_tpu_torch
    g = _group(group_name)
    round_id = g.next_p2p_round(g.rank, dst_rank)
    ray_tpu_torch.get(g.coordinator.put_p2p.remote(
        (round_id, g.rank, dst_rank), np.asarray(array)), timeout=600)


def recv(src_rank: int, *, group_name: str = "default") -> np.ndarray:
    import ray_tpu_torch
    g = _group(group_name)
    round_id = g.next_p2p_round(src_rank, g.rank)
    return ray_tpu_torch.get(g.coordinator.get_p2p.remote(
        (round_id, src_rank, g.rank)), timeout=600)
