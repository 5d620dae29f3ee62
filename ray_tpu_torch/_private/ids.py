"""Binary IDs for jobs/tasks/actors/objects/nodes/placement groups.

Mirrors the reference's ID scheme (reference: src/ray/common/id.h) in spirit:
fixed-width random binary ids with embedded structure — an ObjectID embeds the
TaskID that produced it plus a return/put index, a TaskID embeds its JobID —
so lineage can be read off an id without a directory lookup.
"""

from __future__ import annotations

import os
import random
import struct
from typing import Optional

# Process-local id entropy. os.urandom is a syscall per call — measured
# at hundreds of µs under syscall-filtered sandboxes — and id minting
# sits on the per-task hot path (TaskID + trace id + lease id). One
# urandom seed per PROCESS feeds a userspace PRNG instead; distinct
# processes get distinct seeds, so cross-process uniqueness matches
# urandom's for our id widths. Re-seeded when the pid changes: a forked
# child inheriting the parent's PRNG state would mint the parent's
# exact id stream.
_rng: Optional[random.Random] = None
_rng_pid: Optional[int] = None


def rand_bytes(n: int) -> bytes:
    """Fast unique-id entropy (NOT for cryptographic use)."""
    global _rng, _rng_pid
    pid = os.getpid()
    rng = _rng
    if rng is None or _rng_pid != pid:
        rng = _rng = random.Random(os.urandom(16))
        _rng_pid = pid
    return rng.getrandbits(n * 8).to_bytes(n, "big")


class BaseID:
    SIZE = 16
    __slots__ = ("_bin", "_hex")

    def __init__(self, binary: bytes):
        if len(binary) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {len(binary)}")
        self._bin = binary
        self._hex: Optional[str] = None

    @classmethod
    def from_random(cls) -> "BaseID":
        return cls(rand_bytes(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str) -> "BaseID":
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls) -> "BaseID":
        return cls(b"\x00" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._bin == b"\x00" * self.SIZE

    def binary(self) -> bytes:
        return self._bin

    def hex(self) -> str:
        # memoized: ids are hashed into dict keys on every control-plane
        # hop, ~20x per task submission
        h = self._hex
        if h is None:
            h = self._hex = self._bin.hex()
        return h

    def __hash__(self) -> int:
        return hash((type(self).__name__, self._bin))

    def __eq__(self, other: object) -> bool:
        return type(other) is type(self) and other._bin == self._bin  # type: ignore

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.hex()[:12]}…)"

    def __reduce__(self):
        return (type(self), (self._bin,))


class JobID(BaseID):
    SIZE = 4


class NodeID(BaseID):
    SIZE = 16


class WorkerID(BaseID):
    SIZE = 16


class ActorID(BaseID):
    """12 random bytes + 4-byte job id."""

    SIZE = 16

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(rand_bytes(12) + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._bin[12:16])


class TaskID(BaseID):
    """12 random bytes + 4-byte job id."""

    SIZE = 16

    @classmethod
    def of(cls, job_id: JobID) -> "TaskID":
        return cls(rand_bytes(12) + job_id.binary())

    @classmethod
    def for_actor_creation(cls, actor_id: ActorID) -> "TaskID":
        return cls(actor_id.binary()[:12] + actor_id.job_id().binary())

    def job_id(self) -> JobID:
        return JobID(self._bin[12:16])


class ObjectID(BaseID):
    """TaskID (16) + 4-byte index: which return/put of the task."""

    SIZE = 20
    _IDX = struct.Struct(">I")

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + cls._IDX.pack(index))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        # High bit marks puts, distinguishing them from returns.
        return cls(task_id.binary() + cls._IDX.pack(put_index | 0x80000000))

    def task_id(self) -> TaskID:
        return TaskID(self._bin[:16])

    def return_index(self) -> int:
        return self._IDX.unpack(self._bin[16:20])[0] & 0x7FFFFFFF

    def is_put(self) -> bool:
        return bool(self._IDX.unpack(self._bin[16:20])[0] & 0x80000000)


class PlacementGroupID(BaseID):
    SIZE = 16


def format_id(id_or_none: Optional[BaseID]) -> str:
    return "nil" if id_or_none is None else id_or_none.hex()[:12]
