"""ReplayGroup: driver-side coordinator for the replay shard fleet.

The port's counterpart of ray_tpu/rllib/utils/replay/group.py; its one
edit is the stage: the port's HostStage stages torch tensors for the
learner's device (pinned slots for a learner on the card), so the group
takes that device.

reference parity: rllib/algorithms/apex_dqn/apex_dqn.py APEX's
`training_step` owns the replay actors directly and blocks per sample;
here the coordinator runs a puller thread that keeps
`sample_inflight_per_shard` requests pipelined against every healthy
shard through FaultTolerantActorManager (`foreach_actor_async` +
`fetch_ready_async_reqs`), stages each arriving batch through HostStage
(so the learner's chip-feed sees pooled, fused segments — never a fresh
np.concatenate), and parks it in a bounded queue the learner thread
drains. Backpressure is the queue bound: when the learner falls behind,
the puller blocks before submitting more sample RPCs.

Elasticity: a shard actor death demotes it in the manager; the puller
replaces it inline with a fresh empty shard of the same shard_id
(generation bumped in the named-actor registry), bumps
`reshard_version`, and keeps pulling from the survivors meanwhile —
training never halts, matching the elastic-runner contract.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.utils.device_feed import HostStage
from ray_tpu_torch.rllib.utils.replay.shard import (REPLAY_NAMESPACE,
                                              ReplayShardActor,
                                              shard_actor_name)
from ray_tpu_torch.util.actor_manager import FaultTolerantActorManager


class ReplayGroup:
    """Spawns and coordinates N replay shards for one training job.

    The learner side consumes `group.queue` (items are
    `(StagedBatch, meta)` with `meta["shard_id"]` naming the ticket
    issuer) either directly via `get_batch()` or through a DeviceFeed,
    and routes TD-error priorities back with `update_priorities()` —
    one-way, fire-and-forget, reaped in the background.
    """

    def __init__(self, num_shards: int, capacity: int, *,
                 prioritized: bool = True, alpha: float = 0.6,
                 beta: float = 0.4, batch_size: int = 32,
                 min_size_to_sample: int = 1, seed: Optional[int] = None,
                 name: str = "default", sample_inflight_per_shard: int = 2,
                 queue_depth: int = 4, shard_num_cpus: float = 0.25,
                 device="cpu"):
        assert num_shards > 0
        self.name = name
        self.num_shards = num_shards
        self.capacity = int(capacity)
        self.prioritized = prioritized
        self.alpha = alpha
        self.beta = beta
        self.batch_size = int(batch_size)
        self.min_size_to_sample = int(min_size_to_sample)
        self._seed = seed
        self._shard_num_cpus = shard_num_cpus
        self._gen: Dict[int, int] = {}          # shard_id -> generation
        self._aid_to_sid: Dict[int, int] = {}   # manager id -> shard_id
        self._mgr = FaultTolerantActorManager(
            max_remote_requests_in_flight_per_actor=(
                sample_inflight_per_shard),
            health_probe_method="ping")
        for sid in range(num_shards):
            self._spawn_shard(sid)
        # the learner's device: a learner on the card gets pinned slots
        self._stage = HostStage(queue_depth + 4, device)
        self.queue: "queue.Queue[Tuple[Any, Dict[str, Any]]]" = \
            queue.Queue(maxsize=queue_depth)
        self.reshard_version = 0
        self.shard_replacements = 0
        self.batches_pulled = 0
        self.updates_sent = 0
        self.updates_dropped = 0
        self._update_refs: deque = deque()
        self._stop = threading.Event()
        self._puller: Optional[threading.Thread] = None

    # ---- shard lifecycle -------------------------------------------------

    def _spawn_shard(self, shard_id: int) -> int:
        gen = self._gen.get(shard_id, -1) + 1
        self._gen[shard_id] = gen
        cls = ray_tpu_torch.remote(ReplayShardActor)
        actor = cls.options(
            num_cpus=self._shard_num_cpus,
            name=shard_actor_name(self.name, shard_id, gen),
            namespace=REPLAY_NAMESPACE,
        ).remote(shard_id, self.capacity, prioritized=self.prioritized,
                 alpha=self.alpha, seed=self._seed, group=self.name)
        aid = self._mgr.add_actor(actor)
        self._aid_to_sid[aid] = shard_id
        return aid

    def _replace_dead_shards(self) -> None:
        """Elastic re-add: every unhealthy shard is removed and respawned
        empty under the same shard_id (new generation). The replay data
        it held is lost — acceptable for replay (it refills from the
        runners), unacceptable would be halting training."""
        dead = [aid for aid in list(self._aid_to_sid)
                if not self._mgr.is_actor_healthy(aid)]
        for aid in dead:
            sid = self._aid_to_sid.pop(aid)
            self._mgr.remove_actor(aid)
            self._spawn_shard(sid)
            self.shard_replacements += 1
            self.reshard_version += 1

    def shard_handles(self) -> List[Tuple[int, Any]]:
        """(shard_id, handle) pairs for the current generation — the
        writer spec shipped to env runners (handles are picklable)."""
        actors = self._mgr.actors()
        return sorted(
            ((self._aid_to_sid[aid], actors[aid])
             for aid in actors if aid in self._aid_to_sid),
            key=lambda t: t[0])

    # ---- pull pipeline ---------------------------------------------------

    def start(self) -> None:
        if self._puller is not None:
            return
        self._puller = threading.Thread(
            target=self._pull_loop, name=f"replay-pull-{self.name}",
            daemon=True)
        self._puller.start()

    def _pull_loop(self) -> None:
        sample_call = ("sample",
                       (self.batch_size, self.beta,
                        self.min_size_to_sample), None)
        while not self._stop.is_set():
            self._mgr.foreach_actor_async(sample_call, tag="sample")
            results = self._mgr.fetch_ready_async_reqs(
                timeout_seconds=0.2)
            produced = 0
            saw_failure = False
            for res in results:
                if not res.ok:
                    saw_failure = True
                    continue
                if res.value is None:  # shard below learning-starts gate
                    continue
                staged = self._stage.assemble([res.value], lambda k: 0)
                meta = {"shard_id": self._aid_to_sid.get(res.actor_id)}
                while not self._stop.is_set():
                    try:  # bounded queue IS the backpressure valve
                        self.queue.put((staged, meta), timeout=0.5)
                        produced += 1
                        self.batches_pulled += 1
                        break
                    except queue.Full:
                        continue
                else:
                    staged.release()
            if saw_failure:
                self._replace_dead_shards()
            if not produced and not results:
                self._stop.wait(0.02)
        # drain staged batches the learner will never take
        while True:
            try:
                staged, _ = self.queue.get_nowait()
                staged.release()
            except queue.Empty:
                break

    def get_batch(self, timeout: float = 1.0
                  ) -> Optional[Tuple[Any, Dict[str, Any]]]:
        """One (StagedBatch, meta) from the pull pipeline, or None on
        timeout. Caller owns the StagedBatch and must release() it."""
        try:
            return self.queue.get(timeout=timeout)
        except queue.Empty:
            return None

    # ---- priority feedback (one-way) -------------------------------------

    def update_priorities(self, shard_id: int, idx: np.ndarray,
                          priorities: np.ndarray,
                          epochs: Optional[np.ndarray] = None) -> bool:
        """Route TD-error priorities back to the issuing shard.
        Fire-and-forget: the ref is reaped later, never awaited on the
        training path. Returns False when the shard is gone (its
        replacement is empty — the tickets are meaningless there)."""
        while len(self._update_refs) > 64:  # hard cap, never block
            self._update_refs.popleft()
        if self._update_refs:
            done, _ = ray_tpu_torch.wait(list(self._update_refs),
                                   num_returns=len(self._update_refs),
                                   timeout=0)
            for ref in done:
                self._update_refs.remove(ref)
        handle = None
        actors = self._mgr.actors()
        for aid, sid in self._aid_to_sid.items():
            if sid == shard_id and self._mgr.is_actor_healthy(aid):
                handle = actors.get(aid)
                break
        if handle is None:
            self.updates_dropped += 1
            return False
        self._update_refs.append(
            handle.update_priorities.remote(
                np.asarray(idx), np.asarray(priorities),
                None if epochs is None else np.asarray(epochs)))
        self.updates_sent += 1
        return True

    # ---- health / introspection ------------------------------------------

    def probe_unhealthy(self) -> None:
        self._mgr.probe_unhealthy_actors(timeout_seconds=5.0)
        self._replace_dead_shards()

    def shard_stats(self, timeout: float = 10.0) -> List[Dict[str, Any]]:
        res = self._mgr.foreach_actor("stats",
                                      timeout_seconds=timeout)
        return [r.value for r in res if r.ok]

    def stats(self) -> Dict[str, Any]:
        return {
            "num_shards": self.num_shards,
            "healthy_shards": self._mgr.num_healthy_actors(),
            "reshard_version": self.reshard_version,
            "shard_replacements": self.shard_replacements,
            "batches_pulled": self.batches_pulled,
            "queue_depth": self.queue.qsize(),
            "priority_updates_sent": self.updates_sent,
            "priority_updates_dropped": self.updates_dropped,
        }

    def stop(self) -> None:
        self._stop.set()
        if self._puller is not None:
            self._puller.join(timeout=5.0)
            self._puller = None
        self._mgr.clear()
