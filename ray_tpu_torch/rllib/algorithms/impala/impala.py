"""IMPALA: async actor-critic with V-trace off-policy correction.

The port's counterpart of ray_tpu/rllib/algorithms/impala/impala.py
(reference parity: rllib/algorithms/impala/impala.py:68 (ImpalaConfig),
:559 (Impala), training_step :692-780 — async sample gathering with
bounded in-flight requests per runner (FaultTolerantActorManager),
fragments buffered up to `train_batch_size`, a background learner thread
decoupling updates from the sample loop, mixin replay
(`replay_proportion` over a bounded slot buffer), and targeted weight
sync only to runners whose batches were consumed (:775); ImpalaLearner
(impala_learner.py:52)). A local learner is fed through a DeviceFeed: on
the card, pinned host slots copied on a side stream while the previous
update runs.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._private import spans as _spans
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.impala.vtrace import \
    from_importance_weights
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.util import cuda_sentinel


class ImpalaConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or Impala)
        self.lr = 5e-4
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.clip_rho_threshold = 1.0
        self.clip_pg_rho_threshold = 1.0
        self.rollout_fragment_length = 50
        self.train_batch_size = 500
        self.grad_clip = 40.0
        self.max_requests_in_flight_per_env_runner = 2
        self.broadcast_interval = 1
        # mixin replay (reference impala.py replay_proportion /
        # replay_buffer_num_slots): ratio of replayed to fresh fragments
        # mixed into each train batch.
        self.replay_proportion = 0.0
        self.replay_buffer_num_slots = 16
        # bounded learner queue: sampling backpressures on a slow learner
        self.learner_queue_size = 4


class ImpalaLearner(Learner):
    """V-trace actor-critic loss on time-major sequence batches."""

    def _vtrace_prelude(self, batch):
        """Shared forward + V-trace computation (used by IMPALA's
        policy-gradient loss and APPO's clipped surrogate)."""
        t, b = batch["actions"].shape
        obs_flat = batch["obs"].reshape((t * b,) + batch["obs"].shape[2:])
        out = self.module.forward_train({"obs": obs_flat})
        logits = out["action_dist_inputs"].reshape(
            (t, b) + out["action_dist_inputs"].shape[1:])
        values = out["vf_preds"].reshape(t, b)
        dist = self.module.action_dist(logits)
        target_logp = dist.logp(batch["actions"])

        log_rhos = target_logp - batch["behaviour_logp"]
        discounts = self.config.gamma * (
            1.0 - batch["dones"].to(values.dtype))
        vtrace = from_importance_weights(
            log_rhos, discounts, batch["rewards"], values,
            batch["bootstrap_value"],
            self.config.clip_rho_threshold,
            self.config.clip_pg_rho_threshold)
        return dist, target_logp, log_rhos, values, vtrace

    def compute_loss(self, batch, extra):
        dist, target_logp, _log_rhos, values, vtrace = \
            self._vtrace_prelude(batch)
        pg_loss = -torch.mean(target_logp * vtrace.pg_advantages)
        vf_loss = 0.5 * torch.mean((vtrace.vs - values) ** 2)
        entropy = torch.mean(dist.entropy())
        loss = (pg_loss + self.config.vf_loss_coeff * vf_loss
                - self.config.entropy_coeff * entropy)
        return loss, {"policy_loss": pg_loss, "vf_loss": vf_loss,
                      "entropy": entropy}

    def _full_batch_step(self, batch) -> Dict[str, torch.Tensor]:
        with _spans.span("learner.update", num_iters=1):
            assert self._optimizer is not None, "call build() first"
            dev = {k: self._on_device(v) for k, v in batch.items()}
            with self._state_lock:
                return self._step(dev, self.extra_inputs())

    def update(self, batch, minibatch_size=None, num_iters=1, seed=0):
        """Sequence batches update in one full-batch step (the reference
        ImpalaLearner also consumes whole trajectories per update).

        Stats lag one update: reading the fresh stats would block the
        host on the device, so their copy to pinned host memory is
        started without blocking, behind an event, and the PREVIOUS
        update's stats are returned once their event has completed (a
        non-blocking copy read before its event gives stale numbers).
        The first update returns its own."""
        stats = self._full_batch_step(batch)
        keys = list(stats)
        vec = torch.stack([stats[k].detach().double() for k in keys])
        event = None
        if vec.is_cuda:
            host = torch.empty(vec.shape, dtype=vec.dtype, pin_memory=True)
            host.copy_(vec, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(vec.device))
        else:
            host = vec
        prev = getattr(self, "_pending_stats", None)
        self._pending_stats = (keys, host, event)
        if prev is None:
            prev = self._pending_stats
        keys, host, event = prev
        if event is not None:
            event.synchronize()
        return dict(zip(keys, host.tolist()))

    def update_distributed(self, local_batch, minibatch_size=None,
                           num_iters=1, seed=0):
        """A gang rank's update: one full-batch step on its shard, whose
        grads the ranks average (the JAX package's gang path takes one
        step and reads its stats at once, unlagged)."""
        stats = self._full_batch_step(local_batch)
        keys = list(stats)
        # one forcing point for every stat
        host = torch.stack([stats[k].detach().double() for k in keys]).cpu()
        return dict(zip(keys, host.tolist()))

    def data_axis_for(self, key: str) -> int:
        # time-major [T, B] sequences: the env/batch axis is 1; the
        # per-sequence bootstrap values are [B].
        return _batch_axis(key)


def _to_timemajor(fragment: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Runner fragments are already [T, N, ...] time-major; rename
    columns to the learner's contract."""
    return {
        "obs": fragment["obs"],
        "actions": fragment["actions"],
        "rewards": fragment["rewards"],
        "dones": (fragment["terminateds"] | fragment["truncateds"]),
        "behaviour_logp": fragment["action_logp"],
        "bootstrap_value": fragment["bootstrap_value"],
    }


def _batch_axis(key: str) -> int:
    """Concat axis for time-major [T, B] columns ([B] bootstrap)."""
    return 0 if key == "bootstrap_value" else 1


def _concat_fragments(frags: List[Dict[str, np.ndarray]]
                      ) -> Dict[str, np.ndarray]:
    """Stack same-T fragments along the batch (env) axis."""
    out: Dict[str, np.ndarray] = {}
    for k in frags[0]:
        axis = _batch_axis(k)
        out[k] = frags[0][k] if len(frags) == 1 else np.concatenate(
            [f[k] for f in frags], axis=axis)
    return out


class Impala(Algorithm):
    learner_cls = ImpalaLearner

    def __init__(self, config):
        super().__init__(config)
        self._mgr = None                      # built on first async step
        self._fresh: List[Dict[str, np.ndarray]] = []
        self._fresh_steps = 0
        self._replay: collections.deque = collections.deque(
            maxlen=config.replay_buffer_num_slots)
        self._replay_rng = np.random.default_rng(config.seed or 0)
        self._train_queue: "queue.Queue" = queue.Queue(
            maxsize=config.learner_queue_size)
        self._learner_thread: Optional[threading.Thread] = None
        self._stop_event = threading.Event()
        self._stats_lock = threading.Lock()
        self._learner_stats: Dict[str, float] = {}
        self._learner_error: Optional[BaseException] = None
        self._steps_trained = 0
        self._updates_done = 0
        self._feed = None
        self._stage = None                    # HostStage (local learner)
        self._last_reported_trained = 0
        self._weights_version = 0
        self._synced_version = 0
        self._touched_ids: set = set()

    # ---- background learner (reference legacy _LearnerThread) --------

    def _ensure_learner_thread(self) -> None:
        if self._learner_thread is not None:
            return
        # a local learner's DeviceFeed: the copy of batch k+1 overlaps
        # update k (SURVEY §7.3 EnvRunner→Learner throughput); gang
        # learners receive host batches over RPC instead
        local = self.learner_group._local
        if local is not None:
            from ray_tpu_torch.rllib.utils.device_feed import DeviceFeed
            self._feed = DeviceFeed(self._train_queue, local.device,
                                    stop_event=self._stop_event)
        self._learner_thread = threading.Thread(
            target=self._learner_loop, daemon=True, name="impala-learner")
        self._learner_thread.start()

    def _learner_loop(self) -> None:
        # goodput ledger for the learner thread: sampling starvation
        # is feed_stall, LearnerGroup.update opens productive_step,
        # unwrapped remainder is honest idle
        from ray_tpu_torch._private import goodput
        goodput.ledger("impala").bind()
        try:
            if self._feed is not None and self._feed.device.type == "cuda":
                torch.cuda.set_device(self._feed.device)
            while not self._stop_event.is_set():
                try:
                    if self._feed is not None:
                        batch, steps = self._feed.get(timeout=0.2)
                    else:
                        with goodput.bucket("feed_stall"):
                            batch, steps = self._train_queue.get(
                                timeout=0.2)
                except queue.Empty:
                    continue
                t0 = time.perf_counter()
                with _spans.span("learner.step", steps=steps), \
                        cuda_sentinel.step_region("learner.step"):
                    stats = self.learner_group.update(batch)
                if self._feed is not None:
                    self._feed.add_busy(time.perf_counter() - t0)
                with self._stats_lock:
                    self._learner_stats = stats
                    self._steps_trained += steps
                    self._updates_done += 1
                    self._weights_version += 1
        except BaseException as e:  # noqa: BLE001 - raised by train()
            self._learner_error = e

    def _assemble_train_batch(self, staged: bool = False
                              ) -> Optional[tuple]:
        """Once train_batch_size fresh steps accumulated: drain them, mix
        in replayed fragments per replay_proportion, and return
        (batch, steps). Shared by the async and sync paths. With
        staged=True (local-learner async path) the fragments are copied
        into a reusable HostStage slot instead of a fresh concatenation
        — the DeviceFeed ships the slot's per-dtype segments and recycles
        it once the copy lands."""
        cfg = self.config
        if self._fresh_steps < cfg.train_batch_size:
            return None
        frags = list(self._fresh)
        self._fresh = []
        steps = self._fresh_steps
        self._fresh_steps = 0
        for f in frags:
            self._replay.append(f)
        if cfg.replay_proportion > 0 and len(self._replay) > len(frags):
            n_replay = max(0, round(cfg.replay_proportion * len(frags)))
            for _ in range(n_replay):
                f = self._replay[self._replay_rng.integers(
                    len(self._replay))]
                frags.append(f)
                steps += f["actions"].size
        if staged:
            if self._stage is None:
                from ray_tpu_torch.rllib.utils.device_feed import HostStage
                self._stage = HostStage(cfg.learner_queue_size + 4,
                                        self.learner_group._local.device)
            return self._stage.assemble(frags, _batch_axis), steps
        return _concat_fragments(frags), steps

    def _maybe_enqueue_batch(self) -> int:
        # staged slots only work when a local learner's DeviceFeed
        # recycles them; gang learners get plain concatenated batches
        assembled = self._assemble_train_batch(
            staged=self.learner_group._local is not None)
        if assembled is None:
            return 0
        batch, steps = assembled
        # Bounded queue gives sampling backpressure on a slow learner; the
        # poll loop keeps a dead learner thread from deadlocking us here.
        while True:
            if self._learner_error is not None:
                raise self._learner_error
            try:
                self._train_queue.put((batch, steps), timeout=1.0)
                return steps
            except queue.Full:
                continue

    # ---- the training step -------------------------------------------

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        if not self.env_runners.actors:
            return self._training_step_sync()

        import ray_tpu_torch
        from ray_tpu_torch.util.actor_manager import FaultTolerantActorManager

        if self._learner_error is not None:
            raise self._learner_error
        self._ensure_learner_thread()
        if self._mgr is None:
            self._mgr = FaultTolerantActorManager(
                self.env_runners.actors,
                max_remote_requests_in_flight_per_actor=(
                    cfg.max_requests_in_flight_per_env_runner),
                health_probe_method="ping")
        per_request = cfg.rollout_fragment_length \
            * cfg.num_envs_per_env_runner

        # keep every healthy runner saturated (reference impala.py:692-706)
        self._mgr.foreach_actor_async(("sample", (per_request,), None))
        results = self._mgr.fetch_ready_async_reqs(timeout_seconds=2.0)
        enqueued = 0
        for r in results:
            if not r.ok:
                continue
            fragment = r.value
            self._record_episode_metrics([fragment])
            self._timesteps_total += fragment["actions"].size
            self._fresh.append(_to_timemajor(fragment))
            self._fresh_steps += fragment["actions"].size
            self._touched_ids.add(r.actor_id)
            enqueued += self._maybe_enqueue_batch()

        # targeted weight sync: only runners that contributed since the
        # last broadcast, only when the learner produced new weights
        with self._stats_lock:
            version = self._weights_version
            stats = dict(self._learner_stats)
            trained_total = self._steps_trained
            updates = self._updates_done
        # per-iteration delta (PPO-consistent semantics); the lifetime
        # total is reported separately
        trained_delta = trained_total - self._last_reported_trained
        self._last_reported_trained = trained_total
        if version > self._synced_version and self._touched_ids and \
                self._iteration % cfg.broadcast_interval == 0:
            weights = self.learner_group.get_weights()
            actors = self._mgr.actors()
            targets = [actors[i] for i in self._touched_ids
                       if i in actors]
            ray_tpu_torch.get([a.set_weights.remote(weights)
                               for a in targets], timeout=300)
            self._synced_version = version
            self._touched_ids.clear()
        if self._iteration % 10 == 9:
            self._mgr.probe_unhealthy_actors(timeout_seconds=2.0)
        result = {
            "learner": stats,
            "num_env_steps_trained": trained_delta,
            "num_env_steps_trained_total": trained_total,
            "num_updates_total": updates,
            "num_env_steps_enqueued": enqueued,
            "learner_queue_depth": self._train_queue.qsize(),
            "num_healthy_env_runners": self._mgr.num_healthy_actors(),
        }
        if self._feed is not None:
            result["device_feed"] = self._feed.stats()
        return result

    def _training_step_sync(self) -> Dict[str, Any]:
        """Degenerate num_env_runners=0 mode: local sampling, but still
        buffered to train_batch_size with mixin replay."""
        cfg = self.config
        fragments = self.env_runners.sample_sync(
            cfg.rollout_fragment_length * cfg.num_envs_per_env_runner)
        self._record_episode_metrics(fragments)
        stats: Dict[str, float] = {}
        trained_delta = 0
        for f in fragments:
            self._timesteps_total += f["actions"].size
            self._fresh.append(_to_timemajor(f))
            self._fresh_steps += f["actions"].size
        assembled = self._assemble_train_batch()
        if assembled is not None:
            batch, steps = assembled
            stats = self.learner_group.update(batch)
            trained_delta = steps
            with self._stats_lock:
                self._steps_trained += steps
            self.env_runners.sync_weights(self.learner_group.get_weights())
        return {"learner": stats,
                "num_env_steps_trained": trained_delta,
                "num_env_steps_trained_total": self._steps_trained}

    def stop(self) -> None:
        self._stop_event.set()
        if self._learner_thread is not None:
            self._learner_thread.join(timeout=10)
        if self._feed is not None:
            self._feed.stop()
        self._mgr = None
        super().stop()
