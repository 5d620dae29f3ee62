"""DQN: double/dueling deep Q-learning with (prioritized) replay.

The port's counterpart of ray_tpu/rllib/algorithms/dqn/dqn.py (reference
parity: rllib/algorithms/dqn/dqn.py (DQNConfig :100 — dueling, double_q,
n_step, target_network_update_freq, replay buffer config, epsilon
schedule; training_step :510 — sample → store → replay-sample → train →
priority update → target sync) and dqn_torch_policy.py (build_q_losses:
Huber TD error, double-Q argmax from the online net)). The TD update runs
on the learner's device through autograd; the target network is a frozen
copy of the Q-module on that device, refreshed in place by
additional_update; epsilon-greedy runs in the runner's forward with
epsilon in the batch and draws from the runner's torch.Generator.
"""

from __future__ import annotations

import copy
import queue
import threading
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.catalog import _he_init, _mlp, _mlp_apply
from ray_tpu_torch.rllib.core.learner import Learner, _to_numpy, _to_torch
from ray_tpu_torch.rllib.core.rl_module import Categorical, RLModule
from ray_tpu_torch.rllib.utils.replay_buffers import (PrioritizedReplayBuffer,
                                                      ReplayBuffer)
from ray_tpu_torch.rllib.utils.schedules import LinearSchedule


class DQNConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or DQN)
        self.lr = 5e-4
        self.train_batch_size = 32
        self.rollout_fragment_length = 4
        self.num_epochs = 1
        self.minibatch_size = None
        # DQN-specific (reference dqn.py:100 DQNConfig.training)
        self.dueling = True
        self.double_q = True
        self.n_step = 1
        self.buffer_size = 50_000
        self.prioritized_replay = False
        self.prioritized_replay_alpha = 0.6
        self.prioritized_replay_beta = 0.4
        self.num_steps_sampled_before_learning_starts = 1000
        self.target_network_update_freq = 500   # in sampled timesteps
        # trained/sampled ratio; None -> the reference's "natural value"
        # train_batch_size / rollout_fragment_length (dqn.py
        # calculate_rr_weights semantics)
        self.training_intensity = None
        # epsilon-greedy schedule (reference EpsilonGreedy exploration)
        self.initial_epsilon = 1.0
        self.final_epsilon = 0.02
        self.epsilon_timesteps = 10_000
        # distributed replay plane (APEX pattern, reference
        # apex_dqn.py): >0 moves replay out of the driver into
        # ReplayShardActors and decouples sample→store from
        # replay→train into async loops. Needs num_env_runners > 0;
        # with 0 runner actors the sync in-driver path runs regardless.
        self.num_replay_shards = 0
        self.replay_shard_capacity = None   # None -> buffer_size/shards
        self.replay_max_inflight_pushes = 4  # per shard, then shed
        self.replay_sample_inflight = 2      # pipelined pulls per shard
        self.replay_queue_depth = 4          # staged-batch queue bound
        self.max_requests_in_flight_per_env_runner = 2


class DuelingQMLPModule(RLModule):
    """Q-network MLP; dueling decomposition Q = V + A - mean(A)
    (reference dqn_torch_model.py). forward_exploration is epsilon-greedy
    over Q with epsilon read from the batch (put there by the runner).
    Layers sit in ModuleLists named as the JAX package's params pytree
    ({"torso", "adv", "val"}), for params_from_jax."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hiddens: Sequence[int] = (64, 64), dueling: bool = True):
        super().__init__()
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hiddens = tuple(hiddens)
        self.dueling = dueling
        self.torso = _mlp([obs_dim, *self.hiddens])
        self.adv = _mlp([self.hiddens[-1], num_actions])
        if dueling:
            self.val = _mlp([self.hiddens[-1], 1])
        self.init_params(0)

    def init_params(self, seed: int) -> None:
        gen = torch.Generator().manual_seed(seed)
        _he_init(self.torso, gen)
        _he_init(self.adv, gen, scale_last=0.01)
        if self.dueling:
            _he_init(self.val, gen, scale_last=1.0)

    def forward_train(self, batch):
        obs = batch["obs"].to(self.adv[0].weight.dtype)
        h = torch.relu(_mlp_apply(self.torso, obs))
        adv = _mlp_apply(self.adv, h)
        if self.dueling:
            val = _mlp_apply(self.val, h)
            q = val + adv - torch.mean(adv, dim=-1, keepdim=True)
        else:
            q = adv
        return {"action_dist_inputs": q, "vf_preds": torch.amax(q, dim=-1)}

    def forward_exploration(self, batch, generator):
        out = self.forward_train(batch)
        q = out["action_dist_inputs"]
        greedy = torch.argmax(q, dim=-1)
        eps = batch.get("epsilon", 0.0)
        rand = torch.randint(0, self.num_actions, greedy.shape,
                             generator=generator, device=q.device)
        explore = torch.rand(greedy.shape, generator=generator,
                             device=q.device) < eps
        out["actions"] = torch.where(explore, rand, greedy)
        out["action_logp"] = torch.zeros(greedy.shape, dtype=q.dtype,
                                         device=q.device)
        return out

    def action_dist(self, dist_inputs) -> Categorical:
        return Categorical(dist_inputs)


def fragment_to_transitions(fragment: Dict[str, Any], gamma: float,
                            n_step: int = 1) -> Dict[str, np.ndarray]:
    """Rollout fragment [T, N, ...] -> flat n-step transition batch.

    One transition per collected timestep (nothing dropped). A window
    starting at t accumulates gamma^j * r_{t+j} until the first episode
    end, the n-th step, or the fragment boundary — whichever comes first
    (reference assembles the same windows in
    rllib/utils/replay_buffers/utils.py). Truncation is handled exactly:
    raw (unfolded) rewards accumulate, the done flag is set only on
    *termination*, and truncated/clipped windows bootstrap from the true
    next observation (the runner's sparse final_obs) with the window's
    own discount gamma^(len) carried in the "discounts" column — so the
    target network supplies the bootstrap at *update* time, never a
    value frozen at collection time.
    """
    assert n_step >= 1
    obs = np.asarray(fragment["obs"])
    raw = np.asarray(fragment.get("raw_rewards", fragment["rewards"]),
                     np.float32)
    terms = np.asarray(fragment["terminateds"])
    truncs = np.asarray(fragment["truncateds"])
    dones = terms | truncs
    t_len, n_envs = raw.shape

    # obs after step t (autoreset where done) -> replace done rows with
    # the true final observation so truncated windows bootstrap off it
    next_seq = np.concatenate([obs[1:], fragment["last_obs"][None]],
                              axis=0).copy()
    idx = np.asarray(fragment.get("final_obs_idx",
                                  np.zeros((0, 2), np.int64)))
    if idx.size:
        next_seq[idx[:, 0], idx[:, 1]] = fragment["final_obs_vals"]

    acc_r = np.zeros((t_len, n_envs), np.float32)
    done_out = np.zeros((t_len, n_envs), np.float32)
    disc_out = np.zeros((t_len, n_envs), np.float32)
    next_t = np.zeros((t_len, n_envs), np.int64)
    open_ = np.ones((t_len, n_envs), bool)
    for j in range(n_step):
        tmax = t_len - j
        if tmax <= 0:
            break
        alive = open_[:tmax]
        acc_r[:tmax] += np.where(alive, (gamma ** j) * raw[j:], 0.0)
        closes = np.zeros((tmax, n_envs), bool)
        closes |= dones[j:]                  # episode ended at step t+j
        if j == n_step - 1:
            closes[:] = True                 # window reached n steps
        closes[tmax - 1] = True              # t+j hit the fragment end
        closes &= alive
        done_out[:tmax] = np.where(closes, terms[j:].astype(np.float32),
                                   done_out[:tmax])
        disc_out[:tmax] = np.where(closes, gamma ** (j + 1),
                                   disc_out[:tmax])
        tt = np.broadcast_to(np.arange(tmax)[:, None] + j,
                             (tmax, n_envs))
        next_t[:tmax] = np.where(closes, tt, next_t[:tmax])
        open_[:tmax] &= ~closes

    env_ix = np.broadcast_to(np.arange(n_envs), (t_len, n_envs))
    next_obs = next_seq[next_t.ravel(), env_ix.ravel()]

    def flat(x):
        return np.reshape(x, (-1,) + x.shape[2:])

    return {
        "obs": flat(obs),
        "actions": flat(np.asarray(fragment["actions"])),
        "rewards": flat(acc_r),
        "dones": flat(done_out),
        "discounts": flat(disc_out),
        "next_obs": next_obs,
    }


def huber(td: torch.Tensor) -> torch.Tensor:
    return torch.where(td.abs() < 1.0, 0.5 * td ** 2, td.abs() - 0.5)


class DQNLearner(Learner):
    """Huber TD loss against a frozen target copy of the Q-module on the
    learner's device (reference dqn_torch_policy.py build_q_losses +
    QLoss). build() (and so build_distributed(), on every rank) makes the
    copy; additional_update(update_target=True) refreshes it in place."""

    def build(self, seed: int = 0) -> None:
        super().build(seed)
        with self._state_lock:
            self._target = copy.deepcopy(self.module).requires_grad_(False)

    def _copy_target(self) -> None:
        with self._state_lock, torch.no_grad():
            for t, p in zip(self._target.parameters(),
                            self.module.parameters()):
                t.copy_(p)

    def extra_inputs(self) -> Dict[str, Any]:
        return {"target": self._target}

    def compute_loss(self, batch, extra):
        cfg = self.config
        q_all = self.module.forward_train(
            {"obs": batch["obs"]})["action_dist_inputs"]
        actions = batch["actions"].long()
        q = torch.gather(q_all, -1, actions[:, None])[:, 0]

        with torch.no_grad():
            q_next_target = extra["target"].forward_train(
                {"obs": batch["next_obs"]})["action_dist_inputs"]
            if cfg.double_q:
                q_next_online = self.module.forward_train(
                    {"obs": batch["next_obs"]})["action_dist_inputs"]
                a_star = torch.argmax(q_next_online, dim=-1)
                q_next = torch.gather(q_next_target, -1,
                                      a_star[:, None])[:, 0]
            else:
                q_next = torch.amax(q_next_target, dim=-1)
            target = batch["rewards"] + batch["discounts"] * \
                (1.0 - batch["dones"]) * q_next
        td = q - target
        loss_rows = huber(td)
        weights = batch.get("weights")
        loss = torch.mean(loss_rows * weights) if weights is not None \
            else torch.mean(loss_rows)

        stats = {"qf_loss": loss, "mean_q": torch.mean(q),
                 "mean_td_error": torch.mean(td.abs()),
                 "td_error": td.abs()}
        if "batch_indexes" in batch:
            stats["td_indexes"] = batch["batch_indexes"]
        if "item_epochs" in batch:
            # staleness tickets ride to the priority update so a shard
            # can drop updates for slots recycled since the sample
            stats["td_epochs"] = batch["item_epochs"]
        return loss, stats

    def additional_update(self, *, update_target: bool = False,
                          **kw) -> Dict[str, Any]:
        if update_target:
            self._copy_target()
        return {"target_updated": bool(update_target)}

    def get_state(self) -> Dict[str, Any]:
        state = super().get_state()
        with self._state_lock:
            state["target_params"] = _to_numpy(
                dict(self._target.state_dict()))
        return state

    def set_state(self, state: Dict[str, Any]) -> None:
        super().set_state(state)
        with self._state_lock:
            self._target.load_state_dict(_to_torch(state["target_params"]))


class DQN(Algorithm):
    learner_cls = DQNLearner

    def default_module(self, observation_space, action_space):
        """Q-network instead of the actor-critic catalog default."""
        if len(observation_space.shape) != 1:
            raise NotImplementedError(
                f"DQN ships an MLP Q-net for 1-D observations; got "
                f"obs={observation_space}. Pass a custom Q RLModule "
                f"via config.rl_module(module=...) (it must expose "
                f"Q-values as action_dist_inputs and epsilon-greedy "
                f"forward_exploration, see DuelingQMLPModule).")
        return DuelingQMLPModule(
            observation_space.shape[0], action_space.n,
            self.config.model_hiddens, dueling=self.config.dueling)

    def __init__(self, config: "DQNConfig"):
        super().__init__(config)
        if config.prioritized_replay:
            self.replay_buffer: ReplayBuffer = PrioritizedReplayBuffer(
                config.buffer_size, alpha=config.prioritized_replay_alpha,
                seed=config.seed)
        else:
            self.replay_buffer = ReplayBuffer(config.buffer_size,
                                              seed=config.seed)
        self.epsilon_schedule = LinearSchedule(
            config.epsilon_timesteps, config.final_epsilon,
            config.initial_epsilon)
        self._last_target_update = 0
        # distributed replay plane (built lazily on first step)
        self._replay_group = None
        self._runner_mgr = None
        self._writer_spec_version = -1
        self._replay_thread: Optional[threading.Thread] = None
        self._replay_stop = threading.Event()
        self._replay_stats_lock = threading.Lock()
        self._replay_learner_stats: Dict[str, float] = {}
        self._replay_learner_error: Optional[BaseException] = None
        self._replay_steps_trained = 0
        self._replay_updates = 0
        self._replay_weights_version = 0
        self._replay_synced_version = 0
        self._replay_touched: set = set()
        self._replay_feed = None
        self._last_reported_trained = 0

    def _extra_state(self) -> Dict[str, Any]:
        return {"last_target_update": self._last_target_update}

    def _restore_extra_state(self, extra: Dict[str, Any]) -> None:
        self._last_target_update = extra.get(
            "last_target_update", self._last_target_update)

    # ---- hooks (SAC overrides; reference SAC extends DQN too) -------
    def _before_sample(self, stats: Dict[str, Any]) -> None:
        """Push exploration state to runners (epsilon-greedy here)."""
        eps = self.epsilon_schedule(self._timesteps_total)
        self.env_runners.set_explore_inputs({"epsilon": eps})
        stats["epsilon"] = eps

    def _training_intensity(self) -> float:
        cfg = self.config
        return (cfg.training_intensity
                if cfg.training_intensity is not None
                else cfg.train_batch_size / cfg.rollout_fragment_length)

    def _after_each_update(self) -> None:
        """Per-gradient-step target maintenance (SAC: polyak)."""

    def _maybe_update_target(self) -> None:
        """Periodic hard target sync (target_network_update_freq)."""
        if self._timesteps_total - self._last_target_update >= \
                self.config.target_network_update_freq:
            self.learner_group.additional_update(update_target=True)
            self._last_target_update = self._timesteps_total

    # ---- distributed replay plane (APEX pattern) --------------------

    def _learner_device(self):
        """The local learner's device (its batches are staged for it),
        or the CPU when the learners are a gang."""
        local = self.learner_group._local
        return local.device if local is not None else torch.device("cpu")

    def _ensure_replay_plane(self) -> None:
        if self._replay_group is not None:
            return
        cfg = self.config
        from ray_tpu_torch.rllib.utils.replay import ReplayGroup
        from ray_tpu_torch.util.actor_manager import FaultTolerantActorManager
        n = cfg.num_replay_shards
        capacity = cfg.replay_shard_capacity or \
            max(1, cfg.buffer_size // n)
        self._replay_group = ReplayGroup(
            n, capacity,
            prioritized=cfg.prioritized_replay,
            alpha=cfg.prioritized_replay_alpha,
            beta=cfg.prioritized_replay_beta,
            batch_size=cfg.train_batch_size,
            min_size_to_sample=max(
                cfg.train_batch_size,
                cfg.num_steps_sampled_before_learning_starts // n),
            seed=cfg.seed,
            queue_depth=cfg.replay_queue_depth,
            sample_inflight_per_shard=cfg.replay_sample_inflight,
            device=self._learner_device())
        self._replay_group.start()
        self._runner_mgr = FaultTolerantActorManager(
            self.env_runners.actors,
            max_remote_requests_in_flight_per_actor=(
                cfg.max_requests_in_flight_per_env_runner),
            health_probe_method="ping")
        self._install_writer_spec()
        if self._replay_thread is None:
            self._replay_thread = threading.Thread(
                target=self._replay_learner_loop, daemon=True,
                name="dqn-replay-learner")
            self._replay_thread.start()

    def _install_writer_spec(self) -> None:
        """Ship the current shard handle set to every runner — called at
        startup and again whenever the group resharded (a replaced shard
        means the old handles route pushes into a dead actor)."""
        cfg = self.config
        spec = {"shards": self._replay_group.shard_handles(),
                "max_inflight_per_shard": cfg.replay_max_inflight_pushes,
                "gamma": cfg.gamma, "n_step": cfg.n_step}
        self._runner_mgr.foreach_actor(
            ("set_replay_writer", (spec,), None), timeout_seconds=60.0)
        self._writer_spec_version = self._replay_group.reshard_version

    def _replay_learner_loop(self) -> None:
        """replay→train loop: drain staged batches the ReplayGroup
        puller pipelined off the shards (through the DeviceFeed to a
        local learner's device), update, and route TD-error priorities
        back to the issuing shard (one-way)."""
        import time as _time

        from ray_tpu_torch._private import spans as _spans
        from ray_tpu_torch.util import cuda_sentinel

        cfg = self.config
        group = self._replay_group
        # goodput ledger for the replay learner thread: replay-sample
        # starvation is replay_stall (distinct from the on-policy
        # feed_stall — a starved replay plane has different fixes)
        from ray_tpu_torch._private import goodput
        goodput.ledger("dqn").bind()
        if self.learner_group._local is not None:
            from ray_tpu_torch.rllib.utils.device_feed import DeviceFeed
            self._replay_feed = DeviceFeed(group.queue,
                                           self._learner_device(),
                                           stop_event=self._replay_stop,
                                           stall_bucket="replay_stall")
        while not self._replay_stop.is_set():
            staged = None
            try:
                if self._replay_feed is not None:
                    batch, meta = self._replay_feed.get(timeout=0.2)
                else:
                    with goodput.bucket("replay_stall"):
                        staged, meta = group.queue.get(timeout=0.2)
                    batch = staged.as_dict()
            except queue.Empty:
                continue
            except BaseException as e:  # noqa: BLE001 - the feeder died
                self._replay_learner_error = e
                return
            try:
                t0 = _time.perf_counter()
                with _spans.span("learner.step",
                                 steps=cfg.train_batch_size), \
                        cuda_sentinel.step_region("learner.step"):
                    st = self.learner_group.update(
                        batch, minibatch_size=None, num_iters=1,
                        seed=(cfg.seed or 0) + self._replay_updates)
                if self._replay_feed is not None:
                    self._replay_feed.add_busy(
                        _time.perf_counter() - t0)
            except BaseException as e:  # noqa: BLE001
                self._replay_learner_error = e
                return
            finally:
                if staged is not None:
                    staged.release()
            if group.prioritized and "td_error" in st:
                group.update_priorities(
                    meta.get("shard_id"),
                    np.asarray(st["td_indexes"], np.int64),
                    np.asarray(st["td_error"], np.float64),
                    np.asarray(st["td_epochs"], np.int64)
                    if "td_epochs" in st else None)
            self._after_each_update()
            with self._replay_stats_lock:
                self._replay_learner_stats = {
                    k: float(v) for k, v in st.items()
                    if not getattr(v, "ndim", 0)}
                self._replay_steps_trained += cfg.train_batch_size
                self._replay_updates += 1
                self._replay_weights_version += 1

    def _training_step_replay_plane(self) -> Dict[str, Any]:
        """sample→store and replay→train as decoupled async loops: env
        runners push transitions straight to the replay shards (only
        metadata returns here), the group's puller keeps sample RPCs
        pipelined, and the learner thread trains off the staged queue."""
        import ray_tpu_torch

        cfg = self.config
        if self._replay_learner_error is not None:
            raise self._replay_learner_error
        self._ensure_replay_plane()
        stats: Dict[str, Any] = {}
        self._before_sample(stats)
        per_request = cfg.rollout_fragment_length \
            * cfg.num_envs_per_env_runner
        self._runner_mgr.foreach_actor_async(
            ("sample_to_replay", (per_request,), None))
        results = self._runner_mgr.fetch_ready_async_reqs(
            timeout_seconds=2.0)
        sampled = 0
        writer_stats: Dict[str, int] = {}
        for r in results:
            if not r.ok:
                continue
            meta = r.value
            sampled += meta["steps"]
            self._record_episode_metrics([meta])
            self._replay_touched.add(r.actor_id)
            writer_stats = meta.get("writer", writer_stats)
        self._timesteps_total += sampled
        # a reshard invalidates the shard handles baked into runner
        # writers — re-ship the spec before more pushes go astray
        if self._replay_group.reshard_version != \
                self._writer_spec_version:
            self._install_writer_spec()
        with self._replay_stats_lock:
            version = self._replay_weights_version
            lstats = dict(self._replay_learner_stats)
            trained_total = self._replay_steps_trained
            updates_total = self._replay_updates
        trained_delta = trained_total - self._last_reported_trained
        self._last_reported_trained = trained_total
        if version > self._replay_synced_version and \
                self._replay_touched:
            weights = self.learner_group.get_weights()
            actors = self._runner_mgr.actors()
            targets = [actors[i] for i in self._replay_touched
                       if i in actors]
            ray_tpu_torch.get(
                [a.set_weights.remote(weights) for a in targets],
                timeout=300)
            self._replay_synced_version = version
            self._replay_touched.clear()
        self._maybe_update_target()
        if self._iteration % 10 == 9:
            self._runner_mgr.probe_unhealthy_actors(timeout_seconds=2.0)
            self._replay_group.probe_unhealthy()
        stats.update(lstats)
        return {
            "learner": stats,
            "num_env_steps_sampled": sampled,
            "num_env_steps_trained": trained_delta,
            "num_env_steps_trained_total": trained_total,
            "num_updates_total": updates_total,
            "replay": self._replay_group.stats(),
            "replay_writer": writer_stats,
            "num_healthy_env_runners":
                self._runner_mgr.num_healthy_actors(),
            "device_feed": (self._replay_feed.stats()
                            if self._replay_feed is not None else {}),
        }

    def stop(self) -> None:
        self._replay_stop.set()
        if self._replay_thread is not None:
            self._replay_thread.join(timeout=10)
            self._replay_thread = None
        if self._replay_feed is not None:
            self._replay_feed.stop()
            self._replay_feed = None
        if self._replay_group is not None:
            self._replay_group.stop()
            self._replay_group = None
        super().stop()

    # ---- the shared replay loop -------------------------------------
    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        if cfg.num_replay_shards > 0 and self.env_runners.actors:
            return self._training_step_replay_plane()
        # --- explore + sample (reference dqn.py training_step) -------
        stats: Dict[str, Any] = {}
        self._before_sample(stats)
        fragments = self.env_runners.sample_sync(
            cfg.rollout_fragment_length * cfg.num_envs_per_env_runner)
        self._record_episode_metrics(fragments)
        sampled = 0
        for f in fragments:
            trans = fragment_to_transitions(f, cfg.gamma, cfg.n_step)
            self.replay_buffer.add(trans)
            sampled += f["rewards"].size
        self._timesteps_total += sampled

        # --- replay train --------------------------------------------
        if self.replay_buffer.num_added >= \
                cfg.num_steps_sampled_before_learning_starts:
            num_updates = max(1, round(
                sampled * self._training_intensity()
                / cfg.train_batch_size))
            agg: Dict[str, float] = {}
            for u in range(num_updates):
                if isinstance(self.replay_buffer, PrioritizedReplayBuffer):
                    batch = self.replay_buffer.sample(
                        cfg.train_batch_size,
                        beta=cfg.prioritized_replay_beta)
                else:
                    batch = self.replay_buffer.sample(cfg.train_batch_size)
                st = self.learner_group.update(
                    batch, minibatch_size=None, num_iters=1,
                    seed=cfg.seed + self._iteration * 1000 + u)
                if isinstance(self.replay_buffer, PrioritizedReplayBuffer) \
                        and "td_error" in st:
                    self.replay_buffer.update_priorities(
                        np.asarray(st["td_indexes"], np.int64),
                        np.asarray(st["td_error"]))
                self._after_each_update()
                for k, v in st.items():
                    if not getattr(v, "ndim", 0):
                        agg[k] = agg.get(k, 0.0) + float(v)
            stats.update({k: v / num_updates for k, v in agg.items()})
            stats["num_updates"] = num_updates
            self._maybe_update_target()
            # --- weight sync -----------------------------------------
            self.env_runners.sync_weights(self.learner_group.get_weights())
        return {"learner": stats, "num_env_steps_sampled": sampled,
                "replay_buffer_size": len(self.replay_buffer)}
