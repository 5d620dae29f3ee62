"""LearnerGroup: one local learner or a gang of learner actors.

The port's counterpart of ray_tpu/rllib/core/learner_group.py (reference
parity: rllib/core/learner/learner_group.py:63 — local mode
(num_learners=0, the learner in-process) or remote mode, where learner
actors form one torch.distributed process group, as the reference
LearnerGroup reuses Train's BackendExecutor to build one
(learner_group.py:103-115)). Each gang step averages the ranks' grads
with one all-reduce (Learner.build_distributed), so every learner holds
identical params after every step and Adam's semantics match a single
learner's exactly. On the card each rank holds one GPU and the group is
NCCL; with device="cpu" it is gloo.

Elastic mode (elastic_min_learners set): the gang survives member
death, wedged ranks and explicit resizes. The driver keeps a host-side
state cache (params and optimizer state as numpy, refreshed every
`state_refresh_every` successful updates, default 1 — the gang's
durable checkpoint); when an update loses a rank, a rank wedges
(GangWedgedError from the heartbeat supervisor) or reconfigure() is
called, the gang is drained, re-spawned as fresh processes with a fresh
process group at the new world size (bounded by
elastic_reform_timeout_s, stepping down toward elastic_min_learners
when capacity is short), the cached state is set on every rank
(reshard: each rank slices its data shard by the new world), and the
update is retried — with the same elastic.* span sequence and
reconfiguration metrics as the train plane (train/elastic.py).
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def local_ranks(node_ids: List[str]) -> List[int]:
    """Each gang rank's index among the gang's ranks on its own node,
    from the ranks' node ids in rank order: the card a rank claims (as
    the trainer's workers claim theirs, train/backend_executor.py
    _share_gpu_visibility)."""
    seen: Dict[str, int] = {}
    out = []
    for node in node_ids:
        out.append(seen.get(node, 0))
        seen[node] = out[-1] + 1
    return out


class _MeshLearnerActor:
    """One rank of the learner gang; runs in a fresh worker process (the
    gang's unique runtime-env pool key). It starts without touching CUDA:
    the group reads every rank's node first, and setup() then claims the
    card of the rank's local rank on that node before anything in the
    process touches CUDA, and joins a clean process group."""

    def __init__(self, factory: Callable[[], Any], rank: int,
                 gang_id: str = ""):
        self.rank = rank
        self._factory = factory
        self._store = None
        self._heartbeat = None
        if gang_id:
            from ray_tpu_torch.train.heartbeat import HeartbeatSender
            hb = HeartbeatSender(gang_id, rank)
            if hb.start():
                self._heartbeat = hb

    def node_id(self) -> str:
        import ray_tpu_torch
        return ray_tpu_torch.get_runtime_context().get_node_id()

    def open_store(self, world: int, timeout_s: float) -> Tuple[str, int]:
        """Rank 0: the group's rendezvous store, listening on a port the
        OS picks as it binds (a port picked first and bound later can be
        taken in between by another process); returns its address."""
        import datetime

        import torch.distributed as dist

        from ray_tpu_torch.train.torch_backend import _get_node_ip
        self._store = dist.TCPStore(
            "0.0.0.0", 0, world, is_master=True, wait_for_workers=False,
            timeout=datetime.timedelta(seconds=timeout_s))
        return _get_node_ip(), self._store.port

    def setup(self, local_rank: int, master: Tuple[str, int], world: int,
              seed: int, on_card: bool, timeout_s: float) -> None:
        import datetime

        import torch
        import torch.distributed as dist
        # The "rendezvous" phase BEFORE init_process_group: the
        # rendezvous itself is a collective that can wedge (a peer
        # SIGSTOPped mid-join), and the supervisor can only see that
        # through beats that started first.
        if self._heartbeat is not None:
            self._heartbeat.set_phase("rendezvous")
        if on_card:
            # one card a rank: the node's card at the rank's local rank
            from ray_tpu_torch.train.backend_executor import _claim_gpus
            _claim_gpus([local_rank])
            torch.cuda.set_device(0)
        else:
            torch.set_num_threads(1)  # the ranks share the node's cores
        timeout = datetime.timedelta(seconds=timeout_s)
        store = self._store or dist.TCPStore(
            master[0], master[1], world, is_master=False, timeout=timeout)
        dist.init_process_group(
            backend="nccl" if on_card else "gloo", store=store,
            world_size=world, rank=self.rank, timeout=timeout)
        self.world = world
        self.learner = self._factory()
        self.learner.build_distributed(seed=seed)
        if self._heartbeat is not None:
            self._heartbeat.set_phase("ready")

    def device_report(self) -> Dict[str, Any]:
        """The learner's device, the cards this process sees and the
        process group's backend."""
        import torch
        import torch.distributed as dist
        return {"device": str(self.learner.device),
                "visible_cards": torch.cuda.device_count(),
                "backend": dist.get_backend()}

    def _local_shard(self, batch: Dict[str, np.ndarray]
                     ) -> Dict[str, np.ndarray]:
        """Equal per-rank slices along each column's data axis
        (learner.data_axis_for), truncating the remainder so every rank
        runs identical step counts. Multi-agent batches are nested
        {module_id: {col: array}}; each module's rows shard on their own,
        so every rank holds the same per-module row counts."""
        if batch and all(isinstance(v, dict) for v in batch.values()):
            return {mid: self._local_shard(sub)
                    for mid, sub in batch.items()}
        first = next(iter(batch))
        per = batch[first].shape[self.learner.data_axis_for(first)] \
            // self.world
        out = {}
        for k, v in batch.items():
            sl = [slice(None)] * v.ndim
            sl[self.learner.data_axis_for(k)] = slice(self.rank * per,
                                                      (self.rank + 1) * per)
            out[k] = v[tuple(sl)]
        return out

    def update(self, batch, minibatch_size, num_iters, seed):
        if self._heartbeat is not None:
            # the update round is the supervisor's step unit
            self._heartbeat.note_step()
            self._heartbeat.set_phase("update")
        return self.learner.update_distributed(
            self._local_shard(batch), minibatch_size, num_iters, seed)

    def additional_update(self, **kw):
        return self.learner.additional_update(**kw)

    def get_weights(self):
        return self.learner.get_weights()

    def forward_values(self, obs):
        return self.learner.forward_values(obs)

    def set_weights(self, w):
        self.learner.set_weights(w)

    def get_state(self):
        return self.learner.get_state()

    def set_state(self, s):
        self.learner.set_state(s)

    def shutdown(self) -> None:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


class LearnerGroup:
    # wedge supervisor cadence (mirrors train/backend_executor.py)
    WEDGE_POLL_S = 1.0
    WEDGE_HB_REFRESH_S = 2.0

    def __init__(self, learner_factory: Callable[[], Any],
                 num_learners: int = 0, seed: int = 0, *,
                 elastic_min_learners: Optional[int] = None,
                 elastic_reform_timeout_s: float = 60.0,
                 state_refresh_every: int = 1,
                 step_deadline_s: Optional[float] = None):
        if step_deadline_s is not None and step_deadline_s <= 0:
            raise ValueError(
                f"step_deadline_s must be > 0, got {step_deadline_s}")
        # How many updates between refreshes of the state cache: each
        # refresh pulls the full params and optimizer state from rank 0
        # to the driver; N > 1 trades that cost for losing up to N - 1
        # updates when a reconfiguration falls back to an older cache.
        if state_refresh_every < 1:
            raise ValueError("state_refresh_every must be >= 1")
        self._num_learners = num_learners    # achieved world size
        self._target_learners = num_learners  # what re-forms aim for
        self._factory = learner_factory
        self._seed = seed
        self._elastic_min = elastic_min_learners
        self._reform_timeout_s = elastic_reform_timeout_s
        self._state_refresh_every = state_refresh_every
        self._updates_since_refresh = 0
        self._ckpt_state: Optional[Dict[str, Any]] = None
        # gang heartbeat channel id; fresh per formation (_spawn_gang)
        self._gang_uid: Optional[str] = None
        self._tracker = None
        # per-step wedge deadline, enforced for elastic gangs only
        # (explicit step_deadline_s, else calibrated from trailing
        # update times; runtime-tunable via metrics_configure)
        self._step_deadline = None
        if elastic_min_learners is not None:
            if num_learners == 0:
                raise ValueError(
                    "elastic_min_learners requires a remote gang "
                    "(num_learners >= 1)")
            if not 1 <= elastic_min_learners <= num_learners:
                raise ValueError(
                    f"elastic_min_learners={elastic_min_learners} not in "
                    f"[1, num_learners={num_learners}]")
            from ray_tpu_torch.train.elastic import ReconfigTracker
            from ray_tpu_torch.train.heartbeat import StepDeadline
            self._step_deadline = StepDeadline(step_deadline_s)
            self._tracker = ReconfigTracker("learner")
        if num_learners == 0:
            self._local = learner_factory()
            self._local.build(seed=seed)
            self._actors: List[Any] = []
            return
        self._local = None
        self._actors = []
        # the factory's own learner says where the ranks learn (its
        # config's learner_device): a card and NCCL each, or gloo on the
        # CPU; without the card it asks for, this raises before any spawn
        self._on_card = learner_factory().target_device().type == "cuda"
        self._actors = self._spawn_gang(num_learners)
        if self.elastic:
            # the gang's durable fallback until the first update lands
            self._ckpt_state = self.get_state()

    @property
    def elastic(self) -> bool:
        return self._tracker is not None

    def _spawn_gang(self, world: int) -> List[Any]:
        """Spawn + rendezvous one gang generation of `world` fresh
        processes (each formation gets its own runtime-env pool key, so
        a re-form never reuses a process of an earlier group), within
        elastic_reform_timeout_s for an elastic gang."""
        import time
        import uuid

        import ray_tpu_torch
        from ray_tpu_torch.train.elastic import gang_runtime_env
        if self._on_card:
            gpus = ray_tpu_torch.cluster_resources().get("GPU", 0.0)
            if gpus < world:
                raise RuntimeError(
                    f"a learner gang of {world} on the card needs {world} "
                    f"CUDA GPUs and the cluster has {gpus:g}; pass "
                    f"device='cpu' to learn on the CPU")
        timeout_s = self._reform_timeout_s if self.elastic else 300.0
        deadline = time.monotonic() + timeout_s
        gang_env = gang_runtime_env("RAY_TPU_LEARNER_GANG")
        # fresh heartbeat channel per generation: stale rows from a
        # torn-down gang never shadow the new one
        self._gang_uid = f"learner:{uuid.uuid4().hex[:8]}"
        actor_cls = ray_tpu_torch.remote(_MeshLearnerActor)
        actors = [
            actor_cls.options(num_cpus=1, num_gpus=1 if self._on_card else 0,
                              runtime_env=gang_env).remote(
                self._factory, rank, self._gang_uid)
            for rank in range(world)
        ]
        # Barrier on gang readiness (every rank blocks in
        # init_process_group until all peers are up). On failure the
        # attempt's actors die HERE: a leaked rank would sit in the
        # rendezvous holding its CPU and card, making every smaller
        # world size infeasible too.
        try:
            nodes = ray_tpu_torch.get([a.node_id.remote() for a in actors],
                                      timeout=deadline - time.monotonic())
            master = ray_tpu_torch.get(
                actors[0].open_store.remote(world, timeout_s),
                timeout=deadline - time.monotonic())
            ray_tpu_torch.get([
                a.setup.remote(local_rank, master, world, self._seed,
                               self._on_card, timeout_s)
                for a, local_rank in zip(actors, local_ranks(nodes))],
                timeout=deadline - time.monotonic())
        except BaseException:
            for a in actors:
                try:
                    ray_tpu_torch.kill(a)
                except Exception:  # noqa: BLE001 - actor already dead
                    pass
            raise
        return actors

    def __len__(self) -> int:
        return max(1, self._num_learners)

    # ---- elastic reconfiguration ------------------------------------
    def reconfigure(self, num_learners: Optional[int] = None,
                    reason: str = "manual") -> int:
        """Re-form the gang at `num_learners` (default: the target
        world size) from the cached state; returns the achieved world
        size. An explicit `num_learners` also becomes the new target.
        Elastic gangs only."""
        if not self.elastic:
            raise RuntimeError("reconfigure() requires elastic mode "
                               "(elastic_min_learners)")
        if num_learners is not None:
            # validate BEFORE persisting: a rejected target must not
            # poison later worker_death recoveries
            if num_learners < self._elastic_min:
                raise ValueError(
                    f"target {num_learners} below elastic_min_learners="
                    f"{self._elastic_min}")
            self._target_learners = num_learners
        return self._elastic_reconfigure(
            reason, target=num_learners or self._target_learners)

    def _elastic_reconfigure(self, reason: str, target: int) -> int:
        import ray_tpu_torch
        if target < self._elastic_min:
            raise ValueError(
                f"target {target} below elastic_min_learners="
                f"{self._elastic_min}")
        rec = self._tracker.start(reason, world_size=len(self._actors))
        try:
            with rec.phase("drain"):
                self._kill_gang()
            with rec.phase("checkpoint") as attrs:
                attrs["cached"] = self._ckpt_state is not None
            achieved: Optional[int] = None
            with rec.phase("reform"):
                # step down toward the min when capacity is short; each
                # attempt is bounded by elastic_reform_timeout_s
                last_err: Optional[BaseException] = None
                for world in range(target, self._elastic_min - 1, -1):
                    try:
                        self._actors = self._spawn_gang(world)
                        achieved = world
                        break
                    except Exception as e:  # noqa: BLE001 - rendezvous
                        last_err = e        # timeout / spawn failure
                        self._kill_gang()
                if achieved is None:
                    raise RuntimeError(
                        f"elastic learner re-form infeasible: no world "
                        f"size in [{self._elastic_min}, {target}] "
                        f"became ready within "
                        f"{self._reform_timeout_s:.0f}s per attempt "
                        f"({last_err!r})")
            self._num_learners = achieved
            with rec.phase("reshard", world_size=achieved):
                if self._ckpt_state is not None:
                    ray_tpu_torch.get(
                        [a.set_state.remote(self._ckpt_state)
                         for a in self._actors], timeout=600)
            with rec.phase("resume"):
                pass  # the caller's retried update is the resume
            rec.finish(achieved)
            return achieved
        except BaseException as e:
            rec.abort(e)
            raise

    def _kill_gang(self) -> None:
        """Kill every rank (a re-form's drain: a surviving rank may sit in
        a collective its dead peer never joins, so nothing waits on it)."""
        import ray_tpu_torch
        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:  # noqa: BLE001 - actor already dead
                pass
        self._actors = []
        if self._gang_uid is not None:
            from ray_tpu_torch.train import heartbeat as hb
            from ray_tpu_torch.train.elastic import _core_worker_or_none
            cw = _core_worker_or_none()
            if cw is not None:
                hb.clear_gang(cw._gcs.call, self._gang_uid)
            self._gang_uid = None

    # ---- updates ----------------------------------------------------
    def update(self, batch: Dict[str, np.ndarray],
               minibatch_size: Optional[int] = None,
               num_iters: int = 1, seed: int = 0) -> Dict[str, float]:
        from ray_tpu_torch._private import goodput
        if self._local is not None:
            with goodput.bucket(goodput.PRODUCTIVE):
                return self._local.update(batch, minibatch_size,
                                          num_iters, seed)
        try:
            with goodput.bucket(goodput.PRODUCTIVE):
                return self._update_remote(batch, minibatch_size,
                                           num_iters, seed)
        except Exception as e:  # noqa: BLE001 - a rank died mid-update
            from ray_tpu_torch.exceptions import RayTaskError
            from ray_tpu_torch.train.backend_executor import GangWedgedError
            if not self.elastic or isinstance(e, RayTaskError):
                # a RayTaskError means the update RAN and raised: an
                # application error that a re-form would only replay;
                # only infrastructure failures (a dead rank, a lost
                # worker, a timeout, a wedge) reconfigure
                raise
            logger.warning(
                "elastic learner gang update failed (%r); "
                "reconfiguring and retrying", e)
            # aim back at the TARGET, not the achieved size: a gang
            # that degraded must try for the target again when capacity
            # returns, not ratchet down toward the minimum
            self._elastic_reconfigure(
                "wedge" if isinstance(e, GangWedgedError)
                else "worker_death",
                target=self._target_learners)
            with goodput.bucket(goodput.PRODUCTIVE):
                return self._update_remote(batch, minibatch_size,
                                           num_iters, seed)

    def _update_remote(self, batch, minibatch_size, num_iters, seed):
        import ray_tpu_torch
        # Same full batch + same seed to every rank: each slices its own
        # equal shard and all ranks enter the collective step the same
        # number of times. The batch goes into the object store once: a
        # task carrying it inline is serialized once a rank, and its send
        # blocks the driver while the rank's process is stopped (a wedge
        # the supervisor below must see, not wait behind).
        batch_ref = ray_tpu_torch.put(batch)
        refs = [a.update.remote(batch_ref, minibatch_size, num_iters, seed)
                for a in self._actors]
        if self.elastic:
            # wedge-aware wait: a rank SIGSTOPped inside the all-reduce
            # otherwise blocks every peer for the full 600 s get
            stats = self._await_update(refs, timeout=600)
        else:
            stats = ray_tpu_torch.get(refs, timeout=600)
        # each rank's scalar stats are means over its shard; equal shards
        # make their mean the global one (grad_norm is the same on every
        # rank); array stats (per-sample TD errors and their batch
        # indexes) concatenate in rank order, each rank's shard in turn
        out: Dict[str, Any] = {}
        for k in stats[0]:
            if getattr(stats[0][k], "ndim", 0):
                out[k] = np.concatenate([np.asarray(s[k]) for s in stats])
            else:
                out[k] = float(np.mean([s[k] for s in stats]))
        if self.elastic:
            # refresh the durable fallback: the state every rank holds
            # after this (replicated) step, what a reconfiguration
            # reshards from (a failed fetch just leaves the older cache)
            self._updates_since_refresh += 1
            if self._updates_since_refresh >= self._state_refresh_every:
                try:
                    self._ckpt_state = ray_tpu_torch.get(
                        self._actors[0].get_state.remote(), timeout=600)
                    self._updates_since_refresh = 0
                except Exception:  # noqa: BLE001 - the NEXT update's
                    pass           # failure path uses the older cache
        return out

    # ---- collective-wedge supervisor (train/heartbeat.py) -----------
    def _await_update(self, refs: List[Any], timeout: float
                      ) -> List[Any]:
        """Await one update round with the wedge trip armed, the
        learner-plane mirror of BackendExecutor._await_round. Short
        wait slices; between slices the supervisor refreshes the gang
        heartbeat table (which also carries the runtime step-deadline
        override) and, once the deadline expires, checks staleness.
        Two-factor trip: deadline expired AND >= 1 stale heartbeat;
        every-rank-fresh-but-slow keeps waiting. On a trip the wedged
        pids are hard-killed via their node managers and
        GangWedgedError routes into _elastic_reconfigure with
        reason="wedge". Round times feed the deadline calibrator."""
        import time

        import ray_tpu_torch
        from ray_tpu_torch.train import heartbeat as hb
        from ray_tpu_torch.train.backend_executor import GangWedgedError
        t0 = time.monotonic()
        hb_next = 0.0
        override: Optional[float] = None
        while True:
            ready, pending = ray_tpu_torch.wait(
                refs, num_returns=len(refs), timeout=self.WEDGE_POLL_S)
            if not pending:
                stats = ray_tpu_torch.get(  # graftlint: disable=RT002
                    refs, timeout=60)
                self._step_deadline.observe(time.monotonic() - t0)
                return stats
            now = time.monotonic()
            if now - t0 > timeout:
                raise TimeoutError(
                    f"no learner update round within {timeout:.0f}s")
            if now < hb_next:
                continue
            hb_next = now + self.WEDGE_HB_REFRESH_S
            reply = self._query_heartbeats()
            if reply is None:
                continue
            if reply.get("step_deadline_override_s") is not None:
                override = reply["step_deadline_override_s"]
            deadline = self._step_deadline.current(override)
            if deadline is None or now - t0 < deadline:
                continue
            from ray_tpu_torch._private.config import Config
            stale = hb.stale_ranks(reply,
                                   Config.watchdog_gang_heartbeat_s)
            if not stale:
                continue  # slow but every rank alive: keep waiting
            from ray_tpu_torch._private import spans
            cls = hb.classify_wedge(reply, stale)
            spans.instant(
                "elastic.wedge_detect", gang=self._gang_uid,
                classification=cls["kind"],
                ranks=",".join(str(r) for r in cls["ranks"]),
                nodes=",".join(n[:12] for n in cls["nodes"]),
                deadline_s=round(deadline, 3),
                waited_s=round(now - t0, 3))
            logger.error(
                "elastic learner: step deadline %.1fs expired after "
                "%.1fs with stale heartbeat(s) from rank(s) %s (%s); "
                "hard-killing wedged processes and re-forming",
                deadline, now - t0, cls["ranks"], cls["kind"])
            killed = hb.hard_kill_ranks(stale)
            raise GangWedgedError(
                f"learner rank(s) {cls['ranks']} wedged mid-update "
                f"({cls['kind']}): step deadline {deadline:.1f}s "
                f"expired with heartbeats "
                f"{[round(r['age_s'], 1) for r in stale]}s stale; "
                f"hard-killed ranks {killed} via their node managers")

    def _query_heartbeats(self) -> Optional[Dict[str, Any]]:
        if self._gang_uid is None:
            return None
        from ray_tpu_torch.train import heartbeat as hb
        from ray_tpu_torch.train.elastic import _core_worker_or_none
        cw = _core_worker_or_none()
        if cw is None:
            return None
        try:
            return hb.query_gang(cw._gcs.call, self._gang_uid)
        except Exception:  # noqa: BLE001 - GCS hiccup: retry next slice
            return None

    def additional_update(self, **kwargs) -> Dict[str, Any]:
        if self._local is not None:
            return self._local.additional_update(**kwargs)
        import ray_tpu_torch
        outs = ray_tpu_torch.get(
            [a.additional_update.remote(**kwargs) for a in self._actors],
            timeout=120)
        return outs[0]

    def forward_values(self, obs: np.ndarray) -> np.ndarray:
        """V(obs) from the current weights, computed where the weights
        are (the local learner's device, or rank 0 of the gang)."""
        if self._local is not None:
            return self._local.forward_values(obs)
        import ray_tpu_torch
        return ray_tpu_torch.get(
            self._actors[0].forward_values.remote(obs), timeout=600)

    # ---- weights ----------------------------------------------------
    def get_weights(self):
        if self._local is not None:
            return self._local.get_weights()
        import ray_tpu_torch
        return ray_tpu_torch.get(self._actors[0].get_weights.remote(),
                                 timeout=600)

    def set_weights(self, w) -> None:
        if self._local is not None:
            self._local.set_weights(w)
            return
        import ray_tpu_torch
        ray_tpu_torch.get([a.set_weights.remote(w) for a in self._actors],
                          timeout=600)

    def get_state(self):
        if self._local is not None:
            return self._local.get_state()
        import ray_tpu_torch
        return ray_tpu_torch.get(self._actors[0].get_state.remote(),
                                 timeout=600)

    def set_state(self, state) -> None:
        if self._local is not None:
            self._local.set_state(state)
            return
        import ray_tpu_torch
        ray_tpu_torch.get([a.set_state.remote(state) for a in self._actors],
                          timeout=600)
        if self.elastic:
            self._ckpt_state = state

    def shutdown(self) -> None:
        import ray_tpu_torch
        if self._actors:
            try:  # each rank destroys its process group before it dies
                ray_tpu_torch.get([a.shutdown.remote()
                                   for a in self._actors], timeout=60)
            except Exception:  # noqa: BLE001 - ranks may already be dead
                pass
        self._kill_gang()
        if self._tracker is not None:
            self._tracker.close()
