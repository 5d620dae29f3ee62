"""BackendExecutor: drives the worker group through a training run.

reference parity: python/ray/train/_internal/backend_executor.py:65 —
start (:124, placement group at :200), _share_resource_ids (:258,286:
CUDA visibility sharing), rank mappings
(:358), start_training (:438), get_next_results (:552),
get_with_failure_handling (:640) and restart-on-failure (:701,712) bounded
by FailureConfig.max_failures (air/config.py:377).

Elastic mode (ScalingConfig.elastic_min_workers set): instead of the
fixed-size restart, worker death / node drain triggers a RECONFIGURATION
(TorchElastic re-rendezvous semantics): drain the old gang, fall back to
the latest durable checkpoint, re-form at whatever world size in
[elastic_min_workers, target] is schedulable within
elastic_reform_timeout_s, re-init the backend's process group
(jax.distributed) over the new mesh, re-split dataset shards, and resume
— each phase recorded as an `elastic.*` span with
ray_tpu_elastic_reconfigurations_total/_reconfig_seconds metrics and an
`elastic_stuck_reconfig` watchdog probe (train/elastic.py). Below-target
gangs keep their unscheduled bundles as replacement probes: the pending
placement-group demand is what autoscaler v2 feeds its scheduler, and
the probe turning ready (a replacement node joined) triggers the
scale-up reconfiguration back toward the target world size.
"""

from __future__ import annotations

import logging
import os
import time
import uuid
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch._private import goodput
from ray_tpu_torch.train.backend import Backend, BackendConfig
from ray_tpu_torch.train.config import ScalingConfig
from ray_tpu_torch.train.session import TrainContext, TrainingResult
from ray_tpu_torch.train.worker_group import WorkerGroup

logger = logging.getLogger(__name__)


class TrainingWorkerError(RuntimeError):
    """A worker's train loop raised; wraps the original error."""


class GangWedgedError(RuntimeError):
    """Rank(s) wedged mid-step: the step deadline expired with stale
    heartbeats (train/heartbeat.py). The wedged processes have already
    been hard-killed via their node managers by the time this raises —
    the caller routes it into the elastic re-form path with
    reason="wedge"."""


class BackendExecutor:
    def __init__(self, backend_config: BackendConfig,
                 scaling_config: ScalingConfig,
                 max_failures: int = 0):
        self._backend_config = backend_config
        self._backend: Backend = backend_config.backend_cls()
        self._scaling = scaling_config
        self._max_failures = max_failures
        self._num_failures = 0
        self.worker_group: Optional[WorkerGroup] = None
        self._contexts: List[TrainContext] = []
        # stashed so restarts can re-enter training transparently
        self._train_args: Optional[Dict[str, Any]] = None
        self._latest_checkpoint_dir: Optional[str] = None
        self._elastic = scaling_config.elastic
        self._tracker = None
        self._watch = None
        self._next_grow_poll = 0.0
        # collective-wedge watchdog (train/heartbeat.py): per-formation
        # heartbeat channel id + the per-step deadline calibrator.
        # Enforced only for elastic gangs — the recovery IS the elastic
        # re-form path — but heartbeats flow (and the gang_rank_wedged
        # probe watches them) for fixed gangs too.
        self._gang_uid: Optional[str] = None
        self._step_deadline = None
        if self._elastic:
            from ray_tpu_torch.train.elastic import (MembershipWatch,
                                               ReconfigTracker)
            from ray_tpu_torch.train.heartbeat import StepDeadline
            self._tracker = ReconfigTracker("train")
            self._watch = MembershipWatch()
            self._watch.subscribe()
            self._step_deadline = StepDeadline(
                scaling_config.step_deadline_s)

    # how long a RECONFIGURING gang waits for straggler bundles once
    # the minimum is met (TorchElastic proceed-with-survivors: recover
    # fast at the feasible size, grow when the replacement schedules);
    # the initial formation instead waits toward the full target
    RECONFIG_SETTLE_S = 2.0

    # fallback cadence for probing replacement capacity while degraded
    # when no pubsub capacity event arrived (pubsub can be unavailable
    # — MembershipWatch.subscribe is best-effort)
    GROW_POLL_PERIOD_S = 5.0

    # wedge supervisor: how often the elastic result wait wakes to
    # check membership/deadline state, and how often it refreshes the
    # gang heartbeat table from the GCS while a round is in flight
    # (also picks up the metrics_configure step-deadline override)
    WEDGE_POLL_S = 1.0
    WEDGE_HB_REFRESH_S = 2.0

    # ---- lifecycle --------------------------------------------------
    def start(self) -> None:
        """Form the gang and its process group. A worker that dies while
        the gang forms spends the failure budget, as one that dies a
        step later does (the JAX package's start() lets the error out of
        fit() whatever the budget)."""
        while True:
            try:
                self._form_group()
                self._mesh_init()
                return
            except TrainingWorkerError:
                raise  # infeasible formation: a clear terminal verdict
            except Exception as e:  # noqa: BLE001 - a worker died
                self._teardown_group()
                self._spend_failure(e, "forming the gang again")

    def _form_group(self, settle_s: Optional[float] = None) -> None:
        """Create the worker gang + rank contexts (+ GPU visibility).
        Elastic gangs form at any size in [elastic_min_workers, target]
        bounded by elastic_reform_timeout_s; infeasible demand raises
        TrainingWorkerError naming what could not schedule."""
        target = self._scaling.elastic_target_workers if self._elastic \
            else self._scaling.num_workers
        kwargs: Dict[str, Any] = {}
        if self._elastic:
            kwargs["min_workers"] = self._scaling.elastic_min_workers
            kwargs["reform_timeout_s"] = \
                self._scaling.elastic_reform_timeout_s
            kwargs["reform_settle_s"] = settle_s
        gang_env = self._backend.gang_env(self._backend_config,
                                          num_workers=target)
        if gang_env:
            kwargs["runtime_env"] = gang_env
        try:
            self.worker_group = WorkerGroup(
                target,
                self._scaling._resources_per_worker_not_none,
                self._scaling.placement_strategy, **kwargs)
        except TimeoutError as e:
            raise TrainingWorkerError(
                f"gang formation infeasible: {e}") from e
        if self._elastic and len(self.worker_group) < target:
            logger.warning(
                "elastic gang formed below target: %d/%d workers "
                "(min=%d); unscheduled bundles kept as replacement "
                "probes", len(self.worker_group), target,
                self._scaling.elastic_min_workers)
        self._contexts = self._build_contexts(self.worker_group)
        # fresh heartbeat channel per FORMATION: rows from a torn-down
        # generation must never read as this gang's liveness
        self._gang_uid = f"train:{uuid.uuid4().hex[:8]}"
        for ctx in self._contexts:
            ctx.gang_id = self._gang_uid
        self._share_gpu_visibility(self.worker_group)
        if self._watch is not None:
            self._watch.watch_nodes(list(self.worker_group.node_ids))

    def _mesh_init(self) -> None:
        """Backend process-group setup (torch.distributed over the gang)."""
        self._backend.on_start(self.worker_group, self._backend_config)

    def _build_contexts(self, wg: WorkerGroup) -> List[TrainContext]:
        """World/local/node ranks from the sorted gang (reference
        backend_executor.py:358 _create_rank_world_size_mappings)."""
        node_to_workers: Dict[str, List[int]] = defaultdict(list)
        for rank, node_id in enumerate(wg.node_ids):
            node_to_workers[node_id].append(rank)
        node_rank = {nid: i for i, nid in enumerate(
            dict.fromkeys(wg.node_ids))}
        contexts = []
        for rank, node_id in enumerate(wg.node_ids):
            peers = node_to_workers[node_id]
            contexts.append(TrainContext(
                world_rank=rank,
                world_size=len(wg),
                local_rank=peers.index(rank),
                local_world_size=len(peers),
                node_rank=node_rank[node_id],
            ))
        return contexts

    def _share_gpu_visibility(self, wg: WorkerGroup) -> None:
        """Split each node's GPUs among its co-located workers by local
        rank and set each worker's CUDA_VISIBLE_DEVICES (reference
        backend_executor.py:258 _share_cuda_visible_devices); a worker
        that asked for none sees none, as the reference's do. Runs before
        the train loop touches CUDA: the torch backend's gang_env gives
        every formation fresh processes, whose CUDA sees only these
        cards. The split assumes one gang per node: it does not read
        which cards the scheduler leased, so two gangs on one node (two
        1-GPU trainers) would both take card 0, as the reference's
        _share_tpu_visibility numbers a gang's chips from 0 (ROADMAP,
        Queue 3, a defect shared with the reference). Gangs that share
        one card through fractional GPUs rightly both take card 0."""
        import math

        import ray_tpu_torch
        g = self._scaling.num_gpus_per_worker
        # local rank i holds [i g, (i+1) g): whole cards, or its share of
        # one card when g is a fraction
        ray_tpu_torch.get([
            w.apply.remote(_claim_gpus, list(range(
                math.floor(ctx.local_rank * g),
                math.ceil((ctx.local_rank + 1) * g))))
            for w, ctx in zip(wg.workers, self._contexts)], timeout=120)

    # ---- training ---------------------------------------------------
    def start_training(self, train_loop: Callable,
                       config: Optional[Dict[str, Any]],
                       checkpoint_dir: Optional[str] = None,
                       experiment_name: str = "",
                       trial_dir: str = "",
                       datasets: Optional[Dict[str, Any]] = None) -> None:
        assert self.worker_group is not None, "call start() first"
        self._train_args = {
            "train_loop": train_loop, "config": config,
            "experiment_name": experiment_name, "trial_dir": trial_dir,
            "datasets": datasets,
        }
        self._latest_checkpoint_dir = checkpoint_dir
        try:
            if checkpoint_dir is not None:
                # resuming a prior run: session init re-reads model state
                # from the durable checkpoint on every rank
                with goodput.bucket("checkpoint_restore"):
                    self._init_sessions(checkpoint_dir)
            else:
                self._init_sessions(checkpoint_dir)
            self._start_sessions()
        except TrainingWorkerError:
            raise
        except Exception as e:  # noqa: BLE001 - a worker died before
            self._handle_failure(e)  # its first step: restart budget

    def _init_sessions(self, checkpoint_dir: Optional[str]) -> None:
        """Session setup on every rank: backend training hook, dataset
        shard split at the CURRENT world size, per-rank session init
        with the resume checkpoint (this is where an elastic re-form
        reshards: shards re-split over the new world, and every rank's
        loop reloads/reshards model+optimizer state from the durable
        checkpoint it is handed)."""
        assert self._train_args is not None
        self._backend.on_training_start(self.worker_group,
                                        self._backend_config)
        import ray_tpu_torch
        # Disjoint per-rank dataset shards (reference backend_executor +
        # session.py:1017 get_dataset_shard contract).
        datasets = self._train_args.get("datasets")
        shards_per_rank: Optional[List[Dict[str, Any]]] = None
        if datasets:
            world = len(self.worker_group)
            shards_per_rank = [dict() for _ in range(world)]
            for name, ds in datasets.items():
                # equal=True: every rank must get a non-empty shard or an
                # SPMD loop doing per-batch collectives would deadlock.
                for rank, shard in enumerate(ds.split(world, equal=True)):
                    shards_per_rank[rank][name] = shard.iterator()
        refs = []
        for rank, w in enumerate(self.worker_group.workers):
            ctx = self._contexts[rank]
            ctx.experiment_name = self._train_args["experiment_name"]
            ctx.trial_dir = self._train_args["trial_dir"]
            refs.append(w.init_session.remote(
                self._train_args["train_loop"],
                self._train_args["config"], ctx, checkpoint_dir,
                shards_per_rank[rank] if shards_per_rank else None))
        ray_tpu_torch.get(refs, timeout=120)

    def _start_sessions(self) -> None:
        import ray_tpu_torch
        ray_tpu_torch.get([w.start_training_session.remote()
                     for w in self.worker_group.workers], timeout=120)

    def get_next_results(self, timeout: float = 600.0
                         ) -> Optional[List[TrainingResult]]:
        """One result per worker, or None when all loops finished.

        Worker failures raise TrainingWorkerError after restart budget is
        exhausted; otherwise the group is restarted (elastic:
        reconfigured at the feasible world size) from the latest
        checkpoint and training resumes (reference
        backend_executor.py:552,640-712)."""
        import ray_tpu_torch
        assert self.worker_group is not None
        while True:
            if self._elastic:
                lost = self._lost_gang_nodes()
                if lost:
                    logger.warning(
                        "elastic: gang node(s) %s declared dead; "
                        "reconfiguring", [n[:12] for n in lost])
                    self._handle_failure(TrainingWorkerError(
                        f"gang node(s) {[n[:12] for n in lost]} died"))
                    continue
                self._maybe_grow()
            try:
                # the round wait IS the training step from the driver's
                # vantage: the gang is stepping (goodput) until a span
                # inside re-attributes (compile charge, elastic window)
                with goodput.bucket(goodput.PRODUCTIVE):
                    refs = [w.next_result.remote(timeout=timeout)
                            for w in self.worker_group.workers]
                    if self._elastic:
                        # wedge-aware wait: poll so a rank hung INSIDE
                        # a collective (stale heartbeat + expired step
                        # deadline) is detected and hard-killed instead
                        # of blocking the whole gang for the full
                        # timeout
                        results = self._await_round(refs, timeout)
                    else:
                        # the get IS batched; the loop is the restart
                        # path
                        results = ray_tpu_torch.get(  # graftlint: disable=RT002
                            refs, timeout=timeout + 60)
            except Exception as e:  # noqa: BLE001 - actor death etc.
                self._handle_failure(e)
                continue
            errors = [r.error for r in results
                      if r is not None and r.error is not None]
            if errors:
                self._handle_failure(errors[0])
                continue
            finals = [r is not None and r.final for r in results]
            if all(finals):
                return None
            if any(finals):
                # Uneven report() counts across ranks is a train-loop bug;
                # surface it instead of mixing empty final results into a
                # live round (reference backend_executor.py:581 raises
                # RuntimeError on partial completion).
                done = [i for i, f in enumerate(finals) if f]
                raise TrainingWorkerError(
                    f"workers {done} finished while others are still "
                    "reporting — all ranks must call report() the same "
                    "number of times")
            return [r for r in results if r is not None]

    # ---- collective-wedge supervisor (train/heartbeat.py) -----------
    def _await_round(self, refs: List[Any], timeout: float
                     ) -> List[Optional[TrainingResult]]:
        """Await one result round with the wedge trip armed.

        Short wait slices instead of one blocking get; between slices
        the supervisor refreshes the gang heartbeat table (which also
        carries the runtime step-deadline override) and, once the step
        deadline has expired, checks for stale ranks. The trip is
        two-factor by design: deadline expired AND >= 1 stale heartbeat.
        Every-rank-fresh-but-slow keeps waiting — auto-calibration plus
        the liveness factor is what keeps slow steps from false-
        tripping. On a trip the wedged pids are hard-killed via their
        node managers (a SIGSTOP'd rank answers no RPC) and
        GangWedgedError routes into the elastic re-form with
        reason="wedge". Round times feed the deadline calibrator."""
        import ray_tpu_torch
        from ray_tpu_torch.train import heartbeat as hb
        t0 = time.monotonic()
        hb_next = 0.0
        override: Optional[float] = None
        while True:
            ready, pending = ray_tpu_torch.wait(
                refs, num_returns=len(refs), timeout=self.WEDGE_POLL_S)
            if not pending:
                results = ray_tpu_torch.get(  # graftlint: disable=RT002
                    refs, timeout=60)
                self._step_deadline.observe(time.monotonic() - t0)
                return results
            now = time.monotonic()
            if now - t0 > timeout + 60:
                # mirror the blocking get's outer bound: workers are
                # paced by next_result(timeout) so a round this old is
                # a stuck gang even with fresh heartbeats
                raise TimeoutError(
                    f"no result round within {timeout + 60:.0f}s")
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
            self._trip_wedge(reply, stale, deadline, now - t0)

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

    def _trip_wedge(self, reply: Dict[str, Any],
                    stale: List[Dict[str, Any]], deadline: float,
                    waited: float) -> None:
        from ray_tpu_torch._private import spans
        from ray_tpu_torch.train import heartbeat as hb
        cls = hb.classify_wedge(reply, stale)
        spans.instant(
            "elastic.wedge_detect", gang=self._gang_uid,
            classification=cls["kind"],
            ranks=",".join(str(r) for r in cls["ranks"]),
            nodes=",".join(n[:12] for n in cls["nodes"]),
            deadline_s=round(deadline, 3), waited_s=round(waited, 3))
        logger.error(
            "elastic: step deadline %.1fs expired after %.1fs with "
            "stale heartbeat(s) from rank(s) %s — %s; hard-killing "
            "wedged processes and re-forming",
            deadline, waited, cls["ranks"],
            "whole-node wedge, classifying as slice leave of %s"
            % [n[:12] for n in cls["nodes"]]
            if cls["kind"] == "slice_leave" else "isolated rank wedge")
        killed = hb.hard_kill_ranks(stale)
        raise GangWedgedError(
            f"rank(s) {cls['ranks']} wedged mid-step "
            f"({cls['kind']}): step deadline {deadline:.1f}s expired "
            f"after {waited:.1f}s with heartbeats "
            f"{[round(r['age_s'], 1) for r in stale]}s stale; "
            f"hard-killed ranks {killed} via their node managers")

    # ---- elastic reconfiguration ------------------------------------
    def _lost_gang_nodes(self) -> List[str]:
        """Nodes hosting gang members that the GCS declared dead (via
        the MembershipWatch "node" subscription). A slice preemption
        takes the host down with the workers — the gang must not wait
        for a worker RPC to fail (the driver<->worker channel can
        outlive the node's management plane)."""
        if self._watch is None or self.worker_group is None:
            return []
        lost = self._watch.take_lost_nodes()
        if not lost:
            return []
        gang_nodes = set(self.worker_group.node_ids)
        return [n for n in lost if n in gang_nodes]

    def _maybe_grow(self) -> None:
        """Scale-up trigger, checked at step boundaries: a replacement
        probe became schedulable (a node joined — autoscaler v2 supply
        or manual), so re-form toward the target world size. The
        capacity pubsub event triggers the probe poll immediately;
        otherwise poll at GROW_POLL_PERIOD_S — probe_ready() costs one
        GCS RPC per pending probe, too much for every step boundary of
        a long degraded run."""
        wg = self.worker_group
        if wg is None or wg.missing_workers() == 0:
            return
        event = self._watch.take_capacity_event() \
            if self._watch is not None else False
        now = time.monotonic()
        if not event and now < self._next_grow_poll:
            return
        self._next_grow_poll = now + self.GROW_POLL_PERIOD_S
        if wg.probe_ready():
            logger.info(
                "elastic: replacement capacity arrived; growing gang "
                "%d -> %d workers", len(wg), wg.target_workers)
            try:
                self._reconfigure("scale_up")
            except TrainingWorkerError:
                raise  # infeasible re-form: a clear terminal verdict
            except Exception as e:  # noqa: BLE001 - a kill can land
                # mid-grow (the gang is already drained at that point):
                # spend the restart budget like any other failure
                # instead of escaping fit() as a raw crash
                self._handle_failure(e)

    def _handle_failure(self, error: BaseException) -> None:
        # a kill can land DURING the recovery itself (chaos loves the
        # re-form window): recovery failures spend the same restart
        # budget instead of aborting the run on the first unlucky race
        while True:
            self._spend_failure(
                error, "reconfiguring gang from latest checkpoint"
                if self._elastic else "restarting group from latest "
                "checkpoint")
            try:
                if self._elastic:
                    self._reconfigure(
                        "wedge" if isinstance(error, GangWedgedError)
                        else "worker_death")
                else:
                    self._restart()
                return
            except TrainingWorkerError:
                raise  # infeasible re-form: a clear terminal verdict
            except Exception as e:  # noqa: BLE001 - recovery raced a
                error = e           # new death; retry on budget

    def _spend_failure(self, error: BaseException, then: str) -> None:
        """Spend one failure of the restart budget on `error`; raise
        TrainingWorkerError once the budget is spent, else log `then`."""
        self._num_failures += 1
        if self._max_failures >= 0 and \
                self._num_failures > self._max_failures:
            raise TrainingWorkerError(
                f"training failed after {self._num_failures - 1} "
                f"restart(s): {error!r}") from error
        logger.warning(
            "train worker failure %d/%s (%r); %s", self._num_failures,
            self._max_failures if self._max_failures >= 0 else "inf",
            error, then)

    def _reconfigure(self, reason: str) -> None:
        """One elastic reconfiguration: drain -> checkpoint -> reform ->
        reshard -> resume, span-recorded and metered (train/elastic.py).
        Raises TrainingWorkerError when the re-form is infeasible below
        elastic_min_workers within the deadline."""
        assert self._train_args is not None, "no training to reconfigure"
        rec = self._tracker.start(
            reason, world_size=len(self.worker_group)
            if self.worker_group is not None else 0)
        try:
            with rec.phase("drain"):
                self._teardown_group()
            with rec.phase("checkpoint") as attrs:
                ckpt = self._latest_checkpoint_dir
                if ckpt is not None and not os.path.isdir(ckpt):
                    logger.warning(
                        "elastic: latest checkpoint %s is gone; "
                        "resuming from scratch", ckpt)
                    ckpt = None
                attrs["checkpoint_dir"] = ckpt or ""
            with rec.phase("reform"):
                self._form_group(settle_s=self.RECONFIG_SETTLE_S)
            with rec.phase("reshard",
                           world_size=len(self.worker_group)):
                self._mesh_init()
                self._init_sessions(ckpt)
            with rec.phase("resume"):
                self._start_sessions()
            rec.finish(len(self.worker_group))
        except BaseException as e:
            rec.abort(e)
            raise

    def _restart(self) -> None:
        assert self._train_args is not None, "no training to restart"
        self._teardown_group()
        self.start()
        self.start_training(
            self._train_args["train_loop"], self._train_args["config"],
            checkpoint_dir=self._latest_checkpoint_dir,
            experiment_name=self._train_args["experiment_name"],
            trial_dir=self._train_args["trial_dir"],
            datasets=self._train_args.get("datasets"))

    def note_checkpoint(self, checkpoint_dir: str) -> None:
        """Driver tells the executor where the latest persisted checkpoint
        lives so restarts resume from it."""
        self._latest_checkpoint_dir = checkpoint_dir

    def _teardown_group(self) -> None:
        if self.worker_group is not None:
            try:
                self._backend.on_shutdown(self.worker_group,
                                          self._backend_config)
            except Exception:  # noqa: BLE001 - backend teardown is best-effort
                pass
            self.worker_group.shutdown()
            self.worker_group = None
        if self._gang_uid is not None:
            # drop the formation's heartbeat rows: a dead generation's
            # rows would export as wedged-forever gauge series
            from ray_tpu_torch.train.elastic import _core_worker_or_none
            from ray_tpu_torch.train.heartbeat import clear_gang
            cw = _core_worker_or_none()
            if cw is not None:
                clear_gang(cw._gcs.call, self._gang_uid)
            self._gang_uid = None

    def shutdown(self) -> None:
        self._teardown_group()
        if self._watch is not None:
            self._watch.unsubscribe()
        if self._tracker is not None:
            self._tracker.close()


def _claim_gpus(indices: List[int]) -> List[str]:
    """In a train worker: see only the node's GPUs at `indices` (its
    share by local rank). The node's ids are what it inherited from its
    node manager, so a node started under CUDA_VISIBLE_DEVICES=2,3 hands
    out "2" and "3"."""
    from ray_tpu_torch._private.accelerators.nvidia_gpu import \
        NvidiaGPUAcceleratorManager as gpus
    node_ids = gpus.get_current_node_accelerator_ids()
    ids = [node_ids[i] for i in indices]
    gpus.set_current_process_visible_accelerator_ids(ids)
    return ids
