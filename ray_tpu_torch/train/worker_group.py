"""Worker group: N train-worker actors gang-scheduled in a placement group.

reference parity: python/ray/train/_internal/worker_group.py:19,102,365 —
RayTrainWorker actor + WorkerGroup with node/accelerator-sorted stable
ranks; placement group creation mirrors BackendExecutor.start
(_internal/backend_executor.py:200).

Two formation modes:

- FIXED (min_workers=None): one num_workers-bundle placement group,
  all-or-nothing — the classic gang.
- ELASTIC (min_workers set): one single-bundle placement group PER
  worker, polled against a reform deadline. Formation proceeds with
  every bundle that became schedulable in time as long as that is
  >= min_workers; still-pending groups are KEPT as replacement probes
  (`probe_ready()` turning true = capacity for a bigger world arrived —
  the grow trigger for the elastic reconfiguration loop in
  backend_executor.py). An unschedulable probe also shows up as PENDING
  placement-group demand, which autoscaler v2's ClusterStatusReader
  feeds to the scheduler — the probe is simultaneously the demand
  signal that makes a replacement node appear and the sensor that
  notices it arrived.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.session import (TrainContext, TrainingResult,
                                   _set_session, _TrainSession)

logger = logging.getLogger(__name__)


class RayTrainWorker:
    """The per-rank actor (reference worker_group.py:19). Hosts the
    session; also a generic `_execute` escape hatch used by backends."""

    def __init__(self) -> None:
        self._session: Optional[_TrainSession] = None

    def apply(self, fn: Callable, *args: Any, **kwargs: Any) -> Any:
        return fn(*args, **kwargs)

    def setup_env(self, env: Dict[str, str]) -> None:
        os.environ.update(env)

    def node_info(self) -> Tuple[str, int]:
        ctx = ray_tpu_torch.get_runtime_context()
        return ctx.get_node_id(), os.getpid()

    def init_session(self, train_loop: Callable, config: Optional[Dict],
                      context: TrainContext,
                      checkpoint_dir: Optional[str],
                      dataset_shards: Optional[Dict] = None) -> None:
        ckpt = Checkpoint(checkpoint_dir) if checkpoint_dir else None
        self._session = _TrainSession(train_loop, config, context, ckpt,
                                      dataset_shards=dataset_shards)
        _set_session(self._session)

    def start_training_session(self) -> None:
        assert self._session is not None
        self._session.start()

    def next_result(self, timeout: Optional[float] = None):
        assert self._session is not None
        return self._session.next_result(timeout=timeout)

    def shutdown_session(self) -> None:
        if self._session is not None:
            self._session.close()  # stop the heartbeat sidecar
        self._session = None
        _set_session(None)


class WorkerGroup:
    """Creates/holds the actor gang (reference worker_group.py:102)."""

    def __init__(self, num_workers: int,
                 resources_per_worker: Dict[str, float],
                 placement_strategy: str = "PACK", *,
                 min_workers: Optional[int] = None,
                 reform_timeout_s: Optional[float] = None,
                 reform_settle_s: Optional[float] = None,
                 runtime_env: Optional[Dict[str, Any]] = None):
        from ray_tpu_torch.util import (PlacementGroupSchedulingStrategy,
                                  placement_group)

        self.target_workers = num_workers
        self.elastic = min_workers is not None
        self._resources = dict(resources_per_worker)
        self._runtime_env = runtime_env
        self.pending_pgs: List[Any] = []
        self._pgs: List[Any] = []

        if min_workers is None:
            # fixed gang: one all-or-nothing placement group
            pg = placement_group(
                [dict(resources_per_worker) for _ in range(num_workers)],
                strategy=placement_strategy)
            if not pg.wait(120):
                from ray_tpu_torch.util import remove_placement_group
                remove_placement_group(pg)
                raise TimeoutError(
                    f"placement group for {num_workers} x "
                    f"{resources_per_worker} not schedulable within 120s")
            self._pg = pg
            self._pgs = [pg]
            bundle_slots = [(pg, i) for i in range(num_workers)]
        else:
            # elastic gang: one bundle per worker, bounded by the reform
            # deadline; proceed with >= min_workers ready bundles.
            # reform_settle_s (TorchElastic proceed-with-survivors
            # semantics, used by reconfigurations): once the minimum is
            # met, wait only this long past the LAST bundle that became
            # ready before going — stragglers stay behind as
            # replacement probes and the gang grows when they schedule.
            # None (initial formation) waits toward the full target
            # until the deadline.
            if placement_strategy != "PACK":
                # per-worker single-bundle groups cannot express
                # cross-worker (anti-)affinity — a SPREAD gang would
                # silently lose its blast-radius guarantee
                logger.warning(
                    "elastic formation ignores placement_strategy=%s: "
                    "workers form independent single-bundle placement "
                    "groups with no cross-worker affinity",
                    placement_strategy)
            deadline = time.monotonic() + (reform_timeout_s or 60.0)
            pgs = [placement_group([dict(resources_per_worker)],
                                   strategy="PACK")
                   for _ in range(num_workers)]
            ready: List[Any] = []
            pending: List[Any] = list(pgs)
            last_progress = time.monotonic()
            while pending and time.monotonic() < deadline:
                still = []
                for pg in pending:
                    if pg.is_ready():
                        ready.append(pg)
                        last_progress = time.monotonic()
                    else:
                        still.append(pg)
                pending = still
                if pending and reform_settle_s is not None and \
                        len(ready) >= min_workers and \
                        time.monotonic() - last_progress >= \
                        reform_settle_s:
                    break
                if pending:
                    time.sleep(0.1)
            if len(ready) < min_workers:
                from ray_tpu_torch.util import remove_placement_group
                for pg in pgs:
                    try:
                        remove_placement_group(pg)
                    except Exception:  # noqa: BLE001 - already gone
                        pass
                raise TimeoutError(
                    f"only {len(ready)}/{num_workers} worker bundles of "
                    f"{resources_per_worker} schedulable within "
                    f"{reform_timeout_s or 60.0:.0f}s "
                    f"(elastic_min_workers={min_workers})")
            self._pg = ready[0]
            self._pgs = list(ready)
            self.pending_pgs = pending
            bundle_slots = [(pg, 0) for pg in ready]

        self.num_workers = len(bundle_slots)
        cls = ray_tpu_torch.remote(RayTrainWorker)
        opts: Dict[str, Any] = {"num_cpus": 0}
        if runtime_env:
            opts["runtime_env"] = runtime_env
        self.workers = []
        try:
            self.workers = [
                cls.options(
                    scheduling_strategy=PlacementGroupSchedulingStrategy(
                        placement_group=pg,
                        placement_group_bundle_index=idx),
                    **opts).remote()
                for pg, idx in bundle_slots
            ]
            # Stable rank order: sort by node id then pid (reference
            # worker_group.py:365 sorts by node + GPU ids for
            # deterministic rank assignment).
            infos = ray_tpu_torch.get(
                [w.node_info.remote() for w in self.workers],
                timeout=120)
        except BaseException:
            # a failed formation must release everything it claimed
            # (committed PGs, pending probes, spawned actors): the
            # caller holds no reference yet (__init__ raised), so a
            # leak keeps CPUs reserved and an elastic retry loop
            # compounds it until the cluster reads infeasible
            self.shutdown()
            raise
        order = sorted(range(self.num_workers),
                       key=lambda i: (infos[i][0], infos[i][1]))
        self.workers = [self.workers[i] for i in order]
        self.node_ids = [infos[i][0] for i in order]

    @property
    def placement_group(self):
        return self._pg

    # ---- elastic probes ---------------------------------------------
    def probe_ready(self) -> bool:
        """True when ANY kept replacement probe became schedulable —
        capacity for a larger world arrived. INFEASIBLE probes (the
        GCS gives up on a PENDING group after its scheduling deadline)
        are re-armed so a replacement arriving later still registers."""
        from ray_tpu_torch.util import placement_group, remove_placement_group
        ready = False
        rearmed: List[Any] = []
        for pg in self.pending_pgs:
            if pg.is_ready():
                ready = True
                rearmed.append(pg)
                continue
            info = None
            try:
                info = pg._info()
            except Exception:  # noqa: BLE001 - GCS hiccup; keep probing
                pass
            if info is not None and info.state in ("INFEASIBLE",
                                                   "REMOVED"):
                try:
                    remove_placement_group(pg)
                except Exception:  # noqa: BLE001 - already gone
                    pass
                rearmed.append(placement_group([dict(self._resources)],
                                               strategy="PACK"))
            else:
                rearmed.append(pg)
        self.pending_pgs = rearmed
        return ready

    def missing_workers(self) -> int:
        return max(0, self.target_workers - len(self.workers))

    # ---- execution --------------------------------------------------
    def execute(self, fn: Callable, *args: Any, **kwargs: Any) -> List[Any]:
        """Run fn on every worker, gather results (reference
        WorkerGroup.execute)."""
        return ray_tpu_torch.get(
            [w.apply.remote(fn, *args, **kwargs) for w in self.workers],
            timeout=300)

    def execute_single(self, rank: int, fn: Callable, *args: Any,
                       **kwargs: Any) -> Any:
        return ray_tpu_torch.get(
            self.workers[rank].apply.remote(fn, *args, **kwargs),
            timeout=300)

    def setup_env(self, env_per_worker: List[Dict[str, str]]) -> None:
        ray_tpu_torch.get([w.setup_env.remote(env)
                     for w, env in zip(self.workers, env_per_worker)],
                    timeout=120)

    def shutdown(self) -> None:
        from ray_tpu_torch.util import remove_placement_group
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:  # noqa: BLE001 - worker already dead
                pass
        for pg in list(self._pgs) + list(self.pending_pgs):
            try:
                remove_placement_group(pg)
            except Exception:  # noqa: BLE001 - group already removed
                pass
        self._pgs = []
        self.pending_pgs = []
        self.workers = []

    def __len__(self) -> int:
        return len(self.workers)
