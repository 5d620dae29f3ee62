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

Elastic learner gangs (elastic_min_learners, reconfigure) are not
ported yet: they raise, naming their ROADMAP row.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

_ELASTIC = ("elastic learner gangs (elastic_min_learners, reconfigure) "
            "are not ported yet: ROADMAP Queue 1 item 3, 'elastic learner "
            "gangs'")


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
        self._heartbeat = None
        if gang_id:
            from ray_tpu_torch.train.heartbeat import HeartbeatSender
            hb = HeartbeatSender(gang_id, rank)
            if hb.start():
                self._heartbeat = hb

    def node_id(self) -> str:
        import ray_tpu_torch
        return ray_tpu_torch.get_runtime_context().get_node_id()

    def setup(self, local_rank: int, master: str, world: int, seed: int,
              on_card: bool) -> None:
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
        dist.init_process_group(
            backend="nccl" if on_card else "gloo",
            init_method=f"tcp://{master}", world_size=world,
            rank=self.rank, timeout=datetime.timedelta(seconds=300))
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
        runs identical step counts."""
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
    def __init__(self, learner_factory: Callable[[], Any],
                 num_learners: int = 0, seed: int = 0, *,
                 elastic_min_learners: Optional[int] = None):
        if elastic_min_learners is not None:
            raise NotImplementedError(_ELASTIC)
        self._num_learners = num_learners
        self._factory = learner_factory
        self._seed = seed
        self._gang_uid: Optional[str] = None
        if num_learners == 0:
            self._local = learner_factory()
            self._local.build(seed=seed)
            self._actors: List[Any] = []
            return
        self._local = None
        # the factory's own learner says where the ranks learn (its
        # config's learner_device): a card and NCCL each, or gloo on the
        # CPU; without the card it asks for, this raises before any spawn
        on_card = learner_factory().target_device().type == "cuda"
        self._actors = self._spawn_gang(num_learners, on_card)

    def _spawn_gang(self, world: int, on_card: bool) -> List[Any]:
        """Spawn + rendezvous one gang of `world` fresh processes (each
        formation gets its own runtime-env pool key)."""
        import uuid

        import ray_tpu_torch
        from ray_tpu_torch.train.elastic import free_port, gang_runtime_env
        if on_card:
            gpus = ray_tpu_torch.cluster_resources().get("GPU", 0.0)
            if gpus < world:
                raise RuntimeError(
                    f"a learner gang of {world} on the card needs {world} "
                    f"CUDA GPUs and the cluster has {gpus:g}; pass "
                    f"device='cpu' to learn on the CPU")
        gang_env = gang_runtime_env("RAY_TPU_LEARNER_GANG")
        master = f"127.0.0.1:{free_port()}"
        self._gang_uid = f"learner:{uuid.uuid4().hex[:8]}"
        actor_cls = ray_tpu_torch.remote(_MeshLearnerActor)
        actors = [
            actor_cls.options(num_cpus=1, num_gpus=1 if on_card else 0,
                              runtime_env=gang_env).remote(
                self._factory, rank, self._gang_uid)
            for rank in range(world)
        ]
        # Barrier on gang readiness (every rank blocks in
        # init_process_group until all peers are up). On failure the
        # attempt's actors die HERE: a leaked rank would sit in the
        # rendezvous holding its CPU and card.
        try:
            nodes = ray_tpu_torch.get([a.node_id.remote() for a in actors],
                                      timeout=300)
            ray_tpu_torch.get([
                a.setup.remote(local_rank, master, world, self._seed,
                               on_card)
                for a, local_rank in zip(actors, local_ranks(nodes))],
                timeout=300)
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

    def reconfigure(self, num_learners: Optional[int] = None,
                    reason: str = "manual") -> int:
        raise NotImplementedError(_ELASTIC)

    def _kill_gang(self) -> None:
        import ray_tpu_torch
        if self._actors:
            try:
                ray_tpu_torch.get([a.shutdown.remote()
                                   for a in self._actors], timeout=60)
            except Exception:  # noqa: BLE001 - ranks may already be dead
                pass
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
        with goodput.bucket(goodput.PRODUCTIVE):
            if self._local is not None:
                return self._local.update(batch, minibatch_size,
                                          num_iters, seed)
            return self._update_remote(batch, minibatch_size, num_iters,
                                       seed)

    def _update_remote(self, batch, minibatch_size, num_iters, seed):
        import ray_tpu_torch
        # Same full batch + same seed to every rank: each slices its own
        # equal shard and all ranks enter the collective step the same
        # number of times.
        refs = [a.update.remote(batch, minibatch_size, num_iters, seed)
                for a in self._actors]
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
        return out

    def additional_update(self, **kwargs) -> Dict[str, Any]:
        if self._local is not None:
            return self._local.additional_update(**kwargs)
        import ray_tpu_torch
        outs = ray_tpu_torch.get(
            [a.additional_update.remote(**kwargs) for a in self._actors],
            timeout=120)
        return outs[0]

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

    def shutdown(self) -> None:
        self._kill_gang()
