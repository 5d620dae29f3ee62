"""Distributed replay plane: sharded (prioritized) replay actor service.

reference parity: rllib/algorithms/apex_dqn/apex_dqn.py — the APEX/R2D2
pattern where N replay-shard actors each own a bounded local buffer with
local priorities, env runners hash-route trajectory fragments to shards
through the zero-copy object plane, the learner pulls sample batches
concurrently from every shard, and TD-error priority updates flow back
one-way. The reference builds this from ReplayActor +
ActorHandle round-robin; here the three roles are explicit:

  - `ReplayShardActor` (shard.py): one shard — buffer + local sum-tree
    priorities, epoch-ticketed sampling, per-shard metrics/spans.
  - `ReplayWriter` (writer.py): runner-side pusher — crc32 hash
    routing, scatter-put refs (payload never re-pickles through actor
    args), bounded per-shard inflight with shed counters.
  - `ReplayGroup` (group.py): driver-side coordinator — shard spawn /
    placement, pipelined concurrent pulls (fetch_ready_async_reqs
    style) staged through HostStage, one-way priority-update routing,
    and resharding on shard death (elastic re-add of an empty shard).
"""

from ray_tpu_torch.rllib.utils.replay.group import ReplayGroup
from ray_tpu_torch.rllib.utils.replay.shard import (REPLAY_NAMESPACE,
                                              ReplayShardActor,
                                              shard_actor_name)
from ray_tpu_torch.rllib.utils.replay.writer import ReplayWriter, route_shard

__all__ = ["ReplayGroup", "ReplayShardActor", "ReplayWriter",
           "REPLAY_NAMESPACE", "route_shard", "shard_actor_name"]
