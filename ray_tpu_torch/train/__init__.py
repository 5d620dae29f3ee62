"""ray_tpu_torch.train: distributed training orchestration (Ray Train parity).

reference: python/ray/train — BaseTrainer/DataParallelTrainer +
BackendExecutor + _TrainSession (SURVEY.md §2.3, §3.6). The JAX package's
JaxTrainer starts jax.distributed over the gang; the port's TorchTrainer
starts a torch.distributed process group (NCCL on GPUs, gloo on the
CPU). The JAX package's accelerate, sklearn, tensorflow and transformers
trainers are not ported yet (ROADMAP.md).
"""

from ray_tpu_torch.train.checkpoint import Checkpoint  # noqa: F401
from ray_tpu_torch.train.config import (CheckpointConfig, FailureConfig,  # noqa: F401
                                        RunConfig, ScalingConfig)
from ray_tpu_torch.train.data_parallel_trainer import (DataParallelTrainer,  # noqa: F401
                                                       Result)
from ray_tpu_torch.train.torch_backend import TorchConfig  # noqa: F401
from ray_tpu_torch.train.torch_trainer import TorchTrainer  # noqa: F401
from ray_tpu_torch.train.session import (TrainContext, get_checkpoint,  # noqa: F401
                                         get_context, get_dataset_shard,
                                         report)

__all__ = [
    "Checkpoint", "CheckpointConfig", "FailureConfig", "RunConfig",
    "ScalingConfig", "DataParallelTrainer", "Result", "TorchTrainer",
    "TorchConfig", "TrainContext", "report", "get_checkpoint",
    "get_context", "get_dataset_shard",
]

from ray_tpu_torch._private.usage import record_library_usage as _rlu
_rlu('train')
del _rlu
