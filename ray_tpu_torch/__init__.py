"""ray_tpu_torch: the PyTorch and CUDA port of ray_tpu for NVIDIA Hopper.

The JAX package ``ray_tpu`` is the reference; this package does the same
work with PyTorch on an H100, and its one Pallas kernel family (flash
attention: forward, dK/dV, dQ) is hand-written CUDA C++ for sm_90a. It
imports torch, numpy and the standard library, never jax or ray_tpu.

Ported so far: the flagship decoder's training step (models/, ops/,
parallel/), the runtime it runs on (tasks, actors, objects, placement
groups: a copy of ray_tpu's, with a GPU accelerator manager), Ray
Train's TorchTrainer over an NCCL (gloo on the CPU) process group fed by
Ray Data (data/), Tune over trainers and algorithms (tune/), host-RAM
collectives (util/collective.py), and RLlib (rllib/: the learners on the
card, CPU EnvRunner actors).
Importing this package imports no torch: the runtime is framework-free.
Entry points run on the card unless the caller names another device
(``device="cpu"``, ``ScalingConfig(use_gpu=False)``), and raise when
there is no CUDA.
"""

from ray_tpu_torch import chaos  # noqa: F401
from ray_tpu_torch import exceptions  # noqa: F401
from ray_tpu_torch._private.object_ref import ObjectRef  # noqa: F401
from ray_tpu_torch.actor import (ActorClass, ActorHandle, get_actor,  # noqa: F401
                                 method)
from ray_tpu_torch.api import (available_resources, cancel,  # noqa: F401
                               cluster_resources, free, get,
                               get_gcs_address, get_runtime_context, init,
                               is_initialized, kill, nodes, put, remote,
                               shutdown, timeline, wait)
from ray_tpu_torch.remote_function import RemoteFunction  # noqa: F401

__version__ = "0.1.0"

__all__ = [
    "ObjectRef", "ActorClass", "ActorHandle", "get_actor", "method",
    "remote", "init",
    "shutdown", "is_initialized", "get", "put", "wait", "kill", "cancel",
    "free", "nodes", "cluster_resources", "available_resources",
    "get_gcs_address", "get_runtime_context", "exceptions", "chaos",
    "RemoteFunction", "timeline", "__version__",
]
