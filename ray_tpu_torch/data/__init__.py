"""ray_tpu_torch.data: block-based datasets with a streaming executor.

reference parity: python/ray/data — Dataset over blocks, lazy transforms,
pull-based streaming execution with backpressure, per-worker train shards.
"""

from ray_tpu_torch.data.block import Block  # noqa: F401
from ray_tpu_torch.data.dataset import (Dataset, MaterializedDataset,  # noqa: F401
                                  from_blocks, from_items, from_numpy, range)
from ray_tpu_torch.data.grouped import GroupedData  # noqa: F401
from ray_tpu_torch.data.io import (from_pandas, read_csv,  # noqa: F401
                             read_json, read_parquet)
from ray_tpu_torch.data.iterator import DataIterator  # noqa: F401

__all__ = [
    "Block", "Dataset", "MaterializedDataset", "DataIterator",
    "GroupedData", "from_items", "from_numpy", "from_blocks",
    "from_pandas", "range", "read_csv", "read_json", "read_parquet",
]

from ray_tpu_torch._private.usage import record_library_usage as _rlu
_rlu('data')
del _rlu
