"""Dataset tour: transforms, groupby, parquet roundtrip, train shards."""

import tempfile

import numpy as np

import ray_tpu_torch
from ray_tpu_torch import data as rdata


def main():
    ray_tpu_torch.init(num_cpus=4)

    ds = rdata.from_numpy({
        "x": np.arange(1000, dtype=np.float32),
        "label": np.arange(1000) % 5,
    }, parallelism=8)

    # lazy fused transforms, executed with streaming backpressure
    even = ds.filter(lambda row: row["label"] % 2 == 0) \
             .map(lambda row: {**row, "x2": row["x"] * 2})
    print("rows after filter:", even.count())

    # distributed groupby / aggregate
    agg = ds.groupby("label").agg({"x": ["mean", "max"]})
    print(agg.to_pandas().sort_values("label").to_string(index=False))

    # parquet roundtrip
    out = tempfile.mkdtemp(prefix="ds_parquet_")
    ds.write_parquet(out)
    back = rdata.read_parquet(out)
    print("parquet rows:", back.count())

    # disjoint per-worker shards for training
    shards = ds.split(4, equal=True)
    print("shard sizes:", [s.count() for s in shards])

    ray_tpu_torch.shutdown()


if __name__ == "__main__":
    main()
