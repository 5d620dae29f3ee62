"""The data pipelines that tests/test_torch_data.py holds the port to, run
through the JAX package's ray_tpu.data (a helper, not a test).

    python tests/_torch_data_reference.py OUTPUT

starts its own ray_tpu.init, runs `pipelines(ray_tpu.data)` and writes
every output column to OUTPUT (.npz, keys "<pipeline>/<column>"); the
test runs the same `pipelines` through ray_tpu_torch.data in its own
process and compares. Nothing here imports jax: ray_tpu.data is jax-free.
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the trainer's dataset: rows of T + 1 tokens of a narrow model
TRAIN_ROWS, TRAIN_T, TRAIN_VOCAB, TRAIN_BLOCKS = 8, 16, 256, 3


def train_tokens():
    return np.random.default_rng(5).integers(
        0, TRAIN_VOCAB, (TRAIN_ROWS, TRAIN_T + 1)).astype(np.int32)


def _columns(blocks):
    """Blocks (dicts of columns) concatenated in order; empty ones
    skipped."""
    blocks = [b for b in blocks if b and len(next(iter(b.values())))]
    return {k: np.concatenate([b[k] for b in blocks]) for k in blocks[0]}


def pipelines(rd):
    """name -> {column: array}: the outputs of each pipeline, in the
    order the dataset yields its rows."""
    mapped = rd.range(1000, parallelism=8).map_batches(
        lambda b: {"id": b["id"], "k": b["id"] * 7 % 13,
                   "v": np.sqrt(b["id"].astype(np.float64))})
    shuffled = mapped.random_shuffle(seed=0)
    out = {"shuffle": _columns(shuffled.iter_blocks()),
           "sort": _columns(shuffled.sort("k").iter_blocks()),
           "sort_desc": _columns(
               shuffled.sort("v", descending=True).iter_blocks()),
           "groupby": _columns(shuffled.groupby("k").agg(
               {"v": ["sum", "mean", "max", "std"]}).iter_blocks()),
           "groupby_count": _columns(
               shuffled.groupby("k").count().iter_blocks())}
    for i, shard in enumerate(shuffled.split(4, equal=True)):
        out[f"split4_{i}"] = _columns(shard.iter_blocks())
    train = rd.from_numpy({"tokens": train_tokens()},
                          parallelism=TRAIN_BLOCKS)
    for i, shard in enumerate(train.split(2, equal=True)):
        out[f"train_split2_{i}"] = _columns(shard.iter_blocks())
    return out


def main(path):
    sys.path.insert(0, REPO)
    import ray_tpu
    from ray_tpu import data as rd
    ray_tpu.init(num_cpus=2)
    try:
        out = pipelines(rd)
    finally:
        ray_tpu.shutdown()
    np.savez(path, **{f"{name}/{col}": arr for name, cols in out.items()
                      for col, arr in cols.items()})


if __name__ == "__main__":
    main(sys.argv[1])
