"""The port's ray_tpu_torch.data (copies of the JAX package's data/ under
the rename rule) on the CPU, and TorchTrainer(datasets=) over it.

Mirrors of tests/test_data.py (11) and tests/test_data_ops.py (22) on
ray_tpu_torch, each with its reference test's assertions. Held against
the JAX package: the pipelines of tests/_torch_data_reference.py (a
seeded shuffle, sorts, groupby aggregates, split(4, equal=True), and
the trainer's split(2, equal=True)) run through ray_tpu.data in a
subprocess with its own ray_tpu.init, started when the module's cluster
starts, and through the port here; every output equals the reference's
row for row. A 2-rank gloo TorchTrainer(datasets={"train": ds}) hands
each rank the rows the reference's split gives it, and the first loss
each rank computes on them with a narrow Transformer (TINY, f32) equals
the JAX package's Transformer.loss on the same params (params_from_jax)
and rows within 1e-5 relative. One cluster for the module
(ray_tpu_torch.init(num_cpus=4)).
"""

import subprocess
import sys
from pathlib import Path

import cloudpickle
import numpy as np
import pytest

import _torch_data_reference as reference
import ray_tpu_torch
from ray_tpu_torch import data as rdata
from ray_tpu_torch.data.executor import StreamingExecutor

REPO = Path(__file__).resolve().parent.parent
# the pipelines' functions ride to the port's workers by value
cloudpickle.register_pickle_by_value(reference)


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The JAX package's pipelines, started in a subprocess at once;
    yields (process, output path)."""
    tmp = tmp_path_factory.mktemp("data_reference")
    out, log = tmp / "reference.npz", tmp / "reference.log"
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, str(REPO / "tests/_torch_data_reference.py"),
             str(out)], cwd=REPO, stdout=f, stderr=subprocess.STDOUT)
    yield proc, out, log
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def cluster(reference_run):
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.fixture(autouse=True)
def _cluster(cluster):
    """All tests here run on the module's cluster."""


@pytest.fixture(scope="module")
def reference_outputs(reference_run):
    proc, out, log = reference_run
    assert proc.wait(timeout=240) == 0, log.read_text()
    with np.load(out) as z:
        got = {}
        for key in z.files:
            name, col = key.split("/", 1)
            got.setdefault(name, {})[col] = z[key]
    return got


# ---- mirrors of tests/test_data.py -----------------------------------

def test_range_map_filter_count():
    ds = rdata.range(100, parallelism=4)
    ds2 = ds.map(lambda r: {"id": r["id"] * 2})
    ds3 = ds2.filter(lambda r: r["id"] % 4 == 0)
    assert ds3.count() == 50
    rows = ds3.take(5)
    assert [r["id"] for r in rows] == [0, 4, 8, 12, 16]


def test_map_batches_columnar():
    ds = rdata.range(64, parallelism=4).map_batches(
        lambda b: {"id": b["id"], "sq": b["id"] ** 2}, batch_size=8)
    out = ds.take(3)
    assert [r["sq"] for r in out] == [0, 1, 4]
    assert ds.schema().keys() == {"id", "sq"}


def test_from_items_flat_map():
    ds = rdata.from_items([1, 2, 3], parallelism=2)
    ds2 = ds.flat_map(lambda r: [{"v": r["item"]}, {"v": r["item"] * 10}])
    vals = sorted(r["v"] for r in ds2.iter_rows())
    assert vals == [1, 2, 3, 10, 20, 30]


def test_iter_batches_exact_sizes():
    ds = rdata.range(50, parallelism=4)
    batches = list(ds.iter_batches(batch_size=16))
    sizes = [len(b["id"]) for b in batches]
    assert sizes == [16, 16, 16, 2]
    assert list(batches[0]["id"][:4]) == [0, 1, 2, 3]
    batches = list(ds.iter_batches(batch_size=16, drop_last=True))
    assert [len(b["id"]) for b in batches] == [16, 16, 16]


def test_streaming_backpressure_bounded():
    """No more than max_in_flight blocks are submitted-but-unconsumed."""
    ds = rdata.range(200, parallelism=10).map(lambda r: {"id": r["id"] + 1})
    ex = StreamingExecutor(ds._inputs, ds._ops, max_in_flight_blocks=2)
    total = 0
    for ref in ex.execute():
        blk = ray_tpu_torch.get(ref)
        total += len(blk["id"])
    assert total == 200
    assert ex.peak_in_flight <= 2, (
        f"backpressure violated: {ex.peak_in_flight} blocks in flight")


def test_repartition_and_shuffle():
    ds = rdata.range(30, parallelism=3)
    rep = ds.repartition(5)
    assert rep.num_blocks() == 5
    assert sorted(r["id"] for r in rep.iter_rows()) == list(range(30))

    shuf = rdata.range(30, parallelism=3).random_shuffle(seed=7)
    got = [r["id"] for r in shuf.iter_rows()]
    assert sorted(got) == list(range(30))
    assert got != list(range(30)), "shuffle produced identity order"


def test_split_disjoint_shards():
    shards = rdata.range(40, parallelism=4).split(2, equal=True)
    assert len(shards) == 2
    seen = []
    for s in shards:
        seen.extend(r["id"] for r in s.iter_rows())
    assert sorted(seen) == list(range(40))
    c0, c1 = shards[0].count(), shards[1].count()
    assert c0 == c1 == 20


def test_from_numpy_roundtrip():
    x = np.arange(20, dtype=np.float32)
    y = x * 3
    ds = rdata.from_numpy({"x": x, "y": y}, parallelism=3)
    batch = next(ds.iter_batches(batch_size=20))
    np.testing.assert_array_equal(batch["x"], x)
    np.testing.assert_array_equal(batch["y"], y)


def test_train_get_dataset_shard():
    """Each train worker consumes a disjoint shard via get_dataset_shard."""
    from ray_tpu_torch.train import (DataParallelTrainer, ScalingConfig,
                                     get_context, get_dataset_shard, report)

    def loop():
        it = get_dataset_shard("train")
        ids = []
        for batch in it.iter_batches(batch_size=8):
            ids.extend(int(v) for v in batch["id"])
        report({"ids": ids, "rank": get_context().get_world_rank()})

    ds = rdata.range(32, parallelism=4)
    trainer = DataParallelTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=2,
                                     resources_per_worker={"CPU": 0.5}),
        datasets={"train": ds})
    result = trainer.fit()
    assert result.error is None
    history = result.metrics_history
    assert history, "no reports received"
    # rank-0 metrics carry rank 0's ids; disjointness checked via count
    ids0 = history[-1]["ids"]
    assert len(ids0) == 16 and len(set(ids0)) == 16


def test_two_stage_pipeline_bounded_intermediates():
    """A 100-block dataset through a 2-stage (unfused) map pipeline
    streams with peak live intermediate refs bounded by the per-stage
    caps."""
    ds = (rdata.range(400, parallelism=100)
          .map_batches(lambda b: {"id": b["id"] * 2})
          .map_batches(lambda b: {"id": b["id"] + 1}, num_cpus=0.5))
    ex = StreamingExecutor(ds._inputs, ds._ops, max_in_flight_blocks=3)
    assert len(ex.stages) == 2, [st.ops for st in ex.stages]
    total = 0
    for ref in ex.execute():
        blk = ray_tpu_torch.get(ref)
        total += len(blk["id"])
    assert total == 400
    # two stages x cap 3 = at most 6 live intermediates at any moment
    assert ex.peak_in_flight <= 6, (
        f"streaming property violated: {ex.peak_in_flight} live blocks")
    # correctness: values are id*2+1
    vals = sorted(r["id"] for r in rdata.range(10, parallelism=2)
                  .map_batches(lambda b: {"id": b["id"] * 2})
                  .map_batches(lambda b: {"id": b["id"] + 1}, num_cpus=0.5)
                  .iter_rows())
    assert vals == [2 * i + 1 for i in range(10)]


def test_stage_boundary_resources_propagate():
    # explicit num_cpus starts a new stage; a following op with no
    # request fuses into it (the reference's fusion rule)
    fused = (rdata.range(8, parallelism=2)
             .map(lambda r: {"id": r["id"]}, num_cpus=0.25)
             .map(lambda r: {"id": r["id"] + 1}))
    ex = StreamingExecutor(fused._inputs, fused._ops)
    assert len(ex.stages) == 1
    assert ex.stages[0].num_cpus == 0.25
    # unequal requests -> separate stages carrying their own resources
    split = (rdata.range(8, parallelism=2)
             .map(lambda r: {"id": r["id"]}, num_cpus=0.25)
             .map(lambda r: {"id": r["id"] + 1}, num_cpus=0.5))
    ex2 = StreamingExecutor(split._inputs, split._ops)
    assert [st.num_cpus for st in ex2.stages] == [0.25, 0.5]
    got = sorted(r["id"] for r in split.iter_rows())
    assert got == [i + 1 for i in range(8)]


# ---- mirrors of tests/test_data_ops.py -------------------------------

class TestSort:
    def test_sort_global_order(self):
        rng = np.random.default_rng(0)
        vals = rng.permutation(500).astype(np.int64)
        ds = rdata.from_numpy({"x": vals, "y": vals * 2},
                              parallelism=4)
        out = ds.sort("x")
        got = np.concatenate([b["x"] for b in out.iter_blocks()
                              if b])
        np.testing.assert_array_equal(got, np.arange(500))
        # companion column rides along
        got_y = np.concatenate([b["y"] for b in out.iter_blocks()
                                if b])
        np.testing.assert_array_equal(got_y, np.arange(500) * 2)

    def test_sort_strings(self):
        ds = rdata.from_numpy(
            {"name": np.array(["banana", "apple", "date", "cherry"])},
            parallelism=2)
        got = np.concatenate(
            [b["name"] for b in ds.sort("name").iter_blocks() if b])
        assert list(got) == ["apple", "banana", "cherry", "date"]

    def test_sort_keeps_nan_rows(self):
        vals = np.array([3.0, np.nan, 1.0, 2.0, np.nan, 0.0])
        ds = rdata.from_numpy({"x": vals}, parallelism=3)
        got = np.concatenate(
            [b["x"] for b in ds.sort("x").iter_blocks() if b])
        assert len(got) == 6  # NaNs never dropped
        np.testing.assert_array_equal(got[:4], [0.0, 1.0, 2.0, 3.0])
        assert np.isnan(got[4:]).all()

    def test_sort_with_empty_blocks(self):
        ds = rdata.range(3).repartition(8)  # 5 empty blocks
        got = np.concatenate(
            [b["id"] for b in ds.sort("id").iter_blocks() if b])
        np.testing.assert_array_equal(got, [0, 1, 2])

    def test_sort_descending(self):
        ds = rdata.from_numpy(
            {"x": np.array([3, 1, 2, 5, 4])}, parallelism=2)
        got = np.concatenate(
            [b["x"] for b in ds.sort("x", descending=True).iter_blocks()
             if b])
        np.testing.assert_array_equal(got, [5, 4, 3, 2, 1])


class TestGroupBy:
    def _ds(self):
        return rdata.from_numpy({
            "k": np.array([0, 1, 0, 2, 1, 0]),
            "v": np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])},
            parallelism=3)

    def test_sum_mean_count(self):
        df = self._ds().groupby("k").agg(
            {"v": ["sum", "mean"]}).to_pandas().sort_values("k")
        np.testing.assert_array_equal(df["k"], [0, 1, 2])
        np.testing.assert_allclose(df["sum(v)"], [10.0, 7.0, 4.0])
        np.testing.assert_allclose(df["mean(v)"], [10 / 3, 3.5, 4.0])
        cnt = self._ds().groupby("k").count().to_pandas() \
            .sort_values("k")
        np.testing.assert_array_equal(cnt["count()"], [3, 2, 1])

    def test_min_max_std(self):
        df = self._ds().groupby("k").max("v").to_pandas() \
            .sort_values("k")
        np.testing.assert_allclose(df["max(v)"], [6.0, 5.0, 4.0])

    def test_groupby_with_multidim_feature_column(self):
        # extra [N, d] columns must not break 1-d aggregations
        ds = rdata.from_numpy({
            "k": np.array([0, 1, 0, 1]),
            "v": np.array([1.0, 2.0, 3.0, 4.0]),
            "obs": np.random.randn(4, 5).astype(np.float32)},
            parallelism=2)
        df = ds.groupby("k").sum("v").to_pandas().sort_values("k")
        np.testing.assert_allclose(df["sum(v)"], [4.0, 6.0])

    def test_groupby_after_repartition_with_empty_blocks(self):
        ds = rdata.from_numpy(
            {"k": np.array([0, 1, 0]),
             "v": np.array([1.0, 2.0, 3.0])}).repartition(6)
        df = ds.groupby("k").sum("v").to_pandas().sort_values("k")
        np.testing.assert_allclose(df["sum(v)"], [4.0, 2.0])

    def test_map_groups(self):
        out = self._ds().groupby("k").map_groups(
            lambda blk: {"k": blk["k"][:1],
                         "spread": np.asarray(
                             [blk["v"].max() - blk["v"].min()])})
        df = out.to_pandas().sort_values("k")
        np.testing.assert_allclose(df["spread"], [5.0, 3.0, 0.0])


class TestZipUnion:
    def test_zip(self):
        a = rdata.from_numpy({"x": np.arange(10)}, parallelism=3)
        b = rdata.from_numpy({"y": np.arange(10) * 10}, parallelism=2)
        df = a.zip(b).to_pandas()
        np.testing.assert_array_equal(df["y"], df["x"] * 10)

    def test_zip_name_collision(self):
        a = rdata.from_numpy({"x": np.arange(4)}, parallelism=1)
        b = rdata.from_numpy({"x": np.arange(4) + 100}, parallelism=1)
        df = a.zip(b).to_pandas()
        np.testing.assert_array_equal(df["x_1"], df["x"] + 100)

    def test_zip_collision_never_clobbers(self):
        a = rdata.from_numpy({"x": np.arange(4),
                              "x_1": np.arange(4) + 50}, parallelism=1)
        b = rdata.from_numpy({"x": np.arange(4) + 100}, parallelism=1)
        df = a.zip(b).to_pandas()
        np.testing.assert_array_equal(df["x_1"], np.arange(4) + 50)
        np.testing.assert_array_equal(df["x_2"], np.arange(4) + 100)

    def test_zip_length_mismatch(self):
        a = rdata.from_numpy({"x": np.arange(4)})
        b = rdata.from_numpy({"y": np.arange(5)})
        with pytest.raises(ValueError, match="equal row counts"):
            a.zip(b)

    def test_union(self):
        a = rdata.range(5)
        b = rdata.range(3)
        assert a.union(b).count() == 8


class TestFileIO:
    def _ds(self):
        return rdata.from_numpy({
            "a": np.arange(20), "b": np.arange(20) * 0.5},
            parallelism=3)

    @pytest.mark.parametrize("fmt", ["csv", "json", "parquet"])
    def test_write_read_roundtrip(self, tmp_path, fmt):
        path = str(tmp_path / fmt)
        ds = self._ds()
        files = getattr(ds, f"write_{fmt}")(path)
        assert len(files) == 3
        back = getattr(rdata, f"read_{fmt}")(path)
        df = back.to_pandas().sort_values("a").reset_index(drop=True)
        np.testing.assert_array_equal(df["a"], np.arange(20))
        np.testing.assert_allclose(df["b"], np.arange(20) * 0.5)

    def test_pandas_roundtrip(self):
        import pandas as pd
        df = pd.DataFrame({"x": [1, 2, 3], "y": ["a", "b", "c"]})
        ds = rdata.from_pandas(df)
        out = ds.to_pandas()
        np.testing.assert_array_equal(out["x"], [1, 2, 3])
        assert list(out["y"]) == ["a", "b", "c"]


class TestTorchBatches:
    def test_iter_torch_batches(self):
        import torch
        ds = rdata.from_numpy({"x": np.arange(10, dtype=np.float32)},
                              parallelism=2)
        batches = list(ds.iter_torch_batches(batch_size=4))
        assert all(isinstance(b["x"], torch.Tensor) for b in batches)
        total = torch.cat([b["x"] for b in batches])
        assert total.shape == (10,)


class TestDatasetAggregates:
    def test_sum_min_max_mean_std(self):
        vals = np.arange(100, dtype=np.float64)
        ds = rdata.from_numpy({"x": vals}, parallelism=4)
        assert ds.sum("x") == vals.sum()
        assert ds.min("x") == 0.0
        assert ds.max("x") == 99.0
        assert ds.mean("x") == pytest.approx(vals.mean())
        # ddof=1 (sample std), matching the reference and groupby
        assert ds.std("x") == pytest.approx(vals.std(ddof=1))

    def test_std_large_mean_numerically_stable(self):
        # E[x^2]-mean^2 would cancel to 0 here; Welford merging must not
        vals = 1e8 + np.arange(10, dtype=np.float64)
        ds = rdata.from_numpy({"x": vals}, parallelism=3)
        assert ds.std("x") == pytest.approx(vals.std(ddof=1), rel=1e-6)

    def test_aggregate_with_empty_blocks(self):
        ds = rdata.from_numpy({"x": np.arange(3.0)}).repartition(6)
        assert ds.sum("x") == 3.0
        assert ds.mean("x") == pytest.approx(1.0)


def test_push_based_shuffle_sort_many_blocks():
    """Sort through the push-based (tree-merge) shuffle path with more
    map tasks than the merge factor: reducers consume merged partials,
    and the global order is exact (reference push_based_shuffle.py)."""
    rng = np.random.default_rng(0)
    vals = rng.permutation(300)
    ds = rdata.from_blocks(
        [{"v": vals[i * 30:(i + 1) * 30]} for i in range(10)])
    out = ds.sort("v")
    got = [r["v"] for r in out.iter_rows()]
    assert got == sorted(vals.tolist())
    # descending too
    got_d = [r["v"] for r in ds.sort("v", descending=True).iter_rows()]
    assert got_d == sorted(vals.tolist(), reverse=True)


# ---- held against the JAX package ------------------------------------

@pytest.fixture(scope="module")
def port_outputs():
    return reference.pipelines(rdata)


PIPELINES = ["shuffle", "sort", "sort_desc", "groupby", "groupby_count",
             "split4_0", "split4_1", "split4_2", "split4_3",
             "train_split2_0", "train_split2_1"]


@pytest.mark.parametrize("name", PIPELINES)
def test_pipeline_equals_the_jax_package(port_outputs, reference_outputs,
                                         name):
    """Row for row: the same columns, dtypes and values, in order (the
    float aggregates to the bit: both reduce with the same pandas)."""
    got, want = port_outputs[name], reference_outputs[name]
    assert sorted(got) == sorted(want)
    for col, arr in want.items():
        assert got[col].dtype == arr.dtype, (name, col)
        np.testing.assert_array_equal(got[col], arr, err_msg=f"{name}/{col}")
    if name == "shuffle":
        # a permutation of the input that is not the identity
        assert sorted(got["id"]) == list(range(1000))
        assert not np.array_equal(got["id"], np.arange(1000))


def test_split_shards_partition_the_shuffle(port_outputs):
    shards = [port_outputs[f"split4_{i}"]["id"] for i in range(4)]
    assert [len(s) for s in shards] == [250] * 4
    np.testing.assert_array_equal(np.sort(np.concatenate(shards)),
                                  np.arange(1000))


def test_trainer_shards_and_first_loss_equal_the_jax_package(
        reference_outputs, tmp_path):
    """A 2-rank gloo TorchTrainer(datasets=) hands each rank the
    reference split's rows, and each rank's loss on them at the JAX
    params equals the JAX package's Transformer.loss (1e-5 relative)."""
    import jax

    from ray_tpu.models import TINY as JTINY
    from ray_tpu.models import Transformer as JTransformer
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    jcfg = JTINY.replace(dtype="float32", vocab_size=reference.TRAIN_VOCAB,
                         loss_chunk=0)
    params = jax.tree.map(np.asarray, jax.jit(
        JTransformer.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg))

    def loop(config):
        import torch
        import torch.distributed as dist

        from ray_tpu_torch import train
        from ray_tpu_torch.models import TINY, Transformer

        torch.set_num_threads(1)
        rows = np.concatenate([b["tokens"] for b in train.get_dataset_shard(
            "train").iter_batches(batch_size=3)])
        model = Transformer(TINY.replace(**config["over"]), device="cpu")
        model.load_jax_params(config["params"])
        with torch.no_grad():
            loss = model.loss({"tokens": rows}).item()
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, (dist.get_rank(), rows, loss))
        train.report({"by_rank": gathered})

    ds = rdata.from_numpy({"tokens": reference.train_tokens()},
                          parallelism=reference.TRAIN_BLOCKS)
    result = TorchTrainer(
        loop, train_loop_config={"params": params, "over": dict(
            dtype="float32", vocab_size=reference.TRAIN_VOCAB,
            loss_chunk=0)},
        datasets={"train": ds},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=RunConfig(storage_path=str(tmp_path),
                             name="data")).fit()
    assert result.error is None, result.error
    by_rank = sorted(result.metrics["by_rank"], key=lambda x: x[0])
    assert [r for r, _, _ in by_rank] == [0, 1]
    for rank, rows, loss in by_rank:
        want_rows = reference_outputs[f"train_split2_{rank}"]["tokens"]
        np.testing.assert_array_equal(rows, want_rows)
        want = float(JTransformer.loss(params, {"tokens": want_rows}, jcfg))
        assert abs(loss - want) <= 1e-5 * abs(want), (rank, loss, want)
