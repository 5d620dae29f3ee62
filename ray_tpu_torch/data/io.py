"""File IO: csv / jsonl / parquet readers+writers, pandas interop.

reference parity: python/ray/data/read_api.py (read_csv/read_json/
read_parquet — one read task per file) and Dataset.write_* (one write
task per block producing part files). pandas + pyarrow do the parsing,
as in the reference's datasource implementations.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import block as block_mod
from ray_tpu_torch.data.block import Block
from ray_tpu_torch.data.dataset import Dataset, MaterializedDataset


def _expand(paths: Union[str, Sequence[str]], suffix: str) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(
                os.path.join(p, f) for f in os.listdir(p)
                if f.endswith(suffix)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no {suffix} files under {paths}")
    return out


def _df_to_block(df) -> Block:
    return {c: df[c].to_numpy() for c in df.columns}


def _block_to_df(blk: Block):
    import pandas as pd
    return pd.DataFrame(dict(blk))


class _FileSource:
    """Picklable lazy block source: parse one file inside the task."""

    def __init__(self, path: str, fmt: str):
        self.path, self.fmt = path, fmt

    def __call__(self) -> Block:
        import pandas as pd
        if self.fmt == "csv":
            return _df_to_block(pd.read_csv(self.path))
        if self.fmt == "json":
            return _df_to_block(pd.read_json(self.path, lines=True))
        if self.fmt == "parquet":
            import pyarrow.parquet as pq
            tbl = pq.read_table(self.path)
            return {c: tbl[c].to_numpy(zero_copy_only=False)
                    for c in tbl.column_names}
        raise ValueError(f"unknown format {self.fmt}")


def read_csv(paths: Union[str, Sequence[str]]) -> Dataset:
    return Dataset([_FileSource(p, "csv")
                    for p in _expand(paths, ".csv")])


def read_json(paths: Union[str, Sequence[str]]) -> Dataset:
    """JSONL (one object per line), like the reference's JSON datasource."""
    files = [p for suf in (".json", ".jsonl")
             for p in _try_expand(paths, suf)]
    if not files:
        raise FileNotFoundError(f"no json files under {paths}")
    return Dataset([_FileSource(p, "json") for p in dict.fromkeys(files)])


def _try_expand(paths, suffix):
    try:
        return _expand(paths, suffix)
    except FileNotFoundError:
        return []


def read_parquet(paths: Union[str, Sequence[str]]) -> Dataset:
    return Dataset([_FileSource(p, "parquet")
                    for p in _expand(paths, ".parquet")])


def from_pandas(dfs) -> Dataset:
    """One block per DataFrame (reference ray.data.from_pandas)."""
    if not isinstance(dfs, (list, tuple)):
        dfs = [dfs]
    from ray_tpu_torch.data.dataset import from_blocks
    return from_blocks([_df_to_block(df) for df in dfs])


def _write_block(blk: Block, path: str, fmt: str, index: int) -> str:
    os.makedirs(path, exist_ok=True)
    name = os.path.join(path, f"part-{index:05d}.{fmt}")
    df = _block_to_df(blk)
    if fmt == "csv":
        df.to_csv(name, index=False)
    elif fmt == "json":
        df.to_json(name, orient="records", lines=True)
    elif fmt == "parquet":
        import pyarrow as pa
        import pyarrow.parquet as pq
        pq.write_table(pa.Table.from_pandas(df, preserve_index=False),
                       name)
    return name


def _write(ds: Dataset, path: str, fmt: str) -> List[str]:
    mat = ds.materialize()
    remote = ray_tpu_torch.remote(_write_block)
    return ray_tpu_torch.get([
        remote.remote(ref, path, fmt, i)
        for i, ref in enumerate(mat._refs)])


# Dataset methods (attached in dataset.py would be circular; patch here)
def write_csv(self: Dataset, path: str) -> List[str]:
    return _write(self, path, "csv")


def write_json(self: Dataset, path: str) -> List[str]:
    return _write(self, path, "json")


def write_parquet(self: Dataset, path: str) -> List[str]:
    return _write(self, path, "parquet")


def to_pandas(self: Dataset, limit: Optional[int] = None):
    import pandas as pd
    dfs = [_block_to_df(b) for b in self.iter_blocks()
           if block_mod.block_num_rows(b)]
    df = pd.concat(dfs, ignore_index=True) if dfs else pd.DataFrame()
    return df.head(limit) if limit is not None else df


Dataset.write_csv = write_csv
Dataset.write_json = write_json
Dataset.write_parquet = write_parquet
Dataset.to_pandas = to_pandas
