"""Store-backed data for the Spark estimators.

Counterpart of ``horovod_tpu/spark/common/datamodule.py`` (reference:
``horovod/spark/common/util.py``'s ``prepare_data``, read back through
Petastorm): the data goes to the store as a directory of Parquet part
files written round-robin (pyarrow), and each worker reads the files
whose index is its rank modulo the world size, wrapping around when
there are fewer files than workers.  The layout is the reference's: a
store written by either package reads the same in the other.  Takes a
pyspark DataFrame (``df.write.parquet``) where pyspark is installed, and
a pandas DataFrame, a dict of columns or a list of row dicts without
it; pandas and pyarrow are imported by the functions that need them.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


def _is_spark_df(df: Any) -> bool:
    mod = type(df).__module__ or ""
    return mod.startswith("pyspark.")


def _to_pandas(df: Any):
    import pandas as pd

    if isinstance(df, pd.DataFrame):
        return df
    if isinstance(df, dict):
        return pd.DataFrame({k: list(v) for k, v in df.items()})
    if isinstance(df, (list, tuple)):
        return pd.DataFrame(list(df))
    raise TypeError(
        f"Unsupported dataset type {type(df).__name__}: expected a pyspark "
        f"or pandas DataFrame, dict of columns, or list of row dicts")


def materialize(df: Any, path: str, num_shards: int = 1) -> int:
    """Write ``df`` to ``path`` as a directory of Parquet part files —
    ``num_shards`` parts, rows spread round-robin so every part is
    non-empty whenever rows >= shards (fewer rows than shards writes
    only the non-empty parts; ``read_shard``'s wraparound then hands
    short worlds duplicate rows rather than empty shards); returns the
    row count."""
    if _is_spark_df(df):
        # Repartition so the file count matches the worker count — a
        # 1-partition DataFrame would otherwise give every rank the
        # same single file via the wraparound.
        df.repartition(max(num_shards, 1)).write.mode(
            "overwrite").parquet(path)
        return df.count()
    import pyarrow as pa
    import pyarrow.parquet as pq

    pdf = _to_pandas(df)
    os.makedirs(path, exist_ok=True)
    for old in glob.glob(os.path.join(path, "part-*.parquet")):
        os.remove(old)
    n = len(pdf)
    parts = max(num_shards, 1)
    for i in range(parts):
        chunk = pdf.iloc[i::parts]          # round-robin: balanced parts
        if len(chunk) == 0:
            continue
        table = pa.Table.from_pandas(chunk, preserve_index=False)
        pq.write_table(table, os.path.join(path, f"part-{i:05d}.parquet"))
    return n


def read_shard(path: str, shard: int, num_shards: int,
               columns: Optional[Sequence[str]] = None
               ) -> Dict[str, np.ndarray]:
    """Read this worker's shard (files with index ≡ shard mod
    num_shards) as a dict of stacked numpy columns.  List/array columns
    stack into ``[rows, ...]`` arrays."""
    import pyarrow.parquet as pq

    files = sorted(glob.glob(os.path.join(path, "part-*.parquet")) or
                   glob.glob(os.path.join(path, "*.parquet")))
    if not files:
        raise FileNotFoundError(f"no parquet part files under {path}")
    mine = [f for i, f in enumerate(files) if i % num_shards == shard]
    if not mine:          # fewer files than shards: wrap around
        mine = [files[shard % len(files)]]
    tables = [pq.read_table(f, columns=list(columns) if columns else None)
              for f in mine]
    out: Dict[str, np.ndarray] = {}
    for name in tables[0].column_names:
        col: List[Any] = []
        for t in tables:
            col.extend(t.column(name).to_pylist())
        out[name] = _stack_column(col)
    return out


def _stack_column(col: Sequence[Any]) -> np.ndarray:
    """Stack a python column into ``[rows, ...]`` (list/array values
    become a 2-D+ array; scalars a 1-D array; empty columns a [0]
    float32 array)."""
    if not len(col):
        return np.zeros((0,), np.float32)
    if isinstance(col[0], (list, tuple, np.ndarray)):
        return np.stack([np.asarray(v) for v in col])
    return np.asarray(col)


def to_columns(pdf) -> Dict[str, np.ndarray]:
    """A pandas DataFrame as stacked numpy columns (the transform-side
    twin of :func:`read_shard`)."""
    return {c: _stack_column(list(pdf[c])) for c in pdf.columns}


def stack_features(data: Dict[str, np.ndarray],
                   feature_cols: Sequence[str]) -> np.ndarray:
    """``[rows, F]`` feature matrix from one or more columns (scalar
    columns contribute one feature each; array columns are flattened)."""
    mats = []
    for c in feature_cols:
        a = data[c]
        mats.append(a.reshape(len(a), -1).astype(np.float32))
    return mats[0] if len(mats) == 1 else np.concatenate(mats, axis=1)
