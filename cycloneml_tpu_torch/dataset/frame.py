"""MLFrame — a named-column frame for the estimator API.

The port's counterpart of ``cycloneml_tpu/dataset/frame.py:MLFrame``: a
dict of numpy columns (1-D scalars or 2-D vector columns) sharing a row
count, with select/withColumn semantics and the bridge to
:class:`InstanceDataset` that estimators use. ``sample`` and
``random_split`` draw from ``np.random.RandomState(seed)`` as the
reference does, so one seed picks the same rows in both packages.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
from cycloneml_tpu_torch.dataset.instance import rows_to_dense
from cycloneml_tpu_torch.linalg.vectors import Vector


class MLFrame:
    """Immutable named-column table. Vector columns are 2-D (n, d)."""

    def __init__(self, ctx, columns: Dict[str, np.ndarray]):
        self.ctx = ctx
        self._cols: Dict[str, np.ndarray] = {}
        n = None
        for name, col in columns.items():
            arr = self._coerce(col)
            if n is None:
                n = arr.shape[0]
            elif arr.shape[0] != n:
                raise ValueError(
                    f"column {name!r} has {arr.shape[0]} rows, expected {n}")
            self._cols[name] = arr
        self.n_rows = n or 0
        self._ds_cache: Dict[tuple, InstanceDataset] = {}

    @staticmethod
    def _coerce(col) -> np.ndarray:
        # a copy of a writable buffer: the frame caches its device
        # placement, so it must not alias memory the caller may change
        if isinstance(col, np.ndarray):
            arr = col if not col.flags.writeable else col.copy()
        elif len(col) and isinstance(col[0], Vector):
            arr = rows_to_dense(col)
        else:
            arr = np.asarray(col)
        arr.flags.writeable = False
        return arr

    # -- construction ---------------------------------------------------------
    @classmethod
    def from_rows(cls, ctx, rows: Sequence,
                  schema: Sequence[str]) -> "MLFrame":
        """Row tuples (values in ``schema`` order) as columns."""
        cols: Dict[str, list] = {name: [] for name in schema}
        for row in rows:
            for name, v in zip(schema, row):
                cols[name].append(v)
        return cls(ctx, {k: cls._coerce(v) for k, v in cols.items()})

    @classmethod
    def from_instance_dataset(cls, ds: InstanceDataset,
                              features_col: str = "features",
                              label_col: str = "label",
                              weight_col: Optional[str] = None) -> "MLFrame":
        """A dataset's real rows read back as columns."""
        x, y, w = ds.to_numpy()
        cols = {features_col: x, label_col: y}
        if weight_col:
            cols[weight_col] = w
        return cls(ds.ctx, cols)

    # -- column ops -----------------------------------------------------------
    @property
    def columns(self) -> List[str]:
        return list(self._cols)

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def __getitem__(self, name: str) -> np.ndarray:
        if name not in self._cols:
            raise KeyError(f"column {name!r} not in {self.columns}")
        return self._cols[name]

    def col(self, name: str) -> np.ndarray:
        return self[name]

    def with_column(self, name: str, values) -> "MLFrame":
        cols = dict(self._cols)
        cols[name] = self._coerce(values)
        return MLFrame(self.ctx, cols)

    def select(self, *names: str) -> "MLFrame":
        return MLFrame(self.ctx, {n: self[n] for n in names})

    def drop(self, *names: str) -> "MLFrame":
        return MLFrame(self.ctx, {k: v for k, v in self._cols.items()
                                  if k not in names})

    def with_column_renamed(self, old: str, new: str) -> "MLFrame":
        return MLFrame(self.ctx, {(new if k == old else k): v
                                  for k, v in self._cols.items()})

    def filter_rows(self, mask: np.ndarray) -> "MLFrame":
        """A frame of the rows where ``mask`` is True (a boolean mask or an
        index array), every column alike."""
        return MLFrame(self.ctx, {k: v[mask] for k, v in self._cols.items()})

    def sample(self, fraction: float, seed: int = 0) -> "MLFrame":
        """Each row kept when its uniform draw is below ``fraction``."""
        mask = np.random.RandomState(seed).rand(self.n_rows) < fraction
        return self.filter_rows(mask)

    def random_split(self, weights: Sequence[float],
                     seed: int = 0) -> List["MLFrame"]:
        """Disjoint frames in the proportions of ``weights``: one uniform
        draw a row, cut at the weights' cumulative shares."""
        u = np.random.RandomState(seed).rand(self.n_rows)
        total = float(sum(weights))
        out, lo = [], 0.0
        for hi in np.cumsum([w / total for w in weights]):
            out.append(self.filter_rows((u >= lo) & (u < hi)))
            lo = hi
        return out

    def limit(self, n: int) -> "MLFrame":
        return MLFrame(self.ctx, {k: v[:n] for k, v in self._cols.items()})

    def count(self) -> int:
        return self.n_rows

    def collect(self) -> List[tuple]:
        names = self.columns
        return [tuple(self._cols[c][i] for c in names)
                for i in range(self.n_rows)]

    def head(self, n: int = 5):
        return self.limit(n).collect()

    def to_instance_dataset(self, features_col: str = "features",
                            label_col: Optional[str] = "label",
                            weight_col: Optional[str] = None,
                            dtype=None,
                            fp8_capable: bool = False) -> InstanceDataset:
        """The frame's columns as a device-placed dataset, cached per
        column selection and dtype (the frame is immutable, so repeated
        fits reuse one placement). ``fp8_capable`` is the second rung's
        opt-in (:func:`instance.data_dtype`): only callers that fold the
        per-column scales into their read get e4m3 codes under the fp8
        tiers; every other caller gets bfloat16."""
        if dtype is None:
            from cycloneml_tpu_torch.dataset.instance import data_dtype
            dtype = data_dtype(getattr(self.ctx, "conf", None),
                               fp8_capable=fp8_capable)
        # keyed on the dtype's NAME: a quantized dataset is never served to
        # a caller that asked for the bf16 rung
        key = (features_col, label_col, weight_col, str(dtype))
        ds = self._ds_cache.get(key)
        if ds is None:
            x = self[features_col]
            if x.ndim == 1:
                x = x[:, None]
            y = self[label_col] if label_col else None
            w = self[weight_col] if weight_col else None
            ds = InstanceDataset.from_numpy(self.ctx, x, y, w, dtype=dtype)
            # a frame's cached datasets are the long-lived training blocks
            # the reference persists (MEMORY_AND_DISK): registered with the
            # context's storage tiers, the budgets bound cold frames
            ds.persist()
            self._ds_cache[key] = ds
        return ds

    def __repr__(self) -> str:
        shapes = {k: v.shape for k, v in self._cols.items()}
        return f"MLFrame({self.n_rows} rows, {shapes})"
