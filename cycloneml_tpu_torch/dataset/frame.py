"""MLFrame — a named-column frame for the estimator API.

The port's counterpart of ``cycloneml_tpu/dataset/frame.py:MLFrame``: a
dict of numpy columns (1-D scalars or 2-D vector columns) sharing a row
count, with the bridge to :class:`InstanceDataset` that estimators use.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from cycloneml_tpu_torch.dataset.dataset import InstanceDataset


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
        else:
            arr = np.asarray(col)
        arr.flags.writeable = False
        return arr

    @property
    def columns(self) -> List[str]:
        return list(self._cols)

    def __getitem__(self, name: str) -> np.ndarray:
        if name not in self._cols:
            raise KeyError(f"column {name!r} not in {self.columns}")
        return self._cols[name]

    def with_column(self, name: str, values) -> "MLFrame":
        cols = dict(self._cols)
        cols[name] = self._coerce(values)
        return MLFrame(self.ctx, cols)

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
            self._ds_cache[key] = ds
        return ds

    def __repr__(self) -> str:
        shapes = {k: v.shape for k, v in self._cols.items()}
        return f"MLFrame({self.n_rows} rows, {shapes})"
