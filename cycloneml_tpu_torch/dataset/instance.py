"""Instance blocking — the dtype tiers and the padded row layout.

The port's counterpart of ``cycloneml_tpu/dataset/instance.py``: the whole
dataset is one dense ``(rows, features)`` tensor on the device, padded with
zero-weight rows to a multiple of 8 rows per shard. Zero weight makes the
padding exactly neutral in every weighted sum — the invariant every
estimator relies on.

Two dtype tiers: the DATA tier stores X (bfloat16 by default), the
ACCUMULATOR tier holds labels, weights, optimizer state and every reduction
(float32 on the card, float64 for parity runs). The reference keys the
accumulator tier off jax's x64 flag; the port reads it explicitly from
``cyclone.compute.dtype``.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch


def _active_conf(conf):
    if conf is not None:
        return conf
    from cycloneml_tpu_torch import context as _c
    ctx = _c.active_context()
    return ctx.conf if ctx is not None else None


def compute_dtype(conf=None) -> torch.dtype:
    """The ACCUMULATOR dtype (``cyclone.compute.dtype``): float32, or
    float64 for parity runs. ``conf`` defaults to the active context's."""
    from cycloneml_tpu_torch.conf import COMPUTE_DTYPE
    conf = _active_conf(conf)
    name = conf.get(COMPUTE_DTYPE) if conf is not None else "float32"
    return torch.float64 if name == "float64" else torch.float32


def data_dtype(conf=None) -> torch.dtype:
    """The DATA-tier storage dtype of a design matrix
    (``cyclone.data.dtype``). 'auto' is bfloat16 unless the accumulator
    tier is float64, where it is float64 (the reference's x64 rule)."""
    from cycloneml_tpu_torch.conf import DATA_DTYPE
    conf = _active_conf(conf)
    name = str(conf.get(DATA_DTYPE)) if conf is not None else "auto"
    if name == "auto":
        return torch.float64 if compute_dtype(conf) == torch.float64 \
            else torch.bfloat16
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float64": torch.float64}[name]


def is_narrow_dtype(dt) -> bool:
    """True for sub-float32 storage dtypes (bf16/f16) — the tier boundary
    where float32 accumulation becomes mandatory."""
    return dt.itemsize < 4


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def blockify_arrays(x: np.ndarray, y: Optional[np.ndarray],
                    w: Optional[np.ndarray], n_shards: int,
                    rows_multiple: int = 8, dtype=torch.float32,
                    yw_dtype=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Pad (x, y, w) to a shard-divisible row count with zero-weight rows.

    Returns host tensors ``(x_pad, y_pad, w_pad, n_true)``. The row count
    is padded to a multiple of ``n_shards * rows_multiple``. ``dtype`` is
    the DATA tier (X only); ``y``/``w`` are in ``yw_dtype`` (default
    :func:`compute_dtype`) so weight sums and label moments stay exact.
    """
    n = x.shape[0]
    if yw_dtype is None:
        yw_dtype = compute_dtype()
    target = max(_round_up(n, n_shards * rows_multiple),
                 n_shards * rows_multiple)
    x_pad = torch.zeros((target, x.shape[1]), dtype=dtype)
    y_pad = torch.zeros(target, dtype=yw_dtype)
    w_pad = torch.zeros(target, dtype=yw_dtype)
    with warnings.catch_warnings():
        # a read-only array (an MLFrame column) is only copied from here,
        # which is safe; torch warns about any read-only source
        warnings.simplefilter("ignore", UserWarning)
        x_pad[:n] = torch.from_numpy(np.ascontiguousarray(x))
        if y is not None:
            y_pad[:n] = torch.from_numpy(np.ascontiguousarray(y, np.float64))
        if w is not None:
            w_pad[:n] = torch.from_numpy(np.ascontiguousarray(w, np.float64))
    if w is None:
        w_pad[:n] = 1.0
    return x_pad, y_pad, w_pad, n
