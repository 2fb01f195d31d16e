"""Shared distance helpers for the clustering family — the port's copy of
``cycloneml_tpu/ml/clustering/_util.py``: the ``|x|^2 + |c|^2 - 2 x.c``
expansion on the host, and unit-row normalization (cosine mode) on the
host or the device, with one epsilon for both."""

from __future__ import annotations

import numpy as np
import torch

_NORM_EPS = 1e-12
ROW_CHUNK = 1 << 16  # rows of a device X normalized at a time


def pairwise_sq_dists(x: np.ndarray, c: np.ndarray) -> np.ndarray:
    """(n, k) squared euclidean distances of host rows to host centers,
    through one product."""
    x = np.asarray(x)
    if x.dtype.itemsize < 4:
        x = x.astype(np.float32)
    dot = x @ c.T
    return (np.sum(x * x, axis=1)[:, None]
            + np.sum(c * c, axis=1)[None, :] - 2.0 * dot)


def normalize_rows(x):
    """Rows scaled to unit L2 norm (cosine-distance preprocessing). A
    numpy array is normalized on the host; a tensor on its device, a chunk
    of rows at a time, with norms at float32 or wider for narrow (bf16)
    rows, and the result back in the input's dtype (the normalized copy
    does not widen the data tier)."""
    if not torch.is_tensor(x):
        xw = x if x.dtype.itemsize >= 4 else x.astype(np.float32)
        out = xw / np.maximum(np.sqrt(np.sum(xw * xw, axis=1))[:, None],
                              _NORM_EPS)
        return out if out.dtype == x.dtype else out.astype(x.dtype)
    wide = x.dtype if x.dtype.itemsize >= 4 else torch.float32
    out = torch.empty_like(x)
    for lo in range(0, x.shape[0], ROW_CHUNK):
        xc = x[lo:lo + ROW_CHUNK].to(wide)
        norms = torch.sqrt(torch.sum(xc * xc, dim=1))
        out[lo:lo + ROW_CHUNK] = (
            xc / torch.clamp(norms, min=_NORM_EPS)[:, None]).to(x.dtype)
    return out
