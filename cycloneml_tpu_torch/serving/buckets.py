"""Padded shape buckets: the prepare-once contract of the model server.

The port's copy of ``cycloneml_tpu/serving/buckets.py``. Request shapes
are quantized into a small fixed set of buckets: power-of-two row counts
from 1 up through ``cyclone.serving.maxBatch``, each batch zero-padded up
to its bucket and the padding rows sliced off after dispatch.
Registration prepares every bucket (on the card one CUDA graph a bucket,
``serving/batcher.py``), so the whole bill is paid before the first
request arrives and the steady state prepares nothing.

Padding is numerically neutral by construction: the predict kernel
(``ops/kernels.serving_margins``) reduces each row in an order that does
not depend on the bucket, so a row's result has the same bits whatever
bucket carries it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << (int(n) - 1).bit_length() if n > 1 else 1


def bucket_sizes(max_batch: int) -> Tuple[int, ...]:
    """Every bucket the server prepares: 1, 2, 4, ... up through the next
    power of two >= ``max_batch`` (so a full ``max_batch``-row coalesced
    batch always has a bucket)."""
    top = next_pow2(max(1, int(max_batch)))
    out, b = [], 1
    while b <= top:
        out.append(b)
        b <<= 1
    return tuple(out)


def bucket_for(n_rows: int, max_batch: int) -> int:
    """The bucket an ``n_rows`` batch dispatches in. ``n_rows`` must not
    exceed the largest bucket (the batcher caps coalescing at maxBatch)."""
    if n_rows < 1:
        raise ValueError("empty batch has no bucket")
    b = next_pow2(n_rows)
    top = next_pow2(max(1, int(max_batch)))
    if b > top:
        raise ValueError(
            f"batch of {n_rows} rows exceeds the largest bucket {top} "
            f"(cyclone.serving.maxBatch)")
    return b


def pad_rows(x: np.ndarray, bucket: int) -> np.ndarray:
    """Zero-pad ``x`` (n, d) up to (bucket, d). Returns ``x`` unchanged
    when it already fills the bucket exactly: no copy on the hot path."""
    n = x.shape[0]
    if n == bucket:
        return x
    if n > bucket:
        raise ValueError(f"{n} rows do not fit bucket {bucket}")
    out = np.zeros((bucket,) + x.shape[1:], dtype=x.dtype)
    out[:n] = x
    return out
