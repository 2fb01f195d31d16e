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
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from cycloneml_tpu_torch.linalg.vectors import SparseVector, Vector


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


def data_dtype(conf=None, fp8_capable: bool = False) -> torch.dtype:
    """The DATA-tier storage dtype of a design matrix
    (``cyclone.data.dtype``). 'auto' is bfloat16 unless the accumulator
    tier is float64, where it is float64 (the reference's x64 rule).

    ``fp8_capable`` is the second rung's opt-in: 'auto8' and 'float8'
    resolve to ``torch.float8_e4m3fn`` only for callers that fold the
    per-column scales into their read (LogisticRegression and the
    LinearRegression l-bfgs path); every other caller gets bfloat16 under
    those tiers, so raw codes never reach code that would read them as
    values. 'auto8' keeps the float64 parity tier full width, as 'auto'
    does; 'float8' forces e4m3 for capable callers even there."""
    from cycloneml_tpu_torch.conf import DATA_DTYPE
    conf = _active_conf(conf)
    name = str(conf.get(DATA_DTYPE)) if conf is not None else "auto"
    parity = compute_dtype(conf) == torch.float64
    if name in ("auto", "auto8") and parity:
        return torch.float64
    if name == "auto":
        return torch.bfloat16
    if name in ("auto8", "float8"):
        return torch.float8_e4m3fn if fp8_capable else torch.bfloat16
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float64": torch.float64}[name]


def is_narrow_dtype(dt) -> bool:
    """True for sub-float32 storage dtypes (bf16/f16/fp8) — the tier
    boundary where float32 accumulation becomes mandatory."""
    return dt.itemsize < 4


#: the largest finite float8_e4m3fn value. e4m3fn has no inf, so every
#: fp8 materialization scales its columns into this range first.
FP8_MAX = 448.0

#: the envelope probe's threshold (:func:`fp8_probe_ok`): a column whose
#: absmax/std exceeds it would carry more than ~2 sigma of e4m3 rounding
#: noise per standardized element, and the fit falls back to bfloat16.
FP8_PROBE_RATIO = 32.0

_STAT_ROWS = 1 << 16  # rows of X upcast to float64 at a time by the stats


def is_fp8_dtype(dt) -> bool:
    """True for the 1-byte float8 storage dtypes (e4m3fn, e5m2)."""
    return isinstance(dt, torch.dtype) and str(dt).startswith("torch.float8")


def _column_stats(x: torch.Tensor, chunk_rows: int = _STAT_ROWS):
    """Per-column (absmax, population std) of ``x`` in float64, a chunk of
    rows at a time on x's device: the mean first, then the squared
    deviations from it (the two-pass form numpy's std uses)."""
    n, d = x.shape
    f64 = torch.float64
    absmax = torch.zeros(d, dtype=f64, device=x.device)
    s1 = torch.zeros(d, dtype=f64, device=x.device)
    for lo in range(0, n, chunk_rows):
        xc = x[lo:lo + chunk_rows].to(f64)
        absmax = torch.maximum(absmax, xc.abs().amax(0))
        s1 += xc.sum(0)
    if n == 0:
        return absmax, torch.zeros(d, dtype=f64, device=x.device)
    mean = s1 / n
    s2 = torch.zeros(d, dtype=f64, device=x.device)
    for lo in range(0, n, chunk_rows):
        dx = x[lo:lo + chunk_rows].to(f64) - mean
        s2 += (dx * dx).sum(0)
    return absmax, torch.sqrt(s2 / n)


def quantize_fp8(x, scale=None, out: Optional[torch.Tensor] = None,
                 chunk_rows: int = _STAT_ROWS):
    """Quantize a design matrix to e4m3 codes with PER-COLUMN scales
    (the counterpart of the reference's ``instance.quantize_fp8``).

    ``x`` is numpy or a tensor (any float dtype, on any device); the work
    runs ``chunk_rows`` rows at a time on x's device, so no float64 copy of
    X is held. Returns ``(codes, scale, probe_ratio)``:

    - ``codes``: ``torch.float8_e4m3fn`` on x's device,
      ``codes[i, j] ~= x[i, j] / scale[j]``, written into ``out[:n]`` when
      ``out`` is given (rows of ``out`` past n are left as they are);
    - ``scale``: float64 numpy ``(d,)``, ``absmax_j / FP8_MAX`` (1.0 for an
      all-zero column), so every code is finite; pass ``scale`` to quantize
      against a fixed one instead;
    - ``probe_ratio``: float64 numpy ``(d,)``, the raw ``absmax_j / std_j``
      (0 where std is 0), the envelope probe's input. It is taken here,
      before quantization: a near-constant column collapses to one code
      and its quantized std no longer shows the damage.

    Statistics are those of exactly the rows given: pass the real rows,
    not padding."""
    if isinstance(x, np.ndarray):
        with warnings.catch_warnings():
            # only read from here; torch warns about any read-only source
            warnings.simplefilter("ignore", UserWarning)
            x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float64))
    n, d = x.shape
    absmax, std = _column_stats(x, chunk_rows)
    absmax_h = absmax.cpu().numpy()
    std_h = std.cpu().numpy()
    if scale is None:
        scale = np.where(absmax_h > 0, absmax_h / FP8_MAX, 1.0)
    else:
        scale = np.asarray(scale, dtype=np.float64)
        if scale.shape != (d,):
            raise ValueError(f"quantize_fp8: scale has shape {scale.shape}, "
                             f"expected ({d},)")
    probe_ratio = np.where(std_h > 0,
                           absmax_h / np.where(std_h > 0, std_h, 1.0), 0.0)
    if out is None:
        out = torch.empty((n, d), dtype=torch.float8_e4m3fn, device=x.device)
    elif out.dtype != torch.float8_e4m3fn or out.shape[0] < n \
            or out.shape[1] != d:
        raise ValueError(f"quantize_fp8: out {tuple(out.shape)} {out.dtype} "
                         f"cannot hold {(n, d)} e4m3 codes")
    s = torch.as_tensor(scale, dtype=torch.float64, device=x.device)
    for lo in range(0, n, chunk_rows):
        hi = min(lo + chunk_rows, n)
        # a division, as the reference's: the codes come out bit for bit
        out[lo:hi] = (x[lo:hi].to(torch.float64) / s).to(torch.float8_e4m3fn)
    return out[:n], scale, probe_ratio


def fp8_probe_ok(stats, w_max: Optional[float] = None,
                 probe_ratio: Optional[np.ndarray] = None) -> Optional[str]:
    """The pre-fit envelope probe (the reference's ``fp8_probe_ok``):
    whether e4m3 storage keeps the documented accuracy envelope, decided
    from statistics already at hand. Returns None when it does, else the
    reason (the reference's words).

    - Scale spread: after standardization an element's rounding noise is
      ~``2^-4 absmax_j / std_j`` sigmas. The ratio comes from
      ``probe_ratio`` (raw, from :func:`quantize_fp8`) when given, else
      from the Summarizer moments in ``stats``; zero-variance columns are
      exempt (standardization drops them).
    - Weight overflow: a weight beyond e4m3's finite range."""
    if probe_ratio is not None:
        ratio = np.asarray(probe_ratio, dtype=np.float64)
        live = ratio > 0
    else:
        std = np.asarray(stats.std, dtype=np.float64)
        absmax = np.maximum(np.abs(np.asarray(stats.max)),
                            np.abs(np.asarray(stats.min)))
        live = std > 0
        ratio = np.where(live, absmax / np.where(live, std, 1.0), 0.0)
    if live.any():
        worst = float(ratio[live].max())
        if worst > FP8_PROBE_RATIO:
            j = int(np.argmax(np.where(live, ratio, -np.inf)))
            return (f"column {j} has absmax/std {worst:.1f} > "
                    f"{FP8_PROBE_RATIO:g}: e4m3 rounding would exceed the "
                    f"documented envelope after standardization")
    if w_max is not None and w_max > FP8_MAX:
        return (f"max instance weight {w_max:.1f} > {FP8_MAX:g}: the "
                f"backward multiplier would overflow e4m3's finite range")
    return None


@dataclass
class Instance:
    """One labeled weighted row (ref Instance.scala case class Instance)."""

    label: float
    weight: float
    features: Vector


def rows_to_dense(features: Sequence[Vector],
                  n_features: Optional[int] = None) -> np.ndarray:
    """A sequence of (possibly sparse) vectors stacked into a float64
    ``(len, n_features)`` matrix, ``n_features`` the widest by default."""
    if n_features is None:
        n_features = max(f.size for f in features)
    out = np.zeros((len(features), n_features), dtype=np.float64)
    for i, f in enumerate(features):
        if isinstance(f, SparseVector):
            out[i, f.indices] = f.values
        else:
            out[i, : f.size] = f.to_array()
    return out


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def blockify_arrays(x, y: Optional[np.ndarray],
                    w: Optional[np.ndarray], n_shards: int,
                    rows_multiple: int = 8, dtype=torch.float32,
                    yw_dtype=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Pad (x, y, w) to a shard-divisible row count with zero-weight rows.

    ``x`` is numpy, or a host tensor already in ``dtype`` (fp8 codes).
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
        x_pad[:n] = x if isinstance(x, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(x))
        if y is not None:
            y_pad[:n] = torch.from_numpy(np.ascontiguousarray(y, np.float64))
        if w is not None:
            w_pad[:n] = torch.from_numpy(np.ascontiguousarray(w, np.float64))
    if w is None:
        w_pad[:n] = 1.0
    return x_pad, y_pad, w_pad, n
