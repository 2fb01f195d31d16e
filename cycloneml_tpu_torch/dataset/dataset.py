"""InstanceDataset — the numeric tier every estimator trains on.

The port's counterpart of ``cycloneml_tpu/dataset/dataset.py:
InstanceDataset``: ``x`` is ``(n_pad, d)`` in the data tier, ``y``/``w`` are
``(n_pad,)`` in the accumulator tier, all on the mesh's device; padding
rows carry w=0. Host twins of the padded (y, w) are kept when they are
known, so estimators read label histograms without a device readback.

On the fp8 rung ``x`` holds e4m3 CODES and ``x_scale`` the per-column
float64 scales: the value is ``x * x_scale``. Only fp8-capable fits read the
codes (folding the scale into their (d,) vectors); everything else gets a
bfloat16 dequantization through :func:`fp8_fallback`, which always logs.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from cycloneml_tpu_torch.dataset.instance import (blockify_arrays,
                                                  compute_dtype, data_dtype,
                                                  fp8_probe_ok, is_fp8_dtype,
                                                  quantize_fp8)
from cycloneml_tpu_torch.parallel import collectives

logger = logging.getLogger(__name__)

_DEQUANT_ROWS = 1 << 16  # rows of fp8 codes widened at a time


def fp8_fallback(ds: "InstanceDataset", estimator: str,
                 reason: str) -> "InstanceDataset":
    """Leave the fp8 storage rung for this fit: log the reference's
    warning, record the decision in ``ctx.precision_fallbacks`` (the
    reference's ``PrecisionFallback`` event; the listener bus is ROADMAP
    slice 10) and return the bfloat16 dequantization. The fit goes on
    training; only the storage rung changes."""
    from_dt = str(ds.x.dtype).replace("torch.", "")
    logger.warning("%s: falling back from %s to bfloat16 storage — %s",
                   estimator, from_dt, reason)
    record = getattr(ds.ctx, "precision_fallbacks", None)
    if record is not None:
        record.append({"estimator": estimator, "from_dtype": from_dt,
                       "to_dtype": "bfloat16", "reason": reason})
    return ds.dequantized()


def resolve_fp8_fit(ds: "InstanceDataset", stats,
                    estimator: str) -> "InstanceDataset":
    """The per-fit fp8 safety rail: the envelope probe
    (:func:`instance.fp8_probe_ok`) on statistics already at hand, and a
    fallback to bfloat16 storage when e4m3 would break the documented
    accuracy envelope. ``ds`` itself when it is not quantized or passes."""
    if ds.x_scale is None:
        return ds
    w_host = ds.w_host()
    w_max = float(np.max(w_host)) if len(w_host) else None
    reason = fp8_probe_ok(stats, w_max, probe_ratio=ds._fp8_probe_ratio)
    if reason is None:
        return ds
    return fp8_fallback(ds, estimator, reason)


class InstanceDataset:
    def __init__(self, ctx, x: torch.Tensor, y: torch.Tensor,
                 w: torch.Tensor, n_rows: int, n_features: int,
                 x_scale: Optional[np.ndarray] = None):
        self.ctx = ctx
        self._x = x
        self._y = y
        self._w = w
        if (x_scale is not None) != is_fp8_dtype(x.dtype):
            raise ValueError("an fp8 X needs its per-column x_scale, and "
                             f"only an fp8 X takes one (X is {x.dtype})")
        # fp8 rung: per-column dequantization scales, float64 on the host
        self._x_scale: Optional[np.ndarray] = (
            np.asarray(x_scale, dtype=np.float64)
            if x_scale is not None else None)
        # the RAW data's per-column absmax/std, taken when quantizing: the
        # envelope probe's input (the codes cannot show a collapsed column)
        self._fp8_probe_ratio: Optional[np.ndarray] = None
        self._yw_host: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._summary_cache = None  # Summarizer moments (immutable data)
        self.n_rows = n_rows
        self.n_features = n_features

    @classmethod
    def from_numpy(cls, ctx, x: np.ndarray, y: Optional[np.ndarray] = None,
                   w: Optional[np.ndarray] = None,
                   dtype: Optional[torch.dtype] = None) -> "InstanceDataset":
        """Pad host arrays with zero-weight rows and place them on the
        mesh: X in the data tier (``dtype``, default
        :func:`data_dtype`), y/w in the accumulator tier. An fp8 ``dtype``
        quantizes X first (:func:`instance.quantize_fp8`, statistics over
        the real rows only), keeping its scales and probe ratio."""
        conf = getattr(ctx, "conf", None)
        if dtype is None:
            dtype = data_dtype(conf)
        x = np.asarray(x)
        x_scale = probe_ratio = None
        if is_fp8_dtype(dtype):
            x, x_scale, probe_ratio = quantize_fp8(x)
        ds = cls._place(ctx, x, y, w, dtype, x_scale)
        ds._fp8_probe_ratio = probe_ratio
        return ds

    @classmethod
    def from_fp8_codes(cls, ctx, codes: np.ndarray, x_scale,
                       y: Optional[np.ndarray] = None,
                       w: Optional[np.ndarray] = None,
                       probe_ratio=None) -> "InstanceDataset":
        """A dataset over e4m3 codes quantized elsewhere (the reference's
        fp8 dataset, carried across by ``interop``): ``codes`` is any
        1-byte numpy array holding float8_e4m3fn bits, placed bit for bit
        with its ``x_scale`` and probe ratio."""
        codes = np.ascontiguousarray(codes)
        if codes.dtype.itemsize != 1 or codes.ndim != 2:
            raise ValueError("from_fp8_codes: codes must be a 2-D array of "
                             f"1-byte elements; got {codes.shape} "
                             f"{codes.dtype}")
        x8 = torch.from_numpy(codes.view(np.uint8)).view(torch.float8_e4m3fn)
        ds = cls._place(ctx, x8, y, w, torch.float8_e4m3fn, x_scale)
        ds._fp8_probe_ratio = (None if probe_ratio is None else
                               np.asarray(probe_ratio, dtype=np.float64))
        return ds

    @classmethod
    def _place(cls, ctx, x, y, w, dtype, x_scale) -> "InstanceDataset":
        conf = getattr(ctx, "conf", None)
        rt = ctx.mesh_runtime
        x_p, y_p, w_p, n = blockify_arrays(x, y, w, rt.data_parallelism,
                                           dtype=dtype,
                                           yw_dtype=compute_dtype(conf))
        ds = cls(ctx, rt.device_put_sharded_rows(x_p),
                 rt.device_put_sharded_rows(y_p),
                 rt.device_put_sharded_rows(w_p), n, x.shape[1],
                 x_scale=x_scale)
        ds._yw_host = (y_p.numpy(), w_p.numpy())
        return ds

    def quantized(self) -> "InstanceDataset":
        """This dataset on the fp8 rung: its real rows quantized on their
        device (:func:`instance.quantize_fp8`, statistics over the real
        rows only) into a new X whose padding rows are zero codes; y, w and
        the host twins are shared. ``self`` when already quantized."""
        if self._x_scale is not None:
            return self
        x8 = torch.zeros(self._x.shape, dtype=torch.uint8,
                         device=self._x.device).view(torch.float8_e4m3fn)
        _, scale, ratio = quantize_fp8(self._x[:self.n_rows], out=x8)
        ds = InstanceDataset(self.ctx, x8, self._y, self._w, self.n_rows,
                             self.n_features, x_scale=scale)
        ds._fp8_probe_ratio = ratio
        ds._yw_host = self._yw_host
        return ds

    def attach_host_labels(self, y: np.ndarray,
                           w: np.ndarray) -> "InstanceDataset":
        """Attach padded host twins of (y, w), so ``y_host``/``w_host``
        never read the device back."""
        self._yw_host = (y, w)
        return self

    def derive(self, x=None, y=None, w=None,
               n_features: Optional[int] = None) -> "InstanceDataset":
        """A dataset with some arrays replaced and this dataset's row
        metadata kept: the row count, and the host twins of (y, w) when
        neither changes. Row-aligned transformations (normalization, X.B
        products) build their result through this."""
        ds = InstanceDataset(self.ctx, self._x if x is None else x,
                             self._y if y is None else y,
                             self._w if w is None else w, self.n_rows,
                             self.n_features if n_features is None
                             else n_features,
                             # the scales describe X: they follow an
                             # unchanged X and go with a replaced one
                             x_scale=self._x_scale if x is None else None)
        if x is None:
            ds._fp8_probe_ratio = self._fp8_probe_ratio
        if y is None and w is None:
            ds._yw_host = self._yw_host
        return ds

    def valid_indices(self) -> np.ndarray:
        """Padded-array positions of the real (non-padding) rows: the
        first ``n_rows`` (the port pads at the end only)."""
        return np.arange(self.n_rows)

    def gather_rows(self, idx) -> np.ndarray:
        """Host copy of the given padded row positions at the accumulator
        width (w's dtype): O(len(idx) d) moved, X itself is indexed in
        place on its device and never copied whole."""
        idx = np.asarray(idx, dtype=np.int64).ravel()
        if len(idx) == 0:
            return np.zeros((0, self.n_features))
        rows = self._x[torch.as_tensor(idx, device=self._x.device)]
        out = rows.to(self._w.dtype).cpu().numpy()
        if self._x_scale is not None:
            # codes -> values at the host boundary
            out = out.astype(np.float64) * self._x_scale[None, :]
        return out

    def to_instance_dataset(self, *args, fp8_capable: bool = False,
                            **kwargs) -> "InstanceDataset":
        """Already an InstanceDataset: estimators accept one as a frame
        (column names and dtype are ignored). A quantized dataset handed to
        a caller that is not fp8-capable is dequantized to bfloat16 first:
        raw e4m3 codes are never read as values."""
        if self._x_scale is not None and not fp8_capable:
            return fp8_fallback(
                self, "to_instance_dataset",
                "estimator is not fp8-capable; dequantizing its view")
        return self

    @property
    def x_scale(self) -> Optional[np.ndarray]:
        """Per-column fp8 dequantization scales (float64 host ``(d,)``), or
        None on every wider tier; the value is ``x * x_scale``."""
        return self._x_scale

    def dequantized(self, dtype=torch.bfloat16) -> "InstanceDataset":
        """This dataset with X dequantized out of the fp8 rung into
        ``dtype`` (bfloat16, the next rung down): ``codes.float() * scale``
        a chunk of rows at a time on X's device, y/w and metadata carried
        by :meth:`derive`. ``self`` when not quantized."""
        if self._x_scale is None:
            return self
        s = torch.as_tensor(self._x_scale, dtype=torch.float32,
                            device=self._x.device)
        x = torch.empty(self._x.shape, dtype=dtype, device=self._x.device)
        for lo in range(0, x.shape[0], _DEQUANT_ROWS):
            hi = lo + _DEQUANT_ROWS
            x[lo:hi] = (self._x[lo:hi].to(torch.float32) * s).to(dtype)
        return self.derive(x=x)

    @property
    def x(self) -> torch.Tensor:
        return self._x

    @property
    def y(self) -> torch.Tensor:
        return self._y

    @property
    def w(self) -> torch.Tensor:
        return self._w

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_rows, self.n_features)

    def y_host(self) -> np.ndarray:
        """Padded label vector as numpy."""
        if self._yw_host is not None:
            return self._yw_host[0]
        return self._y.cpu().numpy()

    def w_host(self) -> np.ndarray:
        """Padded weight vector as numpy."""
        if self._yw_host is not None:
            return self._yw_host[1]
        return self._w.cpu().numpy()

    def padded_bytes(self) -> int:
        """Storage footprint of the padded block."""
        return (self._x.numel() * self._x.element_size()
                + self._y.numel() * self._y.element_size()
                + self._w.numel() * self._w.element_size())

    def to_numpy(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Unpadded host copies; a bf16 X comes back as float32, fp8 codes
        dequantized to float64 values (host readbacks always see values)."""
        n = self.n_rows
        x = self._x[:n]
        if x.dtype == torch.bfloat16:
            x = x.float()
        if self._x_scale is not None:
            x = x.double().cpu().numpy() * self._x_scale[None, :]
        else:
            x = x.cpu().numpy()
        return (x, self._y[:n].cpu().numpy(), self._w[:n].cpu().numpy())

    def tree_aggregate_fn(self, fn: Callable, auto_psum: bool = True):
        """``fn(x_shard, y_shard, w_shard, *extras) -> pytree`` summed over
        the mesh; returns a callable taking the extras. ``.compiled`` is the
        aggregation over explicit ``(x, y, w, *extras)`` and ``.arrays()``
        the dataset's arrays, so a caller can run the aggregation inside
        its own loop."""
        compiled = collectives.tree_aggregate(
            fn, self.ctx.mesh_runtime, self.x, self.y, self.w,
            auto_psum=auto_psum)
        ds = self

        def call(*extras):
            return compiled(ds.x, ds.y, ds.w, *extras)

        call.compiled = compiled
        call.arrays = lambda: (ds.x, ds.y, ds.w)
        return call
