"""Shard store: the out-of-core dataset representation.

The port's counterpart of ``cycloneml_tpu/oocore/shards.py``. A
:class:`StreamingDataset` is what an estimator trains on when the design
matrix must never sit whole in device memory: a sequence of bounded shard
files on disk plus the one-pass statistics every fit path needs (the
Summarizer moments, the label histogram, the label moments, the weight
sum), harvested while the shards are WRITTEN, so no epoch is spent on
statistics and no O(n) host vector outlives construction.

**The file format** is the port's own: one raw file a shard
(``shard-NNNNNN.bin``), X's rows in C order at the stream dtype's width
(float32 or float64 as they are, bfloat16 as its 16 bits, e4m3 as its
1-byte codes), then y, then w at the accumulator tier's width (float32 on
the card, float64 on the parity tier). The layout (rows, d, dtypes) lives
in the :class:`StreamingDataset`, not in the file, so a shard's bytes can
be read straight into a pinned staging buffer at fixed offsets
(:meth:`StreamingDataset.read_into`, ``os.preadv``); the reference's npz
shards are not read. The machine with the card has no ``ml_dtypes``: the
bits are viewed through ``torch.Tensor.view(dtype)``.

Geometry: every shard is staged in one fixed ``(pad_rows, d)`` block
(zero-weight rows past its own), so the device slots are allocated once
and host staging peaks at O(pad_rows d), never O(n d).
"""

from __future__ import annotations

import logging
import os
import tempfile
import threading
import warnings
from dataclasses import dataclass, field
from typing import Iterable, List, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

#: labels above this are not class indices: histogram harvesting stops
_MAX_CLASSES = 4096


def _as_tensor(a) -> torch.Tensor:
    """A chunk's X as a tensor (a numpy array shares its memory)."""
    if torch.is_tensor(a):
        return a
    with warnings.catch_warnings():
        # a read-only chunk (np.frombuffer, a memmap) is only read here
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(np.ascontiguousarray(a))


def _bytes_of(t: torch.Tensor) -> np.ndarray:
    """The raw bytes of a contiguous CPU tensor as a uint8 numpy view."""
    return t.contiguous().view(torch.uint8).numpy().reshape(-1)


@dataclass
class _Moments:
    """float64 running sums of the Summarizer's moment set (rows with w >
    0 are 'present', as ``ml/stat/summarizer._moments``), plus the label
    side the fits read (the histogram for classifiers, the y moments for
    regressors). The X sums run on ``device`` (the card's, where the
    dataset's context is) through the Summarizer's own pass; the label
    sums on the host. :meth:`close` reads them back once."""

    d: int
    device: torch.device = torch.device("cpu")
    sums: Optional[dict] = None
    abs_all: Optional[torch.Tensor] = None
    s1y: float = 0.0
    s2y: float = 0.0
    w_max: float = 0.0
    histogram: np.ndarray = field(default_factory=lambda: np.zeros(0))
    integral_labels: bool = True

    def update(self, x: torch.Tensor, y: np.ndarray, w: np.ndarray) -> None:
        """Add rows: ``x`` at its stored (data-tier) values on any device,
        y and w float64 host arrays."""
        from cycloneml_tpu_torch.ml.stat.summarizer import _moments
        x = x.to(self.device)
        w_d = torch.as_tensor(w, dtype=torch.float64, device=self.device)
        out = _moments(x, None, w_d)
        if self.sums is None:
            self.sums = out
            self.abs_all = torch.zeros(self.d, dtype=torch.float64,
                                       device=self.device)
        else:
            for k in ("s1", "s2", "w", "w2", "cnt", "nnz", "l1"):
                self.sums[k] = self.sums[k] + out[k]
            self.sums["mx"] = torch.maximum(self.sums["mx"], out["mx"])
            self.sums["mn"] = torch.minimum(self.sums["mn"], out["mn"])
        if x.shape[0]:
            # ALL rows, zero-weight ones too: the fp8 set scale must hold
            # every stored value (an out-of-range code is NaN, and 0 * NaN
            # would still poison a sum)
            self.abs_all = torch.maximum(
                self.abs_all, x.to(torch.float64).abs().amax(0))
        y = np.asarray(y, dtype=np.float64)
        w = np.asarray(w, dtype=np.float64)
        self.s1y += float((w * y).sum())
        self.s2y += float((w * y * y).sum())
        if w.size:
            self.w_max = max(self.w_max, float(w.max()))
        if self.integral_labels:
            present = w > 0
            yp = y[present]
            if yp.size and (np.any(yp != np.round(yp)) or yp.min() < 0
                            or yp.max() >= _MAX_CLASSES):
                self.integral_labels = False
            elif yp.size:
                hist = np.bincount(yp.astype(np.int64), weights=w[present],
                                   minlength=len(self.histogram))
                if len(hist) > len(self.histogram):
                    self.histogram = np.pad(
                        self.histogram, (0, len(hist) - len(self.histogram)))
                self.histogram = self.histogram + hist

    def close(self) -> "_Moments":
        """Read the X sums back to host float64 (once)."""
        if self.sums is None:
            self.sums = {k: np.zeros(self.d) for k in
                         ("s1", "s2", "nnz", "l1")}
            self.sums.update(w=0.0, w2=0.0, cnt=0.0,
                             mx=np.full(self.d, -np.inf),
                             mn=np.full(self.d, np.inf))
            self.abs_all = np.zeros(self.d)
        elif torch.is_tensor(self.abs_all):
            self.sums = {k: (v.double().cpu().numpy() if v.dim() else
                             float(v)) for k, v in self.sums.items()}
            self.abs_all = self.abs_all.cpu().numpy()
        return self

    @property
    def w(self) -> float:
        return float(self.sums["w"])


@dataclass
class _Shard:
    path: str
    rows: int


class StreamingDataset:
    """Disk-backed shard sequence plus one-pass fit statistics.

    Quacks like the corner of ``InstanceDataset`` the dense fit paths
    touch (``n_rows``, ``n_features``, ``shape``, ``ctx``,
    ``to_instance_dataset`` returning itself), so ``est.fit(sds)`` routes
    through the normal estimator entry and ``_fit_dataset`` dispatches on
    the type. The shard files are OWNED: removed on :meth:`close` or
    garbage collection.

    ``x_dtype`` is the stream dtype (what :meth:`read_into` stages:
    float32, float64, bfloat16 or e4m3 codes); ``x_scale`` the fp8 shard
    set's per-column float64 scale (the value is ``code * x_scale``);
    ``y_dtype`` the accumulator tier of y and w."""

    def __init__(self, ctx, shards: List[_Shard], n_features: int,
                 pad_rows: int, moments: _Moments, spill_dir: str,
                 owns_dir: bool, x_dtype: torch.dtype,
                 y_dtype: torch.dtype, x_scale: Optional[np.ndarray] = None):
        self.ctx = ctx
        self._shards = shards
        self.n_features = int(n_features)
        self.n_rows = int(sum(s.rows for s in shards))
        self.pad_rows = int(pad_rows)
        self._moments = moments
        self._dir = spill_dir
        self._owns_dir = owns_dir
        self.x_dtype = x_dtype
        self.y_dtype = y_dtype
        self.x_scale: Optional[np.ndarray] = (
            np.asarray(x_scale, dtype=np.float64)
            if x_scale is not None else None)
        self._closed = False
        self._close_lock = threading.Lock()

    # -- construction ------------------------------------------------------
    @classmethod
    def from_chunks(cls, ctx, chunks: Iterable, n_features: int,
                    shard_rows: Optional[int] = None,
                    spill_dir: Optional[str] = None,
                    stream_dtype: Optional[str] = None,
                    x_scale: Optional[np.ndarray] = None
                    ) -> "StreamingDataset":
        """Build from an iterator of ``(x, y_or_None, w_or_None)`` chunks
        (the chunk contract of ``dataset/io.py``'s ``iter_libsvm_chunks``,
        ``iter_npy_chunks`` and ``iter_csv_chunks``; x numpy or a tensor on
        any device) without ever holding more than one shard of rows.
        Chunks are re-blocked at ``cyclone.oocore.shardRows`` boundaries;
        X is cast to the stream tier (torch's round to nearest even) before
        it is written, and the moments are taken on the context's device
        from the cast rows.

        ``stream_dtype`` overrides ``cyclone.oocore.streamDtype`` for this
        build. When it resolves to fp8, the write pass stays one rung
        wider (the set-level absmax is unknown mid-stream) and a finalize
        pass (:func:`_finalize_fp8`) requantizes every shard with ONE
        set-level per-column scale, after the envelope probe over the
        write pass's moments; a refusal stays at the wider rung and is
        recorded in ``ctx.precision_fallbacks``.

        ``x_scale`` is the pre-quantized contract (:meth:`from_dataset`
        over an fp8 dataset): the chunks carry e4m3 codes whose value is
        ``code * x_scale``, written through unchanged, with the moments
        taken from the dequantized values and no probe (the in-core rail
        already ran it)."""
        from cycloneml_tpu_torch.conf import OOCORE_DIR, OOCORE_SHARD_ROWS
        from cycloneml_tpu_torch.dataset.instance import compute_dtype
        conf = getattr(ctx, "conf", None)
        if shard_rows is None:
            shard_rows = int(conf.get(OOCORE_SHARD_ROWS)) \
                if conf is not None else 65536
        shard_rows = max(int(shard_rows), 1)
        base = (conf.get(OOCORE_DIR) if conf is not None else "") or ""
        # only a directory made here is removed on close
        owns_dir = spill_dir is None
        spill_dir = spill_dir or tempfile.mkdtemp(prefix="oocore-",
                                                  dir=base or None)
        os.makedirs(spill_dir, exist_ok=True)

        if x_scale is not None:
            xdt, fp8_candidate = torch.float8_e4m3fn, False
            x_scale = np.asarray(x_scale, dtype=np.float64)
        else:
            xdt, fp8_candidate = _resolve_stream_dtype(conf, stream_dtype)
        ydt = compute_dtype(conf)
        np_ydt = np.float64 if ydt == torch.float64 else np.float32
        device = ctx.mesh_runtime.device
        moments = _Moments(int(n_features), device)
        shards: List[_Shard] = []
        carry: List[tuple] = []   # (x, y, w) pieces, < shard_rows together
        carry_rows = 0

        def flush(pieces, rows):
            xs = torch.cat([p[0] for p in pieces]) if len(pieces) > 1 \
                else pieces[0][0]
            ys = np.concatenate([p[1] for p in pieces])
            ws = np.concatenate([p[2] for p in pieces])
            path = os.path.join(spill_dir, f"shard-{len(shards):06d}.bin")
            _write_shard(path, xs.cpu(), ys.astype(np_ydt),
                         ws.astype(np_ydt))
            shards.append(_Shard(path, rows))
            if x_scale is not None:
                # codes are not values: the statistics are the values'
                xs = xs.to(device).to(torch.float64) * torch.as_tensor(
                    x_scale, device=device)
            moments.update(xs, ys, ws)

        for ci, (cx, cy, cw) in enumerate(chunks):
            cx = _as_tensor(cx)
            if cx.dim() != 2 or cx.shape[1] != n_features:
                raise ValueError(f"chunk {ci} has shape {tuple(cx.shape)}, "
                                 f"expected (rows, {n_features})")
            m = cx.shape[0]
            if cx.dtype != xdt:
                cx = cx.to(xdt)
            cy = (np.zeros(m) if cy is None
                  else np.asarray(cy, dtype=np.float64))
            cw = (np.ones(m) if cw is None
                  else np.asarray(cw, dtype=np.float64))
            if len(cy) != m or len(cw) != m:
                raise ValueError(
                    f"chunk {ci}: y/w lengths ({len(cy)}/{len(cw)}) != "
                    f"x rows ({m})")
            lo = 0
            while lo < m:
                take = min(m - lo, shard_rows - carry_rows)
                carry.append((cx[lo:lo + take], cy[lo:lo + take],
                              cw[lo:lo + take]))
                carry_rows += take
                lo += take
                if carry_rows >= shard_rows:
                    flush(carry, carry_rows)
                    carry, carry_rows = [], 0
        if carry_rows:
            flush(carry, carry_rows)
        if not shards:
            raise ValueError("empty chunk stream: nothing to shard")

        pad_rows = _pad_geometry(ctx, max(s.rows for s in shards))
        sds = cls(ctx, shards, n_features, pad_rows, moments.close(),
                  spill_dir, owns_dir, x_dtype=xdt, y_dtype=ydt,
                  x_scale=x_scale)
        if fp8_candidate:
            _finalize_fp8(sds)
        return sds

    @classmethod
    def from_dataset(cls, ds, shard_rows: Optional[int] = None,
                     spill_dir: Optional[str] = None) -> "StreamingDataset":
        """Spill an in-core ``InstanceDataset`` into a shard set (the
        budget guard's degradation path and ``cyclone.oocore.mode=force``).
        Rows are pulled from the device in per-shard slices, O(shard) host
        memory, padding rows dropped by the dataset's own mask.

        An fp8 dataset spills its 1-byte codes with the per-column scale
        (the in-core envelope probe already admitted it to the fp8 rung);
        only a ``streamDtype=bfloat16`` pin widens the codes first, and
        that is recorded (``fp8_fallback``)."""
        from cycloneml_tpu_torch.conf import OOCORE_SHARD_ROWS
        conf = getattr(ds.ctx, "conf", None)
        x_scale = ds.x_scale
        if x_scale is not None and _stream_intent(conf) == "bfloat16":
            from cycloneml_tpu_torch.dataset.dataset import fp8_fallback
            ds = fp8_fallback(
                ds, "StreamingDataset.from_dataset",
                "cyclone.oocore.streamDtype=bfloat16 pins the stream to "
                "the bf16 rung")
            x_scale = None
        if shard_rows is None:
            shard_rows = int(conf.get(OOCORE_SHARD_ROWS)) \
                if conf is not None else 65536
        shard_rows = max(int(shard_rows), 1)
        n_pad = int(ds.x.shape[0])
        mask = ds._valid_mask
        y_host = ds.y_host()
        w_host = ds.w_host()

        def chunks():
            for lo in range(0, n_pad, shard_rows):
                hi = min(lo + shard_rows, n_pad)
                if mask is not None:
                    keep = mask[lo:hi]
                else:
                    keep = np.zeros(hi - lo, dtype=bool)
                    keep[:max(0, min(ds.n_rows, hi) - lo)] = True
                if not keep.any():
                    continue
                xs = ds.x[lo:hi]
                ys = np.asarray(y_host[lo:hi], dtype=np.float64)
                ws = np.asarray(w_host[lo:hi], dtype=np.float64)
                if not keep.all():
                    idx = np.flatnonzero(keep)
                    xs = xs[torch.as_tensor(idx, device=xs.device)]
                    ys, ws = ys[idx], ws[idx]
                yield xs, ys, ws

        return cls.from_chunks(ds.ctx, chunks(), ds.n_features,
                               shard_rows=shard_rows, spill_dir=spill_dir,
                               x_scale=x_scale)

    # -- the InstanceDataset-shaped surface --------------------------------
    @property
    def shape(self):
        return (self.n_rows, self.n_features)

    @property
    def n_shards(self) -> int:
        return len(self._shards)

    def to_instance_dataset(self, features_col=None, label_col=None,
                            weight_col=None, dtype=None,
                            fp8_capable: bool = False) -> "StreamingDataset":
        """Already placed (on disk): column and dtype arguments do not
        apply. An fp8 shard set handed to a consumer that is not
        fp8-capable re-spills at the bf16 rung (recorded in
        ``ctx.precision_fallbacks``): raw codes are never read as
        values."""
        if self.x_scale is not None and not fp8_capable:
            _precision_fallback_event(
                self.ctx, "StreamingDataset.to_instance_dataset",
                "the consumer is not fp8-capable: e4m3 codes would be "
                "read as values", "float8_e4m3fn", "bfloat16")
            scale = torch.as_tensor(self.x_scale)

            def chunks():
                for i in range(self.n_shards):
                    x, y, w = self.load_shard(i)
                    yield x.to(torch.float64) * scale, y, w

            return StreamingDataset.from_chunks(
                self.ctx, chunks(), self.n_features,
                shard_rows=max(s.rows for s in self._shards),
                stream_dtype="bfloat16")
        return self

    # -- one-pass statistics -----------------------------------------------
    @property
    def weight_sum(self) -> float:
        return self._moments.w

    def summary(self):
        """The Summarizer's ``SummaryStats`` from the write pass's moments:
        the streamed fit never pays a statistics epoch."""
        from cycloneml_tpu_torch.ml.stat.summarizer import SummaryStats
        m = self._moments.sums
        w, w2 = float(m["w"]), float(m["w2"])
        mean = m["s1"] / w if w > 0 else np.zeros(self.n_features)
        denom = w - w2 / w if w > 0 else 0.0
        if denom > 0:
            variance = np.maximum((m["s2"] - w * mean * mean) / denom, 0.0)
        else:
            variance = np.zeros_like(mean)
        return SummaryStats(
            mean=mean, variance=variance, count=int(round(float(m["cnt"]))),
            num_nonzeros=m["nnz"].copy(), max=m["mx"].copy(),
            min=m["mn"].copy(), norm_l1=m["l1"].copy(),
            norm_l2=np.sqrt(np.maximum(m["s2"], 0.0)), sum=m["s1"].copy(),
            weight_sum=w)

    def label_histogram(self) -> np.ndarray:
        """Weighted class histogram (float64) when labels are class
        indices; raises for other labels (regression data)."""
        if not self._moments.integral_labels:
            raise ValueError(
                "labels are not class indices; streamed classification "
                "requires integral labels in [0, 4096)")
        return self._moments.histogram.copy()

    @property
    def num_classes(self) -> int:
        return max(len(self._moments.histogram), 2) \
            if self._moments.integral_labels else 0

    def y_moments(self):
        """``(sum w y, sum w y^2, sum w^2)``: what LinearRegression's label
        pass computes in core."""
        m = self._moments
        return m.s1y, m.s2y, float(m.sums["w2"])

    # -- shard access (the stream's supplier) ------------------------------
    def _layout(self, i: int):
        """(rows, X bytes, y/w bytes each) of shard ``i``'s file."""
        rows = self._shards[i].rows
        xb = rows * self.n_features * self.x_dtype.itemsize
        return rows, xb, rows * self.y_dtype.itemsize

    def load_shard(self, i: int):
        """Shard ``i`` on the host, unpadded: ``(x, y, w)``, x a CPU tensor
        in the stream dtype (e4m3 codes for an fp8 set), y and w float64
        numpy."""
        rows, xb, yb = self._layout(i)
        raw = np.fromfile(self._shards[i].path, dtype=np.uint8)
        x = torch.from_numpy(raw[:xb].copy()).view(self.x_dtype).reshape(
            rows, self.n_features)
        np_ydt = np.float64 if self.y_dtype == torch.float64 \
            else np.float32
        y = raw[xb:xb + yb].view(np_ydt).astype(np.float64)
        w = raw[xb + yb:xb + 2 * yb].view(np_ydt).astype(np.float64)
        return x, y, w

    def shard_weights(self, i: int) -> np.ndarray:
        """Shard ``i``'s weights alone (float64), X's bytes left unread."""
        rows, xb, yb = self._layout(i)
        np_ydt = np.float64 if self.y_dtype == torch.float64 \
            else np.float32
        return np.fromfile(self._shards[i].path, dtype=np_ydt, count=rows,
                           offset=xb + yb).astype(np.float64)

    def read_into(self, i: int, x_out: torch.Tensor, y_out: torch.Tensor,
                  w_out: torch.Tensor, pool=None) -> int:
        """Read shard ``i``'s bytes straight into host tensors of the
        stream's dtypes (``(pad_rows, d)`` and ``(pad_rows,)``: a pinned
        slot) and zero the rows past its own, so that a slot a longer
        shard filled holds no stale rows. ``pool`` (an executor) reads X
        in pieces side by side. Returns the shard's rows."""
        rows, xb, yb = self._layout(i)
        x_bytes = _bytes_of(x_out)
        with open(self._shards[i].path, "rb") as fh:
            fd = fh.fileno()
            _pread_all(fd, x_bytes[:xb], 0, pool)
            _pread_all(fd, _bytes_of(y_out)[:yb], xb, None)
            _pread_all(fd, _bytes_of(w_out)[:yb], xb + yb, None)
        if rows < x_out.shape[0]:
            x_out[rows:].zero_()
            y_out[rows:].zero_()
            w_out[rows:].zero_()
        return rows

    def shard_nbytes(self, i: int) -> int:
        try:
            return os.path.getsize(self._shards[i].path)
        except OSError:
            return 0

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        # the latch is taken under the lock: an explicit close races
        # __del__, and two closers past the check would unlink twice
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        for s in self._shards:
            try:
                os.unlink(s.path)
            except OSError:
                pass
        if self._owns_dir:
            try:
                os.rmdir(self._dir)
            except OSError:
                pass

    def __del__(self):  # a dropped shard set must not leak its files
        try:
            self.close()
        except Exception:
            pass


_READ_PIECE = 16 << 20   # bytes of X one reader thread reads at a time


def _pread_all(fd: int, dst: np.ndarray, offset: int, pool) -> None:
    """Fill ``dst`` (a uint8 view) from ``fd`` at ``offset``; in pieces on
    ``pool``'s threads when given (``os.preadv`` releases the GIL, so the
    page-cache copies run side by side)."""
    n = dst.shape[0]

    def piece(lo):
        hi = min(lo + _READ_PIECE, n)
        view = memoryview(dst[lo:hi])
        done = 0
        while done < hi - lo:
            got = os.preadv(fd, [view[done:]], offset + lo + done)
            if got <= 0:
                raise IOError(f"short read of a shard file at byte "
                              f"{offset + lo + done}")
            done += got

    if pool is None or n <= _READ_PIECE:
        for lo in range(0, n, _READ_PIECE):
            piece(lo)
        return
    for f in [pool.submit(piece, lo) for lo in range(0, n, _READ_PIECE)]:
        f.result()


def _write_shard(path: str, x: torch.Tensor, y: np.ndarray,
                 w: np.ndarray) -> None:
    """One shard file: X's bytes, then y's, then w's."""
    with open(path, "wb") as fh:
        fh.write(memoryview(_bytes_of(x)))
        fh.write(memoryview(np.ascontiguousarray(y)).cast("B"))
        fh.write(memoryview(np.ascontiguousarray(w)).cast("B"))


def _pad_geometry(ctx, max_shard_rows: int) -> int:
    """Padded rows per staged shard: the largest shard rounded up to a
    multiple of 8 x the mesh's data parallelism."""
    unit = 8 * int(ctx.mesh_runtime.data_parallelism)
    return ((max(int(max_shard_rows), 1) + unit - 1) // unit) * unit


def _stream_intent(conf, override: Optional[str] = None) -> str:
    """The configured stream rung: 'auto', 'bfloat16' or 'float8'."""
    if override is not None:
        return str(override)
    if conf is None:
        return "auto"
    from cycloneml_tpu_torch.conf import OOCORE_STREAM_DTYPE
    return str(conf.get(OOCORE_STREAM_DTYPE))


def _resolve_stream_dtype(conf, override: Optional[str] = None):
    """``cyclone.oocore.streamDtype`` for a fresh spill as ``(write_dtype,
    fp8_candidate)``: what the WRITE pass stores, one rung wider than fp8
    when fp8 is the candidate (float64 on the parity tier, else bf16),
    because the set-level scale exists only once every row has passed
    through the moments. 'auto' follows ``cyclone.data.dtype``, fp8 tiers
    included (the stream is an fp8-capable consumer)."""
    from cycloneml_tpu_torch.dataset.instance import (compute_dtype,
                                                      data_dtype,
                                                      is_fp8_dtype)
    intent = _stream_intent(conf, override)
    if intent == "bfloat16":
        return torch.bfloat16, False
    if intent != "float8" and \
            not is_fp8_dtype(data_dtype(conf, fp8_capable=True)):
        return data_dtype(conf), False
    if compute_dtype(conf) == torch.float64:
        return torch.float64, True
    return torch.bfloat16, True


def _finalize_fp8(sds: StreamingDataset) -> None:
    """The envelope probe and the set-level requantization.

    Decides fp8 or the write rung for the shard SET: ONE per-column scale
    (``absmax / FP8_MAX`` over every stored value) serves every shard, the
    in-core fp8 dataset's arrangement. The probe (``instance.
    fp8_probe_ok``: the scale spread, the weight overflow) runs on the
    write pass's moments; a refusal keeps the write rung and is recorded.
    On success each shard is rewritten in place, one shard at a time, its
    codes made on the context's device by ``quantize_fp8``, and the
    moments are taken again from the dequantized values, the ones the fit
    reads."""
    from cycloneml_tpu_torch.dataset.instance import (FP8_MAX, fp8_probe_ok,
                                                      quantize_fp8)
    m = sds._moments
    absmax = np.maximum(np.abs(m.sums["mx"]), np.abs(m.sums["mn"]))
    absmax = np.where(np.isfinite(absmax), absmax, 0.0)
    stats = sds.summary()
    std = np.sqrt(np.asarray(stats.variance, dtype=np.float64))
    probe_ratio = np.where(std > 0, absmax / np.where(std > 0, std, 1.0),
                           0.0)
    reason = fp8_probe_ok(stats, w_max=m.w_max or None,
                          probe_ratio=probe_ratio)
    if reason is not None:
        _precision_fallback_event(sds.ctx, "StreamingDataset", reason,
                                  "float8_e4m3fn",
                                  str(sds.x_dtype).replace("torch.", ""))
        return
    scale = np.where(m.abs_all > 0, m.abs_all / FP8_MAX, 1.0)
    device = sds.ctx.mesh_runtime.device
    s_dev = torch.as_tensor(scale, device=device)
    requant = _Moments(sds.n_features, device)
    np_ydt = np.float64 if sds.y_dtype == torch.float64 else np.float32
    for i, s in enumerate(sds._shards):
        x, y, w = sds.load_shard(i)
        x8, _, _ = quantize_fp8(x.to(device), scale=scale)
        _write_shard(s.path, x8.cpu(), y.astype(np_ydt), w.astype(np_ydt))
        requant.update(x8.to(torch.float64) * s_dev, y, w)
    sds._moments = requant.close()
    sds.x_scale = scale
    sds.x_dtype = torch.float8_e4m3fn
    logger.info("oocore: shard set requantized to float8_e4m3fn (%d "
                "shards, one per-column scale)", sds.n_shards)


def _precision_fallback_event(ctx, estimator: str, reason: str,
                              from_dtype: str, to_dtype: str) -> None:
    """Record a streaming-tier precision decision as
    ``dataset.fp8_fallback`` does: a warning, and an entry in
    ``ctx.precision_fallbacks`` (the reference's ``PrecisionFallback``
    event; the listener bus is ROADMAP Queue 1 item 12)."""
    logger.warning("%s: falling back from %s to %s storage — %s",
                   estimator, from_dtype, to_dtype, reason)
    record = getattr(ctx, "precision_fallbacks", None)
    if record is not None:
        record.append({"estimator": estimator, "from_dtype": from_dtype,
                       "to_dtype": to_dtype, "reason": reason})
