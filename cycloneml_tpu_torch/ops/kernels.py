"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Every ``pl.pallas_call`` body of ``cycloneml_tpu/ops/kernels.py`` has a
counterpart here, each with a source note in its ``.cu`` file (what it
replaces, what bounds it on the card, what the design does about that):

- K1 and K2, the GLM row sweep (``csrc/glm_sweep.cu``): ``_run_glm`` with the
  logistic link (LogisticRegression) and the squared link
  (LinearRegression). One pass over X computing the loss, the gradient,
  sum(mult) and sum(w); bytes-bound.
- K1s, ``glm_sweep_stacked`` (``csrc/glm_stacked.cu``): K1's logistic sweep
  for K models over one X, the batched kernel ``jax.vmap`` makes of
  ``_run_glm`` in the reference's stacked fits (OneVsRest, CrossValidator,
  TrainValidationSplit): X is read once for all K models (at most
  :data:`K_MAX` a launch); bytes-bound for few models, bound by operations
  for many.
- K3, ``kmeans_assign`` (``csrc/kmeans_assign.cu``): ``fused_kmeans_assign``,
  the nearest center and its squared distance per row (KMeans);
  bound by operations.
- K4, ``gramian`` (``csrc/gramian.cu``): ``fused_gramian``, the presence-
  masked X^T X (RowMatrix, PCA); bound by operations.

Beside them, ``center_sums`` (``csrc/center_sums.cu``) sums KMeans' centers
in a fixed order (the reference's ``jax.ops.segment_sum``, not a Pallas
kernel), so that two fits of the same data end with the same centers.

X comes in at its storage width: float32, bfloat16 or float8_e4m3fn codes
(the fp8 rung). K1/K2 upcast it to float32 inside the kernel. K3 and K4 pick
an instance by X's dtype (:data:`INSTANCE`): bf16 X and e4m3 codes go to the
tensor cores (wgmma, bf16 products summed in float32; K3 against the
centers split in three bf16 parts, :func:`split_centers`), float32 X to
float32 FMAs. Every wrapper takes the fp8 rung's optional per-column
dequantization vector ``x_scale`` (the reference's ``x_scale`` operand): the
value of X is ``x * x_scale``. K1/K2 fold it into their (d,) vectors; K3
into the centers on the tensor cores (and applies it as X is staged on the
FMAs), K4 in its double reduction pass.

Each wrapper launches its kernel for a CUDA tensor and runs its ``*_plain``
version only for a tensor that lies on the CPU. There is no fallback from
one to the other: a CUDA tensor the kernel cannot take raises. Each wrapper
counts its launches in ``<wrapper>.launches`` (``glm_sweep`` also by link,
in ``glm_sweep.launches_by_link``, and by X's dtype, in
``glm_sweep.launches_by_dtype``; K1s by X's dtype in
``glm_sweep_stacked.launches_by_dtype``, one launch per group of at most
:data:`K_MAX` models; K3 and K4 also by instance, in
``kmeans_assign.launches_by_instance`` and ``gramian.launches_by_instance``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

ROW_CHUNK = 1 << 16  # rows upcast at a time by the plain versions
GRAM_CHUNK = 1 << 13  # rows per product in the plain Gramian

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
TENSOR_CORE, FMA = "tensor_core", "fma"
# the instance of K3 and K4 that each dtype of X launches (the C entry
# points pick by the same dtype code)
INSTANCE = {torch.float32: FMA, torch.bfloat16: TENSOR_CORE,
            torch.float8_e4m3fn: TENSOR_CORE}


def use_fused_kernels(ctx, x: Optional[torch.Tensor] = None) -> bool:
    """Whether the eligible dense sweeps go through the hand-written
    kernels: ``cyclone.ml.usePallasKernels`` 'true'/'false' force one path
    (the key keeps the reference's name, so configurations carry over);
    'auto' (default) says yes when the data ``x`` lives on CUDA in a dtype
    the kernels read (float32, bfloat16 or float8_e4m3fn codes)."""
    from cycloneml_tpu_torch.conf import USE_PALLAS_KERNELS
    conf = getattr(ctx, "conf", None)
    mode = str(conf.get(USE_PALLAS_KERNELS)).lower() if conf is not None \
        else "auto"
    if mode == "true":
        return True
    if mode == "false":
        return False
    return (x is not None and x.device.type == "cuda"
            and x.dtype in _DTYPE_CODE)


# -- K1: the GLM row sweep ----------------------------------------------------

def _softplus(m: torch.Tensor) -> torch.Tensor:
    # exact at every magnitude (torch's softplus goes linear past 20)
    return m.clamp(min=0) + torch.log1p(torch.exp(-m.abs()))


LOGISTIC, SQUARED = "logistic", "squared"
_LINK_CODE = {LOGISTIC: 0, SQUARED: 1}


def _scale_operand(x_scale, d: int, device, dtype=torch.float32
                   ) -> Optional[torch.Tensor]:
    """The per-column dequantization vector as a contiguous ``(d,)``
    tensor (the reference's ``_pad_scale``; the port pads no columns), or
    None."""
    if x_scale is None:
        return None
    s = torch.as_tensor(x_scale).to(device=device, dtype=dtype).reshape(-1)
    if s.shape[0] != d:
        raise ValueError(f"x_scale has {s.shape[0]} entries, expected {d}")
    return s.contiguous()


def split_centers(c: torch.Tensor) -> torch.Tensor:
    """The float32 centers ``c`` ``(k, d)`` split exactly into three
    bf16 parts, ``(3, k, d)``: hi = bf16(c), mid = bf16(c - hi), lo =
    bf16(c - hi - mid), so that hi + mid + lo == c (three 8-bit
    significands cover float32's 24; each difference is exact in float32).
    Exact for every float32 value that is 0 or of magnitude at least
    2^-110 and below bf16's overflow (the last part must stay a normal
    bf16). K3's tensor-core instance sums x.lo, x.mid and x.hi, each
    product exact for bf16 x, into one float32 accumulator."""
    c = c.to(torch.float32)
    hi = c.to(torch.bfloat16)
    r1 = c - hi.to(torch.float32)
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.to(torch.float32)).to(torch.bfloat16)
    return torch.stack([hi, mid, lo])


def _upcast(x: torch.Tensor, lo: int, rows: int, acc_dtype,
            s: Optional[torch.Tensor]) -> torch.Tensor:
    """Rows ``lo:lo+rows`` of X at ``acc_dtype``, times the scale."""
    xc = x[lo:lo + rows].to(acc_dtype)
    return xc if s is None else xc * s


def glm_sweep_plain(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                    beta: torch.Tensor, off, acc_dtype=torch.float32,
                    chunk_rows: int = ROW_CHUNK, link: str = LOGISTIC,
                    ys=0.0, x_scale=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """The sweep in plain PyTorch, accumulated in ``acc_dtype``:
    returns ``(loss, grad_row (d,), sum(mult), sum(w))``. The logistic
    link takes mult = w(sigmoid(m) - y), loss = w(softplus(m) - y m); the
    squared link err = m - ys y, mult = w err, loss = w err^2 / 2, where
    m = x.beta + off. X is upcast ``chunk_rows`` rows at a time (and
    multiplied by ``x_scale`` when given), so no full-width copy of X is
    held. With ``acc_dtype=torch.float64`` it is the truth the kernel is
    held against on the card."""
    if link not in _LINK_CODE:
        raise ValueError(f"glm_sweep: unknown link {link!r}")
    n, d = x.shape
    dev = x.device
    s = _scale_operand(x_scale, d, dev, acc_dtype)
    beta_a = beta.to(acc_dtype)
    off_a = torch.as_tensor(off, dtype=acc_dtype, device=dev)
    ys_a = torch.as_tensor(ys, dtype=acc_dtype, device=dev)
    loss = torch.zeros((), dtype=acc_dtype, device=dev)
    grad = torch.zeros(d, dtype=acc_dtype, device=dev)
    msum = torch.zeros((), dtype=acc_dtype, device=dev)
    wsum = torch.zeros((), dtype=acc_dtype, device=dev)
    for lo in range(0, n, chunk_rows):
        xc = _upcast(x, lo, chunk_rows, acc_dtype, s)
        yc = y[lo:lo + chunk_rows].to(acc_dtype)
        wc = w[lo:lo + chunk_rows].to(acc_dtype)
        m = xc @ beta_a + off_a
        if link == LOGISTIC:
            mult = wc * (torch.sigmoid(m) - yc)
            loss += torch.sum(wc * (_softplus(m) - yc * m))
        else:
            err = m - ys_a * yc
            mult = wc * err
            loss += 0.5 * torch.sum(wc * err * err)
        grad += mult @ xc
        msum += torch.sum(mult)
        wsum += torch.sum(wc)
    return loss, grad, msum, wsum


# pointers and the stream go as c_void_p: an untyped int would be cut to
# 32 bits
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PI = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "glm_sweep": {
        "glm_sweep_max_d": [],
        "glm_sweep_num_parts": [_I, _I, _I, _LL, _PI],
        "glm_sweep_launch": [_I, _I, _P, _P, _P, _P, _P, _LL, _I, _P, _I,
                             _P, _P],
    },
    "kmeans_assign": {
        "kmeans_assign_launch": [_I, _P, _P, _P, _P, _LL, _I, _I, _P, _P,
                                 _P],
    },
    "gramian": {
        "gramian_plan": [_I, _LL, _PI, _PI],
        "gramian_launch": [_I, _P, _P, _P, _LL, _I, _I, _I, _P, _P, _P],
    },
    "glm_stacked": {
        "glm_stacked_max_d": [],
        "glm_stacked_max_models": [],
        "glm_stacked_num_parts": [_I, _I, _I, _LL, _PI],
        "glm_stacked_launch": [_I, _P, _P, _I, _LL, _P, _P, _P, _LL, _I, _I,
                               _P, _I, _P, _P],
    },
    "center_sums": {
        "center_sums_piece_rows": [],
        "center_sums_launch": [_I, _I, _P, _P, _P, _P, _P, _I, _LL, _I, _LL,
                               _P, _P, _P, _P],
    },
}


def _library(name: str = "glm_sweep") -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` with every entry point's
    argument types declared (each returns a cudaError_t as int)."""
    from cycloneml_tpu_torch.ops import build
    lib = build.load(name)
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = _I
    return lib


def _cuda_check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed with CUDA error {rc}")


def _check_x(x: torch.Tensor, what: str) -> None:
    """A CUDA X the kernels take: 2-D, float32, bfloat16 or float8_e4m3fn,
    contiguous."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    if x.dim() != 2 or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{what}: X must be 2-D float32, bfloat16 or "
                         f"float8_e4m3fn on CUDA; got {tuple(x.shape)} "
                         f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: X must be contiguous (a copy of X "
                         "would double the pass's memory)")


def glm_sweep(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
              beta: torch.Tensor, off, link: str = LOGISTIC, ys=0.0,
              x_scale=None) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor]:
    """K1 (``link="logistic"``) and K2 (``link="squared"``, label scale
    ``ys``): ``(loss, grad_row (d,), sum(mult), sum(w))`` in float32 for X
    ``(n, d)`` at storage width, y, w ``(n,)``, beta ``(d,)`` and the
    margin offset ``off`` (a scalar or 0-d tensor); the value of X is
    ``x * x_scale`` when the scale is given. A CPU tensor runs
    :func:`glm_sweep_plain`; a CUDA tensor launches the kernel or
    raises.

    The scale is folded into the (d,) vectors, as the reference's fits
    fold it into ``inv_std``: the kernel sweeps the raw codes with
    ``beta o x_scale`` and the gradient row comes back times ``x_scale``.
    """
    if link not in _LINK_CODE:
        raise ValueError(f"glm_sweep: unknown link {link!r}")
    if x.device.type == "cpu":
        return glm_sweep_plain(x, y, w, beta, off, link=link, ys=ys,
                               x_scale=x_scale)
    _check_x(x, "glm_sweep")
    n, d = x.shape
    lib = _library("glm_sweep")
    if d > lib.glm_sweep_max_d():
        raise ValueError(f"glm_sweep: d={d} exceeds the kernel's limit of "
                         f"{lib.glm_sweep_max_d()} features")
    dev = x.device
    # (n,) vectors and (d,) coefficients in the kernel's f32; a no-op on
    # the f32 accumulator tier the card runs
    y = y.to(device=dev, dtype=torch.float32).contiguous()
    w = w.to(device=dev, dtype=torch.float32).contiguous()
    beta = beta.to(device=dev, dtype=torch.float32)
    s = _scale_operand(x_scale, d, dev)
    if s is not None:
        beta = beta * s
    beta = beta.contiguous()
    if y.shape != (n,) or w.shape != (n,) or beta.shape != (d,):
        raise ValueError("glm_sweep: shapes do not match X "
                         f"{(n, d)}: y {tuple(y.shape)}, w {tuple(w.shape)}, "
                         f"beta {tuple(beta.shape)}")
    # [off, ys] stay on the device: reading off back would sync per sweep
    scalars = torch.zeros(2, dtype=torch.float32, device=dev)
    scalars[0] = torch.as_tensor(off, device=dev)
    scalars[1] = torch.as_tensor(ys, device=dev)
    code, lcode = _DTYPE_CODE[x.dtype], _LINK_CODE[link]
    with torch.cuda.device(dev):
        parts = ctypes.c_int(0)
        _cuda_check(lib.glm_sweep_num_parts(code, lcode, d, n,
                                            ctypes.byref(parts)),
                    "glm_sweep_num_parts")
        partials = torch.empty(parts.value * (d + 3), dtype=torch.float64,
                               device=dev)
        out = torch.empty(d + 3, dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _cuda_check(lib.glm_sweep_launch(
            code, lcode, x.data_ptr(), y.data_ptr(), w.data_ptr(),
            beta.data_ptr(), scalars.data_ptr(), n, d, partials.data_ptr(),
            parts.value, out.data_ptr(), stream), "glm_sweep launch")
    glm_sweep.launches += 1
    glm_sweep.launches_by_link[link] += 1
    glm_sweep.launches_by_dtype[x.dtype] += 1
    grad_row = out[:d] if s is None else out[:d] * s
    return out[d], grad_row, out[d + 1], out[d + 2]


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    glm_sweep.launches = 0
    glm_sweep.launches_by_link = {LOGISTIC: 0, SQUARED: 0}
    glm_sweep.launches_by_dtype = {dt: 0 for dt in _DTYPE_CODE}
    kmeans_assign.launches = 0
    kmeans_assign.launches_by_instance = {TENSOR_CORE: 0, FMA: 0}
    gramian.launches = 0
    gramian.launches_by_instance = {TENSOR_CORE: 0, FMA: 0}
    glm_sweep_stacked.launches = 0
    glm_sweep_stacked.launches_by_dtype = {dt: 0 for dt in _DTYPE_CODE}
    center_sums.launches = 0


def fused_binary_logistic_scaled(x, y, w, inv_std, scaled_mean, coef,
                                 d: int, fit_intercept: bool = True,
                                 x_scale=None) -> Dict[str, torch.Tensor]:
    """K1 with standardization folded around the row pass (the
    counterpart of the reference's ``fused_binary_logistic_scaled``):

      margin = x.(inv_std o beta) + (b0 - scaled_mean.beta)
      grad_beta = inv_std o grad_row - scaled_mean * sum(mult)

    so X is read raw. The fold runs in float32, as the reference's does.
    ``x_scale`` is the fp8 rung's per-column scale (see :func:`glm_sweep`).
    Returns ``{"loss", "grad", "count"}`` (float32 sums)."""
    f32 = torch.float32
    coef = coef.to(f32)
    inv_std = inv_std.to(f32)
    scaled_mean = scaled_mean.to(f32)
    beta = coef[:d]
    b0 = coef[d] if fit_intercept else torch.zeros((), dtype=f32,
                                                    device=coef.device)
    sb = inv_std * beta
    off = b0 - torch.dot(scaled_mean, beta)
    loss, grad_row, msum, wsum = glm_sweep(x, y, w, sb, off,
                                           x_scale=x_scale)
    g = inv_std * grad_row - scaled_mean * msum
    grad = torch.cat([g, msum.reshape(1)]) if fit_intercept else g
    return {"loss": loss, "grad": grad, "count": wsum}


def fused_binary_logistic(x, y, w, coef, d: int, fit_intercept: bool = True,
                          x_scale=None) -> Dict[str, torch.Tensor]:
    """The unscaled twin of :func:`fused_binary_logistic_scaled`
    (inv_std = 1, scaled_mean = 0)."""
    ones = torch.ones(d, dtype=torch.float32, device=coef.device)
    return fused_binary_logistic_scaled(x, y, w, ones, torch.zeros_like(ones),
                                        coef, d, fit_intercept, x_scale)


def fused_least_squares_scaled(x, y, w, inv_std, scaled_mean, y_pars, coef,
                               d: int, x_scale=None
                               ) -> Dict[str, torch.Tensor]:
    """K2 with the doubly-standardized least-squares objective folded
    around the row pass (the counterpart of the reference's
    ``fused_least_squares_scaled``), ``y_pars = [1/sigma_y, y_mean_hat]``:

      margin = x.(inv_std o coef) + (y_mean_hat - scaled_mean.coef)
      err = margin - y / sigma_y
      grad = inv_std o grad_row - scaled_mean * sum(mult)

    X is read raw; there is no intercept coordinate. The fold runs in
    float32, as the reference's does; ``x_scale`` as in :func:`glm_sweep`.
    Returns ``{"loss", "grad", "count"}`` (float32 sums)."""
    f32 = torch.float32
    coef = coef.to(f32)
    inv_std = inv_std.to(f32)
    scaled_mean = scaled_mean.to(f32)
    y_pars = torch.as_tensor(y_pars, device=coef.device).to(f32)
    sb = inv_std * coef
    off = y_pars[1] - torch.dot(scaled_mean, coef)
    loss, grad_row, msum, wsum = glm_sweep(x, y, w, sb, off, link=SQUARED,
                                           ys=y_pars[0], x_scale=x_scale)
    g = inv_std * grad_row - scaled_mean * msum
    return {"loss": loss, "grad": g, "count": wsum}


# -- K3: nearest-center assignment --------------------------------------------

def kmeans_assign_plain(x: torch.Tensor, centers: torch.Tensor,
                        acc_dtype=torch.float32,
                        chunk_rows: int = ROW_CHUNK, x_scale=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The assignment in plain PyTorch at ``acc_dtype``: ``(best int64
    (n,), min_d2 (n,))`` with d2 = (|x|^2 - 2 x.c) + |c|^2, the first
    least index, and the minimum clamped at 0. X is upcast ``chunk_rows``
    rows at a time (and multiplied by ``x_scale`` when given; centers are
    in value space), so neither a full-width copy of X nor an (n, k)
    distance matrix is held."""
    n, d = x.shape
    s = _scale_operand(x_scale, d, x.device, acc_dtype)
    c = centers.to(acc_dtype)
    c_norm = torch.sum(c * c, dim=1)
    best = torch.empty(n, dtype=torch.int64, device=x.device)
    dist = torch.empty(n, dtype=acc_dtype, device=x.device)
    for lo in range(0, n, chunk_rows):
        xc = _upcast(x, lo, chunk_rows, acc_dtype, s)
        x2 = torch.sum(xc * xc, dim=1)
        d2 = (x2[:, None] - 2.0 * (xc @ c.T)) + c_norm[None, :]
        mn, idx = torch.min(d2, dim=1)  # the first index of the minimum
        best[lo:lo + chunk_rows] = idx
        dist[lo:lo + chunk_rows] = torch.clamp(mn, min=0.0)
    return best, dist


def kmeans_assign(x: torch.Tensor, centers: torch.Tensor, x_scale=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 wrapper (the counterpart of the reference's
    ``fused_kmeans_assign``): ``(best (n,), min_d2 float32 (n,))`` for X
    ``(n, d)`` at storage width, whose value is ``x * x_scale`` when the
    scale is given, and centers ``(k, d)`` in value space, taken in
    float32. A CPU tensor runs :func:`kmeans_assign_plain` in float32; a
    CUDA tensor launches the kernel (int32 ``best``) or raises.

    bf16 X and e4m3 codes launch the tensor-core instance: the scale is
    folded into the centers (x~ . c = x . (s o c)), which are then split
    by :func:`split_centers` and padded with zeros to k and d multiples of
    128 and 64 (|c|^2 of the padding centers is +inf); a row whose two
    least distances lie within the products' rounding bound is then
    re-decided in the FMA instance's arithmetic, so every pick is the one
    the FMA instance makes. float32 X launches the FMA instance on the
    centers as they are. ``c_norm`` = |c|^2 stays in value space either
    way."""
    if x.device.type == "cpu":
        return kmeans_assign_plain(x, centers, x_scale=x_scale)
    _check_x(x, "kmeans_assign")
    n, d = x.shape
    dev = x.device
    c = centers.to(device=dev, dtype=torch.float32).contiguous()
    if c.dim() != 2 or c.shape[1] != d or c.shape[0] < 1:
        raise ValueError(f"kmeans_assign: centers {tuple(c.shape)} do not "
                         f"match X {(n, d)}")
    k = c.shape[0]
    s = _scale_operand(x_scale, d, dev)
    c_norm = torch.sum(c * c, dim=1).contiguous()
    instance = INSTANCE[x.dtype]
    if instance == TENSOR_CORE:
        # the three parts, zero-padded, then the float32 centers (value
        # space, transposed to (d, k)) for the rows re-decided in the FMA
        # instance's arithmetic
        k_pad, d_pad = -(-k // 128) * 128, -(-d // 64) * 64
        operand = torch.zeros(3 * k_pad * d_pad + 2 * k * d,
                              dtype=torch.bfloat16, device=dev)
        parts = operand[:3 * k_pad * d_pad].view(3, k_pad, d_pad)
        parts[:, :k, :d] = split_centers(c if s is None else c * s)
        operand[3 * k_pad * d_pad:].view(torch.float32).view(d, k).copy_(
            c.T)
        # the padding centers' |c|^2 is +inf: they never win the argmin
        c_norm = torch.cat([c_norm, torch.full((k_pad - k,), float("inf"),
                                               device=dev)])
    else:
        operand = c
    best = torch.empty(n, dtype=torch.int32, device=dev)
    dist = torch.empty(n, dtype=torch.float32, device=dev)
    lib = _library("kmeans_assign")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _cuda_check(lib.kmeans_assign_launch(
            _DTYPE_CODE[x.dtype], x.data_ptr(), operand.data_ptr(),
            c_norm.data_ptr(), s.data_ptr() if s is not None else None, n,
            d, k, best.data_ptr(), dist.data_ptr(), stream),
            "kmeans_assign launch")
    kmeans_assign.launches += 1
    kmeans_assign.launches_by_instance[instance] += 1
    return best, dist


# -- K4: the Gramian ----------------------------------------------------------

def gramian_plain(x: torch.Tensor, w: Optional[torch.Tensor] = None,
                  acc_dtype=torch.float32,
                  chunk_rows: int = GRAM_CHUNK, x_scale=None) -> torch.Tensor:
    """X^T X over the rows with w > 0 (all rows when ``w`` is None), in
    plain PyTorch at ``acc_dtype``, exactly symmetric; X is upcast
    ``chunk_rows`` rows at a time (and multiplied by ``x_scale`` when
    given; chunk products summed in order), so no full-width copy of X or
    masked copy is held. The chunks are short because a float32 product
    sums each chunk's rows in one accumulator, and long sums of squares
    drift (see ``csrc/gramian.cu``)."""
    n, d = x.shape
    s = _scale_operand(x_scale, d, x.device, acc_dtype)
    g = torch.zeros((d, d), dtype=acc_dtype, device=x.device)
    for lo in range(0, n, chunk_rows):
        xc = _upcast(x, lo, chunk_rows, acc_dtype, s)
        if w is not None:
            xm = xc * (w[lo:lo + chunk_rows] > 0)[:, None].to(acc_dtype)
        else:
            xm = xc
        g += xm.T @ xc
    # mirror the upper triangle, so that G == G^T exactly, as the kernel's
    return torch.triu(g) + torch.triu(g, 1).T


def gramian(x: torch.Tensor, w: Optional[torch.Tensor] = None,
            x_scale=None) -> torch.Tensor:
    """K4 wrapper (the counterpart of the reference's ``fused_gramian``):
    the ``(d, d)`` float32 X^T X over the rows with w > 0, for X ``(n, d)``
    at storage width, whose value is ``x * x_scale`` when the scale is
    given. A CPU tensor runs :func:`gramian_plain` in float32; a CUDA
    tensor launches the kernel (the tensor-core instance for bf16 X and
    e4m3 codes, the FMA instance for float32 X) or raises."""
    if x.device.type == "cpu":
        return gramian_plain(x, w, x_scale=x_scale)
    _check_x(x, "gramian")
    n, d = x.shape
    dev = x.device
    if w is not None:
        w = w.to(device=dev, dtype=torch.float32).contiguous()
        if w.shape != (n,):
            raise ValueError(f"gramian: w {tuple(w.shape)} does not match "
                             f"X {(n, d)}")
    s = _scale_operand(x_scale, d, dev)
    lib = _library("gramian")
    with torch.cuda.device(dev):
        tiles, splits = ctypes.c_int(0), ctypes.c_int(0)
        _cuda_check(lib.gramian_plan(d, n, ctypes.byref(tiles),
                                     ctypes.byref(splits)), "gramian_plan")
        # scratch: a (128, 128) double partial per CTA; the plan bounds the
        # CTAs, so its size does not grow with n
        partials = torch.empty(splits.value * tiles.value * 128 * 128,
                               dtype=torch.float64, device=dev)
        g = torch.empty((d, d), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _cuda_check(lib.gramian_launch(
            _DTYPE_CODE[x.dtype], x.data_ptr(),
            w.data_ptr() if w is not None else None,
            s.data_ptr() if s is not None else None, n, d, tiles.value,
            splits.value, partials.data_ptr(), g.data_ptr(), stream),
            "gramian launch")
    gramian.launches += 1
    gramian.launches_by_instance[INSTANCE[x.dtype]] += 1
    return g


# -- K1s: the logistic sweep for K models over one X --------------------------

K_MAX = 16  # models one K1s launch sweeps (csrc/glm_stacked.cu)


def glm_sweep_stacked_plain(x: torch.Tensor, Y: torch.Tensor,
                            w: torch.Tensor, B: torch.Tensor, off,
                            acc_dtype=torch.float32,
                            chunk_rows: int = ROW_CHUNK, x_scale=None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, torch.Tensor]:
    """K1's logistic sweep for K models over one X in plain PyTorch,
    accumulated in ``acc_dtype``: labels ``Y`` (n, K), coefficients ``B``
    (K, d) and margin offsets ``off`` (K,); returns ``(loss (K,), grad_row
    (K, d), sum(mult) (K,), sum(w))``. Model k's margins are x.B_k +
    off_k, its multipliers w (sigmoid(m) - y_k). X is upcast
    ``chunk_rows`` rows at a time (times ``x_scale`` when given); with
    ``acc_dtype=torch.float64`` it is the truth the kernel is held against
    on the card."""
    n, d = x.shape
    dev = x.device
    s = _scale_operand(x_scale, d, dev, acc_dtype)
    b = B.to(acc_dtype)
    k = b.shape[0]
    off_a = torch.as_tensor(off, device=dev).to(acc_dtype).reshape(k)
    loss = torch.zeros(k, dtype=acc_dtype, device=dev)
    grad = torch.zeros((k, d), dtype=acc_dtype, device=dev)
    msum = torch.zeros(k, dtype=acc_dtype, device=dev)
    wsum = torch.zeros((), dtype=acc_dtype, device=dev)
    for lo in range(0, n, chunk_rows):
        xc = _upcast(x, lo, chunk_rows, acc_dtype, s)
        yc = Y[lo:lo + chunk_rows].to(acc_dtype)
        wc = w[lo:lo + chunk_rows].to(acc_dtype)
        m = xc @ b.T + off_a
        mult = wc[:, None] * (torch.sigmoid(m) - yc)
        loss += torch.sum(wc[:, None] * (_softplus(m) - yc * m), dim=0)
        grad += mult.T @ xc
        msum += torch.sum(mult, dim=0)
        wsum += torch.sum(wc)
    return loss, grad, msum, wsum


def glm_sweep_stacked(x: torch.Tensor, Y: torch.Tensor, w: torch.Tensor,
                      B: torch.Tensor, off, x_scale=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """K1s wrapper: ``(loss (K,), grad_row (K, d), sum(mult) (K,),
    sum(w))`` in float32 for X ``(n, d)`` at storage width, labels ``Y``
    ``(n, K)`` (float32 or bfloat16; other dtypes are taken as float32),
    w ``(n,)``, coefficients ``B`` ``(K, d)`` and offsets ``off`` ``(K,)``;
    the value of X is ``x * x_scale`` when the scale is given. A CPU tensor
    runs :func:`glm_sweep_stacked_plain`; a CUDA tensor launches the kernel
    once per group of at most :data:`K_MAX` models, each launch reading X
    once, or raises. The scale is folded into B and into the gradient rows,
    as :func:`glm_sweep` folds it."""
    if x.device.type == "cpu":
        return glm_sweep_stacked_plain(x, Y, w, B, off, x_scale=x_scale)
    _check_x(x, "glm_sweep_stacked")
    n, d = x.shape
    lib = _library("glm_stacked")
    if d > lib.glm_stacked_max_d():
        raise ValueError(f"glm_sweep_stacked: d={d} exceeds the kernel's "
                         f"limit of {lib.glm_stacked_max_d()} features")
    dev = x.device
    if Y.dim() != 2 or Y.shape[0] != n or Y.device != dev:
        raise ValueError(f"glm_sweep_stacked: labels {tuple(Y.shape)} on "
                         f"{Y.device} do not match X {(n, d)} on {dev}")
    if Y.dtype not in (torch.float32, torch.bfloat16):
        Y = Y.to(torch.float32)
    if Y.stride(1) != 1:
        Y = Y.contiguous()
    k = Y.shape[1]
    w = w.to(device=dev, dtype=torch.float32).contiguous()
    B = B.to(device=dev, dtype=torch.float32)
    s = _scale_operand(x_scale, d, dev)
    if s is not None:
        B = B * s
    off = torch.as_tensor(off, device=dev).to(torch.float32).reshape(-1)
    if w.shape != (n,) or B.shape != (k, d) or off.shape != (k,):
        raise ValueError("glm_sweep_stacked: shapes do not match X "
                         f"{(n, d)} and {k} models: w {tuple(w.shape)}, "
                         f"B {tuple(B.shape)}, off {tuple(off.shape)}")
    code = _DTYPE_CODE[x.dtype]
    y_bf16 = int(Y.dtype == torch.bfloat16)
    kmax = lib.glm_stacked_max_models()
    loss = torch.empty(k, dtype=torch.float32, device=dev)
    grad = torch.empty((k, d), dtype=torch.float32, device=dev)
    msum = torch.empty(k, dtype=torch.float32, device=dev)
    wsum = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for k0 in range(0, k, kmax):
            kg = min(kmax, k - k0)
            parts = ctypes.c_int(0)
            _cuda_check(lib.glm_stacked_num_parts(code, d, kg, n,
                                                  ctypes.byref(parts)),
                        "glm_stacked_num_parts")
            width = kg * (d + 2) + 1
            # scratch: one double partial row per CTA, (SMs x CTAs per SM)
            # rows whatever n
            partials = torch.empty(parts.value * width, dtype=torch.float64,
                                   device=dev)
            out = torch.empty(width, dtype=torch.float32, device=dev)
            bg = B[k0:k0 + kg].contiguous()
            og = off[k0:k0 + kg].contiguous()
            _cuda_check(lib.glm_stacked_launch(
                code, x.data_ptr(), Y.data_ptr() + k0 * Y.element_size(),
                y_bf16, Y.stride(0), w.data_ptr(), bg.data_ptr(),
                og.data_ptr(), n, d, kg, partials.data_ptr(), parts.value,
                out.data_ptr(), stream), "glm_stacked launch")
            glm_sweep_stacked.launches += 1
            glm_sweep_stacked.launches_by_dtype[x.dtype] += 1
            body = out[:kg * (d + 2)].view(kg, d + 2)
            grad[k0:k0 + kg] = body[:, :d]
            loss[k0:k0 + kg] = body[:, d]
            msum[k0:k0 + kg] = body[:, d + 1]
            wsum = out[-1]
    if s is not None:
        grad = grad * s
    return loss, grad, msum, wsum


def fused_binary_logistic_stacked_scaled(x, Y, w, inv_std, scaled_mean,
                                         coef, d: int,
                                         fit_intercept: bool = True,
                                         x_scale=None
                                         ) -> Dict[str, torch.Tensor]:
    """K1s with standardization folded around the row pass, for the
    coefficients of K models ``coef`` ``(K, n_coef)`` and labels ``Y``
    ``(n, K)``: the counterpart of the reference's
    ``jax.vmap(fused_binary_logistic_scaled, in_axes=(None, 1, None, None,
    None, 0))``. Per model k, as :func:`fused_binary_logistic_scaled`:

      margin_k = x.(inv_std o beta_k) + (b0_k - scaled_mean.beta_k)
      grad_k = inv_std o grad_row_k - scaled_mean * sum(mult_k)

    The fold runs in float32. Returns ``{"loss" (K,), "grad" (K, n_coef),
    "count" (K,)}`` (float32 sums)."""
    f32 = torch.float32
    coef = coef.to(f32)
    inv_std = inv_std.to(f32)
    scaled_mean = scaled_mean.to(f32)
    beta = coef[:, :d]
    k = coef.shape[0]
    b0 = coef[:, d] if fit_intercept else torch.zeros(
        k, dtype=f32, device=coef.device)
    sb = beta * inv_std
    off = b0 - beta @ scaled_mean
    loss, grad_row, msum, wsum = glm_sweep_stacked(x, Y, w, sb, off,
                                                   x_scale=x_scale)
    g = grad_row * inv_std - scaled_mean[None, :] * msum[:, None]
    grad = torch.cat([g, msum[:, None]], dim=1) if fit_intercept else g
    return {"loss": loss, "grad": grad, "count": wsum.expand(k)}


# -- KMeans' center sums in a fixed order -------------------------------------

_SUM_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 3}


def center_sums_plain(x: torch.Tensor, w: torch.Tensor, best: torch.Tensor,
                      k: int, acc_dtype=None, chunk_rows: int = ROW_CHUNK,
                      with_sums: bool = True
                      ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Per-cluster sums of w x ``(k, d)`` (None without ``with_sums``) and
    of w ``(k,)`` in plain PyTorch at ``acc_dtype`` (default w's dtype), X
    upcast ``chunk_rows`` rows at a time. ``index_add_`` adds in row order
    on the CPU; on CUDA its float atomics add in a run-dependent order, so
    there it serves only as the float64 truth the kernel is held
    against."""
    acc = w.dtype if acc_dtype is None else acc_dtype
    counts = torch.zeros(k, dtype=acc, device=x.device).index_add_(
        0, best, w.to(acc))
    if not with_sums:
        return None, counts
    sums = torch.zeros((k, x.shape[1]), dtype=acc, device=x.device)
    for lo in range(0, x.shape[0], chunk_rows):
        sums.index_add_(0, best[lo:lo + chunk_rows],
                        x[lo:lo + chunk_rows].to(acc)
                        * w[lo:lo + chunk_rows, None].to(acc))
    return sums, counts


def center_sums(x: torch.Tensor, w: torch.Tensor, best: torch.Tensor, k: int,
                with_sums: bool = True
                ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """KMeans' center sums at w's (accumulator) width: ``(sums (k, d) of
    w x, or None without with_sums; counts (k,) of w)`` over the rows
    assigned to each of the k clusters by ``best`` (n,). A CPU tensor runs
    :func:`center_sums_plain`; a CUDA tensor sorts ``best`` stably, counts
    rows per cluster (integer results), and launches ``csrc/center_sums.cu``
    (X at its storage width, float32, bfloat16 or float64), whose sums run
    in one fixed order: two calls on the same inputs are bitwise equal. No
    float atomics."""
    if x.device.type == "cpu":
        return center_sums_plain(x, w, best, k, with_sums=with_sums)
    dev = x.device
    if x.dim() != 2 or x.dtype not in _SUM_DTYPE_CODE or \
            w.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"center_sums: X must be 2-D float32, bfloat16 or "
                         f"float64 and w float32 or float64 on CUDA; got "
                         f"{tuple(x.shape)} {x.dtype}, w {w.dtype}")
    if x.stride(1) != 1:
        raise ValueError("center_sums: X's rows must be contiguous")
    n, d = x.shape
    w = w.contiguous()
    if best.shape != (n,) or w.shape != (n,):
        raise ValueError(f"center_sums: best {tuple(best.shape)} and w "
                         f"{tuple(w.shape)} do not match X {(n, d)}")
    lib = _library("center_sums")
    piece = lib.center_sums_piece_rows()
    best = best.to(device=dev, dtype=torch.int64)
    # the rows of each cluster in row order, and the clusters' row and
    # piece offsets: integer results, the same on every run
    order = torch.sort(best, stable=True).indices
    rows = torch.bincount(best, minlength=k)[:k]
    offsets = torch.zeros(k + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(rows, 0)
    pieces = torch.zeros(k + 1, dtype=torch.int64, device=dev)
    pieces[1:] = torch.cumsum((rows + piece - 1) // piece, 0)
    max_pieces = -(-n // piece) + k
    n_cols = d if with_sums else 0
    partials = torch.empty(max_pieces * (n_cols + 1), dtype=torch.float64,
                           device=dev)
    sums = torch.empty((k, n_cols), dtype=torch.float64, device=dev)
    counts = torch.empty(k, dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _cuda_check(lib.center_sums_launch(
            _SUM_DTYPE_CODE[x.dtype], _SUM_DTYPE_CODE[w.dtype], x.data_ptr(),
            w.data_ptr(), order.data_ptr(), offsets.data_ptr(),
            pieces.data_ptr(), k, x.stride(0), n_cols, max_pieces,
            partials.data_ptr(), sums.data_ptr(), counts.data_ptr(), stream),
            "center_sums launch")
    center_sums.launches += 1
    return (sums.to(w.dtype) if with_sums else None), counts.to(w.dtype)


reset_launch_counts()  # every count starts at 0
