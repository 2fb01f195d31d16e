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
  :data:`K_MAX` a launch, 8 on the tensor cores past d = 1280,
  :func:`glm_sweep_stacked_group`); on the tensor cores bytes-bound at
  every K <= 16.
- K3, ``kmeans_assign`` (``csrc/kmeans_assign.cu``): ``fused_kmeans_assign``,
  the nearest center and its squared distance per row (KMeans);
  bound by operations.
- K4, ``gramian`` (``csrc/gramian.cu``): ``fused_gramian``, the presence-
  masked X^T X (RowMatrix, PCA); bound by operations.

Beside them, ``center_sums`` (``csrc/center_sums.cu``) sums KMeans' centers
in a fixed order (the reference's ``jax.ops.segment_sum``, not a Pallas
kernel), so that two fits of the same data end with the same centers; and
the sparse (ELL) tier's two passes (``csrc/ell_sweep.cu``, the reference's
``jnp.take`` gathers and ``segment_sum`` scatters of its sparse
aggregators, not Pallas kernels): S1, ``ell_rows``, the margins, the link
and the per-row multipliers with the loss, sum(mult) and sum(w); S2,
``ell_cols``, the column sums X^T r over a column-ordered copy of the
nonzeros (:func:`ell_columns`), for the gradient or the weighted feature
moments. Both sum in one fixed order, with no float atomics.

X comes in at its storage width: float32, bfloat16 or float8_e4m3fn codes
(the fp8 rung). K1/K2 upcast it to float32 inside the kernel. K1s, K3 and
K4 pick an instance by X's dtype (:data:`INSTANCE`): bf16 X and e4m3 codes
go to the tensor cores (bf16 products summed in float32: K3 and K4 by
wgmma, K3 against the centers split in three bf16 parts; K1s by mma.sync,
against its coefficients and multipliers split the same way,
:func:`split_bf16x3`), float32 X to float32 FMAs. Every wrapper takes the
fp8 rung's optional per-column dequantization vector ``x_scale`` (the
reference's ``x_scale`` operand): the value of X is ``x * x_scale``. K1/K2
fold it into their (d,) vectors and K1s into its (K, d) coefficients; K3
into the centers on the tensor cores (and applies it as X is staged on the
FMAs), K4 in its double reduction pass.

Each wrapper launches its kernel for a CUDA tensor and runs its ``*_plain``
version only for a tensor that lies on the CPU. There is no fallback from
one to the other: a CUDA tensor the kernel cannot take raises. Each wrapper
counts its launches in ``<wrapper>.launches`` (``glm_sweep`` also by link,
in ``glm_sweep.launches_by_link``, and by X's dtype, in
``glm_sweep.launches_by_dtype``; K1s, one launch per group of models, by
X's dtype in ``glm_sweep_stacked.launches_by_dtype`` and by instance in
``glm_sweep_stacked.launches_by_instance``; K3 and K4 also by instance, in
``kmeans_assign.launches_by_instance`` and ``gramian.launches_by_instance``;
S1 by link in ``ell_rows.launches_by_link`` and S2 by mode in
``ell_cols.launches_by_mode``).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

ROW_CHUNK = 1 << 16  # rows upcast at a time by the plain versions
GRAM_CHUNK = 1 << 13  # rows per product in the plain Gramian

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
TENSOR_CORE, FMA = "tensor_core", "fma"
# the instance of K1s, K3 and K4 that each dtype of X launches (the C entry
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


def split_bf16x3(c: torch.Tensor) -> torch.Tensor:
    """A float32 tensor ``c`` split exactly into three bf16 parts, stacked
    on a new first axis (``(k, d)`` -> ``(3, k, d)``): hi = bf16(c), mid =
    bf16(c - hi), lo = bf16(c - hi - mid), so that hi + mid + lo == c
    (three 8-bit significands cover float32's 24; each difference is exact
    in float32). Exact for every float32 value that is 0 or of magnitude
    at least 2^-110 and below bf16's overflow (the last part must stay a
    normal bf16). The tensor-core instances multiply bf16 X by each part,
    every product exact in float32, and sum them in float32, smallest part
    first: K3 its centers, K1s its coefficients and its multipliers."""
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
        "glm_stacked_group": [_I, _I],
        "glm_stacked_num_parts": [_I, _I, _I, _LL, _PI],
        "glm_stacked_launch": [_I, _P, _P, _I, _LL, _P, _P, _P, _LL, _I, _I,
                               _P, _I, _P, _P],
    },
    "center_sums": {
        "center_sums_piece_rows": [],
        "center_sums_launch": [_I, _I, _P, _P, _P, _P, _P, _I, _LL, _I, _LL,
                               _P, _P, _P, _P],
    },
    "ell_sweep": {
        "ell_row_blocks": [_LL],
        "ell_piece_entries": [],
        "ell_rows_launch": [_I, _I, _P, _P, _LL, _I, _P, _P, _P, _P, _P, _P,
                            _P, _P, _P, _I, _P, _P],
        "ell_cols_launch": [_I, _P, _P, _P, _LL, _I, _P, _P, _P, _P, _P, _P,
                            _P],
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


def _device_scalars(values, dev) -> torch.Tensor:
    """Scalars (numbers or 0-d tensors) as one float32 vector on ``dev``,
    without reading a device value back: one copy from the host when all
    are numbers, else one stack on the device."""
    if not any(torch.is_tensor(v) for v in values):
        return torch.tensor([float(v) for v in values], dtype=torch.float32,
                            device=dev)
    return torch.stack([
        v.to(device=dev, dtype=torch.float32).reshape(())
        if torch.is_tensor(v)
        else torch.full((), float(v), dtype=torch.float32, device=dev)
        for v in values])


# the sweep's CTA count by (library, device, dtype, link, d, n): the
# occupancy query behind it is asked once, not per sweep
_GLM_PARTS: Dict[tuple, int] = {}


def _glm_parts(lib, dev, code: int, lcode: int, d: int, n: int) -> int:
    key = (id(lib), dev.index, code, lcode, d, n)
    parts = _GLM_PARTS.get(key)
    if parts is None:
        out = ctypes.c_int(0)
        _cuda_check(lib.glm_sweep_num_parts(code, lcode, d, n,
                                            ctypes.byref(out)),
                    "glm_sweep_num_parts")
        parts = _GLM_PARTS[key] = out.value
    return parts


def glm_sweep_plan(dtype: torch.dtype, link: str, d: int,
                   device=None) -> Dict[str, int]:
    """The kernel instance a CUDA sweep of X ``(n, d)`` of ``dtype``
    launches: its ring stages ``S``, its block rows ``R``, its dynamic
    shared memory in bytes and its CTAs resident on one SM of ``device``
    (the current CUDA device by default)."""
    lib = _library("glm_sweep")
    # declared here and not in _SIGNATURES: an older build of the source
    # without this entry point (glm_phases.py --parent) still loads
    fn = lib.glm_sweep_plan
    fn.argtypes, fn.restype = [_I, _I, _I, _PI], _I
    plan = (ctypes.c_int * 4)()
    with torch.cuda.device(device if device is not None
                           else torch.cuda.current_device()):
        _cuda_check(fn(_DTYPE_CODE[dtype], _LINK_CODE[link], d, plan),
                    "glm_sweep_plan")
    return {"stages": plan[0], "block_rows": plan[1], "smem_bytes": plan[2],
            "ctas_per_sm": plan[3]}


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
    scalars = _device_scalars((off, ys), dev)
    code, lcode = _DTYPE_CODE[x.dtype], _LINK_CODE[link]
    with torch.cuda.device(dev):
        parts = _glm_parts(lib, dev, code, lcode, d, n)
        partials = torch.empty(parts * (d + 3), dtype=torch.float64,
                               device=dev)
        out = torch.empty(d + 3, dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _cuda_check(lib.glm_sweep_launch(
            code, lcode, x.data_ptr(), y.data_ptr(), w.data_ptr(),
            beta.data_ptr(), scalars.data_ptr(), n, d, partials.data_ptr(),
            parts, out.data_ptr(), stream), "glm_sweep launch")
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
    glm_sweep_stacked.launches_by_instance = {TENSOR_CORE: 0, FMA: 0}
    center_sums.launches = 0
    ell_rows.launches = 0
    ell_rows.launches_by_link = {link: 0 for link in _ELL_LINK_CODE}
    ell_cols.launches = 0
    ell_cols.launches_by_mode = {GRADIENT: 0, MOMENTS: 0}


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
    by :func:`split_bf16x3` and padded with zeros to k and d multiples of
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
        parts[:, :k, :d] = split_bf16x3(c if s is None else c * s)
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

K_MAX = 16  # models one K1s launch sweeps at most (csrc/glm_stacked.cu)
K1S_PAD = 64  # the tensor-core instance takes B's parts at d rounded up to 64


def glm_sweep_stacked_group(dtype: torch.dtype, d: int) -> int:
    """Models one K1s launch takes for X of ``dtype`` and width ``d``: the
    group size :func:`glm_sweep_stacked` launches by, :data:`K_MAX`, or 8
    on the tensor cores past d = 1280 (where sixteen models' parts leave no
    room for two stages of X). Asks the built kernel (CUDA only)."""
    lib = _library("glm_stacked")
    group = lib.glm_stacked_group(_DTYPE_CODE[dtype], d)
    if group < 1:
        raise ValueError(f"glm_sweep_stacked: no instance takes X of "
                         f"{dtype} at d={d} (limit {lib.glm_stacked_max_d()}"
                         " features)")
    return group


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
    once per group of :func:`glm_sweep_stacked_group` models, each launch
    reading X once, or raises. The scale is folded into B and into the
    gradient rows, as :func:`glm_sweep` folds it. bf16 X and e4m3 codes
    launch the tensor-core instance, which takes each group's B split by
    :func:`split_bf16x3` and zero-padded to :data:`K1S_PAD` columns, and
    bf16 labels in pairs (a group of odd size or odd row stride goes over
    as float32 labels); float32 X the FMA instance, which takes B as it
    is."""
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
    instance = INSTANCE[x.dtype]
    group = glm_sweep_stacked_group(x.dtype, d)
    d_pad = -(-d // K1S_PAD) * K1S_PAD
    loss = torch.empty(k, dtype=torch.float32, device=dev)
    grad = torch.empty((k, d), dtype=torch.float32, device=dev)
    msum = torch.empty(k, dtype=torch.float32, device=dev)
    wsum = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for k0 in range(0, k, group):
            kg = min(group, k - k0)
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
            if instance == TENSOR_CORE:
                bg = torch.zeros((3, kg, d_pad), dtype=torch.bfloat16,
                                 device=dev)
                bg[:, :, :d] = split_bf16x3(B[k0:k0 + kg])
            else:
                bg = B[k0:k0 + kg].contiguous()
            og = off[k0:k0 + kg].contiguous()
            yg, y_ptr, ldy, yb = Y, Y.data_ptr() + k0 * Y.element_size(), \
                Y.stride(0), y_bf16
            if instance == TENSOR_CORE and yb and (kg % 2 or ldy % 2
                                                   or y_ptr % 4):
                # the tensor-core instance copies bf16 labels in pairs;
                # a group that cannot be read so goes over as float32
                yg = Y[:, k0:k0 + kg].float()
                y_ptr, ldy, yb = yg.data_ptr(), kg, 0
            _cuda_check(lib.glm_stacked_launch(
                code, x.data_ptr(), y_ptr, yb, ldy, w.data_ptr(),
                bg.data_ptr(), og.data_ptr(), n, d, kg, partials.data_ptr(),
                parts.value, out.data_ptr(), stream), "glm_stacked launch")
            glm_sweep_stacked.launches += 1
            glm_sweep_stacked.launches_by_dtype[x.dtype] += 1
            glm_sweep_stacked.launches_by_instance[instance] += 1
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


# -- S1 and S2: the sparse (ELL) tier's row and column passes ----------------

GRAM, HINGE = "gram", "hinge"
GRADIENT, MOMENTS = "gradient", "moments"
_ELL_LINK_CODE = {LOGISTIC: 0, SQUARED: 1, HINGE: 2, GRAM: 3}
ELL_CHUNK = 1 << 18  # rows the plain versions take at a time
ELL_PIECE = 1024     # nonzeros of one S2 piece, at most (csrc/ell_sweep.cu)


class EllTail(NamedTuple):
    """A hybrid dataset's COO tail grouped by row: the entries of row r are
    ``cols[ptr[r]:ptr[r + 1]]`` and ``vals[...]``, in their stored order."""
    ptr: torch.Tensor   # (n + 1,) int64
    cols: torch.Tensor  # int32
    vals: torch.Tensor  # float32


class EllColumns(NamedTuple):
    """The nonzeros in column order, S2's operand: column c holds
    ``rows[col_ptr[c]:col_ptr[c + 1]]`` (in row order, the COO tail after
    the ELL entries) and their ``vals``; its entries are cut into pieces of
    at most ``piece``, numbered ``piece_start[c]`` on, each of column
    ``piece_col[p]``."""
    col_ptr: torch.Tensor      # (d + 1,) int64
    rows: torch.Tensor         # (nnz,) int32
    vals: torch.Tensor         # (nnz,) float32
    piece_start: torch.Tensor  # (d + 1,) int64
    piece_col: torch.Tensor    # (n_pieces,) int32
    piece: int


def ell_tail(coo_row: torch.Tensor, coo_idx: torch.Tensor,
             coo_val: torch.Tensor, n: int) -> EllTail:
    """The COO tail (row ids, column ids, values) grouped by row with a
    stable sort, entries of value 0 (the padding) dropped: integer results,
    the same on every run."""
    keep = coo_val != 0
    rows = coo_row[keep].long()
    order = torch.sort(rows, stable=True).indices
    ptr = torch.zeros(n + 1, dtype=torch.int64, device=rows.device)
    ptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n)[:n], 0)
    return EllTail(ptr, coo_idx[keep][order].int().contiguous(),
                   coo_val[keep][order].float().contiguous())


def tail_row_ids(tail: EllTail) -> torch.Tensor:
    """The row id (int64) of each entry of a row-grouped tail."""
    n = tail.ptr.shape[0] - 1
    return torch.repeat_interleave(
        torch.arange(n, device=tail.ptr.device), tail.ptr.diff())


def _nonzero_chunks(indices, values, tail, chunk_rows):
    """(columns int64, rows int32, values) of the nonzeros, the ELL rows a
    chunk at a time in row-major order, then the COO tail."""
    n, k = indices.shape
    dev = indices.device
    for lo in range(0, n, chunk_rows):
        hi = min(lo + chunk_rows, n)
        v = values[lo:hi].reshape(-1)
        keep = v != 0
        rows = torch.arange(lo, hi, dtype=torch.int32,
                            device=dev).repeat_interleave(k)
        yield indices[lo:hi].reshape(-1)[keep].long(), rows[keep], v[keep]
    if tail is not None:
        yield tail.cols.long(), tail_row_ids(tail).int(), tail.vals


def ell_columns(indices: torch.Tensor, values: torch.Tensor, d: int,
                tail: Optional[EllTail] = None, piece: int = ELL_PIECE,
                chunk_rows: int = 1 << 20) -> EllColumns:
    """The column-ordered copy of the nonzeros of ELL rows ``indices``,
    ``values`` (n, k) (and of the COO ``tail``) that S2 reads: a counting
    sort by column, a chunk of rows at a time (a stable sort inside the
    chunk), so entries of a column keep their row order and the scratch is
    bounded by the chunk, not by the nonzeros. Every step has an integer
    result: two builds are equal."""
    dev = indices.device
    counts = torch.zeros(d, dtype=torch.int64, device=dev)
    for cols, _, _ in _nonzero_chunks(indices, values, tail, chunk_rows):
        counts += torch.bincount(cols, minlength=d)[:d]
    col_ptr = torch.zeros(d + 1, dtype=torch.int64, device=dev)
    col_ptr[1:] = torch.cumsum(counts, 0)
    nnz = int(col_ptr[-1])
    rows_out = torch.empty(nnz, dtype=torch.int32, device=dev)
    vals_out = torch.empty(nnz, dtype=torch.float32, device=dev)
    fill = col_ptr[:-1].clone()
    for cols, rows, vals in _nonzero_chunks(indices, values, tail,
                                            chunk_rows):
        order = torch.sort(cols, stable=True).indices
        sc = cols[order]
        cc = torch.bincount(cols, minlength=d)[:d]
        first = torch.cumsum(cc, 0) - cc  # each column's first sorted slot
        dest = fill[sc] + (torch.arange(sc.shape[0], device=dev) - first[sc])
        rows_out[dest] = rows[order]
        vals_out[dest] = vals[order].float()
        fill += cc
        del order, sc, dest
    pieces = (counts + piece - 1) // piece
    piece_start = torch.zeros(d + 1, dtype=torch.int64, device=dev)
    piece_start[1:] = torch.cumsum(pieces, 0)
    piece_col = torch.repeat_interleave(
        torch.arange(d, dtype=torch.int32, device=dev), pieces)
    return EllColumns(col_ptr, rows_out, vals_out, piece_start, piece_col,
                      piece)


def _ell_chunk_values(indices, values, scale, lo, hi):
    """Rows ``lo:hi`` of the values, times ``scale[index]`` in float32
    (the product the reference stores as its standardized values)."""
    v = values[lo:hi]
    return v if scale is None else v * scale[indices[lo:hi].long()]


def tail_values(tail: EllTail, scale):
    """The tail's values, times ``scale[column]`` in float32 when given."""
    return tail.vals if scale is None else tail.vals * scale[tail.cols.long()]


def _ell_link(margin, y, w, link: str):
    """(loss, mult) of the rows at ``margin`` in its dtype."""
    if link == LOGISTIC:
        return (torch.sum(w * (_softplus(margin) - y * margin)),
                w * (torch.sigmoid(margin) - y))
    if link == SQUARED:
        err = margin - y
        return 0.5 * torch.sum(w * err * err), w * err
    if link == HINGE:
        ysign = 2.0 * y - 1.0
        slack = 1.0 - ysign * margin
        return (torch.sum(w * torch.clamp(slack, min=0.0)),
                torch.where(slack > 0, -ysign * w, torch.zeros_like(w)))
    return (torch.zeros((), dtype=margin.dtype, device=margin.device),
            margin * (w > 0).to(margin.dtype))


def ell_rows_plain(indices: torch.Tensor, values: torch.Tensor,
                   y: torch.Tensor, w: torch.Tensor, beta: torch.Tensor,
                   b0=0.0, link: str = LOGISTIC, scale=None,
                   tail: Optional[EllTail] = None,
                   chunk_rows: int = ELL_CHUNK):
    """S1 in plain PyTorch at beta's dtype: margins sum(v beta[index]) + b0
    (gathers, the COO tail by ``index_add_`` over its rows), then the
    link. Returns ``(mult (n,), loss, sum(mult), sum(w))``."""
    acc = beta.dtype
    n = indices.shape[0]
    margin = torch.empty(n, dtype=acc, device=indices.device)
    for lo in range(0, n, chunk_rows):
        hi = min(lo + chunk_rows, n)
        v = _ell_chunk_values(indices, values, scale, lo, hi)
        margin[lo:hi] = torch.sum(v.to(acc) * beta[indices[lo:hi].long()],
                                  dim=1)
    if tail is not None:
        margin.index_add_(0, tail_row_ids(tail),
                          tail_values(tail, scale).to(acc)
                          * beta[tail.cols.long()])
    margin = margin + b0
    yy, ww = y.to(acc), w.to(acc)
    loss, mult = _ell_link(margin, yy, ww, link)
    return mult, loss, torch.sum(mult), torch.sum(ww)


def _check_ell(indices, values, what: str) -> None:
    if indices.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {indices.device}")
    if (indices.dim() != 2 or indices.dtype != torch.int32
            or values.shape != indices.shape
            or values.dtype != torch.float32):
        raise ValueError(f"{what}: ELL rows must be (n, k) int32 indices and "
                         f"float32 values on CUDA; got {tuple(indices.shape)} "
                         f"{indices.dtype}, {tuple(values.shape)} "
                         f"{values.dtype}")
    if not (indices.is_contiguous() and values.is_contiguous()):
        raise ValueError(f"{what}: ELL rows must be contiguous")


def _f32_operand(t, n: int, dev, what: str) -> torch.Tensor:
    t = t.to(device=dev, dtype=torch.float32).contiguous()
    if t.shape != (n,):
        raise ValueError(f"{what}: expected shape ({n},), got "
                         f"{tuple(t.shape)}")
    return t


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def ell_rows(indices: torch.Tensor, values: torch.Tensor, y: torch.Tensor,
             w: torch.Tensor, beta: torch.Tensor, b0=0.0,
             link: str = LOGISTIC, scale=None,
             tail: Optional[EllTail] = None):
    """S1, the row pass: ``(mult (n,), loss, sum(mult), sum(w))`` for ELL
    rows ``indices`` (n, k) int32 and ``values`` (n, k) float32 (value
    times ``scale[index]`` when a (d,) scale is given), y, w (n,), beta
    (d,), the margin offset ``b0`` and the row-grouped COO ``tail``;
    ``link`` is logistic, squared, hinge or gram (mult = margin [w > 0]).
    Every index must be below d. A CPU tensor runs :func:`ell_rows_plain`;
    a CUDA tensor launches ``csrc/ell_sweep.cu`` (mult in float32, the
    three sums as float64 0-d tensors, summed in double in one fixed order:
    two launches are bitwise equal) or raises."""
    if link not in _ELL_LINK_CODE:
        raise ValueError(f"ell_rows: unknown link {link!r}")
    if indices.device.type == "cpu":
        return ell_rows_plain(indices, values, y, w, beta, b0, link, scale,
                              tail)
    _check_ell(indices, values, "ell_rows")
    n, k = indices.shape
    dev = indices.device
    beta = beta.to(device=dev, dtype=torch.float32).contiguous()
    d = beta.shape[0]
    y = _f32_operand(y, n, dev, "ell_rows y")
    w = _f32_operand(w, n, dev, "ell_rows w")
    s = None if scale is None else _f32_operand(scale, d, dev,
                                                "ell_rows scale")
    if tail is not None and tail.ptr.shape != (n + 1,):
        raise ValueError(f"ell_rows: the tail has {tail.ptr.shape[0] - 1} "
                         f"rows, X {n}")
    b0t = _device_scalars((b0,), dev)
    # with a scale, one (d, 2) table of (scale, beta) pairs: one gather a
    # slot serves both
    coef = beta if s is None else torch.stack([s, beta], 1).contiguous()
    lib = _library("ell_sweep")
    with torch.cuda.device(dev):
        blocks = lib.ell_row_blocks(n)
        partials = torch.empty(blocks * 3, dtype=torch.float64, device=dev)
        out = torch.empty(3, dtype=torch.float64, device=dev)
        mult = torch.empty(n, dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _cuda_check(lib.ell_rows_launch(
            _ELL_LINK_CODE[link], int(s is not None), indices.data_ptr(),
            values.data_ptr(), n, k, _ptr(tail.ptr if tail else None),
            _ptr(tail.cols if tail else None),
            _ptr(tail.vals if tail else None), coef.data_ptr(),
            b0t.data_ptr(), y.data_ptr(), w.data_ptr(), mult.data_ptr(),
            partials.data_ptr(), blocks, out.data_ptr(), stream),
            "ell_rows launch")
    ell_rows.launches += 1
    ell_rows.launches_by_link[link] += 1
    return mult, out[0], out[1], out[2]


def ell_cols_plain(indices: torch.Tensor, values: torch.Tensor,
                   r: torch.Tensor, d: int, moments: bool = False,
                   scale=None, tail: Optional[EllTail] = None,
                   acc_dtype=None, chunk_rows: int = ELL_CHUNK):
    """S2 in plain PyTorch with ``index_add_`` over the ELL rows (and the
    tail): the gradient sum_i r_i x_i (d,), or with ``moments`` the (3, d)
    sums of r v, (r v) v and r [v != 0]. The products are formed at r's
    dtype (float32 for float32 r, as the reference's summary forms them),
    summed in float64 as the kernel sums them in double, and returned at
    ``acc_dtype`` (default r's). ``index_add_`` adds in order on the CPU;
    on CUDA its float atomics add in a run-dependent order."""
    f64 = torch.float64
    out = torch.zeros((3 if moments else 1, d), dtype=f64,
                      device=indices.device)

    def add(cols, rr, v):
        if moments:
            wk = rr * v
            out[0].index_add_(0, cols, wk.reshape(-1).to(f64))
            out[1].index_add_(0, cols, (wk * v).reshape(-1).to(f64))
            out[2].index_add_(0, cols, (rr * (v != 0)).reshape(-1).to(f64))
        else:
            out[0].index_add_(0, cols,
                              (rr * v.to(rr.dtype)).reshape(-1).to(f64))

    n = indices.shape[0]
    for lo in range(0, n, chunk_rows):
        hi = min(lo + chunk_rows, n)
        add(indices[lo:hi].reshape(-1).long(), r[lo:hi, None],
            _ell_chunk_values(indices, values, scale, lo, hi))
    if tail is not None:
        add(tail.cols.long(), r[tail_row_ids(tail)],
            tail_values(tail, scale))
    out = out.to(r.dtype if acc_dtype is None else acc_dtype)
    return out if moments else out[0]


def ell_cols(indices: torch.Tensor, values: torch.Tensor, r: torch.Tensor,
             d: int, moments: bool = False, scale=None,
             tail: Optional[EllTail] = None,
             columns: Union[EllColumns, Callable[[], EllColumns],
                            None] = None):
    """S2, the column pass: sum_i r_i x_i (d,) over the ELL rows (value
    times ``scale[index]`` when given) and the COO ``tail``, or with
    ``moments`` the (3, d) weighted moments of :func:`ell_cols_plain`. A
    CPU tensor runs :func:`ell_cols_plain`; a CUDA tensor launches
    ``csrc/ell_sweep.cu`` over ``columns`` (:func:`ell_columns` of the
    same rows and tail, or a zero-argument callable that returns it, such
    as a dataset's ``columns``, called only here; float32 results, sums in
    double in one fixed order: two launches are bitwise equal) or
    raises."""
    if indices.device.type == "cpu":
        return ell_cols_plain(indices, values, r, d, moments, scale, tail)
    _check_ell(indices, values, "ell_cols")
    if callable(columns):
        columns = columns()
    if columns is None:
        raise ValueError("ell_cols: a CUDA launch reads the column-ordered "
                         "copy of the nonzeros (ell_columns)")
    dev = indices.device
    n = indices.shape[0]
    r = _f32_operand(r, n, dev, "ell_cols r")
    s = None if scale is None else _f32_operand(scale, d, dev,
                                                "ell_cols scale")
    lib = _library("ell_sweep")
    if columns.col_ptr.shape != (d + 1,) or \
            columns.piece != lib.ell_piece_entries():
        raise ValueError(f"ell_cols: the column copy is not one of {d} "
                         f"columns in pieces of {lib.ell_piece_entries()}")
    m = 3 if moments else 1
    n_pieces = columns.piece_col.shape[0]
    with torch.cuda.device(dev):
        partials = torch.empty(max(n_pieces, 1) * m, dtype=torch.float64,
                               device=dev)
        out = torch.empty((m, d), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _cuda_check(lib.ell_cols_launch(
            int(moments), columns.col_ptr.data_ptr(),
            columns.piece_start.data_ptr(), columns.piece_col.data_ptr(),
            n_pieces, d, columns.rows.data_ptr(), columns.vals.data_ptr(),
            _ptr(s), r.data_ptr(), partials.data_ptr(), out.data_ptr(),
            stream), "ell_cols launch")
    ell_cols.launches += 1
    ell_cols.launches_by_mode[MOMENTS if moments else GRADIENT] += 1
    return out if moments else out[0]


reset_launch_counts()  # every count starts at 0
