"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Every ``pl.pallas_call`` body of ``cycloneml_tpu/ops/kernels.py`` has a
counterpart here, each with a source note in its ``.cu`` file (what it
replaces, what bounds it on the card, what the design does about that):

- K1 and K2, the GLM row sweep (``csrc/glm_sweep.cu``): ``_run_glm`` with the
  logistic link (LogisticRegression) and the squared link
  (LinearRegression). One pass over X computing the loss, the gradient,
  sum(mult) and sum(w); bytes-bound.
- K3, ``kmeans_assign`` (``csrc/kmeans_assign.cu``): ``fused_kmeans_assign``,
  the nearest center and its squared distance per row (KMeans);
  bound by float32 FMAs.
- K4, ``gramian`` (``csrc/gramian.cu``): ``fused_gramian``, the presence-
  masked X^T X (RowMatrix, PCA); bound by float32 FMAs.

Each wrapper launches its kernel for a CUDA tensor and runs its ``*_plain``
version only for a tensor that lies on the CPU. There is no fallback from
one to the other: a CUDA tensor the kernel cannot take raises. Each wrapper
counts its launches in ``<wrapper>.launches`` (``glm_sweep`` also by link,
in ``glm_sweep.launches_by_link``).

Not ported yet (ROADMAP slice 3): the fp8 ``x_scale`` operand of K1-K4.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

ROW_CHUNK = 1 << 16  # rows upcast at a time by the plain versions
GRAM_CHUNK = 1 << 13  # rows per product in the plain Gramian

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def use_fused_kernels(ctx, x: Optional[torch.Tensor] = None) -> bool:
    """Whether the eligible dense sweeps go through the hand-written
    kernels: ``cyclone.ml.usePallasKernels`` 'true'/'false' force one path
    (the key keeps the reference's name, so configurations carry over);
    'auto' (default) says yes when the data ``x`` lives on CUDA in a dtype
    the kernel reads (float32 or bfloat16)."""
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


# -- K1: the GLM row sweep -----------------------------------------------------

def _softplus(m: torch.Tensor) -> torch.Tensor:
    # exact at every magnitude (torch's softplus goes linear past 20)
    return m.clamp(min=0) + torch.log1p(torch.exp(-m.abs()))


LOGISTIC, SQUARED = "logistic", "squared"
_LINK_CODE = {LOGISTIC: 0, SQUARED: 1}


def glm_sweep_plain(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                    beta: torch.Tensor, off, acc_dtype=torch.float32,
                    chunk_rows: int = ROW_CHUNK, link: str = LOGISTIC,
                    ys=0.0) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor]:
    """The sweep in plain PyTorch, accumulated in ``acc_dtype``:
    returns ``(loss, grad_row (d,), sum(mult), sum(w))``. The logistic
    link takes mult = w(sigmoid(m) - y), loss = w(softplus(m) - y m); the
    squared link err = m - ys y, mult = w err, loss = w err^2 / 2, where
    m = x.beta + off. X is upcast ``chunk_rows`` rows at a time, so no
    full-width copy of X is held. With ``acc_dtype=torch.float64`` it is
    the truth the kernel is held against on the card."""
    if link not in _LINK_CODE:
        raise ValueError(f"glm_sweep: unknown link {link!r}")
    n, d = x.shape
    dev = x.device
    beta_a = beta.to(acc_dtype)
    off_a = torch.as_tensor(off, dtype=acc_dtype, device=dev)
    ys_a = torch.as_tensor(ys, dtype=acc_dtype, device=dev)
    loss = torch.zeros((), dtype=acc_dtype, device=dev)
    grad = torch.zeros(d, dtype=acc_dtype, device=dev)
    msum = torch.zeros((), dtype=acc_dtype, device=dev)
    wsum = torch.zeros((), dtype=acc_dtype, device=dev)
    for lo in range(0, n, chunk_rows):
        xc = x[lo:lo + chunk_rows].to(acc_dtype)
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
        "kmeans_assign_launch": [_I, _P, _P, _P, _LL, _I, _I, _P, _P, _P],
    },
    "gramian": {
        "gramian_plan": [_I, _LL, _PI, _PI],
        "gramian_launch": [_I, _P, _P, _LL, _I, _I, _I, _P, _P, _P],
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
    """A CUDA X the kernels take: 2-D, float32 or bfloat16, contiguous."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    if x.dim() != 2 or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{what}: X must be 2-D float32 or bfloat16 on "
                         f"CUDA; got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: X must be contiguous (a copy of X "
                         "would double the pass's memory)")


def glm_sweep(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
              beta: torch.Tensor, off, link: str = LOGISTIC, ys=0.0
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """K1 (``link="logistic"``) and K2 (``link="squared"``, label scale
    ``ys``): ``(loss, grad_row (d,), sum(mult), sum(w))`` in float32 for X
    ``(n, d)`` at storage width, y, w ``(n,)``, beta ``(d,)`` and the
    margin offset ``off`` (a scalar or 0-d tensor). A CPU tensor runs
    :func:`glm_sweep_plain`; a CUDA tensor launches the kernel or
    raises."""
    if link not in _LINK_CODE:
        raise ValueError(f"glm_sweep: unknown link {link!r}")
    if x.device.type == "cpu":
        return glm_sweep_plain(x, y, w, beta, off, link=link, ys=ys)
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
    beta = beta.to(device=dev, dtype=torch.float32).contiguous()
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
    return out[d], out[:d], out[d + 1], out[d + 2]


glm_sweep.launches = 0
glm_sweep.launches_by_link = {LOGISTIC: 0, SQUARED: 0}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    glm_sweep.launches = 0
    glm_sweep.launches_by_link = {LOGISTIC: 0, SQUARED: 0}
    kmeans_assign.launches = 0
    gramian.launches = 0


def fused_binary_logistic_scaled(x, y, w, inv_std, scaled_mean, coef,
                                 d: int, fit_intercept: bool = True
                                 ) -> Dict[str, torch.Tensor]:
    """K1 with standardization folded around the row pass (the
    counterpart of the reference's ``fused_binary_logistic_scaled``):

      margin = x.(inv_std o beta) + (b0 - scaled_mean.beta)
      grad_beta = inv_std o grad_row - scaled_mean * sum(mult)

    so X is read raw. The fold runs in float32, as the reference's does.
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
    loss, grad_row, msum, wsum = glm_sweep(x, y, w, sb, off)
    g = inv_std * grad_row - scaled_mean * msum
    grad = torch.cat([g, msum.reshape(1)]) if fit_intercept else g
    return {"loss": loss, "grad": grad, "count": wsum}


def fused_binary_logistic(x, y, w, coef, d: int, fit_intercept: bool = True
                          ) -> Dict[str, torch.Tensor]:
    """The unscaled twin of :func:`fused_binary_logistic_scaled`
    (inv_std = 1, scaled_mean = 0)."""
    ones = torch.ones(d, dtype=torch.float32, device=coef.device)
    return fused_binary_logistic_scaled(x, y, w, ones, torch.zeros_like(ones),
                                        coef, d, fit_intercept)


def fused_least_squares_scaled(x, y, w, inv_std, scaled_mean, y_pars, coef,
                               d: int) -> Dict[str, torch.Tensor]:
    """K2 with the doubly-standardized least-squares objective folded
    around the row pass (the counterpart of the reference's
    ``fused_least_squares_scaled``), ``y_pars = [1/sigma_y, y_mean_hat]``:

      margin = x.(inv_std o coef) + (y_mean_hat - scaled_mean.coef)
      err = margin - y / sigma_y
      grad = inv_std o grad_row - scaled_mean * sum(mult)

    X is read raw; there is no intercept coordinate. The fold runs in
    float32, as the reference's does. Returns ``{"loss", "grad",
    "count"}`` (float32 sums)."""
    f32 = torch.float32
    coef = coef.to(f32)
    inv_std = inv_std.to(f32)
    scaled_mean = scaled_mean.to(f32)
    y_pars = torch.as_tensor(y_pars, device=coef.device).to(f32)
    sb = inv_std * coef
    off = y_pars[1] - torch.dot(scaled_mean, coef)
    loss, grad_row, msum, wsum = glm_sweep(x, y, w, sb, off, link=SQUARED,
                                           ys=y_pars[0])
    g = inv_std * grad_row - scaled_mean * msum
    return {"loss": loss, "grad": g, "count": wsum}


# -- K3: nearest-center assignment ---------------------------------------------

def kmeans_assign_plain(x: torch.Tensor, centers: torch.Tensor,
                        acc_dtype=torch.float32,
                        chunk_rows: int = ROW_CHUNK
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The assignment in plain PyTorch at ``acc_dtype``: ``(best int64
    (n,), min_d2 (n,))`` with d2 = (|x|^2 - 2 x.c) + |c|^2, the first
    least index, and the minimum clamped at 0. X is upcast ``chunk_rows``
    rows at a time, so neither a full-width copy of X nor an (n, k)
    distance matrix is held."""
    n = x.shape[0]
    c = centers.to(acc_dtype)
    c_norm = torch.sum(c * c, dim=1)
    best = torch.empty(n, dtype=torch.int64, device=x.device)
    dist = torch.empty(n, dtype=acc_dtype, device=x.device)
    for lo in range(0, n, chunk_rows):
        xc = x[lo:lo + chunk_rows].to(acc_dtype)
        x2 = torch.sum(xc * xc, dim=1)
        d2 = (x2[:, None] - 2.0 * (xc @ c.T)) + c_norm[None, :]
        mn, idx = torch.min(d2, dim=1)  # the first index of the minimum
        best[lo:lo + chunk_rows] = idx
        dist[lo:lo + chunk_rows] = torch.clamp(mn, min=0.0)
    return best, dist


def kmeans_assign(x: torch.Tensor, centers: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 wrapper (the counterpart of the reference's
    ``fused_kmeans_assign``): ``(best (n,), min_d2 float32 (n,))`` for X
    ``(n, d)`` at storage width and centers ``(k, d)``, which are taken in
    float32. A CPU tensor runs :func:`kmeans_assign_plain` in float32; a
    CUDA tensor launches the kernel (int32 ``best``) or raises."""
    if x.device.type == "cpu":
        return kmeans_assign_plain(x, centers)
    _check_x(x, "kmeans_assign")
    n, d = x.shape
    dev = x.device
    c = centers.to(device=dev, dtype=torch.float32).contiguous()
    if c.dim() != 2 or c.shape[1] != d or c.shape[0] < 1:
        raise ValueError(f"kmeans_assign: centers {tuple(c.shape)} do not "
                         f"match X {(n, d)}")
    k = c.shape[0]
    c_norm = torch.sum(c * c, dim=1).contiguous()
    best = torch.empty(n, dtype=torch.int32, device=dev)
    dist = torch.empty(n, dtype=torch.float32, device=dev)
    lib = _library("kmeans_assign")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _cuda_check(lib.kmeans_assign_launch(
            _DTYPE_CODE[x.dtype], x.data_ptr(), c.data_ptr(),
            c_norm.data_ptr(), n, d, k, best.data_ptr(), dist.data_ptr(),
            stream), "kmeans_assign launch")
    kmeans_assign.launches += 1
    return best, dist


kmeans_assign.launches = 0


# -- K4: the Gramian -----------------------------------------------------------

def gramian_plain(x: torch.Tensor, w: Optional[torch.Tensor] = None,
                  acc_dtype=torch.float32,
                  chunk_rows: int = GRAM_CHUNK) -> torch.Tensor:
    """X^T X over the rows with w > 0 (all rows when ``w`` is None), in
    plain PyTorch at ``acc_dtype``, exactly symmetric; X is upcast
    ``chunk_rows`` rows at a time (chunk products summed in order), so no
    full-width copy of X or masked copy is held. The chunks are short
    because a float32 product sums each chunk's rows in one accumulator,
    and long sums of squares drift (see ``csrc/gramian.cu``)."""
    n, d = x.shape
    g = torch.zeros((d, d), dtype=acc_dtype, device=x.device)
    for lo in range(0, n, chunk_rows):
        xc = x[lo:lo + chunk_rows].to(acc_dtype)
        if w is not None:
            xm = xc * (w[lo:lo + chunk_rows] > 0)[:, None].to(acc_dtype)
        else:
            xm = xc
        g += xm.T @ xc
    # mirror the upper triangle, so that G == G^T exactly, as the kernel's
    return torch.triu(g) + torch.triu(g, 1).T


def gramian(x: torch.Tensor, w: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """K4 wrapper (the counterpart of the reference's ``fused_gramian``):
    the ``(d, d)`` float32 X^T X over the rows with w > 0, for X ``(n, d)``
    at storage width. A CPU tensor runs :func:`gramian_plain` in float32;
    a CUDA tensor launches the kernel or raises."""
    if x.device.type == "cpu":
        return gramian_plain(x, w)
    _check_x(x, "gramian")
    n, d = x.shape
    dev = x.device
    if w is not None:
        w = w.to(device=dev, dtype=torch.float32).contiguous()
        if w.shape != (n,):
            raise ValueError(f"gramian: w {tuple(w.shape)} does not match "
                             f"X {(n, d)}")
    lib = _library("gramian")
    with torch.cuda.device(dev):
        tiles, splits = ctypes.c_int(0), ctypes.c_int(0)
        _cuda_check(lib.gramian_plan(d, n, ctypes.byref(tiles),
                                     ctypes.byref(splits)), "gramian_plan")
        partials = torch.empty(splits.value * tiles.value * 128 * 128,
                               dtype=torch.float64, device=dev)
        g = torch.empty((d, d), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _cuda_check(lib.gramian_launch(
            _DTYPE_CODE[x.dtype], x.data_ptr(),
            w.data_ptr() if w is not None else None, n, d, tiles.value,
            splits.value, partials.data_ptr(), g.data_ptr(), stream),
            "gramian launch")
    gramian.launches += 1
    return g


gramian.launches = 0
