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
  :data:`K_MAX` a launch, 8 on the tensor cores from d = 1281 to 2048 and
  past 8192, :func:`glm_sweep_stacked_group`); on the tensor cores
  bytes-bound at every K <= 16 up to d = 2048.
- K3, ``kmeans_assign`` (``csrc/kmeans_assign.cu``): ``fused_kmeans_assign``,
  the nearest center and its squared distance per row (KMeans);
  bound by operations.
- K4, ``gramian`` (``csrc/gramian.cu``): ``fused_gramian``, the presence-
  masked X^T X (RowMatrix, PCA); bound by operations.

Beside them, ``center_sums`` (``csrc/center_sums.cu``) sums KMeans' centers
in a fixed order (the reference's ``jax.ops.segment_sum``, not a Pallas
kernel), so that two fits of the same data end with the same centers: a
stable counting sort of the assignment written for the card, then one warp
a piece of a cluster's sorted rows (the ``counting`` instance; past
:data:`COUNT_MAX_K` clusters the ``sorted`` one, ``torch.sort`` and the
same sums, bitwise equal to it); and
the sparse (ELL) tier's two passes (``csrc/ell_sweep.cu``, the reference's
``jnp.take`` gathers and ``segment_sum`` scatters of its sparse
aggregators, not Pallas kernels): S1, ``ell_rows``, the margins, the link
and the per-row multipliers with the loss, sum(mult) and sum(w); S2,
``ell_cols``, the column sums X^T r over a copy of the nonzeros in (row
block, column) order (:func:`ell_columns`), for the gradient or the
weighted feature moments. Both sum in one fixed order, with no float atomics.
So does ``als_normal`` (``csrc/als_normal.cu``), ALS's normal equations of
every destination entity of a half-step (the reference's chunked
scatter-add of outer products, not a Pallas kernel), over the ratings
sorted stably by destination once a fit (:func:`als_order`): float32 on
the tensor cores (each operand split in two TF32 parts, three products),
float64 on float64 FMAs. And so does ``serving_margins``
(``csrc/serving_margins.cu``), the model server's linear margins of K
models over a bucket of request rows (the reference's jnp predict kernels
``serving/servable.py:67-117``, not Pallas kernels): tiles of request rows
by margin rows staged through shared memory, or one warp an output where
that measured faster (:func:`serving_margins_plan`), every output summed
in an order that depends on neither the bucket, K nor the tile, so that
padding a batch and serving models as a gang leave a row's bits
unchanged; its plain twin gives the same bits. And so does ``tree_hist``
(``csrc/tree_hist.cu``), the decision-tree engine's level histogram (the
reference's scatter-add ``ml/tree/impl.py:451``, not a Pallas kernel):
each tree's rows sorted stably by node and cut into pieces on the card,
then one CTA a (piece, feature block), each lane adding its own rows into
its own shared-memory copy of the table (or, for the widths whose copies
do not fit, each lane its bins' rows), and the pieces added in piece
order.

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

K1, K2 and K1s take any d: up to 2,048 columns their narrow instances,
then their wide instances (K1/K2 up to 12,288: a row's slots over a CTA's
512 threads; K1s up to 8,192: the columns over a cluster of 4 or 8 CTAs),
each one read of X; past those, and for K1s on float32 X past 2,048,
their two-pass instances (two passes over X by column block;
:func:`glm_sweep_instance` names the instance a width takes).

Each wrapper launches its kernel for a CUDA tensor and runs its ``*_plain``
version only for a tensor that lies on the CPU. There is no fallback from
one to the other: a CUDA tensor the kernel cannot take raises. Each wrapper
counts its launches in ``<wrapper>.launches`` (``glm_sweep`` also by link,
in ``glm_sweep.launches_by_link``, by X's dtype, in
``glm_sweep.launches_by_dtype``, and by width, in
``glm_sweep.launches_by_width``; K1s, one launch per group of models, by
X's dtype in ``glm_sweep_stacked.launches_by_dtype``, by instance in
``glm_sweep_stacked.launches_by_instance`` and by width in
``glm_sweep_stacked.launches_by_width``; K3 and K4 also by instance, in
``kmeans_assign.launches_by_instance`` and ``gramian.launches_by_instance``;
the center sums by instance in ``center_sums.launches_by_instance``;
S1 by link in ``ell_rows.launches_by_link`` and S2 by mode in
``ell_cols.launches_by_mode``; ALS's normal equations in
``als_normal.launches``, one a half-step, and by instance in
``als_normal.launches_by_instance``; the serving margins, counted under a
lock since lanes launch from their own threads, in
``serving_margins.launches`` and ``serving_margins.launches_by_instance``,
each replay of a bucket's CUDA graph one launch); the tree histogram in
``tree_hist.launches``, one a launch of a group of trees (every tree of a
forest level while rows x trees stay below 2^31), and by instance in
``tree_hist.launches_by_instance``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

ROW_CHUNK = 1 << 16  # rows upcast at a time by the plain versions
GRAM_CHUNK = 1 << 13  # rows per product in the plain Gramian

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
TENSOR_CORE, FMA = "tensor_core", "fma"
# the instance of K1s, K3 and K4 that each dtype of X launches (the C entry
# points pick by the same dtype code)
INSTANCE = {torch.float32: FMA, torch.bfloat16: TENSOR_CORE,
            torch.float8_e4m3fn: TENSOR_CORE}


def kernel_mode(ctx) -> str:
    """``cyclone.ml.usePallasKernels`` of ``ctx``, lower case: 'true',
    'false' or 'auto' (also when ``ctx`` carries no configuration)."""
    from cycloneml_tpu_torch.conf import USE_PALLAS_KERNELS
    conf = getattr(ctx, "conf", None)
    return str(conf.get(USE_PALLAS_KERNELS)).lower() if conf is not None \
        else "auto"


def use_fused_kernels(ctx, x: Optional[torch.Tensor] = None) -> bool:
    """Whether the eligible dense sweeps go through the hand-written
    kernels: ``cyclone.ml.usePallasKernels`` 'true'/'false' force one path
    (the key keeps the reference's name, so configurations carry over);
    'auto' (default) says yes when the data ``x`` lives on CUDA in a dtype
    the kernels read (float32, bfloat16 or float8_e4m3fn codes)."""
    mode = kernel_mode(ctx)
    if mode == "true":
        return True
    if mode == "false":
        return False
    return (x is not None and x.device.type == "cuda"
            and x.dtype in _DTYPE_CODE)


# -- K1: the GLM row sweep ----------------------------------------------------

NARROW, WIDE, TWO_PASS = "narrow", "wide", "two_pass"
NARROW_MAX_D = 2048  # the narrow instances' widest d (csrc/glm_sweep.cu,
                     # csrc/glm_stacked.cu: glm_*_max_d)
WIDE_MAX_D = 12288   # the one-read wide K1/K2's widest d
                     # (glm_sweep_wide_max_d)
STACKED_WIDE_MAX_D = 8192  # the one-read wide K1s's widest d
                           # (glm_stacked_wide_max_d)


def glm_sweep_instance(dtype: torch.dtype, d: int,
                       stacked: bool = False) -> str:
    """The instance of K1 and K2 (of K1s with ``stacked=True``) that a
    CUDA X of ``dtype`` and width ``d`` launches. Each reads X once up to
    :data:`WIDE_MAX_D` columns (K1s: :data:`STACKED_WIDE_MAX_D`):
    :data:`NARROW` up to :data:`NARROW_MAX_D` (a row's slots held by one
    warp's lanes), :data:`WIDE` past it (a row's slots spread over a CTA's
    threads, or K1s's columns over a cluster of CTAs). Past those bounds,
    and for K1s on float32 X past :data:`NARROW_MAX_D`, :data:`TWO_PASS`:
    two passes over X by column block. The C entry points route by the
    same bounds."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"glm_sweep: no kernel reads X of {dtype}")
    if d < 1:
        raise ValueError(f"glm_sweep: X needs at least one column, got {d}")
    if d <= NARROW_MAX_D:
        return NARROW
    if stacked:
        if d <= STACKED_WIDE_MAX_D and INSTANCE[dtype] == TENSOR_CORE:
            return WIDE
    elif d <= WIDE_MAX_D:
        return WIDE
    return TWO_PASS


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
_D = ctypes.c_double
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
        "center_sums_launch": [_I, _I, _P, _P, _P, _LL, _I, _LL, _I, _LL,
                               _P, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    },
    "ell_sweep": {
        "ell_row_blocks": [_LL],
        "ell_piece_entries": [],
        "ell_max_hot_slots": [],
        "ell_rows_launch": [_I, _I, _P, _P, _LL, _I, _P, _P, _P, _P, _P, _P,
                            _P, _P, _P, _I, _P, _I, _P, _P],
        "ell_cols_launch": [_I, _P, _P, _P, _LL, _P, _I, _P, _P, _P, _P, _P,
                            _P, _P],
    },
    "als_normal": {
        "als_normal_launch": [_I, _I, _I, _P, _I, _P, _P, _P, _P, _P, _P,
                              _LL, _I, _P, _I, _D, _D, _P, _P, _P, _P, _P,
                              _P],
    },
    "serving_margins": {
        "serving_margins_launch": [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _P, _P],
        "serving_margins_plan": [_I, _I, _I, _I, _I, _P],
    },
    "tree_hist": {
        "tree_hist_plan": [_I, _I, _I, _I, _P],
        "tree_keys_launch": [_P, _I, _I, _LL, _I, _I, _P, _P],
        "tree_hist_launch": [_P, _I, _LL, _P, _LL, _LL, _P, _P, _LL, _LL, _LL,
                             _LL, _I, _I, _I, _I, _I, _P, _P, _P, _P, _I,
                             _P],
    },
}


def _entry(lib: ctypes.CDLL, fn: str, argtypes):
    """An entry point declared at its call and not in _SIGNATURES: an
    older build of the source without it (glm_phases.py --parent) still
    loads."""
    f = getattr(lib, fn)
    f.argtypes, f.restype = argtypes, _I
    return f


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


class CudaError(RuntimeError):
    """A kernel entry point returned a CUDA error; ``code`` is its
    cudaError_t (``parallel.resilience`` classifies the codes that poison
    the context as permanent)."""

    def __init__(self, what: str, code: int):
        super().__init__(f"{what} failed with CUDA error {code}")
        self.code = int(code)


def _cuda_check(rc: int, what: str) -> None:
    if rc != 0:
        raise CudaError(what, rc)


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


# the sweep's CTA count by (library, device, dtype, link, d, n, two-pass):
# the occupancy query behind it is asked once, not per sweep
_GLM_PARTS: Dict[tuple, int] = {}


def _glm_parts(lib, dev, code: int, lcode: int, d: int, n: int,
               two_pass: bool = False) -> int:
    key = (id(lib), dev.index, code, lcode, d, n, two_pass)
    parts = _GLM_PARTS.get(key)
    if parts is None:
        out = ctypes.c_int(0)
        fn = _entry(lib, "glm_sweep_two_pass_parts", [_I, _I, _I, _LL, _PI]) \
            if two_pass else lib.glm_sweep_num_parts
        _cuda_check(fn(code, lcode, d, n, ctypes.byref(out)),
                    "glm_sweep_num_parts")
        parts = _GLM_PARTS[key] = out.value
    return parts


def glm_sweep_plan(dtype: torch.dtype, link: str, d: int,
                   device=None) -> Dict[str, int]:
    """The kernel instance a CUDA sweep of X ``(n, d)`` of ``dtype``
    launches, on ``device`` (the current CUDA device by default). A narrow
    instance: its ring stages ``S``, its block rows ``R``, its dynamic
    shared memory in bytes and its CTAs resident on one SM. The wide
    instance (one read, d <= :data:`WIDE_MAX_D`): ``instance="wide"`` and
    the same four, the rows of a tile and a CTA's threads. The two-pass
    instance: ``instance="two_pass"``, its block rows, the rows a warp or
    thread has in flight, a gradient CTA's columns, and the CTAs of its
    margin and gradient kernels resident on one SM."""
    lib = _library("glm_sweep")
    inst = glm_sweep_instance(dtype, d)
    fn = _entry(lib, "glm_sweep_two_pass_plan" if inst == TWO_PASS
                else "glm_sweep_plan", [_I, _I, _I, _PI])
    plan = (ctypes.c_int * 6)()
    with torch.cuda.device(device if device is not None
                           else torch.cuda.current_device()):
        _cuda_check(fn(_DTYPE_CODE[dtype], _LINK_CODE[link], d, plan),
                    "glm_sweep_plan")
    if inst == TWO_PASS:
        return {"instance": TWO_PASS, "block_rows": plan[0],
                "group_rows": plan[1], "column_block": plan[2],
                "margin_ctas_per_sm": plan[3],
                "gradient_ctas_per_sm": plan[4]}
    out = {"stages": plan[0], "block_rows": plan[1], "smem_bytes": plan[2],
           "ctas_per_sm": plan[3]}
    if inst == WIDE:
        out = {"instance": WIDE, **out, "group_rows": plan[4],
               "threads": plan[5]}
    return out


def glm_sweep(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
              beta: torch.Tensor, off, link: str = LOGISTIC, ys=0.0,
              x_scale=None) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor]:
    """K1 (``link="logistic"``) and K2 (``link="squared"``, label scale
    ``ys``): ``(loss, grad_row (d,), sum(mult), sum(w))`` in float32 for X
    ``(n, d)`` at storage width, y, w ``(n,)``, beta ``(d,)`` and the
    margin offset ``off`` (a scalar or 0-d tensor); the value of X is
    ``x * x_scale`` when the scale is given. A CPU tensor runs
    :func:`glm_sweep_plain`; a CUDA tensor launches the instance
    :func:`glm_sweep_instance` names or raises.

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
    return _sweep(x, y, w, beta, off, link, ys, x_scale,
                  glm_sweep_instance(x.dtype, x.shape[1]))


def _sweep(x, y, w, beta, off, link: str, ys, x_scale, instance: str):
    """One launch of ``instance`` on a CUDA X (checked by the caller),
    counted in :func:`glm_sweep`'s counts under ``instance``;
    :func:`glm_sweep` routes by width. The two-pass instance takes any d
    past :data:`NARROW_MAX_D`, so that a script can time it beside the
    one-read instance at the same width."""
    n, d = x.shape
    lib = _library("glm_sweep")
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
        two_pass = instance == TWO_PASS
        parts = _glm_parts(lib, dev, code, lcode, d, n, two_pass)
        partials = torch.empty(parts * (d + 3), dtype=torch.float64,
                               device=dev)
        out = torch.empty(d + 3, dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if not two_pass:
            _cuda_check(lib.glm_sweep_launch(
                code, lcode, x.data_ptr(), y.data_ptr(), w.data_ptr(),
                beta.data_ptr(), scalars.data_ptr(), n, d,
                partials.data_ptr(), parts, out.data_ptr(), stream),
                "glm_sweep launch")
        else:
            # beta zero-padded to whole 8-column slots; the multipliers'
            # (n,) scratch between the margin and gradient passes
            beta8 = torch.zeros(-(-d // 8) * 8, dtype=torch.float32,
                                device=dev)
            beta8[:d] = beta
            mult = torch.empty(max(n, 1), dtype=torch.float32, device=dev)
            launch = _entry(lib, "glm_sweep_two_pass_launch",
                            [_I, _I, _P, _P, _P, _P, _P, _LL, _I, _P, _I, _P,
                             _P, _P])
            _cuda_check(launch(
                code, lcode, x.data_ptr(), y.data_ptr(), w.data_ptr(),
                beta8.data_ptr(), scalars.data_ptr(), n, d,
                partials.data_ptr(), parts, mult.data_ptr(), out.data_ptr(),
                stream), "glm_sweep two-pass launch")
    glm_sweep.launches += 1
    glm_sweep.launches_by_link[link] += 1
    glm_sweep.launches_by_dtype[x.dtype] += 1
    glm_sweep.launches_by_width[instance] += 1
    grad_row = out[:d] if s is None else out[:d] * s
    return out[d], grad_row, out[d + 1], out[d + 2]


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    glm_sweep.launches = 0
    glm_sweep.launches_by_link = {LOGISTIC: 0, SQUARED: 0}
    glm_sweep.launches_by_dtype = {dt: 0 for dt in _DTYPE_CODE}
    glm_sweep.launches_by_width = {NARROW: 0, WIDE: 0, TWO_PASS: 0}
    kmeans_assign.launches = 0
    kmeans_assign.launches_by_instance = {TENSOR_CORE: 0, FMA: 0}
    gramian.launches = 0
    gramian.launches_by_instance = {TENSOR_CORE: 0, FMA: 0}
    glm_sweep_stacked.launches = 0
    glm_sweep_stacked.launches_by_dtype = {dt: 0 for dt in _DTYPE_CODE}
    glm_sweep_stacked.launches_by_instance = {TENSOR_CORE: 0, FMA: 0}
    glm_sweep_stacked.launches_by_width = {NARROW: 0, WIDE: 0, TWO_PASS: 0}
    center_sums.launches = 0
    center_sums.launches_by_instance = {COUNTING: 0, SORTED: 0}
    _center_order.launches = 0
    ell_rows.launches = 0
    ell_rows.launches_by_link = {link: 0 for link in _ELL_LINK_CODE}
    ell_cols.launches = 0
    ell_cols.launches_by_mode = {GRADIENT: 0, MOMENTS: 0}
    als_normal.launches = 0
    als_normal.launches_by_instance = {TENSOR_CORE: 0, FMA: 0}
    with _SERVING_LOCK:
        serving_margins.launches = 0
        serving_margins.launches_by_instance = {
            serving_instance(dt, q): 0
            for dt in _SERVING_DTYPE_CODE for q in (False, True)}
    tree_hist.launches = 0
    tree_hist.launches_by_instance = {LANE_A_ROW: 0, LANE_A_BIN: 0}


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
    on the tensor cores past d = 1280 up to 2048 (where sixteen models'
    parts leave no room for two stages of X) and in the two-pass instance
    past :data:`STACKED_WIDE_MAX_D`. The wide tensor-core instance (a
    cluster of CTAs, each with a slice of B's parts) takes 16. Asks the
    built kernel
    (CUDA only)."""
    lib = _library("glm_stacked")
    group = lib.glm_stacked_group(_DTYPE_CODE[dtype], d)
    if group < 1:
        raise ValueError(f"glm_sweep_stacked: no instance takes X of "
                         f"{dtype} at d={d}")
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
    runs :func:`glm_sweep_stacked_plain`; a CUDA tensor launches the
    instance ``glm_sweep_instance(dtype, d, stacked=True)`` names once per
    group of :func:`glm_sweep_stacked_group` models, each launch reading X
    once (twice in the two-pass instance), or raises. The scale is folded
    into B and into the gradient rows, as :func:`glm_sweep` folds it. bf16
    X and e4m3 codes launch the tensor-core instance, which takes each
    group's B split by :func:`split_bf16x3` and zero-padded to
    :data:`K1S_PAD` columns, and bf16 labels in pairs (a group of odd size
    or odd row stride goes over as float32 labels); float32 X the FMA
    instance, which takes B as it is."""
    if x.device.type == "cpu":
        return glm_sweep_stacked_plain(x, Y, w, B, off, x_scale=x_scale)
    _check_x(x, "glm_sweep_stacked")
    return _stacked(x, Y, w, B, off, x_scale,
                    glm_sweep_instance(x.dtype, x.shape[1], stacked=True),
                    glm_sweep_stacked_group(x.dtype, x.shape[1]))


def _stacked(x, Y, w, B, off, x_scale, width: str, group: int):
    """The launches of ``width`` on a CUDA X (checked by the caller), one
    per group of ``group`` models, each counted in
    :func:`glm_sweep_stacked`'s counts under ``width``;
    :func:`glm_sweep_stacked` routes by width. The two-pass instance takes
    any d past :data:`NARROW_MAX_D` (with groups of 8 on the tensor
    cores), so that a script can time it beside the one-read instance at
    the same width."""
    n, d = x.shape
    lib = _library("glm_stacked")
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
    d_pad = -(-d // K1S_PAD) * K1S_PAD
    loss = torch.empty(k, dtype=torch.float32, device=dev)
    grad = torch.empty((k, d), dtype=torch.float32, device=dev)
    msum = torch.empty(k, dtype=torch.float32, device=dev)
    wsum = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for k0 in range(0, k, group):
            kg = min(group, k - k0)
            out = torch.empty(kg * (d + 2) + 1, dtype=torch.float32,
                              device=dev)
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
            args = (code, x.data_ptr(), y_ptr, yb, ldy, w.data_ptr(),
                    bg.data_ptr(), og.data_ptr(), n, d, kg)
            if width == TWO_PASS:
                _stacked_two_pass(lib, args, n, d, kg, out, stream)
            else:
                _stacked_one_read(lib, args, n, d, kg, out, stream)
            glm_sweep_stacked.launches += 1
            glm_sweep_stacked.launches_by_dtype[x.dtype] += 1
            glm_sweep_stacked.launches_by_instance[instance] += 1
            glm_sweep_stacked.launches_by_width[width] += 1
            body = out[:kg * (d + 2)].view(kg, d + 2)
            grad[k0:k0 + kg] = body[:, :d]
            loss[k0:k0 + kg] = body[:, d]
            msum[k0:k0 + kg] = body[:, d + 1]
            wsum = out[-1]
    if s is not None:
        grad = grad * s
    return loss, grad, msum, wsum


# K1s's partial rows by (library, device, dtype, d, kg, n): the occupancy
# query behind them (clusters resident at once, for the wide instance) is
# asked once, not per launch
_STACKED_PARTS: Dict[tuple, int] = {}


def _stacked_one_read(lib, args, n: int, d: int, kg: int, out,
                      stream) -> None:
    """One launch of a K1s instance that reads X once, narrow or wide
    (``args``: dtype code through kg of ``glm_stacked_launch``)."""
    code, dev = args[0], out.device
    key = (id(lib), dev.index, code, d, kg, n)
    parts = _STACKED_PARTS.get(key)
    if parts is None:
        got = ctypes.c_int(0)
        _cuda_check(lib.glm_stacked_num_parts(code, d, kg, n,
                                              ctypes.byref(got)),
                    "glm_stacked_num_parts")
        parts = _STACKED_PARTS[key] = got.value
    # scratch: one double partial row per CTA (per cluster of the wide
    # instance), as many as are resident whatever n
    partials = torch.empty(parts * (kg * (d + 2) + 1), dtype=torch.float64,
                           device=dev)
    _cuda_check(lib.glm_stacked_launch(*args, partials.data_ptr(), parts,
                                       out.data_ptr(), stream),
                "glm_stacked launch")


def _stacked_two_pass(lib, args, n: int, d: int, kg: int, out,
                      stream) -> None:
    """One launch of the two-pass K1s instance (d > 2048): the (n, kg)
    multipliers between its two passes, the margin CTAs' scalar rows and
    the row slabs' gradient rows (one slab per SM) as scratch."""
    code, dev = args[0], out.device
    ctas, slabs = ctypes.c_int(0), ctypes.c_int(0)
    _cuda_check(_entry(lib, "glm_stacked_two_pass_parts",
                       [_I, _I, _I, _LL, _PI, _PI])(
        code, d, kg, n, ctypes.byref(ctas), ctypes.byref(slabs)),
        "glm_stacked_two_pass_parts")
    mult = torch.empty(max(n, 1) * kg, dtype=torch.float32, device=dev)
    mpart = torch.empty(ctas.value * (2 * kg + 1), dtype=torch.float64,
                        device=dev)
    gpart = torch.empty(slabs.value * kg * d, dtype=torch.float64,
                        device=dev)
    launch = _entry(lib, "glm_stacked_two_pass_launch",
                    [_I, _P, _P, _I, _LL, _P, _P, _P, _LL, _I, _I, _P, _P,
                     _I, _P, _I, _P, _P])
    _cuda_check(launch(*args, mult.data_ptr(), mpart.data_ptr(), ctas.value,
                       gpart.data_ptr(), slabs.value, out.data_ptr(),
                       stream), "glm_stacked two-pass launch")


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
COUNTING, SORTED = "counting", "sorted"
PIECE_ROWS = 2048        # sorted rows of one piece, at most (kPieceRows)
SORT_ROWS = 1 << 14      # rows of one block of the counting sort's table
SORT_WARP_ROWS = SORT_ROWS // 8  # rows of one warp's run (kWarpRows)
COUNT_MAX_K = 4096       # the counting instance's largest k (kCountMaxK)
# the stages of a launch (csrc/center_sums.cu's bits): the histogram, the
# scans, the scatter (the counting sort), the pieces' sums, the reduce
_HIST, _SCAN, _SCATTER, _PIECES, _REDUCE = 1, 2, 4, 8, 16
_STAGES_ORDER = _HIST | _SCAN | _SCATTER
_STAGES_SUMS = _PIECES | _REDUCE
_STAGES_ALL = _STAGES_ORDER | _STAGES_SUMS


class CenterOrder(NamedTuple):
    """The rows sorted stably by cluster and the clusters' offsets:
    cluster c's rows are ``order[offsets[c]:offsets[c + 1]]`` in row order,
    its pieces (of at most :data:`PIECE_ROWS` sorted rows) are
    ``piece_start[c]`` to ``piece_start[c + 1]``. Rows outside [0, k) are
    left out: only the first ``offsets[k]`` entries of ``order`` are
    set."""
    order: torch.Tensor        # (n,) int32
    offsets: torch.Tensor      # (k + 1,) int64
    piece_start: torch.Tensor  # (k + 1,) int64


def center_sums_instance(k: int) -> str:
    """The instance of the center sums that ``k`` clusters launch:
    :data:`COUNTING` (a stable counting sort written for the card) up to
    :data:`COUNT_MAX_K`, where its per-warp counters fit a CTA's shared
    memory; past it :data:`SORTED` (``torch.sort`` of the assignment).
    Both run the same sums on the same order: their results are bitwise
    equal."""
    if k < 1:
        raise ValueError(f"center_sums: k must be at least 1, got {k}")
    return COUNTING if k <= COUNT_MAX_K else SORTED


def center_order_plain(best: torch.Tensor, k: int,
                       block_rows: int = SORT_ROWS,
                       warp_rows: int = SORT_WARP_ROWS) -> CenterOrder:
    """The counting sort of ``csrc/center_sums.cu`` in plain PyTorch, step
    for step: each block of ``block_rows`` rows counted per cluster, the
    (cluster, block) table scanned in that order, and each row ranked in
    its block after the rows of the earlier warp runs (``warp_rows`` rows
    each) and, in its run, after the earlier rounds of 32 rows and the
    lower lanes of its own. Rows outside [0, k) are left out. The result is
    ``torch.sort(best, stable=True)``'s order of the rows kept."""
    i64 = torch.int64
    b = best.to(i64)
    n = b.shape[0]
    dev = b.device
    nb = -(-n // block_rows)
    per = block_rows // warp_rows
    valid = (b >= 0) & (b < k)
    c = torch.where(valid, b, torch.zeros_like(b))
    row = torch.arange(n, device=dev)
    run = row // warp_rows  # the warp run of each row (block * per + warp)
    # the histogram: each warp run's rows per cluster, then the blocks'
    runs = torch.zeros((nb * per, k), dtype=i64, device=dev)
    runs.index_put_((run[valid], c[valid]), torch.ones_like(c[valid]),
                    accumulate=True)
    by_run = runs.view(nb, per, k)
    table = by_run.sum(1).T.contiguous()  # (k, nb): the (cluster, block) table
    # the scan in (cluster, block) order, and the clusters' offsets
    flat = table.view(-1)
    start = (torch.cumsum(flat, 0) - flat).view(k, nb)  # of (c, block)
    rows = table.sum(1)
    offsets = torch.zeros(k + 1, dtype=i64, device=dev)
    offsets[1:] = torch.cumsum(rows, 0)
    pieces = torch.zeros(k + 1, dtype=i64, device=dev)
    pieces[1:] = torch.cumsum((rows + PIECE_ROWS - 1) // PIECE_ROWS, 0)
    # each warp run's first position per cluster: its block's, after the
    # block's earlier runs
    before = torch.cumsum(by_run, 1) - by_run          # (nb, per, k)
    cur = (start.T[:, None, :] + before).reshape(nb * per, k)
    # the rounds: lane l of round j of every run at once
    order = torch.full((n,), -1, dtype=torch.int32, device=dev)
    lower = torch.tril(torch.ones(32, 32, dtype=torch.bool, device=dev), -1)
    n_runs = nb * per
    run_ids = torch.arange(n_runs, device=dev)
    for j in range(0, warp_rows, 32):
        r = run_ids[:, None] * warp_rows + j + torch.arange(32, device=dev)
        live = r < n
        rc = r.clamp(max=max(n - 1, 0))
        ok = live & valid[rc] if n else live
        cl = torch.where(ok, c[rc], torch.full_like(rc, -1))
        same = (cl[:, :, None] == cl[:, None, :]) & ok[:, None, :]
        rank = (same & lower).sum(2)                   # lower lanes alike
        pos = cur[run_ids[:, None].expand_as(cl), cl.clamp(min=0)] + rank
        order[pos[ok]] = r[ok].to(torch.int32)
        cur.index_put_((run_ids[:, None].expand_as(cl)[ok], cl[ok]),
                       torch.ones_like(cl[ok]), accumulate=True)
    return CenterOrder(order, offsets, pieces)


def center_sums_pieces_plain(x: torch.Tensor, w: torch.Tensor,
                             co: CenterOrder, k: int, with_sums: bool = True,
                             out_dtype: Optional[torch.dtype] = None
                             ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """The kernels' summation order in plain PyTorch: the rows of each
    piece of ``co`` (:func:`center_order_plain`) in their sorted order, the
    product w x at w's width summed per column into a double, row after
    row, and the weights likewise; then each cluster's pieces in piece
    order. Returns ``(sums (k, d) or None, counts (k,))`` at ``out_dtype``
    (default w's width; float64 gives the double sums themselves)."""
    f64 = torch.float64
    dev = x.device
    n_pieces = int(co.piece_start[k])
    d = x.shape[1] if with_sums else 0
    rows = co.offsets[1:] - co.offsets[:-1]
    # each piece's cluster, first sorted position and length
    cl = torch.repeat_interleave(torch.arange(k, device=dev),
                                 co.piece_start[1:] - co.piece_start[:-1])
    first = co.offsets[cl] + (torch.arange(n_pieces, device=dev)
                              - co.piece_start[cl]) * PIECE_ROWS
    length = torch.minimum(rows[cl] + co.offsets[cl] - first,
                           torch.full_like(first, PIECE_ROWS))
    acc = torch.zeros((n_pieces, d + 1), dtype=f64, device=dev)
    order = co.order.to(torch.int64)
    for i in range(int(length.max()) if n_pieces else 0):
        live = i < length
        r = order[(first + i)[live]]
        wr = w[r]
        if d:
            acc[live, :d] += (x[r].to(w.dtype) * wr[:, None]).to(f64)
        acc[live, d] += wr.to(f64)
    out = torch.zeros((k, d + 1), dtype=f64, device=dev)
    for j in range(int((co.piece_start[1:] - co.piece_start[:-1]).max())
                   if n_pieces else 0):
        p = co.piece_start[:-1] + j
        live = p < co.piece_start[1:]
        out[live] += acc[p[live]]
    out = out.to(w.dtype if out_dtype is None else out_dtype)
    return (out[:, :d] if with_sums else None), out[:, d]


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


class _Scratch(NamedTuple):
    """What one launch of ``csrc/center_sums.cu`` writes: the counting
    sort's (cluster, block) table and clusters' rows (None for the sorted
    instance), the order and offsets, and (with X) the pieces' partials
    and the double sums."""
    table: Optional[torch.Tensor]     # (k * ceil(n / SORT_ROWS),) int32
    rows: Optional[torch.Tensor]      # (k,) int32
    order: CenterOrder
    partials: Optional[torch.Tensor]  # (max_pieces * (n_cols + 1),) double
    sums: Optional[torch.Tensor]      # (k, n_cols) double
    counts: Optional[torch.Tensor]    # (k,) double


def _scratch(n: int, k: int, dev, n_cols: Optional[int] = None,
             co: Optional[CenterOrder] = None) -> _Scratch:
    """The scratch of a launch for n rows and k clusters: the counting
    sort's, or ``co`` (the sorted instance's order) in its place; the
    sums' buffers for ``n_cols`` summed columns (None: the order alone)."""
    table = rows = None
    if co is None:
        nb = -(-n // SORT_ROWS)
        ints = torch.empty(k * nb + k + n, dtype=torch.int32, device=dev)
        longs = torch.empty(2 * (k + 1), dtype=torch.int64, device=dev)
        table, rows = ints[:k * nb], ints[k * nb:k * nb + k]
        co = CenterOrder(ints[k * nb + k:], longs[:k + 1], longs[k + 1:])
    if n_cols is None:
        return _Scratch(table, rows, co, None, None, None)
    max_pieces = -(-n // PIECE_ROWS) + k
    f64 = torch.float64
    return _Scratch(
        table, rows, co,
        torch.empty(max_pieces * (n_cols + 1), dtype=f64, device=dev),
        torch.empty((k, n_cols), dtype=f64, device=dev),
        torch.empty(k, dtype=f64, device=dev))


def _launch(sc: _Scratch, k: int, stages: int,
            best: Optional[torch.Tensor] = None,
            x: Optional[torch.Tensor] = None,
            w: Optional[torch.Tensor] = None) -> None:
    """One call of ``csrc/center_sums.cu``'s entry point on ``sc`` with
    ``stages``, its bits (a stage reads what the earlier ones left in
    ``sc``): ``best`` (int32, contiguous) only with the sort's stages, X
    and w only with the sums'."""
    n = sc.order.order.shape[0]
    if stages & _STAGES_ORDER:
        if k > COUNT_MAX_K:
            raise ValueError(f"center_sums: k = {k} is past the counting "
                             f"sort's {COUNT_MAX_K} clusters")
        if best.dtype != torch.int32 or not best.is_contiguous():
            raise ValueError("center_sums: the counting sort reads a "
                             "contiguous int32 assignment")
    if x is None:
        head, ld, n_cols = (0, 0, None, None), 0, 0
    else:
        head = (_SUM_DTYPE_CODE[x.dtype], _SUM_DTYPE_CODE[w.dtype],
                x.data_ptr(), w.data_ptr())
        ld, n_cols = x.stride(0), sc.sums.shape[1]
    ptrs = [None if t is None else t.data_ptr() for t in (
        best, sc.table, sc.rows, sc.order.order, sc.order.offsets,
        sc.order.piece_start, sc.partials, sc.sums, sc.counts)]
    max_pieces = -(-n // PIECE_ROWS) + k
    dev = sc.order.order.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _cuda_check(_library("center_sums").center_sums_launch(
            *head, ptrs[0], n, k, ld, n_cols, max_pieces, *ptrs[1:], stages,
            stream), "center_sums launch")


def _center_order(best: torch.Tensor, k: int) -> CenterOrder:
    """The rows sorted stably by cluster (``best`` (n,) in [0, k)) with the
    clusters' row and piece offsets: on a CUDA tensor the counting sort of
    ``csrc/center_sums.cu`` alone (its histogram, scans and scatter, for k
    up to :data:`COUNT_MAX_K`; counted in ``_center_order.launches``), on a
    CPU tensor :func:`center_order_plain`. The order is
    ``torch.sort(best, stable=True)``'s."""
    if best.device.type == "cpu":
        return center_order_plain(best, k)
    best = best.to(dtype=torch.int32).contiguous()
    sc = _scratch(best.shape[0], k, best.device)
    _launch(sc, k, _STAGES_ORDER, best)
    _center_order.launches += 1
    return sc.order


def center_sums(x: torch.Tensor, w: torch.Tensor, best: torch.Tensor, k: int,
                with_sums: bool = True
                ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """KMeans' center sums at w's (accumulator) width: ``(sums (k, d) of
    w x, or None without with_sums; counts (k,) of w)`` over the rows
    assigned to each of the k clusters by ``best`` (n,). A CPU tensor runs
    :func:`center_sums_plain`; a CUDA tensor launches ``csrc/center_sums.cu``
    (X at its storage width, float32, bfloat16 or float64), whose sums run
    in one fixed order with no float atomics: two calls on the same inputs
    are bitwise equal. The instance (:func:`center_sums_instance`) sorts
    ``best`` stably by a counting sort of its own (:data:`COUNTING`) or by
    ``torch.sort`` (:data:`SORTED`), counted in
    ``center_sums.launches_by_instance``."""
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
    if n >= 2 ** 31:
        raise ValueError(f"center_sums: {n} rows exceed the int32 order")
    n_cols = d if with_sums else 0
    if center_sums_instance(k) == SORTED:
        sums, counts = _sorted_launch(x, w, best, k, n_cols)
    else:
        best = best.to(device=dev, dtype=torch.int32).contiguous()
        sc = _scratch(n, k, dev, n_cols)
        _launch(sc, k, _STAGES_ALL, best, x, w)
        center_sums.launches += 1
        center_sums.launches_by_instance[COUNTING] += 1
        sums, counts = sc.sums, sc.counts
    return (sums.to(w.dtype) if with_sums else None), counts.to(w.dtype)


def center_order_sorted(best: torch.Tensor, k: int) -> CenterOrder:
    """The sorted instance's bookkeeping (on any device): the assignment
    sorted stably by ``torch.sort``, its indices cast to int32, the
    clusters' row and piece offsets by ``bincount`` and ``cumsum``;
    integer results, the same on every run."""
    best = best.to(torch.int64)
    dev = best.device
    order = torch.sort(best, stable=True).indices.to(torch.int32)
    rows = torch.bincount(best, minlength=k)[:k]
    offsets = torch.zeros(k + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(rows, 0)
    pieces = torch.zeros(k + 1, dtype=torch.int64, device=dev)
    pieces[1:] = torch.cumsum((rows + PIECE_ROWS - 1) // PIECE_ROWS, 0)
    return CenterOrder(order, offsets, pieces)


def _sorted_launch(x, w, best, k, n_cols):
    """The sorted instance (any k; :func:`center_sums` takes it past
    :data:`COUNT_MAX_K`): :func:`center_order_sorted`, then the same sums
    as the counting instance's on its order. Returns the double sums and
    counts."""
    co = center_order_sorted(best.to(x.device), k)
    sc = _scratch(x.shape[0], k, x.device, n_cols, co)
    _launch(sc, k, _STAGES_SUMS, None, x, w)
    center_sums.launches += 1
    center_sums.launches_by_instance[SORTED] += 1
    return sc.sums, sc.counts


# -- S1 and S2: the sparse (ELL) tier's row and column passes ----------------

GRAM, HINGE = "gram", "hinge"
GRADIENT, MOMENTS = "gradient", "moments"
_ELL_LINK_CODE = {LOGISTIC: 0, SQUARED: 1, HINGE: 2, GRAM: 3}
ELL_CHUNK = 1 << 18  # rows the plain versions take at a time
ELL_PIECE = 1024     # nonzeros of one S2 piece, at most (csrc/ell_sweep.cu)
ELL_BLOCK_ROWS = 1 << 22  # rows of one block of the column copy (16.8 MB of
                          # mult: one block's slice of r stays in L2)
ELL_HOT_SLOTS = 2048      # S1's shared-memory table of hot columns


class EllTail(NamedTuple):
    """A hybrid dataset's COO tail grouped by row: the entries of row r are
    ``cols[ptr[r]:ptr[r + 1]]`` and ``vals[...]``, in their stored order."""
    ptr: torch.Tensor   # (n + 1,) int64
    cols: torch.Tensor  # int32
    vals: torch.Tensor  # float32


class EllColumns(NamedTuple):
    """The nonzeros in (row block, column, row) order, S2's operand. Row
    block b, rows ``[b R, (b + 1) R)`` with R = ``block_rows``, holds
    ``rows[block_ptr[b]:block_ptr[b + 1]]`` and their ``vals``, sorted by
    column, rows ascending inside a column (the COO tail's entries after
    the ELL ones). Each (block, column) segment is cut into pieces of at
    most ``piece`` entries, numbered in storage order: piece p holds
    entries ``piece_ptr[p]:piece_ptr[p + 1]``, all of column
    ``piece_col[p]``, and its partial sum goes to slot ``piece_slot[p]``;
    column c's slots are ``slot_ptr[c]:slot_ptr[c + 1]``, in block
    order."""
    rows: torch.Tensor        # (nnz,) int32
    vals: torch.Tensor        # (nnz,) float32
    block_ptr: torch.Tensor   # (n_blocks + 1,) int64
    piece_ptr: torch.Tensor   # (n_pieces + 1,) int64
    piece_col: torch.Tensor   # (n_pieces,) int32
    piece_slot: torch.Tensor  # (n_pieces,) int32
    slot_ptr: torch.Tensor    # (d + 1,) int64
    block_rows: int
    piece: int


def column_counts(columns: EllColumns, d: int) -> torch.Tensor:
    """The nonzeros of each column (int64, (d,)) in a column copy."""
    return torch.zeros(d, dtype=torch.int64,
                       device=columns.rows.device).index_add_(
        0, columns.piece_col.long(), columns.piece_ptr.diff())


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


def _nonzero_chunks(indices, values, tail, chunk_rows, lo, hi):
    """(columns int64, rows int32, values) of the nonzeros of rows
    ``lo:hi``: the ELL rows a chunk at a time in row-major order, then the
    COO tail's entries of those rows."""
    k = indices.shape[1]
    dev = indices.device
    for a in range(lo, hi, chunk_rows):
        b = min(a + chunk_rows, hi)
        v = values[a:b].reshape(-1)
        keep = v != 0
        rows = torch.arange(a, b, dtype=torch.int32,
                            device=dev).repeat_interleave(k)
        yield indices[a:b].reshape(-1)[keep].long(), rows[keep], v[keep]
    if tail is not None:
        t0, t1 = int(tail.ptr[lo]), int(tail.ptr[hi])
        if t1 > t0:
            rows = torch.repeat_interleave(
                torch.arange(lo, hi, dtype=torch.int32, device=dev),
                tail.ptr[lo:hi + 1].diff())
            yield tail.cols[t0:t1].long(), rows, tail.vals[t0:t1]


def ell_columns(indices: torch.Tensor, values: torch.Tensor, d: int,
                tail: Optional[EllTail] = None, piece: int = ELL_PIECE,
                chunk_rows: int = 1 << 20,
                block_rows: int = ELL_BLOCK_ROWS) -> EllColumns:
    """The copy of the nonzeros of ELL rows ``indices``, ``values`` (n, k)
    (and of the COO ``tail``) that S2 reads, in (row block, column, row)
    order (:class:`EllColumns`): block by block, a counting sort by column
    a chunk of rows at a time (a stable sort inside the chunk), so entries
    of a column keep their row order and the scratch is bounded by the
    chunk. One block of at least n rows is the plain column order. Every
    step has an integer result: two builds are equal."""
    if block_rows < 1 or block_rows & (block_rows - 1):
        raise ValueError(f"ell_columns: block_rows must be a power of two, "
                         f"got {block_rows}")
    n = indices.shape[0]
    dev = indices.device
    bounds = [(lo, min(lo + block_rows, n))
              for lo in range(0, max(n, 1), block_rows)]
    # each block's nonzeros by column, then the layout they give
    counts = torch.zeros((len(bounds), d), dtype=torch.int64, device=dev)
    for b, (lo, hi) in enumerate(bounds):
        for cols, _, _ in _nonzero_chunks(indices, values, tail, chunk_rows,
                                          lo, hi):
            counts[b] += torch.bincount(cols, minlength=d)[:d]
    block_ptr = torch.zeros(len(bounds) + 1, dtype=torch.int64, device=dev)
    block_ptr[1:] = torch.cumsum(counts.sum(1), 0)
    pieces = (counts + piece - 1) // piece  # (blocks, d)
    slot_ptr = torch.zeros(d + 1, dtype=torch.int64, device=dev)
    slot_ptr[1:] = torch.cumsum(pieces.sum(0), 0)
    if int(slot_ptr[-1]) >= 2 ** 31:
        raise ValueError("ell_columns: more than 2^31 pieces")
    # column c's first slot in block b: its slots of earlier blocks first
    slot_base = slot_ptr[:-1] + torch.cumsum(pieces, 0) - pieces
    nnz = int(block_ptr[-1])
    rows_out = torch.empty(nnz, dtype=torch.int32, device=dev)
    vals_out = torch.empty(nnz, dtype=torch.float32, device=dev)
    starts, piece_col, piece_slot = [], [], []
    for b, (lo, hi) in enumerate(bounds):
        seg = int(block_ptr[b]) + torch.cumsum(counts[b], 0) - counts[b]
        fill = seg.clone()
        for cols, rows, vals in _nonzero_chunks(indices, values, tail,
                                                chunk_rows, lo, hi):
            order = torch.sort(cols, stable=True).indices
            sc = cols[order]
            cc = torch.bincount(cols, minlength=d)[:d]
            first = torch.cumsum(cc, 0) - cc  # each column's first slot
            dest = fill[sc] + (torch.arange(sc.shape[0], device=dev)
                               - first[sc])
            rows_out[dest] = rows[order]
            vals_out[dest] = vals[order].float()
            fill += cc
            del order, sc, dest
        cols_b = torch.nonzero(counts[b]).reshape(-1)
        reps = pieces[b, cols_b]
        at = torch.repeat_interleave(torch.cumsum(reps, 0) - reps, reps)
        j = torch.arange(int(reps.sum()), device=dev) - at  # piece in segment
        starts.append(torch.repeat_interleave(seg[cols_b], reps) + j * piece)
        piece_col.append(torch.repeat_interleave(cols_b, reps).int())
        piece_slot.append((torch.repeat_interleave(slot_base[b, cols_b], reps)
                           + j).int())
    piece_ptr = torch.cat(starts + [block_ptr[-1:]])
    return EllColumns(rows_out, vals_out, block_ptr, piece_ptr,
                      torch.cat(piece_col), torch.cat(piece_slot), slot_ptr,
                      block_rows, piece)


def ell_hot_columns(indices: torch.Tensor, values: torch.Tensor, d: int,
                    tail: Optional[EllTail] = None,
                    slots: int = ELL_HOT_SLOTS,
                    chunk_rows: int = 1 << 20) -> torch.Tensor:
    """S1's hot-column table: for each of ``slots`` slots (a power of two)
    the column c with c mod slots = slot that holds the most nonzeros of
    these rows (the lowest id among equals), or -1 where no column does.
    int32, (slots,)."""
    if slots < 1 or slots & (slots - 1):
        raise ValueError(f"ell_hot_columns: slots must be a power of two, "
                         f"got {slots}")
    counts = torch.zeros(-(-d // slots) * slots, dtype=torch.int64,
                         device=indices.device)
    for cols, _, _ in _nonzero_chunks(indices, values, tail, chunk_rows, 0,
                                      indices.shape[0]):
        counts[:d] += torch.bincount(cols, minlength=d)[:d]
    best, which = counts.reshape(-1, slots).max(0)  # first of equals
    col = which * slots + torch.arange(slots, device=indices.device)
    return torch.where(best > 0, col, -1).int()


def hot_share(hot: torch.Tensor, counts: torch.Tensor) -> float:
    """The share of the nonzeros (``counts`` by column) that the hot table
    ``hot`` serves."""
    h = hot[hot >= 0].long()
    return float(counts[h].sum()) / max(float(counts.sum()), 1.0)


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
             tail: Optional[EllTail] = None,
             hot: Optional[torch.Tensor] = None):
    """S1, the row pass: ``(mult (n,), loss, sum(mult), sum(w))`` for ELL
    rows ``indices`` (n, k) int32 and ``values`` (n, k) float32 (value
    times ``scale[index]`` when a (d,) scale is given), y, w (n,), beta
    (d,), the margin offset ``b0`` and the row-grouped COO ``tail``;
    ``link`` is logistic, squared, hinge or gram (mult = margin [w > 0]).
    Every index must be below d. A CPU tensor runs :func:`ell_rows_plain`;
    a CUDA tensor launches ``csrc/ell_sweep.cu`` (mult in float32, the
    three sums as float64 0-d tensors, summed in double in one fixed order:
    two launches are bitwise equal) or raises. ``hot``
    (:func:`ell_hot_columns` of the same rows) lets the kernel read the
    hot columns' coefficients from shared memory; the results are the same
    bits with or without it."""
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
    if hot is not None:
        hot = hot.to(device=dev, dtype=torch.int32).contiguous()
        slots = hot.shape[0]
        if hot.dim() != 1 or slots & (slots - 1) or not \
                32 <= slots <= lib.ell_max_hot_slots():
            raise ValueError(f"ell_rows: the hot table must be a power of "
                             f"two of 32 to {lib.ell_max_hot_slots()} "
                             f"slots; got {tuple(hot.shape)}")
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
            partials.data_ptr(), blocks, _ptr(hot),
            0 if hot is None else hot.shape[0], out.data_ptr(), stream),
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
    double in one fixed order set by the copy's layout: two launches are
    bitwise equal) or raises."""
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
    if columns.slot_ptr.shape != (d + 1,) or \
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
            int(moments), columns.piece_ptr.data_ptr(),
            columns.piece_col.data_ptr(), columns.piece_slot.data_ptr(),
            n_pieces, columns.slot_ptr.data_ptr(), d,
            columns.rows.data_ptr(), columns.vals.data_ptr(), _ptr(s),
            r.data_ptr(), partials.data_ptr(), out.data_ptr(), stream),
            "ell_cols launch")
    ell_cols.launches += 1
    ell_cols.launches_by_mode[MOMENTS if moments else GRADIENT] += 1
    return out if moments else out[0]


# -- ALS: every entity's normal equations in a fixed order --------------------

ALS_PIECE = 1024  # ratings of one piece, at most (the kernel takes any)
_ALS_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}


class AlsOrder(NamedTuple):
    """The ratings of one half-step (destination <- source) in a stable
    order by destination: destination e's ratings are positions
    ``offsets[e]:offsets[e + 1]``, in input order, and ``src``, ``rating``
    and ``dst`` hold each position's source id, rating and destination.
    Each destination's positions are cut into pieces of at most ``piece``
    (a destination with no rating has one empty piece): its pieces are
    ``piece_start[e]`` to ``piece_start[e + 1]``, ``piece_dst`` names each
    piece's destination, and ``piece_slot`` the scratch slot of each piece
    of a destination with more than one piece (-1 for the others; a
    destination's slots are consecutive). ``multi`` lists the destinations
    with more than one piece, whose pieces are summed in piece order by the
    kernel's second stage."""
    offsets: torch.Tensor      # (n_dst + 1,) int64
    src: torch.Tensor          # (nnz,) int32
    rating: torch.Tensor       # (nnz,) the compute dtype
    dst: torch.Tensor          # (nnz,) int32
    piece_start: torch.Tensor  # (n_dst + 1,) int64
    piece_dst: torch.Tensor    # (n_pieces,) int32
    piece_slot: torch.Tensor   # (n_pieces,) int32
    multi: torch.Tensor        # (n_multi,) int32
    n_slots: int
    piece: int

    @property
    def n_dst(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def counts(self) -> torch.Tensor:
        """Each destination's number of ratings (int64)."""
        return self.offsets[1:] - self.offsets[:-1]


def als_order(dst: torch.Tensor, src: torch.Tensor, rating: torch.Tensor,
              n_dst: int, n_src: int, piece: int = ALS_PIECE) -> AlsOrder:
    """The :class:`AlsOrder` of ratings ``(dst[k], src[k], rating[k])``
    with destinations in [0, n_dst) and sources in [0, n_src), on their
    device: a stable ``torch.sort`` of ``dst`` (set-up, once a fit and
    orientation; integer results, the same on every run), the offsets by
    ``bincount`` and ``cumsum``, the pieces. Raises for ids out of range
    (the kernel gathers unchecked) and for 2^31 ratings or more (the
    positions are int32)."""
    nnz = dst.shape[0]
    if src.shape != (nnz,) or rating.shape != (nnz,):
        raise ValueError(f"als_order: dst {tuple(dst.shape)}, src "
                         f"{tuple(src.shape)} and rating "
                         f"{tuple(rating.shape)} must be one (nnz,) each")
    if nnz >= 2 ** 31:
        raise ValueError(f"als_order: {nnz} ratings exceed the int32 "
                         "positions of the order")
    if piece < 1:
        raise ValueError(f"als_order: piece must be at least 1, got {piece}")
    i64 = torch.int64
    d64, s64 = dst.to(i64), src.to(i64)
    if nnz and (int(d64.min()) < 0 or int(d64.max()) >= n_dst
                or int(s64.min()) < 0 or int(s64.max()) >= n_src):
        raise ValueError(f"als_order: ids out of range (destinations in "
                         f"[0, {n_dst}), sources in [0, {n_src}))")
    dev = dst.device
    perm = torch.sort(d64, stable=True).indices
    counts = torch.bincount(d64, minlength=n_dst)
    offsets = torch.zeros(n_dst + 1, dtype=i64, device=dev)
    offsets[1:] = torch.cumsum(counts, 0)
    pieces = ((counts + piece - 1) // piece).clamp(min=1)
    piece_start = torch.zeros(n_dst + 1, dtype=i64, device=dev)
    piece_start[1:] = torch.cumsum(pieces, 0)
    n_pieces = int(piece_start[-1])
    piece_dst = torch.repeat_interleave(
        torch.arange(n_dst, device=dev), pieces, output_size=n_pieces)
    multi_piece = (pieces > 1)[piece_dst]
    slot = torch.cumsum(multi_piece.to(i64), 0) - 1
    return AlsOrder(
        offsets=offsets, src=s64[perm].to(torch.int32),
        rating=rating[perm], dst=d64[perm].to(torch.int32),
        piece_start=piece_start, piece_dst=piece_dst.to(torch.int32),
        piece_slot=torch.where(multi_piece, slot, -1).to(torch.int32),
        multi=torch.nonzero(pieces > 1).flatten().to(torch.int32),
        n_slots=int(multi_piece.sum()), piece=piece)


def als_chunk_rows(rank: int, itemsize: int, budget: int) -> int:
    """Ratings the plain normal equations take at a time: as many as keep
    their ``(chunk, rank, rank)`` outer products within ``budget`` bytes
    (the reference's ``aggregationChunkBytes``), at least one."""
    return max(1, budget // (rank * rank * itemsize))


def als_normal_plain(src_fac: torch.Tensor, order: AlsOrder,
                     implicit: bool = False, alpha: float = 1.0,
                     reg: float = 0.0, yty: Optional[torch.Tensor] = None,
                     chunk_bytes: int = 256 << 20
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every destination's normal equations in plain PyTorch at the source
    factors' dtype, as the reference builds them (``_normal_eq_local``):
    explicit, A = sum v v^T and b = sum r v; implicit, A = sum (alpha |r|)
    v v^T and b = sum (1 + alpha |r|) [r > 0] v, over each destination's
    ratings (v the source's factor row). The ratings are scanned in the
    order's positions, ``als_chunk_rows`` at a time, each chunk's outer
    products added by ``index_add_`` (in order on the CPU; on CUDA its float
    atomics add in a run-dependent order, so there it serves only as the
    truth the kernel is held against). Returns ``(A (n_dst, r, r), b
    (n_dst, r), n (n_dst,))``, n the count of every rating (r <= 0 too);
    A has ``reg * max(n, 1)`` added to its diagonal and then ``yty`` added
    when they are given (the solve's terms)."""
    dt = src_fac.dtype
    dev = src_fac.device
    n_dst, r = order.n_dst, src_fac.shape[1]
    a = torch.zeros((n_dst, r, r), dtype=dt, device=dev)
    b = torch.zeros((n_dst, r), dtype=dt, device=dev)
    rows = als_chunk_rows(r, src_fac.element_size(), chunk_bytes)
    for lo in range(0, order.src.shape[0], rows):
        d = order.dst[lo:lo + rows]
        v = src_fac[order.src[lo:lo + rows]]
        rc = order.rating[lo:lo + rows].to(dt)
        if implicit:
            c = alpha * rc.abs()
            a.index_add_(0, d, (v * c[:, None])[:, :, None] * v[:, None, :])
            b.index_add_(0, d, v * ((1.0 + c) * (rc > 0).to(dt))[:, None])
        else:
            a.index_add_(0, d, v[:, :, None] * v[:, None, :])
            b.index_add_(0, d, v * rc[:, None])
    n = order.counts.to(dt)
    if reg:  # A + reg max(n, 1) I, then + yty: the reference's order
        a.diagonal(dim1=1, dim2=2).add_((reg * n.clamp(min=1.0))[:, None])
    if yty is not None:
        a += yty.to(dt)
    return a, b, n


def als_normal(src_fac: torch.Tensor, order: AlsOrder, implicit: bool = False,
               alpha: float = 1.0, reg: float = 0.0,
               yty: Optional[torch.Tensor] = None,
               chunk_bytes: int = 256 << 20, instance: Optional[str] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every destination's normal equations ``(A, b, n)`` as
    :func:`als_normal_plain` computes them (with ``reg`` and ``yty`` added
    to A when given). A CPU tensor runs :func:`als_normal_plain`
    (``chunk_bytes`` its chunks' budget); a CUDA tensor launches
    ``csrc/als_normal.cu`` or raises: float32 factors on the tensor cores
    (3xTF32 products, float32 sums), float64 factors on float64 FMAs; each
    entry summed in a fixed order per piece, the pieces in piece order, no
    float atomics, so that two launches are bitwise equal, and A mirrored
    from its upper triangle, so that A == A^T bitwise. ``instance`` names
    the instance (:data:`TENSOR_CORE` or :data:`FMA`; None: by dtype):
    ``FMA`` at float32 is the earlier float32 design, kept to be timed
    beside the tensor cores; no fit passes it. Counted in
    ``als_normal.launches`` and by instance in
    ``als_normal.launches_by_instance``."""
    if src_fac.device.type == "cpu":
        return als_normal_plain(src_fac, order, implicit, alpha, reg, yty,
                                chunk_bytes)
    dt = src_fac.dtype
    if src_fac.dim() != 2 or dt not in _ALS_DTYPE_CODE or \
            not src_fac.is_contiguous():
        raise ValueError(f"als_normal: the source factors must be a "
                         f"contiguous 2-D float32 or float64 tensor on CUDA; "
                         f"got {tuple(src_fac.shape)} {dt}")
    if order.rating.dtype != dt:
        raise ValueError(f"als_normal: ratings of {order.rating.dtype} with "
                         f"factors of {dt}")
    if instance is None:
        instance = TENSOR_CORE if dt == torch.float32 else FMA
    if instance not in (TENSOR_CORE, FMA) or \
            (instance == TENSOR_CORE and dt != torch.float32):
        raise ValueError(f"als_normal: no {instance!r} instance for {dt}")
    dev = src_fac.device
    tensors = [t for t in order if torch.is_tensor(t)]
    if any(t.device != dev for t in tensors):
        raise ValueError("als_normal: the order lies on another device than "
                         "the factors")
    n_dst, r = order.n_dst, src_fac.shape[1]
    if yty is not None:
        yty = yty.to(device=dev, dtype=dt).contiguous()
        if yty.shape != (r, r):
            raise ValueError(f"als_normal: yty {tuple(yty.shape)} is not "
                             f"({r}, {r})")
    with torch.cuda.device(dev):
        a = torch.empty((n_dst, r, r), dtype=dt, device=dev)
        b = torch.empty((n_dst, r), dtype=dt, device=dev)
        part_a = part_b = None
        if order.n_slots:
            part_a = torch.empty((order.n_slots, r, r), dtype=dt, device=dev)
            part_b = torch.empty((order.n_slots, r), dtype=dt, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _cuda_check(_library("als_normal").als_normal_launch(
            _ALS_DTYPE_CODE[dt], int(instance == FMA), int(bool(implicit)),
            src_fac.data_ptr(), r, order.src.data_ptr(),
            order.rating.data_ptr(), order.offsets.data_ptr(),
            order.piece_start.data_ptr(), order.piece_dst.data_ptr(),
            order.piece_slot.data_ptr(), order.piece_dst.shape[0],
            order.piece, order.multi.data_ptr(), order.multi.shape[0],
            float(alpha), float(reg), _ptr(yty), _ptr(part_a), _ptr(part_b),
            a.data_ptr(), b.data_ptr(), stream),
            "als_normal launch")
    als_normal.launches += 1
    als_normal.launches_by_instance[instance] += 1
    return a, b, order.counts.to(dt)


# -- serving margins -----------------------------------------------------------

_SERVING_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
_SERVING_LOCK = threading.Lock()  # lanes count from their own threads
SERVING_LANES = 32  # a warp's lanes: the partial sums of one margin


def serving_instance(dtype: torch.dtype, quantized: bool) -> str:
    """The name of the serving-margins instance for the serving ``dtype``
    and coefficient form: ``f32``, ``f64``, ``f32_e4m3`` or ``f64_e4m3``."""
    if dtype not in _SERVING_DTYPE_CODE:
        raise ValueError(f"serving_margins: no instance for {dtype}")
    return ("f32" if dtype == torch.float32 else "f64") + \
        ("_e4m3" if quantized else "")


def serving_margins_plain(x: torch.Tensor, coef: torch.Tensor,
                          icpt: torch.Tensor,
                          scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Margins ``(K, B, Km)`` of ``K`` linear models for the rows ``x``
    ``(B, d)``: ``coef`` ``(K, Km, d)`` in x's dtype, or e4m3 codes with
    ``scale`` ``(K, Km)`` (a coefficient is ``code * scale``, rounded
    once), and ``icpt`` ``(K, Km)``.

    The kernel's order with elementwise ops only, so that the bits are
    the kernel's and do not depend on B or K: a ``(..., 32)`` partial
    takes the product of column ``32 i + l`` in lane ``l`` for each block
    ``i`` in turn (the last block zero-padded), each product and sum
    rounded on its own; then the xor tree over offsets 16, 8, 4, 2, 1 as
    five adds of the partial and its lane-permuted self; then the
    intercept."""
    dt = x.dtype
    k, km, d = coef.shape
    b = x.shape[0]
    blocks = -(-d // SERVING_LANES)
    pad = blocks * SERVING_LANES - d
    c = coef.to(dt)
    if scale is not None:
        c = c * scale.to(dt)[..., None]
    xb = torch.nn.functional.pad(x, (0, pad)).reshape(b, blocks,
                                                      SERVING_LANES)
    cb = torch.nn.functional.pad(c, (0, pad)).reshape(k, km, blocks,
                                                      SERVING_LANES)
    part = torch.zeros((k, b, km, SERVING_LANES), dtype=dt, device=x.device)
    for i in range(blocks):
        part = part + xb[None, :, None, i, :] * cb[:, None, :, i, :]
    lanes = torch.arange(SERVING_LANES, device=x.device)
    for off in (16, 8, 4, 2, 1):
        part = part + part[..., lanes ^ off]
    return part[..., 0] + icpt.to(dt)[:, None, :]


def _serving_operands(x, coef, icpt, scale):
    """Check a CUDA call's operands; returns (dtype code, quantized)."""
    dt = x.dtype
    quantized = coef.dtype == torch.float8_e4m3fn
    if dt not in _SERVING_DTYPE_CODE or x.dim() != 2:
        raise ValueError(f"serving_margins: x must be 2-D float32 or float64, "
                         f"got {tuple(x.shape)} {dt}")
    if coef.dim() != 3 or coef.shape[2] != x.shape[1] or \
            (coef.dtype != dt and not quantized):
        raise ValueError(f"serving_margins: coef {tuple(coef.shape)} "
                         f"{coef.dtype} does not match x {tuple(x.shape)} {dt}")
    k, km = coef.shape[:2]
    vecs = [icpt] + ([scale] if quantized else [])
    if quantized and scale is None:
        raise ValueError("serving_margins: e4m3 codes need their scale")
    for t in [x, coef] + vecs:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("serving_margins: operands must be contiguous "
                             "on one device")
    if any(v.dtype != dt or v.shape != (k, km) for v in vecs):
        raise ValueError(f"serving_margins: icpt and scale must be ({k}, "
                         f"{km}) {dt}")
    return _SERVING_DTYPE_CODE[dt], quantized


def serving_margins(x: torch.Tensor, coef: torch.Tensor, icpt: torch.Tensor,
                    scale: Optional[torch.Tensor] = None, *,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The margins :func:`serving_margins_plain` computes, ``(K, B, Km)``.
    A CPU tensor runs the plain twin; a CUDA tensor launches
    ``csrc/serving_margins.cu`` on the current stream, into ``out`` (or a
    new tensor), or raises. The launch synchronizes nothing, so a bucket's
    CUDA graph captures it between its two copies
    (``serving/batcher.py``). Counted in ``serving_margins.launches`` and
    by :func:`serving_instance` in ``serving_margins.launches_by_instance``,
    except while the stream is being captured (a capture launches nothing;
    the lane counts each replay, :func:`count_serving_launch`)."""
    if x.device.type == "cpu":
        return serving_margins_plain(x, coef, icpt, scale)
    code, quantized = _serving_operands(x, coef, icpt, scale)
    k, km, d = coef.shape
    b = x.shape[0]
    if out is None:
        out = torch.empty((k, b, km), dtype=x.dtype, device=x.device)
    elif out.shape != (k, b, km) or out.dtype != x.dtype or \
            out.device != x.device or not out.is_contiguous():
        raise ValueError(f"serving_margins: out must be a contiguous ({k}, "
                         f"{b}, {km}) {x.dtype} tensor on {x.device}")
    with torch.cuda.device(x.device):
        capturing = torch.cuda.is_current_stream_capturing()
        stream = torch.cuda.current_stream(x.device)
        _cuda_check(_library("serving_margins").serving_margins_launch(
            code, int(quantized), x.data_ptr(), coef.data_ptr(),
            _ptr(scale if quantized else None), icpt.data_ptr(), k, b, km, d,
            out.data_ptr(), stream.cuda_stream), "serving_margins launch")
    if not capturing:
        count_serving_launch(serving_instance(x.dtype, quantized))
    return out


def serving_margins_plan(dtype: torch.dtype, quantized: bool, b: int,
                         margins: int, d: int) -> dict:
    """The tile the kernel takes for ``b`` rows, ``margins`` (K * Km)
    margin rows and ``d`` columns (asks the built library): warps of a CTA
    along rows and margins, rows and margins a warp, stages in flight and
    the CTAs of the launch, the columns of a chunk, and ``direct`` (1: the
    one-warp-an-output layout, whose tile fields are 0)."""
    plan = (ctypes.c_int * 8)()
    _cuda_check(_library("serving_margins").serving_margins_plan(
        _SERVING_DTYPE_CODE[dtype], int(quantized), b, margins, d, plan),
        "serving_margins plan")
    return dict(zip(("warp_rows", "warp_margins", "rows_a_warp",
                     "margins_a_warp", "stages", "ctas", "chunk_cols",
                     "direct"), plan))


def count_serving_launch(instance: str) -> None:
    """Count one launch of the serving-margins ``instance``: an eager
    launch, or one replay of a bucket's CUDA graph."""
    with _SERVING_LOCK:
        serving_margins.launches += 1
        serving_margins.launches_by_instance[instance] += 1


# -- the decision-tree engine's level histogram in a fixed order --------------

TREE_PIECE_ROWS = 8192         # sorted rows of one piece, at least
TREE_SCRATCH_BYTES = 1 << 30   # the pieces' partial tables, at most (or
#                                twice the output, where that is more)
TREE_PLAIN_ELEMS = 1 << 22     # (row, feature, channel) values the plain
#                                twin adds at a time
TREE_BIN_DTYPES = (torch.uint8, torch.int32)  # the bins' widths it takes
# the instances (``tree_hist_plan``): a lane a row into lane-private
# shared-memory tables, or the first design's lane a bin
LANE_A_ROW, LANE_A_BIN = "lane_a_row", "lane_a_bin"


def tree_hist_plain(bins: torch.Tensor, chans: torch.Tensor,
                    pos: torch.Tensor, a_pad: int, n_bins: int
                    ) -> torch.Tensor:
    """The level histogram [T, a_pad, d, n_bins, C] in plain PyTorch, at
    chans' dtype (float32 on the engine's path): for each tree t, each row
    i with ``pos[i, t] >= 0`` and each feature f, ``chans[i, t]`` added
    into ``[t, pos[i, t], f, bins[i, f]]``, by ``index_add_`` on the flat
    keys pos·d·B + f·B + bin (the reference's ``hist_fn``,
    ``ml/tree/impl.py:437-455``). ``bins`` [n, d] uint8 or int32, ``chans``
    [n, T, C], ``pos`` [n, T] int32. On the CPU ``index_add_`` adds in row
    order; on CUDA in a run-dependent order, so there it is only the twin
    :func:`tree_hist` is held against (in float64, the table's truth)."""
    n, d = bins.shape
    T, C = chans.shape[1], chans.shape[2]
    dev = bins.device
    out = torch.zeros((T, a_pad * d * n_bins, C), dtype=chans.dtype,
                      device=dev)
    feat = torch.arange(d, device=dev, dtype=torch.int64) * n_bins
    step = max(1, TREE_PLAIN_ELEMS // max(d * C, 1))
    for t in range(T):
        for lo in range(0, n, step):
            p = pos[lo:lo + step, t]
            act = p >= 0
            idx = (p[act].to(torch.int64)[:, None] * (d * n_bins) + feat
                   + bins[lo:lo + step][act].to(torch.int64))     # [m, d]
            vals = chans[lo:lo + step, t][act]                     # [m, C]
            out[t].index_add_(0, idx.reshape(-1), vals[:, None, :].expand(
                vals.shape[0], d, C).reshape(-1, C))
    return out.view(T, a_pad, d, n_bins, C)


def tree_order(keys: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """``(order (m,) int32, offsets (k + 1,) int64)``: the positions of
    ``keys`` (m,) int32 sorted stably by key, key j's at
    ``order[offsets[j]:offsets[j + 1]]``; keys outside [0, k) left out.
    Up to :data:`COUNT_MAX_K` keys the center sums' counting sort
    (:func:`_center_order`), past it ``torch.sort`` and the offsets by
    ``searchsorted`` on its sorted keys: the same order, which depends on
    the keys alone. Neither reads anything back to the host."""
    if k <= COUNT_MAX_K:
        co = _center_order(keys, k)
        return co.order, co.offsets
    k64 = torch.where((keys >= 0) & (keys < k), keys.to(torch.int64),
                      torch.full_like(keys, k, dtype=torch.int64))
    srt = torch.sort(k64, stable=True)
    offsets = torch.searchsorted(srt.values, torch.arange(
        k + 1, device=keys.device, dtype=torch.int64))
    return srt.indices.to(torch.int32), offsets


def tree_piece_rows(rows: int, n: int, n_keys: int, a_pad: int, dbc: int,
                    out_elems: int) -> Tuple[int, int, int]:
    """``(piece_rows, n_windows, max_pieces)`` of a launch over at most
    ``rows`` sorted rows of ``n_keys`` keys (``n`` rows, ``a_pad`` nodes a
    tree), from shapes alone: the least :data:`TREE_PIECE_ROWS` x 2^j
    whose bound on the pieces, ceil(rows / piece_rows) + n_keys x
    n_windows, times the partial table of ``dbc`` floats fits
    :data:`TREE_SCRATCH_BYTES` (or twice the ``out_elems`` output), the
    windows and that bound. A level of one node a tree has one window
    (each tree's rows are in row order already); past it the rows are cut
    into windows of piece_rows x a_pad rows, so that the CTAs in flight
    read the rows of a few windows (``tree_phases.py`` times a deep level
    with and without them; at level 0 they only make more, smaller
    pieces)."""
    budget = max(TREE_SCRATCH_BYTES, 8 * out_elems)
    piece_rows = TREE_PIECE_ROWS
    while True:
        n_windows = 1 if a_pad == 1 else -(-n // (piece_rows * a_pad))
        n_windows = max(1, n_windows)
        bound = -(-rows // piece_rows) + n_keys * n_windows
        if bound * dbc * 4 <= budget or piece_rows >= rows:
            return piece_rows, n_windows, bound
        piece_rows *= 2


def tree_pieces(order: torch.Tensor, offsets: torch.Tensor, tg: int,
                a_pad: int, piece_rows: int, n_windows: int,
                max_pieces: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The piece table of one launch in plain PyTorch, the twin of
    ``csrc/tree_hist.cu``'s segments, scan and table kernels: the rows cut
    into ``n_windows`` windows of piece_rows x a_pad rows (one window:
    every row), each key's
    sorted rows (``order`` values row x tg + tree, key k's at
    ``offsets[k]`` ..) in each window into pieces of ``piece_rows``,
    numbered window by window. Returns ``(seg, table)``: seg (4 S + 1,)
    int64 (S = n_windows x k segments, i = window x k + key): the
    segments' first and end sorted positions, their pieces, then their
    first piece (S + 1); table (3, max_pieces) int64: each piece's key,
    first sorted position and length (past the real count key k,
    position 0 and length 0)."""
    k = offsets.shape[0] - 1
    S = n_windows * k
    dev = offsets.device
    i64 = torch.int64
    m = order.shape[0] + 1                   # above every order value
    # each key's values lifted past the earlier keys': one sorted sequence
    kept = order[:int(offsets[k])].to(i64)
    lifted = torch.repeat_interleave(torch.arange(k, device=dev),
                                     torch.diff(offsets)) * m + kept
    w = torch.arange(n_windows + 1, device=dev, dtype=i64)
    lim = (w * piece_rows * a_pad * tg).clamp(max=m)
    if n_windows == 1:                       # one window: every row
        lim[1] = m
    bounds = torch.searchsorted(lifted, torch.arange(
        k, device=dev, dtype=i64)[None, :] * m + lim[:, None])
    first, end = bounds[:-1].reshape(-1), bounds[1:].reshape(-1)
    count = (end - first + piece_rows - 1) // piece_rows
    start = torch.zeros(S + 1, dtype=i64, device=dev)
    start[1:] = torch.cumsum(count, 0)
    p = torch.arange(max_pieces, dtype=i64, device=dev)
    live = p < start[S]
    i = (torch.searchsorted(start[:S], p, right=True) - 1).clamp(min=0)
    pf = first[i] + (p - start[i]) * piece_rows
    zero = torch.zeros_like(p)
    table = torch.stack([torch.where(live, i % k, torch.full_like(p, k)),
                         torch.where(live, pf, zero),
                         torch.where(live, (end[i] - pf).clamp(
                             max=piece_rows), zero)])
    return torch.cat([first, end, count, start]), table


class TreeLaunch(NamedTuple):
    """What a launch of ``csrc/tree_hist.cu`` for one group of trees reads
    beside the data: the (row, tree) pairs sorted stably by key (``order``
    holds row x trees + tree), the keys' offsets, and from
    :func:`tree_piece_rows` the piece size, the windows and the bound on
    the pieces the grid and scratch are sized by."""
    order: torch.Tensor        # (n x trees,) int32
    offsets: torch.Tensor      # (n_keys + 1,) int64
    n_keys: int
    piece_rows: int
    n_windows: int
    max_pieces: int


def tree_keys_plain(pos: torch.Tensor, a_pad: int) -> torch.Tensor:
    """The keys :func:`tree_order` sorts for a launch over ``pos`` [n, tg]
    int32 in plain PyTorch: tree x a_pad + node in row-major order
    (row x tg + tree), -1 where a row is out of a tree (pos < 0)."""
    tg = pos.shape[1]
    return torch.where(pos >= 0, pos + torch.arange(
        tg, device=pos.device, dtype=torch.int32) * a_pad, -1).reshape(-1)


def tree_keys(pos: torch.Tensor, t0: int, tg: int, a_pad: int
              ) -> torch.Tensor:
    """:func:`tree_keys_plain` of ``pos[:, t0:t0 + tg]`` by one launch of
    ``csrc/tree_hist.cu``'s ``tree_keys_kernel`` (a CUDA ``pos`` [n, T]
    int32, contiguous); on a CPU tensor the plain version."""
    if pos.device.type == "cpu":
        return tree_keys_plain(pos[:, t0:t0 + tg], a_pad)
    n, T = pos.shape
    keys = torch.empty(n * tg, dtype=torch.int32, device=pos.device)
    with torch.cuda.device(pos.device):
        _cuda_check(_library("tree_hist").tree_keys_launch(
            pos.data_ptr(), T, t0, n, tg, a_pad, keys.data_ptr(),
            torch.cuda.current_stream(pos.device).cuda_stream),
            "tree_keys launch")
    return keys


def tree_launch_inputs(pos: torch.Tensor, t0: int, tg: int, a_pad: int,
                       dbc: int) -> TreeLaunch:
    """The sort and the piece sizes of one launch over trees t0 .. t0 +
    tg - 1 of ``pos`` [n, T] (-1 for a row out of a tree), keys tree x
    a_pad + node in row-major order (:func:`tree_keys`), for partial
    tables of ``dbc`` floats; nothing read back to the host."""
    n = pos.shape[0]
    k = tg * a_pad
    order, offsets = tree_order(tree_keys(pos, t0, tg, a_pad), k)
    return TreeLaunch(order, offsets, k, *tree_piece_rows(
        n * tg, n, k, a_pad, dbc, k * dbc))


def tree_launch_scratch(lp: TreeLaunch, dbc: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(seg, table, partial)``, the scratch of a launch: the segments
    (4 x n_windows x n_keys + 1 int64), the piece table (3 x max_pieces
    int64) and the pieces' partial tables (max_pieces x ``dbc`` floats)."""
    dev = lp.order.device
    return (torch.empty(4 * lp.n_windows * lp.n_keys + 1, dtype=torch.int64,
                        device=dev),
            torch.empty(3 * lp.max_pieces, dtype=torch.int64, device=dev),
            torch.empty(lp.max_pieces * dbc, dtype=torch.float32,
                        device=dev))


def _tree_launch(bins: torch.Tensor, chans: torch.Tensor, lp: TreeLaunch,
                 t0: int, a_pad: int, n_bins: int, scratch, out: torch.Tensor,
                 stages: int = 7) -> None:
    """One call of ``tree_hist_launch`` for trees t0 .. of ``lp`` with
    ``scratch`` (:func:`tree_launch_scratch`): ``stages`` bit 1 the
    segments and the piece table, bit 2 the pieces, bit 4 the reduce into
    ``out`` (a stage reads what the earlier ones left)."""
    d = bins.shape[1]
    dev = bins.device
    seg, table, partial = scratch
    with torch.cuda.device(dev):
        _cuda_check(_library("tree_hist").tree_hist_launch(
            bins.data_ptr(), bins.element_size(), bins.stride(0),
            chans.data_ptr(), chans.stride(0), chans.stride(1),
            lp.order.data_ptr(), lp.offsets.data_ptr(), lp.n_keys,
            lp.piece_rows, lp.n_windows, lp.max_pieces, d, n_bins,
            chans.shape[2], t0, a_pad, seg.data_ptr(), table.data_ptr(),
            partial.data_ptr(), out.data_ptr(), stages,
            torch.cuda.current_stream(dev).cuda_stream), "tree_hist launch")


# the instance by (device, n_bins, C, d, bin bytes): the plan is asked of
# the built library once
_TREE_PLANS: Dict[tuple, Dict[str, int]] = {}


def tree_hist_plan(n_bins: int, C: int, d: int,
                   bin_dtype: torch.dtype = torch.uint8,
                   device=None) -> Dict[str, int]:
    """The instance a CUDA launch takes for ``n_bins`` bins, ``C``
    channels, ``d`` features and bins of ``bin_dtype`` (asks the built
    library; on ``device``, the current CUDA device by default):
    ``instance`` :data:`LANE_A_ROW` where C <= 16 and one feature's lane
    copies (a feature pair's 32 slots a cell) and doubles (n_bins x C x
    136 bytes) fit a CTA's shared memory with its staging, else
    :data:`LANE_A_BIN`; its features a CTA and
    feature blocks, threads, dynamic shared memory, CTAs resident on one
    SM and ``variant`` (channels of the lane-a-row instance: 3 or 4
    exactly, else up to 16; bins a lane a pass of the lane-a-bin one)."""
    if bin_dtype not in TREE_BIN_DTYPES:
        raise ValueError(f"tree_hist: bins must be uint8 or int32, got "
                         f"{bin_dtype}")
    with torch.cuda.device(device if device is not None
                           else torch.cuda.current_device()):
        key = (torch.cuda.current_device(), n_bins, C, d, bin_dtype)
        plan = _TREE_PLANS.get(key)
        if plan is None:
            raw = (ctypes.c_int * 7)()
            _cuda_check(_library("tree_hist").tree_hist_plan(
                n_bins, C, d, 1 if bin_dtype == torch.uint8 else 4, raw),
                "tree_hist plan")
            plan = _TREE_PLANS[key] = dict(zip(
                ("instance", "features", "feature_blocks", "threads",
                 "smem_bytes", "ctas_per_sm", "variant"), raw))
            plan["instance"] = LANE_A_ROW if plan["instance"] else LANE_A_BIN
    return plan


def tree_hist(bins: torch.Tensor, chans: torch.Tensor, pos: torch.Tensor,
              a_pad: int, n_bins: int) -> torch.Tensor:
    """The level histogram of :func:`tree_hist_plain`. A CPU tensor runs
    the plain twin; a CUDA tensor launches ``csrc/tree_hist.cu`` or raises:
    each tree's rows sorted stably by node (:func:`tree_order`), cut into
    pieces on the card (:func:`tree_piece_rows`; the twin of its table:
    :func:`tree_pieces`), one CTA a (piece, feature block) adding them in
    sorted order (lane l of a half warp rows l, l + 16, ... into its own
    shared-memory copy of its feature's table, in float over blocks of
    2,048 rows, the 16 lane copies added into a double), each key's pieces
    in window and piece order in double, each cell rounded once to
    float32, no float atomics, so two calls on the same inputs are bitwise
    equal. Reads nothing back to the host. ``bins`` uint8 or int32 with
    contiguous rows; uint8 rows must start on 4-byte boundaries
    (``impl.bin_storage`` pads them), else it raises. Trees go to a
    launch while rows x trees stay below 2^31 (the order's int32), each
    launch counted in
    ``tree_hist.launches`` and by instance (:func:`tree_hist_plan`) in
    ``tree_hist.launches_by_instance``."""
    if bins.device.type == "cpu":
        return tree_hist_plain(bins, chans, pos, a_pad, n_bins)
    if bins.device.type != "cuda":
        raise ValueError(f"tree_hist: no kernel for device {bins.device}")
    n, d = bins.shape
    if chans.dim() != 3 or chans.shape[0] != n or pos.shape != (
            n, chans.shape[1]):
        raise ValueError(f"tree_hist: bins {tuple(bins.shape)}, chans "
                         f"{tuple(chans.shape)} and pos {tuple(pos.shape)} "
                         "do not match")
    if bins.dtype not in TREE_BIN_DTYPES or chans.dtype != torch.float32 \
            or pos.dtype != torch.int32:
        raise ValueError("tree_hist: bins must be uint8 or int32, pos int32 "
                         f"and chans float32; got {bins.dtype}, "
                         f"{chans.dtype}, {pos.dtype}")
    if bins.stride(1) != 1 or chans.stride(2) != 1:
        raise ValueError("tree_hist: bins' rows and each (row, tree)'s "
                         "channels must be contiguous")
    if a_pad < 1 or n_bins < 1:
        raise ValueError(f"tree_hist: a_pad {a_pad} and n_bins {n_bins} "
                         "must be positive")
    if (bins.stride(0) * bins.element_size()) % 4 or bins.data_ptr() % 4:
        raise ValueError("tree_hist: the kernel copies bins in 4-byte "
                         "words, so each row must start on a 4-byte "
                         "boundary; store uint8 bins through "
                         "ml.tree.impl.bin_storage, which pads the rows")
    T, C = chans.shape[1], chans.shape[2]
    dev = bins.device
    dbc = d * n_bins * C
    out = torch.empty((T, a_pad, d, n_bins, C), dtype=torch.float32,
                      device=dev)
    group = max(1, (2 ** 31 - 1) // max(n, 1))
    instance = tree_hist_plan(n_bins, C, d, bins.dtype, dev)["instance"]
    pos = pos.contiguous()
    for t0 in range(0, T, group):
        tg = min(group, T - t0)
        lp = tree_launch_inputs(pos, t0, tg, a_pad, dbc)
        _tree_launch(bins, chans, lp, t0, a_pad, n_bins,
                     tree_launch_scratch(lp, dbc), out[t0:t0 + tg])
        tree_hist.launches += 1
        tree_hist.launches_by_instance[instance] += 1
    return out


reset_launch_counts()  # every count starts at 0
