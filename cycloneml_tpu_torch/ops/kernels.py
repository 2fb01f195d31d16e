"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

K1, the GLM row sweep (``csrc/glm_sweep.cu``), replaces the Pallas kernel
``cycloneml_tpu/ops/kernels.py:_run_glm`` with the logistic link: one pass
over X computing the loss, the gradient, sum(mult) and sum(w). It is
bandwidth-bound (X is read once per sweep); see the source note in the
``.cu`` file for the bound and what the design does about it.

:func:`glm_sweep` launches the kernel for a CUDA tensor and runs
:func:`glm_sweep_plain` only for a tensor that lies on the CPU. There is no
fallback from one to the other: a CUDA tensor the kernel cannot take raises.
``glm_sweep.launches`` counts kernel launches.

Not ported yet (ROADMAP Queue 2): the squared link (K2, LinearRegression),
``fused_kmeans_assign`` (K3), ``fused_gramian`` (K4) and the fp8
``x_scale`` operand of K1 (slice 3).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

ROW_CHUNK = 1 << 16  # rows upcast at a time by the plain version

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


def glm_sweep_plain(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                    beta: torch.Tensor, off, acc_dtype=torch.float32,
                    chunk_rows: int = ROW_CHUNK
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """The sweep in plain PyTorch, accumulated in ``acc_dtype``:
    returns ``(loss, grad_row (d,), sum(mult), sum(w))``. X is upcast
    ``chunk_rows`` rows at a time, so no full-width copy of X is held.
    With ``acc_dtype=torch.float64`` it is the truth the kernel is held
    against on the card."""
    n, d = x.shape
    dev = x.device
    beta_a = beta.to(acc_dtype)
    off_a = off.to(acc_dtype) if torch.is_tensor(off) else \
        torch.tensor(off, dtype=acc_dtype, device=dev)
    loss = torch.zeros((), dtype=acc_dtype, device=dev)
    grad = torch.zeros(d, dtype=acc_dtype, device=dev)
    msum = torch.zeros((), dtype=acc_dtype, device=dev)
    wsum = torch.zeros((), dtype=acc_dtype, device=dev)
    for lo in range(0, n, chunk_rows):
        xc = x[lo:lo + chunk_rows].to(acc_dtype)
        yc = y[lo:lo + chunk_rows].to(acc_dtype)
        wc = w[lo:lo + chunk_rows].to(acc_dtype)
        m = xc @ beta_a + off_a
        mult = wc * (torch.sigmoid(m) - yc)
        loss += torch.sum(wc * (_softplus(m) - yc * m))
        grad += mult @ xc
        msum += torch.sum(mult)
        wsum += torch.sum(wc)
    return loss, grad, msum, wsum


def _library() -> ctypes.CDLL:
    from cycloneml_tpu_torch.ops import build
    lib = build.load("glm_sweep")
    # pointers and the stream as c_void_p: an untyped int would be cut to
    # 32 bits
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.glm_sweep_max_d.argtypes = []
    lib.glm_sweep_max_d.restype = i
    lib.glm_sweep_num_parts.argtypes = [i, i, ll, ctypes.POINTER(i)]
    lib.glm_sweep_num_parts.restype = i
    lib.glm_sweep_launch.argtypes = [i, p, p, p, p, p, ll, i, p, i, p, p]
    lib.glm_sweep_launch.restype = i
    return lib


def _cuda_check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed with CUDA error {rc}")


def glm_sweep(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
              beta: torch.Tensor, off
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """K1 wrapper: ``(loss, grad_row (d,), sum(mult), sum(w))`` in float32
    for X ``(n, d)`` at storage width, y, w ``(n,)``, beta ``(d,)`` and the
    margin offset ``off`` (a scalar or 0-d tensor). A CPU tensor runs
    :func:`glm_sweep_plain`; a CUDA tensor launches the kernel or
    raises."""
    if x.device.type == "cpu":
        return glm_sweep_plain(x, y, w, beta, off)
    if x.device.type != "cuda":
        raise ValueError(f"glm_sweep: no kernel for device {x.device}")
    if x.dim() != 2 or x.dtype not in _DTYPE_CODE:
        raise ValueError("glm_sweep: X must be 2-D float32 or bfloat16 on "
                         f"CUDA; got {tuple(x.shape)} {x.dtype}")
    n, d = x.shape
    lib = _library()
    if d > lib.glm_sweep_max_d():
        raise ValueError(f"glm_sweep: d={d} exceeds the kernel's limit of "
                         f"{lib.glm_sweep_max_d()} features")
    if not x.is_contiguous():
        raise ValueError("glm_sweep: X must be contiguous (a copy of X "
                         "would double the sweep's memory)")
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
    code = _DTYPE_CODE[x.dtype]
    with torch.cuda.device(dev):
        parts = ctypes.c_int(0)
        _cuda_check(lib.glm_sweep_num_parts(code, d, n, ctypes.byref(parts)),
                    "glm_sweep_num_parts")
        partials = torch.empty(parts.value * (d + 3), dtype=torch.float64,
                               device=dev)
        out = torch.empty(d + 3, dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _cuda_check(lib.glm_sweep_launch(
            code, x.data_ptr(), y.data_ptr(), w.data_ptr(), beta.data_ptr(),
            scalars.data_ptr(), n, d, partials.data_ptr(), parts.value,
            out.data_ptr(), stream), "glm_sweep launch")
    glm_sweep.launches += 1
    return out[d], out[:d], out[d + 1], out[d + 2]


glm_sweep.launches = 0


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
