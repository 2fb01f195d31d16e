"""Block aggregators — the per-shard loss/gradient sums.

The port's counterpart of ``cycloneml_tpu/ml/optim/aggregators.py`` (binary
logistic family). Every aggregator has the signature ``agg(x, y, w, ...,
coef) -> {"loss", "grad", "count"}`` over a shard whose padding rows carry
w=0, and returns SUMS; ``tree_aggregate`` adds them over the mesh and the
loss function divides by the weight sum. Coefficient layout:
``[w_0 .. w_{d-1}, intercept?]``.

The ``binary_logistic*`` aggregators are plain PyTorch; the ``_pallas``
twin (the reference's name, so the two packages line up) runs kernel K1.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from cycloneml_tpu_torch.dataset.instance import is_narrow_dtype

Agg = Callable[..., Dict[str, torch.Tensor]]

ROW_CHUNK = 1 << 16  # rows of a narrow X upcast at a time


def _split_coef(coef, d, fit_intercept):
    if fit_intercept:
        return coef[:d], coef[d]
    return coef, torch.zeros((), dtype=coef.dtype, device=coef.device)


def _softplus(m: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus = logaddexp(m, 0): exact at every magnitude
    return m.clamp(min=0) + torch.log1p(torch.exp(-m.abs()))


def _tier_dot(a: torch.Tensor, b: torch.Tensor, acc=None) -> torch.Tensor:
    """``a @ b`` (``a`` 2-D, ``b`` 1-D) across the data/accumulator tier
    boundary.

    Full-width operands multiply as they are, the narrower one promoted
    (the reference's dtype promotion). When ``a`` is narrow (a bf16 X or
    its transpose), ``b`` is rounded to ``a``'s width and the products
    accumulate in ``acc`` (default ``b``'s dtype) — the reference's
    ``preferred_element_type`` recipe: narrow multiplicands, wide sums.
    A torch bf16 product would round its output to bf16, so X is instead
    upcast ``ROW_CHUNK`` rows at a time (never a full-width copy) and
    multiplied at ``acc`` width, where the bf16 x bf16 products are
    exact.
    """
    if not is_narrow_dtype(a.dtype):
        if a.dtype != b.dtype:
            wide = torch.promote_types(a.dtype, b.dtype)
            a, b = a.to(wide), b.to(wide)
        return a @ b
    if acc is None:
        acc = b.dtype
    bn = b.to(a.dtype).to(acc)
    # chunk along X's rows, a's long axis: a's rows for X @ beta, its
    # contraction axis for X.T @ mult (chunk products summed in order)
    if a.shape[0] >= a.shape[1]:
        return torch.cat([a[lo:lo + ROW_CHUNK].to(acc) @ bn
                          for lo in range(0, a.shape[0], ROW_CHUNK)])
    out = torch.zeros(a.shape[0], dtype=acc, device=a.device)
    for lo in range(0, a.shape[1], ROW_CHUNK):
        out += a[:, lo:lo + ROW_CHUNK].to(acc) @ bn[lo:lo + ROW_CHUNK]
    return out


def binary_logistic(d: int, fit_intercept: bool = True) -> Agg:
    """Binomial logistic loss (ref BinaryLogisticBlockAggregator.scala:41):
    loss_i = w_i (softplus(m_i) - y_i m_i) with margin m = x.beta + b0."""

    def agg(x, y, w, coef):
        beta, b0 = _split_coef(coef, d, fit_intercept)
        margin = _tier_dot(x, beta) + b0
        loss = torch.sum(w * (_softplus(margin) - y * margin))
        multiplier = w * (torch.sigmoid(margin) - y)
        g = _tier_dot(x.T, multiplier)
        grad = torch.cat([g, torch.sum(multiplier).reshape(1)]) \
            if fit_intercept else g
        return {"loss": loss, "grad": grad, "count": torch.sum(w)}

    return agg


def binary_logistic_scaled(d: int, fit_intercept: bool = True) -> Agg:
    """Binomial logistic loss over RAW feature rows with standardization
    folded into the read: margin = x.(inv_std o beta) - scaled_mean.beta
    + b0 and grad_beta = inv_std o (x.T mult) - scaled_mean sum(mult) —
    the aggregation over (x - mu)/sigma without a standardized copy of X.

    Signature ``agg(x, y, w, inv_std, scaled_mean, coef)``; pass
    ``scaled_mean = zeros`` when not centering."""

    def agg(x, y, w, inv_std, scaled_mean, coef):
        beta, b0 = _split_coef(coef, d, fit_intercept)
        sb = inv_std * beta
        margin = _tier_dot(x, sb) - torch.dot(scaled_mean, beta) + b0
        loss = torch.sum(w * (_softplus(margin) - y * margin))
        multiplier = w * (torch.sigmoid(margin) - y)
        msum = torch.sum(multiplier)
        g = inv_std * _tier_dot(x.T, multiplier) - scaled_mean * msum
        grad = torch.cat([g, msum.reshape(1)]) if fit_intercept else g
        return {"loss": loss, "grad": grad, "count": torch.sum(w)}

    return agg


def binary_logistic_pallas_scaled(d: int, fit_intercept: bool = True) -> Agg:
    """Kernel twin of :func:`binary_logistic_scaled`: the row pass is K1
    (``ops/kernels.fused_binary_logistic_scaled``), standardization is
    folded around it, and X is read once per evaluation at its storage
    width."""
    from cycloneml_tpu_torch.ops.kernels import fused_binary_logistic_scaled

    def agg(x, y, w, inv_std, scaled_mean, coef):
        return fused_binary_logistic_scaled(
            x, y, w, inv_std, scaled_mean, coef, d, fit_intercept)

    return agg
