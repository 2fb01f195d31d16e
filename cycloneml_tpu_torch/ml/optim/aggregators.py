"""Block aggregators — the per-shard loss/gradient sums.

The port's counterpart of ``cycloneml_tpu/ml/optim/aggregators.py`` (binary
logistic and least-squares families). Every aggregator has the signature ``agg(x, y, w, ...,
coef) -> {"loss", "grad", "count"}`` over a shard whose padding rows carry
w=0, and returns SUMS; ``tree_aggregate`` adds them over the mesh and the
loss function divides by the weight sum. Coefficient layout:
``[w_0 .. w_{d-1}, intercept?]``.

The ``binary_logistic*`` and ``least_squares*`` aggregators are plain
PyTorch; the ``_pallas`` twins (the reference's names, so the two packages
line up) run kernels K1 and K2.

Model-axis twins (:func:`stack_aggregator`, :func:`stack_scaled_aggregator`,
the reference's ``jax.vmap`` of a binomial aggregator) take labels ``(n, K)``
and coefficients ``(K, n_coef)`` over one shared X and return ``{"loss"
(K,), "grad" (K, n_coef), "count" (K,)}``: a batched plain PyTorch twin of
each plain binomial aggregator, and for the kernel twin one launch of K1s
(``ops/kernels.glm_sweep_stacked``) per evaluation, never K launches of K1.
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
    """``a @ b`` (``a`` 2-D, ``b`` 1-D, or 2-D for the model-axis twins)
    across the data/accumulator tier
    boundary.

    Full-width operands multiply as they are, the narrower one promoted
    (the reference's dtype promotion). When ``a`` is narrow (a bf16 X, the
    fp8 rung's e4m3 codes, or a transpose of either), X is upcast
    ``ROW_CHUNK`` rows at a time (never a full-width copy; the upcast of a
    code is exact) and multiplied by ``b`` at ``acc`` width (default
    ``b``'s dtype), so the products and sums are those of the kernels,
    which read X narrow and keep the vector operand at full width.

    This is the reference's KERNEL route, and the port follows it on both
    narrow rungs. The reference's jnp route (its ``_tier_dot``) instead
    rounds ``b`` (the coefficients, the multipliers) down to X's width:
    bf16, or e4m3 on the fp8 rung. For least squares that rounding is not
    benign even at bf16: the residual x.b - y/sigma_y cancels to ~1e-3 of
    the margin, and a bf16-rounded b moves the margin by about as much (at
    the LinearRegression configuration, 400,000 x 2,000, it left the plain
    fit's objective 4.5e-3 above the kernel fit's). On the fp8 rung, a
    600 x 12 logistic fit (regParam 0.01) lands 9.0% (max|dcoef| /
    max|coef|) from the float32-tier fit through the reference's jnp route
    and 1.2% through its kernel route, 8.4% apart from each other; the
    port's plain path agrees with the kernel route to the kernel-vs-plain
    bound (tests/test_torch_fp8.py).
    """
    if not is_narrow_dtype(a.dtype):
        if a.dtype != b.dtype:
            wide = torch.promote_types(a.dtype, b.dtype)
            a, b = a.to(wide), b.to(wide)
        return a @ b
    if acc is None:
        acc = b.dtype
    bw = b.to(acc)
    # chunk along X's rows, a's long axis: a's rows for X @ beta, its
    # contraction axis for X.T @ mult (chunk products summed in order)
    if a.shape[0] >= a.shape[1]:
        return torch.cat([a[lo:lo + ROW_CHUNK].to(acc) @ bw
                          for lo in range(0, a.shape[0], ROW_CHUNK)])
    out = torch.zeros((a.shape[0],) + tuple(bw.shape[1:]), dtype=acc,
                      device=a.device)
    for lo in range(0, a.shape[1], ROW_CHUNK):
        out += a[:, lo:lo + ROW_CHUNK].to(acc) @ bw[lo:lo + ROW_CHUNK]
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

    def stacked(x, Y, w, coef):
        beta, b0 = _split_stack(coef, d, fit_intercept)
        margin = _tier_dot(x, beta.T) + b0
        loss = torch.sum(w[:, None] * (_softplus(margin) - Y * margin), dim=0)
        mult = w[:, None] * (torch.sigmoid(margin) - Y)
        g = _tier_dot(x.T, mult).T
        grad = torch.cat([g, torch.sum(mult, dim=0)[:, None]], dim=1) \
            if fit_intercept else g
        return {"loss": loss, "grad": grad,
                "count": torch.sum(w).expand(coef.shape[0])}

    agg.stacked = stacked
    return agg


def _split_stack(coef, d, fit_intercept):
    """``(beta (K, d), b0 (K,))`` of stacked coefficients ``(K, n_coef)``."""
    if fit_intercept:
        return coef[:, :d], coef[:, d]
    return coef, torch.zeros(coef.shape[0], dtype=coef.dtype,
                             device=coef.device)


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

    def stacked(x, Y, w, inv_std, scaled_mean, coef):
        beta, b0 = _split_stack(coef, d, fit_intercept)
        sb = beta * inv_std
        margin = _tier_dot(x, sb.T) - beta @ scaled_mean + b0
        loss = torch.sum(w[:, None] * (_softplus(margin) - Y * margin), dim=0)
        mult = w[:, None] * (torch.sigmoid(margin) - Y)
        msum = torch.sum(mult, dim=0)
        g = inv_std * _tier_dot(x.T, mult).T \
            - scaled_mean[None, :] * msum[:, None]
        grad = torch.cat([g, msum[:, None]], dim=1) if fit_intercept else g
        return {"loss": loss, "grad": grad,
                "count": torch.sum(w).expand(coef.shape[0])}

    agg.stacked = stacked
    return agg


def binary_logistic_pallas_scaled(d: int, fit_intercept: bool = True) -> Agg:
    """Kernel twin of :func:`binary_logistic_scaled`: the row pass is K1
    (``ops/kernels.fused_binary_logistic_scaled``), standardization is
    folded around it, and X is read once per evaluation at its storage
    width."""
    from cycloneml_tpu_torch.ops.kernels import (
        fused_binary_logistic_scaled, fused_binary_logistic_stacked_scaled)

    def agg(x, y, w, inv_std, scaled_mean, coef):
        return fused_binary_logistic_scaled(
            x, y, w, inv_std, scaled_mean, coef, d, fit_intercept)

    def stacked(x, Y, w, inv_std, scaled_mean, coef):
        return fused_binary_logistic_stacked_scaled(
            x, Y, w, inv_std, scaled_mean, coef, d, fit_intercept)

    agg.stacked = stacked
    return agg


def least_squares(d: int, fit_intercept: bool = True) -> Agg:
    """Squared loss 1/2 w (x.beta + b0 - y)^2 (ref
    LeastSquaresBlockAggregator)."""

    def agg(x, y, w, coef):
        beta, b0 = _split_coef(coef, d, fit_intercept)
        err = _tier_dot(x, beta) + b0 - y
        loss = 0.5 * torch.sum(w * err * err)
        mult = w * err
        g = _tier_dot(x.T, mult)
        grad = torch.cat([g, torch.sum(mult).reshape(1)]) \
            if fit_intercept else g
        return {"loss": loss, "grad": grad, "count": torch.sum(w)}

    return agg


def least_squares_scaled(d: int) -> Agg:
    """Least-squares twin of :func:`binary_logistic_scaled`: the
    LinearRegression l-bfgs objective over RAW feature rows with the
    doubly-standardized problem folded into the read. With
    ``sb = inv_std o beta`` and ``y_pars = [1/sigma_y, y_mean_hat]``:

      err = x.sb - (scaled_mean.beta - y_mean_hat) - y / sigma_y
      grad = inv_std o (x.T mult) - scaled_mean sum(mult)

    so neither a standardized X nor a scaled y exists. Signature
    ``agg(x, y, w, inv_std, scaled_mean, y_pars, coef)``; pass
    ``scaled_mean = zeros`` and ``y_pars[1] = 0`` for the uncentered
    objective. No intercept coordinate: the caller recovers it in closed
    form."""

    def agg(x, y, w, inv_std, scaled_mean, y_pars, coef):
        sb = inv_std * coef
        off = torch.dot(scaled_mean, coef) - y_pars[1]
        err = _tier_dot(x, sb) - off - y * y_pars[0]
        loss = 0.5 * torch.sum(w * err * err)
        mult = w * err
        msum = torch.sum(mult)
        g = inv_std * _tier_dot(x.T, mult) - scaled_mean * msum
        return {"loss": loss, "grad": g, "count": torch.sum(w)}

    return agg


def least_squares_pallas_scaled(d: int) -> Agg:
    """Kernel twin of :func:`least_squares_scaled`: the residual sweep is
    K2 (``ops/kernels.fused_least_squares_scaled``), standardization and
    the label scaling are folded around it, and X is read once per
    evaluation at its storage width."""
    from cycloneml_tpu_torch.ops.kernels import fused_least_squares_scaled

    def agg(x, y, w, inv_std, scaled_mean, y_pars, coef):
        return fused_least_squares_scaled(
            x, y, w, inv_std, scaled_mean, y_pars, coef, d)

    return agg


def stack_aggregator(agg: Agg) -> Agg:
    """Model-axis twin of a plain ``(x, y, w, coef)`` binomial aggregator
    (the reference's ``jax.vmap(agg, in_axes=(None, 1, None, 0))``): labels
    ``(n, K)``, coefficients ``(K, n_coef)``, x and w shared; returns
    ``{loss (K,), grad (K, n_coef), count (K,)}``, so ``tree_aggregate``
    sums all K models' partials in one reduction with a leading model
    axis."""
    twin = getattr(agg, "stacked", None)
    if twin is None:
        raise ValueError(f"aggregator {agg!r} has no model-axis twin (the "
                         "port stacks the binomial logistic aggregators)")
    return twin


def stack_scaled_aggregator(agg: Agg) -> Agg:
    """Model-axis twin of a scaled aggregator ``(x, y, w, inv_std,
    scaled_mean, coef)`` (the reference's ``jax.vmap(agg, in_axes=(None, 1,
    None, None, None, 0))``): labels ``(n, K)`` and coefficients ``(K,
    n_coef)``, everything else, the standardization vectors too, shared.
    For :func:`binary_logistic_pallas_scaled` it is one K1s launch per
    evaluation (per group of ``ops/kernels.K_MAX`` models)."""
    return stack_aggregator(agg)
