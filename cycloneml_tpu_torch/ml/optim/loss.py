"""Distributed loss function — the treeAggregate gradient reduction.

The port's counterpart of ``cycloneml_tpu/ml/optim/loss.py``: the aggregator
is summed over the mesh by ``tree_aggregate``, normalized by the weight sum,
and the L2 penalty is added. :func:`wolfe_search` is the reference's strong-
Wolfe state machine run as a host loop: the trial gradients stay on the
device and only the two scalars it branches on (the value and the
directional derivative) are read back per evaluation.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
from cycloneml_tpu_torch.dataset.instance import compute_dtype


def _weight_sum_agg(x, y, w):
    return {"ws": torch.sum(w)}


class DistributedLossFunction:
    """Callable ``(coef) -> (loss, grad)`` in float64 host space, plus the
    device-side :meth:`f_and_g` the device optimizer evaluates.

    - ``agg``: a block aggregator (sums, not means);
    - ``l2_reg_fn``: optional L2 penalty from :func:`l2_regularization`;
    - ``extra_args``: replicated tensors the aggregator takes before the
      coefficients (inv_std and scaled_mean for the scaled aggregators).
    Loss and gradient are divided by the total weight, as the reference
    does.
    """

    def __init__(self, dataset: InstanceDataset, agg: Callable,
                 l2_reg_fn: Optional[Callable] = None,
                 weight_sum: Optional[float] = None,
                 extra_args: tuple = ()):
        base = dataset.tree_aggregate_fn(agg)
        extra = tuple(extra_args)

        def call(*coef):
            return base(*extra, *coef)

        call.compiled = base.compiled
        call.arrays = lambda: base.arrays() + extra
        self._agg_call = call
        self._ctx = dataset.ctx
        self.device = dataset.x.device
        self.cdt = compute_dtype(getattr(dataset.ctx, "conf", None))
        self.l2_reg_fn = l2_reg_fn
        if weight_sum is None:
            weight_sum = float(dataset.tree_aggregate_fn(_weight_sum_agg)()["ws"])
        self.weight_sum = weight_sum
        self.n_evals = 0
        self.n_dispatches = 0  # host round trips: one per eval or search

    def _record(self, metrics) -> None:
        if hasattr(self._ctx, "record_step"):
            self._ctx.record_step(metrics)

    def f_and_g(self, coef: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Normalized loss and gradient at ``coef`` (a device tensor in the
        accumulator dtype), both left on the device."""
        out = self._agg_call(coef)
        loss = (out["loss"] / self.weight_sum).to(self.cdt)
        grad = (out["grad"] / self.weight_sum).to(self.cdt)
        if self.l2_reg_fn is not None:
            rl, rg = self.l2_reg_fn.traceable(coef)
            loss = loss + rl
            grad = grad + rg
        return loss, grad

    def __call__(self, coef: np.ndarray) -> Tuple[float, np.ndarray]:
        self.n_evals += 1
        self.n_dispatches += 1
        coef_d = torch.as_tensor(np.asarray(coef), device=self.device).to(self.cdt)
        out = self._agg_call(coef_d)
        loss = float(out["loss"]) / self.weight_sum
        grad = out["grad"].cpu().double().numpy() / self.weight_sum
        if self.l2_reg_fn is not None:
            rl, rg = self.l2_reg_fn(np.asarray(coef, dtype=np.float64))
            loss += float(rl)
            grad += np.asarray(rg, dtype=np.float64)
        self._record({"loss": loss})
        return loss, grad

    def device_line_search(self, x: np.ndarray, direction: np.ndarray,
                           value: float, dg0: float, init_alpha: float,
                           c1: float, c2: float, max_evals: int):
        """The whole strong-Wolfe search with the trial points and
        gradients on the device (one round trip in the reference's
        accounting). Returns ``(alpha, value_new, grad_new)`` in host
        float64, or None when the penalty has no device twin."""
        if self.l2_reg_fn is not None and \
                not hasattr(self.l2_reg_fn, "traceable"):
            return None
        cdt = self.cdt
        x0 = torch.as_tensor(np.asarray(x), device=self.device).to(cdt)
        dirn = torch.as_tensor(np.asarray(direction),
                               device=self.device).to(cdt)

        def phi(alpha):
            v, g = self.f_and_g(x0 + float(alpha) * dirn)
            return v, g, torch.dot(dirn, g)

        alpha, v, g, evals = wolfe_search(
            phi, torch.zeros_like(x0), value, dg0, init_alpha, c1, c2,
            max_evals, cdt)
        self.n_evals += evals
        self.n_dispatches += 1
        self._record({"loss": float(v), "line_search_evals": evals})
        return float(alpha), float(v), g.cpu().double().numpy()


def wolfe_search(phi, g_zero: torch.Tensor, value0, dg0, init_alpha,
                 c1: float, c2: float, max_evals: int, cdt: torch.dtype):
    """Strong-Wolfe bracket+zoom (Nocedal-Wright alg 3.5/3.6): the
    reference's ``loss.wolfe_search`` state machine, step for step, as a
    host loop.

    ``phi(alpha) -> (value, grad, dg)`` with 0-d tensors for the value and
    the directional derivative, which are read back together (one sync per
    evaluation); the gradient stays on the device. Scalars are carried in
    the accumulator dtype ``cdt``, as the reference carries them. Returns
    ``(alpha, value, grad, evals)``.
    """
    t = np.float64 if cdt == torch.float64 else np.float32
    value0, dg0 = t(value0), t(dg0)
    zero = t(0.0)
    phase, evals, bi, zj = 0, 0, 0, 0   # phase: 0 bracket, 1 zoom, 2 done
    alpha_prev, v_prev, d_prev = zero, value0, dg0
    alpha_next = t(init_alpha)
    lo = hi = v_lo = d_lo = v_hi = zero
    res_alpha, res_v, res_g = zero, value0, g_zero
    while phase < 2:
        in_bracket = phase == 0
        alpha = alpha_next if in_bracket else t(0.5) * (lo + hi)
        v_d, g, dg_d = phi(alpha)
        v, dg = (t(s) for s in torch.stack([v_d.to(cdt), dg_d.to(cdt)])
                 .tolist())
        armijo_fail = v > value0 + t(c1) * alpha * dg0
        wolfe_ok = abs(dg) <= -t(c2) * dg0
        set_res = True
        if in_bracket:
            zoom_a = armijo_fail or (bi > 0 and v >= v_prev)
            done = (not zoom_a) and wolfe_ok
            zoom_b = (not zoom_a) and (not done) and dg >= 0
            cont = not (zoom_a or done or zoom_b)
            exhaust = cont and bi + 1 >= max_evals
            phase = 2 if (done or exhaust) else (1 if (zoom_a or zoom_b)
                                                 else 0)
            if zoom_a:
                lo, v_lo, d_lo, hi, v_hi = (alpha_prev, v_prev, d_prev,
                                            alpha, v)
            else:
                lo, v_lo, d_lo, hi, v_hi = alpha, v, dg, alpha_prev, v_prev
            set_res = done or exhaust
            if cont:
                alpha_prev, v_prev, d_prev = alpha, v, dg
                alpha_next = alpha * t(2.0)
            bi += 1
        else:
            hi_a = armijo_fail or v >= v_lo
            done = (not hi_a) and wolfe_ok
            flip = (not hi_a) and (not done) and dg * (hi - lo) >= 0
            if hi_a:
                hi, v_hi = alpha, v
            else:
                if flip:
                    hi, v_hi = lo, v_lo
                lo, v_lo, d_lo = alpha, v, dg
            exhaust = abs(hi - lo) < 1e-12 or zj + 1 >= max_evals
            phase = 2 if (done or exhaust) else 1
            zj += 1
        evals += 1
        if set_res:
            res_alpha, res_v, res_g = alpha, v, g
    return res_alpha, res_v, res_g, evals


def inv_std_vector(features_std: np.ndarray) -> np.ndarray:
    """1/sigma per feature with zero-variance features excluded to 0 (the
    reference's featuresStd != 0 guard, LogisticRegression.scala:649)."""
    return np.where(features_std > 0, 1.0 / np.where(
        features_std > 0, features_std, 1.0), 0.0)


def l2_regularization(reg_param: float, d: int, fit_intercept: bool,
                      features_std: Optional[np.ndarray] = None,
                      standardize: bool = True) -> Optional[Callable]:
    """The L2 penalty on the feature coefficients (never the intercept),
    or None for ``reg_param == 0``."""
    if standardize:
        return _l2_standardized(float(reg_param), int(d), bool(fit_intercept))
    return _l2_regularization(reg_param, d, fit_intercept, features_std,
                              standardize)


def _l2_standardized(reg_param: float, d: int, fit_intercept: bool):
    return _l2_regularization(reg_param, d, fit_intercept, None, True)


def _l2_regularization(reg_param: float, d: int, fit_intercept: bool,
                       features_std: Optional[np.ndarray] = None,
                       standardize: bool = True) -> Optional[Callable]:
    """L2 penalty with the reference's L2RegFunction semantics: applied to
    the feature coefficients only; with ``standardization=false`` it is
    computed in the ORIGINAL feature space (each beta_j / std_j squared)
    although training runs in standardized space.

    Returns ``fn(coef: np.ndarray) -> (loss, grad)`` in host float64, with
    ``fn.traceable`` its twin on device tensors."""
    if reg_param == 0.0:
        return None
    std = None
    if not standardize:
        if features_std is None:
            raise ValueError("features_std required when standardization=false")
        std = np.where(features_std > 0, features_std, 1.0)

    def fn(coef: np.ndarray):
        beta = coef[:d]
        if std is None:
            loss = 0.5 * reg_param * np.dot(beta, beta)
            gbeta = reg_param * beta
        else:
            b = beta / std
            loss = 0.5 * reg_param * np.dot(b, b)
            gbeta = reg_param * beta / (std * std)
        grad = np.concatenate([gbeta, np.zeros(coef.shape[0] - d)])
        return loss, grad

    def traceable(coef: torch.Tensor):
        beta = coef[:d]
        if std is None:
            loss = 0.5 * reg_param * torch.dot(beta, beta)
            gbeta = reg_param * beta
        else:
            s = torch.as_tensor(std, dtype=coef.dtype, device=coef.device)
            b = beta / s
            loss = 0.5 * reg_param * torch.dot(b, b)
            gbeta = reg_param * beta / (s * s)
        grad = torch.cat([gbeta, torch.zeros(coef.shape[0] - d,
                                             dtype=coef.dtype,
                                             device=coef.device)])
        return loss, grad

    fn.traceable = traceable
    return fn
