"""Distributed loss function — the treeAggregate gradient reduction.

The port's counterpart of ``cycloneml_tpu/ml/optim/loss.py``: the aggregator
is summed over the mesh by ``tree_aggregate``, normalized by the weight sum,
and the L2 penalty is added. :func:`wolfe_search` is the reference's strong-
Wolfe state machine run as a host loop: the trial gradients stay on the
device and only the two scalars it branches on (the value and the
directional derivative) are read back per evaluation.

The stacked (model-axis) twins carry K binomial objectives over one shared
X: :class:`StackedDistributedLossFunction` evaluates all K in one
aggregation, with the per-model L2 penalty as runtime data
(:func:`stacked_l2_scale`, :func:`stacked_host_l2`), and
:func:`wolfe_search` takes a batched form in which every model walks its
own bracket+zoom in lockstep evaluations.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
from cycloneml_tpu_torch.dataset.instance import compute_dtype
from cycloneml_tpu_torch.ml.optim import aggregators


def _weight_sum_agg(x, y, w):
    return {"ws": torch.sum(w)}


class DistributedLossFunction:
    """Callable ``(coef) -> (loss, grad)`` in float64 host space, plus the
    device-side :meth:`f_and_g` the device optimizer evaluates.

    - ``dataset``: an ``InstanceDataset`` or a ``SparseInstanceDataset``
      (whose aggregators, ``sparse_aggregators``, take its rows as one
      block);
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
        precision = aggregators.matmul_precision()
        base = dataset.tree_aggregate_fn(agg)
        extra = tuple(extra_args)
        # w lies beside the rows on both tiers (a sparse dataset has no x)
        self.device = dataset.w.device

        def call(*coef):
            with aggregators.precision_scope(precision, self.device):
                return base(*extra, *coef)

        call.compiled = base.compiled
        call.arrays = lambda: base.arrays() + extra
        self._agg_call = call
        self._ctx = dataset.ctx
        self.cdt = compute_dtype(getattr(dataset.ctx, "conf", None))
        self.l2_reg_fn = l2_reg_fn
        if weight_sum is None and not isinstance(dataset, InstanceDataset):
            weight_sum = float(torch.sum(dataset.w))
        elif weight_sum is None:
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
                 c1: float, c2: float, max_evals: int, cdt: torch.dtype,
                 active=None):
    """Strong-Wolfe bracket+zoom (Nocedal-Wright alg 3.5/3.6): the
    reference's ``loss.wolfe_search`` state machine, step for step, as a
    host loop.

    ``phi(alpha) -> (value, grad, dg)`` with 0-d tensors for the value and
    the directional derivative, which are read back together (one sync per
    evaluation); the gradient stays on the device. Scalars are carried in
    the accumulator dtype ``cdt``, as the reference carries them. Returns
    ``(alpha, value, grad, evals)``.

    Batched (model-axis) form: when ``value0``, ``dg0`` and ``init_alpha``
    are ``(K,)`` arrays (``g_zero`` then ``(K, n)``), every model walks its
    own trajectory in lockstep evaluations, ``phi`` taking and returning
    ``(K,)`` values (one readback of all K values and directional
    derivatives per evaluation); a model whose search ended keeps its state
    while the others go on. ``active`` (``(K,)`` bool) starts the models it
    marks False in the done phase with no evaluation. ``evals`` is then
    ``(K,)``, counting each model's live steps; the lockstep count is
    ``evals.max()``.
    """
    if np.ndim(value0) > 0:
        return _wolfe_search_batched(phi, g_zero, value0, dg0, init_alpha,
                                     c1, c2, max_evals, cdt, active)
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


def _wolfe_search_batched(phi, g_zero, value0, dg0, init_alpha, c1, c2,
                          max_evals, cdt, active):
    """The batched form of :func:`wolfe_search`: the reference's
    ``while_loop`` state, each field a ``(K,)`` host array, with every
    update selected through for the models whose search had already ended
    (``live``), as the reference's per-model freeze does."""
    t = np.float64 if cdt == torch.float64 else np.float32
    value0 = np.asarray(value0, dtype=t)
    dg0 = np.asarray(dg0, dtype=t)
    zero = np.zeros(value0.shape, dtype=t)
    izero = np.zeros(value0.shape, dtype=np.int64)
    phase = izero.copy() if active is None else \
        np.where(np.asarray(active), 0, 2)
    evals, bi, zj = izero.copy(), izero.copy(), izero.copy()
    alpha_prev, v_prev, d_prev = zero.copy(), value0 + zero, dg0 + zero
    alpha_next = np.asarray(init_alpha, dtype=t) + zero
    lo, hi, v_lo, d_lo, v_hi = (zero.copy() for _ in range(5))
    res_alpha, res_v, res_g = zero.copy(), value0 + zero, g_zero
    c1t, c2t, half, two = t(c1), t(c2), t(0.5), t(2.0)
    where = np.where
    while (phase < 2).any():
        live = phase < 2
        in_bracket = phase == 0
        alpha = where(in_bracket, alpha_next, half * (lo + hi))
        v_d, g, dg_d = phi(alpha)
        v, dg = (a.astype(t) for a in torch.stack(
            [v_d.to(cdt), dg_d.to(cdt)]).cpu().numpy())
        armijo_fail = v > value0 + c1t * alpha * dg0
        wolfe_ok = np.abs(dg) <= -c2t * dg0
        # bracket phase (alg 3.5)
        b_zoom_a = armijo_fail | ((bi > 0) & (v >= v_prev))
        b_done = ~b_zoom_a & wolfe_ok
        b_zoom_b = ~b_zoom_a & ~b_done & (dg >= 0)
        b_cont = ~(b_zoom_a | b_done | b_zoom_b)
        b_exhaust = b_cont & (bi + 1 >= max_evals)
        # zoom phase (alg 3.6)
        z_hi_a = armijo_fail | (v >= v_lo)
        z_done = ~z_hi_a & wolfe_ok
        z_flip = ~z_hi_a & ~z_done & (dg * (hi - lo) >= 0)
        z_hi = where(z_hi_a, alpha, where(z_flip, lo, hi))
        z_v_hi = where(z_hi_a, v, where(z_flip, v_lo, v_hi))
        z_lo = where(z_hi_a, lo, alpha)
        z_v_lo = where(z_hi_a, v_lo, v)
        z_d_lo = where(z_hi_a, d_lo, dg)
        z_exhaust = (np.abs(z_hi - z_lo) < 1e-12) | (zj + 1 >= max_evals)
        new_phase = where(in_bracket,
                          where(b_done | b_exhaust, 2,
                                where(b_zoom_a | b_zoom_b, 1, 0)),
                          where(z_done | z_exhaust, 2, 1))
        new_lo = where(in_bracket, where(b_zoom_a, alpha_prev, alpha), z_lo)
        new_v_lo = where(in_bracket, where(b_zoom_a, v_prev, v), z_v_lo)
        new_d_lo = where(in_bracket, where(b_zoom_a, d_prev, dg), z_d_lo)
        new_hi = where(in_bracket, where(b_zoom_a, alpha, alpha_prev), z_hi)
        new_v_hi = where(in_bracket, where(b_zoom_a, v, v_prev), z_v_hi)
        # the bracket records its result only on termination, the zoom on
        # every evaluation (the host zoom's running best)
        set_res = live & where(in_bracket, b_done | b_exhaust, True)
        step = live & in_bracket & b_cont
        alpha_prev = where(step, alpha, alpha_prev)
        v_prev = where(step, v, v_prev)
        d_prev = where(step, dg, d_prev)
        alpha_next = where(step, alpha * two, alpha_next)
        lo, v_lo, d_lo = (where(live, a, b) for a, b in
                          ((new_lo, lo), (new_v_lo, v_lo),
                           (new_d_lo, d_lo)))
        hi, v_hi = where(live, new_hi, hi), where(live, new_v_hi, v_hi)
        evals = evals + live
        bi = bi + (live & in_bracket)
        zj = zj + (live & ~in_bracket)
        phase = where(live, new_phase, phase)
        res_alpha = where(set_res, alpha, res_alpha)
        res_v = where(set_res, v, res_v)
        res_g = torch.where(torch.as_tensor(set_res, device=g.device)[:, None],
                            g, res_g)
    return res_alpha, res_v, res_g, evals


def validate_binary_labels(y: np.ndarray, what: str) -> None:
    """Reject labels outside {0, 1} (the reference's check: the ±1
    convention would silently corrupt the binomial losses)."""
    bad = ~np.isin(y, (0.0, 1.0))
    if bad.any():
        raise ValueError(
            f"{what} requires labels in {{0, 1}}, found "
            f"{np.unique(y[bad])[:5]}")


def stacked_l2_scale(d: int, n_coef: int,
                     features_std: Optional[np.ndarray] = None,
                     standardize: bool = True) -> np.ndarray:
    """Per-coordinate scale of the stacked L2 penalty ``0.5 reg_k
    sum_j coef_kj^2 scale_j``: 1 on the feature coordinates (1/std^2 when
    ``standardization=false`` computes the penalty in the original space),
    0 on the intercept; runtime data, so one stacked fit serves any
    per-model reg vector."""
    scale = np.zeros(n_coef)
    if standardize or features_std is None:
        scale[:d] = 1.0
    else:
        s = np.where(features_std > 0, features_std, 1.0)
        scale[:d] = 1.0 / (s * s)
    return scale


def stacked_host_l2(loss: np.ndarray, grad: np.ndarray,
                    coef_stack: np.ndarray, reg: np.ndarray,
                    l2_scale: Optional[np.ndarray]):
    """The per-model L2 penalty on a stacked host float64 (loss, grad)
    pair: ``loss_k += 0.5 reg_k sum_j coef_kj^2 scale_j``."""
    if l2_scale is None or not np.any(reg > 0):
        return loss, grad
    cs = np.asarray(coef_stack, dtype=np.float64)
    loss = loss + 0.5 * reg * np.sum(cs * cs * l2_scale[None, :], axis=1)
    grad = grad + reg[:, None] * cs * l2_scale[None, :]
    return loss, grad


class StackedDistributedLossFunction:
    """Model-axis twin of :class:`DistributedLossFunction`: K binomial
    objectives over ONE shared X.

    Callable ``(coef_stack (K, n_coef)) -> (loss (K,), grad (K, n_coef))``
    in host float64, plus the device-side :meth:`f_and_g` the stacked
    optimizer evaluates. ``dataset`` carries the ``(n_pad, K)`` label
    matrix as its ``y`` (``InstanceDataset.derive``) and ``agg`` is a
    model-axis aggregator (``aggregators.stack_scaled_aggregator``), so
    one aggregation evaluates all K models. The L2 term is runtime data:
    per-model ``reg`` ``(K,)`` and the shared per-coordinate ``l2_scale``
    of :func:`stacked_l2_scale`.
    """

    def __init__(self, dataset: InstanceDataset, agg: Callable,
                 n_models: int, reg: Optional[np.ndarray] = None,
                 l2_scale: Optional[np.ndarray] = None,
                 weight_sum: Optional[float] = None,
                 extra_args: tuple = ()):
        precision = aggregators.matmul_precision()
        base = dataset.tree_aggregate_fn(agg)
        extra = tuple(extra_args)
        self.device = dataset.x.device

        def call(*coef):
            with aggregators.precision_scope(precision, self.device):
                return base(*extra, *coef)

        self._agg_call = call
        self._ctx = dataset.ctx
        self.cdt = compute_dtype(getattr(dataset.ctx, "conf", None))
        self.n_models = int(n_models)
        self.reg = (np.zeros(self.n_models) if reg is None
                    else np.asarray(reg, dtype=np.float64))
        self.l2_scale = (None if l2_scale is None
                         else np.asarray(l2_scale, dtype=np.float64))
        if weight_sum is None:
            weight_sum = float(dataset.tree_aggregate_fn(_weight_sum_agg)()["ws"])
        self.weight_sum = weight_sum
        self.n_evals = 0        # batched evaluations (each covers all K)
        self.n_dispatches = 0   # host round trips: one per eval or chunk
        self._reg_d = torch.as_tensor(self.reg, device=self.device).to(
            self.cdt)
        self._l2s_d = None if self.l2_scale is None else torch.as_tensor(
            self.l2_scale, device=self.device).to(self.cdt)

    def f_and_g(self, coef: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Normalized losses ``(K,)`` and gradients ``(K, n_coef)`` at the
        device stack ``coef`` (accumulator dtype), left on the device; the
        L2 term as the reference's stacked chunk adds it."""
        out = self._agg_call(coef)
        loss = (out["loss"] / self.weight_sum).to(self.cdt)
        grad = (out["grad"] / self.weight_sum).to(self.cdt)
        if self._l2s_d is not None:
            loss = loss + 0.5 * self._reg_d * torch.sum(
                (coef * self._l2s_d) * coef, dim=1)
            grad = grad + self._reg_d[:, None] * coef * self._l2s_d
        return loss, grad

    def __call__(self, coef_stack: np.ndarray):
        self.n_evals += 1
        self.n_dispatches += 1
        coef_d = torch.as_tensor(np.asarray(coef_stack),
                                 device=self.device).to(self.cdt)
        out = self._agg_call(coef_d)
        loss = out["loss"].cpu().double().numpy() / self.weight_sum
        grad = out["grad"].cpu().double().numpy() / self.weight_sum
        loss, grad = stacked_host_l2(loss, grad, coef_stack, self.reg,
                                     self.l2_scale)
        if hasattr(self._ctx, "record_step"):
            self._ctx.record_step({"loss": float(np.mean(loss)),
                                   "n_models": self.n_models})
        return loss, grad


def inv_std_vector(features_std: np.ndarray) -> np.ndarray:
    """1/sigma per feature with zero-variance features excluded to 0 (the
    reference's featuresStd != 0 guard, LogisticRegression.scala:649)."""
    return np.where(features_std > 0, 1.0 / np.where(
        features_std > 0, features_std, 1.0), 0.0)


_STANDARDIZE_ROWS = 1 << 16  # rows of X standardized at a time


def standardize_dataset(ds: InstanceDataset, features_std: np.ndarray,
                        center_mean: Optional[np.ndarray] = None):
    """A standardized copy of X, ``(x - mu) / sigma`` (``x / sigma`` without
    ``center_mean``), in X's data tier (a bf16 X gives a bf16 copy), built
    a chunk of rows at a time at the accumulator width, so the copy is the
    only buffer the size of X. Zero-variance features scale to 0 (the
    reference's exclusion); padding rows keep w = 0. The reference keeps
    this copy for LinearSVC (its other fits fold standardization into the
    aggregator's read). Returns ``(standardized dataset, inv_std)``."""
    if ds.x_scale is not None:
        raise ValueError("standardize_dataset reads X as values: dequantize "
                         "fp8 codes first (fp8_fallback)")
    inv_std = inv_std_vector(features_std)
    x = ds.x
    cdt = ds.w.dtype
    s = torch.as_tensor(inv_std, device=x.device).to(cdt)
    mu = None if center_mean is None else torch.as_tensor(
        np.asarray(center_mean), device=x.device).to(cdt)
    out = torch.empty_like(x)
    for lo in range(0, x.shape[0], _STANDARDIZE_ROWS):
        xc = x[lo:lo + _STANDARDIZE_ROWS].to(cdt)
        if mu is not None:
            xc = xc - mu
        out[lo:lo + _STANDARDIZE_ROWS] = (xc * s).to(x.dtype)
    return ds.derive(x=out), inv_std


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
