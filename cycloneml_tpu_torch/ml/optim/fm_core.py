"""Factorization-machine training core shared by FMClassifier/FMRegressor,
the port of the reference's ``ml/optim/fm_core.py`` (ref:
ml/regression/FMRegressor.scala — ``trainImpl`` runs mini-batch gradient
descent with the AdamW or plain GD updater over the combined coefficients
[factors, linear?, intercept?]; FMClassifier reuses it with the logistic
loss).

The loss of a step is summed over row chunks on the dataset's device, its
gradient by ``torch.autograd`` (the reference's ``jax.grad``). The update
is the port's own, written to optax's formulas (the reference's
``optax.adamw`` and ``optax.sgd``): bias-corrected moments, eps outside
the square root, decoupled weight decay ``regParam``. A mini-batch mask
below ``miniBatchFraction=1.0`` draws the port's own bits
(``gradient_descent.sample_weights``: a generator seeded by a SplitMix64
mix of (seed, step)); the reference draws ``jax.random``'s.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
from cycloneml_tpu_torch.ml.optim.aggregators import precision_scope
from cycloneml_tpu_torch.ml.optim.gradient_descent import sample_weights

ROW_CHUNK = 1 << 16  # rows whose loss and gradient are taken at a time
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # the reference's AdamW


def fm_margin(x: torch.Tensor, coef: torch.Tensor, d: int, k: int,
              fit_intercept: bool, fit_linear: bool) -> torch.Tensor:
    """margin_i = b + x·w + ½ Σ_f [(x·V_f)² − (x²)·(V_f²)]; V is (d, k)."""
    V = coef[: d * k].reshape(d, k)
    off = d * k
    w = None
    if fit_linear:
        w = coef[off: off + d]
        off += d
    s = x @ V                                                   # (bsz, k)
    margin = 0.5 * torch.sum(s * s - (x * x) @ (V * V), dim=1)
    if fit_intercept:
        margin = margin + coef[off]
    if w is not None:
        margin = margin + x @ w
    return margin


def fm_loss_grad(ds: InstanceDataset, coef: torch.Tensor, d: int, k: int,
                 loss_type: str, fit_intercept: bool, fit_linear: bool,
                 w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Σ w·loss, its gradient) over the dataset's rows with weights ``w``
    (the mask applied), at coef's dtype: the logistic loss softplus(m) −
    y m (``torch.logaddexp(m, 0)``, jax's softplus) or the squared error
    ½ (m − y)²."""
    x, y = ds.x, ds.y
    c = coef.detach().requires_grad_(True)
    loss = torch.zeros((), dtype=coef.dtype, device=coef.device)
    grad = torch.zeros_like(coef)
    for lo in range(0, x.shape[0], ROW_CHUNK):
        xc = x[lo:lo + ROW_CHUNK].to(coef.dtype)
        yc = y[lo:lo + ROW_CHUNK].to(coef.dtype)
        m = fm_margin(xc, c, d, k, fit_intercept, fit_linear)
        if loss_type == "logistic":
            per = torch.logaddexp(m, torch.zeros_like(m)) - yc * m
        else:  # squaredError
            per = 0.5 * (m - yc) ** 2
        part = torch.sum(w[lo:lo + ROW_CHUNK] * per)
        g, = torch.autograd.grad(part, c)
        loss = loss + part.detach()
        grad = grad + g
    return loss, grad


class AdamW:
    """optax.adamw(lr, b1, b2, eps, weight_decay) written out: moments
    m = (1 − b1) g + b1 m, v = (1 − b2) g² + b2 v; the update
    m̂ / (√v̂ + eps) + weight_decay · params with m̂ = m / (1 − b1^t),
    v̂ = v / (1 − b2^t), scaled by −lr and added to the parameters."""

    def __init__(self, lr: float, weight_decay: float, params: torch.Tensor):
        self.lr, self.wd = lr, weight_decay
        self.mu = torch.zeros_like(params)
        self.nu = torch.zeros_like(params)
        self.count = 0

    def step(self, params: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        self.count += 1
        self.mu = (1 - ADAM_B1) * g + ADAM_B1 * self.mu
        self.nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * self.nu
        mu_hat = self.mu / (1 - ADAM_B1 ** self.count)
        nu_hat = self.nu / (1 - ADAM_B2 ** self.count)
        upd = mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS) + self.wd * params
        return params + (-self.lr) * upd


def train_fm(ds: InstanceDataset, d: int, loss_type: str, factor_size: int,
             fit_intercept: bool, fit_linear: bool, reg_param: float,
             mini_batch_fraction: float, init_std: float, max_iter: int,
             step_size: float, tol: float, solver: str, seed: int,
             ) -> Tuple[np.ndarray, list]:
    """Returns (coef, objective_history). coef layout = [V, w?, b?]."""
    k = factor_size
    frac = mini_batch_fraction
    n_coef = d * k + (d if fit_linear else 0) + (1 if fit_intercept else 0)
    rng = np.random.RandomState(seed)
    coef = np.zeros(n_coef)
    coef[: d * k] = rng.randn(d * k) * init_std

    dev, dtype = ds.w.device, ds.w.dtype  # the accumulator tier
    coef_t = torch.as_tensor(coef, device=dev).to(dtype)
    adam = AdamW(step_size, reg_param, coef_t) if solver == "adamW" else None
    history = []
    prev = np.inf
    with precision_scope("highest", dev):
        for t in range(max_iter):
            w = ds.w if frac >= 1.0 else sample_weights(ds.w, frac, seed, t)
            wsum_t = torch.sum(w)
            loss_t, grad = fm_loss_grad(ds, coef_t, d, k, loss_type,
                                        fit_intercept, fit_linear, w)
            wsum, loss_sum = float(wsum_t), float(loss_t)
            if wsum <= 0:
                continue
            loss = loss_sum / wsum
            history.append(loss)
            g = grad / max(wsum, 1e-300)
            if adam is not None:
                coef_t = adam.step(coef_t, g)
            else:  # gd: L2 for plain gd (ref SquaredL2Updater), then sgd
                if reg_param > 0:
                    g = g + reg_param * coef_t
                coef_t = coef_t + (-step_size) * g
            if frac >= 1.0 and abs(prev - loss) < tol * max(abs(prev), 1.0):
                prev = loss
                break
            prev = loss
    return coef_t.to(torch.float64).cpu().numpy(), history


def split_fm_coef(coef: np.ndarray, d: int, k: int, fit_intercept: bool,
                  fit_linear: bool):
    V = coef[: d * k].reshape(d, k)
    off = d * k
    w = coef[off: off + d] if fit_linear else np.zeros(d)
    if fit_linear:
        off += d
    b = float(coef[off]) if fit_intercept else 0.0
    return V, w, b


def fm_margin_np(x: np.ndarray, V: np.ndarray, w: np.ndarray, b: float):
    s = x @ V
    quad = 0.5 * ((s * s) - (x * x) @ (V * V)).sum(axis=1)
    return b + x @ w + quad
