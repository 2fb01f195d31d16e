"""Weibull AFT survival regression, the port of the reference's
``ml/regression/aft.py`` (ref: ml/regression/AFTSurvivalRegression.scala
— AFTAggregator loss/gradient, L-BFGS over [β, intercept, log σ]). The
gradient of the censored Weibull log-likelihood comes from
``torch.autograd`` through the block loss (the reference's ``jax.grad``),
summed over the dataset's rows on its device, into the host ``LBFGS``,
with the reference's initial values and standardization.

log-likelihood per instance (t=label, δ=censor, ε=(log t − Xβ − b)/σ):
    ll = δ·(ε − log σ) − exp(ε)          (constants in t dropped)

The censor indicator rides as column 0 of the device block; the dataset's
``w`` slot is the validity mask (padding rows contribute nothing — the
−exp(ε) term is NOT weight-neutral, unlike the weighted losses, so a mask is
required rather than w=0 alone).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
from cycloneml_tpu_torch.dataset.frame import MLFrame
from cycloneml_tpu_torch.linalg.vectors import DenseVector, Vectors
from cycloneml_tpu_torch.ml.base import PredictionModel, Predictor
from cycloneml_tpu_torch.ml.optim.aggregators import precision_scope
from cycloneml_tpu_torch.ml.optim.lbfgs import LBFGS
from cycloneml_tpu_torch.ml.shared import (
    HasAggregationDepth, HasFitIntercept, HasLabelCol, HasMaxIter, HasTol,
)
from cycloneml_tpu_torch.ml.util_io import MLReadable, MLWritable, load_arrays, save_arrays
from cycloneml_tpu_torch.util.logging import get_logger

logger = get_logger(__name__)

ROW_CHUNK = 1 << 18  # rows whose loss and gradient are taken at a time


def aft_loss_grad(ds: InstanceDataset, params: torch.Tensor, d: int,
                  fit_intercept: bool):
    """(−Σ mask·ll, its gradient) at ``params`` = [β, b, log σ] over the
    dataset's rows (column 0 of X the censor δ, y = log t, w the mask), in
    row chunks at params' dtype, the gradient by autograd."""
    q = params.detach().requires_grad_(True)
    beta, icpt, log_sigma = q[:d], q[d], q[d + 1]
    sigma = torch.exp(log_sigma)
    loss = torch.zeros((), dtype=params.dtype, device=params.device)
    grad = torch.zeros_like(params)
    x, logy, mask = ds.x, ds.y, ds.w
    with precision_scope("highest", params.device):
        for lo in range(0, x.shape[0], ROW_CHUNK):
            blk = x[lo:lo + ROW_CHUNK].to(params.dtype)
            delta, xf = blk[:, 0], blk[:, 1:]
            eta = xf @ beta
            if fit_intercept:
                eta = eta + icpt
            eps = (logy[lo:lo + ROW_CHUNK].to(params.dtype) - eta) / sigma
            ll = delta * (eps - log_sigma) - torch.exp(eps)
            part = -torch.sum(mask[lo:lo + ROW_CHUNK].to(params.dtype) * ll)
            g, = torch.autograd.grad(part, q, retain_graph=True)
            loss = loss + part.detach()
            grad = grad + g
    return loss, grad


class _AFTParams(HasMaxIter, HasTol, HasFitIntercept, HasAggregationDepth,
                 HasLabelCol):
    def _declare_aft_params(self):
        self._p_label_col()
        self._p_max_iter(100)
        self._p_tol(1e-6)
        self._p_fit_intercept(True)
        self._p_aggregation_depth(2)
        self._param("censorCol", "censor column (1=event, 0=censored)",
                    default="censor")
        self._param("quantileProbabilities", "quantiles to predict",
                    default=[0.01, 0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99])
        self._param("quantilesCol", "quantiles output column", default="")

    def set_censor_col(self, v):
        return self.set("censorCol", v)

    def set_quantile_probabilities(self, v):
        """(ref AFTSurvivalRegression[Model].setQuantileProbabilities)"""
        return self.set("quantileProbabilities", list(v))

    def set_quantiles_col(self, v):
        return self.set("quantilesCol", v)


class AFTSurvivalRegression(Predictor, _AFTParams, MLWritable, MLReadable):
    def __init__(self, uid=None, **kwargs):
        super().__init__(uid)
        self._declare_aft_params()
        for k, v in kwargs.items():
            self.set(k, v)

    def _fit(self, frame: MLFrame) -> "AFTSurvivalRegressionModel":
        x = np.asarray(frame[self.get("featuresCol")], dtype=np.float64)
        y = np.asarray(frame[self.get("labelCol")], dtype=np.float64)
        censor = np.asarray(frame[self.get("censorCol")], dtype=np.float64)
        return self._fit_arrays(x, y, censor)

    def _fit_arrays(self, x, y, censor) -> "AFTSurvivalRegressionModel":
        from cycloneml_tpu_torch.context import CycloneContext

        n, d = x.shape
        if np.any(y <= 0):
            raise ValueError("AFT labels must be positive survival times")

        # feature standardization without centering (ref trainImpl: scales by
        # 1/std so L-BFGS conditioning matches; coefficients unscaled at end)
        std = x.std(axis=0, ddof=0)
        inv_std = np.where(std > 0, 1.0 / np.where(std > 0, std, 1.0), 0.0)
        x_std = x * inv_std[None, :]

        ctx = CycloneContext.get_or_create()
        x_dev = np.concatenate([censor[:, None], x_std], axis=1)
        ds = InstanceDataset.from_numpy(ctx, x_dev, np.log(y), None)
        fit_icpt = self.get("fitIntercept")
        dev, dtype = ds.w.device, ds.w.dtype
        n_total = float(n)

        def loss_fn(params):
            p = torch.as_tensor(np.asarray(params), device=dev).to(dtype)
            loss, grad = aft_loss_grad(ds, p, d, fit_icpt)
            return (float(loss) / n_total,
                    grad.to(torch.float64).cpu().numpy() / n_total)

        opt = LBFGS(max_iter=self.get("maxIter"), tol=self.get("tol"))
        x0 = np.zeros(d + 2)  # β=0, b=0, log σ=0 (ref initial values)
        state = opt.minimize(loss_fn, x0)
        sol = state.x
        coef = sol[:d] * inv_std
        icpt = float(sol[d]) if fit_icpt else 0.0
        scale = float(np.exp(sol[d + 1]))

        model = AFTSurvivalRegressionModel(coef, icpt, scale, uid=self.uid)
        self._copy_values(model)
        model._set_parent(self)
        model.loss_history = list(state.loss_history)
        return model


class AFTSurvivalRegressionModel(PredictionModel, _AFTParams,
                                 MLWritable, MLReadable):
    def __init__(self, coefficients: Optional[np.ndarray] = None,
                 intercept: float = 0.0, scale: float = 1.0, uid=None):
        super().__init__(uid)
        self._declare_aft_params()
        self._coef = np.asarray(coefficients) if coefficients is not None else None
        self._icpt = float(intercept)
        self._scale = float(scale)
        self.loss_history: List[float] = []

    @property
    def coefficients(self) -> DenseVector:
        return Vectors.dense(self._coef)

    @property
    def intercept(self) -> float:
        return self._icpt

    @property
    def scale(self) -> float:
        return self._scale

    @property
    def num_features(self) -> int:
        return self._coef.shape[0]

    def _predict_batch(self, x: np.ndarray) -> np.ndarray:
        return np.exp(x @ self._coef + self._icpt)

    def _transform(self, frame: MLFrame) -> MLFrame:
        out = super()._transform(frame)
        qcol = self.get("quantilesCol")
        if qcol:
            x = frame[self.get("featuresCol")]
            if x.ndim == 1:
                x = x[:, None]
            out = out.with_column(qcol, self.predict_quantiles(x))
        return out

    def predict_quantiles(self, features) -> np.ndarray:
        """t_q = exp(Xβ+b) · (−log(1−q))^σ (ref predictQuantiles)."""
        x = np.atleast_2d(np.asarray(features, dtype=np.float64))
        lam = np.exp(x @ self._coef + self._icpt)
        qs = np.asarray(self.get("quantileProbabilities"))
        return lam[:, None] * np.power(-np.log1p(-qs)[None, :], self._scale)

    def _save_data(self, path: str) -> None:
        save_arrays(path, coef=self._coef, icpt=np.array(self._icpt),
                    scale=np.array(self._scale))

    def _load_data(self, path: str, meta) -> None:
        arrs = load_arrays(path)
        self._coef = arrs["coef"]
        self._icpt = float(arrs["icpt"])
        self._scale = float(arrs["scale"])
