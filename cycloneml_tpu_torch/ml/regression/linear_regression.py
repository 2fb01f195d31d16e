"""Linear regression with elastic net — the quasi-Newton path.

The port's counterpart of ``cycloneml_tpu/ml/regression/linear_regression.py``
with the reference's objective

  f(b) = 1/(2n) sum w_i ((x_i - mu)/sigma_x . b - (y_i - y_mean)/sigma_y)^2
         + regParam/sigma_y (alpha |b|_1 + (1 - alpha)/2 |b|^2)

in doubly-standardized space (features and label divided by their std, the
glmnet convention the reference follows): one label-moment pass, the
constant-label cases, ``eff_reg = regParam / sigma_y``, the standardization
folded into the aggregator's read (no standardized copy of X, no scaled y),
L-BFGS for a pure L2 penalty and OWL-QN when elastic net has an L1 part,
and the intercept recovered in closed form ``y_mean - coef.mu``. Under
``cyclone.ml.usePallasKernels`` the sweep is kernel K2.

Not ported yet, and raising ``NotImplementedError`` with their ROADMAP
slice: ``solver="normal"`` and ``"auto"`` where it resolves to the normal
equations (``ml/optim/wls.py``), streamed and fp8 datasets, persistence.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
from cycloneml_tpu_torch.dataset.instance import compute_dtype
from cycloneml_tpu_torch.linalg.vectors import DenseVector, Vectors
from cycloneml_tpu_torch.ml.base import PredictionModel, Predictor
from cycloneml_tpu_torch.ml.optim import aggregators
from cycloneml_tpu_torch.ml.optim.lbfgs import LBFGS, OWLQN
from cycloneml_tpu_torch.ml.optim.loss import (DistributedLossFunction,
                                               inv_std_vector,
                                               l2_regularization)
from cycloneml_tpu_torch.ml.shared import (
    HasAggregationDepth, HasElasticNetParam, HasFitIntercept, HasLabelCol,
    HasMaxIter, HasRegParam, HasSolver, HasStandardization, HasTol,
)
from cycloneml_tpu_torch.ml.stat import Summarizer

logger = logging.getLogger(__name__)

# the normal-equation solver's feature cap (ref WeightedLeastSquares
# MAX_NUM_FEATURES); here it only steers what "auto" resolves to
MAX_FEATURES_FOR_NORMAL = 4096


class _LinearRegressionParams(HasMaxIter, HasRegParam, HasElasticNetParam,
                              HasTol, HasFitIntercept, HasStandardization,
                              HasSolver, HasAggregationDepth, HasLabelCol):
    def _declare_linreg_params(self):
        self._p_label_col()
        self._p_max_iter(100)
        self._p_reg_param(0.0)
        self._p_elastic_net(0.0)
        self._p_tol(1e-6)
        self._p_fit_intercept(True)
        self._p_standardization(True)
        self._p_solver(["auto", "l-bfgs", "normal"], "auto")
        self._p_aggregation_depth(2)


def _label_moments(x, y, w):
    return {"s1": torch.sum(w * y), "s2": torch.sum(w * y * y),
            "w2": torch.sum(w * w)}


class LinearRegression(Predictor, _LinearRegressionParams):
    def __init__(self, uid=None, **kwargs):
        super().__init__(uid)
        self._declare_linreg_params()
        for k, v in kwargs.items():
            self.set(k, v)

    def set_max_iter(self, v):
        return self.set("maxIter", v)

    def set_reg_param(self, v):
        return self.set("regParam", v)

    def set_elastic_net_param(self, v):
        return self.set("elasticNetParam", v)

    def set_solver(self, v):
        return self.set("solver", v)

    def _fit(self, frame) -> "LinearRegressionModel":
        ds = frame.to_instance_dataset(
            self.get("featuresCol"), self.get("labelCol"),
            self.get("weightCol") or None)
        return self._fit_dataset(ds)

    def _model(self, coef, icpt, history, total_iterations,
               loss_fn=None) -> "LinearRegressionModel":
        model = LinearRegressionModel(coef, icpt, uid=self.uid)
        self._copy_values(model)
        model._set_parent(self)
        model.summary = LinearRegressionTrainingSummary(
            history, total_iterations,
            loss_fn.n_evals if loss_fn is not None else 0)
        return model

    def _fit_dataset(self, ds: InstanceDataset) -> "LinearRegressionModel":
        d = ds.n_features
        reg = self.get("regParam")
        alpha = self.get("elasticNetParam")
        solver = self.get("solver")
        if solver == "auto":
            solver = "normal" if (alpha * reg == 0.0
                                  and d <= MAX_FEATURES_FOR_NORMAL) \
                else "l-bfgs"
        if solver == "normal":
            raise NotImplementedError(
                "LinearRegression's normal-equation solver (ml/optim/wls.py; "
                "also what solver='auto' picks for d <= 4096 without an L1 "
                "part) is ROADMAP slice 2; use solver='l-bfgs'")

        stats = Summarizer.summarize(ds)
        w_sum = stats.weight_sum
        ymom = ds.tree_aggregate_fn(_label_moments)()
        y_mean = float(ymom["s1"]) / w_sum
        denom = w_sum - float(ymom["w2"]) / w_sum
        y_var = max((float(ymom["s2"]) - w_sum * y_mean ** 2) / denom, 0.0) \
            if denom > 0 else 0.0
        y_std = float(np.sqrt(y_var))
        if y_std == 0.0:
            # constant label (ref LinearRegression.scala:388-414): with an
            # intercept, or an all-zero label, the exact fit is zero
            # coefficients; without one a nonzero constant is still solved,
            # unscaled (y_std = |y_mean|), and regularization is refused
            # because the label-standardized penalty is undefined there
            if self.get("fitIntercept") or y_mean == 0.0:
                return self._model(
                    np.zeros(d), y_mean if self.get("fitIntercept") else 0.0,
                    [0.0], 0)
            if reg > 0.0:
                raise ValueError(
                    "The standard deviation of the label is zero. Model "
                    "cannot be regularized when labels are standardized "
                    "(ref WeightedLeastSquares require)")
            y_std = abs(y_mean)

        # glmnet semantics: the penalty applies to the label-standardized
        # problem (ref LinearRegression.scala:396 effectiveRegParam)
        eff_reg = reg / y_std
        return self._solve_quasi_newton(ds, stats, y_mean, y_std, eff_reg,
                                        alpha)

    def _solve_quasi_newton(self, ds, stats, y_mean, y_std, reg, alpha):
        d = ds.n_features
        fit_intercept = self.get("fitIntercept")
        standardize = self.get("standardization")
        x_mean, x_std = stats.mean, stats.std
        inv_std = inv_std_vector(x_std)
        scaled_mean = x_mean * inv_std if fit_intercept else np.zeros(d)
        y_mean_std = y_mean / y_std if fit_intercept else 0.0
        y_pars = np.array([1.0 / y_std, y_mean_std])

        from cycloneml_tpu_torch.ops.kernels import use_fused_kernels
        agg = (aggregators.least_squares_pallas_scaled(d)
               if use_fused_kernels(ds.ctx, ds.x)
               else aggregators.least_squares_scaled(d))
        l2 = (1.0 - alpha) * reg
        l1 = alpha * reg
        l2_fn = l2_regularization(l2, d, False, features_std=x_std,
                                  standardize=standardize) if l2 > 0 else None
        # the folded vectors ride in the accumulator tier: their
        # corrections must not round through a bf16 data tier
        adt = compute_dtype(getattr(ds.ctx, "conf", None))
        dev = ds.x.device
        extras = tuple(torch.as_tensor(a, device=dev).to(adt)
                       for a in (inv_std, scaled_mean, y_pars))
        loss_fn = DistributedLossFunction(ds, agg, l2_fn, stats.weight_sum,
                                          extra_args=extras)
        if l1 > 0:
            l1_vec = np.full(d, l1) if standardize else np.where(
                x_std > 0, l1 / np.where(x_std > 0, x_std, 1.0), 0.0)
            opt = OWLQN(max_iter=self.get("maxIter"), tol=self.get("tol"),
                        l1_reg=l1_vec)
        else:
            opt = LBFGS(max_iter=self.get("maxIter"), tol=self.get("tol"))
        state = opt.minimize(loss_fn, np.zeros(d))
        if state.converged_reason == "max iterations reached":
            logger.warning("LinearRegression did not converge in %d "
                           "iterations", self.get("maxIter"))

        # standardized-space coefficients back to the original space
        coef = np.asarray(state.x, np.float64) * inv_std * y_std
        icpt = y_mean - float(coef @ x_mean) if fit_intercept else 0.0
        history = list(state.loss_history)
        return self._model(coef, icpt, history, max(len(history) - 1, 0),
                           loss_fn)


class LinearRegressionModel(PredictionModel, _LinearRegressionParams):
    def __init__(self, coefficients: Optional[np.ndarray] = None,
                 intercept: float = 0.0, uid=None):
        super().__init__(uid)
        self._declare_linreg_params()
        self._coef = np.asarray(coefficients, dtype=np.float64) \
            if coefficients is not None else None
        self._icpt = float(intercept)
        self.summary: Optional[LinearRegressionTrainingSummary] = None

    @property
    def coefficients(self) -> DenseVector:
        return Vectors.dense(self._coef)

    @property
    def intercept(self) -> float:
        return self._icpt

    @property
    def num_features(self) -> int:
        return self._coef.shape[0]

    def _predict_batch(self, x: np.ndarray) -> np.ndarray:
        return x @ self._coef + self._icpt

    def evaluate(self, frame) -> dict:
        """Regression metrics on a frame (ref LinearRegressionSummary):
        rmse, mse, mae and r2."""
        x = frame[self.get("featuresCol")]
        y = frame[self.get("labelCol")]
        resid = y - self._predict_batch(x)
        sse = float(resid @ resid)
        sst = float(((y - y.mean()) ** 2).sum())
        n = len(y)
        return {"rmse": float(np.sqrt(sse / n)), "mse": sse / n,
                "mae": float(np.abs(resid).mean()),
                "r2": 1.0 - sse / sst if sst > 0 else float("nan")}


class LinearRegressionTrainingSummary:
    """Objective history and counts of a fit: iterations and loss/gradient
    evaluations."""

    def __init__(self, objective_history, total_iterations, total_evals=0):
        self.objective_history = objective_history
        self.total_iterations = total_iterations
        self.total_evals = total_evals
