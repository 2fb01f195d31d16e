"""Linear regression with elastic net — the normal and quasi-Newton paths.

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
``cyclone.ml.usePallasKernels`` the sweep is kernel K2. The quasi-Newton
path is fp8-capable: on e4m3 codes the per-column scales fold into the
aggregator's ``inv_std``, after the envelope probe.

``solver="normal"``, and ``"auto"`` when regParam * elasticNetParam = 0
and d <= 4096 (so a default ``LinearRegression()``), delegate to
``ml/optim/wls.WeightedLeastSquares`` as the reference does: one moments
pass, then the float64 host solve. That solver is not fp8-capable: on e4m3
codes it first leaves the fp8 rung through ``fp8_fallback``.

Streamed fits (the reference's :96-123): a ``StreamingDataset`` handed
to ``fit``, or an in-core dataset under ``cyclone.oocore.mode=force``
(spilled first), trains by the quasi-Newton path over epochs of shards,
K2 once a shard on the card, with the moments and label moments of the
shards' write pass. ``solver="auto"`` resolves to ``l-bfgs`` there; an
explicit ``solver="normal"`` raises before any spill (its moments want the
in-core matrix).
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from cycloneml_tpu_torch.dataset.dataset import (InstanceDataset,
                                                 fp8_fallback,
                                                 resolve_fp8_fit)
from cycloneml_tpu_torch.dataset.instance import compute_dtype
from cycloneml_tpu_torch.linalg.vectors import DenseVector, Vectors
from cycloneml_tpu_torch.ml.base import PredictionModel, Predictor
from cycloneml_tpu_torch.ml.util_io import MLReadable, MLWritable, load_arrays, save_arrays
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

# the component owns the real cap (wls.py raises at fit time); this alias
# only steers what "auto" resolves to
from cycloneml_tpu_torch.ml.optim.wls import \
    MAX_NUM_FEATURES as MAX_FEATURES_FOR_NORMAL  # noqa: E402


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


class LinearRegression(Predictor, _LinearRegressionParams, MLWritable,
                       MLReadable):
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
        # fp8-capable: the l-bfgs path folds the per-column scales into
        # inv_std; the normal solver leaves the fp8 rung (fp8_fallback)
        ds = frame.to_instance_dataset(
            self.get("featuresCol"), self.get("labelCol"),
            self.get("weightCol") or None, fp8_capable=True)
        return self._fit_dataset(ds)

    def _model(self, coef, icpt, history, total_iterations,
               loss_fn=None, streamed=False) -> "LinearRegressionModel":
        model = LinearRegressionModel(coef, icpt, uid=self.uid)
        self._copy_values(model)
        model._set_parent(self)
        model.summary = LinearRegressionTrainingSummary(
            history, total_iterations,
            loss_fn.n_evals if loss_fn is not None else 0,
            loss_fn.n_dispatches if loss_fn is not None else 0, streamed,
            dict(loss_fn.stats) if streamed and loss_fn is not None
            else None)
        return model

    def _fit_dataset(self, ds) -> "LinearRegressionModel":
        from cycloneml_tpu_torch.oocore import (StreamingDataset,
                                                shard_dataset,
                                                streaming_mode)
        conf = getattr(ds.ctx, "conf", None)
        streamed = isinstance(ds, StreamingDataset)
        force = not streamed and streaming_mode(conf) == "force"
        d = ds.n_features
        reg = self.get("regParam")
        alpha = self.get("elasticNetParam")
        solver = self.get("solver")
        if solver == "auto":
            # a streamed fit always takes the quasi-Newton path: the
            # normal solver's moments want the in-core design matrix
            solver = "normal" if (alpha * reg == 0.0
                                  and d <= MAX_FEATURES_FOR_NORMAL
                                  and not (streamed or force)) else "l-bfgs"
        if (streamed or force) and solver == "normal":
            # checked before any spill: an explicit normal request must
            # not pay an O(n d) shard write only to raise
            raise ValueError(
                "solver='normal' requires an in-core dataset; streamed "
                "fits use solver='l-bfgs' (or 'auto')")
        if force:
            sds = shard_dataset(ds)
            try:
                return self._fit_dataset(sds)
            finally:
                sds.close()
        if solver == "normal":
            return self._solve_normal(ds)

        stats = ds.summary() if streamed else Summarizer.summarize(ds)
        if not streamed:
            # the fp8 safety rail: envelope probe, bfloat16 fallback
            ds = resolve_fp8_fit(ds, stats, "LinearRegression")
        w_sum = stats.weight_sum
        # the label moments: one pass in core, the write pass's streamed
        if streamed:
            s1y, s2y, w2y = ds.y_moments()
            ymom = {"s1": s1y, "s2": s2y, "w2": w2y}
        else:
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
                    [0.0], 0, streamed=streamed)
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

    def _solve_normal(self, ds: InstanceDataset) -> "LinearRegressionModel":
        """The WLS component, exactly as the reference delegates to it
        (LinearRegression.scala:446-448): standardizeLabel=true,
        solverType=auto."""
        if ds.x_scale is not None:
            # the moments read X as values; e4m3 codes are not values
            ds = fp8_fallback(ds, "LinearRegression",
                              "solver='normal' is not fp8-eligible")
        from cycloneml_tpu_torch.ml.optim.wls import (AUTO,
                                                      WeightedLeastSquares)
        wm = WeightedLeastSquares(
            fit_intercept=self.get("fitIntercept"),
            reg_param=self.get("regParam"),
            elastic_net_param=self.get("elasticNetParam"),
            standardize_features=self.get("standardization"),
            standardize_label=True, solver_type=AUTO,
            max_iter=self.get("maxIter"), tol=self.get("tol")
        ).fit(ds.x, ds.y, ds.w)
        return self._model(wm.coefficients, wm.intercept,
                           wm.objective_history,
                           max(len(wm.objective_history) - 1, 0))

    def _solve_quasi_newton(self, ds, stats, y_mean, y_std, reg, alpha):
        d = ds.n_features
        fit_intercept = self.get("fitIntercept")
        standardize = self.get("standardization")
        x_mean, x_std = stats.mean, stats.std
        inv_std = inv_std_vector(x_std)
        scaled_mean = x_mean * inv_std if fit_intercept else np.zeros(d)
        y_mean_std = y_mean / y_std if fit_intercept else 0.0
        y_pars = np.array([1.0 / y_std, y_mean_std])
        # fp8 rung: the per-column scale folds into the aggregator's inv_std
        # (x_hat = codes o (scale / sigma) - mu / sigma); the final
        # unscaling keeps the original inv_std
        fp8_scale = ds.x_scale
        inv_std_agg = inv_std * fp8_scale if fp8_scale is not None \
            else inv_std

        from cycloneml_tpu_torch.oocore import (StreamingDataset,
                                                StreamingLossFunction)
        from cycloneml_tpu_torch.oocore.engine import stream_uses_kernels
        from cycloneml_tpu_torch.ops.kernels import use_fused_kernels
        streamed = isinstance(ds, StreamingDataset)
        agg = (aggregators.least_squares_pallas_scaled(d)
               if (stream_uses_kernels(ds) if streamed
                   else use_fused_kernels(ds.ctx, ds.x))
               else aggregators.least_squares_scaled(d))
        l2 = (1.0 - alpha) * reg
        l1 = alpha * reg
        l2_fn = l2_regularization(l2, d, False, features_std=x_std,
                                  standardize=standardize) if l2 > 0 else None
        # the folded vectors ride in the accumulator tier: their
        # corrections must not round through a bf16 data tier
        adt = compute_dtype(getattr(ds.ctx, "conf", None))
        dev = ds.ctx.mesh_runtime.device if streamed else ds.x.device
        extras = tuple(torch.as_tensor(a, device=dev).to(adt)
                       for a in (inv_std_agg, scaled_mean, y_pars))
        loss_cls = StreamingLossFunction if streamed \
            else DistributedLossFunction
        loss_fn = loss_cls(ds, agg, l2_fn, stats.weight_sum,
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
        if fp8_scale is not None and not np.all(np.isfinite(state.x)):
            # an overflowing fp8 fit surfaces as NaN: refit on bfloat16 (a
            # shard set re-spills there)
            if streamed:
                bf16 = ds.to_instance_dataset(fp8_capable=False)
                try:
                    return self._solve_quasi_newton(bf16, stats, y_mean,
                                                    y_std, reg, alpha)
                finally:
                    bf16.close()
            return self._solve_quasi_newton(
                fp8_fallback(ds, "LinearRegression",
                             "non-finite fp8 solution"),
                stats, y_mean, y_std, reg, alpha)

        # standardized-space coefficients back to the original space
        coef = np.asarray(state.x, np.float64) * inv_std * y_std
        icpt = y_mean - float(coef @ x_mean) if fit_intercept else 0.0
        history = list(state.loss_history)
        return self._model(coef, icpt, history, max(len(history) - 1, 0),
                           loss_fn, streamed)


class LinearRegressionModel(PredictionModel, _LinearRegressionParams,
                            MLWritable, MLReadable):
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

    def _save_data(self, path: str) -> None:
        save_arrays(path, coef=self._coef, icpt=np.array(self._icpt))

    def _load_data(self, path: str, meta) -> None:
        arrs = load_arrays(path)
        self._coef = arrs["coef"]
        self._icpt = float(arrs["icpt"])


class LinearRegressionTrainingSummary:
    """Objective history and counts of a fit: iterations, loss/gradient
    evaluations and dispatches (shard launches when ``streamed``, with
    the epochs' split in ``stream_stats``)."""

    def __init__(self, objective_history, total_iterations, total_evals=0,
                 total_dispatches=0, streamed=False, stream_stats=None):
        self.objective_history = objective_history
        self.total_iterations = total_iterations
        self.total_evals = total_evals
        self.total_dispatches = total_dispatches
        self.streamed = bool(streamed)
        self.stream_stats = stream_stats
