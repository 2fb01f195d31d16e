"""Logistic regression — the binomial dense fit.

The port's counterpart of ``cycloneml_tpu/ml/classification/
logistic_regression.py`` (``_fit_dataset``, binomial dense branch, :663-950):
the label histogram and feature moments from one Summarizer pass, training
in standardized feature space with standardization folded into the
aggregator's read (no standardized copy of X), fitWithMean centering, the
log-odds intercept start, the L2 penalty, L-BFGS — chunked on the device
under ``cyclone.ml.lbfgs.deviceChunk`` — or OWL-QN when elastic net has an
L1 part, and unscaling back to the original feature space. Under
``cyclone.ml.usePallasKernels`` the sweep is kernel K1.

The fit is fp8-capable: under ``cyclone.data.dtype=auto8|float8`` it reads
e4m3 codes, with the per-column scales folded into the aggregator's
``inv_std``, after the envelope probe (``dataset.resolve_fp8_fit``); a
non-finite fp8 solution refits on the bfloat16 rung.

Not ported yet, and raising ``NotImplementedError`` with their ROADMAP
slice: multinomial fits, coefficient bounds (L-BFGS-B), checkpointed
training, stacked fits.
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
from cycloneml_tpu_torch.ml.base import (Predictor,
                                         ProbabilisticClassificationModel)
from cycloneml_tpu_torch.ml.optim import aggregators
from cycloneml_tpu_torch.ml.optim.lbfgs import LBFGS, OWLQN
from cycloneml_tpu_torch.ml.optim.loss import (DistributedLossFunction,
                                               inv_std_vector,
                                               l2_regularization)
from cycloneml_tpu_torch.ml.param import ParamValidators as V
from cycloneml_tpu_torch.ml.shared import (
    HasAggregationDepth, HasElasticNetParam, HasFitIntercept, HasLabelCol,
    HasMaxBlockSizeInMB, HasMaxIter, HasRegParam, HasStandardization,
    HasThreshold, HasTol,
)
from cycloneml_tpu_torch.ml.stat import Summarizer

logger = logging.getLogger(__name__)


class _LogisticRegressionParams(HasMaxIter, HasRegParam, HasElasticNetParam,
                                HasTol, HasFitIntercept, HasStandardization,
                                HasThreshold, HasAggregationDepth,
                                HasMaxBlockSizeInMB):
    def _declare_lr_params(self):
        self._p_max_iter(100)
        self._p_reg_param(0.0)
        self._p_elastic_net(0.0)
        self._p_tol(1e-6)
        self._p_fit_intercept(True)
        self._p_standardization(True)
        self._p_threshold(0.5)
        self._p_aggregation_depth(2)
        self._p_max_block_size(0.0)
        self.family = self._param(
            "family", "label distribution family",
            V.in_array(["auto", "binomial", "multinomial"]), default="auto")
        self.checkpointDir = self._param(
            "checkpointDir", "directory for mid-training optimizer "
            "checkpoints", default="")
        self.checkpointInterval = self._param(
            "checkpointInterval", "iterations between checkpoints",
            V.gt(0), default=10)
        for name in ("lowerBoundsOnCoefficients", "upperBoundsOnCoefficients",
                     "lowerBoundsOnIntercepts", "upperBoundsOnIntercepts"):
            setattr(self, name, self._param(name, "box constraint",
                                            default=None))

    def _opt(self, name):
        """Optional param: None when never set (these have no default)."""
        return self.get(name) if self.is_defined(self.get_param(name)) else None

    def _has_bounds(self) -> bool:
        return any(self._opt(p) is not None for p in (
            "lowerBoundsOnCoefficients", "upperBoundsOnCoefficients",
            "lowerBoundsOnIntercepts", "upperBoundsOnIntercepts"))


class LogisticRegression(Predictor, _LogisticRegressionParams):
    def __init__(self, uid=None, **kwargs):
        super().__init__(uid)
        self._declare_lr_params()
        for k, v in kwargs.items():
            self.set(k, v)

    def set_max_iter(self, v):
        return self.set("maxIter", v)

    def set_reg_param(self, v):
        return self.set("regParam", v)

    def set_elastic_net_param(self, v):
        return self.set("elasticNetParam", v)

    def set_tol(self, v):
        return self.set("tol", v)

    def set_fit_intercept(self, v):
        return self.set("fitIntercept", v)

    def set_standardization(self, v):
        return self.set("standardization", v)

    def set_family(self, v):
        return self.set("family", v)

    def set_threshold(self, v):
        return self.set("threshold", v)

    def _fit(self, frame) -> "LogisticRegressionModel":
        # fp8-capable: the scaled aggregators fold the per-column scales
        # into inv_std, so this fit may take the e4m3 rung
        ds = frame.to_instance_dataset(
            self.get("featuresCol"), self.get("labelCol"),
            self.get("weightCol") or None, fp8_capable=True)
        return self._fit_dataset(ds)

    def fit_stacked(self, frame, y_stack=None, reg_params=None):
        raise NotImplementedError("stacked fits are ROADMAP slice 4")

    def _check_ported(self, is_multinomial: bool) -> None:
        if is_multinomial:
            raise NotImplementedError(
                "multinomial LogisticRegression is ROADMAP slice 2")
        if self._has_bounds():
            raise NotImplementedError(
                "coefficient bounds (L-BFGS-B) are ROADMAP slice 2")
        if self.get("checkpointDir"):
            raise NotImplementedError(
                "checkpointed training is ROADMAP slice 8")

    def _fit_dataset(self, ds: InstanceDataset) -> "LogisticRegressionModel":
        conf = getattr(ds.ctx, "conf", None)
        d = ds.n_features
        stats = Summarizer.summarize(ds)
        # the fp8 safety rail: the envelope probe may swap the quantized
        # dataset for its bfloat16 dequantization (logged and recorded)
        ds = resolve_fp8_fit(ds, stats, "LogisticRegression")
        fp8_scale = ds.x_scale
        features_std = stats.std
        weight_sum = stats.weight_sum

        y_host = ds.y_host()
        w_host = ds.w_host()
        num_classes = int(y_host.max()) + 1 if ds.n_rows else 2
        family = self.get("family")
        if family == "auto":
            is_multinomial = num_classes > 2
        else:
            is_multinomial = family == "multinomial"
            if not is_multinomial and num_classes > 2:
                raise ValueError(
                    f"Binomial family requires <= 2 label classes, found "
                    f"{num_classes} (the reference rejects this too)")
            num_classes = max(num_classes, 2)
        histogram = np.bincount(y_host.astype(np.int64), weights=w_host,
                                minlength=num_classes)[:num_classes]

        fit_intercept = self.get("fitIntercept")
        standardize = self.get("standardization")
        reg = self.get("regParam")
        alpha = self.get("elasticNetParam")
        l2 = (1.0 - alpha) * reg
        l1 = alpha * reg
        self._check_ported(is_multinomial)

        # fitWithMean (ref LogisticRegression.scala:946-955, SPARK-34448):
        # with a free intercept, train on CENTERED standardized features;
        # the intercept is mapped back after optimization
        fit_with_mean = fit_intercept

        from cycloneml_tpu_torch.ops.kernels import use_fused_kernels
        # standardization folds INTO the aggregator read on every path:
        # no standardized copy of X exists
        inv_std = inv_std_vector(features_std)
        scaled_mean = stats.mean * inv_std if fit_with_mean else None
        # fp8 rung: x_hat = (codes o scale - mu) / sigma = codes o (scale /
        # sigma) - mu / sigma, so the AGGREGATOR reads inv_std o scale, while
        # scaled_mean and the final unscaling keep the original inv_std
        inv_std_agg = inv_std * fp8_scale if fp8_scale is not None \
            else inv_std
        if use_fused_kernels(ds.ctx, ds.x):
            agg = aggregators.binary_logistic_pallas_scaled(d, fit_intercept)
        else:
            agg = aggregators.binary_logistic_scaled(d, fit_intercept)
        n_coef = d + (1 if fit_intercept else 0)
        x0 = np.zeros(n_coef)
        if fit_intercept and 0 < histogram[1:].sum() < weight_sum:
            p1 = histogram[1:].sum() / weight_sum
            x0[d] = np.log(p1 / (1.0 - p1))
        l2_fn = l2_regularization(
            l2, d, fit_intercept, features_std=features_std,
            standardize=standardize) if l2 > 0 else None

        mu_or_zero = scaled_mean if fit_with_mean else np.zeros(d)
        # the standardization vectors ride in the ACCUMULATOR tier: the
        # fold's corrections must not round through a bf16 data tier
        adt = compute_dtype(conf)
        dev = ds.x.device
        extras = (torch.as_tensor(inv_std_agg, device=dev).to(adt),
                  torch.as_tensor(mu_or_zero, device=dev).to(adt))
        loss_fn = DistributedLossFunction(ds, agg, l2_fn, weight_sum,
                                          extra_args=extras)

        if l1 > 0:
            # the L1 part on the feature coordinates, never the intercept;
            # in the original feature space under standardization=false
            l1_vec = np.zeros(n_coef)
            l1_vec[:d] = l1 if standardize else np.where(
                features_std > 0,
                l1 / np.where(features_std > 0, features_std, 1.0), 0.0)
            opt = OWLQN(max_iter=self.get("maxIter"), tol=self.get("tol"),
                        l1_reg=l1_vec)
            chunk = 0
        else:
            opt = LBFGS(max_iter=self.get("maxIter"), tol=self.get("tol"))
            from cycloneml_tpu_torch.conf import LBFGS_DEVICE_CHUNK
            chunk = int(conf.get(LBFGS_DEVICE_CHUNK)) \
                if conf is not None else 0
        if chunk > 0 and (l2_fn is None or hasattr(l2_fn, "traceable")):
            from cycloneml_tpu_torch.ml.optim.device_lbfgs import DeviceLBFGS
            opt = DeviceLBFGS(max_iter=self.get("maxIter"),
                              tol=self.get("tol"), chunk=chunk)
        state = opt.minimize(loss_fn, x0)
        if state.converged_reason == "max iterations reached":
            logger.warning(
                "LogisticRegression did not converge in %d iterations",
                self.get("maxIter"))

        sol = np.asarray(state.x, dtype=np.float64)
        if fp8_scale is not None and not np.all(np.isfinite(sol)):
            # e4m3 has no inf: an overflowing fp8 fit surfaces as NaN in
            # the solution; refit on the bfloat16 rung
            return self._fit_dataset(fp8_fallback(
                ds, "LogisticRegression", "non-finite fp8 solution"))
        beta = sol[:d] * inv_std
        icpt = float(sol[d]) if fit_intercept else 0.0
        if fit_with_mean:
            # ref LogisticRegression.scala:1027-1031: solution(num) -= adapt
            icpt -= float(sol[:d] @ scaled_mean)
        model = LogisticRegressionModel(
            coefficient_matrix=beta[None, :], intercept_vector=np.array([icpt]),
            num_classes=2, is_multinomial=False, uid=self.uid)
        self._copy_values(model)
        model._set_parent(self)
        model.summary = LogisticRegressionTrainingSummary(
            objective_history=list(state.loss_history),
            total_iterations=state.iteration,
            total_evals=loss_fn.n_evals,
            total_dispatches=loss_fn.n_dispatches)
        return model


class LogisticRegressionModel(ProbabilisticClassificationModel,
                              _LogisticRegressionParams, HasLabelCol):
    """Fitted binomial model: margins, sigmoid probabilities and
    threshold-aware predictions."""

    def __init__(self, coefficient_matrix: Optional[np.ndarray] = None,
                 intercept_vector: Optional[np.ndarray] = None,
                 num_classes: int = 2, is_multinomial: bool = False,
                 uid=None):
        super().__init__(uid)
        if is_multinomial:
            raise NotImplementedError(
                "multinomial LogisticRegressionModel is ROADMAP slice 2")
        self._declare_lr_params()
        self._p_label_col()
        self._coef = np.asarray(coefficient_matrix, dtype=np.float64) \
            if coefficient_matrix is not None else None
        self._icpt = np.asarray(intercept_vector, dtype=np.float64) \
            if intercept_vector is not None else None
        self._num_classes = num_classes
        self._is_multinomial = False
        self.summary: Optional[LogisticRegressionTrainingSummary] = None

    @property
    def coefficients(self) -> DenseVector:
        return Vectors.dense(self._coef[0])

    @property
    def intercept(self) -> float:
        return float(self._icpt[0])

    @property
    def num_classes(self) -> int:
        return self._num_classes

    @property
    def num_features(self) -> int:
        return self._coef.shape[1]

    def _raw_prediction(self, x: np.ndarray) -> np.ndarray:
        m = x @ self._coef[0] + self._icpt[0]
        return np.stack([-m, m], axis=1)

    def _raw_to_probability(self, raw: np.ndarray) -> np.ndarray:
        # binomial raw is (-m, m): probability is sigmoid(m), not the
        # softmax of the pair (the reference's raw2probabilityInPlace)
        p1 = 1.0 / (1.0 + np.exp(-raw[:, 1]))
        return np.stack([1.0 - p1, p1], axis=1)

    def _raw_to_prediction(self, raw: np.ndarray) -> np.ndarray:
        prob1 = 1.0 / (1.0 + np.exp(-raw[:, 1]))
        return (prob1 > self.get("threshold")).astype(np.float64)

    def __repr__(self) -> str:
        return (f"LogisticRegressionModel(uid={self.uid}, "
                f"numClasses={self._num_classes}, "
                f"numFeatures={self.num_features})")


class LogisticRegressionTrainingSummary:
    """Objective history and optimizer counts of a fit: iterations, loss/
    gradient evaluations and host round trips (one per line search or
    device chunk)."""

    def __init__(self, objective_history, total_iterations,
                 total_evals=None, total_dispatches=None):
        self.objective_history = objective_history
        self.total_iterations = total_iterations
        self.total_evals = total_evals
        self.total_dispatches = total_dispatches
