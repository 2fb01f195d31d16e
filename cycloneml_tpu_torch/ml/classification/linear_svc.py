"""Linear support vector classifier.

The port's counterpart of ``cycloneml_tpu/ml/classification/linear_svc.py``
(ref LinearSVC.scala): one Summarizer pass, a standardized copy of X
(``loss.standardize_dataset``, the one buffer the fit adds beside X), the
hinge aggregator (plain PyTorch; the reference has no kernel for it), the
L2 penalty, host L-BFGS, and the coefficients unscaled by ``inv_std``. The
threshold applies to the raw margin, not to a probability.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
from cycloneml_tpu_torch.linalg.vectors import DenseVector, Vectors
from cycloneml_tpu_torch.ml.base import ClassificationModel, Predictor
from cycloneml_tpu_torch.ml.util_io import MLReadable, MLWritable, load_arrays, save_arrays
from cycloneml_tpu_torch.ml.optim import aggregators
from cycloneml_tpu_torch.ml.optim.lbfgs import LBFGS
from cycloneml_tpu_torch.ml.optim.loss import (DistributedLossFunction,
                                               l2_regularization,
                                               standardize_dataset,
                                               validate_binary_labels)
from cycloneml_tpu_torch.ml.shared import (
    HasAggregationDepth, HasFitIntercept, HasMaxIter, HasRegParam,
    HasStandardization, HasTol,
)
from cycloneml_tpu_torch.ml.stat import Summarizer

logger = logging.getLogger(__name__)


class _LinearSVCParams(HasMaxIter, HasRegParam, HasTol, HasFitIntercept,
                       HasStandardization, HasAggregationDepth):
    def _declare_svc_params(self):
        self._p_max_iter(100)
        self._p_reg_param(0.0)
        self._p_tol(1e-6)
        self._p_fit_intercept(True)
        self._p_standardization(True)
        # a threshold on the RAW margin (ref LinearSVC.threshold)
        self.threshold = self._param(
            "threshold", "margin threshold for the positive class",
            default=0.0)
        self._p_aggregation_depth(2)


class LinearSVC(Predictor, _LinearSVCParams, MLWritable, MLReadable):
    def __init__(self, uid=None, **kwargs):
        super().__init__(uid)
        self._declare_svc_params()
        for k, v in kwargs.items():
            self.set(k, v)

    def set_max_iter(self, v):
        return self.set("maxIter", v)

    def set_reg_param(self, v):
        return self.set("regParam", v)

    def set_threshold(self, v):
        return self.set("threshold", v)

    def _fit(self, frame) -> "LinearSVCModel":
        ds = frame.to_instance_dataset(
            self.get("featuresCol"), self.get("labelCol"),
            self.get("weightCol") or None)
        return self._fit_dataset(ds)

    def _fit_dataset(self, ds: InstanceDataset) -> "LinearSVCModel":
        d = ds.n_features
        stats = Summarizer.summarize(ds)
        features_std = stats.std
        fit_intercept = self.get("fitIntercept")
        reg = self.get("regParam")

        validate_binary_labels(ds.y_host()[:ds.n_rows], "LinearSVC")
        ds_std, inv_std = standardize_dataset(ds, features_std)

        agg = aggregators.hinge(d, fit_intercept)
        l2_fn = l2_regularization(reg, d, fit_intercept,
                                  features_std=features_std,
                                  standardize=self.get("standardization")
                                  ) if reg > 0 else None
        loss_fn = DistributedLossFunction(ds_std, agg, l2_fn,
                                          stats.weight_sum)
        n_coef = d + (1 if fit_intercept else 0)
        state = LBFGS(max_iter=self.get("maxIter"),
                      tol=self.get("tol")).minimize(loss_fn, np.zeros(n_coef))
        if state.converged_reason == "max iterations reached":
            logger.warning("LinearSVC did not converge in %d iterations",
                           self.get("maxIter"))

        model = LinearSVCModel(state.x[:d] * inv_std,
                               float(state.x[d]) if fit_intercept else 0.0,
                               uid=self.uid)
        self._copy_values(model)
        model._set_parent(self)
        model.objective_history = list(state.loss_history)
        model.total_iterations = state.iteration
        model.total_evals = loss_fn.n_evals
        return model


class LinearSVCModel(ClassificationModel, _LinearSVCParams,
                     MLWritable, MLReadable):
    def __init__(self, coefficients: Optional[np.ndarray] = None,
                 intercept: float = 0.0, uid=None):
        super().__init__(uid)
        self._declare_svc_params()
        self._coef = np.asarray(coefficients, dtype=np.float64) \
            if coefficients is not None else None
        self._icpt = float(intercept)
        self.objective_history = []
        self.total_iterations = 0
        self.total_evals = 0

    @property
    def coefficients(self) -> DenseVector:
        return Vectors.dense(self._coef)

    @property
    def intercept(self) -> float:
        return self._icpt

    @property
    def num_classes(self) -> int:
        return 2

    @property
    def num_features(self) -> int:
        return len(self._coef)

    def _raw_prediction(self, x: np.ndarray) -> np.ndarray:
        m = x @ self._coef + self._icpt
        return np.stack([-m, m], axis=1)

    def _raw_to_prediction(self, raw: np.ndarray) -> np.ndarray:
        return (raw[:, 1] > self.get("threshold")).astype(np.float64)

    def _save_data(self, path: str) -> None:
        save_arrays(path, coef=self._coef, icpt=np.array(self._icpt))

    def _load_data(self, path: str, meta) -> None:
        arrs = load_arrays(path)
        self._coef = arrs["coef"]
        self._icpt = float(arrs["icpt"])
