"""Factorization-machine regressor, the port of the reference's
``ml/regression/fm.py`` (ref: ml/regression/FMRegressor.scala)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from cycloneml_tpu_torch.dataset.frame import MLFrame
from cycloneml_tpu_torch.linalg.matrices import DenseMatrix
from cycloneml_tpu_torch.linalg.vectors import DenseVector, Vectors
from cycloneml_tpu_torch.ml.base import PredictionModel, Predictor
from cycloneml_tpu_torch.ml.optim.fm_core import fm_margin_np, split_fm_coef, train_fm
from cycloneml_tpu_torch.ml.param import ParamValidators as V
from cycloneml_tpu_torch.ml.shared import (
    HasFitIntercept, HasMaxIter, HasRegParam, HasSeed, HasSolver, HasTol,
)
from cycloneml_tpu_torch.ml.util_io import MLReadable, MLWritable, load_arrays, save_arrays


class _FMParams(HasMaxIter, HasRegParam, HasTol, HasFitIntercept, HasSeed,
                HasSolver):
    def _declare_fm_params(self):
        self._p_max_iter(100)
        self._p_reg_param(0.0)
        self._p_tol(1e-6)
        self._p_fit_intercept(True)
        self._p_seed(17)
        self._p_solver(["adamW", "gd"], "adamW")
        self.factorSize = self._param(
            "factorSize", "dimensionality of the factors (> 0)",
            V.gt(0), default=8)
        self.fitLinear = self._param(
            "fitLinear", "whether to fit the 1-way linear term", default=True)
        self.miniBatchFraction = self._param(
            "miniBatchFraction", "minibatch fraction in (0, 1]",
            V.in_range(0.0, 1.0, lower_inclusive=False), default=1.0)
        self.initStd = self._param(
            "initStd", "stddev of initial factors", V.gt(0.0), default=0.01)
        self.stepSize = self._param(
            "stepSize", "optimizer step size", V.gt(0.0), default=1.0)


class FMRegressor(Predictor, _FMParams, MLWritable, MLReadable):
    def __init__(self, uid=None, **kwargs):
        super().__init__(uid)
        self._declare_fm_params()
        for k, v in kwargs.items():
            self.set(k, v)

    def set_factor_size(self, v):
        return self.set("factorSize", v)

    def set_max_iter(self, v):
        return self.set("maxIter", v)

    def set_step_size(self, v):
        return self.set("stepSize", v)

    def _fit(self, frame: MLFrame) -> "FMRegressionModel":
        ds = frame.to_instance_dataset(
            self.get("featuresCol"), self.get("labelCol"), None)
        d = ds.n_features
        coef, history = train_fm(
            ds, d, "squaredError", self.get("factorSize"),
            self.get("fitIntercept"), self.get("fitLinear"),
            self.get("regParam"), self.get("miniBatchFraction"),
            self.get("initStd"), self.get("maxIter"), self.get("stepSize"),
            self.get("tol"), self.get("solver"), self.get("seed"))
        V_, w, b = split_fm_coef(coef, d, self.get("factorSize"),
                                 self.get("fitIntercept"),
                                 self.get("fitLinear"))
        model = FMRegressionModel(V_, w, b, uid=self.uid)
        self._copy_values(model)
        model._set_parent(self)
        model.objective_history = history
        return model


class FMRegressionModel(PredictionModel, _FMParams, MLWritable, MLReadable):
    def __init__(self, factors: Optional[np.ndarray] = None,
                 linear: Optional[np.ndarray] = None,
                 intercept: float = 0.0, uid=None):
        super().__init__(uid)
        self._declare_fm_params()
        self._V = np.asarray(factors) if factors is not None else None
        self._w = np.asarray(linear) if linear is not None else None
        self._b = float(intercept)
        self.objective_history = []

    @property
    def factors(self) -> DenseMatrix:
        return DenseMatrix.from_array(self._V)

    @property
    def linear(self) -> DenseVector:
        return Vectors.dense(self._w)

    @property
    def intercept(self) -> float:
        return self._b

    @property
    def num_features(self) -> int:
        return self._V.shape[0]

    def _predict_batch(self, x: np.ndarray) -> np.ndarray:
        return fm_margin_np(x, self._V, self._w, self._b)

    def _save_data(self, path: str) -> None:
        save_arrays(path, V=self._V, w=self._w, b=np.array(self._b))

    def _load_data(self, path: str, meta) -> None:
        arrs = load_arrays(path)
        self._V, self._w, self._b = arrs["V"], arrs["w"], float(arrs["b"])
