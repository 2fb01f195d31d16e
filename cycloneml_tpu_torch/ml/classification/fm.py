"""Factorization-machine classifier, the port of the reference's
``ml/classification/fm.py`` (ref: ml/classification/FMClassifier.scala —
logistic loss over the shared FM trainImpl, ``ml/optim/fm_core.py``)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from cycloneml_tpu_torch.dataset.frame import MLFrame
from cycloneml_tpu_torch.linalg.matrices import DenseMatrix
from cycloneml_tpu_torch.linalg.vectors import DenseVector, Vectors
from cycloneml_tpu_torch.ml.base import Predictor, ProbabilisticClassificationModel
from cycloneml_tpu_torch.ml.optim.fm_core import fm_margin_np, split_fm_coef, train_fm
from cycloneml_tpu_torch.ml.optim.loss import validate_binary_labels
from cycloneml_tpu_torch.ml.regression.fm import _FMParams
from cycloneml_tpu_torch.ml.util_io import MLReadable, MLWritable, load_arrays, save_arrays


class FMClassifier(Predictor, _FMParams, MLWritable, MLReadable):
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

    def _fit(self, frame: MLFrame) -> "FMClassificationModel":
        ds = frame.to_instance_dataset(
            self.get("featuresCol"), self.get("labelCol"), None)
        validate_binary_labels(ds.unpad(ds.y_host()), "FMClassifier")
        d = ds.n_features
        coef, history = train_fm(
            ds, d, "logistic", self.get("factorSize"),
            self.get("fitIntercept"), self.get("fitLinear"),
            self.get("regParam"), self.get("miniBatchFraction"),
            self.get("initStd"), self.get("maxIter"), self.get("stepSize"),
            self.get("tol"), self.get("solver"), self.get("seed"))
        V_, w, b = split_fm_coef(coef, d, self.get("factorSize"),
                                 self.get("fitIntercept"),
                                 self.get("fitLinear"))
        model = FMClassificationModel(V_, w, b, uid=self.uid)
        self._copy_values(model)
        model._set_parent(self)
        model.objective_history = history
        return model


class FMClassificationModel(ProbabilisticClassificationModel, _FMParams,
                            MLWritable, MLReadable):
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
    def num_classes(self) -> int:
        return 2

    @property
    def num_features(self) -> int:
        return self._V.shape[0]

    def _raw_prediction(self, x: np.ndarray) -> np.ndarray:
        m = fm_margin_np(x, self._V, self._w, self._b)
        return np.stack([-m, m], axis=1)

    def _raw_to_probability(self, raw: np.ndarray) -> np.ndarray:
        p = 1.0 / (1.0 + np.exp(-raw[:, 1]))
        return np.stack([1.0 - p, p], axis=1)

    def _save_data(self, path: str) -> None:
        save_arrays(path, V=self._V, w=self._w, b=np.array(self._b))

    def _load_data(self, path: str, meta) -> None:
        arrs = load_arrays(path)
        self._V, self._w, self._b = arrs["V"], arrs["w"], float(arrs["b"])
