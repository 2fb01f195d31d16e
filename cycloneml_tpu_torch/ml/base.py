"""Estimator / Transformer / Predictor abstractions.

The port's counterpart of ``cycloneml_tpu/ml/base.py`` (the part the
ported estimators use; Pipeline and persistence come with ROADMAP slice 9):
estimators fit on an ``MLFrame`` (or an ``InstanceDataset``), models
transform frames by adding prediction columns.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from cycloneml_tpu_torch.ml.param import ParamMap, Params
from cycloneml_tpu_torch.ml.shared import (
    HasFeaturesCol, HasLabelCol, HasPredictionCol, HasProbabilityCol,
    HasRawPredictionCol, HasWeightCol,
)


class PipelineStage(Params):
    """Base of Estimator and Transformer."""


class Transformer(PipelineStage):
    def transform(self, frame, params: Optional[ParamMap] = None):
        if params is not None:
            return self.copy(params).transform(frame)
        return self._transform(frame)

    def _transform(self, frame):
        raise NotImplementedError


class Estimator(PipelineStage):
    def fit(self, frame, params: Optional[ParamMap] = None):
        if params is not None:
            return self.copy(params).fit(frame)
        return self._fit(frame)

    def _fit(self, frame):
        raise NotImplementedError


class Model(Transformer):
    """A fitted Transformer with a parent estimator reference."""

    parent: Optional[Estimator] = None

    def _set_parent(self, parent: Estimator) -> "Model":
        self.parent = parent
        return self

    def save(self, path: str) -> None:
        raise NotImplementedError("model persistence is ROADMAP slice 9")


class Predictor(Estimator, HasFeaturesCol, HasLabelCol, HasPredictionCol,
                HasWeightCol):
    def __init__(self, uid=None):
        super().__init__(uid)
        self._p_features_col()
        self._p_label_col()
        self._p_prediction_col()
        self._p_weight_col()

    def set_features_col(self, v: str):
        return self.set("featuresCol", v)

    def set_label_col(self, v: str):
        return self.set("labelCol", v)

    def set_prediction_col(self, v: str):
        return self.set("predictionCol", v)

    def set_weight_col(self, v: str):
        return self.set("weightCol", v)


class PredictionModel(Model, HasFeaturesCol, HasPredictionCol):
    def __init__(self, uid=None):
        super().__init__(uid)
        self._p_features_col()
        self._p_prediction_col()

    @property
    def num_features(self) -> int:
        raise NotImplementedError

    def predict(self, features) -> float:
        """Single-vector prediction."""
        arr = features.to_array() if hasattr(features, "to_array") \
            else np.asarray(features)
        return float(self._predict_batch(arr[None, :])[0])

    def _predict_batch(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _transform(self, frame):
        x = frame[self.get("featuresCol")]
        if x.ndim == 1:
            x = x[:, None]
        return frame.with_column(self.get("predictionCol"),
                                 self._predict_batch(x))


class ClassificationModel(PredictionModel, HasRawPredictionCol):
    def __init__(self, uid=None):
        super().__init__(uid)
        self._p_raw_prediction_col()

    @property
    def num_classes(self) -> int:
        raise NotImplementedError

    def _raw_prediction(self, x: np.ndarray) -> np.ndarray:
        """(n, num_classes) margins."""
        raise NotImplementedError

    def _predict_batch(self, x: np.ndarray) -> np.ndarray:
        # through _raw_to_prediction, so threshold-aware subclasses keep
        # predict() consistent with transform()
        return self._raw_to_prediction(self._raw_prediction(x))

    def _transform(self, frame):
        x = frame[self.get("featuresCol")]
        if x.ndim == 1:
            x = x[:, None]
        raw = self._raw_prediction(x)
        out = frame
        if self.get("rawPredictionCol"):
            out = out.with_column(self.get("rawPredictionCol"), raw)
        if self.get("predictionCol"):
            out = out.with_column(self.get("predictionCol"),
                                  self._raw_to_prediction(raw))
        return out

    def _raw_to_prediction(self, raw: np.ndarray) -> np.ndarray:
        return np.argmax(raw, axis=1).astype(np.float64)


class ProbabilisticClassificationModel(ClassificationModel, HasProbabilityCol):
    def __init__(self, uid=None):
        super().__init__(uid)
        self._p_probability_col()

    def _raw_to_probability(self, raw: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _transform(self, frame):
        x = frame[self.get("featuresCol")]
        if x.ndim == 1:
            x = x[:, None]
        raw = self._raw_prediction(x)  # once for all three columns
        out = frame
        if self.get("rawPredictionCol"):
            out = out.with_column(self.get("rawPredictionCol"), raw)
        if self.get("probabilityCol"):
            out = out.with_column(self.get("probabilityCol"),
                                  self._raw_to_probability(raw))
        if self.get("predictionCol"):
            out = out.with_column(self.get("predictionCol"),
                                  self._raw_to_prediction(raw))
        return out
