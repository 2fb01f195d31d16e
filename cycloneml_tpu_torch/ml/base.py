"""Estimator / Transformer / Pipeline / Predictor abstractions.

The port's counterpart of ``cycloneml_tpu/ml/base.py`` (ref: mllib/src/main/
scala/org/apache/spark/ml/Pipeline.scala:93 Pipeline, :296 PipelineModel;
Predictor.scala; classification/Classifier.scala): estimators fit on an
``MLFrame`` (or an ``InstanceDataset``), models transform frames by adding
columns, and a Pipeline chains stages. Persistence is ``ml/util_io.py``'s.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from cycloneml_tpu_torch.ml.param import ParamMap, Params
from cycloneml_tpu_torch.ml.shared import (
    HasFeaturesCol, HasLabelCol, HasPredictionCol, HasProbabilityCol,
    HasRawPredictionCol, HasWeightCol,
)
from cycloneml_tpu_torch.ml.util_io import (
    MLReadable, MLWritable, load_pipeline_stages, save_pipeline_stages,
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


class Pipeline(Estimator, MLWritable, MLReadable):
    """Chain of stages (ref Pipeline.scala:93): fit runs the estimators in
    order, transforming the frame through each fitted model up to the last
    estimator."""

    def __init__(self, stages: Optional[Sequence[PipelineStage]] = None,
                 uid=None):
        super().__init__(uid)
        self.stagesParam = self._param("stages", "pipeline stages")
        if stages is not None:
            self.set_stages(list(stages))

    def set_stages(self, stages: List[PipelineStage]) -> "Pipeline":
        self._stages = list(stages)
        return self

    def get_stages(self) -> List[PipelineStage]:
        return list(getattr(self, "_stages", []))

    def _fit(self, frame) -> "PipelineModel":
        cur = frame
        fitted: List[Transformer] = []
        stages = self.get_stages()
        # transformers after the last estimator need not see the data
        last_est = -1
        for i, s in enumerate(stages):
            if isinstance(s, Estimator):
                last_est = i
        for i, stage in enumerate(stages):
            if isinstance(stage, Estimator):
                model = stage.fit(cur)
                fitted.append(model)
                if i < last_est:
                    cur = model.transform(cur)
            elif isinstance(stage, Transformer):
                fitted.append(stage)
                if i < last_est:
                    cur = stage.transform(cur)
            else:
                raise TypeError(f"stage {stage} is neither Estimator nor "
                                "Transformer")
        return PipelineModel(fitted, uid=self.uid)._set_parent(self)

    def copy(self, extra: Optional[ParamMap] = None) -> "Pipeline":
        that = super().copy(extra)
        that._stages = [s.copy(extra) for s in self.get_stages()]
        return that

    def _save_data(self, path: str) -> None:
        save_pipeline_stages(self.get_stages(), path)

    def _load_data(self, path: str, meta) -> None:
        self._stages = load_pipeline_stages(path)


class PipelineModel(Model, MLWritable, MLReadable):
    """Fitted pipeline (ref Pipeline.scala:296)."""

    def __init__(self, stages: Optional[List[Transformer]] = None, uid=None):
        super().__init__(uid)
        self.stages = list(stages or [])

    def _transform(self, frame):
        cur = frame
        for stage in self.stages:
            cur = stage.transform(cur)
        return cur

    def copy(self, extra: Optional[ParamMap] = None) -> "PipelineModel":
        that = super().copy(extra)
        that.stages = [s.copy(extra) for s in self.stages]
        return that

    def _save_data(self, path: str) -> None:
        save_pipeline_stages(self.stages, path)

    def _load_data(self, path: str, meta) -> None:
        self.stages = load_pipeline_stages(path)


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
