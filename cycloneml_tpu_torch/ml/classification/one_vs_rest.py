"""One-vs-rest multiclass reduction.

The port's counterpart of ``cycloneml_tpu/ml/classification/one_vs_rest.py``
(ref OneVsRest.scala): one binary copy of the base classifier per class over
relabeled data; the model predicts the class whose binary margin is the
largest.

``parallelism > 1`` routes through the stacked fit (``fit_stacked``) when
the base classifier supports it: the K binary fits share one X and train
together, every evaluation of all K models one aggregation (kernel K1s on
the card, reading X once). Otherwise the K fits run one after another, as
the reference's serial fallback does.

Besides a frame, the fit takes an :class:`InstanceDataset` (data made on the
card): its labels are read from the dataset's host twin, and the serial
path relabels it through ``derive``. Persistence (``save``/``load``) is
ROADMAP slice 9.
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np
import torch

from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
from cycloneml_tpu_torch.dataset.instance import compute_dtype, data_dtype
from cycloneml_tpu_torch.ml.base import ClassificationModel, Estimator, Model
from cycloneml_tpu_torch.ml.param import ParamValidators as V
from cycloneml_tpu_torch.ml.shared import (
    HasFeaturesCol, HasLabelCol, HasPredictionCol, HasRawPredictionCol,
    HasWeightCol,
)
from cycloneml_tpu_torch.mesh import safe_fit_parallelism

logger = logging.getLogger(__name__)


class _OVRParams(HasFeaturesCol, HasLabelCol, HasPredictionCol,
                 HasRawPredictionCol, HasWeightCol):
    def _declare_ovr_params(self):
        self._p_features_col()
        self._p_label_col()
        self._p_prediction_col()
        self._p_raw_prediction_col()
        self._p_weight_col()
        self.parallelism = self._param(
            "parallelism", "max concurrent binary fits (>= 1)",
            V.gt_eq(1), default=1)


def _labels(frame, label_col: str) -> np.ndarray:
    """The frame's labels as a host vector (a dataset's real rows)."""
    if isinstance(frame, InstanceDataset):
        return np.asarray(frame.y_host()[:frame.n_rows])
    return np.asarray(frame[label_col])


class OneVsRest(Estimator, _OVRParams):
    def __init__(self, classifier: Optional[Estimator] = None, uid=None,
                 **kwargs):
        super().__init__(uid)
        self._declare_ovr_params()
        self.classifier = classifier
        for k, v in kwargs.items():
            self.set(k, v)

    def set_classifier(self, clf: Estimator) -> "OneVsRest":
        self.classifier = clf
        return self

    def set_parallelism(self, v):
        return self.set("parallelism", v)

    def _configure(self, clf):
        clf.set("featuresCol", self.get("featuresCol"))
        wc = self.get("weightCol")
        if wc and "weightCol" in clf._params:
            clf.set("weightCol", wc)
        return clf

    def _fit(self, frame) -> "OneVsRestModel":
        if self.classifier is None:
            raise ValueError("classifier must be set")
        label_col = self.get("labelCol")
        y = _labels(frame, label_col)
        num_classes = int(y.max()) + 1
        conf = getattr(frame.ctx, "conf", None)
        requested = self.get("parallelism")
        clf = self._configure(self.classifier.copy())
        stackable = (requested > 1 and num_classes > 1
                     and hasattr(clf, "fit_stacked")
                     and clf.can_fit_stacked()
                     and hasattr(frame, "to_instance_dataset"))
        if stackable:
            effective = safe_fit_parallelism(requested,
                                             stacked_width=num_classes)
            logger.info("OneVsRest: fitting %d binary models as one "
                        "stacked fit (effective parallelism %d)",
                        num_classes, effective)
            clf.set("labelCol", label_col)
            # ONE (K, n) {0, 1} label matrix in the data tier (exact in
            # bf16), not K float64 host vectors
            yt = torch.from_numpy(np.array(y))
            y_stack = (torch.arange(num_classes)[:, None] == yt[None, :]).to(
                data_dtype(conf))
            models = clf.fit_stacked(frame, y_stack)
        else:
            safe_fit_parallelism(requested)
            np_dt = torch.empty(0, dtype=compute_dtype(conf)).numpy().dtype
            models = []
            for c in range(num_classes):
                # one transient relabel per class, in the accumulator tier
                binary = (y == c).astype(np_dt)
                one = self._configure(self.classifier.copy())
                if isinstance(frame, InstanceDataset):
                    sub = _relabeled(frame, binary)
                else:
                    sub = frame.with_column("_ovr_label", binary)
                    one.set("labelCol", "_ovr_label")
                models.append(one.fit(sub))

        model = OneVsRestModel(models, uid=self.uid)
        self._copy_values(model)
        model._set_parent(self)
        return model

    def copy(self, extra=None) -> "OneVsRest":
        that = super().copy(extra)
        that.classifier = self.classifier.copy() if self.classifier else None
        return that


def _relabeled(ds: InstanceDataset, binary: np.ndarray) -> InstanceDataset:
    """``ds`` with the real rows' labels replaced by ``binary`` (padding
    rows keep label 0 and w = 0); X is shared."""
    y_pad = np.zeros(ds.x.shape[0], dtype=binary.dtype)
    y_pad[:ds.n_rows] = binary
    sub = ds.derive(y=ds.ctx.mesh_runtime.device_put_sharded_rows(y_pad))
    return sub.attach_host_labels(y_pad, ds.w_host())


class OneVsRestModel(Model, _OVRParams):
    def __init__(self, models: Optional[List[ClassificationModel]] = None,
                 uid=None):
        super().__init__(uid)
        self._declare_ovr_params()
        self.models = list(models or [])

    @property
    def num_classes(self) -> int:
        return len(self.models)

    def _transform(self, frame):
        x = frame[self.get("featuresCol")]
        if x.ndim == 1:
            x = x[:, None]
        # each binary model's margin of its positive class
        margins = np.stack(
            [m._raw_prediction(x)[:, 1] for m in self.models], axis=1)
        out = frame
        if self.get("rawPredictionCol"):
            out = out.with_column(self.get("rawPredictionCol"), margins)
        return out.with_column(self.get("predictionCol"),
                               margins.argmax(1).astype(np.float64))

    def copy(self, extra=None) -> "OneVsRestModel":
        that = super().copy(extra)
        that.models = [m.copy() for m in self.models]
        return that
