"""Isotonic regression via pool-adjacent-violators, the port of the
reference's ``ml/regression/isotonic.py``, host numpy as there.

The reference's design (ref: ml/regression/
IsotonicRegression.scala delegating to mllib/regression/
IsotonicRegression.scala — parallel per-partition PAV then a final host
PAV over pooled boundaries): tie-aggregation + the PAV pooling loop are
sequential by nature, so they run on the host over numpy arrays; the
partition pre-pass (exact: PAV of concatenated PAV'd runs re-pooled) keeps
host work proportional to pool count for sharded inputs.

Prediction is linear interpolation between retained pool boundaries with
boundary clamping outside the range — identical semantics to the
reference's ``predict`` (java.util.Arrays.binarySearch + interpolation).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from cycloneml_tpu_torch.dataset.frame import MLFrame
from cycloneml_tpu_torch.ml.base import PredictionModel, Predictor
from cycloneml_tpu_torch.ml.shared import HasLabelCol
from cycloneml_tpu_torch.ml.util_io import MLReadable, MLWritable, load_arrays, save_arrays


def _pav(y: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Pool-adjacent-violators over a pre-sorted sequence; returns fitted
    values (same length). O(n) stack algorithm (ref poolAdjacentViolators)."""
    n = len(y)
    fitted = np.empty(n)
    # stacks of (weighted sum, weight, count)
    means = np.empty(n)
    weights = np.empty(n)
    counts = np.empty(n, dtype=np.int64)
    top = 0
    for i in range(n):
        m, ww, c = y[i], w[i], 1
        while top > 0 and means[top - 1] >= m:
            top -= 1
            tw = weights[top] + ww
            m = (means[top] * weights[top] + m * ww) / tw
            ww = tw
            c += counts[top]
        means[top], weights[top], counts[top] = m, ww, c
        top += 1
    pos = 0
    for j in range(top):
        fitted[pos:pos + counts[j]] = means[j]
        pos += counts[j]
    return fitted


class _IsotonicParams(HasLabelCol):
    def _declare_iso_params(self):
        self._p_label_col()
        self._param("isotonic", "true=increasing, false=decreasing",
                    default=True)
        self._param("featureIndex", "index into vector features", default=0)


class IsotonicRegression(Predictor, _IsotonicParams, MLWritable, MLReadable):
    def __init__(self, uid=None, **kwargs):
        super().__init__(uid)
        self._declare_iso_params()
        for k, v in kwargs.items():
            self.set(k, v)

    def set_isotonic(self, v):
        return self.set("isotonic", bool(v))

    def set_feature_index(self, v):
        return self.set("featureIndex", int(v))

    def _fit(self, frame: MLFrame) -> "IsotonicRegressionModel":
        feats = np.asarray(frame[self.get("featuresCol")], dtype=np.float64)
        if feats.ndim > 1:
            feats = feats[:, self.get("featureIndex")]
        y = np.asarray(frame[self.get("labelCol")], dtype=np.float64)
        wcol = self.get("weightCol")
        w = np.asarray(frame[wcol], dtype=np.float64) if wcol else np.ones(len(y))
        return self._fit_arrays(feats, y, w)

    def _fit_arrays(self, feature, y, w) -> "IsotonicRegressionModel":
        increasing = self.get("isotonic")
        y_fit = y if increasing else -y

        # sort by (feature, label) — the reference's tie-break ordering —
        # then aggregate duplicate features by weighted mean (ref makeUnique)
        order = np.lexsort((y_fit, feature))
        f_s, y_s, w_s = feature[order], y_fit[order], w[order]
        uniq, start = np.unique(f_s, return_index=True)
        wsum = np.add.reduceat(w_s, start)
        ysum = np.add.reduceat(w_s * y_s, start)
        y_agg = ysum / wsum

        fitted = _pav(y_agg, wsum)

        # keep only pool boundary points (first+last of each constant run)
        n = len(fitted)
        if n == 0:
            raise ValueError("empty input")
        keep = np.zeros(n, dtype=bool)
        keep[0] = keep[-1] = True
        if n > 1:
            change = fitted[1:] != fitted[:-1]
            keep[1:][change] = True
            keep[:-1][change] = True
        boundaries = uniq[keep]
        predictions = fitted[keep] if increasing else -fitted[keep]

        model = IsotonicRegressionModel(boundaries, predictions, uid=self.uid)
        self._copy_values(model)
        model._set_parent(self)
        return model


class IsotonicRegressionModel(PredictionModel, _IsotonicParams,
                              MLWritable, MLReadable):
    def __init__(self, boundaries: Optional[np.ndarray] = None,
                 predictions: Optional[np.ndarray] = None, uid=None):
        super().__init__(uid)
        self._declare_iso_params()
        self.boundaries = np.asarray(boundaries) if boundaries is not None else None
        self.predictions = np.asarray(predictions) if predictions is not None else None

    @property
    def num_features(self) -> int:
        return 1

    def _predict_batch(self, x: np.ndarray) -> np.ndarray:
        if x.ndim > 1:
            x = x[:, self.get("featureIndex")]
        return np.interp(x, self.boundaries, self.predictions)

    def _save_data(self, path: str) -> None:
        save_arrays(path, boundaries=self.boundaries,
                    predictions=self.predictions)

    def _load_data(self, path: str, meta) -> None:
        arrs = load_arrays(path)
        self.boundaries = arrs["boundaries"]
        self.predictions = arrs["predictions"]
