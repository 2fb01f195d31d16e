"""Evaluators — host numpy over a scored frame.

The port's copy of ``cycloneml_tpu/ml/evaluation/evaluators.py`` (ref
ml/evaluation: Evaluator.scala, BinaryClassificationEvaluator with
areaUnderROC/areaUnderPR from the mllib BinaryClassificationMetrics curves,
MulticlassClassificationEvaluator, RegressionEvaluator). The clustering,
multilabel and ranking evaluators are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from cycloneml_tpu_torch.ml.param import Params, ParamValidators as V
from cycloneml_tpu_torch.ml.util_io import MLReadable, MLWritable

# numpy 2 names it trapezoid; numpy 1 only trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


class Evaluator(Params, MLWritable, MLReadable):
    """Base (ref Evaluator.scala): evaluate + isLargerBetter; ``save`` and
    ``load`` round-trip its params through the model metadata layout
    (``ml/util_io``)."""

    def evaluate(self, frame) -> float:
        raise NotImplementedError

    @property
    def is_larger_better(self) -> bool:
        return True


def binary_curve_points(score: np.ndarray, y: np.ndarray,
                        w: Optional[np.ndarray] = None):
    """Descending-score cumulative true and false positives, tied scores
    collapsed to one point (each tie group's last cumulative, so the metric
    does not depend on row order within ties). Returns (thresholds, tps,
    fps, tp_total, fp_total), the totals floored at 1e-300."""
    if w is None:
        w = np.ones(len(y))
    order = np.argsort(-score, kind="stable")
    y, w, s = y[order], w[order], score[order]
    tps = np.cumsum(w * y)
    fps = np.cumsum(w * (1 - y))
    last_of_group = np.append(s[1:] != s[:-1], True)
    tps, fps, thresholds = (tps[last_of_group], fps[last_of_group],
                            s[last_of_group])
    return (thresholds, tps, fps,
            max(float(tps[-1]), 1e-300), max(float(fps[-1]), 1e-300))


class BinaryClassificationEvaluator(Evaluator):
    def __init__(self, uid=None, **kw):
        super().__init__(uid)
        self.rawPredictionCol = self._param("rawPredictionCol",
                                            "raw prediction/score column",
                                            default="rawPrediction")
        self.labelCol = self._param("labelCol", "label column",
                                    default="label")
        self.weightCol = self._param("weightCol", "weight column", default="")
        self.metricName = self._param(
            "metricName", "areaUnderROC|areaUnderPR",
            V.in_array(["areaUnderROC", "areaUnderPR"]),
            default="areaUnderROC")
        for k, v in kw.items():
            self.set(k, v)

    def evaluate(self, frame) -> float:
        raw = frame[self.get("rawPredictionCol")]
        score = raw[:, 1] if raw.ndim == 2 else np.asarray(raw,
                                                           dtype=np.float64)
        y = np.asarray(frame[self.get("labelCol")], dtype=np.float64)
        wcol = self.get("weightCol")
        w = np.asarray(frame[wcol], dtype=np.float64) if wcol \
            else np.ones(len(y))
        _, tps, fps, tp_tot, fp_tot = binary_curve_points(score, y, w)
        if self.get("metricName") == "areaUnderROC":
            tpr = np.concatenate([[0.0], tps / tp_tot])
            fpr = np.concatenate([[0.0], fps / fp_tot])
            return float(_trapezoid(tpr, fpr))
        precision = tps / np.maximum(tps + fps, 1e-300)
        recall = np.concatenate([[0.0], tps / tp_tot])
        precision = np.concatenate([[1.0], precision])
        return float(_trapezoid(precision, recall))


class MulticlassClassificationEvaluator(Evaluator):
    _METRICS = ["f1", "accuracy", "weightedPrecision", "weightedRecall",
                "weightedFMeasure", "weightedTruePositiveRate",
                "weightedFalsePositiveRate", "logLoss", "hammingLoss"]

    def __init__(self, uid=None, **kw):
        super().__init__(uid)
        self.predictionCol = self._param("predictionCol", "prediction column",
                                         default="prediction")
        self.labelCol = self._param("labelCol", "label column",
                                    default="label")
        self.probabilityCol = self._param("probabilityCol",
                                          "probability column (for logLoss)",
                                          default="probability")
        self.metricName = self._param("metricName", "metric",
                                      V.in_array(self._METRICS), default="f1")
        self.beta = self._param("beta", "F-beta", V.gt(0.0), default=1.0)
        for k, v in kw.items():
            self.set(k, v)

    @property
    def is_larger_better(self) -> bool:
        return self.get("metricName") not in ("logLoss", "hammingLoss")

    def evaluate(self, frame) -> float:
        metric = self.get("metricName")
        y = np.asarray(frame[self.get("labelCol")], dtype=np.int64)
        if metric == "logLoss":
            probs = frame[self.get("probabilityCol")]
            p = np.clip(probs[np.arange(len(y)), y], 1e-15, 1.0)
            return float(-np.log(p).mean())
        pred = np.asarray(frame[self.get("predictionCol")], dtype=np.int64)
        if metric == "accuracy":
            return float((pred == y).mean())
        if metric == "hammingLoss":
            return float((pred != y).mean())
        classes = np.unique(np.concatenate([y, pred]))
        n = len(y)
        weights = np.array([(y == c).sum() / n for c in classes])
        prec, rec, fpr = [], [], []
        for c in classes:
            tp = float(((pred == c) & (y == c)).sum())
            fp = float(((pred == c) & (y != c)).sum())
            fn = float(((pred != c) & (y == c)).sum())
            tn = n - tp - fp - fn
            prec.append(tp / max(tp + fp, 1e-300))
            rec.append(tp / max(tp + fn, 1e-300))
            fpr.append(fp / max(fp + tn, 1e-300))
        prec, rec = np.array(prec), np.array(rec)
        if metric == "weightedPrecision":
            return float((weights * prec).sum())
        if metric in ("weightedRecall", "weightedTruePositiveRate"):
            return float((weights * rec).sum())
        if metric == "weightedFalsePositiveRate":
            return float((weights * np.array(fpr)).sum())
        # 'f1' is always beta=1 (as the reference); 'weightedFMeasure'
        # honours beta
        beta2 = (self.get("beta") if metric == "weightedFMeasure"
                 else 1.0) ** 2
        f = (1 + beta2) * prec * rec / np.maximum(beta2 * prec + rec, 1e-300)
        return float((weights * f).sum())


class RegressionEvaluator(Evaluator):
    """rmse, mse, mae, r2 (1 - SSE/SST) and var (of the predictions)."""

    def __init__(self, uid=None, **kw):
        super().__init__(uid)
        self.predictionCol = self._param("predictionCol", "prediction column",
                                         default="prediction")
        self.labelCol = self._param("labelCol", "label column",
                                    default="label")
        self.metricName = self._param(
            "metricName", "rmse|mse|mae|r2|var",
            V.in_array(["rmse", "mse", "mae", "r2", "var"]), default="rmse")
        for k, v in kw.items():
            self.set(k, v)

    @property
    def is_larger_better(self) -> bool:
        return self.get("metricName") in ("r2", "var")

    def evaluate(self, frame) -> float:
        y = np.asarray(frame[self.get("labelCol")], dtype=np.float64)
        pred = np.asarray(frame[self.get("predictionCol")], dtype=np.float64)
        resid = y - pred
        m = self.get("metricName")
        if m == "rmse":
            return float(np.sqrt((resid ** 2).mean()))
        if m == "mse":
            return float((resid ** 2).mean())
        if m == "mae":
            return float(np.abs(resid).mean())
        if m == "var":
            return float(pred.var())
        sst = ((y - y.mean()) ** 2).sum()
        return float(1.0 - (resid ** 2).sum() / max(sst, 1e-300))
