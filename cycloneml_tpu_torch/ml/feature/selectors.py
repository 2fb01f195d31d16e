"""Feature selectors — the port's counterpart of
``cycloneml_tpu/ml/feature/selectors.py``, on ``ml/stat/tests.py``.

Parity with ref ml/feature: ChiSqSelector.scala, VarianceThresholdSelector,
UnivariateFeatureSelector.scala.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from cycloneml_tpu_torch.ml.base import Estimator, Model
from cycloneml_tpu_torch.ml.feature.scalers import _InOutCol
from cycloneml_tpu_torch.ml.param import ParamValidators as V
from cycloneml_tpu_torch.ml.stat.tests import ANOVATest, ChiSquareTest, FValueTest
from cycloneml_tpu_torch.ml.util_io import MLReadable, MLWritable, load_arrays, save_arrays


class _SelectorModelBase(Model, _InOutCol, MLWritable, MLReadable):
    def __init__(self, selected: Optional[np.ndarray] = None, uid=None):
        super().__init__(uid)
        self._p_in_out(out_default="selected")
        self.selected = np.asarray(selected, dtype=np.int64) \
            if selected is not None else None

    @property
    def selected_features(self) -> List[int]:
        return [int(i) for i in self.selected]

    def _transform(self, frame):
        return frame.with_column(self.get("outputCol"),
                                 self._in(frame)[:, self.selected])

    def _save_data(self, path):
        save_arrays(path, selected=self.selected)

    def _load_data(self, path, meta):
        self.selected = load_arrays(path)["selected"]


def _select_by_mode(scores: np.ndarray, pvals: np.ndarray, mode: str,
                    param: float) -> np.ndarray:
    d = len(scores)
    order = np.argsort(-scores, kind="stable")
    if mode == "numTopFeatures":
        sel = order[: int(param)]
    elif mode == "percentile":
        sel = order[: max(int(d * param), 1)]
    elif mode == "fpr":
        sel = np.nonzero(pvals < param)[0]
    elif mode == "fdr":
        # Benjamini-Hochberg (ref ChiSqSelector fdr mode)
        ps = np.sort(pvals)
        thresh = param * (np.arange(1, d + 1) / d)
        ok = np.nonzero(ps <= thresh)[0]
        cut = ps[ok[-1]] if len(ok) else -1.0
        sel = np.nonzero(pvals <= cut)[0]
    elif mode == "fwe":
        sel = np.nonzero(pvals < param / d)[0]
    else:
        raise ValueError(f"unknown selector mode {mode}")
    return np.sort(sel)


class _SelectorParams(_InOutCol):
    def _p_selector(self):
        self._p_in_out(out_default="selected")
        self.labelCol = self._param("labelCol", "label column", default="label")
        self.selectorType = self._param(
            "selectorType", "selection mode",
            V.in_array(["numTopFeatures", "percentile", "fpr", "fdr", "fwe"]),
            default="numTopFeatures")
        self.numTopFeatures = self._param("numTopFeatures", "top features",
                                          V.gt(0), default=50)
        self.percentile = self._param("percentile", "fraction to keep",
                                      V.in_range(0, 1), default=0.1)
        self.fpr = self._param("fpr", "false positive rate",
                               V.in_range(0, 1, False, True), default=0.05)
        self.fdr = self._param("fdr", "false discovery rate",
                               V.in_range(0, 1, False, True), default=0.05)
        self.fwe = self._param("fwe", "family-wise error rate",
                               V.in_range(0, 1, False, True), default=0.05)

    def _mode_param(self):
        mode = self.get("selectorType")
        return mode, {
            "numTopFeatures": lambda: self.get("numTopFeatures"),
            "percentile": lambda: self.get("percentile"),
            "fpr": lambda: self.get("fpr"),
            "fdr": lambda: self.get("fdr"),
            "fwe": lambda: self.get("fwe"),
        }[mode]()


class ChiSqSelector(Estimator, _SelectorParams, MLWritable, MLReadable):
    """Chi-squared feature selection (ref ChiSqSelector.scala)."""

    def __init__(self, uid=None, **kw):
        super().__init__(uid)
        self._p_selector()
        for k, v in kw.items():
            self.set(k, v)

    def _fit(self, frame) -> "ChiSqSelectorModel":
        res = ChiSquareTest.test(frame, self.get("inputCol"), self.get("labelCol"))
        mode, param = self._mode_param()
        sel = _select_by_mode(res["statistics"], res["pValues"], mode, param)
        m = ChiSqSelectorModel(sel, uid=self.uid)
        self._copy_values(m)
        return m._set_parent(self)


class ChiSqSelectorModel(_SelectorModelBase):
    pass


class VarianceThresholdSelector(Estimator, _InOutCol, MLWritable, MLReadable):
    """Drop features with variance <= threshold (ref
    VarianceThresholdSelector.scala)."""

    def __init__(self, uid=None, **kw):
        super().__init__(uid)
        self._p_in_out(out_default="selected")
        self.varianceThreshold = self._param("varianceThreshold",
                                             "variance cutoff", V.gt_eq(0.0),
                                             default=0.0)
        for k, v in kw.items():
            self.set(k, v)

    def _fit(self, frame) -> "VarianceThresholdSelectorModel":
        x = self._in(frame)
        var = x.var(axis=0, ddof=1)
        sel = np.nonzero(var > self.get("varianceThreshold"))[0]
        m = VarianceThresholdSelectorModel(sel, uid=self.uid)
        self._copy_values(m)
        return m._set_parent(self)


class VarianceThresholdSelectorModel(_SelectorModelBase):
    pass


class UnivariateFeatureSelector(Estimator, _SelectorParams, MLWritable, MLReadable):
    """Selector choosing the test by feature/label types
    (ref UnivariateFeatureSelector.scala): categorical/categorical → chi2,
    continuous/categorical → ANOVA F, continuous/continuous → F-value."""

    def __init__(self, uid=None, **kw):
        super().__init__(uid)
        self._p_selector()
        self.featureType = self._param("featureType", "categorical|continuous",
                                       V.in_array(["categorical", "continuous"]),
                                       default="continuous")
        self.labelType = self._param("labelType", "categorical|continuous",
                                     V.in_array(["categorical", "continuous"]),
                                     default="categorical")
        for k, v in kw.items():
            self.set(k, v)

    def _fit(self, frame) -> "UnivariateFeatureSelectorModel":
        ft, lt = self.get("featureType"), self.get("labelType")
        fcol, lcol = self.get("inputCol"), self.get("labelCol")
        if ft == "categorical" and lt == "categorical":
            res = ChiSquareTest.test(frame, fcol, lcol)
            scores = res["statistics"]
        elif ft == "continuous" and lt == "categorical":
            res = ANOVATest.test(frame, fcol, lcol)
            scores = res["fValues"]
        elif ft == "continuous" and lt == "continuous":
            res = FValueTest.test(frame, fcol, lcol)
            scores = res["fValues"]
        else:
            raise ValueError("categorical features with continuous label "
                             "is unsupported (as the reference)")
        mode, param = self._mode_param()
        sel = _select_by_mode(scores, res["pValues"], mode, param)
        m = UnivariateFeatureSelectorModel(sel, uid=self.uid)
        self._copy_values(m)
        return m._set_parent(self)


class UnivariateFeatureSelectorModel(_SelectorModelBase):
    pass
