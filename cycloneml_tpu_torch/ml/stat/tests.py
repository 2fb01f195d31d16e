"""Hypothesis tests & correlation.

The port's counterpart of ``cycloneml_tpu/ml/stat/tests.py``, host numpy
and scipy as there (the contingency tables and moments are small). Parity
with ref: ml/stat/ChiSquareTest.scala, KolmogorovSmirnovTest.scala,
ANOVATest.scala, FValueTest.scala, Correlation.scala (pearson/spearman,
mllib/stat/correlation/). Contingency/moment accumulation is vectorized;
p-values from scipy distributions (the reference uses commons-math).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from cycloneml_tpu_torch.dataset.frame import MLFrame
from cycloneml_tpu_torch.linalg.matrices import DenseMatrix


class ChiSquareTest:
    @staticmethod
    def test(frame: MLFrame, features_col: str, label_col: str) -> Dict[str, np.ndarray]:
        """Pearson chi-squared independence test of each feature vs label
        (ref ChiSquareTest.scala / mllib Statistics.chiSqTest)."""
        from scipy.stats import chi2
        x = frame[features_col]
        if x.ndim == 1:
            x = x[:, None]
        y = np.asarray(frame[label_col])
        d = x.shape[1]
        stats, pvals, dofs = np.zeros(d), np.zeros(d), np.zeros(d, dtype=int)
        y_codes, y_idx = np.unique(y, return_inverse=True)
        for j in range(d):
            f_codes, f_idx = np.unique(x[:, j], return_inverse=True)
            table = np.zeros((len(f_codes), len(y_codes)))
            np.add.at(table, (f_idx, y_idx), 1.0)
            expected = table.sum(1, keepdims=True) * table.sum(0, keepdims=True) / table.sum()
            with np.errstate(divide="ignore", invalid="ignore"):
                contrib = np.where(expected > 0, (table - expected) ** 2 / expected, 0.0)
            stat = float(contrib.sum())
            dof = (table.shape[0] - 1) * (table.shape[1] - 1)
            stats[j] = stat
            dofs[j] = dof
            pvals[j] = float(chi2.sf(stat, dof)) if dof > 0 else 1.0
        return {"pValues": pvals, "statistics": stats, "degreesOfFreedom": dofs}


class KolmogorovSmirnovTest:
    @staticmethod
    def test(frame: MLFrame, sample_col: str, dist: str = "norm",
             *params) -> Dict[str, float]:
        """One-sample two-sided KS test (ref KolmogorovSmirnovTest.scala)."""
        from scipy import stats as ss
        x = np.asarray(frame[sample_col], dtype=np.float64)
        if dist != "norm":
            raise ValueError("only 'norm' is supported (as the reference)")
        loc = params[0] if len(params) >= 1 else 0.0
        scale = params[1] if len(params) >= 2 else 1.0
        stat, p = ss.kstest(x, "norm", args=(loc, scale))
        return {"pValue": float(p), "statistic": float(stat)}


class ANOVATest:
    @staticmethod
    def test(frame: MLFrame, features_col: str, label_col: str) -> Dict[str, np.ndarray]:
        """One-way ANOVA F-test per feature, categorical label
        (ref ANOVATest.scala)."""
        from scipy.stats import f as f_dist
        x = frame[features_col]
        if x.ndim == 1:
            x = x[:, None]
        y = np.asarray(frame[label_col])
        classes = np.unique(y)
        n, d = x.shape
        k = len(classes)
        stats, pvals = np.zeros(d), np.zeros(d)
        grand = x.mean(axis=0)
        ss_between = np.zeros(d)
        ss_within = np.zeros(d)
        for c in classes:
            xc = x[y == c]
            ss_between += len(xc) * (xc.mean(axis=0) - grand) ** 2
            ss_within += ((xc - xc.mean(axis=0)) ** 2).sum(axis=0)
        df1, df2 = k - 1, n - k
        with np.errstate(divide="ignore", invalid="ignore"):
            f_stat = (ss_between / df1) / (ss_within / df2)
        # zero within-group variance with nonzero between = perfect separation
        f_stat = np.where((ss_within == 0) & (ss_between > 0), np.inf, f_stat)
        f_stat = np.where((ss_within == 0) & (ss_between == 0), 0.0, f_stat)
        stats[:] = f_stat
        pvals[:] = f_dist.sf(f_stat, df1, df2)
        return {"pValues": pvals, "fValues": stats,
                "degreesOfFreedom": np.array([df1, df2])}


class FValueTest:
    @staticmethod
    def test(frame: MLFrame, features_col: str, label_col: str) -> Dict[str, np.ndarray]:
        """F-test for regression (continuous label) per feature
        (ref FValueTest.scala)."""
        from scipy.stats import f as f_dist
        x = frame[features_col]
        if x.ndim == 1:
            x = x[:, None]
        y = np.asarray(frame[label_col], dtype=np.float64)
        n, d = x.shape
        xc = x - x.mean(axis=0)
        yc = y - y.mean()
        denom = np.sqrt((xc ** 2).sum(axis=0) * (yc ** 2).sum())
        with np.errstate(divide="ignore", invalid="ignore"):
            r = np.where(denom > 0, xc.T @ yc / denom, 0.0)
        df2 = n - 2
        f_stat = r ** 2 / np.maximum(1 - r ** 2, 1e-300) * df2
        return {"pValues": f_dist.sf(f_stat, 1, df2), "fValues": f_stat,
                "degreesOfFreedom": np.array([1, df2])}


class Correlation:
    @staticmethod
    def corr(frame: MLFrame, col: str, method: str = "pearson") -> DenseMatrix:
        """Feature correlation matrix (ref Correlation.scala; pearson via the
        reference's moment formula, spearman via rank transform then pearson,
        ref mllib/stat/correlation/SpearmanCorrelation.scala)."""
        x = frame[col]
        if x.ndim == 1:
            x = x[:, None]
        x = np.asarray(x, dtype=np.float64)
        if method == "spearman":
            from scipy.stats import rankdata
            x = np.apply_along_axis(rankdata, 0, x)
        elif method != "pearson":
            raise ValueError("method must be pearson or spearman")
        xc = x - x.mean(axis=0)
        cov = xc.T @ xc
        std = np.sqrt(np.maximum(np.diag(cov), 0.0))
        with np.errstate(divide="ignore", invalid="ignore"):
            corr = cov / std[:, None] / std[None, :]
        corr[~np.isfinite(corr)] = np.nan
        np.fill_diagonal(corr, 1.0)
        return DenseMatrix.from_array(corr)
