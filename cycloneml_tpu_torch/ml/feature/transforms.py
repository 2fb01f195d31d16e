"""Stateless & simple fitted vector transforms — the port's counterpart of
``cycloneml_tpu/ml/feature/transforms.py``, host numpy as there.

Parity with ref ml/feature: Binarizer.scala, Bucketizer.scala,
ElementwiseProduct.scala, PolynomialExpansion.scala, DCT.scala,
VectorAssembler.scala, VectorSlicer.scala, VectorSizeHint.scala,
Interaction.scala, QuantileDiscretizer.scala, Imputer.scala.
"""

from __future__ import annotations

from itertools import combinations_with_replacement
from typing import List, Optional

import numpy as np

from cycloneml_tpu_torch.ml.base import Estimator, Model, Transformer
from cycloneml_tpu_torch.ml.feature.scalers import _InOutCol
from cycloneml_tpu_torch.ml.param import ParamValidators as V
from cycloneml_tpu_torch.ml.util_io import MLReadable, MLWritable, load_arrays, save_arrays


class Binarizer(Transformer, _InOutCol, MLWritable, MLReadable):
    """x > threshold → 1.0 else 0.0 (ref Binarizer.scala)."""

    def __init__(self, uid=None, **kw):
        super().__init__(uid)
        self._p_in_out(out_default="binarized")
        self.threshold = self._param("threshold", "binarization threshold",
                                     default=0.0)
        for k, v in kw.items():
            self.set(k, v)

    def _transform(self, frame):
        x = frame[self.get("inputCol")]
        return frame.with_column(self.get("outputCol"),
                                 (x > self.get("threshold")).astype(np.float64))


class Bucketizer(Transformer, _InOutCol, MLWritable, MLReadable):
    """Map continuous values to bucket indices by split points
    (ref Bucketizer.scala): splits define [s_i, s_{i+1}) buckets, last bucket
    closed; values outside raise unless handleInvalid=keep (extra bucket)."""

    def __init__(self, uid=None, **kw):
        super().__init__(uid)
        self._p_in_out(out_default="bucketed")
        self.splits = self._param("splits", "bucket split points (ascending)",
                                  V.array_length_gt(2))
        self.handleInvalid = self._param(
            "handleInvalid", "error|keep|skip for out-of-range",
            V.in_array(["error", "keep", "skip"]), default="error")
        for k, v in kw.items():
            self.set(k, v)

    def _transform(self, frame):
        splits = np.asarray(self.get("splits"), dtype=np.float64)
        x = np.asarray(frame[self.get("inputCol")], dtype=np.float64)
        idx = np.searchsorted(splits, x, side="right") - 1
        idx = np.where(x == splits[-1], len(splits) - 2, idx)  # closed last
        invalid = (x < splits[0]) | (x > splits[-1]) | np.isnan(x)
        mode = self.get("handleInvalid")
        if mode == "error":
            if invalid.any():
                raise ValueError("values outside bucketizer splits; set "
                                 "handleInvalid to keep or skip")
        elif mode == "keep":
            idx = np.where(invalid, len(splits) - 1, idx)
        out = frame.with_column(self.get("outputCol"), idx.astype(np.float64))
        if mode == "skip":
            out = out.filter_rows(~invalid)
        return out


class ElementwiseProduct(Transformer, _InOutCol, MLWritable, MLReadable):
    """Hadamard product with a fixed vector (ref ElementwiseProduct.scala)."""

    def __init__(self, uid=None, scaling_vec=None, **kw):
        super().__init__(uid)
        self._p_in_out(out_default="product")
        self.scalingVec = self._param("scalingVec", "the multiplier vector")
        if scaling_vec is not None:
            self.set("scalingVec", list(np.asarray(scaling_vec, dtype=np.float64)))
        for k, v in kw.items():
            self.set(k, v)

    def _transform(self, frame):
        v = np.asarray(self.get("scalingVec"), dtype=np.float64)
        return frame.with_column(self.get("outputCol"),
                                 self._in(frame) * v[None, :])


class PolynomialExpansion(Transformer, _InOutCol, MLWritable, MLReadable):
    """Degree-d polynomial feature expansion (ref PolynomialExpansion.scala:
    same term set — all monomials of total degree 1..d, no bias term)."""

    def __init__(self, uid=None, **kw):
        super().__init__(uid)
        self._p_in_out(out_default="poly")
        self.degree = self._param("degree", "polynomial degree (> 0)", V.gt(0),
                                  default=2)
        for k, v in kw.items():
            self.set(k, v)

    def _transform(self, frame):
        x = self._in(frame).astype(np.float64)
        d = x.shape[1]
        deg = self.get("degree")
        cols = []
        for total in range(1, deg + 1):
            for combo in combinations_with_replacement(range(d), total):
                term = np.ones(x.shape[0])
                for j in combo:
                    term = term * x[:, j]
                cols.append(term)
        return frame.with_column(self.get("outputCol"), np.stack(cols, axis=1))


class DCT(Transformer, _InOutCol, MLWritable, MLReadable):
    """DCT-II per row (ref DCT.scala, which wraps the same scaled transform)."""

    def __init__(self, uid=None, **kw):
        super().__init__(uid)
        self._p_in_out(out_default="dct")
        self.inverse = self._param("inverse", "apply inverse DCT", default=False)
        for k, v in kw.items():
            self.set(k, v)

    def _transform(self, frame):
        from scipy.fft import dct, idct
        x = self._in(frame).astype(np.float64)
        fn = idct if self.get("inverse") else dct
        return frame.with_column(self.get("outputCol"),
                                 fn(x, type=2, norm="ortho", axis=1))


class VectorAssembler(Transformer, MLWritable, MLReadable):
    """Concatenate columns into one vector column (ref VectorAssembler.scala)."""

    def __init__(self, uid=None, input_cols: Optional[List[str]] = None,
                 output_col: str = "features", **kw):
        super().__init__(uid)
        self.inputCols = self._param("inputCols", "columns to assemble")
        self.outputCol = self._param("outputCol", "output column",
                                     default="features")
        if input_cols is not None:
            self.set("inputCols", list(input_cols))
        if output_col != "features":
            self.set("outputCol", output_col)
        for k, v in kw.items():
            self.set(k, v)

    def _transform(self, frame):
        parts = []
        for c in self.get("inputCols"):
            col = frame[c]
            parts.append(col[:, None] if col.ndim == 1 else col)
        return frame.with_column(self.get("outputCol"),
                                 np.hstack(parts).astype(np.float64))


class VectorSlicer(Transformer, _InOutCol, MLWritable, MLReadable):
    """Select sub-vector by indices (ref VectorSlicer.scala)."""

    def __init__(self, uid=None, **kw):
        super().__init__(uid)
        self._p_in_out(out_default="sliced")
        self.indices = self._param("indices", "indices to keep")
        for k, v in kw.items():
            self.set(k, v)

    def _transform(self, frame):
        idx = np.asarray(self.get("indices"), dtype=np.int64)
        return frame.with_column(self.get("outputCol"), self._in(frame)[:, idx])


class VectorSizeHint(Transformer, _InOutCol, MLWritable, MLReadable):
    """Validate/declare vector size (ref VectorSizeHint.scala)."""

    def __init__(self, uid=None, **kw):
        super().__init__(uid)
        self._p_in_out()
        self.size = self._param("size", "expected vector size (> 0)", V.gt(0))
        self.handleInvalid = self._param(
            "handleInvalid", "error|skip", V.in_array(["error", "skip"]),
            default="error")
        for k, v in kw.items():
            self.set(k, v)

    def _transform(self, frame):
        x = self._in(frame)
        if x.shape[1] != self.get("size"):
            if self.get("handleInvalid") == "error":
                raise ValueError(
                    f"column {self.get('inputCol')!r} has size {x.shape[1]}, "
                    f"expected {self.get('size')}")
            return frame.filter_rows(np.zeros(frame.n_rows, dtype=bool))
        return frame


class Interaction(Transformer, MLWritable, MLReadable):
    """Pairwise products across columns (ref Interaction.scala: the output is
    the flattened outer product of the input vectors)."""

    def __init__(self, uid=None, input_cols: Optional[List[str]] = None, **kw):
        super().__init__(uid)
        self.inputCols = self._param("inputCols", "columns to interact")
        self.outputCol = self._param("outputCol", "output column",
                                     default="interacted")
        if input_cols is not None:
            self.set("inputCols", list(input_cols))
        for k, v in kw.items():
            self.set(k, v)

    def _transform(self, frame):
        cols = []
        for c in self.get("inputCols"):
            col = frame[c]
            cols.append(col[:, None] if col.ndim == 1 else col)
        out = cols[0]
        for c in cols[1:]:
            out = (out[:, :, None] * c[:, None, :]).reshape(out.shape[0], -1)
        return frame.with_column(self.get("outputCol"), out)


class QuantileDiscretizer(Estimator, _InOutCol, MLWritable, MLReadable):
    """Fit bucket splits at quantiles, producing a Bucketizer
    (ref QuantileDiscretizer.scala)."""

    def __init__(self, uid=None, **kw):
        super().__init__(uid)
        self._p_in_out(out_default="bucketed")
        self.numBuckets = self._param("numBuckets", "number of buckets (> 1)",
                                      V.gt(1), default=2)
        self.handleInvalid = self._param(
            "handleInvalid", "error|keep|skip", V.in_array(["error", "keep", "skip"]),
            default="error")
        for k, v in kw.items():
            self.set(k, v)

    def _fit(self, frame) -> Bucketizer:
        x = np.asarray(frame[self.get("inputCol")], dtype=np.float64)
        qs = np.linspace(0, 1, self.get("numBuckets") + 1)
        splits = np.unique(np.quantile(x, qs))
        splits[0], splits[-1] = -np.inf, np.inf
        if len(splits) < 3:
            splits = np.array([-np.inf, np.median(x), np.inf])
        b = Bucketizer(uid=self.uid)
        b.set("splits", splits.tolist())
        b.set("inputCol", self.get("inputCol"))
        b.set("outputCol", self.get("outputCol"))
        b.set("handleInvalid", self.get("handleInvalid"))
        return b


class Imputer(Estimator, MLWritable, MLReadable):
    """Fill missing values with mean/median/mode (ref Imputer.scala)."""

    def __init__(self, uid=None, input_cols=None, output_cols=None, **kw):
        super().__init__(uid)
        self.inputCols = self._param("inputCols", "columns to impute")
        self.outputCols = self._param("outputCols", "imputed output columns")
        self.strategy = self._param("strategy", "mean|median|mode",
                                    V.in_array(["mean", "median", "mode"]),
                                    default="mean")
        self.missingValue = self._param("missingValue",
                                        "placeholder for missing (besides NaN)",
                                        default=float("nan"))
        if input_cols is not None:
            self.set("inputCols", list(input_cols))
        if output_cols is not None:
            self.set("outputCols", list(output_cols))
        for k, v in kw.items():
            self.set(k, v)

    def _fit(self, frame) -> "ImputerModel":
        strat = self.get("strategy")
        mv = self.get("missingValue")
        fills = []
        for c in self.get("inputCols"):
            col = np.asarray(frame[c], dtype=np.float64)
            mask = ~(np.isnan(col) | (col == mv))
            vals = col[mask]
            if len(vals) == 0:
                raise ValueError(f"all values missing in column {c!r}")
            if strat == "mean":
                fills.append(float(vals.mean()))
            elif strat == "median":
                fills.append(float(np.median(vals)))
            else:
                uniq, cnt = np.unique(vals, return_counts=True)
                fills.append(float(uniq[np.argmax(cnt)]))
        m = ImputerModel(np.asarray(fills), uid=self.uid)
        self._copy_values(m)
        return m._set_parent(self)


class ImputerModel(Model, MLWritable, MLReadable):
    def __init__(self, fill_values=None, uid=None):
        super().__init__(uid)
        self.inputCols = self._param("inputCols", "columns to impute")
        self.outputCols = self._param("outputCols", "imputed output columns")
        self.strategy = self._param("strategy", "mean|median|mode",
                                    default="mean")
        self.missingValue = self._param("missingValue", "missing placeholder",
                                        default=float("nan"))
        self.fill_values = np.asarray(fill_values) if fill_values is not None else None

    def _transform(self, frame):
        out = frame
        mv = self.get("missingValue")
        for c_in, c_out, fill in zip(self.get("inputCols"),
                                     self.get("outputCols"), self.fill_values):
            col = np.asarray(frame[c_in], dtype=np.float64).copy()
            mask = np.isnan(col) | (col == mv)
            col[mask] = fill
            out = out.with_column(c_out, col)
        return out

    def _save_data(self, path):
        save_arrays(path, fills=self.fill_values)

    def _load_data(self, path, meta):
        self.fill_values = load_arrays(path)["fills"]
