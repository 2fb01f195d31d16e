"""Categorical indexers & encoders — the port's counterpart of
``cycloneml_tpu/ml/feature/indexers.py``, host numpy as there.

Parity with ref ml/feature: StringIndexer.scala, IndexToString,
OneHotEncoder.scala, VectorIndexer.scala.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from cycloneml_tpu_torch.ml.base import Estimator, Model, Transformer
from cycloneml_tpu_torch.ml.feature.scalers import _InOutCol
from cycloneml_tpu_torch.ml.param import ParamValidators as V
from cycloneml_tpu_torch.ml.util_io import MLReadable, MLWritable, load_arrays, save_arrays


def ordered_labels(col, order: str = "frequencyDesc"):
    """Category ordering shared by StringIndexer and RFormula (ref:
    StringIndexer.scala stringOrderType — frequencyDesc ties break
    lexicographically)."""
    uniq, counts = np.unique(col, return_counts=True)
    if order == "frequencyDesc":
        idx = np.lexsort((uniq, -counts))
    elif order == "frequencyAsc":
        idx = np.lexsort((uniq, counts))
    elif order == "alphabetAsc":
        idx = np.argsort(uniq)
    else:
        idx = np.argsort(uniq)[::-1]
    return [str(u) for u in uniq[idx]]


class StringIndexer(Estimator, _InOutCol, MLWritable, MLReadable):
    """Map strings to indices by descending frequency (ref StringIndexer.scala;
    orderType variants supported)."""

    def __init__(self, uid=None, **kw):
        super().__init__(uid)
        self._p_in_out(in_default="category", out_default="categoryIndex")
        self.handleInvalid = self._param(
            "handleInvalid", "error|skip|keep for unseen labels",
            V.in_array(["error", "skip", "keep"]), default="error")
        self.stringOrderType = self._param(
            "stringOrderType", "label ordering",
            V.in_array(["frequencyDesc", "frequencyAsc", "alphabetDesc",
                        "alphabetAsc"]), default="frequencyDesc")
        for k, v in kw.items():
            self.set(k, v)

    def _fit(self, frame) -> "StringIndexerModel":
        col = [str(v) for v in frame[self.get("inputCol")]]
        labels = ordered_labels(col, self.get("stringOrderType"))
        m = StringIndexerModel(labels, uid=self.uid)
        self._copy_values(m)
        return m._set_parent(self)


class StringIndexerModel(Model, _InOutCol, MLWritable, MLReadable):
    def __init__(self, labels: Optional[List[str]] = None, uid=None):
        super().__init__(uid)
        self._p_in_out(in_default="category", out_default="categoryIndex")
        self.handleInvalid = self._param("handleInvalid", "error|skip|keep",
                                         default="error")
        self.labels = list(labels or [])
        self._index = {l: i for i, l in enumerate(self.labels)}

    def _transform(self, frame):
        col = frame[self.get("inputCol")]
        mode = self.get("handleInvalid")
        out = np.empty(len(col))
        invalid = np.zeros(len(col), dtype=bool)
        for i, v in enumerate(col):
            j = self._index.get(str(v))
            if j is None:
                invalid[i] = True
                out[i] = len(self.labels)  # 'keep' bucket
            else:
                out[i] = j
        if invalid.any():
            if mode == "error":
                bad = sorted({str(col[i]) for i in np.nonzero(invalid)[0]})
                raise ValueError(f"unseen labels {bad[:5]}; set handleInvalid")
            if mode == "skip":
                return frame.filter_rows(~invalid).with_column(
                    self.get("outputCol"), out[~invalid])
        return frame.with_column(self.get("outputCol"), out)

    def _save_data(self, path):
        with open(os.path.join(path, "labels.json"), "w") as fh:
            json.dump(self.labels, fh)

    def _load_data(self, path, meta):
        with open(os.path.join(path, "labels.json")) as fh:
            self.labels = json.load(fh)
        self._index = {l: i for i, l in enumerate(self.labels)}


class IndexToString(Transformer, _InOutCol, MLWritable, MLReadable):
    """Inverse of StringIndexer (ref StringIndexer.scala IndexToString)."""

    def __init__(self, uid=None, labels: Optional[List[str]] = None, **kw):
        super().__init__(uid)
        self._p_in_out(in_default="categoryIndex", out_default="category")
        self.labelsParam = self._param("labels", "index → label mapping")
        if labels is not None:
            self.set("labels", list(labels))
        for k, v in kw.items():
            self.set(k, v)

    def _transform(self, frame):
        labels = self.get("labels")
        col = np.asarray(frame[self.get("inputCol")]).astype(int)
        out = np.array([labels[i] for i in col], dtype=object)
        return frame.with_column(self.get("outputCol"), out)


class OneHotEncoder(Estimator, MLWritable, MLReadable):
    """Index → one-hot vector (ref OneHotEncoder.scala): dropLast=True by
    default, so the last category maps to the zero vector."""

    def __init__(self, uid=None, input_cols=None, output_cols=None, **kw):
        super().__init__(uid)
        self.inputCols = self._param("inputCols", "index columns")
        self.outputCols = self._param("outputCols", "encoded columns")
        self.dropLast = self._param("dropLast", "drop last category", default=True)
        self.handleInvalid = self._param(
            "handleInvalid", "error|keep", V.in_array(["error", "keep"]),
            default="error")
        if input_cols is not None:
            self.set("inputCols", list(input_cols))
        if output_cols is not None:
            self.set("outputCols", list(output_cols))
        for k, v in kw.items():
            self.set(k, v)

    def _fit(self, frame) -> "OneHotEncoderModel":
        sizes = []
        for c in self.get("inputCols"):
            col = np.asarray(frame[c]).astype(int)
            sizes.append(int(col.max()) + 1 if len(col) else 0)
        m = OneHotEncoderModel(sizes, uid=self.uid)
        self._copy_values(m)
        return m._set_parent(self)


class OneHotEncoderModel(Model, MLWritable, MLReadable):
    def __init__(self, category_sizes: Optional[List[int]] = None, uid=None):
        super().__init__(uid)
        self.inputCols = self._param("inputCols", "index columns")
        self.outputCols = self._param("outputCols", "encoded columns")
        self.dropLast = self._param("dropLast", "drop last category", default=True)
        self.handleInvalid = self._param("handleInvalid", "error|keep",
                                         default="error")
        self.category_sizes = list(category_sizes or [])

    def _transform(self, frame):
        out = frame
        drop = self.get("dropLast")
        keep = self.get("handleInvalid") == "keep"
        for c_in, c_out, size in zip(self.get("inputCols"),
                                     self.get("outputCols"),
                                     self.category_sizes):
            col = np.asarray(frame[c_in]).astype(int)
            # ref OneHotEncoderModel.configedCategorySize: with keep, an
            # extra "invalid" category at index `size`; dropLast removes it
            # (keep) or the true last category (error)
            if keep:
                width = size + 1 if not drop else size
            else:
                width = size - 1 if drop else size
            invalid = (col < 0) | (col >= size)
            if invalid.any() and not keep:
                raise ValueError(f"index out of range in {c_in!r}")
            eff = np.where(invalid, size, col)
            enc = np.zeros((len(col), max(width, 0)))
            valid = eff < width
            enc[np.nonzero(valid)[0], eff[valid]] = 1.0
            out = out.with_column(c_out, enc)
        return out

    def _save_data(self, path):
        save_arrays(path, sizes=np.asarray(self.category_sizes))

    def _load_data(self, path, meta):
        self.category_sizes = [int(s) for s in load_arrays(path)["sizes"]]


class VectorIndexer(Estimator, _InOutCol, MLWritable, MLReadable):
    """Detect categorical vector slots (≤ maxCategories distinct values) and
    re-index them to [0, k) (ref VectorIndexer.scala)."""

    def __init__(self, uid=None, **kw):
        super().__init__(uid)
        self._p_in_out(out_default="indexed")
        self.maxCategories = self._param("maxCategories",
                                         "max distinct values to treat as "
                                         "categorical (> 1)", V.gt(1), default=20)
        for k, v in kw.items():
            self.set(k, v)

    def _fit(self, frame) -> "VectorIndexerModel":
        x = self._in(frame)
        max_cat = self.get("maxCategories")
        category_maps = {}
        for j in range(x.shape[1]):
            uniq = np.unique(x[:, j])
            if len(uniq) <= max_cat:
                category_maps[j] = {float(v): i for i, v in enumerate(sorted(uniq))}
        m = VectorIndexerModel(x.shape[1], category_maps, uid=self.uid)
        self._copy_values(m)
        return m._set_parent(self)


class VectorIndexerModel(Model, _InOutCol, MLWritable, MLReadable):
    def __init__(self, num_features: int = 0, category_maps=None, uid=None):
        super().__init__(uid)
        self._p_in_out(out_default="indexed")
        self.maxCategories = self._param("maxCategories", "max categories",
                                         default=20)
        self.num_features = num_features
        self.category_maps = category_maps or {}

    @property
    def category_feature_indices(self):
        return sorted(self.category_maps)

    def _transform(self, frame):
        x = self._in(frame).astype(np.float64).copy()
        for j, mapping in self.category_maps.items():
            col = x[:, j]
            x[:, j] = np.array([mapping.get(float(v), -1.0) for v in col])
        return frame.with_column(self.get("outputCol"), x)

    def _save_data(self, path):
        payload = {str(j): {str(k): v for k, v in m.items()}
                   for j, m in self.category_maps.items()}
        with open(os.path.join(path, "maps.json"), "w") as fh:
            json.dump({"num_features": self.num_features, "maps": payload}, fh)

    def _load_data(self, path, meta):
        with open(os.path.join(path, "maps.json")) as fh:
            d = json.load(fh)
        self.num_features = d["num_features"]
        self.category_maps = {int(j): {float(k): v for k, v in m.items()}
                              for j, m in d["maps"].items()}
