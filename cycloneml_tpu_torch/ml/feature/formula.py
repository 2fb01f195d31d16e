"""RFormula — the port's counterpart of ``cycloneml_tpu/ml/feature/formula.py``.

RFormula (ref: ml/feature/RFormula.scala + RFormulaParser.scala): an R-style
model formula ``label ~ term + term`` compiled into a feature-assembly
pipeline. Supported grammar (the subset the reference's own docs
illustrate): ``y ~ a + b``, ``y ~ .`` (all non-label columns), ``a:b``
interaction terms, ``y ~ . - c`` exclusion. String columns one-hot encode
with the last category dropped (R's dummy coding, exactly the reference's
behavior); the label string-indexes when categorical.

SQLTransformer (ref: ml/feature/SQLTransformer.scala) runs its statement
through the reference's SQL engine, which the port does not have yet: it
raises, naming ROADMAP Queue 1 item 12 (the host-side layers, ``sql/``),
when one is built and when a saved one is loaded.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from cycloneml_tpu_torch.dataset.frame import MLFrame
from cycloneml_tpu_torch.ml.base import Estimator, Model, Transformer
from cycloneml_tpu_torch.ml.util_io import MLReadable, MLWritable


def _is_string_col(arr: np.ndarray) -> bool:
    return arr.dtype == object or arr.dtype.kind in "US"


def _parse_formula(formula: str) -> Tuple[str, List[str], List[str]]:
    """Returns (label, include_terms, exclude_terms); '.' may appear in
    include_terms; interactions are 'a:b' strings."""
    if "~" not in formula:
        raise ValueError(f"formula needs '~': {formula!r}")
    lhs, rhs = formula.split("~", 1)
    label = lhs.strip()
    include: List[str] = []
    exclude: List[str] = []
    # strict scanner: term, then (+|- term)* — anything else (R operators
    # like '*', '^', '(', or two terms with no operator) must be REJECTED:
    # R's a*b means a + b + a:b, and silently reinterpreting would train on
    # the wrong design matrix
    term_re = r"[\w.]+(?::[\w.]+)*"
    pos = 0
    first = True
    while pos < len(rhs):
        pat = (rf"\s*(?:([+-])\s*)?({term_re})" if first
               else rf"\s*([+-])\s*({term_re})")
        m = re.match(pat, rhs[pos:])
        if m is None:
            break
        sign, term = m.group(1) or "+", m.group(2)
        (exclude if sign == "-" else include).append(term)
        pos += m.end()
        first = False
    residue = rhs[pos:].strip()
    if residue:
        raise ValueError(
            f"unsupported formula syntax at {residue!r} in {formula!r} "
            "(supported: terms joined by '+' or '-', interactions 'a:b', "
            "and '.')")
    if not include:
        raise ValueError(f"formula has no terms: {formula!r}")
    return label, include, exclude


class RFormula(Estimator, MLWritable, MLReadable):
    """(ref RFormula.scala) — fit() resolves '.', indexes string columns,
    and returns an RFormulaModel producing featuresCol (+ labelCol)."""

    def __init__(self, uid=None, **kw):
        super().__init__(uid)
        self.formula = self._param("formula", "R model formula", default="")
        self.featuresCol = self._param("featuresCol", "output features",
                                       default="features")
        self.labelCol = self._param("labelCol", "output label",
                                    default="label")
        for k, v in kw.items():
            self.set(k, v)

    def _fit(self, frame: MLFrame) -> "RFormulaModel":
        label, include, exclude = _parse_formula(self.get("formula"))
        cols = [c for c in frame.columns if c != label]
        terms: List[str] = []
        for t in include:
            if t == ".":
                terms.extend(c for c in cols if c not in terms)
            elif t not in terms:
                terms.append(t)
        terms = [t for t in terms if t not in exclude]

        # category dictionaries for string columns (ref: StringIndexer order
        # = descending frequency, ties lexicographic)
        categories: Dict[str, List] = {}
        for t in terms:
            for c in t.split(":"):
                if c in frame.columns and _is_string_col(frame[c]) \
                        and c not in categories:
                    categories[c] = _freq_order(frame[c])
        label_categories: Optional[List] = None
        if label in frame.columns and _is_string_col(frame[label]):
            label_categories = _freq_order(frame[label])

        m = RFormulaModel(terms=terms, label=label, categories=categories,
                          label_categories=label_categories, uid=self.uid)
        self._copy_values(m)
        return m._set_parent(self)


def _freq_order(arr: np.ndarray) -> List[str]:
    # categories are ALWAYS str labels (same rule pre/post persistence),
    # ordered by StringIndexer's shared frequencyDesc logic
    from cycloneml_tpu_torch.ml.feature.indexers import ordered_labels
    return ordered_labels([str(v) for v in arr])


class RFormulaModel(Model, MLWritable, MLReadable):
    def __init__(self, terms: Optional[List[str]] = None, label: str = "",
                 categories: Optional[Dict[str, List]] = None,
                 label_categories: Optional[List] = None, uid=None):
        super().__init__(uid)
        self.formula = self._param("formula", "R model formula", default="")
        self.featuresCol = self._param("featuresCol", "output features",
                                       default="features")
        self.labelCol = self._param("labelCol", "output label",
                                    default="label")
        self.terms = terms or []
        self.label = label
        self.categories = categories or {}
        self.label_categories = label_categories

    @staticmethod
    def _code(lookup: Dict[str, int], v, col: str) -> int:
        try:
            return lookup[str(v)]
        except KeyError:
            raise ValueError(
                f"column {col!r} has category {v!r} unseen at fit time "
                "(ref RFormula handleInvalid='error')") from None

    def _encode_col(self, frame: MLFrame, c: str) -> np.ndarray:
        arr = frame[c]
        if c in self.categories:
            cats = self.categories[c]
            lookup = {v: i for i, v in enumerate(cats)}
            codes = np.array([self._code(lookup, v, c) for v in arr])
            # dummy coding: k-1 columns, last category dropped (ref/R)
            out = np.zeros((len(arr), max(len(cats) - 1, 1)))
            mask = codes < len(cats) - 1
            out[np.arange(len(arr))[mask], codes[mask]] = 1.0
            return out if len(cats) > 1 else out[:, :0]
        a = np.asarray(arr, dtype=np.float64)
        return a[:, None] if a.ndim == 1 else a

    def _transform(self, frame: MLFrame) -> MLFrame:
        parts = []
        for t in self.terms:
            factors = [self._encode_col(frame, c) for c in t.split(":")]
            block = factors[0]
            for f in factors[1:]:  # interaction = pairwise products
                block = (block[:, :, None] * f[:, None, :]).reshape(
                    len(f), -1)
            parts.append(block)
        feats = (np.concatenate(parts, axis=1) if parts
                 else np.zeros((frame.n_rows, 0)))
        out = frame.with_column(self.get("featuresCol"), feats)
        if self.label in frame.columns:
            y = frame[self.label]
            if self.label_categories is not None:
                lookup = {v: i for i, v in enumerate(self.label_categories)}
                y = np.array([float(self._code(lookup, v, self.label))
                              for v in y])
            else:
                y = np.asarray(y, dtype=np.float64)
            out = out.with_column(self.get("labelCol"), y)
        return out

    def _save_data(self, path):
        import json
        import os
        with open(os.path.join(path, "formula.json"), "w") as fh:
            # categories are already str labels (see _freq_order), so JSON
            # round-trips them without changing lookup behavior
            json.dump({"terms": self.terms, "label": self.label,
                       "categories": self.categories,
                       "label_categories": self.label_categories}, fh)

    def _load_data(self, path, meta):
        import json
        import os
        with open(os.path.join(path, "formula.json")) as fh:
            d = json.load(fh)
        self.terms = d["terms"]
        self.label = d["label"]
        self.categories = d["categories"]
        self.label_categories = d["label_categories"]


SQL_TRANSFORMER_ITEM = 12  # ROADMAP Queue 1 item: the host-side layers


class SQLTransformer(Transformer, MLWritable, MLReadable):
    """(ref SQLTransformer.scala) — ``SELECT ... FROM __THIS__`` over the
    frame through the SQL engine, which is ROADMAP Queue 1 item 12's: it
    raises ``NotImplementedError`` when built, and so when a saved one is
    loaded (the load builds it)."""

    def __init__(self, uid=None, **kw):
        raise NotImplementedError(
            "SQLTransformer runs its statement through the SQL engine, which "
            "has no port yet: ROADMAP Queue 1 item "
            f"{SQL_TRANSFORMER_ITEM}")
