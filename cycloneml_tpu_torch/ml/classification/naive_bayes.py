"""Naive Bayes classifier, the port of the reference's
``ml/classification/naive_bayes.py`` (ref: ml/classification/
NaiveBayes.scala — ``trainDiscreteImpl`` aggregates per-class feature sums
in one pass for multinomial/bernoulli/complement, ``trainGaussianImpl``
per-class means and variances). The per-class sums are the one-hot(y)ᵀ·X
products of the reference, as plain large ``torch.matmul``s at the
accumulator dtype over row chunks (TF32 off: the reference asks
``Precision.HIGHEST``); the host finishes with the small (k, d) smoothing
and log transforms.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
from cycloneml_tpu_torch.dataset.frame import MLFrame
from cycloneml_tpu_torch.linalg.matrices import DenseMatrix
from cycloneml_tpu_torch.ml.base import Predictor, ProbabilisticClassificationModel
from cycloneml_tpu_torch.ml.optim.aggregators import precision_scope
from cycloneml_tpu_torch.ml.param import ParamValidators as V
from cycloneml_tpu_torch.ml.util_io import MLReadable, MLWritable, load_arrays, save_arrays
from cycloneml_tpu_torch.util.logging import get_logger

logger = get_logger(__name__)

_MODEL_TYPES = ["multinomial", "bernoulli", "complement", "gaussian"]
ROW_CHUNK = 1 << 16  # rows upcast into one product at a time


def class_sums(ds: InstanceDataset, k: int, model_type: str) -> dict:
    """The reference's one pass: per-class sums of w·x (``feat``, (k, d);
    of w·1[x != 0] for bernoulli), of w·x² (``sq``, gaussian only) and of
    w (``wsum``, (k,)), at w's dtype, with the count of values the model
    type refuses (``neg``: negative ones, or bernoulli's outside {0, 1}),
    over row chunks of X upcast to w's dtype."""
    x, y, w = ds.x, ds.y, ds.w
    acc, dev = w.dtype, w.device
    d = x.shape[1]
    classes = torch.arange(k, device=dev)
    out = {"feat": torch.zeros((k, d), dtype=acc, device=dev),
           "wsum": torch.zeros(k, dtype=acc, device=dev),
           "neg": torch.zeros((), dtype=torch.int64, device=dev)}
    if model_type == "gaussian":
        out["sq"] = torch.zeros((k, d), dtype=acc, device=dev)
    with precision_scope("highest", dev):
        for lo in range(0, x.shape[0], ROW_CHUNK):
            xc = x[lo:lo + ROW_CHUNK].to(acc)
            ow = ((y[lo:lo + ROW_CHUNK, None].to(torch.int64) == classes)
                  .to(acc) * w[lo:lo + ROW_CHUNK, None])          # (m, k)
            if model_type == "bernoulli":
                out["neg"] += ((xc != 0) & (xc != 1)).sum()
                xc = (xc != 0).to(acc)
            elif model_type != "gaussian":
                out["neg"] += (xc < 0).sum()
            out["feat"] += torch.matmul(ow.T, xc)
            if model_type == "gaussian":
                out["sq"] += torch.matmul(ow.T, xc * xc)
            out["wsum"] += ow.sum(0)
    return out


class NaiveBayes(Predictor, MLWritable, MLReadable):
    def __init__(self, uid=None, **kwargs):
        super().__init__(uid)
        self._declare_nb_params()
        for k, v in kwargs.items():
            self.set(k, v)

    def _declare_nb_params(self):
        self.smoothing = self._param("smoothing", "additive smoothing (>= 0)",
                                     V.gt_eq(0.0), default=1.0)
        self.modelType = self._param(
            "modelType", "multinomial|bernoulli|complement|gaussian",
            V.in_array(_MODEL_TYPES), default="multinomial")

    def set_smoothing(self, v):
        return self.set("smoothing", v)

    def set_model_type(self, v):
        return self.set("modelType", v)

    def _fit(self, frame: MLFrame) -> "NaiveBayesModel":
        ds = frame.to_instance_dataset(
            self.get("featuresCol"), self.get("labelCol"),
            self.get("weightCol") or None)
        return self._fit_dataset(ds)

    def _fit_dataset(self, ds: InstanceDataset) -> "NaiveBayesModel":
        d = ds.n_features
        model_type = self.get("modelType")
        lam = self.get("smoothing")
        k = int(np.asarray(ds.y_host()).max()) + 1 if ds.n_rows else 2
        out = class_sums(ds, k, model_type)
        if int(out["neg"]) > 0:
            kind = ("zero-or-one" if model_type == "bernoulli"
                    else "nonnegative")
            raise ValueError(f"{model_type} NaiveBayes requires {kind} "
                             "feature values")
        feat = out["feat"].to(torch.float64).cpu().numpy()      # (k, d)
        wsum = out["wsum"].to(torch.float64).cpu().numpy()      # (k,)
        pi = np.log(wsum + lam) - np.log(wsum.sum() + k * lam)

        sigma = np.zeros((0, 0))
        if model_type == "multinomial":
            theta = (np.log(feat + lam)
                     - np.log(feat.sum(axis=1, keepdims=True) + lam * d))
        elif model_type == "complement":
            # ref trainDiscreteImpl complement branch (Rennie et al. 2003):
            # per-class stats of the COMPLEMENT, normalized, negated
            total = feat.sum(axis=0, keepdims=True)     # (1, d)
            comp = total - feat
            logc = np.log(comp + lam) - np.log(
                comp.sum(axis=1, keepdims=True) + lam * d)
            theta = -logc
        elif model_type == "bernoulli":
            theta = (np.log(feat + lam)
                     - np.log(wsum[:, None] + 2.0 * lam))
        else:  # gaussian — unbiased-ish variance with epsilon flooring
            mu = feat / np.maximum(wsum[:, None], 1e-300)
            sq = out["sq"].to(torch.float64).cpu().numpy()
            var = sq / np.maximum(wsum[:, None], 1e-300) - mu * mu
            # ref uses max-variance epsilon: 1e-9 * max var
            eps = 1e-9 * max(var.max(), 1e-300)
            sigma = np.maximum(var, eps)
            theta = mu

        model = NaiveBayesModel(pi, theta, sigma, uid=self.uid)
        self._copy_values(model)
        model._set_parent(self)
        return model


class NaiveBayesModel(ProbabilisticClassificationModel, MLWritable, MLReadable):
    def __init__(self, pi: Optional[np.ndarray] = None,
                 theta: Optional[np.ndarray] = None,
                 sigma: Optional[np.ndarray] = None, uid=None):
        super().__init__(uid)
        NaiveBayes._declare_nb_params(self)
        self._pi = np.asarray(pi) if pi is not None else None
        self._theta = np.asarray(theta) if theta is not None else None
        self._sigma = np.asarray(sigma) if sigma is not None else None

    @property
    def pi(self) -> np.ndarray:
        return self._pi

    @property
    def theta(self) -> DenseMatrix:
        return DenseMatrix.from_array(self._theta)

    @property
    def sigma(self) -> DenseMatrix:
        return DenseMatrix.from_array(self._sigma)

    @property
    def num_classes(self) -> int:
        return len(self._pi)

    @property
    def num_features(self) -> int:
        return self._theta.shape[1]

    def _raw_prediction(self, x: np.ndarray) -> np.ndarray:
        mt = self.get("modelType")
        if mt in ("multinomial", "complement"):
            raw = x @ self._theta.T
            if mt == "multinomial":
                raw = raw + self._pi[None, :]
            return raw
        if mt == "bernoulli":
            xb = (x != 0).astype(np.float64)
            neg_theta = np.log1p(-np.exp(self._theta))
            raw = (xb @ self._theta.T + (1.0 - xb) @ neg_theta.T
                   + self._pi[None, :])
            return raw
        # gaussian
        mu, var = self._theta, self._sigma
        ll = -0.5 * (((x[:, None, :] - mu[None, :, :]) ** 2 / var[None, :, :])
                     + np.log(2 * np.pi * var)[None, :, :]).sum(axis=2)
        return ll + self._pi[None, :]

    def _raw_to_probability(self, raw: np.ndarray) -> np.ndarray:
        m = raw.max(axis=1, keepdims=True)
        e = np.exp(raw - m)
        return e / e.sum(axis=1, keepdims=True)

    def _save_data(self, path: str) -> None:
        save_arrays(path, pi=self._pi, theta=self._theta,
                    sigma=self._sigma if self._sigma is not None else np.zeros((0, 0)))

    def _load_data(self, path: str, meta) -> None:
        arrs = load_arrays(path)
        self._pi = arrs["pi"]
        self._theta = arrs["theta"]
        self._sigma = arrs["sigma"]
