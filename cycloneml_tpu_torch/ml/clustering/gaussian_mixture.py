"""Gaussian mixture model via EM.

The port's counterpart of ``cycloneml_tpu/ml/clustering/gaussian_mixture.py``
(ref: ml/clustering/GaussianMixture.scala, mllib/clustering/
GaussianMixture.scala:43 — per-partition responsibility-weighted sufficient
statistics merged by a treeAggregate, the host's M-step):

- E-step on the device, a chunk of rows at a time (the (rows, k, d)
  intermediate is 16 GB in float32 at 2M x 16 x 128): every component's
  log-density by one batched ``torch.linalg.solve_triangular`` against the
  stacked Cholesky factors, ``logsumexp``, the responsibilities, their sums,
  the weighted mean sums and the scatter sum_i r_ik x_i x_i^T as k products
  (one batched ``torch.matmul``). Each chunk's partials are added into
  float64 sums in chunk order, so two fits of the same rows are bitwise
  equal;
- the M-step, the log-likelihood test against ``tol`` and the sampled
  initialization (the reference's ``RandomState(seed)`` draws) on the
  host in float64, as the reference.

No hand-written kernel: the reference's E-step is jnp (no Pallas call), and
its products stay ``torch`` products here (TF32 off: the reference's
``Precision.HIGHEST``).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
from cycloneml_tpu_torch.ml.base import Estimator, Model
from cycloneml_tpu_torch.ml.param import ParamValidators as V
from cycloneml_tpu_torch.ml.shared import (
    HasFeaturesCol, HasMaxIter, HasPredictionCol, HasProbabilityCol, HasSeed,
    HasTol, HasWeightCol,
)
from cycloneml_tpu_torch.ml.util_io import MLReadable, MLWritable, load_arrays, save_arrays

_MIN_COV_EIG = 1e-6  # diagonal jitter keeping Cholesky factorizable
ROW_CHUNK = 1 << 15  # rows of one E-step chunk: (rows, k, d) intermediates


class MultivariateGaussian(NamedTuple):
    """Parity with ref stat/distribution/MultivariateGaussian.scala."""
    mean: np.ndarray
    cov: np.ndarray


class _GMMParams(HasFeaturesCol, HasPredictionCol, HasProbabilityCol,
                 HasMaxIter, HasSeed, HasTol, HasWeightCol):
    def _declare_gmm_params(self):
        self._p_features_col()
        self._p_prediction_col()
        self._p_probability_col()
        self._p_max_iter(100)
        self._p_seed(17)
        self._p_tol(0.01)
        self._p_weight_col()
        self.k = self._param("k", "number of mixture components (> 1)",
                             V.gt(1), default=2)


def e_step(x: torch.Tensor, w: torch.Tensor, wts: torch.Tensor,
           mus: torch.Tensor, chols: torch.Tensor,
           chunk_rows: int = ROW_CHUNK) -> dict:
    """The E-step's sums over rows ``x`` (n, d) with weights ``w``, for
    components of weights ``wts`` (k,), means ``mus`` (k, d) and Cholesky
    factors ``chols`` (k, d, d), all at the accumulator width: the summed
    weighted log-likelihood, the responsibility sums (k,), the weighted mean
    sums (k, d) and scatter sums (k, d, d), each chunk of ``chunk_rows``
    rows computed at w's width and added in float64 in chunk order."""
    k, d = mus.shape
    dt, dev = w.dtype, w.device
    f64 = torch.float64
    logdet = torch.sum(torch.log(torch.diagonal(chols, dim1=1, dim2=2)), 1)
    logw = torch.log(torch.clamp(wts, min=1e-300))
    const = d * math.log(2.0 * math.pi)
    ll = torch.zeros((), dtype=f64, device=dev)
    rs = torch.zeros(k, dtype=f64, device=dev)
    ms = torch.zeros((k, d), dtype=f64, device=dev)
    sc = torch.zeros((k, d, d), dtype=f64, device=dev)
    for lo in range(0, x.shape[0], chunk_rows):
        xc = x[lo:lo + chunk_rows].to(dt)
        wc = w[lo:lo + chunk_rows]
        # z_j = L_j^{-1} (x - mu_j) for every component at once
        diff = (xc[None, :, :] - mus[:, None, :]).transpose(1, 2)  # (k, d, b)
        z = torch.linalg.solve_triangular(chols, diff, upper=False)
        del diff
        maha = torch.sum(z * z, dim=1).T                            # (b, k)
        del z
        joint = -0.5 * (maha + const) - logdet[None, :] + logw[None, :]
        lse = torch.logsumexp(joint, dim=1)                         # (b,)
        resp = torch.exp(joint - lse[:, None]) * wc[:, None]        # (b, k)
        # padding rows (w=0) contribute nothing
        ll += torch.sum(torch.where(wc > 0, lse * wc,
                                    torch.zeros_like(lse))).to(f64)
        rs += torch.sum(resp, dim=0).to(f64)
        ms += (resp.T @ xc).to(f64)
        # sum_i r_ij x_i x_i^T: one product per component
        sc += torch.matmul(xc.T[None, :, :] * resp.T[:, None, :], xc).to(f64)
    return {"loglik": ll, "resp_sum": rs, "mean_sum": ms, "scatter": sc}


class GaussianMixture(Estimator, _GMMParams, MLWritable, MLReadable):
    def __init__(self, uid=None, **kwargs):
        super().__init__(uid)
        self._declare_gmm_params()
        for key, v in kwargs.items():
            self.set(key, v)

    def set_k(self, v):
        return self.set("k", v)

    def set_max_iter(self, v):
        return self.set("maxIter", v)

    def set_seed(self, v):
        return self.set("seed", v)

    def set_tol(self, v):
        return self.set("tol", v)

    def _fit(self, frame) -> "GaussianMixtureModel":
        ds = frame.to_instance_dataset(
            self.get("featuresCol"), label_col=None,
            weight_col=self.get("weightCol") or None)
        return self._fit_dataset(ds)

    def _fit_dataset(self, ds: InstanceDataset) -> "GaussianMixtureModel":
        k, d = self.get("k"), ds.n_features
        dtype = ds.w.dtype  # accumulator tier: X may store bf16
        dev = ds.x.device

        weights, means, covs = self._init_params(ds, k)

        def em_stats(x, y, w, wts, mus, chols):
            return e_step(x, w, wts, mus, chols)

        step = ds.tree_aggregate_fn(em_stats)
        prev_ll = -np.inf
        ll = -np.inf
        it = 0
        for it in range(1, self.get("maxIter") + 1):
            chols = np.linalg.cholesky(covs + _MIN_COV_EIG * np.eye(d))
            out = step(*(torch.as_tensor(a, device=dev).to(dtype)
                         for a in (weights, means, chols)))
            # one transfer for the whole EM stat tree
            flat = torch.cat([out["loglik"].reshape(1), out["resp_sum"],
                              out["mean_sum"].reshape(-1),
                              out["scatter"].reshape(-1)]).cpu().numpy()
            ll = float(flat[0])
            rs = flat[1:1 + k]
            ms = flat[1 + k:1 + k + k * d].reshape(k, d)
            sc = flat[1 + k + k * d:].reshape(k, d, d)
            total = rs.sum()
            weights = rs / max(total, 1e-300)
            means = ms / np.maximum(rs[:, None], 1e-300)
            covs = (sc / np.maximum(rs[:, None, None], 1e-300)
                    - means[:, :, None] * means[:, None, :])
            covs = 0.5 * (covs + np.transpose(covs, (0, 2, 1)))
            if abs(ll - prev_ll) < self.get("tol") and it > 1:
                prev_ll = ll
                break
            prev_ll = ll

        model = GaussianMixtureModel(weights, means, covs, uid=self.uid)
        self._copy_values(model)
        model._set_parent(self)
        model.num_iterations = it
        model.log_likelihood = ll
        return model

    def _init_params(self, ds: InstanceDataset, k: int):
        """Reference init (mllib GaussianMixture.initialize): sample rows,
        split into k slices, empirical mean/cov per slice. Only the sampled
        rows leave the device; the global variance fallback comes from a
        one-pass moment aggregation."""
        rng = np.random.RandomState(self.get("seed"))
        n, d = ds.n_rows, ds.n_features
        n_sample = min(n, max(2 * k, 100))
        idx = np.sort(rng.choice(n, size=n_sample, replace=False))
        # padding lives past row n_rows, so real-row gathers are safe
        sample = np.array(ds.gather_rows(idx), dtype=np.float64)
        rng.shuffle(sample)
        slices = np.array_split(sample, k)

        if all(len(s) > 1 for s in slices):
            # normal case (n_sample >= 2k): no global pass needed
            mean_all = var0 = None
        else:
            # degenerate slices fall back to global moments (one pass)
            def moments(x, y, w):
                real = (w > 0).to(w.dtype)
                s1 = torch.zeros(d, dtype=w.dtype, device=w.device)
                s2 = torch.zeros_like(s1)
                for lo in range(0, x.shape[0], ROW_CHUNK):
                    xc = x[lo:lo + ROW_CHUNK].to(w.dtype)
                    rc = real[lo:lo + ROW_CHUNK, None]
                    s1 = s1 + torch.sum(xc * rc, dim=0)
                    s2 = s2 + torch.sum(xc * xc * rc, dim=0)
                return {"s1": s1, "s2": s2, "n": torch.sum(real)}

            mo = ds.tree_aggregate_fn(moments)()
            cnt = max(float(mo["n"]), 1.0)
            mean_all = mo["s1"].cpu().double().numpy() / cnt
            var0 = np.maximum(mo["s2"].cpu().double().numpy() / cnt
                              - mean_all ** 2, 0.0) + _MIN_COV_EIG
        means = np.stack([s.mean(axis=0) if len(s) else mean_all
                          for s in slices])
        covs = np.stack([
            np.diag(s.var(axis=0) + _MIN_COV_EIG) if len(s) > 1 else np.diag(var0)
            for s in slices])
        weights = np.full(k, 1.0 / k)
        return weights, means, covs


class GaussianMixtureModel(Model, _GMMParams, MLWritable, MLReadable):
    def __init__(self, weights: Optional[np.ndarray] = None,
                 means: Optional[np.ndarray] = None,
                 covs: Optional[np.ndarray] = None, uid=None):
        super().__init__(uid)
        self._declare_gmm_params()
        self.weights = np.asarray(weights) if weights is not None else None
        self._means = np.asarray(means) if means is not None else None
        self._covs = np.asarray(covs) if covs is not None else None
        self.num_iterations = 0
        self.log_likelihood = float("nan")

    @property
    def gaussians(self) -> List[MultivariateGaussian]:
        return [MultivariateGaussian(m, c)
                for m, c in zip(self._means, self._covs)]

    def _log_resp(self, x: np.ndarray) -> np.ndarray:
        d = x.shape[1]
        k = len(self.weights)
        from scipy.linalg import solve_triangular

        out = np.empty((x.shape[0], k))
        for j in range(k):
            L = np.linalg.cholesky(self._covs[j] + _MIN_COV_EIG * np.eye(d))
            z = solve_triangular(L, (x - self._means[j]).T, lower=True)
            out[:, j] = (-0.5 * (np.sum(z * z, axis=0) + d * np.log(2 * np.pi))
                         - np.log(np.diag(L)).sum()
                         + np.log(max(self.weights[j], 1e-300)))
        return out

    def _probability(self, x: np.ndarray) -> np.ndarray:
        lr = self._log_resp(x)
        lse = np.logaddexp.reduce(lr, axis=1)
        return np.exp(lr - lse[:, None])

    def _transform(self, frame):
        x = np.asarray(frame[self.get("featuresCol")], dtype=np.float64)
        if x.ndim == 1:
            x = x[:, None]
        prob = self._probability(x)
        out = frame
        if self.get("probabilityCol"):
            out = out.with_column(self.get("probabilityCol"), prob)
        out = out.with_column(self.get("predictionCol"),
                              prob.argmax(1).astype(np.float64))
        return out

    def predict(self, features) -> int:
        arr = features.to_array() if hasattr(features, "to_array") \
            else np.asarray(features)
        return int(self._probability(np.atleast_2d(arr)).argmax(1)[0])

    def predict_probability(self, features) -> np.ndarray:
        arr = features.to_array() if hasattr(features, "to_array") \
            else np.asarray(features)
        return self._probability(np.atleast_2d(arr))[0]

    def _save_data(self, path: str) -> None:
        save_arrays(path, weights=self.weights, means=self._means,
                    covs=self._covs)

    def _load_data(self, path: str, meta) -> None:
        arrs = load_arrays(path)
        self.weights = arrs["weights"]
        self._means = arrs["means"]
        self._covs = arrs["covs"]
