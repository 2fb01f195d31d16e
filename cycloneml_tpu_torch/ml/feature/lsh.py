"""Locality-sensitive hashing — the port's counterpart of
``cycloneml_tpu/ml/feature/lsh.py``, host numpy as there; the random
vectors and MinHash coefficients come from ``np.random.RandomState(seed)``,
so one seed gives both packages the same hash functions.

Parity with ref ml/feature/LSH.scala, MinHashLSH.scala,
BucketedRandomProjectionLSH.scala: hash tables, approxNearestNeighbors and
approxSimilarityJoin. Hash evaluation is one vectorized pass (matmul for the
random-projection family — MXU-friendly by construction).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from cycloneml_tpu_torch.dataset.frame import MLFrame
from cycloneml_tpu_torch.ml.base import Estimator, Model
from cycloneml_tpu_torch.ml.feature.scalers import _InOutCol
from cycloneml_tpu_torch.ml.param import ParamValidators as V
from cycloneml_tpu_torch.ml.shared import HasSeed
from cycloneml_tpu_torch.ml.util_io import MLReadable, MLWritable, load_arrays, save_arrays

MINHASH_PRIME = 2038074743  # the reference's prime (MinHashLSH.scala)


class _LSHParams(_InOutCol, HasSeed):
    def _p_lsh(self):
        self._p_in_out(out_default="hashes")
        self._p_seed(17)
        self.numHashTables = self._param("numHashTables", "hash tables (> 0)",
                                         V.gt(0), default=1)


class _LSHModelBase(Model, _LSHParams, MLWritable, MLReadable):
    def _hash_batch(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _key_distance(self, a: np.ndarray, b: np.ndarray) -> float:
        raise NotImplementedError

    def _transform(self, frame):
        return frame.with_column(self.get("outputCol"),
                                 self._hash_batch(self._in(frame)))

    def approx_nearest_neighbors(self, frame: MLFrame, key: np.ndarray,
                                 num_nearest: int,
                                 dist_col: str = "distCol") -> MLFrame:
        x = self._in(frame)
        hx = self._hash_batch(x)
        hk = self._hash_batch(np.asarray(key, dtype=np.float64)[None, :])[0]
        # candidate filter: any matching hash table, then exact re-rank
        cand = (hx == hk[None, :]).any(axis=1)
        if cand.sum() < num_nearest:
            cand = np.ones(len(x), dtype=bool)
        cand_idx = np.nonzero(cand)[0]
        # exact re-rank over the candidate set only — that's the LSH payoff
        cand_d = np.array([self._key_distance(x[i], key) for i in cand_idx])
        top = np.argsort(cand_d)[:num_nearest]
        keep = np.sort(cand_idx[top])
        dists = np.full(len(x), np.inf)
        dists[cand_idx] = cand_d
        mask = np.isin(np.arange(len(x)), keep)
        return frame.filter_rows(mask).with_column(dist_col, dists[keep])

    def approx_similarity_join(self, a: MLFrame, b: MLFrame, threshold: float,
                               dist_col: str = "distCol"):
        xa, xb = self._in(a), self._in(b)
        ha, hb = self._hash_batch(xa), self._hash_batch(xb)
        pairs = []
        for i in range(len(xa)):
            match = (hb == ha[i][None, :]).any(axis=1)
            for j in np.nonzero(match)[0]:
                d = self._key_distance(xa[i], xb[j])
                if d < threshold:
                    pairs.append((i, j, d))
        ctx = a.ctx
        if not pairs:
            return MLFrame(ctx, {"idA": np.array([], dtype=int),
                                 "idB": np.array([], dtype=int),
                                 dist_col: np.array([])})
        arr = np.array(pairs)
        return MLFrame(ctx, {"idA": arr[:, 0].astype(int),
                             "idB": arr[:, 1].astype(int),
                             dist_col: arr[:, 2]})


class BucketedRandomProjectionLSH(Estimator, _LSHParams, MLWritable, MLReadable):
    """Euclidean LSH: floor(x·v / bucketLength) (ref
    BucketedRandomProjectionLSH.scala)."""

    def __init__(self, uid=None, **kw):
        super().__init__(uid)
        self._p_lsh()
        self.bucketLength = self._param("bucketLength", "bucket width (> 0)",
                                        V.gt(0.0))
        for k, v in kw.items():
            self.set(k, v)

    def _fit(self, frame) -> "BucketedRandomProjectionLSHModel":
        d = self._in(frame).shape[1]
        rng = np.random.RandomState(self.get("seed"))
        dirs = rng.randn(self.get("numHashTables"), d)
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        m = BucketedRandomProjectionLSHModel(dirs, uid=self.uid)
        self._copy_values(m)
        return m._set_parent(self)


class BucketedRandomProjectionLSHModel(_LSHModelBase):
    def __init__(self, directions: Optional[np.ndarray] = None, uid=None):
        super().__init__(uid)
        self._p_lsh()
        self.bucketLength = self._param("bucketLength", "bucket width",
                                        default=1.0)
        self.directions = np.asarray(directions) if directions is not None else None

    def _hash_batch(self, x):
        proj = x @ self.directions.T / self.get("bucketLength")
        return np.floor(proj)

    def _key_distance(self, a, b):
        return float(np.linalg.norm(a - b))

    def _save_data(self, path):
        save_arrays(path, dirs=self.directions)

    def _load_data(self, path, meta):
        self.directions = load_arrays(path)["dirs"]


class MinHashLSH(Estimator, _LSHParams, MLWritable, MLReadable):
    """Jaccard LSH over binary vectors (ref MinHashLSH.scala): h(x) =
    min over nonzero indices of ((a·i + b) mod prime) per table."""

    def __init__(self, uid=None, **kw):
        super().__init__(uid)
        self._p_lsh()
        for k, v in kw.items():
            self.set(k, v)

    def _fit(self, frame) -> "MinHashLSHModel":
        rng = np.random.RandomState(self.get("seed"))
        nt = self.get("numHashTables")
        coeff_a = rng.randint(1, MINHASH_PRIME, nt)
        coeff_b = rng.randint(0, MINHASH_PRIME, nt)
        m = MinHashLSHModel(coeff_a, coeff_b, uid=self.uid)
        self._copy_values(m)
        return m._set_parent(self)


class MinHashLSHModel(_LSHModelBase):
    def __init__(self, coeff_a=None, coeff_b=None, uid=None):
        super().__init__(uid)
        self._p_lsh()
        self.coeff_a = np.asarray(coeff_a) if coeff_a is not None else None
        self.coeff_b = np.asarray(coeff_b) if coeff_b is not None else None

    def _hash_batch(self, x):
        out = np.empty((x.shape[0], len(self.coeff_a)))
        for i in range(x.shape[0]):
            nz = np.nonzero(x[i])[0]
            if len(nz) == 0:
                raise ValueError("MinHash requires at least one nonzero entry")
            vals = ((np.add.outer(self.coeff_b, (nz + 1) * 0) +
                     np.outer(self.coeff_a, nz + 1)) % MINHASH_PRIME)
            out[i] = vals.min(axis=1)
        return out

    def _key_distance(self, a, b):
        sa, sb = set(np.nonzero(a)[0]), set(np.nonzero(b)[0])
        union = len(sa | sb)
        return 1.0 - (len(sa & sb) / union if union else 0.0)

    def _save_data(self, path):
        save_arrays(path, a=self.coeff_a, b=self.coeff_b)

    def _load_data(self, path, meta):
        arrs = load_arrays(path)
        self.coeff_a, self.coeff_b = arrs["a"], arrs["b"]
