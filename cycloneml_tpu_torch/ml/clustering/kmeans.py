"""K-means clustering.

The port's counterpart of ``cycloneml_tpu/ml/clustering/kmeans.py``:
Lloyd's algorithm with one device pass and one readback per step, empty
clusters keeping their center, the cosine mode (rows normalized once,
centers renormalized per step), and "random" or "k-means||" initialization
drawn from a host ``np.random.RandomState(seed)`` exactly as the reference
draws it, finished by weighted k-means++ on the candidates.

Every distance pass over X (each Lloyd step, each k-means|| step and the
candidates' attraction pass) is one nearest-center assignment: kernel K3
(``ops/kernels.kmeans_assign``) when ``use_fused_kernels`` says so — on a
CUDA X by default — else its plain version at the accumulator width. Two
mechanisms differ from the reference, not the results: "auto" takes K3 on
CUDA (the reference keeps its XLA path unless the kernel is forced), and
the k-means|| passes go through the assignment instead of an (n x
candidates) distance matrix (160 GB at 10M rows and ~4,000 candidates).

The center sums and counts of each step (and the candidates' attraction)
run in one fixed order (``ops/kernels.center_sums``: a stable sort of the
assignment, by a counting sort of its own up to ``COUNT_MAX_K`` clusters,
and per-cluster sums, no float atomics), so two fits of the same data end
with bitwise-equal centers, on the card as on the CPU.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
from cycloneml_tpu_torch.dataset.instance import compute_dtype
from cycloneml_tpu_torch.linalg.matrices import DenseMatrix
from cycloneml_tpu_torch.ml.base import Estimator, Model
from cycloneml_tpu_torch.ml.clustering._util import (normalize_rows,
                                                     pairwise_sq_dists)
from cycloneml_tpu_torch.ml.param import ParamValidators as V
from cycloneml_tpu_torch.ml.util_io import MLReadable, MLWritable, load_arrays, save_arrays
from cycloneml_tpu_torch.ml.shared import (
    HasFeaturesCol, HasMaxIter, HasPredictionCol, HasSeed, HasTol,
    HasWeightCol,
)
from cycloneml_tpu_torch.ops import kernels

# candidates x padded rows above which k-means|| weighs candidates equally
# instead of by attraction (the reference's gate, kmeans.py:219)
ATTRACT_LIMIT = 5e7


class _KMeansParams(HasFeaturesCol, HasPredictionCol, HasMaxIter, HasSeed,
                    HasTol, HasWeightCol):
    def _declare_kmeans_params(self):
        self._p_features_col()
        self._p_prediction_col()
        self._p_max_iter(20)
        self._p_seed(17)
        self._p_tol(1e-4)
        self._p_weight_col()
        self.k = self._param("k", "number of clusters (> 1)", V.gt(1),
                             default=2)
        self.initMode = self._param(
            "initMode", "initialization: random or k-means||",
            V.in_array(["random", "k-means||"]), default="k-means||")
        self.initSteps = self._param("initSteps", "k-means|| steps (> 0)",
                                     V.gt(0), default=2)
        self.distanceMeasure = self._param(
            "distanceMeasure", "euclidean or cosine",
            V.in_array(["euclidean", "cosine"]), default="euclidean")


def _assign(x: torch.Tensor, c: torch.Tensor, use_kernel: bool):
    """Nearest center and its clamped squared distance for every row: K3
    (its plain float32 version on the CPU) or the plain assignment at the
    centers' (accumulator) width."""
    if use_kernel:
        return kernels.kmeans_assign(x, c)
    return kernels.kmeans_assign_plain(x, c, acc_dtype=c.dtype)


def _center_sums(x: torch.Tensor, w: torch.Tensor, best: torch.Tensor,
                 k: int):
    """Per-cluster sums of w x ``(k, d)`` and of w ``(k,)``, at w's
    (accumulator) width, in one fixed order (``ops/kernels.center_sums``;
    its plain version on the CPU), so a fit's centers are the same on
    every run."""
    return kernels.center_sums(x, w, best, k)


class KMeans(Estimator, _KMeansParams, MLWritable, MLReadable):
    def __init__(self, uid=None, **kwargs):
        super().__init__(uid)
        self._declare_kmeans_params()
        for key, v in kwargs.items():
            self.set(key, v)

    def set_k(self, v):
        return self.set("k", v)

    def set_max_iter(self, v):
        return self.set("maxIter", v)

    def set_seed(self, v):
        return self.set("seed", v)

    def _fit(self, frame) -> "KMeansModel":
        ds = frame.to_instance_dataset(
            self.get("featuresCol"), label_col=None,
            weight_col=self.get("weightCol") or None)
        return self._fit_dataset(ds)

    def _prepare(self, ds: InstanceDataset):
        """The dataset the fit clusters (rows normalized in cosine mode)
        and whether its distance passes take K3."""
        from cycloneml_tpu_torch.ops.kernels import use_fused_kernels
        if self.get("distanceMeasure") == "cosine":
            ds = ds.derive(x=normalize_rows(ds.x))
        return ds, use_fused_kernels(ds.ctx, ds.x)

    def _fit_dataset(self, ds: InstanceDataset) -> "KMeansModel":
        ds, use_kernel = self._prepare(ds)
        centers, passes = self._init_centers(ds, self.get("k"), use_kernel)
        centers, cost, it = self._lloyd(ds, centers, use_kernel)
        model = KMeansModel(centers, training_cost=cost, uid=self.uid)
        self._copy_values(model)
        model._set_parent(self)
        model.num_iterations = it
        model.init_distance_passes = passes
        return model

    def _lloyd(self, ds: InstanceDataset, centers: np.ndarray,
               use_kernel: bool):
        """Lloyd's steps from ``centers`` (host float64) until no center
        moves by ``tol`` or ``maxIter`` steps ran; returns ``(centers,
        cost, steps)``. Each step is one assignment pass over X, the
        center sums beside it, and one readback."""
        k = self.get("k")
        cosine = self.get("distanceMeasure") == "cosine"
        # centers ride the accumulator tier even when X stores bf16
        dtype = compute_dtype(getattr(ds.ctx, "conf", None))
        dev = ds.x.device

        def step(x, y, w, c):
            best, dist = _assign(x, c, use_kernel)
            sums, counts = _center_sums(x, w, best, k)
            return {"sums": sums, "counts": counts,
                    "cost": torch.sum(w * dist.to(w.dtype))}

        run = ds.tree_aggregate_fn(step)
        tol = self.get("tol")
        cost = float("inf")
        it = 0
        for it in range(1, self.get("maxIter") + 1):
            out = run(torch.as_tensor(centers, device=dev).to(dtype))
            # one transfer per step
            flat = torch.cat([out["sums"].reshape(-1), out["counts"],
                              out["cost"].reshape(1)]).cpu().double().numpy()
            sums = flat[:k * centers.shape[1]].reshape(k, -1)
            counts = flat[k * centers.shape[1]:-1]
            cost = float(flat[-1])
            # empty clusters keep their previous center (ref behavior)
            new_centers = np.where(counts[:, None] > 0,
                                   sums / np.maximum(counts[:, None], 1e-300),
                                   centers)
            if cosine:
                norms = np.linalg.norm(new_centers, axis=1, keepdims=True)
                new_centers = new_centers / np.maximum(norms, 1e-12)
            moved = np.linalg.norm(new_centers - centers, axis=1).max()
            centers = new_centers
            if moved < tol:
                break
        return centers, cost, it

    def _init_centers(self, ds: InstanceDataset, k: int, use_kernel: bool):
        """Initial centers (host float64) and the number of distance
        passes over X the initialization made."""
        rng = np.random.RandomState(self.get("seed"))
        valid = ds.valid_indices()
        n = len(valid)
        if n <= k:
            x_host = ds.to_numpy()[0]  # tiny by construction
            reps = int(np.ceil(k / max(n, 1)))
            return np.tile(x_host, (reps, 1))[:k].astype(np.float64), 0
        if self.get("initMode") == "random":
            idx = rng.choice(valid, size=k, replace=False)
            return ds.gather_rows(idx).astype(np.float64), 0

        # k-means|| (Bahmani et al.; ref initKMeansParallel): one random
        # center, then each step samples rows with probability
        # l d2(x) / cost, l = 2k, and weighted k-means++ on the candidates
        dtype = compute_dtype(getattr(ds.ctx, "conf", None))
        dev = ds.x.device

        def min_d2(x, y, w, c):
            _, dist = _assign(x, c, use_kernel)
            return dist.to(w.dtype) * (w > 0)

        passes = 0
        centers = [ds.gather_rows([valid[rng.randint(n)]])[0]]
        l_factor = 2 * k
        for _ in range(self.get("initSteps")):
            c_arr = torch.as_tensor(np.asarray(centers), device=dev).to(dtype)
            d2 = min_d2(ds.x, ds.y, ds.w, c_arr).cpu().numpy()  # (n_pad,)
            passes += 1
            total = float(d2.sum())  # padding rows contribute 0
            if total <= 0:
                break
            probs = np.minimum(l_factor * d2 / total, 1.0)
            picked = np.nonzero(rng.rand(len(d2)) < probs)[0]
            if len(picked):
                centers.extend(ds.gather_rows(picked))
        cand = np.unique(np.asarray(centers, dtype=np.float64), axis=0)
        if cand.shape[0] <= k:
            extra = ds.gather_rows(
                rng.choice(valid, size=k - cand.shape[0], replace=False))
            return np.vstack([cand, extra.astype(np.float64)])[:k], passes
        m = cand.shape[0]
        if ds.x.shape[0] * m < ATTRACT_LIMIT:
            # weigh each candidate by the weight of the rows it attracts
            best, _ = _assign(ds.x, torch.as_tensor(cand, device=dev)
                              .to(dtype), use_kernel)
            _, attract = kernels.center_sums(ds.x, ds.w, best, m,
                                             with_sums=False)
            attract = attract.cpu().double().numpy()
            passes += 1
            attract = np.maximum(attract, 0.0) + 1e-12
        else:
            attract = np.ones(m)
        return _kmeans_pp(cand, attract, k, rng), passes


def _kmeans_pp(points: np.ndarray, weights: np.ndarray, k: int,
               rng: np.random.RandomState) -> np.ndarray:
    """Weighted k-means++ on a small candidate set (driver-side, ref
    LocalKMeans.kMeansPlusPlus)."""
    n = points.shape[0]
    first = rng.choice(n, p=weights / weights.sum())
    chosen = [first]
    d2 = ((points - points[first]) ** 2).sum(1)
    for _ in range(1, k):
        p = weights * d2
        total = p.sum()
        if total <= 0:
            remaining = [i for i in range(n) if i not in set(chosen)]
            chosen.append(rng.choice(remaining))
        else:
            nxt = rng.choice(n, p=p / total)
            chosen.append(nxt)
            d2 = np.minimum(d2, ((points - points[nxt]) ** 2).sum(1))
    return points[chosen].astype(np.float64)


class KMeansModel(Model, _KMeansParams, MLWritable, MLReadable):
    def __init__(self, centers: Optional[np.ndarray] = None,
                 training_cost: float = 0.0, uid=None):
        super().__init__(uid)
        self._declare_kmeans_params()
        self._centers = np.asarray(centers, dtype=np.float64) \
            if centers is not None else None
        self.training_cost = training_cost
        self.num_iterations = 0
        # distance passes over X the initialization made (k-means|| steps,
        # plus the candidates' attraction pass when it ran)
        self.init_distance_passes = 0

    @property
    def cluster_centers(self):
        return [row for row in self._centers]

    def cluster_centers_matrix(self) -> DenseMatrix:
        return DenseMatrix.from_array(self._centers)

    def _host_rows(self, x: np.ndarray) -> np.ndarray:
        if x.ndim == 1:
            x = x[:, None]
        if self.get("distanceMeasure") == "cosine":
            x = normalize_rows(x)
        return x

    def _assign(self, x: np.ndarray) -> np.ndarray:
        d2 = pairwise_sq_dists(self._host_rows(x), self._centers)
        return d2.argmin(1).astype(np.float64)

    def _transform(self, frame):
        x = frame[self.get("featuresCol")]
        return frame.with_column(self.get("predictionCol"), self._assign(x))

    def predict(self, features) -> int:
        arr = features.to_array() if hasattr(features, "to_array") \
            else np.asarray(features)
        return int(self._assign(arr[None, :])[0])

    def compute_cost(self, frame) -> float:
        """Sum of squared distances to the nearest center (mllib
        KMeansModel.computeCost)."""
        d2 = pairwise_sq_dists(self._host_rows(frame[self.get("featuresCol")]),
                               self._centers)
        return float(np.maximum(d2.min(1), 0.0).sum())

    def _save_data(self, path: str) -> None:
        save_arrays(path, centers=self._centers,
                    training_cost=np.array(self.training_cost))

    def _load_data(self, path: str, meta) -> None:
        arrs = load_arrays(path)
        self._centers = arrs["centers"]
        self.training_cost = float(arrs["training_cost"])
