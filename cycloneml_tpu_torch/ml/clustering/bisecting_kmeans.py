"""Bisecting k-means (divisive hierarchical clustering).

The port's counterpart of ``cycloneml_tpu/ml/clustering/bisecting_kmeans.py``
(ref: mllib/clustering/BisectingKMeans.scala — level-by-level bisection of
divisible clusters, binary-tree node indexing root=1/children 2i,2i+1,
ClusteringTreeNode predict-by-descent):

- each row's tree node lives on the device beside X; a level's splits all
  train together: the child centers stacked (2m, d), each row choosing
  only between its own node's two children through a node -> slot table
  (``slot_of``), the distances one product a chunk of rows at a time;
- the children's sums and weights of each pass, and after a level its
  children's row counts and costs, are the center sums
  (``ops/kernels.center_sums``, the reference's one-hot products): on the
  card a fixed order with no float atomics at every width the kernel
  reads (float32, bfloat16 or float64 X), so two fits of the same rows
  build the same tree bit for bit. Only an explicit
  ``usePallasKernels=false`` takes the plain ``index_add_`` sums (on the
  card only a float64 truth);
- the divisibility gate on point count and cost, the children's
  +/- perturbation from the host ``RandomState(seed)`` and the cosine mode
  are the reference's.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
from cycloneml_tpu_torch.ml.base import Estimator, Model
from cycloneml_tpu_torch.ml.clustering._util import (normalize_rows,
                                                     pairwise_sq_dists,
                                                     sq_dists)
from cycloneml_tpu_torch.ml.param import ParamValidators as V
from cycloneml_tpu_torch.ml.shared import (
    HasFeaturesCol, HasMaxIter, HasPredictionCol, HasSeed, HasWeightCol,
)
from cycloneml_tpu_torch.ml.util_io import MLReadable, MLWritable, load_arrays, save_arrays
from cycloneml_tpu_torch.ops import kernels
from cycloneml_tpu_torch.parallel import collectives

ROW_CHUNK = 1 << 20  # rows whose distances to the children are formed at once


class _BKMParams(HasFeaturesCol, HasPredictionCol, HasMaxIter, HasSeed,
                 HasWeightCol):
    def _declare_bkm_params(self):
        self._p_features_col()
        self._p_prediction_col()
        self._p_max_iter(20)
        self._p_seed(17)
        self._p_weight_col()
        self.k = self._param("k", "desired number of leaf clusters (> 1)",
                             V.gt(1), default=4)
        self.minDivisibleClusterSize = self._param(
            "minDivisibleClusterSize",
            "min points (>=1) or fraction (<1) for a divisible cluster",
            V.gt(0.0), default=1.0)
        self.distanceMeasure = self._param(
            "distanceMeasure", "euclidean or cosine",
            V.in_array(["euclidean", "cosine"]), default="euclidean")


def _sums(use_kernel: bool, x, w, idx, k: int, with_sums: bool = True):
    """Per-child sums of w x and of w: the center sums' fixed order
    (``kernels.center_sums``, its plain version on the CPU), or with
    ``usePallasKernels=false`` the plain ``index_add_`` sums at w's
    width."""
    if use_kernel:
        return kernels.center_sums(x, w, idx, k, with_sums=with_sums)
    return kernels.center_sums_plain(x, w, idx, k, with_sums=with_sums)


class BisectingKMeans(Estimator, _BKMParams, MLWritable, MLReadable):
    def __init__(self, uid=None, **kwargs):
        super().__init__(uid)
        self._declare_bkm_params()
        for key, v in kwargs.items():
            self.set(key, v)

    def set_k(self, v):
        return self.set("k", v)

    def set_max_iter(self, v):
        return self.set("maxIter", v)

    def set_seed(self, v):
        return self.set("seed", v)

    def _fit(self, frame) -> "BisectingKMeansModel":
        ds = frame.to_instance_dataset(
            self.get("featuresCol"), label_col=None,
            weight_col=self.get("weightCol") or None)
        return self._fit_dataset(ds)

    def _fit_dataset(self, ds: InstanceDataset) -> "BisectingKMeansModel":
        k = self.get("k")
        cosine = self.get("distanceMeasure") == "cosine"
        rng = np.random.RandomState(self.get("seed"))
        dtype = ds.w.dtype  # accumulator tier: X may store bf16
        dev = ds.x.device
        use_kernel = kernels.kernel_mode(ds.ctx) != "false"
        if cosine:
            ds = ds.derive(x=normalize_rows(ds.x))
        d = ds.n_features

        # root stats: weighted mean, row count, and cost about the mean
        def root_stats(x, y, w, center):
            s = torch.zeros(d, dtype=dtype, device=dev)
            cost = torch.zeros((), dtype=dtype, device=dev)
            for lo in range(0, x.shape[0], ROW_CHUNK):
                xc = x[lo:lo + ROW_CHUNK].to(dtype)
                wc = w[lo:lo + ROW_CHUNK]
                s = s + wc @ xc
                cost = cost + torch.sum(
                    wc * torch.sum((xc - center[None, :]) ** 2, dim=1))
            return {"sum": s, "wsum": torch.sum(w),
                    "count": torch.sum((w > 0).to(w.dtype)), "cost": cost}

        root_agg = ds.tree_aggregate_fn(root_stats)
        out = root_agg(torch.zeros(d, dtype=dtype, device=dev))
        flat = torch.cat([out["sum"], out["wsum"].reshape(1),
                          out["count"].reshape(1)]).cpu().double().numpy()
        total_n = float(flat[d + 1])
        root_center = flat[:d] / max(float(flat[d]), 1e-300)
        if cosine:
            root_center /= max(np.linalg.norm(root_center), 1e-12)
        root_cost = float(root_agg(torch.as_tensor(
            root_center, device=dev).to(dtype))["cost"])

        # divisibility gates on POINT COUNT like the reference (a cluster of
        # fractional-weight rows is still divisible), plus a nonzero-cost
        # check (ref BisectingKMeans.divisibleLeaves: cost > EPSILON * size)
        min_size = self.get("minDivisibleClusterSize")
        min_n = min_size if min_size >= 1.0 else min_size * total_n

        nodes: Dict[int, np.ndarray] = {1: root_center}
        sizes: Dict[int, float] = {1: total_n}
        costs: Dict[int, float] = {1: root_cost}
        leaves = {1}
        # each row's binary-tree node index, root = 1, beside X
        assign = torch.ones(ds.x.shape[0], dtype=torch.int64, device=dev)
        run = _level_program(ds, use_kernel)
        level_passes = []

        while len(leaves) < k:
            divisible = sorted(
                [n for n in leaves
                 if sizes[n] >= min_n and sizes[n] > 1
                 and costs[n] > 1e-12 * sizes[n]],
                key=lambda n: -sizes[n])
            if not divisible:
                break
            m = min(len(divisible), k - len(leaves))
            splitting = divisible[:m]
            # the table covers every live node index, so no row's lookup
            # aliases another node's slot
            max_node = max(leaves)
            slot_of = np.full(max_node + 1, -1, np.int64)
            for s, node in enumerate(splitting):
                slot_of[node] = s
            # init children by +/- perturbation of parent (ref splitCenter)
            child = np.empty((m, 2, d))
            for s, node in enumerate(splitting):
                c = nodes[node]
                level = max(1e-4 * np.linalg.norm(c), 1e-4)
                noise = rng.rand(d)
                child[s, 0] = c - level * noise
                child[s, 1] = c + level * noise

            slot_t = torch.as_tensor(slot_of, device=dev)
            passes = 0
            for _ in range(max(1, self.get("maxIter"))):
                flat = child.reshape(-1, d)
                stats, state = run(assign, slot_t,
                                   torch.as_tensor(flat, device=dev).to(dtype))
                passes += 1
                # one transfer a pass
                host = torch.cat([stats["sums"].reshape(-1),
                                  stats["wsums"]]).cpu().double().numpy()
                sums = host[:2 * m * d].reshape(2 * m, d)
                wsums = host[2 * m * d:]
                moved_child = np.where(wsums[:, None] > 0,
                                       sums / np.maximum(wsums[:, None], 1e-300),
                                       flat)
                if cosine:
                    moved_child = moved_child / np.maximum(
                        np.linalg.norm(moved_child, axis=1, keepdims=True), 1e-12)
                moved = np.linalg.norm(moved_child - flat, axis=1).max()
                child = moved_child.reshape(m, 2, d)
                if moved < 1e-6:
                    break
            level_passes.append(passes)
            # the last pass's assignment: the children's row counts and
            # costs, then each row's new node
            assign, cidx, real, wcost = state
            counts, child_cost = _child_stats(ds, cidx, real, wcost, 2 * m,
                                              use_kernel)
            for s, node in enumerate(splitting):
                leaves.discard(node)
                for side in (0, 1):
                    ci = 2 * node + side
                    nodes[ci] = child[s, side]
                    sizes[ci] = counts[2 * s + side]
                    costs[ci] = child_cost[2 * s + side]
                    leaves.add(ci)

        leaf_idx = sorted(leaves)
        centers = np.stack([nodes[i] for i in leaf_idx])
        model = BisectingKMeansModel(
            centers,
            node_index=np.asarray(leaf_idx, np.int64),
            tree_nodes=nodes, uid=self.uid)
        self._copy_values(model)
        model._set_parent(self)
        model.level_passes = level_passes
        return model


def _level_program(ds: InstanceDataset, use_kernel: bool):
    """One pass of a level: every active row's nearer child of its node,
    the children's sums and weights (summed over the mesh), and each row's
    state (new node, child slot, real-row flag, weighted cost) kept
    beside X."""

    def level_step(x, y, w, assigned, slot_of, child_centers):
        slot = slot_of[assigned]                                  # (b,)
        active = slot >= 0
        sl = torch.clamp(slot, min=0)
        d_left = torch.empty(x.shape[0], dtype=w.dtype, device=x.device)
        d_right = torch.empty_like(d_left)
        for lo in range(0, x.shape[0], ROW_CHUNK):
            d2 = sq_dists(x[lo:lo + ROW_CHUNK], child_centers)   # (b, 2m)
            s2 = 2 * sl[lo:lo + ROW_CHUNK, None]
            d_left[lo:lo + ROW_CHUNK] = torch.gather(d2, 1, s2)[:, 0]
            d_right[lo:lo + ROW_CHUNK] = torch.gather(d2, 1, s2 + 1)[:, 0]
        side = (d_right < d_left).to(torch.int64)                 # 0/1
        cidx = torch.where(active, 2 * sl + side, torch.zeros_like(sl))
        act = active.to(w.dtype)
        wm = w * act
        sums, wsums = _sums(use_kernel, x, wm, cidx, child_centers.shape[0])
        real = act * (w > 0).to(w.dtype)
        mind = torch.clamp(torch.minimum(d_left, d_right), min=0.0)
        new_assign = torch.where(active, 2 * assigned + side, assigned)
        return ({"sums": sums, "wsums": wsums},
                (new_assign, cidx, real, wm * mind))

    compiled = collectives.tree_aggregate_with_state(
        level_step, ds.ctx.mesh_runtime, ds.x, ds.y, ds.w, ds.w)

    def run(assign, slot_of, child):
        return compiled(ds.x, ds.y, ds.w, assign, slot_of, child)

    return run


def _child_stats(ds: InstanceDataset, cidx, real, wcost, k: int,
                 use_kernel: bool):
    """The children's row counts and costs of a level's last pass
    (host float64 ``(k,)`` each), two weight-only center sums."""

    def stats(x, idx, r, wc):
        return (_sums(use_kernel, x, r, idx, k, with_sums=False)[1],
                _sums(use_kernel, x, wc, idx, k, with_sums=False)[1])

    counts, cost = collectives.tree_aggregate(
        stats, ds.ctx.mesh_runtime, ds.x, cidx, real, wcost)(
            ds.x, cidx, real, wcost)
    host = torch.cat([counts, cost]).cpu().double().numpy()
    return host[:k], host[k:]


class BisectingKMeansModel(Model, _BKMParams, MLWritable, MLReadable):
    """Prediction descends the tree root->leaf choosing the nearer child
    (ref ClusteringTreeNode.predict), on the host."""

    def __init__(self, centers: Optional[np.ndarray] = None,
                 node_index: Optional[np.ndarray] = None,
                 tree_nodes: Optional[Dict[int, np.ndarray]] = None, uid=None):
        super().__init__(uid)
        self._declare_bkm_params()
        self._centers = np.asarray(centers) if centers is not None else None
        self._node_index = (np.asarray(node_index)
                            if node_index is not None else None)
        self._tree = dict(tree_nodes) if tree_nodes else None
        # the passes over X of each level of the fit that made the model
        self.level_passes = []

    @property
    def cluster_centers(self):
        return [row for row in self._centers]

    def _assign(self, x: np.ndarray) -> np.ndarray:
        if x.ndim == 1:
            x = x[:, None]
        if self.get("distanceMeasure") == "cosine":
            x = normalize_rows(x)
        leaf_set = set(int(i) for i in self._node_index)
        if self._tree:
            out = np.empty(x.shape[0])
            leaf_pos = {int(n): i for i, n in enumerate(self._node_index)}
            for r in range(x.shape[0]):
                node = 1
                while node not in leaf_set:
                    left, right = self._tree.get(2 * node), self._tree.get(2 * node + 1)
                    if left is None or right is None:
                        break
                    dl = np.sum((x[r] - left) ** 2)
                    dr = np.sum((x[r] - right) ** 2)
                    node = 2 * node + (1 if dr < dl else 0)
                out[r] = leaf_pos.get(node, 0)
            return out.astype(np.float64)
        d2 = pairwise_sq_dists(x, self._centers)
        return d2.argmin(1).astype(np.float64)

    def _transform(self, frame):
        x = frame[self.get("featuresCol")]
        return frame.with_column(self.get("predictionCol"), self._assign(x))

    def predict(self, features) -> int:
        arr = features.to_array() if hasattr(features, "to_array") \
            else np.asarray(features)
        return int(self._assign(arr[None, :])[0])

    def compute_cost(self, frame) -> float:
        x = frame[self.get("featuresCol")]
        if x.ndim == 1:
            x = x[:, None]
        assign = self._assign(x).astype(int)
        if self.get("distanceMeasure") == "cosine":
            # cosine distance 1 - cos(x, c), not squared-euclidean on the
            # normalized vectors (which would double it)
            xn = normalize_rows(x)
            cn = normalize_rows(self._centers[assign])
            return float(np.sum(1.0 - np.sum(xn * cn, axis=1)))
        return float(np.sum((x - self._centers[assign]) ** 2))

    def _save_data(self, path: str) -> None:
        tree_idx = (np.asarray(sorted(self._tree), np.int64) if self._tree
                    else np.zeros(0, np.int64))
        tree_centers = (np.stack([self._tree[i] for i in tree_idx])
                        if len(tree_idx)
                        else np.zeros((0, self._centers.shape[1])))
        save_arrays(path, centers=self._centers, node_index=self._node_index,
                    tree_idx=tree_idx, tree_centers=tree_centers)

    def _load_data(self, path: str, meta) -> None:
        arrs = load_arrays(path)
        self._centers = arrs["centers"]
        self._node_index = arrs["node_index"]
        self._tree = {int(i): c for i, c in
                      zip(arrs["tree_idx"], arrs["tree_centers"])}
