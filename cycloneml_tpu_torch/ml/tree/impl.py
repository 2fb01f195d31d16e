"""Histogram-based decision-tree engine: the port of the reference's
``ml/tree/impl.py`` (ref: ml/tree/impl/RandomForest.scala:83,
``findBestSplits:463``; the bin seqOp of DTStatsAggregator).

The same three steps a tree level as the reference, all trees of a forest
at once:

1. **binize**, once a dataset: each feature bucketized into bin ids (one
   byte each up to maxBins 256, int32 past it; the reference's int32
   values) against quantile thresholds drawn from the reference's host
   sample (``torch.searchsorted`` per feature on the context's device);
2. **histogram**: every (tree, node, feature, bin) cell sums the stat
   channels of the rows that reach it. On the card this is
   ``kernels.tree_hist`` (``csrc/tree_hist.cu``), which adds each cell's
   rows in one order fixed by the data, with no float atomics, so that two
   fits of the same data grow bitwise-equal forests; on the CPU, or under
   ``cyclone.ml.usePallasKernels=false``, its plain twin
   ``kernels.tree_hist_plain`` (``index_add_``);
3. **reassign**: the host's chosen splits go back as four small tables and
   a gather (:func:`_reassign`) moves every row to its child node.

The split search, the bootstrap or Bernoulli counts and the feature
subsets are host numpy, copied from the reference as they are: the same
``RandomState`` draws in the same order give the same forests. Trees are
stored compactly (explicit child pointers), as the reference stores them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cycloneml_tpu_torch.dataset.instance import compute_dtype
from cycloneml_tpu_torch.ops import kernels
from cycloneml_tpu_torch.util.logging import get_logger

logger = get_logger(__name__)

REASSIGN_ROWS = 1 << 20  # rows moved to their children at a time
CHANNEL_ROWS = 1 << 20   # rows whose float64 channels are built at a time


# ---------------------------------------------------------------------------
# Split finding (quantile binning)
# ---------------------------------------------------------------------------

def find_splits(x_sample: np.ndarray, max_bins: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-feature continuous split thresholds from a host-side sample
    (ref RandomForest.findSplits — quantiles over a bounded sample).

    Returns ``(thresholds [d, max_bins-1] float64 padded with +inf,
    n_bins [d] int32)``; feature f uses thresholds[f, :n_bins[f]-1] and its
    binned values live in [0, n_bins[f]).
    """
    n, d = x_sample.shape
    s_max = max_bins - 1
    thresholds = np.full((d, s_max), np.inf, dtype=np.float64)
    n_bins = np.ones(d, dtype=np.int32)
    for f in range(d):
        vals = np.unique(x_sample[:, f])
        if len(vals) <= 1:
            continue
        if len(vals) <= max_bins:
            th = (vals[:-1] + vals[1:]) / 2.0
        else:
            qs = np.quantile(x_sample[:, f], np.linspace(0, 1, max_bins + 1)[1:-1])
            th = np.unique(qs)
        th = th[:s_max]
        thresholds[f, :len(th)] = th
        n_bins[f] = len(th) + 1
    return thresholds, n_bins


# ---------------------------------------------------------------------------
# Forest data container
# ---------------------------------------------------------------------------

@dataclass
class ForestData:
    """Fitted ensemble as padded flat node tables, one row group per tree.

    ``feature[t, i] < 0`` marks a leaf. ``prediction[t, i]`` is the class
    stat vector (weighted class counts) for classification or ``[mean]`` for
    regression. Heap-free: ``left``/``right`` are explicit node indices.
    """
    feature: np.ndarray      # [T, N] int32
    threshold: np.ndarray    # [T, N] float64
    left: np.ndarray         # [T, N] int32
    right: np.ndarray        # [T, N] int32
    prediction: np.ndarray   # [T, N, C]
    impurity: np.ndarray     # [T, N]
    gain: np.ndarray         # [T, N]
    count: np.ndarray        # [T, N]  raw instance count reaching the node
    weight: np.ndarray       # [T, N]  weighted count
    n_nodes: np.ndarray      # [T] int32
    tree_weights: np.ndarray  # [T]
    num_features: int
    is_classification: bool

    @property
    def num_trees(self) -> int:
        return self.feature.shape[0]

    def tree_depth(self, t: int) -> int:
        depth = np.zeros(self.feature.shape[1], dtype=np.int64)
        maxd = 0
        for i in range(int(self.n_nodes[t])):
            if self.feature[t, i] >= 0:
                for c in (self.left[t, i], self.right[t, i]):
                    depth[c] = depth[i] + 1
                    maxd = max(maxd, int(depth[c]))
        return maxd

    # -- prediction ---------------------------------------------------------
    def predict_leaf_values(self, x: np.ndarray) -> np.ndarray:
        """Leaf value vector per (row, tree): [n, T, C]."""
        n = x.shape[0]
        T, N, C = self.prediction.shape
        out = np.empty((n, T, C), dtype=np.float64)
        max_depth = max((self.tree_depth(t) for t in range(T)), default=0)
        rows = np.arange(n)
        for t in range(T):
            node = np.zeros(n, dtype=np.int64)
            feat, thr = self.feature[t], self.threshold[t]
            lc, rc = self.left[t], self.right[t]
            for _ in range(max_depth):
                f = feat[node]
                interior = f >= 0
                if not interior.any():
                    break
                xv = x[rows, np.clip(f, 0, self.num_features - 1)]
                nxt = np.where(xv <= thr[node], lc[node], rc[node])
                node = np.where(interior, nxt, node)
            out[:, t, :] = self.prediction[t][node]
        return out

    def predict_raw(self, x: np.ndarray) -> np.ndarray:
        """Classification: sum of per-tree class probability votes [n, C]
        (ref RandomForestClassificationModel.predictRaw — normalized votes).
        Regression: weighted sum of tree means [n, 1]."""
        leaf = self.predict_leaf_values(np.asarray(x, dtype=np.float64))
        if self.is_classification:
            tot = np.maximum(leaf.sum(axis=2, keepdims=True), 1e-300)
            return (leaf / tot * self.tree_weights[None, :, None]).sum(axis=1)
        return (leaf[..., 0] * self.tree_weights[None, :]).sum(axis=1, keepdims=True)

    # -- introspection --------------------------------------------------------
    def feature_importances(self) -> np.ndarray:
        """Gain×count importances, normalized per tree then averaged
        (ref: ml/tree/treeModels.scala TreeEnsembleModel.featureImportances)."""
        imp = np.zeros(self.num_features, dtype=np.float64)
        for t in range(self.num_trees):
            one = np.zeros(self.num_features, dtype=np.float64)
            for i in range(int(self.n_nodes[t])):
                f = self.feature[t, i]
                if f >= 0:
                    one[f] += self.gain[t, i] * self.count[t, i]
            s = one.sum()
            if s > 0:
                imp += one / s
        s = imp.sum()
        return imp / s if s > 0 else imp

    def debug_string(self, t: int = 0) -> str:
        lines: List[str] = []

        def rec(i: int, indent: int) -> None:
            pad = "  " * indent
            f = int(self.feature[t, i])
            if f < 0:
                lines.append(f"{pad}Predict: {self._leaf_value(t, i)}")
            else:
                thr = self.threshold[t, i]
                lines.append(f"{pad}If (feature {f} <= {thr})")
                rec(int(self.left[t, i]), indent + 1)
                lines.append(f"{pad}Else (feature {f} > {thr})")
                rec(int(self.right[t, i]), indent + 1)

        rec(0, 0)
        return "\n".join(lines)

    def _leaf_value(self, t: int, i: int) -> float:
        p = self.prediction[t, i]
        if self.is_classification:
            return float(np.argmax(p))
        return float(p[0])

    # -- persistence ----------------------------------------------------------
    def to_arrays(self) -> Dict[str, np.ndarray]:
        return {
            "tree_feature": self.feature, "tree_threshold": self.threshold,
            "tree_left": self.left, "tree_right": self.right,
            "tree_prediction": self.prediction, "tree_impurity": self.impurity,
            "tree_gain": self.gain, "tree_count": self.count,
            "tree_weight": self.weight, "tree_n_nodes": self.n_nodes,
            "tree_weights": self.tree_weights,
            "tree_num_features": np.array(self.num_features),
            "tree_is_classification": np.array(self.is_classification),
        }

    @classmethod
    def from_arrays(cls, a: Dict[str, np.ndarray]) -> "ForestData":
        return cls(feature=a["tree_feature"], threshold=a["tree_threshold"],
                   left=a["tree_left"], right=a["tree_right"],
                   prediction=a["tree_prediction"], impurity=a["tree_impurity"],
                   gain=a["tree_gain"], count=a["tree_count"],
                   weight=a["tree_weight"], n_nodes=a["tree_n_nodes"],
                   tree_weights=a["tree_weights"],
                   num_features=int(a["tree_num_features"]),
                   is_classification=bool(a["tree_is_classification"]))


# ---------------------------------------------------------------------------
# Driver-side tree bookkeeping
# ---------------------------------------------------------------------------

class _TreeBuilder:
    """Growable node table for one tree (explicit child pointers)."""

    def __init__(self, n_channels: int):
        self.feature: List[int] = []
        self.threshold: List[float] = []
        self.left: List[int] = []
        self.right: List[int] = []
        self.prediction: List[np.ndarray] = []
        self.impurity: List[float] = []
        self.gain: List[float] = []
        self.count: List[float] = []
        self.weight: List[float] = []
        self.C = n_channels

    def add_node(self) -> int:
        self.feature.append(-1)
        self.threshold.append(0.0)
        self.left.append(-1)
        self.right.append(-1)
        self.prediction.append(np.zeros(self.C))
        self.impurity.append(0.0)
        self.gain.append(0.0)
        self.count.append(0.0)
        self.weight.append(0.0)
        return len(self.feature) - 1


def _num_features_per_node(strategy: str, d: int, num_trees: int,
                           is_classification: bool) -> int:
    """ref RandomForestParams featureSubsetStrategy semantics."""
    s = strategy.lower()
    if s == "auto":
        if num_trees == 1:
            return d
        return (int(math.ceil(math.sqrt(d))) if is_classification
                else max(1, int(math.ceil(d / 3.0))))
    if s == "all":
        return d
    if s == "sqrt":
        return int(math.ceil(math.sqrt(d)))
    if s == "log2":
        return max(1, int(math.ceil(math.log2(max(d, 2)))))
    if s == "onethird":
        return max(1, int(math.ceil(d / 3.0)))
    try:
        v = float(strategy)
    except ValueError:
        raise ValueError(f"unsupported featureSubsetStrategy {strategy!r}")
    if v >= 1.0 and v == int(v):
        return min(d, int(v))
    if 0.0 < v < 1.0:
        return max(1, int(math.ceil(v * d)))
    raise ValueError(f"unsupported featureSubsetStrategy {strategy!r}")


def _impurity_and_pred(stats: np.ndarray, kind: str):
    """stats [..., C] channel layout: classification C=1+K (count, class
    weights); regression C=4 (count, w, wy, wy2). Returns (impurity, raw
    count, weighted count)."""
    if kind == "variance":
        cnt, w, wy, wy2 = (stats[..., i] for i in range(4))
        # float32 cumsum cancellation can leave tiny nonzero wy on empty
        # bins — mask on weight, don't divide by ~0
        mask = w > 1e-12
        safe = np.where(mask, w, 1.0)
        mean = wy / safe
        imp = np.where(mask, np.maximum(wy2 / safe - mean * mean, 0.0), 0.0)
        return imp, cnt, w
    cls = stats[..., 1:]
    w = cls.sum(axis=-1)
    safe = np.where(w > 1e-12, w, 1.0)
    p = cls / safe[..., None]
    if kind == "entropy":
        imp = -(p * np.log(np.maximum(p, 1e-300))).sum(axis=-1)
    else:  # gini
        imp = 1.0 - (p * p).sum(axis=-1)
    return imp, stats[..., 0], w


# ---------------------------------------------------------------------------
# Binned dataset (device side)
# ---------------------------------------------------------------------------

def bin_storage(n: int, d: int, max_bins: int, dev) -> torch.Tensor:
    """An [n, d] tensor for bin ids below ``max_bins``: uint8 up to 256
    bins (a view of rows padded to a multiple of 4 bytes, so that the
    histogram kernel copies whole 4-byte words of a row), int32 past
    it."""
    if max_bins > 256:
        return torch.empty((n, d), dtype=torch.int32, device=dev)
    return torch.empty((n, -(-d // 4) * 4), dtype=torch.uint8,
                       device=dev)[:, :d]


class BinnedDataset:
    """Bucketized features on the context's device, reusable across trees
    and boosting rounds."""

    def __init__(self, ctx, bins: torch.Tensor, thresholds: np.ndarray,
                 n_bins: np.ndarray, n_rows: int, n_features: int,
                 valid_idx: Optional[np.ndarray] = None):
        self.ctx = ctx
        self.bins = bins                    # [n_pad, d] uint8 or int32
        self.thresholds = thresholds        # [d, B-1] float64 host
        self.n_bins = n_bins                # [d] host
        self.max_bins = int(n_bins.max())
        self.n_rows = n_rows
        self.n_features = n_features
        # real-row positions in padded space (the reference's valid_idx:
        # a chunked dataset's mask names them)
        self.valid_idx = (np.asarray(valid_idx) if valid_idx is not None
                          else np.arange(n_rows))

    @classmethod
    def from_instance_dataset(cls, ds, max_bins: int, seed: int,
                              sample_cap: int = 10000) -> "BinnedDataset":
        """The reference's binning: the same ``RandomState(seed)`` sample
        of at most ``sample_cap`` real rows (gathered from the device, X
        never copied whole), the same thresholds (:func:`find_splits`),
        then ``bin = #thresholds < value`` per feature by
        ``torch.searchsorted(..., right=False)`` on X cast to the
        thresholds' dtype, the accumulator dtype (float64 on the parity
        tier, float32 on the card, as the reference's follow x64)."""
        vi = ds.valid_indices()
        if ds.n_rows > sample_cap:
            rng = np.random.RandomState(seed)
            idx = vi[rng.choice(ds.n_rows, size=sample_cap, replace=False)]
        else:
            idx = vi
        x = ds.x
        dev = x.device
        sample = x[torch.as_tensor(idx, device=dev)].to(
            torch.float64).cpu().numpy()
        thresholds, n_bins = find_splits(sample, max_bins)
        tdt = compute_dtype(getattr(ds.ctx, "conf", None))
        th = torch.as_tensor(thresholds, device=dev).to(tdt)
        bins = bin_storage(x.shape[0], x.shape[1], max_bins, dev)
        for f in range(x.shape[1]):
            # side left: v <= th[b] <=> bin <= b, the raw rule "value <=
            # threshold goes left"
            bins[:, f] = torch.searchsorted(
                th[f].contiguous(), x[:, f].to(tdt).contiguous(),
                right=False).to(bins.dtype)
        return cls(ds.ctx, bins, thresholds, n_bins, ds.n_rows,
                   ds.n_features, valid_idx=vi)


# ---------------------------------------------------------------------------
# The forest grower
# ---------------------------------------------------------------------------

@dataclass
class ForestConfig:
    task: str = "classification"          # or "regression"
    num_classes: int = 2
    impurity: str = "gini"                 # gini|entropy|variance
    max_depth: int = 5
    min_instances_per_node: int = 1
    min_weight_fraction_per_node: float = 0.0
    min_info_gain: float = 0.0
    num_trees: int = 1
    feature_subset_strategy: str = "all"
    subsampling_rate: float = 1.0
    bootstrap: bool = False
    seed: int = 17


def _bootstrap_counts(n_pad: int, valid_idx: np.ndarray,
                      cfg: ForestConfig) -> np.ndarray:
    """Per-(row, tree) sample counts [n_pad, T] float32 on the host, the
    reference's draws (ref BaggedPoint: Poisson(rate) with bootstrap,
    Bernoulli(rate) without) from ``RandomState(cfg.seed)``; padding rows
    0. The draws fill rows in order, so the real rows (first on both
    packages' padding) get the reference's counts."""
    T = cfg.num_trees
    rng = np.random.RandomState(cfg.seed)
    if T == 1 and not cfg.bootstrap and cfg.subsampling_rate >= 1.0:
        cnt = np.ones((n_pad, 1), dtype=np.float32)
    elif cfg.bootstrap:
        cnt = rng.poisson(cfg.subsampling_rate,
                          size=(n_pad, T)).astype(np.float32)
    else:
        cnt = (rng.rand(n_pad, T) < cfg.subsampling_rate).astype(np.float32)
    keep = np.zeros(n_pad, dtype=bool)
    keep[valid_idx] = True
    cnt[~keep] = 0.0
    return cnt


def _channels(cnt: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
              label: Optional[torch.Tensor], n_classes: int) -> torch.Tensor:
    """The stat channels [n_pad, T, C] float32 on the device (stored
    tree-major: strides (C, n_pad x C, 1)), built from
    the host counts, y and w in float64 with the reference's products and
    rounded once to float32 (its ``chans.astype(np.float32)``): the same
    values. Classification C = 1 + K: the count, then the one-hot label
    times w x count (``label`` the class of each real row, -1 for
    padding); regression C = 4: the count, w x count, times y, times y²."""
    n_pad, T = cnt.shape
    C = 1 + n_classes if label is not None else 4
    # tree-major in memory: a tree's rows' channels lie together, so the
    # histogram kernel's gathers of one tree's sorted rows share sectors
    out = torch.empty((T, n_pad, C), dtype=torch.float32,
                      device=cnt.device).permute(1, 0, 2)
    for lo in range(0, n_pad, CHANNEL_ROWS):
        c64 = cnt[lo:lo + CHANNEL_ROWS].to(torch.float64)
        ww = w[lo:lo + CHANNEL_ROWS, None] * c64
        if label is not None:
            lab = label[lo:lo + CHANNEL_ROWS]
            onehot = (lab[:, None] == torch.arange(
                n_classes, device=lab.device)).to(torch.float64)
            ch = torch.cat([c64[:, :, None],
                            onehot[:, None, :] * ww[:, :, None]], dim=2)
        else:
            yc = y[lo:lo + CHANNEL_ROWS, None]
            ch = torch.stack([c64, ww, ww * yc, ww * (yc * yc)], dim=2)
        out[lo:lo + CHANNEL_ROWS] = ch.to(torch.float32)
    return out


def grow_forest(binned: BinnedDataset, y: np.ndarray, w: np.ndarray,
                cfg: ForestConfig) -> ForestData:
    """Level-synchronous forest growth: one histogram a level for all
    trees at once (``kernels.tree_hist``), the split search on the host,
    one gather a level to move the rows.

    ``y``/``w`` are host arrays of length n_rows (labels are residuals for
    GBT rounds)."""
    dev = binned.bins.device
    d, B, T = binned.n_features, binned.max_bins, cfg.num_trees
    classification = cfg.task == "classification"
    K = cfg.num_classes if classification else 0
    kind = cfg.impurity
    n_pad = binned.bins.shape[0]
    vi = binned.valid_idx

    cnt_host = _bootstrap_counts(n_pad, vi, cfg)
    y_host = np.zeros(n_pad, dtype=np.float64)
    y_host[vi] = y
    w_host = np.zeros(n_pad, dtype=np.float64)
    w_host[vi] = w
    label = None
    if classification:
        lab = np.full(n_pad, -1, dtype=np.int64)
        lab[vi] = np.clip(y.astype(np.int64), 0, K - 1)
        label = torch.from_numpy(lab).to(dev)
    cnt = torch.from_numpy(cnt_host).to(dev)
    chans = _channels(cnt, torch.from_numpy(y_host).to(dev),
                      torch.from_numpy(w_host).to(dev), label, K)
    pos = torch.where(cnt > 0, 0, -1).to(torch.int32)   # [n_pad, T]
    del cnt, label
    plain = kernels.kernel_mode(binned.ctx) == "false"

    # -- host bookkeeping --------------------------------------------------
    trees = [_TreeBuilder(K if classification else 1) for _ in range(T)]
    # active[t] = list of node ids at the current level, position-indexed
    active: List[List[int]] = [[tb.add_node()] for tb in trees]
    n_feat_subset = _num_features_per_node(
        cfg.feature_subset_strategy, d, T, classification)
    total_weight = float((w_host * cnt_host.mean(axis=1)).sum()) if T > 1 else float(
        (w_host * cnt_host[:, 0]).sum())
    # per-node min weight uses the full training weight (ref minWeightFractionPerNode)
    min_w = cfg.min_weight_fraction_per_node * max(total_weight, 1e-300)
    del cnt_host, y_host, w_host

    valid_split_mask = np.zeros((d, B), dtype=bool)        # [d, B] bins that exist
    for f in range(d):
        valid_split_mask[f, : max(int(binned.n_bins[f]) - 1, 0)] = True

    depth = 0
    while depth <= cfg.max_depth:
        A = max(len(a) for a in active)
        if A == 0:
            break
        A_pad = 1 << (A - 1).bit_length()
        hist_fn = kernels.tree_hist_plain if plain else kernels.tree_hist
        hist = hist_fn(binned.bins, chans, pos, A_pad, B)
        hist = hist.to(torch.float64).cpu().numpy()         # [T, A_pad, d, B, C]
        tables, active, any_split = _split_level(
            hist, active, trees, binned.thresholds, valid_split_mask,
            n_feat_subset, min_w, depth, classification, kind, cfg)
        if not any_split:
            break
        pos = _reassign(binned.bins, pos, *tables)
        depth += 1

    return _pack(trees, d, classification)


def _split_level(hist: np.ndarray, active: List[List[int]],
                 trees: List["_TreeBuilder"], thresholds: np.ndarray,
                 valid_split_mask: np.ndarray, n_feat_subset: int,
                 min_w: float, depth: int, classification: bool, kind: str,
                 cfg: ForestConfig):
    """The host split search of one level, the reference's as it is:
    fills each active node's statistics and split, and returns the
    reassign tables (featA, binA, posL, posR) [T, A_pad], the next level's
    active nodes and whether any node split."""
    T, A_pad, d = hist.shape[:3]
    featA = np.full((T, A_pad), -1, dtype=np.int32)
    binA = np.zeros((T, A_pad), dtype=np.int32)
    posL = np.full((T, A_pad), -1, dtype=np.int32)
    posR = np.full((T, A_pad), -1, dtype=np.int32)
    next_active: List[List[int]] = [[] for _ in range(T)]
    any_split = False

    for t in range(T):
        if not active[t]:
            continue
        nodes = active[t]
        h = hist[t, :len(nodes)]                        # [a, d, B, C]
        parent = h.sum(axis=2)[:, 0, :]                 # [a, C] (same ∀ features)
        p_imp, p_cnt, p_w = _impurity_and_pred(parent, kind)

        cum = np.cumsum(h, axis=2)                      # left stats per split
        left_s = cum[:, :, :-1, :]                      # split after bin b
        right_s = parent[:, None, None, :] - left_s
        l_imp, l_cnt, l_w = _impurity_and_pred(left_s, kind)
        r_imp, r_cnt, r_w = _impurity_and_pred(right_s, kind)
        safe_w = np.maximum(p_w, 1e-300)[:, None, None]
        gain = (p_imp[:, None, None]
                - (l_w * l_imp + r_w * r_imp) / safe_w)

        ok = (valid_split_mask[None, :, :-1]
              & (l_cnt >= cfg.min_instances_per_node)
              & (r_cnt >= cfg.min_instances_per_node)
              & (l_w >= min_w) & (r_w >= min_w))
        if n_feat_subset < d:
            frng = np.random.RandomState(
                (cfg.seed + 31 * depth + 131 * t) % (2 ** 31))
            sel = np.zeros((len(nodes), d), dtype=bool)
            for a_i in range(len(nodes)):
                sel[a_i, frng.choice(d, size=n_feat_subset, replace=False)] = True
            ok &= sel[:, :, None]
        gain = np.where(ok, gain, -np.inf)

        for a_i, node_id in enumerate(nodes):
            tb = trees[t]
            tb.count[node_id] = float(p_cnt[a_i])
            tb.weight[node_id] = float(p_w[a_i])
            tb.impurity[node_id] = float(p_imp[a_i])
            if classification:
                tb.prediction[node_id] = parent[a_i, 1:].copy()
            else:
                m = parent[a_i, 2] / max(parent[a_i, 1], 1e-300)
                tb.prediction[node_id] = np.array([m])

            g = gain[a_i]
            best = np.unravel_index(np.argmax(g), g.shape)
            best_gain = g[best]
            splittable = (depth < cfg.max_depth
                          and np.isfinite(best_gain)
                          and best_gain >= cfg.min_info_gain
                          and best_gain > 1e-12
                          and p_imp[a_i] > 0.0)
            if not splittable:
                continue
            f_best, b_best = int(best[0]), int(best[1])
            tb.feature[node_id] = f_best
            tb.threshold[node_id] = float(thresholds[f_best, b_best])
            tb.gain[node_id] = float(best_gain)
            lid, rid = tb.add_node(), tb.add_node()
            tb.left[node_id], tb.right[node_id] = lid, rid
            featA[t, a_i] = f_best
            binA[t, a_i] = b_best
            posL[t, a_i] = len(next_active[t])
            next_active[t].append(lid)
            posR[t, a_i] = len(next_active[t])
            next_active[t].append(rid)
            any_split = True
    return (featA, binA, posL, posR), next_active, any_split


def _reassign(bins: torch.Tensor, pos: torch.Tensor, featA: np.ndarray,
              binA: np.ndarray, posL: np.ndarray, posR: np.ndarray,
              chunk_rows: int = REASSIGN_ROWS) -> torch.Tensor:
    """Every active row's position at the next level (the reference's
    ``reassign_fn``): its node's split feature, bin and child positions
    gathered from the [T, A_pad] tables, its bin of that feature gathered
    from ``bins`` (uint8 or int32); a row whose node settled becomes -1. A
    gather, ``chunk_rows`` rows at a time; no scatter."""
    dev = pos.device
    T, A_pad = featA.shape
    d = bins.shape[1]
    tabs = torch.as_tensor(np.stack([featA, binA, posL, posR]),
                           device=dev).reshape(4, T * A_pad)
    base = torch.arange(T, device=dev, dtype=torch.int64) * A_pad
    out = torch.empty_like(pos)
    for lo in range(0, pos.shape[0], chunk_rows):
        p = pos[lo:lo + chunk_rows]
        idx = p.clamp(min=0).to(torch.int64) + base        # [m, T]
        f = tabs[0][idx]
        xv = torch.gather(bins[lo:lo + chunk_rows], 1,
                          f.clamp(0, d - 1).to(torch.int64))
        nxt = torch.where(xv <= tabs[1][idx], tabs[2][idx], tabs[3][idx])
        new = torch.where(f >= 0, nxt, torch.full_like(nxt, -1))
        out[lo:lo + chunk_rows] = torch.where(p >= 0, new, p)
    return out


def _pack(trees: List["_TreeBuilder"], d: int, classification: bool) -> ForestData:
    T = len(trees)
    N = max(len(tb.feature) for tb in trees)
    C = trees[0].C

    def pad2(lists, dtype, fill=0):
        out = np.full((T, N), fill, dtype=dtype)
        for t, ls in enumerate(lists):
            out[t, :len(ls)] = ls
        return out

    pred = np.zeros((T, N, C), dtype=np.float64)
    for t, tb in enumerate(trees):
        for i, p in enumerate(tb.prediction):
            pred[t, i] = p
    return ForestData(
        feature=pad2([tb.feature for tb in trees], np.int32, -1),
        threshold=pad2([tb.threshold for tb in trees], np.float64),
        left=pad2([tb.left for tb in trees], np.int32, -1),
        right=pad2([tb.right for tb in trees], np.int32, -1),
        prediction=pred,
        impurity=pad2([tb.impurity for tb in trees], np.float64),
        gain=pad2([tb.gain for tb in trees], np.float64),
        count=pad2([tb.count for tb in trees], np.float64),
        weight=pad2([tb.weight for tb in trees], np.float64),
        n_nodes=np.array([len(tb.feature) for tb in trees], dtype=np.int32),
        tree_weights=np.ones(T, dtype=np.float64),
        num_features=d,
        is_classification=classification,
    )
