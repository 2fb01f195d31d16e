"""Tree-based classifiers: DecisionTree, RandomForest, GBT, the port of the
reference's ``ml/classification/trees.py`` (ref:
ml/classification/DecisionTreeClassifier.scala,
RandomForestClassifier.scala, GBTClassifier.scala; training engine
ml/tree/impl/RandomForest.scala:83 and GradientBoostedTrees.scala) on the
histogram engine of ``ml/tree/impl.py``: one level histogram for all
trees of a forest a level (``kernels.tree_hist`` on the card). The GBT
residual loop stays on the host, as the reference's does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cycloneml_tpu_torch.dataset.frame import MLFrame
from cycloneml_tpu_torch.ml.base import Predictor, ProbabilisticClassificationModel
from cycloneml_tpu_torch.ml.tree import (
    BinnedDataset, ForestConfig, ForestData, _DecisionTreeParams, _GBTParams,
    _RandomForestParams, grow_forest,
)
from cycloneml_tpu_torch.ml.util_io import MLReadable, MLWritable, load_arrays, save_arrays
from cycloneml_tpu_torch.util.logging import get_logger

logger = get_logger(__name__)


def _prepare(est, frame: MLFrame):
    ds = frame.to_instance_dataset(
        est.get("featuresCol"), label_col=est.get("labelCol"),
        weight_col=est.get("weightCol") or None)
    # the real rows' labels and weights (a chunked dataset's mask honoured)
    y, w = ds.unpad(ds.y_host()), ds.unpad(ds.w_host())
    binned = BinnedDataset.from_instance_dataset(
        ds, est.get("maxBins"), est.get("seed"))
    return binned, y, w


class _TreeClassifierModelBase(ProbabilisticClassificationModel):
    """Shared transform path: raw = ensemble probability votes."""

    _forest: ForestData
    _num_classes: int

    @property
    def num_classes(self) -> int:
        return self._num_classes

    @property
    def num_features(self) -> int:
        return self._forest.num_features

    @property
    def feature_importances(self) -> np.ndarray:
        return self._forest.feature_importances()

    @property
    def total_num_nodes(self) -> int:
        return int(self._forest.n_nodes.sum())

    def to_debug_string(self) -> str:
        return "\n\n".join(self._forest.debug_string(t)
                           for t in range(self._forest.num_trees))

    def _raw_prediction(self, x: np.ndarray) -> np.ndarray:
        return self._forest.predict_raw(x)

    def _raw_to_probability(self, raw: np.ndarray) -> np.ndarray:
        s = np.maximum(raw.sum(axis=1, keepdims=True), 1e-300)
        return raw / s

    def _save_data(self, path: str) -> None:
        save_arrays(path, num_classes=np.array(self._num_classes),
                    **self._forest.to_arrays())

    def _load_data(self, path: str, meta) -> None:
        a = load_arrays(path)
        self._num_classes = int(a["num_classes"])
        self._forest = ForestData.from_arrays(a)


# ---------------------------------------------------------------------------
# DecisionTreeClassifier
# ---------------------------------------------------------------------------

class DecisionTreeClassifier(Predictor, _DecisionTreeParams, MLWritable, MLReadable):
    """ref: ml/classification/DecisionTreeClassifier.scala:45."""

    def __init__(self, uid=None, **kwargs):
        super().__init__(uid)
        self._declare_tree_params(["gini", "entropy"], "gini")
        for k, v in kwargs.items():
            self.set(k, v)

    def _fit(self, frame: MLFrame) -> "DecisionTreeClassificationModel":
        binned, y, w = _prepare(self, frame)
        k = int(y.max()) + 1 if len(y) else 2
        cfg = ForestConfig(
            task="classification", num_classes=max(k, 2),
            impurity=self.get("impurity"), max_depth=self.get("maxDepth"),
            min_instances_per_node=self.get("minInstancesPerNode"),
            min_weight_fraction_per_node=self.get("minWeightFractionPerNode"),
            min_info_gain=self.get("minInfoGain"), num_trees=1,
            feature_subset_strategy="all", subsampling_rate=1.0,
            bootstrap=False, seed=self.get("seed"))
        forest = grow_forest(binned, y, w, cfg)
        m = DecisionTreeClassificationModel(forest, max(k, 2))
        self._copy_values(m)
        return m


class DecisionTreeClassificationModel(_TreeClassifierModelBase,
                                      _DecisionTreeParams, MLWritable, MLReadable):
    def __init__(self, forest: Optional[ForestData] = None,
                 num_classes: int = 2, uid=None):
        super().__init__(uid)
        self._declare_tree_params(["gini", "entropy"], "gini")
        self._forest = forest
        self._num_classes = num_classes

    @property
    def depth(self) -> int:
        return self._forest.tree_depth(0)

    @property
    def num_nodes(self) -> int:
        return int(self._forest.n_nodes[0])


# ---------------------------------------------------------------------------
# RandomForestClassifier
# ---------------------------------------------------------------------------

class RandomForestClassifier(Predictor, _RandomForestParams, MLWritable, MLReadable):
    """ref: ml/classification/RandomForestClassifier.scala:48."""

    def __init__(self, uid=None, **kwargs):
        super().__init__(uid)
        self._declare_tree_params(["gini", "entropy"], "gini")
        self._declare_rf_params()
        for k, v in kwargs.items():
            self.set(k, v)

    def _fit(self, frame: MLFrame) -> "RandomForestClassificationModel":
        binned, y, w = _prepare(self, frame)
        k = int(y.max()) + 1 if len(y) else 2
        cfg = ForestConfig(
            task="classification", num_classes=max(k, 2),
            impurity=self.get("impurity"), max_depth=self.get("maxDepth"),
            min_instances_per_node=self.get("minInstancesPerNode"),
            min_weight_fraction_per_node=self.get("minWeightFractionPerNode"),
            min_info_gain=self.get("minInfoGain"),
            num_trees=self.get("numTrees"),
            feature_subset_strategy=self.get("featureSubsetStrategy"),
            subsampling_rate=self.get("subsamplingRate"),
            bootstrap=self.get("bootstrap"), seed=self.get("seed"))
        forest = grow_forest(binned, y, w, cfg)
        m = RandomForestClassificationModel(forest, max(k, 2))
        self._copy_values(m)
        return m


class RandomForestClassificationModel(_TreeClassifierModelBase,
                                      _RandomForestParams, MLWritable, MLReadable):
    def __init__(self, forest: Optional[ForestData] = None,
                 num_classes: int = 2, uid=None):
        super().__init__(uid)
        self._declare_tree_params(["gini", "entropy"], "gini")
        self._declare_rf_params()
        self._forest = forest
        self._num_classes = num_classes

    @property
    def num_trees(self) -> int:
        return self._forest.num_trees


# ---------------------------------------------------------------------------
# GBTClassifier
# ---------------------------------------------------------------------------

class GBTClassifier(Predictor, _GBTParams, MLWritable, MLReadable):
    """Gradient-boosted trees for binary classification
    (ref: ml/classification/GBTClassifier.scala:58; boosting loop
    mllib/tree/GradientBoostedTrees via ml/tree/impl/GradientBoostedTrees
    .scala — LogLoss: L = 2·log(1+exp(-2yF)), negative gradient
    4y/(1+exp(2yF)), first tree weight 1.0 then stepSize)."""

    def __init__(self, uid=None, **kwargs):
        super().__init__(uid)
        self._declare_tree_params(["variance"], "variance")
        self._declare_gbt_params(["logistic"], "logistic")
        for k, v in kwargs.items():
            self.set(k, v)

    def _fit(self, frame: MLFrame) -> "GBTClassificationModel":
        binned, y, w = _prepare(self, frame)
        y_pm = 2.0 * y - 1.0                       # {0,1} → {-1,+1}
        forests, weights = _boost(
            self, binned, w,
            first_target=y_pm,
            neg_gradient=lambda f: 4.0 * y_pm / (1.0 + np.exp(2.0 * y_pm * f)))
        m = GBTClassificationModel(forests, np.array(weights))
        self._copy_values(m)
        return m


def _boost(est, binned: BinnedDataset, w: np.ndarray, first_target: np.ndarray,
           neg_gradient) -> tuple:
    """Shared boosting loop; each round fits a variance-impurity regression
    tree to the pseudo-residual (ref GradientBoostedTrees.boost)."""
    step = est.get("stepSize")
    base_cfg = dict(
        task="regression", impurity="variance",
        max_depth=est.get("maxDepth"),
        min_instances_per_node=est.get("minInstancesPerNode"),
        min_weight_fraction_per_node=est.get("minWeightFractionPerNode"),
        min_info_gain=est.get("minInfoGain"), num_trees=1,
        feature_subset_strategy=est.get("featureSubsetStrategy"),
        subsampling_rate=est.get("subsamplingRate"), bootstrap=False)

    x_for_pred = None
    forests, weights = [], []
    f_pred = np.zeros_like(first_target)
    target = first_target
    for it in range(max(est.get("maxIter"), 1)):
        cfg = ForestConfig(seed=est.get("seed") + it, **base_cfg)
        tree = grow_forest(binned, target, w, cfg)
        tw = 1.0 if it == 0 else step
        forests.append(tree)
        weights.append(tw)
        if it == max(est.get("maxIter"), 1) - 1:
            break
        if x_for_pred is None:
            # one host copy of the raw features for residual updates
            x_for_pred = _unbin(binned)
        f_pred = f_pred + tw * tree.predict_raw(x_for_pred)[:, 0]
        target = neg_gradient(f_pred)
    return forests, weights


def _unbin(binned: BinnedDataset) -> np.ndarray:
    """Representative raw value per bin so tree thresholds (raw-space)
    evaluate identically to bin comparisons: use threshold midpoint proxies.
    Simpler and exact: reconstruct from bins via thresholds — value in bin b
    of feature f satisfies th[b-1] < v <= th[b]; any v in that interval gives
    the same path, so use th[b] (and th[last]+1 for the top bin). The bins
    may be uint8 or int32."""
    bins = binned.bins[torch.as_tensor(
        binned.valid_idx, device=binned.bins.device)].cpu().numpy()
    d = binned.n_features
    out = np.empty(bins.shape, dtype=np.float64)
    for f in range(d):
        nb = int(binned.n_bins[f])
        th = binned.thresholds[f, :max(nb - 1, 0)]
        reps = np.concatenate([th, [th[-1] + 1.0 if nb > 1 else 0.0]])
        out[:, f] = reps[np.clip(bins[:, f], 0, nb - 1)]
    return out


class GBTClassificationModel(ProbabilisticClassificationModel, _GBTParams,
                             MLWritable, MLReadable):
    """Prediction = Σ wᵢ·treeᵢ(x); raw = (-F, F), probability via the
    logistic loss link (ref GBTClassificationModel.predictRaw/
    raw2probabilityInPlace: p₁ = 1/(1+exp(-2F)))."""

    def __init__(self, forests=None, tree_weights: Optional[np.ndarray] = None,
                 uid=None):
        super().__init__(uid)
        self._declare_tree_params(["variance"], "variance")
        self._declare_gbt_params(["logistic"], "logistic")
        self._forests = forests or []
        self._tree_weights = (np.asarray(tree_weights)
                              if tree_weights is not None else np.zeros(0))

    @property
    def num_trees(self) -> int:
        return len(self._forests)

    @property
    def tree_weights(self) -> np.ndarray:
        return self._tree_weights

    @property
    def num_features(self) -> int:
        return self._forests[0].num_features

    @property
    def num_classes(self) -> int:
        return 2

    @property
    def feature_importances(self) -> np.ndarray:
        imp = np.zeros(self.num_features)
        for fo in self._forests:
            imp += fo.feature_importances()
        s = imp.sum()
        return imp / s if s > 0 else imp

    def _margin(self, x: np.ndarray) -> np.ndarray:
        f = np.zeros(x.shape[0])
        for fo, tw in zip(self._forests, self._tree_weights):
            f += tw * fo.predict_raw(x)[:, 0]
        return f

    def _raw_prediction(self, x: np.ndarray) -> np.ndarray:
        m = self._margin(np.asarray(x, dtype=np.float64))
        return np.stack([-m, m], axis=1)

    def _raw_to_probability(self, raw: np.ndarray) -> np.ndarray:
        p1 = 1.0 / (1.0 + np.exp(-2.0 * raw[:, 1]))
        return np.stack([1.0 - p1, p1], axis=1)

    def _raw_to_prediction(self, raw: np.ndarray) -> np.ndarray:
        return (raw[:, 1] > 0).astype(np.float64)

    def _save_data(self, path: str) -> None:
        arrs = {"gbt_weights": self._tree_weights,
                "gbt_n": np.array(len(self._forests))}
        for i, fo in enumerate(self._forests):
            arrs.update({f"t{i}_{k}": v for k, v in fo.to_arrays().items()})
        save_arrays(path, **arrs)

    def _load_data(self, path: str, meta) -> None:
        a = load_arrays(path)
        self._tree_weights = a["gbt_weights"]
        n = int(a["gbt_n"])
        self._forests = [
            ForestData.from_arrays(
                {k[len(f"t{i}_"):]: v for k, v in a.items()
                 if k.startswith(f"t{i}_")})
            for i in range(n)]
