"""Tree-based regressors: DecisionTree, RandomForest, GBT, the port of the
reference's ``ml/regression/trees.py`` (ref: ml/regression/DecisionTreeRegressor.scala,
RandomForestRegressor.scala, GBTRegressor.scala — SquaredError/AbsoluteError
losses from mllib/tree/loss). Same dense histogram engine as the
classifiers."""

from __future__ import annotations

from typing import Optional

import numpy as np

from cycloneml_tpu_torch.dataset.frame import MLFrame
from cycloneml_tpu_torch.ml.base import PredictionModel, Predictor
from cycloneml_tpu_torch.ml.classification.trees import _boost, _prepare
from cycloneml_tpu_torch.ml.tree import (
    ForestConfig, ForestData, _DecisionTreeParams, _GBTParams,
    _RandomForestParams, grow_forest,
)
from cycloneml_tpu_torch.ml.util_io import MLReadable, MLWritable, load_arrays, save_arrays


class _TreeRegressorModelBase(PredictionModel):
    _forest: ForestData

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

    def _predict_batch(self, x: np.ndarray) -> np.ndarray:
        raw = self._forest.predict_raw(np.asarray(x, dtype=np.float64))[:, 0]
        if self._forest.num_trees > 1:
            raw = raw / self._forest.tree_weights.sum()   # forest averages
        return raw

    def _save_data(self, path: str) -> None:
        save_arrays(path, **self._forest.to_arrays())

    def _load_data(self, path: str, meta) -> None:
        self._forest = ForestData.from_arrays(load_arrays(path))


class DecisionTreeRegressor(Predictor, _DecisionTreeParams, MLWritable, MLReadable):
    """ref: ml/regression/DecisionTreeRegressor.scala:44."""

    def __init__(self, uid=None, **kwargs):
        super().__init__(uid)
        self._declare_tree_params(["variance"], "variance")
        for k, v in kwargs.items():
            self.set(k, v)

    def _fit(self, frame: MLFrame) -> "DecisionTreeRegressionModel":
        binned, y, w = _prepare(self, frame)
        cfg = ForestConfig(
            task="regression", impurity="variance",
            max_depth=self.get("maxDepth"),
            min_instances_per_node=self.get("minInstancesPerNode"),
            min_weight_fraction_per_node=self.get("minWeightFractionPerNode"),
            min_info_gain=self.get("minInfoGain"), num_trees=1,
            feature_subset_strategy="all", subsampling_rate=1.0,
            bootstrap=False, seed=self.get("seed"))
        m = DecisionTreeRegressionModel(grow_forest(binned, y, w, cfg))
        self._copy_values(m)
        return m


class DecisionTreeRegressionModel(_TreeRegressorModelBase, _DecisionTreeParams,
                                  MLWritable, MLReadable):
    def __init__(self, forest: Optional[ForestData] = None, uid=None):
        super().__init__(uid)
        self._declare_tree_params(["variance"], "variance")
        self._forest = forest

    @property
    def depth(self) -> int:
        return self._forest.tree_depth(0)

    @property
    def num_nodes(self) -> int:
        return int(self._forest.n_nodes[0])


class RandomForestRegressor(Predictor, _RandomForestParams, MLWritable, MLReadable):
    """ref: ml/regression/RandomForestRegressor.scala:46."""

    def __init__(self, uid=None, **kwargs):
        super().__init__(uid)
        self._declare_tree_params(["variance"], "variance")
        self._declare_rf_params()
        for k, v in kwargs.items():
            self.set(k, v)

    def _fit(self, frame: MLFrame) -> "RandomForestRegressionModel":
        binned, y, w = _prepare(self, frame)
        cfg = ForestConfig(
            task="regression", impurity="variance",
            max_depth=self.get("maxDepth"),
            min_instances_per_node=self.get("minInstancesPerNode"),
            min_weight_fraction_per_node=self.get("minWeightFractionPerNode"),
            min_info_gain=self.get("minInfoGain"),
            num_trees=self.get("numTrees"),
            feature_subset_strategy=self.get("featureSubsetStrategy"),
            subsampling_rate=self.get("subsamplingRate"),
            bootstrap=self.get("bootstrap"), seed=self.get("seed"))
        m = RandomForestRegressionModel(grow_forest(binned, y, w, cfg))
        self._copy_values(m)
        return m


class RandomForestRegressionModel(_TreeRegressorModelBase, _RandomForestParams,
                                  MLWritable, MLReadable):
    def __init__(self, forest: Optional[ForestData] = None, uid=None):
        super().__init__(uid)
        self._declare_tree_params(["variance"], "variance")
        self._declare_rf_params()
        self._forest = forest

    @property
    def num_trees(self) -> int:
        return self._forest.num_trees


class GBTRegressor(Predictor, _GBTParams, MLWritable, MLReadable):
    """ref: ml/regression/GBTRegressor.scala:52 — squared loss
    (neg. gradient 2(y−F)) or absolute loss (sign(y−F))."""

    def __init__(self, uid=None, **kwargs):
        super().__init__(uid)
        self._declare_tree_params(["variance"], "variance")
        self._declare_gbt_params(["squared", "absolute"], "squared")
        for k, v in kwargs.items():
            self.set(k, v)

    def _fit(self, frame: MLFrame) -> "GBTRegressionModel":
        binned, y, w = _prepare(self, frame)
        if self.get("lossType") == "absolute":
            neg_grad = lambda f: np.sign(y - f)  # noqa: E731
        else:
            neg_grad = lambda f: 2.0 * (y - f)   # noqa: E731
        forests, weights = _boost(self, binned, w, first_target=y,
                                  neg_gradient=neg_grad)
        m = GBTRegressionModel(forests, np.array(weights))
        self._copy_values(m)
        return m


class GBTRegressionModel(PredictionModel, _GBTParams, MLWritable, MLReadable):
    def __init__(self, forests=None, tree_weights: Optional[np.ndarray] = None,
                 uid=None):
        super().__init__(uid)
        self._declare_tree_params(["variance"], "variance")
        self._declare_gbt_params(["squared", "absolute"], "squared")
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
    def feature_importances(self) -> np.ndarray:
        imp = np.zeros(self.num_features)
        for fo in self._forests:
            imp += fo.feature_importances()
        s = imp.sum()
        return imp / s if s > 0 else imp

    def _predict_batch(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        f = np.zeros(x.shape[0])
        for fo, tw in zip(self._forests, self._tree_weights):
            f += tw * fo.predict_raw(x)[:, 0]
        return f

    def _save_data(self, path: str) -> None:
        arrs = {"gbt_weights": self._tree_weights,
                "gbt_n": np.array(len(self._forests))}
        for i, fo in enumerate(self._forests):
            arrs.update({f"t{i}_{k}": v for k, v in fo.to_arrays().items()})
        save_arrays(path, **arrs)

    def _load_data(self, path: str, meta) -> None:
        a = load_arrays(path)
        self._tree_weights = a["gbt_weights"]
        self._forests = [
            ForestData.from_arrays(
                {k[len(f"t{i}_"):]: v for k, v in a.items()
                 if k.startswith(f"t{i}_")})
            for i in range(int(a["gbt_n"]))]
