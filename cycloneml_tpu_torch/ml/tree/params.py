"""Shared tree params, the port's copy of the reference's ``ml/tree/params.py``
(ref: ml/tree/treeParams.scala — DecisionTreeParams, TreeEnsembleParams,
RandomForestParams, GBTParams): the same names, docs, defaults and
validators."""

from __future__ import annotations

from cycloneml_tpu_torch.ml.param import ParamValidators as V
from cycloneml_tpu_torch.ml.shared import HasSeed


class _DecisionTreeParams(HasSeed):
    def _declare_tree_params(self, impurity_allowed, impurity_default):
        self._p_seed(17)
        self.maxDepth = self._param(
            "maxDepth", "maximum tree depth (>= 0); depth 0 is one leaf",
            V.in_range(0, 30), default=5)
        self.maxBins = self._param(
            "maxBins", "max number of bins for discretizing continuous "
            "features (>= 2)", V.gt_eq(2), default=32)
        self.minInstancesPerNode = self._param(
            "minInstancesPerNode", "minimum number of instances each child "
            "must have after split (>= 1)", V.gt_eq(1), default=1)
        self.minWeightFractionPerNode = self._param(
            "minWeightFractionPerNode", "minimum fraction of the weighted "
            "sample count each child must have after split",
            V.in_range(0.0, 0.5, True, False), default=0.0)
        self.minInfoGain = self._param(
            "minInfoGain", "minimum information gain for a split",
            V.gt_eq(0.0), default=0.0)
        self.maxMemoryInMB = self._param(
            "maxMemoryInMB", "memory budget for histogram aggregation "
            "(accepted for API parity; the dense engine sizes itself)",
            V.gt_eq(0), default=256)
        self.cacheNodeIds = self._param(
            "cacheNodeIds", "node-id caching (always on: assignments live "
            "on device)", default=False)
        self.checkpointInterval = self._param(
            "checkpointInterval", "checkpoint interval for node-id cache",
            default=10)
        self.impurity = self._param(
            "impurity", "impurity criterion", V.in_array(impurity_allowed),
            default=impurity_default)

    def set_max_depth(self, v):
        return self.set("maxDepth", v)

    def set_max_bins(self, v):
        return self.set("maxBins", v)

    def set_min_instances_per_node(self, v):
        return self.set("minInstancesPerNode", v)

    def set_min_info_gain(self, v):
        return self.set("minInfoGain", v)

    def set_impurity(self, v):
        return self.set("impurity", v)

    def set_seed(self, v):
        return self.set("seed", v)


class _TreeEnsembleParams(_DecisionTreeParams):
    def _declare_ensemble_params(self, subset_default):
        self.subsamplingRate = self._param(
            "subsamplingRate", "fraction of training data per tree",
            V.in_range(0.0, 1.0, False, True), default=1.0)
        self.featureSubsetStrategy = self._param(
            "featureSubsetStrategy", "features to consider per split: auto, "
            "all, onethird, sqrt, log2, n (int), or fraction (0,1]",
            default=subset_default)

    def set_subsampling_rate(self, v):
        return self.set("subsamplingRate", v)

    def set_feature_subset_strategy(self, v):
        return self.set("featureSubsetStrategy", v)


class _RandomForestParams(_TreeEnsembleParams):
    def _declare_rf_params(self):
        self._declare_ensemble_params("auto")
        self.numTrees = self._param(
            "numTrees", "number of trees (>= 1)", V.gt_eq(1), default=20)
        self.bootstrap = self._param(
            "bootstrap", "whether to bootstrap-sample rows per tree",
            default=True)

    def set_num_trees(self, v):
        return self.set("numTrees", v)

    def set_bootstrap(self, v):
        return self.set("bootstrap", v)


class _GBTParams(_TreeEnsembleParams):
    def _declare_gbt_params(self, loss_allowed, loss_default):
        self._declare_ensemble_params("all")
        self.maxIter = self._param(
            "maxIter", "number of boosting rounds (>= 0)", V.gt_eq(0),
            default=20)
        self.stepSize = self._param(
            "stepSize", "learning rate in (0, 1]",
            V.in_range(0.0, 1.0, False, True), default=0.1)
        self.lossType = self._param(
            "lossType", "loss function", V.in_array(loss_allowed),
            default=loss_default)
        self.validationTol = self._param(
            "validationTol", "early-stopping tolerance on validation error",
            V.gt_eq(0.0), default=0.01)

    def set_max_iter(self, v):
        return self.set("maxIter", v)

    def set_step_size(self, v):
        return self.set("stepSize", v)

    def set_loss_type(self, v):
        return self.set("lossType", v)
