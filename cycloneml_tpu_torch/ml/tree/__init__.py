"""Tree-ensemble engine shared by the classification and regression
estimators (ref: ml/tree/ — the impl/ package and treeParams.scala)."""

from cycloneml_tpu_torch.ml.tree.impl import (
    BinnedDataset, ForestConfig, ForestData, find_splits, grow_forest,
)
from cycloneml_tpu_torch.ml.tree.params import (
    _DecisionTreeParams, _GBTParams, _RandomForestParams, _TreeEnsembleParams,
)

__all__ = [
    "BinnedDataset", "ForestConfig", "ForestData", "find_splits",
    "grow_forest", "_DecisionTreeParams", "_GBTParams", "_RandomForestParams",
    "_TreeEnsembleParams",
]
