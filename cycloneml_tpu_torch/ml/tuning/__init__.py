"""Model selection: parameter grids, cross-validation, train/validation
split."""
from cycloneml_tpu_torch.ml.tuning.tuning import (
    CrossValidator, CrossValidatorModel, ParamGridBuilder,
    TrainValidationSplit, TrainValidationSplitModel,
)

__all__ = ["ParamGridBuilder", "CrossValidator", "CrossValidatorModel",
           "TrainValidationSplit", "TrainValidationSplitModel"]
