"""Classifiers."""
from cycloneml_tpu_torch.ml.classification.linear_svc import (
    LinearSVC, LinearSVCModel,
)
from cycloneml_tpu_torch.ml.classification.logistic_regression import (
    BinaryLogisticRegressionSummary, LogisticRegression,
    LogisticRegressionModel, LogisticRegressionTrainingSummary,
)
from cycloneml_tpu_torch.ml.classification.one_vs_rest import (
    OneVsRest, OneVsRestModel,
)

__all__ = ["BinaryLogisticRegressionSummary", "LinearSVC", "LinearSVCModel", "LogisticRegression",
           "LogisticRegressionModel", "LogisticRegressionTrainingSummary",
           "OneVsRest", "OneVsRestModel"]
