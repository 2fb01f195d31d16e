"""Classifiers."""
from cycloneml_tpu_torch.ml.classification.logistic_regression import (
    LogisticRegression, LogisticRegressionModel,
    LogisticRegressionTrainingSummary,
)
from cycloneml_tpu_torch.ml.classification.one_vs_rest import (
    OneVsRest, OneVsRestModel,
)

__all__ = ["LogisticRegression", "LogisticRegressionModel",
           "LogisticRegressionTrainingSummary", "OneVsRest",
           "OneVsRestModel"]
