"""Classifiers."""
from cycloneml_tpu_torch.ml.classification.logistic_regression import (
    LogisticRegression, LogisticRegressionModel,
    LogisticRegressionTrainingSummary,
)

__all__ = ["LogisticRegression", "LogisticRegressionModel",
           "LogisticRegressionTrainingSummary"]
