"""Regressors."""
from cycloneml_tpu_torch.ml.regression.linear_regression import (
    LinearRegression, LinearRegressionModel,
    LinearRegressionTrainingSummary,
)

__all__ = ["LinearRegression", "LinearRegressionModel",
           "LinearRegressionTrainingSummary"]
