"""Regressors."""
from cycloneml_tpu_torch.ml.regression.glm import (
    GeneralizedLinearRegression, GeneralizedLinearRegressionModel,
    GLMTrainingSummary,
)
from cycloneml_tpu_torch.ml.regression.linear_regression import (
    LinearRegression, LinearRegressionModel,
    LinearRegressionTrainingSummary,
)

__all__ = ["GeneralizedLinearRegression", "GeneralizedLinearRegressionModel",
           "GLMTrainingSummary", "LinearRegression", "LinearRegressionModel",
           "LinearRegressionTrainingSummary"]
