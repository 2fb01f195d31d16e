"""Regressors."""
from cycloneml_tpu_torch.ml.regression.aft import (
    AFTSurvivalRegression, AFTSurvivalRegressionModel,
)
from cycloneml_tpu_torch.ml.regression.fm import FMRegressionModel, FMRegressor
from cycloneml_tpu_torch.ml.regression.glm import (
    GeneralizedLinearRegression, GeneralizedLinearRegressionModel,
    GLMTrainingSummary,
)
from cycloneml_tpu_torch.ml.regression.isotonic import (
    IsotonicRegression, IsotonicRegressionModel,
)
from cycloneml_tpu_torch.ml.regression.linear_regression import (
    LinearRegression, LinearRegressionModel,
    LinearRegressionTrainingSummary,
)
from cycloneml_tpu_torch.ml.regression.trees import (
    DecisionTreeRegressionModel, DecisionTreeRegressor, GBTRegressionModel,
    GBTRegressor, RandomForestRegressionModel, RandomForestRegressor,
)

__all__ = ["AFTSurvivalRegression", "AFTSurvivalRegressionModel",
           "DecisionTreeRegressionModel", "DecisionTreeRegressor",
           "FMRegressionModel", "FMRegressor", "GBTRegressionModel",
           "GBTRegressor", "GeneralizedLinearRegression",
           "GeneralizedLinearRegressionModel", "GLMTrainingSummary",
           "IsotonicRegression", "IsotonicRegressionModel",
           "LinearRegression", "LinearRegressionModel",
           "LinearRegressionTrainingSummary", "RandomForestRegressionModel",
           "RandomForestRegressor"]
