"""Classifiers."""
from cycloneml_tpu_torch.ml.classification.fm import (
    FMClassificationModel, FMClassifier,
)
from cycloneml_tpu_torch.ml.classification.linear_svc import (
    LinearSVC, LinearSVCModel,
)
from cycloneml_tpu_torch.ml.classification.logistic_regression import (
    BinaryLogisticRegressionSummary, LogisticRegression,
    LogisticRegressionModel, LogisticRegressionTrainingSummary,
)
from cycloneml_tpu_torch.ml.classification.mlp import (
    MultilayerPerceptronClassificationModel, MultilayerPerceptronClassifier,
)
from cycloneml_tpu_torch.ml.classification.naive_bayes import (
    NaiveBayes, NaiveBayesModel,
)
from cycloneml_tpu_torch.ml.classification.one_vs_rest import (
    OneVsRest, OneVsRestModel,
)
from cycloneml_tpu_torch.ml.classification.trees import (
    DecisionTreeClassificationModel, DecisionTreeClassifier,
    GBTClassificationModel, GBTClassifier, RandomForestClassificationModel,
    RandomForestClassifier,
)

__all__ = ["BinaryLogisticRegressionSummary",
           "DecisionTreeClassificationModel", "DecisionTreeClassifier",
           "FMClassificationModel", "FMClassifier", "GBTClassificationModel",
           "GBTClassifier", "LinearSVC", "LinearSVCModel",
           "LogisticRegression", "LogisticRegressionModel",
           "LogisticRegressionTrainingSummary",
           "MultilayerPerceptronClassificationModel",
           "MultilayerPerceptronClassifier", "NaiveBayes", "NaiveBayesModel",
           "OneVsRest", "OneVsRestModel", "RandomForestClassificationModel",
           "RandomForestClassifier"]
