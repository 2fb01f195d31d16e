"""Evaluators."""
from cycloneml_tpu_torch.ml.evaluation.evaluators import (
    BinaryClassificationEvaluator, Evaluator,
    MulticlassClassificationEvaluator, RegressionEvaluator,
)

__all__ = ["Evaluator", "BinaryClassificationEvaluator",
           "MulticlassClassificationEvaluator", "RegressionEvaluator"]
