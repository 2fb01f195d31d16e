"""Evaluators."""
from cycloneml_tpu_torch.ml.evaluation.evaluators import (
    BinaryClassificationEvaluator, Evaluator,
    MulticlassClassificationEvaluator,
)

__all__ = ["Evaluator", "BinaryClassificationEvaluator",
           "MulticlassClassificationEvaluator"]
