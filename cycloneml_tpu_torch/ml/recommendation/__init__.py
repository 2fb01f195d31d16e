"""Recommendation."""
from cycloneml_tpu_torch.ml.recommendation.als import ALS, ALSModel

__all__ = ["ALS", "ALSModel"]
