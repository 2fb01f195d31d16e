"""Feature transformers."""
from cycloneml_tpu_torch.ml.feature.pca import PCA, PCAModel

__all__ = ["PCA", "PCAModel"]
