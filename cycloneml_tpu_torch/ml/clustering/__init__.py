"""Clustering."""
from cycloneml_tpu_torch.ml.clustering.kmeans import KMeans, KMeansModel

__all__ = ["KMeans", "KMeansModel"]
