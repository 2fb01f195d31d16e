"""Clustering."""
from cycloneml_tpu_torch.ml.clustering.kmeans import KMeans, KMeansModel
from cycloneml_tpu_torch.ml.clustering.gaussian_mixture import (
    GaussianMixture, GaussianMixtureModel, MultivariateGaussian,
)
from cycloneml_tpu_torch.ml.clustering.bisecting_kmeans import (
    BisectingKMeans, BisectingKMeansModel,
)
from cycloneml_tpu_torch.ml.clustering.power_iteration import PowerIterationClustering
from cycloneml_tpu_torch.ml.clustering.lda import LDA, LDAModel

__all__ = [
    "KMeans", "KMeansModel",
    "GaussianMixture", "GaussianMixtureModel", "MultivariateGaussian",
    "BisectingKMeans", "BisectingKMeansModel",
    "PowerIterationClustering",
    "LDA", "LDAModel",
]
