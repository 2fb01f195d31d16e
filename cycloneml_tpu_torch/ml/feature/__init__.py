"""Feature transformers — the port of ``cycloneml_tpu/ml/feature/``: every
name of the reference's ``__all__`` but ``SQLTransformer``, whose SQL
engine is ROADMAP Queue 1 item 12's (``formula.SQLTransformer`` raises
naming it)."""
from cycloneml_tpu_torch.ml.feature.scalers import (
    StandardScaler, StandardScalerModel, MinMaxScaler, MinMaxScalerModel,
    MaxAbsScaler, MaxAbsScalerModel, RobustScaler, RobustScalerModel,
    Normalizer,
)
from cycloneml_tpu_torch.ml.feature.transforms import (
    Binarizer, Bucketizer, ElementwiseProduct, PolynomialExpansion, DCT,
    VectorAssembler, VectorSlicer, VectorSizeHint, Interaction,
    QuantileDiscretizer, Imputer, ImputerModel,
)
from cycloneml_tpu_torch.ml.feature.text import (
    Tokenizer, RegexTokenizer, StopWordsRemover, NGram, HashingTF, IDF,
    IDFModel, CountVectorizer, CountVectorizerModel, FeatureHasher,
)
from cycloneml_tpu_torch.ml.feature.indexers import (
    StringIndexer, StringIndexerModel, IndexToString, OneHotEncoder,
    OneHotEncoderModel, VectorIndexer, VectorIndexerModel,
)
from cycloneml_tpu_torch.ml.feature.selectors import (
    ChiSqSelector, ChiSqSelectorModel, VarianceThresholdSelector,
    VarianceThresholdSelectorModel, UnivariateFeatureSelector,
    UnivariateFeatureSelectorModel,
)
from cycloneml_tpu_torch.ml.feature.pca import PCA, PCAModel
from cycloneml_tpu_torch.ml.feature.lsh import (
    MinHashLSH, MinHashLSHModel, BucketedRandomProjectionLSH,
    BucketedRandomProjectionLSHModel,
)
from cycloneml_tpu_torch.ml.feature.word2vec import Word2Vec, Word2VecModel
from cycloneml_tpu_torch.ml.feature.formula import RFormula, RFormulaModel

__all__ = [
    "StandardScaler", "StandardScalerModel", "MinMaxScaler", "MinMaxScalerModel",
    "MaxAbsScaler", "MaxAbsScalerModel", "RobustScaler", "RobustScalerModel",
    "Normalizer", "Binarizer", "Bucketizer", "ElementwiseProduct",
    "PolynomialExpansion", "DCT", "VectorAssembler", "VectorSlicer",
    "VectorSizeHint", "Interaction", "QuantileDiscretizer", "Imputer",
    "ImputerModel", "Tokenizer", "RegexTokenizer", "StopWordsRemover", "NGram",
    "HashingTF", "IDF", "IDFModel", "CountVectorizer", "CountVectorizerModel",
    "FeatureHasher", "StringIndexer", "StringIndexerModel", "IndexToString",
    "OneHotEncoder", "OneHotEncoderModel", "VectorIndexer", "VectorIndexerModel",
    "ChiSqSelector", "ChiSqSelectorModel", "VarianceThresholdSelector",
    "VarianceThresholdSelectorModel", "UnivariateFeatureSelector",
    "UnivariateFeatureSelectorModel", "PCA", "PCAModel", "MinHashLSH",
    "MinHashLSHModel", "BucketedRandomProjectionLSH",
    "BucketedRandomProjectionLSHModel", "Word2Vec", "Word2VecModel",
    "RFormula", "RFormulaModel",
]
