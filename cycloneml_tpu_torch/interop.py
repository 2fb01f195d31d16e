"""Carrying state across from the reference package, through numpy only.

The port never imports ``cycloneml_tpu`` (or jax); what crosses between the
two packages is plain numpy: the same host arrays (or fp8 codes) as a
dataset, the same ELL (or hybrid) rows as a sparse dataset, a fitted
model's parameters (binomial and multinomial logistic regression, linear
regression, LinearSVC, GLM, KMeans, PCA, OneVsRest's binary models, ALS's
ids and factors; the trees' node tables, the MLP's layers and weights,
FM's factors, NaiveBayes' pi, theta and sigma, AFT's coefficients and
isotonic regression's boundaries; every fitted feature model's
state), a
stack of coefficients of K models, or an optimizer state's
``to_pytree()`` dict (L-BFGS and OWL-QN alike).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from cycloneml_tpu_torch.context import CycloneContext
from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
from cycloneml_tpu_torch.dataset.sparse import SparseInstanceDataset
from cycloneml_tpu_torch.ml.classification.linear_svc import LinearSVCModel
from cycloneml_tpu_torch.ml.classification.logistic_regression import (
    LogisticRegressionModel,
)
from cycloneml_tpu_torch.ml.classification.one_vs_rest import OneVsRestModel
from cycloneml_tpu_torch.ml.clustering.kmeans import KMeansModel
from cycloneml_tpu_torch.ml.feature.pca import PCAModel
from cycloneml_tpu_torch.ml.optim.lbfgs import OptimState
from cycloneml_tpu_torch.ml.recommendation.als import ALSModel
from cycloneml_tpu_torch.ml.regression.glm import (
    GeneralizedLinearRegressionModel,
)
from cycloneml_tpu_torch.ml.regression.linear_regression import (
    LinearRegressionModel,
)


def dataset_from_numpy(x, y=None, w=None, ctx: Optional[CycloneContext] = None,
                       dtype=None, x_scale=None,
                       probe_ratio=None) -> InstanceDataset:
    """Host arrays (the same ones handed to the reference) as an
    :class:`InstanceDataset` of the given (default: active) context.

    With ``x_scale`` given, ``x`` is a reference fp8 dataset's e4m3 codes
    (its real rows, as a 1-byte numpy array: ``np.asarray`` of its X, or a
    ``uint8`` view) and they come across bit for bit, with the scale and
    the probe ratio, so both packages fit the identical bytes."""
    ctx = ctx if ctx is not None else CycloneContext.get_or_create()
    if x_scale is not None:
        return InstanceDataset.from_fp8_codes(ctx, np.asarray(x), x_scale,
                                              y, w, probe_ratio)
    return InstanceDataset.from_numpy(ctx, np.asarray(x), y, w, dtype=dtype)


def sparse_dataset_from_reference(indices=None, values=None, y=None, w=None,
                                  n_features: Optional[int] = None,
                                  rows=None, k_ell: int = 16,
                                  ctx: Optional[CycloneContext] = None
                                  ) -> SparseInstanceDataset:
    """A :class:`SparseInstanceDataset` from the numpy arrays handed to the
    reference's sparse constructors: ``indices``/``values`` (n, k) as for its
    ``from_ell``, or ``rows`` ([(indices, values)]) and ``k_ell`` as for
    its ``from_rows_hybrid``; ``y``, ``w`` and ``n_features`` as there.
    Both packages then hold the identical float32 rows."""
    ctx = ctx if ctx is not None else CycloneContext.get_or_create()
    if rows is not None:
        return SparseInstanceDataset.from_rows_hybrid(
            ctx, rows, y, w, n_features=n_features, k_ell=k_ell)
    return SparseInstanceDataset.from_ell(ctx, np.asarray(indices),
                                          np.asarray(values), y, w,
                                          n_features=n_features)


def model_from_reference(coefficients, intercept,
                         **params) -> LogisticRegressionModel:
    """A binomial model from a reference ``LogisticRegressionModel``'s
    ``coefficients`` (d,) and ``intercept``; ``params`` (e.g.
    ``threshold``) are set on the new model."""
    coef = np.asarray(coefficients, dtype=np.float64).reshape(1, -1)
    model = LogisticRegressionModel(
        coefficient_matrix=coef,
        intercept_vector=np.array([float(intercept)]), num_classes=2)
    return _with_params(model, params)


def multinomial_model_from_reference(coefficient_matrix, intercept_vector,
                                    **params) -> LogisticRegressionModel:
    """A multinomial model from a reference ``LogisticRegressionModel``'s
    ``coefficient_matrix`` (k, d) (its ``to_array()``) and
    ``intercept_vector`` (k,)."""
    coef = np.asarray(coefficient_matrix, dtype=np.float64)
    model = LogisticRegressionModel(
        coefficient_matrix=coef,
        intercept_vector=np.asarray(intercept_vector,
                                    dtype=np.float64).ravel(),
        num_classes=coef.shape[0], is_multinomial=True)
    return _with_params(model, params)


def svc_model_from_reference(coefficients, intercept,
                             **params) -> LinearSVCModel:
    """A :class:`LinearSVCModel` from a reference model's ``coefficients``
    (d,) and ``intercept``; ``params`` (e.g. ``threshold``) are set on the
    new model."""
    return _with_params(LinearSVCModel(
        np.asarray(coefficients, dtype=np.float64), float(intercept)),
        params)


def glm_model_from_reference(coefficients, intercept,
                             **params) -> GeneralizedLinearRegressionModel:
    """A :class:`GeneralizedLinearRegressionModel` from a reference model's
    ``coefficients`` (d,) and ``intercept``; ``params`` (``family``,
    ``link``, ``variancePower``, ``linkPower``, ``offsetCol``,
    ``linkPredictionCol``) are set on the new model."""
    return _with_params(GeneralizedLinearRegressionModel(
        np.asarray(coefficients, dtype=np.float64), float(intercept)),
        params)


def coef_stack_from_reference(models) -> np.ndarray:
    """The ``(K, d + 1)`` float64 stack ``[coefficients, intercept]`` of K
    binomial models (a reference ``fit_stacked`` result, or any sequence
    of objects with ``coefficients`` and ``intercept``), the layout the
    stacked aggregators take."""
    return np.stack([np.concatenate([np.asarray(m.coefficients,
                                                dtype=np.float64).ravel(),
                                     [float(m.intercept)]])
                     for m in models])


def ovr_model_from_reference(models, **params) -> OneVsRestModel:
    """A :class:`OneVsRestModel` over the binary models of a reference
    ``OneVsRestModel`` (its ``models`` list), each carried by
    :func:`model_from_reference`; ``params`` are set on the new model."""
    return _with_params(OneVsRestModel(
        [model_from_reference(m.coefficients, m.intercept) for m in models]),
        params)


def _with_params(model, params: dict):
    for k, v in params.items():
        model.set(k, v)
    return model


def linear_model_from_reference(coefficients, intercept,
                                **params) -> LinearRegressionModel:
    """A :class:`LinearRegressionModel` from a reference model's
    ``coefficients`` (d,) and ``intercept``."""
    return _with_params(LinearRegressionModel(
        np.asarray(coefficients, dtype=np.float64), float(intercept)),
        params)


def kmeans_model_from_reference(centers, training_cost: float = 0.0,
                                num_iterations: int = 0,
                                **params) -> KMeansModel:
    """A :class:`KMeansModel` from a reference model's centers (k, d) (its
    ``cluster_centers`` rows or ``cluster_centers_matrix().to_array()``),
    training cost and iteration count; ``params`` (e.g.
    ``distanceMeasure``) are set on the new model."""
    model = KMeansModel(np.asarray(centers, dtype=np.float64),
                        training_cost=float(training_cost))
    model.num_iterations = int(num_iterations)
    model.set("k", model._centers.shape[0])
    return _with_params(model, params)


def pca_model_from_reference(pc, explained_variance, **params) -> PCAModel:
    """A :class:`PCAModel` from a reference model's ``pc`` (d, k) and
    ``explained_variance`` (k,)."""
    pc = np.asarray(pc, dtype=np.float64)
    model = PCAModel(pc, np.asarray(explained_variance, dtype=np.float64))
    model.set("k", pc.shape[1])
    return _with_params(model, params)


def als_model_from_reference(user_ids, item_ids, user_factors, item_factors,
                             **params) -> ALSModel:
    """An :class:`ALSModel` from a reference model's arrays (those its
    ``_save_data`` writes): the sorted raw ``user_ids`` and ``item_ids``
    and the float64 ``user_factors`` (n_users, rank) and ``item_factors``
    (n_items, rank); ``params`` (e.g. ``coldStartStrategy``) are set on the
    new model."""
    return _with_params(ALSModel(
        np.asarray(user_ids), np.asarray(item_ids),
        np.asarray(user_factors, dtype=np.float64),
        np.asarray(item_factors, dtype=np.float64)), params)


def optim_state_from_pytree(d: dict) -> OptimState:
    """The port's :class:`OptimState` from the dict of a reference
    ``OptimState.to_pytree()`` (arrays become float64 numpy), with the
    curvature pairs and OWL-QN's ``raw_grad``, so either optimizer resumes
    the reference's run exactly."""
    def f64(a):
        return np.asarray(a, dtype=np.float64)

    return OptimState(
        x=f64(d["x"]), value=float(d["value"]), grad=f64(d["grad"]),
        iteration=int(d["iteration"]),
        converged=bool(d.get("converged", False)),
        converged_reason=str(d.get("converged_reason", "")),
        loss_history=[float(v) for v in d["loss_history"]],
        hist_s=[f64(s) for s in d["hist_s"]],
        hist_y=[f64(y) for y in d["hist_y"]],
        raw_grad=(f64(d["raw_grad"]) if d.get("raw_grad") is not None
                  else None))


def _tree_model_class(name: str):
    import cycloneml_tpu_torch.ml.classification.trees as ct
    import cycloneml_tpu_torch.ml.regression.trees as rt
    cls = getattr(ct, name, None) or getattr(rt, name, None)
    if cls is None or not name.endswith("Model"):
        raise ValueError(f"{name!r} is not a tree model of the port")
    return cls


def forest_model_from_reference(model_class: str, arrays: dict,
                                num_classes: int = 2, **params):
    """A DecisionTree or RandomForest model of the port (``model_class``,
    e.g. ``"RandomForestClassificationModel"``) from a reference forest's
    ``ForestData.to_arrays()`` (the arrays its model saves), with
    ``num_classes`` for a classifier."""
    from cycloneml_tpu_torch.ml.tree import ForestData
    cls = _tree_model_class(model_class)
    forest = ForestData.from_arrays({k: np.asarray(v)
                                     for k, v in arrays.items()})
    model = (cls(forest, int(num_classes)) if forest.is_classification
             else cls(forest))
    return _with_params(model, params)


def gbt_model_from_reference(model_class: str, forests, tree_weights,
                             **params):
    """A GBT model of the port (``"GBTClassificationModel"`` or
    ``"GBTRegressionModel"``) from a reference model's trees, each as its
    ``ForestData.to_arrays()``, and its ``tree_weights``."""
    from cycloneml_tpu_torch.ml.tree import ForestData
    cls = _tree_model_class(model_class)
    fs = [ForestData.from_arrays({k: np.asarray(v) for k, v in a.items()})
          for a in forests]
    return _with_params(cls(fs, np.asarray(tree_weights, dtype=np.float64)),
                        params)


def mlp_model_from_reference(layers, weights, **params):
    """A :class:`MultilayerPerceptronClassificationModel` from a reference
    model's layer sizes and flat weight vector."""
    from cycloneml_tpu_torch.ml.classification.mlp import (
        MultilayerPerceptronClassificationModel)
    return _with_params(MultilayerPerceptronClassificationModel(
        [int(v) for v in layers], np.asarray(weights, dtype=np.float64)),
        params)


def fm_model_from_reference(factors, linear, intercept,
                            classification: bool = True, **params):
    """An FM classification (or regression) model from a reference
    model's factors (d, k), linear part (d,) and intercept."""
    from cycloneml_tpu_torch.ml.classification.fm import FMClassificationModel
    from cycloneml_tpu_torch.ml.regression.fm import FMRegressionModel
    cls = FMClassificationModel if classification else FMRegressionModel
    factors = np.asarray(factors, dtype=np.float64)
    model = cls(factors, np.asarray(linear, dtype=np.float64),
                float(intercept))
    model.set("factorSize", factors.shape[1])
    return _with_params(model, params)


def naive_bayes_model_from_reference(pi, theta, sigma=None,
                                     model_type: str = "multinomial",
                                     **params):
    """A :class:`NaiveBayesModel` from a reference model's pi (k,), theta
    (k, d) and sigma (gaussian's variances, else empty), of
    ``model_type``."""
    from cycloneml_tpu_torch.ml.classification.naive_bayes import (
        NaiveBayesModel)
    model = NaiveBayesModel(
        np.asarray(pi, dtype=np.float64), np.asarray(theta, dtype=np.float64),
        np.zeros((0, 0)) if sigma is None
        else np.asarray(sigma, dtype=np.float64))
    model.set("modelType", model_type)
    return _with_params(model, params)


def aft_model_from_reference(coefficients, intercept, scale, **params):
    """An :class:`AFTSurvivalRegressionModel` from a reference model's
    coefficients, intercept and scale."""
    from cycloneml_tpu_torch.ml.regression.aft import (
        AFTSurvivalRegressionModel)
    return _with_params(AFTSurvivalRegressionModel(
        np.asarray(coefficients, dtype=np.float64), float(intercept),
        float(scale)), params)


def isotonic_model_from_reference(boundaries, predictions, **params):
    """An :class:`IsotonicRegressionModel` from a reference model's
    boundaries and predictions."""
    from cycloneml_tpu_torch.ml.regression.isotonic import (
        IsotonicRegressionModel)
    return _with_params(IsotonicRegressionModel(
        np.asarray(boundaries, dtype=np.float64),
        np.asarray(predictions, dtype=np.float64)), params)


#: the state a fitted feature model carries, by class: the reference
#: model's attribute names, which the port's model keeps
_FEATURE_STATE = {
    "StandardScalerModel": ("mean", "std"),
    "MinMaxScalerModel": ("data_min", "data_max"),
    "MaxAbsScalerModel": ("max_abs",),
    "RobustScalerModel": ("median", "iqr"),
    "ImputerModel": ("fill_values",),
    "IDFModel": ("idf", "doc_freq", "num_docs"),
    "CountVectorizerModel": ("vocabulary",),
    "StringIndexerModel": ("labels",),
    "OneHotEncoderModel": ("category_sizes",),
    "VectorIndexerModel": ("num_features", "category_maps"),
    "ChiSqSelectorModel": ("selected",),
    "VarianceThresholdSelectorModel": ("selected",),
    "UnivariateFeatureSelectorModel": ("selected",),
    "BucketedRandomProjectionLSHModel": ("directions",),
    "MinHashLSHModel": ("coeff_a", "coeff_b"),
    "RFormulaModel": ("terms", "label", "categories", "label_categories"),
    "Word2VecModel": ("vocabulary", "vectors"),
}


def feature_model_from_reference(model_class: str, arrays: dict, **params):
    """A fitted feature model of the port (``model_class``, e.g.
    ``"StandardScalerModel"``) from a reference model's state: ``arrays``
    maps each of the reference model's state attributes (``mean`` and
    ``std`` of a StandardScalerModel, ``vocabulary`` and ``vectors`` of a
    Word2VecModel, ...; numpy arrays, lists, dicts or numbers) to its
    value, and ``params`` sets the model's params (its columns)."""
    import cycloneml_tpu_torch.ml.feature as feat
    state = _FEATURE_STATE.get(model_class)
    if state is None:
        raise ValueError(f"{model_class!r} is not a fitted feature model of "
                         f"the port; one of {sorted(_FEATURE_STATE)}")
    missing = [k for k in state if k not in arrays]
    if missing:
        raise ValueError(f"{model_class} needs {missing}")
    model = getattr(feat, model_class)()
    for k in state:
        v = arrays[k]
        setattr(model, k, np.array(v) if isinstance(v, np.ndarray) else v)
    if model_class == "StringIndexerModel":
        model.labels = [str(v) for v in model.labels]
        model._index = {t: i for i, t in enumerate(model.labels)}
    elif "vocabulary" in state:
        model.vocabulary = [str(v) for v in model.vocabulary]
        model._index = {t: i for i, t in enumerate(model.vocabulary)}
    return _with_params(model, params)
