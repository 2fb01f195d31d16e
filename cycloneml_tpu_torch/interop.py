"""Carrying state across from the reference package, through numpy only.

The port never imports ``cycloneml_tpu`` (or jax); what crosses between the
two packages is plain numpy: the same host arrays (or fp8 codes) as a
dataset, the same ELL (or hybrid) rows as a sparse dataset, a fitted
model's parameters (binomial and multinomial logistic regression, linear
regression, LinearSVC, GLM, KMeans, PCA, OneVsRest's binary models), a
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
