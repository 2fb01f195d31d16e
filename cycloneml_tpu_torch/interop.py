"""Carrying state across from the reference package, through numpy only.

The port never imports ``cycloneml_tpu`` (or jax); what crosses between the
two packages is plain numpy: the same host arrays as a dataset, a fitted
model's coefficients, or an optimizer state's ``to_pytree()`` dict.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from cycloneml_tpu_torch.context import CycloneContext
from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
from cycloneml_tpu_torch.ml.classification.logistic_regression import (
    LogisticRegressionModel,
)
from cycloneml_tpu_torch.ml.optim.lbfgs import OptimState


def dataset_from_numpy(x, y=None, w=None, ctx: Optional[CycloneContext] = None,
                       dtype=None) -> InstanceDataset:
    """Host arrays (the same ones handed to the reference) as an
    :class:`InstanceDataset` of the given (default: active) context."""
    ctx = ctx if ctx is not None else CycloneContext.get_or_create()
    return InstanceDataset.from_numpy(ctx, np.asarray(x), y, w, dtype=dtype)


def model_from_reference(coefficients, intercept,
                         **params) -> LogisticRegressionModel:
    """A binomial model from a reference ``LogisticRegressionModel``'s
    ``coefficients`` (d,) and ``intercept``; ``params`` (e.g.
    ``threshold``) are set on the new model."""
    coef = np.asarray(coefficients, dtype=np.float64).reshape(1, -1)
    model = LogisticRegressionModel(
        coefficient_matrix=coef,
        intercept_vector=np.array([float(intercept)]), num_classes=2)
    for k, v in params.items():
        model.set(k, v)
    return model


def optim_state_from_pytree(d: dict) -> OptimState:
    """The port's :class:`OptimState` from the dict of a reference
    ``OptimState.to_pytree()`` (arrays become float64 numpy)."""
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
