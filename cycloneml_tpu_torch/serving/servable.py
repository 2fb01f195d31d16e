"""The model-abstraction layer: fitted estimators as servable programs.

The port's counterpart of ``cycloneml_tpu/serving/servable.py``. A
servable exposes (a) its parameters, which the serving lane places on the
device once and binds into its bucket programs, and (b) a host-side
postprocessing step that reuses the fitted model's own numpy
link/threshold code (``_raw_to_prediction``), keeping serving semantics
those of ``model.predict``.

The margins are computed by ``ops/kernels.serving_margins``
(``csrc/serving_margins.cu`` on the card, its plain twin on the CPU): each
margin summed in an order that depends on neither the bucket, the
number of models nor the kernel's tile, so that zero-padding is numerically invisible and a
gang of K homogeneous servables, stacked on a leading model axis, gives
per-row results bitwise equal to K serial lanes.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import numpy as np
import torch

_TORCH_DTYPE = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}


def serving_dtype(conf=None) -> np.dtype:
    """Resolve ``cyclone.serving.dtype``: 'auto' means the accumulator
    tier, ``cyclone.compute.dtype`` (float32 by default). Request batches
    never ride the bf16 data tier: serving is latency-bound, not
    bandwidth-bound.

    An explicit 'float64' is honoured on the card and on the CPU. (The
    reference downgrades it to float32 without jax x64, where XLA would
    narrow float64 arguments silently; torch computes what it is given.)
    """
    from cycloneml_tpu_torch.conf import COMPUTE_DTYPE, SERVING_DTYPE
    name = "auto"
    if conf is not None:
        name = str(conf.get(SERVING_DTYPE))
    if name == "auto":
        name = str(conf.get(COMPUTE_DTYPE)) if conf is not None \
            else "float32"
    return np.dtype(name)


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a serving dtype (float32 or float64, numpy or
    torch)."""
    if isinstance(dtype, torch.dtype):
        if dtype in _TORCH_DTYPE.values():
            return dtype
    elif np.dtype(dtype) in _TORCH_DTYPE:
        return _TORCH_DTYPE[np.dtype(dtype)]
    raise ValueError(f"serving computes in float32 or float64, not {dtype}")


def _quantize_rows(coef, icpt, dtype
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-margin-row fp8 quantization of a coefficient tensor: e4m3
    codes, and scales and intercepts at the serving ``dtype`` (numpy or
    torch). Works on (Km, d) (serial) and (K, Km, d) (gang) tensors; the
    scale is per last-but-one axis row, ``absmax / FP8_MAX`` (1.0 for an
    all-zero row, so every code is finite). The codes are rounded from
    float64 directly (no double rounding through float32), bit for bit
    the reference's ``ml_dtypes`` codes."""
    from cycloneml_tpu_torch.dataset.instance import FP8_MAX
    dt = torch_dtype(dtype)
    c = torch.as_tensor(np.asarray(coef, dtype=np.float64))
    absmax = c.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / FP8_MAX,
                        torch.ones((), dtype=torch.float64))
    codes = (c / scale[..., None]).to(torch.float8_e4m3fn)
    return (codes, scale.to(dt),
            torch.as_tensor(np.asarray(icpt, dtype=np.float64)).to(dt))


class Servable:
    """One fitted model behind the serving interface.

    ``raw_format`` maps margins back into the model's raw-prediction
    convention so the model's own numpy postprocessing runs unchanged:
    ``pair`` (binary margin m -> raw (-m, m): logistic, SVC),
    ``identity`` (multinomial margins are the raw), ``scalar``
    (regression: the margin is the prediction).
    """

    def __init__(self, model: Any, coef: np.ndarray, icpt: np.ndarray,
                 raw_format: str):
        if raw_format not in ("pair", "identity", "scalar"):
            raise ValueError(f"unknown raw_format {raw_format!r}")
        self.model = model
        self._coef = np.atleast_2d(np.asarray(coef, dtype=np.float64))
        self._icpt = np.atleast_1d(np.asarray(icpt, dtype=np.float64))
        if self._icpt.shape[0] != self._coef.shape[0]:
            raise ValueError("coefficient rows and intercepts disagree")
        self.raw_format = raw_format

    @property
    def n_features(self) -> int:
        return self._coef.shape[1]

    @property
    def n_margins(self) -> int:
        return self._coef.shape[0]

    @property
    def signature(self) -> Tuple:
        """Homogeneity class: gangs require identical signatures."""
        return (type(self.model).__name__, self.raw_format,
                self.n_margins, self.n_features)

    def params(self, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        """(coef (Km, d), icpt (Km,)) at the serving ``dtype``, host
        tensors the lane places on its device."""
        dt = torch_dtype(dtype)
        return (torch.as_tensor(self._coef).to(dt),
                torch.as_tensor(self._icpt).to(dt))

    def quantized_params(self, dtype):
        """(codes, scale, icpt) for the quantized predict tier: e4m3 codes
        with one scale a margin row, scale and icpt at the serving dtype
        (:func:`_quantize_rows`). Intercepts stay wide: they are O(Km)
        and additive."""
        return _quantize_rows(self._coef, self._icpt, dtype)

    def margins_to_raw(self, margins: np.ndarray) -> np.ndarray:
        if self.raw_format == "pair":
            m = margins[:, 0]
            return np.stack([-m, m], axis=1)
        return margins

    def postprocess(self, margins: np.ndarray) -> np.ndarray:
        """Margins (n, Km) -> final predictions (n,), via the fitted
        model's own numpy link/threshold code."""
        if self.raw_format == "scalar":
            return margins[:, 0]
        return self.model._raw_to_prediction(self.margins_to_raw(margins))

    def host_margins(self, x: np.ndarray) -> np.ndarray:
        """Host numpy margins in float64: the parity baseline."""
        return x.astype(np.float64) @ self._coef.T + self._icpt[None, :]


class GangServable:
    """K homogeneous servables served by one kernel launch a batch."""

    def __init__(self, members: Sequence[Servable]):
        members = list(members)
        if not members:
            raise ValueError("a gang needs at least one model")
        sig = members[0].signature
        for m in members[1:]:
            if m.signature != sig:
                raise ValueError(
                    f"gang members must be homogeneous: {m.signature} != "
                    f"{sig} (same model type, raw format, classes and "
                    f"feature count)")
        self.members: List[Servable] = members
        self._coefs = np.stack([m._coef for m in members])   # (K, Km, d)
        self._icpts = np.stack([m._icpt for m in members])   # (K, Km)

    @property
    def n_models(self) -> int:
        return len(self.members)

    @property
    def n_features(self) -> int:
        return self.members[0].n_features

    @property
    def n_margins(self) -> int:
        return self.members[0].n_margins

    @property
    def signature(self) -> Tuple:
        return ("gang", self.n_models) + self.members[0].signature

    def params(self, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        dt = torch_dtype(dtype)
        return (torch.as_tensor(self._coefs).to(dt),
                torch.as_tensor(self._icpts).to(dt))

    def quantized_params(self, dtype):
        """(codes (K, Km, d), scales (K, Km), icpts (K, Km)): the gang
        form of :meth:`Servable.quantized_params`."""
        return _quantize_rows(self._coefs, self._icpts, dtype)

    def postprocess(self, margins: np.ndarray) -> List[np.ndarray]:
        """Stacked margins (K, n, Km) -> per-model predictions [(n,), ...]
        through each member's own postprocessing."""
        return [m.postprocess(margins[k])
                for k, m in enumerate(self.members)]


def as_servable(model: Any) -> Servable:
    """Adapt a fitted estimator to the serving interface.

    Linear-form models are supported: LogisticRegressionModel (binomial
    and multinomial), LinearSVCModel, LinearRegressionModel, and anything
    already wrapped as a :class:`Servable`.
    """
    if isinstance(model, (Servable, GangServable)):
        return model
    from cycloneml_tpu_torch.ml.classification.linear_svc import (
        LinearSVCModel,
    )
    from cycloneml_tpu_torch.ml.classification.logistic_regression import (
        LogisticRegressionModel,
    )
    from cycloneml_tpu_torch.ml.regression.linear_regression import (
        LinearRegressionModel,
    )
    if isinstance(model, LogisticRegressionModel):
        if model._is_multinomial:
            return Servable(model, model._coef, model._icpt, "identity")
        return Servable(model, model._coef[0], model._icpt[:1], "pair")
    if isinstance(model, LinearSVCModel):
        return Servable(model, model._coef, [model._icpt], "pair")
    if isinstance(model, LinearRegressionModel):
        return Servable(model, model._coef, [model._icpt], "scalar")
    raise TypeError(
        f"no servable adapter for {type(model).__name__}; supported: "
        f"LogisticRegressionModel, LinearSVCModel, LinearRegressionModel, "
        f"or a prebuilt Servable")
