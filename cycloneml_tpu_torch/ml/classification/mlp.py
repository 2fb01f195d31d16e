"""Multilayer perceptron classifier, the port of the reference's
``ml/classification/mlp.py`` (ref: ml/classification/
MultilayerPerceptronClassifier.scala:93 over the ml/ann/ feed-forward stack
— sigmoid hidden layers + softmax output with cross-entropy, trained by
Breeze LBFGS or GD on one flat weight vector).

The loss of a row block is a block aggregator (:func:`mlp_aggregator`):
the layers' products on the dataset's device at the accumulator dtype,
the cross-entropy summed over row chunks and its gradient by
``torch.autograd`` (the reference's ``jax.grad``), summed by the port's
``DistributedLossFunction`` into the host ``LBFGS`` (or the plain GD
loop). The initial weights are the reference's Glorot draws from
``RandomState(seed)``.

Weight packing (persisted as one vector, as the reference's): per layer i,
W_i (fan_out × fan_in) row-major, then b_i.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from cycloneml_tpu_torch.dataset.frame import MLFrame
from cycloneml_tpu_torch.linalg.vectors import DenseVector, Vectors
from cycloneml_tpu_torch.ml.base import Predictor, ProbabilisticClassificationModel
from cycloneml_tpu_torch.ml.optim.aggregators import precision_scope
from cycloneml_tpu_torch.ml.optim.lbfgs import LBFGS
from cycloneml_tpu_torch.ml.optim.loss import DistributedLossFunction
from cycloneml_tpu_torch.ml.param import ParamValidators as V
from cycloneml_tpu_torch.ml.shared import HasMaxIter, HasSeed, HasSolver, HasTol
from cycloneml_tpu_torch.ml.util_io import MLReadable, MLWritable, load_arrays, save_arrays
from cycloneml_tpu_torch.util.logging import get_logger

logger = get_logger(__name__)

ROW_CHUNK = 1 << 16  # rows a forward and backward pass takes at a time


def _n_weights(layers: Sequence[int]) -> int:
    return sum((layers[i] + 1) * layers[i + 1] for i in range(len(layers) - 1))


def _forward(flat: torch.Tensor, x: torch.Tensor,
             layers: Sequence[int]) -> torch.Tensor:
    """Returns output-layer logits for a row block."""
    off = 0
    h = x
    n = len(layers) - 1
    for i in range(n):
        fin, fout = layers[i], layers[i + 1]
        W = flat[off: off + fin * fout].reshape(fout, fin)
        off += fin * fout
        b = flat[off: off + fout]
        off += fout
        h = h @ W.T + b
        if i < n - 1:
            h = torch.sigmoid(h)
    return h  # logits; softmax applied in the loss / probability


def mlp_aggregator(layers: Sequence[int]):
    """The block aggregator ``(x, y, w, flat) -> {loss, grad, count}``:
    Σ w (logsumexp(logits) − logits[y]) over the block's rows in chunks
    of :data:`ROW_CHUNK` (X upcast to flat's dtype), its gradient by
    autograd, and Σ w; TF32 off (the reference's ``Precision.HIGHEST``)."""
    def agg(x, y, w, flat):
        f = flat.detach().requires_grad_(True)
        loss = torch.zeros((), dtype=flat.dtype, device=flat.device)
        grad = torch.zeros_like(flat)
        with precision_scope("highest", flat.device):
            for lo in range(0, x.shape[0], ROW_CHUNK):
                logits = _forward(f, x[lo:lo + ROW_CHUNK].to(flat.dtype),
                                  layers)
                picked = torch.gather(
                    logits, 1,
                    y[lo:lo + ROW_CHUNK].to(torch.int64)[:, None])[:, 0]
                part = torch.sum(w[lo:lo + ROW_CHUNK].to(flat.dtype)
                                 * (torch.logsumexp(logits, 1) - picked))
                g, = torch.autograd.grad(part, f)
                loss = loss + part.detach()
                grad = grad + g
        return {"loss": loss, "grad": grad, "count": torch.sum(w)}
    return agg


class _MLPParams(HasMaxIter, HasTol, HasSeed, HasSolver):
    def _declare_mlp_params(self):
        self._p_max_iter(100)
        self._p_tol(1e-6)
        self._p_seed(17)
        self._p_solver(["l-bfgs", "gd"], "l-bfgs")
        self.layers = self._param(
            "layers", "layer sizes from input to output", default=None)
        self.blockSize = self._param(
            "blockSize", "block size (kept for parity; blocks are the "
            "physical layout already)", V.gt(0), default=128)
        self.stepSize = self._param("stepSize", "gd step size", V.gt(0.0),
                                    default=0.03)
        self.initialWeights = self._param(
            "initialWeights", "explicit initial weight vector", default=None)


class MultilayerPerceptronClassifier(Predictor, _MLPParams,
                                     MLWritable, MLReadable):
    def __init__(self, uid=None, **kwargs):
        super().__init__(uid)
        self._declare_mlp_params()
        for k, v in kwargs.items():
            self.set(k, v)

    def set_layers(self, v):
        return self.set("layers", list(v))

    def set_max_iter(self, v):
        return self.set("maxIter", v)

    def set_seed(self, v):
        return self.set("seed", v)

    def _fit(self, frame: MLFrame) -> "MultilayerPerceptronClassificationModel":
        layers = (self.get("layers")
                  if self.is_defined(self.get_param("layers")) else None)
        if not layers or len(layers) < 2:
            raise ValueError("layers must list >= 2 sizes (input and output)")
        layers = [int(v) for v in layers]
        ds = frame.to_instance_dataset(
            self.get("featuresCol"), self.get("labelCol"), None)
        if ds.n_features != layers[0]:
            raise ValueError(f"input layer size {layers[0]} != "
                             f"feature dim {ds.n_features}")
        k = layers[-1]
        y_real = ds.unpad(ds.y_host())
        if ds.n_rows and (y_real.min() < 0 or y_real.max() >= k
                          or np.any(y_real != np.floor(y_real))):
            raise ValueError(
                f"labels must be integers in [0, {k}) to match the output "
                f"layer; found range [{y_real.min()}, {y_real.max()}] "
                "(an out-of-range index would pick another class's logit)")
        loss_fn = DistributedLossFunction(ds, mlp_aggregator(layers))

        n_w = _n_weights(layers)
        init = (self.get("initialWeights")
                if self.is_defined(self.get_param("initialWeights")) else None)
        if init is not None:
            x0 = np.asarray(init, np.float64)
            if len(x0) != n_w:
                raise ValueError(f"initialWeights has {len(x0)} values, "
                                 f"topology needs {n_w}")
        else:
            # ref FeedForwardModel init: uniform scaled by fan-in-ish factor
            rng = np.random.RandomState(self.get("seed"))
            x0 = np.empty(n_w)
            off = 0
            for i in range(len(layers) - 1):
                fin, fout = layers[i], layers[i + 1]
                scale = np.sqrt(6.0 / (fin + fout))  # Glorot uniform
                x0[off: off + fin * fout] = rng.uniform(
                    -scale, scale, fin * fout)
                off += fin * fout
                x0[off: off + fout] = 0.0
                off += fout

        if self.get("solver") == "l-bfgs":
            state = LBFGS(max_iter=self.get("maxIter"),
                          tol=self.get("tol")).minimize(loss_fn, x0)
            sol, history, iters = state.x, list(state.loss_history), state.iteration
        else:  # gd
            lr = self.get("stepSize")
            sol = x0.copy()
            history = []
            for _ in range(self.get("maxIter")):
                loss, grad = loss_fn(sol)
                history.append(loss)
                sol = sol - lr * grad
            iters = self.get("maxIter")

        model = MultilayerPerceptronClassificationModel(layers, sol, uid=self.uid)
        self._copy_values(model)
        model._set_parent(self)
        model.objective_history = history
        model.total_iterations = iters
        return model


class MultilayerPerceptronClassificationModel(ProbabilisticClassificationModel,
                                              _MLPParams, MLWritable, MLReadable):
    def __init__(self, layers: Optional[List[int]] = None,
                 weights: Optional[np.ndarray] = None, uid=None):
        super().__init__(uid)
        self._declare_mlp_params()
        self._layers = list(layers) if layers is not None else None
        self._weights = np.asarray(weights) if weights is not None else None
        self.objective_history = []
        self.total_iterations = 0

    @property
    def weights(self) -> DenseVector:
        return Vectors.dense(self._weights)

    @property
    def num_classes(self) -> int:
        return self._layers[-1]

    @property
    def num_features(self) -> int:
        return self._layers[0]

    def _raw_prediction(self, x: np.ndarray) -> np.ndarray:
        h = x
        off = 0
        n = len(self._layers) - 1
        for i in range(n):
            fin, fout = self._layers[i], self._layers[i + 1]
            W = self._weights[off: off + fin * fout].reshape(fout, fin)
            off += fin * fout
            b = self._weights[off: off + fout]
            off += fout
            h = h @ W.T + b
            if i < n - 1:
                h = 1.0 / (1.0 + np.exp(-h))
        return h

    def _raw_to_probability(self, raw: np.ndarray) -> np.ndarray:
        m = raw.max(axis=1, keepdims=True)
        e = np.exp(raw - m)
        return e / e.sum(axis=1, keepdims=True)

    def _save_data(self, path: str) -> None:
        save_arrays(path, layers=np.asarray(self._layers, np.int64),
                    weights=self._weights)

    def _load_data(self, path: str, meta) -> None:
        arrs = load_arrays(path)
        self._layers = [int(v) for v in arrs["layers"]]
        self._weights = arrs["weights"]
