"""Mini-batch gradient descent with pluggable updaters.

The port's counterpart of ``cycloneml_tpu/ml/optim/gradient_descent.py``
(ref mllib GradientDescent.scala:34 ``runMiniBatchSGD``: per step a
miniBatchFraction sample, the summed gradient, one ``Updater`` step with
the step size stepSize/sqrt(t)). The sample is a Bernoulli mask folded
into the row weights, so shapes stay fixed.

The mask's bits are the port's own: the reference draws them with
``jax.random`` (:95-105), whose bits torch cannot reproduce. The port
draws ``torch.rand`` from a ``torch.Generator`` seeded by
:func:`mask_seed`, a SplitMix64 mix (``dataset/random._mix64``) of (seed,
step, shard), folded to 32 bits so that the CPU's generator keeps all of
it. A fixed seed replays exactly on one device type; the CPU's and the
card's generators draw different bits (ROADMAP Queue 3, a decided break).
At ``miniBatchFraction=1.0`` no mask is drawn, and the port follows the
reference exactly.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from cycloneml_tpu_torch.dataset.random import _mix64

logger = logging.getLogger(__name__)


class Updater:
    """(ref Updater.scala) — returns (new_weights, reg_value)."""

    def compute(self, weights: np.ndarray, gradient: np.ndarray,
                step_size: float, iteration: int, reg_param: float
                ) -> Tuple[np.ndarray, float]:
        raise NotImplementedError


class SimpleUpdater(Updater):
    def compute(self, weights, gradient, step_size, iteration, reg_param):
        eta = step_size / np.sqrt(iteration)
        return weights - eta * gradient, 0.0


class SquaredL2Updater(Updater):
    """w <- w(1 - eta lambda) - eta g; reg = lambda |w|^2 / 2 (ref
    SquaredL2Updater)."""

    def compute(self, weights, gradient, step_size, iteration, reg_param):
        eta = step_size / np.sqrt(iteration)
        new_w = weights * (1.0 - eta * reg_param) - eta * gradient
        return new_w, 0.5 * reg_param * float(new_w @ new_w)


class L1Updater(Updater):
    """The soft-thresholding proximal step (ref L1Updater.compute)."""

    def compute(self, weights, gradient, step_size, iteration, reg_param):
        eta = step_size / np.sqrt(iteration)
        w = weights - eta * gradient
        shrink = reg_param * eta
        w = np.sign(w) * np.maximum(np.abs(w) - shrink, 0.0)
        return w, reg_param * float(np.abs(w).sum())


def mask_seed(seed: int, step: int, shard: int = 0) -> int:
    """The 32-bit generator seed of the mini-batch mask of (seed, step,
    shard): SplitMix64 mixes chained over the three, folded to 32 bits."""
    z = _mix64(int(seed) + 0x9E3779B97F4A7C15)
    z = _mix64(z ^ (int(step) + 0xBF58476D1CE4E5B9))
    z = _mix64(z ^ (int(shard) + 0x94D049BB133111EB))
    return (z ^ (z >> 32)) & 0xFFFFFFFF


def sample_weights(w: torch.Tensor, frac: float, seed: int, step: int,
                   shard: int = 0) -> torch.Tensor:
    """``w`` times a Bernoulli(``frac``) row mask drawn on w's device from
    the generator of :func:`mask_seed`."""
    g = torch.Generator(device=w.device)
    g.manual_seed(mask_seed(seed, step, shard))
    u = torch.rand(w.shape, generator=g, device=w.device,
                   dtype=torch.float32)
    return w * (u < frac).to(w.dtype)


def _step_sums(out) -> Tuple[float, float, np.ndarray]:
    """(count, loss, grad) of one step's sums, on the host in float64."""
    return (float(out["count"]), float(out["loss"]),
            np.asarray(out["grad"], dtype=np.float64))


class GradientDescent:
    """(ref GradientDescent.scala:34 runMiniBatchSGD)

    ``agg`` is a block aggregator ``(x, y, w, coef) -> {loss, grad,
    count}``; each step multiplies the row weights by the Bernoulli mask
    and divides the summed gradient by the sampled weight, as the
    reference divides by miniBatchSize. The coefficients go to the
    aggregator in float32, as the reference's do."""

    def __init__(self, step_size: float = 1.0, num_iterations: int = 100,
                 reg_param: float = 0.0, mini_batch_fraction: float = 1.0,
                 updater: Optional[Updater] = None,
                 convergence_tol: float = 0.001, seed: int = 0):
        self.step_size = step_size
        self.num_iterations = num_iterations
        self.reg_param = reg_param
        self.mini_batch_fraction = mini_batch_fraction
        self.updater = updater or SimpleUpdater()
        self.convergence_tol = convergence_tol
        self.seed = seed

    def _sampled(self, agg: Callable) -> Callable:
        frac, seed = self.mini_batch_fraction, self.seed

        def fn(*args):
            # (rows..., w, coef, step): w is the last row-sharded array
            *rows, w, coef, step = args
            if frac < 1.0:
                w = sample_weights(w, frac, seed, step)
            return agg(*rows, w, coef)

        return fn

    def _run(self, evaluate, x0: np.ndarray) -> Tuple[np.ndarray, list]:
        """The reference's loop: ``evaluate(w, t)`` gives step t's sums."""
        w = np.asarray(x0, dtype=np.float64).copy()
        history: list = []
        # regVal of the initial weights with a zero gradient, as
        # runMiniBatchSGD computes it before the loop
        _, reg = self.updater.compute(w, np.zeros_like(w), 0.0, 1,
                                      self.reg_param)
        updates = 0
        for t in range(1, self.num_iterations + 1):
            count, loss_sum, grad_sum = _step_sums(evaluate(w, t))
            if count <= 0:
                continue  # an empty mini-batch: no update, no history
            history.append(loss_sum / count + reg)
            prev_w = w
            w, reg = self.updater.compute(w, grad_sum / count,
                                          self.step_size, t, self.reg_param)
            updates += 1
            # GradientDescent.isConverged, never on the first update
            if self.convergence_tol > 0 and updates > 1:
                delta = float(np.linalg.norm(w - prev_w))
                if delta < self.convergence_tol * max(
                        float(np.linalg.norm(prev_w)), 1.0):
                    logger.info("GradientDescent converged at iteration %d",
                                t)
                    break
        return w, history

    def optimize(self, dataset, agg: Callable, x0: np.ndarray
                 ) -> Tuple[np.ndarray, list]:
        """Returns (weights, stochastic loss history), as the reference's
        runMiniBatchSGD."""
        compiled = dataset.tree_aggregate_fn(self._sampled(agg))
        dev = dataset.w.device

        def evaluate(w, t):
            return compiled(torch.as_tensor(w, dtype=torch.float32,
                                            device=dev), t)

        return self._run(evaluate, x0)


def _run_stacked(gd: GradientDescent, evaluate, x0: np.ndarray
                 ) -> Tuple[np.ndarray, list]:
    """The model-axis loop: every model's update and convergence test as
    its serial run, a converged model frozen while the others step."""
    W = np.asarray(x0, dtype=np.float64).copy()
    n_models = W.shape[0]
    histories: list = [[] for _ in range(n_models)]
    regs = np.zeros(n_models)
    for kk in range(n_models):
        _, regs[kk] = gd.updater.compute(W[kk], np.zeros_like(W[kk]), 0.0, 1,
                                         gd.reg_param)
    live = np.ones(n_models, dtype=bool)
    updates = np.zeros(n_models, dtype=np.int64)
    for t in range(1, gd.num_iterations + 1):
        if not live.any():
            break
        out = evaluate(W, t)
        count = np.asarray(out["count"], dtype=np.float64)
        if float(count.max()) <= 0:
            continue  # an empty mini-batch (the shared mask): no update
        loss = np.asarray(out["loss"], dtype=np.float64) / count
        grad = np.asarray(out["grad"], dtype=np.float64) / count[:, None]
        for kk in np.nonzero(live)[0]:
            histories[kk].append(loss[kk] + regs[kk])
            prev = W[kk].copy()
            W[kk], regs[kk] = gd.updater.compute(W[kk], grad[kk],
                                                 gd.step_size, t,
                                                 gd.reg_param)
            updates[kk] += 1
            if gd.convergence_tol > 0 and updates[kk] > 1:
                delta = float(np.linalg.norm(W[kk] - prev))
                if delta < gd.convergence_tol * max(
                        float(np.linalg.norm(prev)), 1.0):
                    live[kk] = False
                    logger.info("GradientDescent: model %d converged at "
                                "iteration %d (%d/%d still live)", kk, t,
                                int(live.sum()), n_models)
    return W, histories


class StackedGradientDescent(GradientDescent):
    """Model-axis mini-batch SGD: K models over ONE X (the reference's
    ``StackedGradientDescent``). The dataset carries the ``(n_pad, K)``
    label matrix as ``y``, the aggregator is the model-axis twin
    (``aggregators.stack_aggregator``), and one reduction gives all K
    gradients. Per-model convergence freezes a model where its serial run
    stops; the mask is keyed on seed and step only, so each model sees
    its serial run's samples."""

    def optimize_stacked(self, dataset, agg: Callable, x0: np.ndarray
                         ) -> Tuple[np.ndarray, list]:
        """``x0`` is (K, n); returns ``(weights (K, n), histories)``."""
        from cycloneml_tpu_torch.ml.optim import aggregators
        compiled = dataset.tree_aggregate_fn(
            self._sampled(aggregators.stack_aggregator(agg)))
        dev = dataset.w.device

        def evaluate(W, t):
            return compiled(torch.as_tensor(W, dtype=torch.float32,
                                            device=dev), t)

        return _run_stacked(self, evaluate, x0)
