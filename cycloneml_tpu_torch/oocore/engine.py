"""Streaming fit routing and the streamed mini-batch SGD.

The port's counterpart of ``cycloneml_tpu/oocore/engine.py``. The mode
(``cyclone.oocore.mode``):

- ``auto`` (default): in-core fits run unchanged, but a fit whose
  predicted peak device memory exceeds the budget guard's budget
  (``observe/costs``) DEGRADES to the streaming engine instead of warning
  or raising;
- ``force``: every eligible dense fit streams, each loss/gradient
  evaluation one epoch over the shards;
- ``off``: no streaming anywhere.

The degradation signal is ``observe.costs.OutOfCoreRequired``, raised by
the guard only where the optimizer's owner declared a streaming fallback
(``DeviceLBFGS.oocore_fallback``) and caught by the estimator.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from cycloneml_tpu_torch.ml.optim.gradient_descent import (GradientDescent,
                                                          _run_stacked,
                                                          sample_weights)
from cycloneml_tpu_torch.observe.costs import OutOfCoreRequired  # noqa: F401
from cycloneml_tpu_torch.oocore.objective import (
    StackedStreamingLossFunction, StreamingLossFunction)
from cycloneml_tpu_torch.oocore.shards import StreamingDataset

logger = logging.getLogger(__name__)


def streaming_mode(conf) -> str:
    """``cyclone.oocore.mode``: 'auto', 'force' or 'off'."""
    from cycloneml_tpu_torch.conf import OOCORE_MODE
    if conf is None:
        return "auto"
    return str(conf.get(OOCORE_MODE))


def degrade_allowed(ctx) -> bool:
    """Whether the budget guard may degrade to streaming (mode auto or
    force)."""
    return streaming_mode(getattr(ctx, "conf", None)) != "off"


def stream_uses_kernels(sds) -> bool:
    """Whether a streamed fit over ``sds`` takes the kernel route: what
    ``ops/kernels.use_fused_kernels`` says of an X of the stream's dtype
    on the context's device."""
    from cycloneml_tpu_torch.ops.kernels import use_fused_kernels
    probe = torch.empty((0, 1), dtype=sds.x_dtype,
                        device=sds.ctx.mesh_runtime.device)
    return use_fused_kernels(sds.ctx, probe)


def shard_dataset(ds, shard_rows: Optional[int] = None,
                  spill_dir: Optional[str] = None) -> StreamingDataset:
    """Spill an in-core dataset to a shard set (bounded per-shard
    staging, :meth:`StreamingDataset.from_dataset`) through the
    content-hash cache: a re-fit over the same dataset attaches to the
    existing spill and writes 0 bytes (``cyclone.oocore.cacheBytes=0``
    restores the build-and-own path)."""
    from cycloneml_tpu_torch.oocore.cache import shard_set_cache
    return shard_set_cache().attach(ds, shard_rows=shard_rows,
                                    spill_dir=spill_dir)


class StreamingGradientDescent(GradientDescent):
    """Mini-batch SGD over streamed epochs, the out-of-core twin of
    ``ml/optim/gradient_descent.GradientDescent``: a step's gradient is the
    sum of every shard's partial (an epoch), then one Updater step, the
    in-core update. ``miniBatchFraction`` < 1 folds a per-shard Bernoulli
    row mask into the weights, keyed on (seed, step, TRUE shard index), so
    a fixed seed replays exactly whatever the shard order.

    ``shuffle`` (``cyclone.oocore.shuffle`` when None) walks each epoch's
    shards in the reference's seeded permutation, numpy's
    ``RandomState((seed * 1000003 + step) % 2**32)``, bit for bit."""

    def __init__(self, step_size: float = 1.0, num_iterations: int = 100,
                 reg_param: float = 0.0, mini_batch_fraction: float = 1.0,
                 updater=None, convergence_tol: float = 0.001, seed: int = 0,
                 shuffle: Optional[bool] = None):
        super().__init__(step_size, num_iterations, reg_param,
                         mini_batch_fraction, updater, convergence_tol, seed)
        self.shuffle = shuffle

    def _order_fn(self, sds):
        shuffle = self.shuffle
        if shuffle is None:
            from cycloneml_tpu_torch.conf import OOCORE_SHUFFLE
            conf = getattr(sds.ctx, "conf", None)
            shuffle = bool(conf.get(OOCORE_SHUFFLE)) \
                if conf is not None else False
        seed = self.seed

        def epoch_order(step: int):
            if not shuffle:
                return None
            return np.random.RandomState(
                (seed * 1000003 + step) % (2 ** 32)).permutation(
                    sds.n_shards)

        return epoch_order

    def _sampled(self, agg: Callable) -> Callable:
        frac, seed = self.mini_batch_fraction, self.seed
        if frac >= 1.0:
            return agg

        def fn(x, y, w, coef, step, shard):
            return agg(x, y, sample_weights(w, frac, seed, step, shard),
                       coef)

        return fn

    def _evaluate(self, loss_fn, sds):
        frac = self.mini_batch_fraction
        epoch_order = self._order_fn(sds)
        dev = sds.ctx.mesh_runtime.device

        def evaluate(w, t):
            coef = torch.as_tensor(w, dtype=torch.float32, device=dev)
            if frac < 1.0:
                return loss_fn.sweep(coef, t, per_shard=lambda i: (i,),
                                     order=epoch_order(t))
            return loss_fn.sweep(coef, order=epoch_order(t))

        return evaluate

    def optimize(self, sds: StreamingDataset, agg: Callable, x0: np.ndarray
                 ) -> Tuple[np.ndarray, list]:
        """Returns (weights, stochastic loss history), the in-core
        ``GradientDescent.optimize`` contract."""
        loss_fn = StreamingLossFunction(sds, self._sampled(agg))
        return self._run(self._evaluate(loss_fn, sds), x0)

    def optimize_stacked(self, sds: StreamingDataset, agg: Callable,
                         x0: np.ndarray, y_stack=None
                         ) -> Tuple[np.ndarray, list]:
        """The model-axis twin of :meth:`optimize`: ``x0`` is ``(K, n)``,
        each step ONE epoch whose per-shard aggregator is the model-axis
        twin, so K models ride every staged shard. ``y_stack`` (``(K,
        n)``) gives per-model labels (OneVsRest's relabelings); without it
        every model sees the shard's own labels. The mask is drawn once a
        shard and shared by the models. Returns ``(weights (K, n),
        histories)``."""
        from cycloneml_tpu_torch.ml.optim import aggregators
        stacked = self._sampled(aggregators.stack_aggregator(agg))
        n_models = np.asarray(x0).shape[0]
        loss_fn = StackedStreamingLossFunction(sds, stacked, n_models,
                                               y_stack=y_stack)
        return _run_stacked(self, self._evaluate(loss_fn, sds), x0)
