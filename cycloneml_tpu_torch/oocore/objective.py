"""The streamed objective: one loss/gradient evaluation is one epoch.

The port's counterpart of ``cycloneml_tpu/oocore/objective.py``, the
out-of-core twin of ``ml/optim/loss.DistributedLossFunction``: every shard
is staged through the pinned ring (:class:`~cycloneml_tpu_torch.oocore.
stream.ShardStream`), run through the SAME aggregator the in-core fit uses
(on the card K1, K2 or K1s, once a shard, over the slot's padded block),
and its partial sums are added in float64 in staging order. The reference
reads every shard's partial back to the host (:118-129); the port adds
each shard's float32 output into a float64 accumulator on the device, the
same IEEE sum, and reads the accumulator back once an epoch. The total is
normalized by the weight sum of the write pass's moments and the L2 term
is added once an epoch, as in core.

On the CPU in float64 a streamed fit differs from the in-core fit only by
summation order (shard partials against one pass). On the card each
shard's float32 partial differs from one whole-X K1 sweep's, so the
streamed fit is held to the kernel tolerance, not bitwise to the in-core
fit; two streamed fits of one shard set are bitwise equal.

There is no device line search here: the host strong-Wolfe search runs
with every phi(alpha) a full epoch.

``stats`` gathers the epochs' split: ``read_s``, ``slot_wait_s`` and
``consumer_wait_s`` from the stream, ``copy_s`` (the copies' device time,
CUDA events), ``compute_s`` (device time from the shard's copy being
waited on to the end of its fold, CUDA events), ``copy_stall_s`` (device
time the caller's stream sat waiting for a copy) and ``wall_s``; on the
CPU the device columns are host times or 0.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from cycloneml_tpu_torch.dataset.instance import compute_dtype
from cycloneml_tpu_torch.oocore.stream import ShardStream, shard_ring
from cycloneml_tpu_torch.parallel import collectives


class StreamingLossFunction:
    """Callable ``(coef) -> (loss, grad)`` in host float64 over a
    :class:`~cycloneml_tpu_torch.oocore.shards.StreamingDataset`.

    - ``agg``: the aggregator the in-core fit would use (sums, signature
      ``(x, y, w, *extras, coef)``);
    - ``extra_args``: replicated tensors before the coefficients
      (inv_std, scaled_mean, y_pars), the in-core ``extra_args``;
    - ``l2_reg_fn``: the host penalty, applied once an epoch;
    - the weight sum comes from the shard set's write-pass moments.
    Counters: ``n_evals``, ``n_dispatches`` (shard launches, n_shards an
    epoch) and ``epochs``."""

    def __init__(self, sds, agg: Callable,
                 l2_reg_fn: Optional[Callable] = None,
                 weight_sum: Optional[float] = None,
                 extra_args: tuple = ()):
        self._sds = sds
        self._ctx = sds.ctx
        rt = sds.ctx.mesh_runtime
        self._prog = lambda x, y, w, *args: collectives.tree_aggregate(
            agg, rt, x, y, w)(x, y, w, *args)
        self._extras = tuple(extra_args)
        self.device = rt.device
        self.cdt = compute_dtype(getattr(sds.ctx, "conf", None))
        self.l2_reg_fn = l2_reg_fn
        self.weight_sum = float(weight_sum) if weight_sum is not None \
            else float(sds.weight_sum)
        self.n_evals = 0
        self.n_dispatches = 0   # shard launches (n_shards an epoch)
        self.epochs = 0
        self.stats = {"read_s": 0.0, "slot_wait_s": 0.0,
                      "consumer_wait_s": 0.0, "copy_s": 0.0,
                      "compute_s": 0.0, "copy_stall_s": 0.0, "wall_s": 0.0,
                      "bytes": 0, "shards": 0}
        self._ring = None

    # -- the streamed sweep ------------------------------------------------
    def sweep(self, *call_args, per_shard=None, order=None) -> dict:
        """One epoch: stage every shard, run the aggregator over it, add
        its partial sums into float64 accumulators on the device in
        staging order, read them back once. Returns the sums (float64
        numpy; the caller normalizes). ``per_shard(i)`` supplies extra
        arguments appended for shard ``i`` (the streamed SGD's mask key,
        by the TRUE shard index); ``order`` permutes the staging order."""
        if self._ring is None:
            self._ring = shard_ring(self._sds)
        cuda = self.device.type == "cuda"
        f64 = torch.float64
        acc = None
        self.epochs += 1
        t_wall = time.perf_counter()
        with ShardStream(self._sds, order=order, ring=self._ring,
                         stats=self.stats) as stream:
            for i, xs, ys, ws, slot in stream:
                args = call_args if per_shard is None \
                    else (*call_args, *per_shard(i))
                t0 = time.perf_counter()
                out = self._prog(xs, ys, ws, *args)
                if acc is None:
                    acc = {k: torch.as_tensor(v).to(f64).clone()
                           for k, v in out.items()}
                else:
                    for k, v in out.items():
                        acc[k] += torch.as_tensor(v).to(f64)
                if not cuda:
                    self.stats["compute_s"] += time.perf_counter() - t0
                stream.release(slot)
                self.n_dispatches += 1
        if acc is None:
            raise RuntimeError("streamed sweep saw zero shards")
        keys = list(acc)
        # the one readback of the epoch
        flat = torch.cat([acc[k].reshape(-1) for k in keys]).cpu().numpy()
        out, lo = {}, 0
        for k in keys:
            n = acc[k].numel()
            out[k] = flat[lo:lo + n].reshape(tuple(acc[k].shape)) \
                if acc[k].dim() else flat[lo]
            lo += n
        self.stats["wall_s"] += time.perf_counter() - t_wall
        if cuda:
            stall, compute = stream.device_seconds()
            self.stats["copy_stall_s"] += stall
            self.stats["compute_s"] += compute
        self.stats["copy_s"] = self._ring.copy_seconds()
        return out

    def __call__(self, coef: np.ndarray) -> Tuple[float, np.ndarray]:
        self.n_evals += 1
        coef_d = torch.as_tensor(np.asarray(coef, dtype=np.float64),
                                 device=self.device).to(self.cdt)
        out = self.sweep(*self._extras, coef_d)
        loss = float(out["loss"]) / self.weight_sum
        grad = np.asarray(out["grad"], dtype=np.float64) / self.weight_sum
        if self.l2_reg_fn is not None:
            rl, rg = self.l2_reg_fn(np.asarray(coef, dtype=np.float64))
            loss += float(rl)
            grad = grad + np.asarray(rg, dtype=np.float64)
        if hasattr(self._ctx, "record_step"):
            # one streamed epoch, as one step's metrics
            self._ctx.record_step({"loss": loss,
                                   "oocore_shards": self._sds.n_shards})
        return loss, grad


class _StackedShardView:
    """A shard set seen with a per-shard ``(rows, K)`` label stack, built
    on the host at stage time, so the stacked streamed fit never holds the
    whole ``(n, K)`` matrix on the device: each shard's stack is staged
    with its rows.

    - :meth:`tiled`: the shard's own labels across K models (a regParam
      grid);
    - :meth:`from_stack`: column slices of a caller's ``(K, n)`` stack in
      shard row order (OneVsRest's relabelings; ``from_chunks`` keeps row
      order, so shard offsets index the stack)."""

    def __init__(self, sds, n_models: int, y_fn, stack_dtype: torch.dtype):
        self._sds = sds
        self.n_models = int(n_models)
        self._y_fn = y_fn
        self.stack_dtype = stack_dtype

    @classmethod
    def tiled(cls, sds, n_models: int, stack_dtype) -> "_StackedShardView":
        def y_fn(i, y):
            return y[:, None].expand(len(y), n_models)

        return cls(sds, n_models, y_fn, stack_dtype)

    @classmethod
    def from_stack(cls, sds, y_stack, stack_dtype) -> "_StackedShardView":
        offsets = np.cumsum([0] + [s.rows for s in sds._shards])
        if y_stack.shape[1] != sds.n_rows:
            raise ValueError(
                f"y_stack has {y_stack.shape[1]} rows per model; the "
                f"shard set has {sds.n_rows}")

        def y_fn(i, y):
            lo, hi = int(offsets[i]), int(offsets[i + 1])
            block = y_stack[:, lo:hi]
            block = block if torch.is_tensor(block) else \
                torch.from_numpy(np.asarray(block, dtype=np.float64))
            return block.T

        return cls(sds, len(y_stack), y_fn, stack_dtype)

    # -- the delegated surface (what ShardStream and the objective touch) --
    @property
    def ctx(self):
        return self._sds.ctx

    @property
    def n_shards(self) -> int:
        return self._sds.n_shards

    @property
    def n_rows(self) -> int:
        return self._sds.n_rows

    @property
    def n_features(self) -> int:
        return self._sds.n_features

    @property
    def pad_rows(self) -> int:
        return self._sds.pad_rows

    @property
    def weight_sum(self) -> float:
        return self._sds.weight_sum

    @property
    def x_dtype(self):
        return self._sds.x_dtype

    @property
    def y_dtype(self):
        return self._sds.y_dtype

    @property
    def x_scale(self):
        return self._sds.x_scale

    def read_into(self, i: int, x_out, y_out, w_out, pool=None) -> int:
        """The shard's X and w into the slot, and its ``(rows, K)`` label
        stack into ``y_out`` (the rows past the shard's zeroed)."""
        rows = self._sds._shards[i].rows
        y_raw = torch.empty(x_out.shape[0], dtype=self._sds.y_dtype)
        self._sds.read_into(i, x_out, y_raw, w_out, pool=pool)
        y_out[:rows] = self._y_fn(i, y_raw[:rows].to(torch.float64)).to(
            y_out.dtype)
        y_out[rows:] = 0
        return rows


class StackedStreamingLossFunction(StreamingLossFunction):
    """The model-axis twin of :class:`StreamingLossFunction` (the
    streamed ``loss.StackedDistributedLossFunction``): callable
    ``(coef_stack (K, n_coef)) -> (loss (K,), grad (K, n_coef))`` in host
    float64, one evaluation ONE epoch whose per-shard aggregator is the
    model-axis one (K1s on the card), so every staged shard serves all K
    models. The per-model L2 is ``loss.stacked_host_l2``, shared with the
    in-core stacked loss."""

    def __init__(self, sds, agg, n_models: int,
                 reg: Optional[np.ndarray] = None,
                 l2_scale: Optional[np.ndarray] = None,
                 weight_sum: Optional[float] = None,
                 extra_args: tuple = (), y_stack=None,
                 stack_dtype: Optional[torch.dtype] = None):
        if stack_dtype is None:
            stack_dtype = compute_dtype(getattr(sds.ctx, "conf", None))
        view = (_StackedShardView.tiled(sds, n_models, stack_dtype)
                if y_stack is None
                else _StackedShardView.from_stack(sds, y_stack, stack_dtype))
        super().__init__(view, agg, l2_reg_fn=None, weight_sum=weight_sum,
                         extra_args=extra_args)
        self.n_models = int(n_models)
        self.reg = (np.zeros(self.n_models) if reg is None
                    else np.asarray(reg, dtype=np.float64))
        self.l2_scale = (None if l2_scale is None
                         else np.asarray(l2_scale, dtype=np.float64))

    def __call__(self, coef_stack: np.ndarray):
        from cycloneml_tpu_torch.ml.optim.loss import stacked_host_l2
        self.n_evals += 1
        coef_d = torch.as_tensor(np.asarray(coef_stack, dtype=np.float64),
                                 device=self.device).to(self.cdt)
        out = self.sweep(*self._extras, coef_d)
        loss = np.asarray(out["loss"], dtype=np.float64) / self.weight_sum
        grad = np.asarray(out["grad"], dtype=np.float64) / self.weight_sum
        loss, grad = stacked_host_l2(loss, grad, coef_stack, self.reg,
                                     self.l2_scale)
        if hasattr(self._ctx, "record_step"):
            self._ctx.record_step({"loss": float(np.mean(loss)),
                                   "n_models": self.n_models,
                                   "oocore_shards": self._sds.n_shards})
        return loss, grad
