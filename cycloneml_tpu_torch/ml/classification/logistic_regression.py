"""Logistic regression — the binomial and multinomial dense fits.

The port's counterpart of ``cycloneml_tpu/ml/classification/
logistic_regression.py`` (``_fit_dataset``, dense branch, :663-950): the
label histogram and feature moments from one Summarizer pass, the family
(``auto`` is multinomial past two classes), training in standardized
feature space with standardization folded into the aggregator's read (no
standardized copy of X), fitWithMean centering, the log-odds intercept
start (binomial) or the centered log class histogram (multinomial), the L2
penalty, and the optimizer the reference's ``createOptimizer`` picks:
L-BFGS-B when any coefficient or intercept bound is set, OWL-QN when
elastic net has an L1 part, else L-BFGS — chunked on the device under
``cyclone.ml.lbfgs.deviceChunk``. Then unscaling back to the original
feature space. Under ``cyclone.ml.usePallasKernels`` the binomial sweep is
kernel K1, bounded fits included (one launch per L-BFGS-B trial point);
the multinomial aggregator is plain PyTorch, as the reference's is.

The fit is fp8-capable: under ``cyclone.data.dtype=auto8|float8`` it reads
e4m3 codes, with the per-column scales folded into the aggregator's
``inv_std``, after the envelope probe (``dataset.resolve_fp8_fit``); a
non-finite fp8 solution refits on the bfloat16 rung.

Stacked fits (:meth:`LogisticRegression.fit_stacked`, the reference's
:214-410): K binomial models over ONE shared X (OneVsRest's relabelings or
CrossValidator's regParam grid) train together in the stacked device
L-BFGS, every evaluation one model-axis aggregation: kernel K1s under
``cyclone.ml.usePallasKernels``, which reads X once for all K models.

A :class:`~cycloneml_tpu_torch.dataset.sparse.SparseInstanceDataset`
trains binomially on the sparse tier (:meth:`LogisticRegression.
_fit_sparse`, the reference's :563-650), through the sparse aggregators:
on the card, kernels S1 and S2 (``csrc/ell_sweep.cu``) once per
evaluation of the host optimizer.

Streamed (out-of-core) fits (the reference's :264-274, :412-560,
:667-679, :876-895): a :class:`~cycloneml_tpu_torch.oocore.shards.
StreamingDataset` handed to ``fit`` or ``fit_stacked`` trains over epochs
of shards staged from disk, every evaluation the same aggregator once a
shard (K1, or K1s for the stacked fit, on the card); under
``cyclone.oocore.mode=force`` an in-core dataset is spilled to shards
first (``oocore.shard_dataset``); and when the memory budget guard finds
the in-core fit over budget (``observe/costs``), the fit degrades to the
streamed one. The statistics come from the shards' write pass; the
optimizer is the host L-BFGS (``StackedHostLBFGS`` for stacked fits). The
summary says ``streamed``.

Checkpointed training (the reference's ``_optimize``, :174-196): with
``checkpointDir`` set, the dense, sparse and streamed fits run the host
optimizer under ``parallel/resilience.train_with_checkpoints``, a
checkpoint every ``checkpointInterval`` iterations, bound to the dataset
and the parameters by a fingerprint, so that a killed fit resumes where it
stopped and a directory of another fit raises. The chunked
``DeviceLBFGS`` is chosen only without ``checkpointDir``, as the
reference chooses it.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from cycloneml_tpu_torch.dataset.dataset import (InstanceDataset,
                                                 fp8_fallback,
                                                 resolve_fp8_fit)
from cycloneml_tpu_torch.dataset.instance import compute_dtype
from cycloneml_tpu_torch.dataset.sparse import SparseInstanceDataset
from cycloneml_tpu_torch.linalg.matrices import DenseMatrix
from cycloneml_tpu_torch.linalg.vectors import DenseVector, Vectors
from cycloneml_tpu_torch.ml.base import (Predictor,
                                         ProbabilisticClassificationModel)
from cycloneml_tpu_torch.ml.optim import aggregators
from cycloneml_tpu_torch.ml.optim.lbfgs import LBFGS, LBFGSB, OWLQN
from cycloneml_tpu_torch.ml.optim.loss import (DistributedLossFunction,
                                               inv_std_vector,
                                               l2_regularization)
from cycloneml_tpu_torch.ml.evaluation.evaluators import (
    _trapezoid, binary_curve_points)
from cycloneml_tpu_torch.ml.param import ParamValidators as V
from cycloneml_tpu_torch.ml.util_io import MLReadable, MLWritable, load_arrays, save_arrays
from cycloneml_tpu_torch.ml.shared import (
    HasAggregationDepth, HasElasticNetParam, HasFitIntercept, HasLabelCol,
    HasMaxBlockSizeInMB, HasMaxIter, HasRegParam, HasStandardization,
    HasThreshold, HasTol,
)
from cycloneml_tpu_torch.ml.stat import Summarizer

logger = logging.getLogger(__name__)


class _LogisticRegressionParams(HasMaxIter, HasRegParam, HasElasticNetParam,
                                HasTol, HasFitIntercept, HasStandardization,
                                HasThreshold, HasAggregationDepth,
                                HasMaxBlockSizeInMB):
    def _declare_lr_params(self):
        self._p_max_iter(100)
        self._p_reg_param(0.0)
        self._p_elastic_net(0.0)
        self._p_tol(1e-6)
        self._p_fit_intercept(True)
        self._p_standardization(True)
        self._p_threshold(0.5)
        self._p_aggregation_depth(2)
        self._p_max_block_size(0.0)
        self.family = self._param(
            "family", "label distribution family",
            V.in_array(["auto", "binomial", "multinomial"]), default="auto")
        self.checkpointDir = self._param(
            "checkpointDir", "directory for mid-training optimizer "
            "checkpoints", default="")
        self.checkpointInterval = self._param(
            "checkpointInterval", "iterations between checkpoints",
            V.gt(0), default=10)
        for name in ("lowerBoundsOnCoefficients", "upperBoundsOnCoefficients",
                     "lowerBoundsOnIntercepts", "upperBoundsOnIntercepts"):
            setattr(self, name, self._param(name, "box constraint",
                                            default=None))

    def _opt(self, name):
        """Optional param: None when never set (these have no default)."""
        return self.get(name) if self.is_defined(self.get_param(name)) else None

    def _has_bounds(self) -> bool:
        return any(self._opt(p) is not None for p in (
            "lowerBoundsOnCoefficients", "upperBoundsOnCoefficients",
            "lowerBoundsOnIntercepts", "upperBoundsOnIntercepts"))


class LogisticRegression(Predictor, _LogisticRegressionParams, MLWritable,
                         MLReadable):
    def __init__(self, uid=None, **kwargs):
        super().__init__(uid)
        self._declare_lr_params()
        for k, v in kwargs.items():
            self.set(k, v)

    def set_max_iter(self, v):
        return self.set("maxIter", v)

    def set_reg_param(self, v):
        return self.set("regParam", v)

    def set_elastic_net_param(self, v):
        return self.set("elasticNetParam", v)

    def set_tol(self, v):
        return self.set("tol", v)

    def set_fit_intercept(self, v):
        return self.set("fitIntercept", v)

    def set_standardization(self, v):
        return self.set("standardization", v)

    def set_family(self, v):
        return self.set("family", v)

    def set_threshold(self, v):
        return self.set("threshold", v)

    def _flat_bounds(self, d, num_classes, is_multinomial, fit_intercept,
                     n_coef, features_std):
        """The user's bounds in the optimizer's coefficient layout, in
        STANDARDIZED space: beta_std = beta_orig * std, so coefficient
        bounds scale by the feature std (the reference's createBounds);
        intercept bounds are unscaled. Returns ``(lower, upper)``."""
        k_rows = num_classes if is_multinomial else 1
        n_feat = d * k_rows
        out = []
        for cp, ip, fill in (
                ("lowerBoundsOnCoefficients", "lowerBoundsOnIntercepts",
                 -np.inf),
                ("upperBoundsOnCoefficients", "upperBoundsOnIntercepts",
                 np.inf)):
            b = np.full(n_coef, fill)
            cb = self._opt(cp)
            if cb is not None:
                cb = np.asarray(cb, dtype=np.float64)
                if cb.ndim == 1 and k_rows == 1 and cb.size == d:
                    cb = cb[None, :]  # binomial convenience: a plain vector
                if cb.shape != (k_rows, d):
                    # the exact shape: a transposed multinomial matrix of
                    # the right size would scramble the box
                    raise ValueError(f"{cp} must have shape ({k_rows}, {d}); "
                                     f"got {cb.shape}")
                b[:n_feat] = (cb * np.asarray(features_std)[None, :]
                              ).reshape(-1)
            ib = self._opt(ip)
            if ib is not None:
                if not fit_intercept:
                    raise ValueError(f"{ip} requires fitIntercept=True")
                ib = np.asarray(ib, dtype=np.float64).reshape(-1)
                if ib.size != k_rows:
                    raise ValueError(
                        f"{ip} must have {k_rows} entries; got {ib.size}")
                b[n_feat:] = ib
            out.append(b)
        return out[0], out[1]

    def _fit(self, frame) -> "LogisticRegressionModel":
        if isinstance(frame, SparseInstanceDataset):
            # the sparse tier has its own fit (the ELL/hybrid aggregators)
            return self._fit_sparse(frame)
        # fp8-capable: the scaled aggregators fold the per-column scales
        # into inv_std, so this fit may take the e4m3 rung
        ds = frame.to_instance_dataset(
            self.get("featuresCol"), self.get("labelCol"),
            self.get("weightCol") or None, fp8_capable=True)
        return self._fit_dataset(ds)

    # -- stacked (model-axis) fits -------------------------------------------
    def can_fit_stacked(self) -> bool:
        """Param-level eligibility for :meth:`fit_stacked`: binomial, pure
        L2 (``elasticNetParam == 0``), no coefficient bounds, no
        checkpointing (the reference's rule). The labels are checked inside
        the fit."""
        return (self.get("family") != "multinomial"
                and float(self.get("elasticNetParam")) == 0.0
                and not self._has_bounds()
                and not self.get("checkpointDir"))

    def fit_stacked(self, frame, y_stack=None, reg_params=None):
        """Fit K binomial models over ONE shared X in one stacked fit (the
        reference's ``fit_stacked``): every evaluation covers all K models
        in one aggregation (K1s on the kernel route, reading X once), and
        every model walks its own L-BFGS path, frozen once it converges.

        ``y_stack``: (K, n) per-model {0, 1} labels (OneVsRest's
        relabelings); default the frame's own labels, once per entry of
        ``reg_params``. ``reg_params``: per-model L2 strength
        (CrossValidator's regParam grid); default this estimator's
        ``regParam`` for every model. One of the two must be given. Returns
        K :class:`LogisticRegressionModel` whose summaries carry
        ``n_models``, the shared ``total_dispatches`` and their own
        ``total_iterations``/``total_evals``."""
        from cycloneml_tpu_torch.ml.optim.device_lbfgs import \
            StackedDeviceLBFGS
        from cycloneml_tpu_torch.ml.optim.loss import (
            StackedDistributedLossFunction, stacked_l2_scale,
            validate_binary_labels)
        from cycloneml_tpu_torch.ops.kernels import use_fused_kernels

        if not self.can_fit_stacked():
            raise ValueError(
                "fit_stacked requires a binomial, pure-L2, unbounded, "
                "non-checkpointed configuration (can_fit_stacked)")
        from cycloneml_tpu_torch.oocore import (StreamingDataset,
                                                shard_dataset,
                                                streaming_mode)
        ds = frame.to_instance_dataset(
            self.get("featuresCol"), self.get("labelCol"),
            self.get("weightCol") or None, fp8_capable=True)
        conf = getattr(ds.ctx, "conf", None)
        # streamed stacked fits: ONE epoch serves all K models
        if isinstance(ds, StreamingDataset):
            return self._fit_stacked_streamed(ds, y_stack, reg_params)
        if streaming_mode(conf) == "force":
            sds = shard_dataset(ds)
            try:
                return self._fit_stacked_streamed(sds, y_stack, reg_params)
            finally:
                sds.close()
        if y_stack is None and reg_params is None:
            raise ValueError("fit_stacked needs y_stack or reg_params")
        if y_stack is None:
            y = np.asarray(ds.y_host()[:ds.n_rows], dtype=np.float64)
            y_stack = np.broadcast_to(y, (len(reg_params), len(y)))
        # the caller's storage is kept (OvR hands a data-tier stack, numpy
        # or torch); host math converts one (n,) model row at a time
        if not torch.is_tensor(y_stack):
            y_stack = np.asarray(y_stack)
        n_models = y_stack.shape[0]
        if y_stack.shape[1] != ds.n_rows:
            raise ValueError(
                f"y_stack has {y_stack.shape[1]} rows per model; dataset "
                f"has {ds.n_rows}")
        for kk in range(n_models):
            validate_binary_labels(_row64(y_stack, kk), "fit_stacked")
        if reg_params is None:
            reg_params = np.full(n_models, float(self.get("regParam")))
        reg_params = np.asarray(reg_params, dtype=np.float64)
        if len(reg_params) != n_models:
            raise ValueError("reg_params length != number of stacked models")

        d = ds.n_features
        stats = Summarizer.summarize(ds)
        ds = resolve_fp8_fit(ds, stats, "LogisticRegression(stacked)")
        fp8_scale = ds.x_scale
        features_std = stats.std
        weight_sum = stats.weight_sum
        fit_intercept = self.get("fitIntercept")
        standardize = self.get("standardization")
        fit_with_mean = fit_intercept  # bounds are excluded by eligibility
        inv_std = inv_std_vector(features_std)
        scaled_mean = stats.mean * inv_std if fit_with_mean else np.zeros(d)
        # fp8: the scales fold into the aggregator's inv_std (as in
        # _fit_dataset); the unscaling below keeps the original
        inv_std_agg = inv_std * fp8_scale if fp8_scale is not None \
            else inv_std

        n_coef = d + (1 if fit_intercept else 0)
        x0 = np.zeros((n_models, n_coef))
        if fit_intercept:
            w_real = np.asarray(ds.w_host()[:ds.n_rows], dtype=np.float64)
            # per-model weighted positive mass, one float64 row at a time
            pos = np.array([_row64(y_stack, kk) @ w_real
                            for kk in range(n_models)])
            ok = (pos > 0) & (pos < weight_sum)
            p1 = np.where(ok, pos / weight_sum, 0.5)
            x0[:, d] = np.where(ok, np.log(p1 / (1.0 - p1)), 0.0)

        # the (n_pad, K) label matrix in the data tier ({0, 1} is exact in
        # bf16), bf16 under the fp8 tier (labels mix with f32 margins);
        # built on the host in the data tier, so no (n, K) float64 copy
        # exists, and placed on X's device; X itself is shared via derive
        ydt = torch.bfloat16 if fp8_scale is not None else ds.x.dtype
        n_pad = ds.x.shape[0]
        y_pad = torch.zeros((n_pad, n_models), dtype=ydt)
        for kk in range(n_models):
            y_pad[:ds.n_rows, kk] = torch.as_tensor(_row64(y_stack, kk))
        rt = ds.ctx.mesh_runtime
        ds_stacked = ds.derive(y=rt.device_put_sharded_rows(y_pad))

        if use_fused_kernels(ds.ctx, ds.x):
            base_agg = aggregators.binary_logistic_pallas_scaled(
                d, fit_intercept)
        else:
            base_agg = aggregators.binary_logistic_scaled(d, fit_intercept)
        agg = aggregators.stack_scaled_aggregator(base_agg)
        l2s = stacked_l2_scale(d, n_coef, features_std, standardize)
        adt = compute_dtype(conf)
        dev = ds.x.device
        loss_fn = StackedDistributedLossFunction(
            ds_stacked, agg, n_models, reg=reg_params, l2_scale=l2s,
            weight_sum=weight_sum,
            extra_args=(torch.as_tensor(inv_std_agg, device=dev).to(adt),
                        torch.as_tensor(scaled_mean, device=dev).to(adt)))

        from cycloneml_tpu_torch.conf import LBFGS_DEVICE_CHUNK
        chunk = int(conf.get(LBFGS_DEVICE_CHUNK)) if conf is not None else 0
        # deviceChunk=0 means one dispatch per iteration: chunk 1 here
        opt = StackedDeviceLBFGS(max_iter=self.get("maxIter"),
                                 tol=self.get("tol"), chunk=max(chunk, 1))
        res = opt.minimize(loss_fn, x0)
        if fp8_scale is not None and not np.all(np.isfinite(res.x)):
            return self.fit_stacked(
                fp8_fallback(ds, "LogisticRegression(stacked)",
                             "non-finite fp8 solution"),
                y_stack=y_stack, reg_params=reg_params)
        n_unconverged = sum(
            1 for r in res.converged_reasons if r == "max iterations reached")
        if n_unconverged:
            logger.warning(
                "stacked LogisticRegression: %d of %d models did not "
                "converge in %d iterations", n_unconverged, n_models,
                self.get("maxIter"))

        models = []
        for kk in range(n_models):
            sol = res.x[kk]
            beta = sol[:d] * inv_std
            icpt = float(sol[d]) if fit_intercept else 0.0
            if fit_with_mean:
                icpt -= float(sol[:d] @ scaled_mean)
            model = LogisticRegressionModel(
                coefficient_matrix=beta[None, :],
                intercept_vector=np.array([icpt]),
                num_classes=2, is_multinomial=False)
            self._copy_values(model)
            model._set_parent(self)
            model.summary = LogisticRegressionTrainingSummary(
                objective_history=list(res.loss_histories[kk]),
                total_iterations=int(res.iterations[kk]),
                total_evals=int(res.evals[kk]),
                total_dispatches=loss_fn.n_dispatches,
                n_models=n_models, stacked_evals=loss_fn.n_evals)
            models.append(model)
        return models

    def _fit_stacked_streamed(self, sds, y_stack=None, reg_params=None):
        """The out-of-core leg of :meth:`fit_stacked` (the reference's
        :412-560): K binomial models over ONE shard set, each optimizer
        round ONE streamed epoch whose per-shard aggregator is the
        model-axis one (``StackedStreamingLossFunction``; K1s on the
        card), so the spill is read once a round, not once a model. The
        optimizer is ``StackedHostLBFGS``: every model makes the decisions
        its serial streamed fit would."""
        from cycloneml_tpu_torch.ml.optim.device_lbfgs import \
            StackedHostLBFGS
        from cycloneml_tpu_torch.ml.optim.loss import (
            stacked_l2_scale, validate_binary_labels)
        from cycloneml_tpu_torch.oocore import StackedStreamingLossFunction
        from cycloneml_tpu_torch.oocore.engine import stream_uses_kernels

        if y_stack is None and reg_params is None:
            raise ValueError("fit_stacked needs y_stack or reg_params")
        d = sds.n_features
        stats = sds.summary()   # the write pass's moments: no stats epoch
        weight_sum = stats.weight_sum
        # the fp8 decision ran at spill time (shards._finalize_fp8)
        fp8_scale = sds.x_scale
        if y_stack is None:
            # a grid over the set's own labels: binary-ness from the write
            # pass's histogram, the positives from its label moments
            hist = sds.label_histogram()
            if len(hist) > 2:
                raise ValueError(
                    f"fit_stacked requires binary {{0, 1}} labels; the "
                    f"shard set carries {len(hist)} classes")
            n_models = len(reg_params)
            pos = np.full(n_models, sds.y_moments()[0])
        else:
            if not torch.is_tensor(y_stack):
                y_stack = np.asarray(y_stack)
            n_models = y_stack.shape[0]
            if y_stack.shape[1] != sds.n_rows:
                raise ValueError(
                    f"y_stack has {y_stack.shape[1]} rows per model; the "
                    f"shard set has {sds.n_rows}")
            for kk in range(n_models):
                validate_binary_labels(_row64(y_stack, kk), "fit_stacked")
            # per-model weighted positives over the shards' w, one (n,)
            # host vector beside the caller's (K, n) stack
            w_all = np.concatenate([sds.shard_weights(i)
                                    for i in range(sds.n_shards)])
            pos = np.array([_row64(y_stack, kk) @ w_all
                            for kk in range(n_models)])
        if reg_params is None:
            reg_params = np.full(n_models, float(self.get("regParam")))
        reg_params = np.asarray(reg_params, dtype=np.float64)
        if len(reg_params) != n_models:
            raise ValueError("reg_params length != number of stacked models")

        features_std = stats.std
        fit_intercept = self.get("fitIntercept")
        standardize = self.get("standardization")
        fit_with_mean = fit_intercept  # bounds are excluded by eligibility
        inv_std = inv_std_vector(features_std)
        scaled_mean = stats.mean * inv_std if fit_with_mean else np.zeros(d)
        inv_std_agg = inv_std * fp8_scale if fp8_scale is not None \
            else inv_std
        n_coef = d + (1 if fit_intercept else 0)
        x0 = np.zeros((n_models, n_coef))
        if fit_intercept:
            ok = (pos > 0) & (pos < weight_sum)
            p1 = np.where(ok, pos / weight_sum, 0.5)
            x0[:, d] = np.where(ok, np.log(p1 / (1.0 - p1)), 0.0)

        base_agg = (aggregators.binary_logistic_pallas_scaled(d,
                                                              fit_intercept)
                    if stream_uses_kernels(sds)
                    else aggregators.binary_logistic_scaled(d, fit_intercept))
        agg = aggregators.stack_scaled_aggregator(base_agg)
        l2s = stacked_l2_scale(d, n_coef, features_std, standardize)
        adt = compute_dtype(getattr(sds.ctx, "conf", None))
        dev = sds.ctx.mesh_runtime.device
        # the staged (rows, K) label stack: {0, 1} is exact in bf16;
        # float64 on the parity tier keeps the sums those of the serial
        # streamed fits; never fp8 (labels mix with float32 margins)
        ydt = torch.float64 if adt == torch.float64 else torch.bfloat16
        loss_fn = StackedStreamingLossFunction(
            sds, agg, n_models, reg=reg_params, l2_scale=l2s,
            weight_sum=weight_sum,
            extra_args=(torch.as_tensor(inv_std_agg, device=dev).to(adt),
                        torch.as_tensor(scaled_mean, device=dev).to(adt)),
            y_stack=y_stack, stack_dtype=ydt)
        opt = StackedHostLBFGS(max_iter=self.get("maxIter"),
                               tol=self.get("tol"))
        res = opt.minimize(loss_fn, x0)
        if fp8_scale is not None and not np.all(np.isfinite(res.x)):
            # e4m3 has no inf: an overflow shows as NaN; re-spill at the
            # bf16 rung (recorded) and refit
            bf16 = sds.to_instance_dataset(fp8_capable=False)
            try:
                return self._fit_stacked_streamed(
                    bf16, y_stack=y_stack, reg_params=reg_params)
            finally:
                bf16.close()
        n_unconverged = sum(
            1 for r in res.converged_reasons if r == "max iterations reached")
        if n_unconverged:
            logger.warning(
                "stacked LogisticRegression (streamed): %d of %d models did "
                "not converge in %d iterations", n_unconverged, n_models,
                self.get("maxIter"))
        models = []
        for kk in range(n_models):
            sol = res.x[kk]
            beta = sol[:d] * inv_std
            icpt = float(sol[d]) if fit_intercept else 0.0
            if fit_with_mean:
                icpt -= float(sol[:d] @ scaled_mean)
            model = LogisticRegressionModel(
                coefficient_matrix=beta[None, :],
                intercept_vector=np.array([icpt]),
                num_classes=2, is_multinomial=False)
            self._copy_values(model)
            model._set_parent(self)
            model.summary = LogisticRegressionTrainingSummary(
                objective_history=list(res.loss_histories[kk]),
                total_iterations=int(res.iterations[kk]),
                total_evals=int(res.evals[kk]),
                total_dispatches=loss_fn.n_dispatches,
                n_models=n_models, stacked_evals=loss_fn.n_evals,
                streamed=True, stream_stats=dict(loss_fn.stats))
            models.append(model)
        return models

    def _optimize(self, opt, loss_fn, x0, fp_parts):
        """The optimize tail of the dense, sparse and streamed fits:
        checkpointed training bound to ``fp_parts`` (the dataset and the
        parameters) when ``checkpointDir`` is set, else ``minimize``; then
        the non-convergence warning."""
        if self.get("checkpointDir"):
            import hashlib
            from cycloneml_tpu_torch.parallel.resilience import \
                train_with_checkpoints
            from cycloneml_tpu_torch.util.checkpoint import \
                TrainingCheckpointer
            # the reference's fingerprint: resuming another fit's
            # checkpoint would silently return the wrong model
            fp = hashlib.sha1(repr(fp_parts).encode()).hexdigest()[:16]
            state = train_with_checkpoints(
                opt, loss_fn, x0,
                TrainingCheckpointer(self.get("checkpointDir")),
                interval=self.get("checkpointInterval"), fingerprint=fp)
        else:
            state = opt.minimize(loss_fn, x0)
        if state.converged_reason == "max iterations reached":
            logger.warning(
                "LogisticRegression did not converge in %d iterations",
                self.get("maxIter"))
        return state

    def _fit_dataset(self, ds) -> "LogisticRegressionModel":
        from cycloneml_tpu_torch.oocore import (StreamingDataset,
                                                shard_dataset,
                                                streaming_mode)
        conf = getattr(ds.ctx, "conf", None)
        streamed = isinstance(ds, StreamingDataset)
        if not streamed and streaming_mode(conf) == "force":
            # spill the in-core dataset and fit over streamed epochs; the
            # spill is this fit's, released once the model is built
            sds = shard_dataset(ds)
            try:
                return self._fit_dataset(sds)
            finally:
                sds.close()
        d = ds.n_features
        # a shard set carries its moments and label histogram from the
        # write pass: no statistics epoch
        stats = ds.summary() if streamed else Summarizer.summarize(ds)
        if not streamed:
            # the fp8 safety rail: the envelope probe may swap the
            # quantized dataset for its bfloat16 dequantization (recorded)
            ds = resolve_fp8_fit(ds, stats, "LogisticRegression")
        fp8_scale = ds.x_scale
        features_std = stats.std
        weight_sum = stats.weight_sum

        if streamed:
            hist = ds.label_histogram()
            num_classes = max(len(hist), 2) if ds.n_rows else 2
        else:
            y_host = ds.y_host()
            w_host = ds.w_host()
            num_classes = int(y_host.max()) + 1 if ds.n_rows else 2
        family = self.get("family")
        if family == "auto":
            is_multinomial = num_classes > 2
        else:
            is_multinomial = family == "multinomial"
            if not is_multinomial and num_classes > 2:
                raise ValueError(
                    f"Binomial family requires <= 2 label classes, found "
                    f"{num_classes} (the reference rejects this too)")
            num_classes = max(num_classes, 2)
        if streamed:
            histogram = np.zeros(num_classes)
            histogram[:len(hist)] = hist[:num_classes]
        else:
            histogram = np.bincount(y_host.astype(np.int64),
                                    weights=w_host,
                                    minlength=num_classes)[:num_classes]

        fit_intercept = self.get("fitIntercept")
        standardize = self.get("standardization")
        reg = self.get("regParam")
        alpha = self.get("elasticNetParam")
        l2 = (1.0 - alpha) * reg
        l1 = alpha * reg

        # fitWithMean (ref LogisticRegression.scala:946-955, SPARK-34448):
        # with a free intercept, train on CENTERED standardized features;
        # the intercept is mapped back after optimization. Intercept
        # bounds pin the intercept, so they turn it off
        fit_with_mean = fit_intercept and all(
            self._opt(p) is None for p in ("lowerBoundsOnIntercepts",
                                           "upperBoundsOnIntercepts"))

        from cycloneml_tpu_torch.oocore.engine import stream_uses_kernels
        from cycloneml_tpu_torch.ops.kernels import use_fused_kernels
        # standardization folds INTO the aggregator read on every path:
        # no standardized copy of X exists
        inv_std = inv_std_vector(features_std)
        scaled_mean = stats.mean * inv_std if fit_with_mean else None
        # fp8 rung: x_hat = (codes o scale - mu) / sigma = codes o (scale /
        # sigma) - mu / sigma, so the AGGREGATOR reads inv_std o scale, while
        # scaled_mean and the final unscaling keep the original inv_std
        inv_std_agg = inv_std * fp8_scale if fp8_scale is not None \
            else inv_std
        k = num_classes
        if is_multinomial:
            # no kernel in either package: the plain aggregator
            agg = aggregators.multinomial_logistic_scaled(d, k,
                                                          fit_intercept)
            n_coef = d * k + (k if fit_intercept else 0)
            x0 = np.zeros(n_coef)
            if fit_intercept and histogram.min() > 0:
                logs = np.log(histogram / histogram.sum())
                x0[d * k:] = logs - logs.mean()
            l2_fn = l2_regularization(
                l2, d * k, fit_intercept,
                features_std=np.tile(features_std, k),
                standardize=standardize) if l2 > 0 else None
        else:
            if (stream_uses_kernels(ds) if streamed
                    else use_fused_kernels(ds.ctx, ds.x)):
                agg = aggregators.binary_logistic_pallas_scaled(
                    d, fit_intercept)
            else:
                agg = aggregators.binary_logistic_scaled(d, fit_intercept)
            n_coef = d + (1 if fit_intercept else 0)
            x0 = np.zeros(n_coef)
            if fit_intercept and 0 < histogram[1:].sum() < weight_sum:
                p1 = histogram[1:].sum() / weight_sum
                x0[d] = np.log(p1 / (1.0 - p1))
            l2_fn = l2_regularization(
                l2, d, fit_intercept, features_std=features_std,
                standardize=standardize) if l2 > 0 else None

        mu_or_zero = scaled_mean if fit_with_mean else np.zeros(d)
        # the standardization vectors ride in the ACCUMULATOR tier: the
        # fold's corrections must not round through a bf16 data tier
        adt = compute_dtype(conf)
        dev = ds.ctx.mesh_runtime.device if streamed else ds.x.device
        extras = (torch.as_tensor(inv_std_agg, device=dev).to(adt),
                  torch.as_tensor(mu_or_zero, device=dev).to(adt))
        if streamed:
            # the streamed twin: the same aggregator, extras and
            # normalization, one evaluation one epoch over the shards
            from cycloneml_tpu_torch.oocore import StreamingLossFunction
            loss_fn = StreamingLossFunction(ds, agg, l2_fn, weight_sum,
                                            extra_args=extras)
        else:
            loss_fn = DistributedLossFunction(ds, agg, l2_fn, weight_sum,
                                              extra_args=extras)

        if self._has_bounds():
            # ref createOptimizer: L-BFGS-B whenever bounds are set, and
            # bounds only with none or L2 regularization (any nonzero
            # elasticNetParam is refused, whatever regParam is)
            if alpha != 0.0:
                raise ValueError(
                    "coefficient bounds are only supported with none or L2 "
                    "regularization (elasticNetParam must be 0, as the "
                    "reference enforces)")
            lo, hi = self._flat_bounds(d, k, is_multinomial, fit_intercept,
                                       n_coef, features_std)
            opt = LBFGSB(lo, hi, max_iter=self.get("maxIter"),
                         tol=self.get("tol"))
        elif l1 > 0:
            # the L1 part on the feature coordinates, never the intercept;
            # in the original feature space under standardization=false
            n_feat = d * k if is_multinomial else d
            stds = np.tile(features_std, k) if is_multinomial \
                else features_std
            l1_vec = np.zeros(n_coef)
            l1_vec[:n_feat] = l1 if standardize else np.where(
                stds > 0, l1 / np.where(stds > 0, stds, 1.0), 0.0)
            opt = OWLQN(max_iter=self.get("maxIter"), tol=self.get("tol"),
                        l1_reg=l1_vec)
        else:
            opt = LBFGS(max_iter=self.get("maxIter"), tol=self.get("tol"))
            from cycloneml_tpu_torch.conf import LBFGS_DEVICE_CHUNK
            chunk = int(conf.get(LBFGS_DEVICE_CHUNK)) \
                if conf is not None else 0
            # the chunked device optimizer runs whole iterations a
            # dispatch: checkpoints want every iteration's state, so a
            # checkpointed fit keeps the host optimizer (the reference's
            # rule)
            if chunk > 0 and not streamed and \
                    not self.get("checkpointDir") and (
                        l2_fn is None or hasattr(l2_fn, "traceable")):
                from cycloneml_tpu_torch.ml.optim.device_lbfgs import \
                    DeviceLBFGS
                opt = DeviceLBFGS(max_iter=self.get("maxIter"),
                                  tol=self.get("tol"), chunk=chunk)
                # this fit has a streaming twin: over budget, the guard
                # degrades to it instead of warning or raising
                opt.oocore_fallback = True
        from cycloneml_tpu_torch.observe.costs import OutOfCoreRequired
        try:
            state = self._optimize(opt, loss_fn, x0, (
                ds.n_rows, d, num_classes, float(weight_sum),
                np.asarray(histogram).round(6).tolist(),
                np.asarray(features_std).round(6).tolist(),
                reg, alpha, self.get("tol"), fit_intercept, standardize,
                fit_with_mean,
            ))
        except OutOfCoreRequired as e:
            # the guard's terminal degradation: the whole fit again over
            # streamed epochs, O(shard) device memory
            logger.warning("LogisticRegression: %s", e)
            sds = shard_dataset(ds)
            try:
                return self._fit_dataset(sds)
            finally:
                sds.close()

        sol = np.asarray(state.x, dtype=np.float64)
        if fp8_scale is not None and not np.all(np.isfinite(sol)):
            # e4m3 has no inf: an overflowing fp8 fit surfaces as NaN in
            # the solution; refit on the bfloat16 rung (a shard set
            # re-spills there)
            if streamed:
                bf16 = ds.to_instance_dataset(fp8_capable=False)
                try:
                    return self._fit_dataset(bf16)
                finally:
                    bf16.close()
            return self._fit_dataset(fp8_fallback(
                ds, "LogisticRegression", "non-finite fp8 solution"))
        if is_multinomial:
            wstd = sol[:d * k].reshape(k, d)
            wmat = wstd * inv_std[None, :]
            icpt = sol[d * k:] if fit_intercept else np.zeros(k)
            if fit_with_mean:
                # centered-problem intercepts back to the original space
                # (ref LogisticRegression.scala:1018-1024)
                icpt = icpt - wstd @ scaled_mean
            if not self._has_bounds():
                if reg == 0.0:
                    # identifiability without regularization: center the
                    # coefficients over the classes (ref :656-674, glmnet)
                    wmat = wmat - wmat.mean(axis=0, keepdims=True)
                if fit_intercept:
                    # intercepts are never regularized: their common
                    # constant is free under any regParam (ref :676-681)
                    icpt = icpt - icpt.mean()
            model = LogisticRegressionModel(
                coefficient_matrix=wmat, intercept_vector=icpt,
                num_classes=k, is_multinomial=True, uid=self.uid)
        else:
            beta = sol[:d] * inv_std
            icpt = float(sol[d]) if fit_intercept else 0.0
            if fit_with_mean:
                # ref LogisticRegression.scala:1027-1031: solution(num) -= adapt
                icpt -= float(sol[:d] @ scaled_mean)
            model = LogisticRegressionModel(
                coefficient_matrix=beta[None, :],
                intercept_vector=np.array([icpt]), num_classes=2,
                is_multinomial=False, uid=self.uid)
        self._copy_values(model)
        model._set_parent(self)
        model.summary = LogisticRegressionTrainingSummary(
            objective_history=list(state.loss_history),
            total_iterations=state.iteration,
            total_evals=loss_fn.n_evals,
            total_dispatches=loss_fn.n_dispatches, streamed=streamed,
            stream_stats=dict(loss_fn.stats) if streamed else None)
        return model


    def _fit_sparse(self, ds: SparseInstanceDataset
                    ) -> "LogisticRegressionModel":
        """Binomial logistic regression over the sparse (ELL / hybrid)
        tier (the reference's ``_fit_sparse``, :563-650): std-only
        standardization folded into the read (sparsity kept), the log-odds
        intercept start, and the host optimizer the reference picks —
        L-BFGS-B under bounds, OWL-QN with an L1 part (per feature when
        ``standardization=False``), else L-BFGS, each evaluation one pass
        of the sparse aggregator (S1 + S2 on the card) and one readback.
        Coefficients are unscaled by inv_std."""
        from cycloneml_tpu_torch.dataset.sparse import (
            sparse_feature_std, standardize_sparse_dataset)
        from cycloneml_tpu_torch.ml.optim.sparse_aggregators import (
            binary_logistic_sparse, binary_logistic_sparse_hybrid)

        d = ds.n_features
        w_host = ds.w_host()
        y_host = ds.y_host()
        mask = w_host > 0
        num_classes = int(y_host[mask].max()) + 1 if mask.any() else 2
        family = self.get("family")
        if family == "multinomial" or (family == "auto" and num_classes > 2):
            raise NotImplementedError(
                "sparse-tier training is binomial only; hash or densify "
                "for multinomial")
        if num_classes > 2:
            raise ValueError(
                f"Binomial family requires <= 2 label classes, found "
                f"{num_classes} (the reference rejects this too)")
        histogram = np.bincount(y_host[mask].astype(np.int64),
                                weights=w_host[mask], minlength=2)[:2]
        weight_sum = float(w_host[mask].sum())

        fit_intercept = self.get("fitIntercept")
        standardize = self.get("standardization")
        reg = self.get("regParam")
        alpha = self.get("elasticNetParam")
        l2 = (1.0 - alpha) * reg
        l1 = alpha * reg

        features_std = sparse_feature_std(ds)
        ds_std, inv_std = standardize_sparse_dataset(ds, features_std)
        agg = (binary_logistic_sparse_hybrid(d, fit_intercept)
               if ds.is_hybrid else binary_logistic_sparse(d, fit_intercept))
        n_coef = d + (1 if fit_intercept else 0)
        x0 = np.zeros(n_coef)
        if fit_intercept and 0 < histogram[1] < weight_sum:
            p1 = histogram[1] / weight_sum
            x0[d] = np.log(p1 / (1.0 - p1))
        l2_fn = l2_regularization(
            l2, d, fit_intercept, features_std=features_std,
            standardize=standardize) if l2 > 0 else None
        loss_fn = DistributedLossFunction(ds_std, agg, l2_fn, weight_sum)

        if self._has_bounds():
            if alpha != 0.0:
                raise ValueError(
                    "coefficient bounds are only supported with none or L2 "
                    "regularization (elasticNetParam must be 0, as the "
                    "reference enforces)")
            lo, hi = self._flat_bounds(d, 2, False, fit_intercept, n_coef,
                                       features_std)
            opt = LBFGSB(lo, hi, max_iter=self.get("maxIter"),
                         tol=self.get("tol"))
        elif l1 > 0:
            l1_vec = np.zeros(n_coef)
            per = np.full(d, l1)
            if not standardize:
                per = np.where(features_std > 0,
                               l1 / np.where(features_std > 0,
                                             features_std, 1.0), 0.0)
            l1_vec[:d] = per
            opt = OWLQN(max_iter=self.get("maxIter"), tol=self.get("tol"),
                        l1_reg=l1_vec)
        else:
            opt = LBFGS(max_iter=self.get("maxIter"), tol=self.get("tol"))
        state = self._optimize(opt, loss_fn, x0, (
            ds.n_rows, d, 2, float(weight_sum),
            np.asarray(histogram).round(6).tolist(),
            np.asarray(features_std).round(6).tolist(),
            reg, alpha, self.get("tol"), fit_intercept, standardize,
            "sparse",
        ))

        sol = np.asarray(state.x, dtype=np.float64)
        beta = sol[:d] * inv_std
        icpt = float(sol[d]) if fit_intercept else 0.0
        model = LogisticRegressionModel(
            coefficient_matrix=beta[None, :],
            intercept_vector=np.array([icpt]),
            num_classes=2, is_multinomial=False, uid=self.uid)
        self._copy_values(model)
        model._set_parent(self)
        model.summary = LogisticRegressionTrainingSummary(
            objective_history=list(state.loss_history),
            total_iterations=state.iteration,
            total_evals=loss_fn.n_evals,
            total_dispatches=loss_fn.n_dispatches)
        return model


def _row64(y_stack, kk: int) -> np.ndarray:
    """Model ``kk``'s labels of a (K, n) stack (numpy or torch, any dtype)
    as a float64 host vector."""
    row = y_stack[kk]
    if torch.is_tensor(row):
        return row.to(torch.float64).cpu().numpy()
    return np.asarray(row, dtype=np.float64)


class LogisticRegressionModel(ProbabilisticClassificationModel,
                              _LogisticRegressionParams, HasLabelCol,
                              MLWritable, MLReadable):
    """Fitted model: margins, sigmoid (binomial) or softmax (multinomial,
    a ``(k, d)`` coefficient matrix and ``(k,)`` intercepts)
    probabilities, threshold-aware binomial predictions."""

    def __init__(self, coefficient_matrix: Optional[np.ndarray] = None,
                 intercept_vector: Optional[np.ndarray] = None,
                 num_classes: int = 2, is_multinomial: bool = False,
                 uid=None):
        super().__init__(uid)
        self._declare_lr_params()
        self._p_label_col()
        self._coef = np.asarray(coefficient_matrix, dtype=np.float64) \
            if coefficient_matrix is not None else None
        self._icpt = np.asarray(intercept_vector, dtype=np.float64) \
            if intercept_vector is not None else None
        self._num_classes = num_classes
        self._is_multinomial = bool(is_multinomial)
        self.summary: Optional[LogisticRegressionTrainingSummary] = None

    @property
    def coefficients(self) -> DenseVector:
        if self._is_multinomial:
            raise ValueError("use coefficient_matrix for multinomial models")
        return Vectors.dense(self._coef[0])

    @property
    def intercept(self) -> float:
        if self._is_multinomial:
            raise ValueError("use intercept_vector for multinomial models")
        return float(self._icpt[0])

    @property
    def coefficient_matrix(self) -> DenseMatrix:
        return DenseMatrix.from_array(self._coef)

    @property
    def intercept_vector(self) -> DenseVector:
        return Vectors.dense(self._icpt)

    @property
    def num_classes(self) -> int:
        return self._num_classes

    @property
    def num_features(self) -> int:
        return self._coef.shape[1]

    def evaluate(self, frame) -> "BinaryLogisticRegressionSummary":
        """The binary metrics of this model over ``frame``
        (:class:`BinaryLogisticRegressionSummary`); binomial models only."""
        return _lr_evaluate(self, frame)

    def _raw_prediction(self, x: np.ndarray) -> np.ndarray:
        if self._is_multinomial:
            return x @ self._coef.T + self._icpt[None, :]
        m = x @ self._coef[0] + self._icpt[0]
        return np.stack([-m, m], axis=1)

    def _raw_to_probability(self, raw: np.ndarray) -> np.ndarray:
        if self._is_multinomial:
            e = np.exp(raw - raw.max(axis=1, keepdims=True))
            return e / e.sum(axis=1, keepdims=True)
        # binomial raw is (-m, m): probability is sigmoid(m), not the
        # softmax of the pair (the reference's raw2probabilityInPlace)
        p1 = 1.0 / (1.0 + np.exp(-raw[:, 1]))
        return np.stack([1.0 - p1, p1], axis=1)

    def _raw_to_prediction(self, raw: np.ndarray) -> np.ndarray:
        if self._is_multinomial:
            return np.argmax(raw, axis=1).astype(np.float64)
        prob1 = 1.0 / (1.0 + np.exp(-raw[:, 1]))
        return (prob1 > self.get("threshold")).astype(np.float64)

    def _save_data(self, path: str) -> None:
        save_arrays(path, coef=self._coef, icpt=self._icpt,
                    num_classes=np.array(self._num_classes),
                    is_multinomial=np.array(self._is_multinomial))

    def _load_data(self, path: str, meta) -> None:
        arrs = load_arrays(path)
        self._coef = arrs["coef"]
        self._icpt = arrs["icpt"]
        self._num_classes = int(arrs["num_classes"])
        self._is_multinomial = bool(arrs["is_multinomial"])

    def __repr__(self) -> str:
        return (f"LogisticRegressionModel(uid={self.uid}, "
                f"numClasses={self._num_classes}, "
                f"numFeatures={self.num_features})")


def _lr_evaluate(model, frame) -> "BinaryLogisticRegressionSummary":
    """Score ``frame`` with ``model`` and summarize it against the model's
    label column: the probability of class 1 as the score, the model's
    threshold-aware predictions for the accuracy."""
    if model._is_multinomial:
        raise ValueError("evaluate() summary is binary-only "
                         "(ref BinaryLogisticRegressionSummary)")
    out = model.transform(frame)
    probs = np.asarray(out[model.get("probabilityCol")])
    scores = probs[:, 1] if probs.ndim == 2 else probs
    labels = np.asarray(frame[model.get("labelCol")], dtype=np.float64)
    preds = np.asarray(out[model.get("predictionCol")], dtype=np.float64)
    return BinaryLogisticRegressionSummary(scores, labels, predictions=preds)


class LogisticRegressionTrainingSummary:
    """Objective history and optimizer counts of a fit: iterations, loss/
    gradient evaluations and host round trips (one per line search or
    device chunk); ``n_models`` > 1 when the model trained in a stacked fit
    of that many models, whose dispatches and ``stacked_evals`` (the
    lockstep evaluations of all of them, each one aggregation) it
    shared. ``streamed``: the fit ran over epochs of shards, and then
    ``total_dispatches`` counts shard launches (evaluations x shards) and
    ``stream_stats`` holds its epochs' split (``oocore/objective``)."""

    def __init__(self, objective_history, total_iterations,
                 total_evals=None, total_dispatches=None, n_models=1,
                 stacked_evals=None, streamed=False, stream_stats=None):
        self.objective_history = objective_history
        self.total_iterations = total_iterations
        self.total_evals = total_evals
        self.total_dispatches = total_dispatches
        self.n_models = n_models
        self.stacked_evals = stacked_evals
        self.streamed = bool(streamed)
        self.stream_stats = stream_stats


class BinaryLogisticRegressionSummary:
    """Binary metrics over a scored frame (the reference's
    BinaryLogisticRegressionSummary): the ROC and precision-recall curves,
    the area under ROC and the by-threshold curves, from one sorted pass
    (:func:`~cycloneml_tpu_torch.ml.evaluation.evaluators.
    binary_curve_points`, tied scores collapsed), all float64 on the
    host."""

    def __init__(self, scores: np.ndarray, labels: np.ndarray,
                 predictions: Optional[np.ndarray] = None):
        if len(scores) == 0:
            raise ValueError("cannot summarize an empty frame")
        self._predictions = predictions
        (self._thresholds, self._tps, self._fps,
         self._p, self._n) = binary_curve_points(scores, labels)
        self._labels = labels
        self._scores = scores

    @property
    def roc(self) -> np.ndarray:
        """(FPR, TPR) points with the (0, 0) and (1, 1) ends."""
        fpr = np.concatenate([[0.0], self._fps / self._n, [1.0]])
        tpr = np.concatenate([[0.0], self._tps / self._p, [1.0]])
        return np.column_stack([fpr, tpr])

    @property
    def area_under_roc(self) -> float:
        r = self.roc
        return float(_trapezoid(r[:, 1], r[:, 0]))

    areaUnderROC = area_under_roc

    def _precision(self) -> np.ndarray:
        return self._tps / np.maximum(self._tps + self._fps, 1e-300)

    @property
    def pr(self) -> np.ndarray:
        """(recall, precision) points from recall 0, which takes the first
        point's precision."""
        precision = self._precision()
        return np.column_stack([
            np.concatenate([[0.0], self._tps / self._p]),
            np.concatenate([[precision[0]], precision])])

    def precision_by_threshold(self) -> np.ndarray:
        return np.column_stack([self._thresholds, self._precision()])

    def recall_by_threshold(self) -> np.ndarray:
        return np.column_stack([self._thresholds, self._tps / self._p])

    def f_measure_by_threshold(self, beta: float = 1.0) -> np.ndarray:
        p, r = self._precision(), self._tps / self._p
        b2 = beta * beta
        f = (1 + b2) * p * r / np.maximum(b2 * p + r, 1e-300)
        return np.column_stack([self._thresholds, f])

    @property
    def accuracy(self) -> float:
        """Against the model's own (threshold-aware) predictions when the
        summary has them, else scores above 0.5."""
        pred = (self._predictions if self._predictions is not None
                else (self._scores > 0.5).astype(np.float64))
        return float((pred == self._labels).mean())
