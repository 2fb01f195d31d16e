"""ModelServer: low-latency inference over prepared bucket programs.

The port's counterpart of ``cycloneml_tpu/serving/server.py``. Registration
(never a request) pays every preparation: one program a power-of-two row
bucket, on the card a CUDA graph over the hand-written margins kernel
(``serving/batcher.py``). A request's life is: queue -> coalesce (the
batcher's window) -> admission check -> pad into the bucket's buffer ->
replay the bucket's program -> split the results.

K homogeneous models register as a gang: one kernel launch scores all K a
dispatch, so a model zoo multiplies throughput, not preparation or
dispatch overhead.

Observability: every dispatch gets a ``serving`` span and every request a
``request`` span under it; latency and throughput feed the metrics
registry (the context's ``metrics_registry`` when the server has a
context). The reference also posts its stats to the listener bus and the
status store, ROADMAP Queue 1 item 12.
"""

from __future__ import annotations

import concurrent.futures
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from cycloneml_tpu_torch.serving.batcher import (ModelLane, ServingError,
                                                 ServingOverloaded)
from cycloneml_tpu_torch.serving.buckets import bucket_sizes
from cycloneml_tpu_torch.serving.servable import (GangServable, as_servable,
                                                  serving_dtype, torch_dtype)

logger = logging.getLogger(__name__)


class ModelServer:
    """Registry, micro-batcher and admission control over servable models.

    ``ctx`` (a CycloneContext) supplies the conf, the device and the
    metrics registry; without one the server reads ``conf`` (or the
    defaults) and keeps a private registry. Its device is
    ``cyclone.master``'s: the card unless ``cyclone.master=cpu``, and on
    ``cuda`` with no card the server raises. Keyword overrides beat conf.
    """

    def __init__(self, ctx=None, *, conf=None, max_batch: Optional[int] = None,
                 window_ms: Optional[float] = None, dtype=None,
                 max_queue: Optional[int] = None,
                 shed_after_ms: Optional[float] = None,
                 max_retries: Optional[int] = None, registry=None,
                 quantize: Optional[bool] = None):
        from cycloneml_tpu_torch.conf import (
            MASTER, SERVING_MAX_BATCH, SERVING_MAX_QUEUE,
            SERVING_MAX_RETRIES, SERVING_QUANTIZE, SERVING_SHED_AFTER_MS,
            SERVING_WINDOW_MS, CycloneConf,
        )
        from cycloneml_tpu_torch.mesh import resolve_device
        if ctx is None:
            from cycloneml_tpu_torch.context import active_context
            ctx = active_context()
        self.ctx = ctx
        if conf is not None:
            self.conf = conf  # an explicit conf wins (budget-guard tests)
        else:
            self.conf = ctx.conf if ctx is not None else CycloneConf()
        self.device = (ctx.device if ctx is not None and conf is None
                       else resolve_device(self.conf.get(MASTER)))
        if registry is not None:
            self.registry = registry
        elif ctx is not None:
            self.registry = ctx.metrics_registry
        else:
            from cycloneml_tpu_torch.util.metrics import MetricsRegistry
            self.registry = MetricsRegistry()
        self.max_batch = int(max_batch if max_batch is not None
                             else self.conf.get(SERVING_MAX_BATCH))
        self.window_s = float(window_ms if window_ms is not None
                              else self.conf.get(SERVING_WINDOW_MS)) / 1e3
        self.max_queue = int(max_queue if max_queue is not None
                             else self.conf.get(SERVING_MAX_QUEUE))
        self.shed_after_s = float(
            shed_after_ms if shed_after_ms is not None
            else self.conf.get(SERVING_SHED_AFTER_MS)) / 1e3
        self.max_retries = int(max_retries if max_retries is not None
                               else self.conf.get(SERVING_MAX_RETRIES))
        self.dtype = (np.dtype(dtype) if dtype is not None
                      else serving_dtype(self.conf))
        self.torch_dtype = torch_dtype(self.dtype)
        # quantized predict tier: fp8 coefficient codes and per-row scales,
        # smaller bucket peaks, so admission fits more gang models under
        # the same budgetFraction
        self.quantize = bool(quantize if quantize is not None
                             else self.conf.get(SERVING_QUANTIZE))
        self._lanes: Dict[str, ModelLane] = {}
        # names whose preparation is in flight: _install releases the lock
        # while it prepares, so the duplicate-name check covers them too
        self._registering: set = set()
        self._lock = threading.Lock()
        self._stopped = False

    # -- registration -----------------------------------------------------------

    def register(self, name: str, model: Any) -> Dict[str, Any]:
        """Adapt ``model`` and prepare every shape bucket's program under
        ``name``; returns the entry's stats, the compile ledger among
        them. On the card a bucket whose graph fails to capture, or a
        kernel that fails to build, raises here."""
        return self._install(name, as_servable(model))

    def register_gang(self, name: str, models: Sequence[Any]
                      ) -> Dict[str, Any]:
        """Register K homogeneous models as one program a bucket.
        ``predict`` on a gang returns a list of K per-model results."""
        gang = GangServable([as_servable(m) for m in models])
        return self._install(name, gang)

    def _install(self, name: str, servable) -> Dict[str, Any]:
        with self._lock:
            if self._stopped:
                raise ServingError("model server is stopped", status=503)
            if name in self._lanes or name in self._registering:
                raise ValueError(f"model {name!r} already registered")
            self._registering.add(name)
            lane = ModelLane(name, servable, self)
        try:
            t0 = time.perf_counter()
            lane.warm_up()
            logger.info(
                "serving: registered %r (%s, d=%d, %s): %d buckets "
                "prepared, %.1f ms", name,
                "gang[%d]" % servable.n_models if lane.is_gang else "serial",
                servable.n_features, lane.instance, lane.compiles,
                (time.perf_counter() - t0) * 1e3)
            with self._lock:
                # stop() may have run while the preparation was in flight
                if self._stopped:
                    raise ServingError("model server stopped during "
                                       "registration", status=503)
                lane.start()
                self._lanes[name] = lane
        finally:
            with self._lock:
                self._registering.discard(name)
        return lane.stats()

    # -- request path -----------------------------------------------------------

    def predict(self, name: str, x, timeout: Optional[float] = None):
        """Score ``x`` (a row vector or an (n, d) matrix) against ``name``.

        Blocks until the micro-batcher answers; requests larger than
        ``maxBatch`` rows split into maxBatch-row sub-requests and
        reassemble under one deadline. Serial models return an (n,)
        prediction array; gangs a list of K per-model arrays.
        """
        lane = self._lane(name)
        x2 = np.asarray(x, dtype=self.dtype)
        if x2.ndim == 1:
            # a single feature row, except a 0-length 1-D array: an empty
            # wire payload (rows: []) is an empty request, not a d=0 row
            x2 = (x2.reshape(0, lane.servable.n_features) if x2.size == 0
                  else x2[None, :])
        if x2.ndim != 2 or x2.shape[1] != lane.servable.n_features:
            raise ValueError(
                f"model {name!r} expects (n, {lane.servable.n_features}) "
                f"features, got {x2.shape}")
        if x2.shape[0] == 0:
            empty = np.zeros((0,), dtype=np.float64)
            return ([empty] * lane.servable.n_models if lane.is_gang
                    else empty)
        futures = []
        try:
            for i in range(0, x2.shape[0], self.max_batch):
                futures.append(lane.submit(x2[i:i + self.max_batch]))
        except ServingError:
            # shed the whole request as a unit: earlier chunks must not
            # burn dispatches on results the caller will never read
            for f in futures:
                lane.try_cancel(f)
            raise
        if timeout is None:
            # the worst honest wait: window, shed patience and dispatch
            # slack a sub-request
            timeout = (self.window_s + self.shed_after_s
                       + 30.0) * len(futures)
        # one total deadline for every chunk
        deadline = time.monotonic() + timeout
        parts = []
        try:
            for f in futures:
                parts.append(f.result(
                    timeout=max(0.0, deadline - time.monotonic())))
        except BaseException as e:
            for f in futures:
                if not f.done():
                    lane.try_cancel(f)
            if isinstance(e, concurrent.futures.TimeoutError):
                raise ServingError(
                    f"model {name!r} request timed out after {timeout:.1f}s",
                    status=504, cause=e) from e
            raise
        if lane.is_gang:
            if len(parts) == 1:
                return parts[0]
            return [np.concatenate([p[k] for p in parts])
                    for k in range(lane.servable.n_models)]
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def _lane(self, name: str) -> ModelLane:
        with self._lock:
            lane = self._lanes.get(name)
        if lane is None:
            raise KeyError(
                f"no model {name!r} registered (have: "
                f"{sorted(self._lanes) or 'none'})")
        return lane

    # -- introspection ----------------------------------------------------------

    @property
    def models(self) -> List[str]:
        with self._lock:
            return sorted(self._lanes)

    def n_features(self, name: str) -> int:
        return self._lane(name).servable.n_features

    def compile_counts(self) -> Dict[str, int]:
        """Bucket programs prepared a model (on the card, CUDA graphs
        captured), all at registration: equal to the bucket count, and
        flat thereafter."""
        with self._lock:
            return {n: lane.compiles for n, lane in self._lanes.items()}

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            lanes = dict(self._lanes)
        models = {n: lane.stats() for n, lane in lanes.items()}
        totals = {k: sum(m[k] for m in models.values())
                  for k in ("requests", "rows", "batches", "shed",
                            "retries", "compiles", "coalesced")}
        totals["models"] = len(models)
        totals["buckets"] = len(bucket_sizes(self.max_batch))
        return {"models": models, "totals": totals,
                "maxBatch": self.max_batch,
                "windowMs": self.window_s * 1e3,
                "dtype": self.dtype.name,
                "quantize": self.quantize}

    def stop(self) -> None:
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            lanes = list(self._lanes.values())
        for lane in lanes:
            lane.stop()

    def __enter__(self) -> "ModelServer":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
