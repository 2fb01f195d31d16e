"""Dynamic micro-batching: one lane (queue, worker thread and bucket
programs) per registered model.

The port's counterpart of ``cycloneml_tpu/serving/batcher.py``. Clipper's
adaptive batching contract (Crankshaw et al., NSDI 2017): a request waits
at most ``cyclone.serving.windowMs`` for co-riders before its batch
dispatches, and a batch never exceeds ``cyclone.serving.maxBatch`` rows.
Coalesced rows pad up to a power-of-two bucket (buckets.py).

**Each bucket one CUDA graph.** On the card, registration captures one
``torch.cuda.CUDAGraph`` a bucket on the lane's own stream, over buffers
allocated before the capture: the copy of the bucket's pinned host input
to the device, the ``serving_margins`` launch (``csrc/serving_margins.cu``)
and the copy of the margins to a pinned host output. A dispatch writes the
coalesced rows into the bucket's pinned input and zeroes the pad rows,
replays the graph, waits on the lane's stream and reads the pinned output.
The lane's bucket table is the compile ledger: one entry a bucket at
registration, none added by a request, and no device memory allocated in
the steady state. A graph binds its lane's parameter addresses, so graphs
are per lane (the reference shares one executable between same-signature
models); same-signature lanes share the built kernel library. A graph
that fails to capture, or a kernel that fails to build, makes ``register``
raise: the card never serves through eager launches or the plain twin. On
the CPU the table holds the plain twin's callables.

Before every dispatch the lane runs admission control against the memory
budget guard (``observe/costs.check_budget``) over the bucket's peak
predicted from shapes (:func:`bucket_peak_bytes`) plus live
``torch.cuda.memory_allocated`` on the lane's device. An over-budget batch
is requeued (backpressure) and re-checked each window until its oldest
request has waited ``cyclone.serving.shedAfterMs``, then shed with a
503-style :class:`ServingOverloaded`: the guard path never raises
``MemoryBudgetError``.

Dispatch rides the chaos harness (``serving.dispatch`` injection point):
transient failures retry with backoff up to ``cyclone.serving.maxRetries``;
permanent failures (``parallel/resilience.classify_failure``) fail every
request in the batch with a 5xx :class:`ServingError`. Every outcome
completes the request futures. Usage attribution, the flight recorder's
shed trigger and the skew detector's dispatch samples are ROADMAP Queue 1
item 12.
"""

from __future__ import annotations

import collections
import logging
import random
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from cycloneml_tpu_torch.observe import costs, tracing
from cycloneml_tpu_torch.ops import kernels
from cycloneml_tpu_torch.serving.buckets import bucket_for, bucket_sizes
from cycloneml_tpu_torch.serving.servable import GangServable
from cycloneml_tpu_torch.util.metrics import Histogram

logger = logging.getLogger(__name__)

# one capture at a time in the process: a capture's stream must see no
# other thread's capture begin on the same device
_CAPTURE_LOCK = threading.Lock()


class ServingError(RuntimeError):
    """A request the server could not answer; carries an HTTP-shaped
    ``status`` (5xx) so wire frontends map it without string matching."""

    def __init__(self, msg: str, status: int = 500,
                 cause: Optional[BaseException] = None):
        super().__init__(msg)
        self.status = int(status)
        self.cause = cause


class ServingOverloaded(ServingError):
    """Load was shed: queue full, or admission control could not fit the
    dispatch within the memory budget before the shed deadline (503)."""

    def __init__(self, msg: str, cause: Optional[BaseException] = None):
        super().__init__(msg, status=503, cause=cause)


class _Request:
    __slots__ = ("x", "n", "future", "t_enq")

    def __init__(self, x: np.ndarray):
        self.x = x
        self.n = x.shape[0]
        self.future: "Future" = Future()
        self.t_enq = time.perf_counter()


def bucket_peak_bytes(servable, bucket: int, dtype, quantize: bool) -> int:
    """A bucket program's predicted peak device bytes, from shapes: the
    parameters (1 byte a coefficient quantized, with a scale and an
    intercept a margin row; else the dtype's width a coefficient and an
    intercept a row), the bucket's input rows and its (K, bucket, Km)
    margins. The quantized form is smaller, so one budget admits more
    gang models."""
    item = np.dtype(dtype).itemsize
    k = servable.n_models if isinstance(servable, GangServable) else 1
    km, d = servable.n_margins, servable.n_features
    params = (k * km * d + 2 * k * km * item if quantize
              else k * km * d * item + k * km * item)
    return params + bucket * d * item + k * bucket * km * item


def _fill_rows(buf: np.ndarray, parts: Sequence[np.ndarray]) -> None:
    """Write the coalesced requests' rows into a bucket's buffer, one after
    another, and zero the pad rows after them (what ``pad_rows`` does)."""
    off = 0
    for p in parts:
        buf[off:off + p.shape[0]] = p
        off += p.shape[0]
    buf[off:] = 0


def serving_params(servable, shape, dtype: torch.dtype, quantize: bool,
                   device: torch.device):
    """A servable's parameters on ``device`` in the kernel's layout:
    (coefficients (K, Km, d) in ``dtype`` or e4m3 codes, intercepts
    (K, Km), and the codes' scales (K, Km) or None)."""
    k, km, d = shape
    if quantize:
        coef, scale, icpt = servable.quantized_params(dtype)
    else:
        (coef, icpt), scale = servable.params(dtype), None
    return tuple(
        None if t is None else t.reshape(s).to(device).contiguous()
        for t, s in ((coef, (k, km, d)), (icpt, (k, km)), (scale, (k, km))))


class _BucketGraph:
    """One bucket's CUDA graph and the buffers it binds: pinned input
    rows, their device copy, the device margins and their pinned copy."""

    def __init__(self, lane: "ModelLane", bucket: int):
        dev, dt = lane.device, lane.server.torch_dtype
        k, km, d = lane.shape
        self.x_dev = torch.zeros((bucket, d), dtype=dt, device=dev)
        self.out_dev = torch.empty((k, bucket, km), dtype=dt, device=dev)
        self.x_pin = torch.zeros((bucket, d), dtype=dt, pin_memory=True)
        self.out_pin = torch.empty((k, bucket, km), dtype=dt,
                                   pin_memory=True)
        self.x = self.x_pin.numpy()
        self.out = self.out_pin.numpy()
        self.stream = lane.stream
        self.device = dev
        self.graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK, torch.cuda.device(dev), \
                torch.cuda.stream(self.stream):
            # thread-local: other lanes' threads keep replaying meanwhile
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.x_dev.copy_(self.x_pin, non_blocking=True)
                lane.launch(self.x_dev, self.out_dev)
                self.out_pin.copy_(self.out_dev, non_blocking=True)
            except BaseException:
                try:
                    self.graph.capture_end()
                except Exception:
                    pass
                raise
            self.graph.capture_end()

    def __call__(self, parts: Sequence[np.ndarray]) -> np.ndarray:
        _fill_rows(self.x, parts)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            self.graph.replay()
        # the pinned buffers are read and rewritten only after this wait
        self.stream.synchronize()
        return self.out.copy()


class ModelLane:
    """Queue, worker thread and bucket programs for ONE registered (model
    | gang) entry."""

    def __init__(self, name: str, servable, server):
        self.name = name
        self.servable = servable
        self.server = server
        self.is_gang = isinstance(servable, GangServable)
        self.buckets = bucket_sizes(server.max_batch)
        self.device = server.device
        k = servable.n_models if self.is_gang else 1
        self.shape = (k, servable.n_margins, servable.n_features)
        self.instance = kernels.serving_instance(server.torch_dtype,
                                                 server.quantize)
        self.stream: Optional["torch.cuda.Stream"] = None
        self._params = None     # (coef or codes, icpt, scale) on the device
        # bucket -> the bucket's program: a CUDA graph on the card, the
        # plain twin's callable on the CPU (the compile ledger)
        self._table = {}
        self._run_lock = threading.Lock()  # one program run at a time
        self._queue: "collections.deque[_Request]" = collections.deque()
        self._cv = threading.Condition()
        self._stop = False
        # per-lane seeded jitter (stable across processes, where str hash
        # is salted): chaos replays of the retry backoff stay deterministic
        self._rng = random.Random(sum(name.encode()))
        self._thread: Optional[threading.Thread] = None
        # per-lane tallies (ints under the cv; scrape-side metrics live in
        # the server's shared MetricsRegistry)
        self.compiles = 0
        self.requests = 0
        self.rows = 0
        self.batches = 0
        self.coalesced = 0      # requests that shared a dispatch with >=1 other
        self.shed = 0
        self.retries = 0
        self.requeues = 0
        self.latency = Histogram(window=4096)   # seconds, request e2e
        self.peaks = {}         # bucket -> predicted peak bytes (guard armed)
        # bucket -> BudgetVerdict of the first admission check: the
        # predicted side is static, so re-checks (one a window while
        # requeued) reuse it and re-sample only live occupancy
        self._verdicts = {}

    # -- registration: every bucket's program ---------------------------------

    def _cache_size(self) -> int:
        return len(self._table)

    def _place_params(self) -> None:
        self._params = serving_params(self.servable, self.shape,
                                      self.server.torch_dtype,
                                      self.server.quantize, self.device)

    def launch(self, x: torch.Tensor,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The margins (K, rows, Km) of the rows ``x`` on the lane's
        device through ``kernels.serving_margins``."""
        coef, icpt, scale = self._params
        return kernels.serving_margins(x, coef, icpt, scale, out=out)

    def _prepare(self, bucket: int) -> Callable[[Sequence[np.ndarray]],
                                                np.ndarray]:
        if self.device.type == "cuda":
            prog = _BucketGraph(self, bucket)
            # the capture is checked by one replay on zero rows, whose
            # margins are the intercepts exactly; it counts as a launch
            got = prog([])
            kernels.count_serving_launch(self.instance)
            want = self._params[1].cpu().numpy()[:, None, :]
            if not np.array_equal(got, np.broadcast_to(want, got.shape)):
                raise RuntimeError(
                    f"serving lane {self.name!r}: the CUDA graph of bucket "
                    f"{bucket} replayed wrong margins on zero rows")
            return prog
        d = self.shape[2]
        np_dt = self.server.dtype

        def plain(parts: Sequence[np.ndarray]) -> np.ndarray:
            x = np.empty((bucket, d), dtype=np_dt)
            _fill_rows(x, parts)
            return self.launch(torch.from_numpy(x)).numpy()

        return plain

    def warm_up(self) -> None:
        """Prepare every bucket: the whole bill is paid here, before the
        first request. Each bucket adds one entry to the compile ledger and
        gets a ``compile`` span; the steady state adds none."""
        harvest = costs.guard_armed(self.server.conf)
        self._place_params()
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
            # one eager launch loads the kernel before the captures
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self.stream):
                self.launch(torch.zeros((1, self.shape[2]),
                                        dtype=self.server.torch_dtype,
                                        device=self.device))
            self.stream.synchronize()
        for b in self.buckets:
            with tracing.span("compile", f"serving/{self.name}",
                              bucket=b) as sp:
                self._table[b] = self._prepare(b)
            with self._cv:   # tallies are cv-guarded, warm-up included
                self.compiles += 1
            self.server.registry.counter("serving.compiles").inc()
            sp.annotate(compiled=True)
            if harvest:
                self.peaks[b] = bucket_peak_bytes(
                    self.servable, b, self.server.dtype, self.server.quantize)

    def bucket_margins(self, x: np.ndarray, bucket: int) -> np.ndarray:
        """The margins of the rows ``x`` through bucket ``bucket``'s
        program, pad rows included: (K, bucket, Km) for a gang, (bucket,
        Km) for a serial lane. Counted as a launch on the card."""
        out = self._run(bucket, [np.asarray(x, dtype=self.server.dtype)])
        return out if self.is_gang else out[0]

    def _run(self, bucket: int, parts: Sequence[np.ndarray]) -> np.ndarray:
        with self._run_lock:
            out = self._table[bucket](parts)
        if self.device.type == "cuda":
            kernels.count_serving_launch(self.instance)
        return out

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run_worker, name=f"cyclone-serve-{self.name}",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            pending = list(self._queue)
            self._queue.clear()
            self._cv.notify_all()
            worker = self._thread
        for r in pending:
            r.future.set_exception(
                ServingOverloaded(f"model server stopped while "
                                  f"{self.name!r} request was queued"))
        if worker is not None:
            worker.join(timeout=10)

    # -- request side ---------------------------------------------------------

    def submit(self, x: np.ndarray) -> "Future":
        if x.shape[0] > self.server.max_batch:
            # a request _collect can never pop would wedge the lane;
            # ModelServer.predict pre-splits, so this is a direct caller's
            # bug: fail it loudly
            raise ValueError(
                f"request of {x.shape[0]} rows exceeds maxBatch "
                f"{self.server.max_batch}; split it (ModelServer.predict "
                f"does) or raise cyclone.serving.maxBatch")
        req = _Request(x)
        with self._cv:
            if self._stop:
                raise ServingError("model server is stopped", status=503)
            if len(self._queue) >= self.server.max_queue:
                self.shed += 1
                self.server.registry.counter("serving.shed").inc()
                raise ServingOverloaded(
                    f"{self.name!r} queue is full "
                    f"({self.server.max_queue} requests) — backpressure")
            self._queue.append(req)
            self._cv.notify_all()
        return req.future

    def try_cancel(self, fut: "Future") -> bool:
        """Remove a still-queued request and fail its future with a 503
        (ModelServer.predict unwinds a multi-chunk submission whose later
        chunk hit backpressure). False when the request already left the
        queue."""
        with self._cv:
            for r in self._queue:
                if r.future is fut:
                    self._queue.remove(r)
                    break
            else:
                return False
            self.shed += 1
        self.server.registry.counter("serving.shed").inc()
        fut.set_exception(ServingOverloaded(
            f"{self.name!r}: sibling sub-request hit backpressure; "
            f"multi-chunk request shed as a unit"))
        return True

    # -- worker ----------------------------------------------------------------

    def _run_worker(self) -> None:
        while True:
            got = self._collect()
            if got is None:
                return
            batch, rows = got
            if not batch:
                continue
            try:
                self._dispatch(batch, rows)
            except Exception as e:  # never hang a future
                logger.exception("serving lane %s: unexpected dispatch "
                                 "failure", self.name)
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(
                            ServingError(f"internal serving failure: {e}",
                                         status=500, cause=e))

    def _collect(self):
        """Assemble the next batch: up to maxBatch rows, waiting at most
        windowMs past the first queued request's arrival (a worker that
        fell behind dispatches at once)."""
        with self._cv:
            while not self._queue and not self._stop:
                self._cv.wait(timeout=0.1)
            if self._stop:
                # anything that slipped in after stop() drained the queue
                # still completes its future
                leftovers = list(self._queue)
                self._queue.clear()
                for r in leftovers:
                    r.future.set_exception(ServingOverloaded(
                        f"model server stopped while {self.name!r} "
                        f"request was queued"))
                return None
            deadline = self._queue[0].t_enq + self.server.window_s
            batch: List[_Request] = []
            rows = 0
            while True:
                while (self._queue
                       and rows + self._queue[0].n <= self.server.max_batch):
                    r = self._queue.popleft()
                    batch.append(r)
                    rows += r.n
                if rows >= self.server.max_batch or self._stop:
                    break
                if self._queue:
                    break  # head does not fit this batch: dispatch now
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
            return batch, rows

    def _requeue_front(self, batch: List[_Request]) -> None:
        with self._cv:
            if not self._stop:
                for r in reversed(batch):
                    self._queue.appendleft(r)
                self.requeues += 1
                self.server.registry.counter("serving.requeued").inc()
                return
        # stop() already drained the queue: give these the same 503
        for r in batch:
            r.future.set_exception(ServingOverloaded(
                f"model server stopped while {self.name!r} request "
                f"was queued"))

    # -- admission control -----------------------------------------------------

    def _admitted(self, bucket: int) -> bool:
        """Whether the bucket's predicted peak fits the budget beside the
        device's live occupancy. No prediction (guard unarmed) admits."""
        peak = self.peaks.get(bucket)
        if peak is None:
            return True
        verdict = self._verdicts.get(bucket)
        if verdict is None:
            # never raises: serving degrades to queue/shed even under
            # budgetAction=raise; first check a bucket only
            verdict = costs.check_budget(
                f"serving/{self.name}[{bucket}]", peak,
                conf=self.server.conf, ctx=self.server.ctx,
                device=self.device, allow_raise=False)
            if verdict is not None:
                self._verdicts[bucket] = verdict
        if verdict is None:
            return True
        if verdict.exceeded:
            return False
        if verdict.budget_bytes and verdict.predicted_bytes and \
                self.device.type == "cuda":
            live = torch.cuda.memory_allocated(self.device)
            if live + verdict.predicted_bytes > verdict.budget_bytes:
                return False
        return True

    def _shed_or_requeue(self, batch: List[_Request]) -> None:
        """Over-budget batch: shed members past the shed deadline with a
        503, requeue the rest at the front and wait one window."""
        now = time.perf_counter()
        keep: List[_Request] = []
        for r in batch:
            if now - r.t_enq >= self.server.shed_after_s:
                with self._cv:
                    self.shed += 1
                self.server.registry.counter("serving.shed").inc()
                r.future.set_exception(ServingOverloaded(
                    f"{self.name!r}: admission control predicts the "
                    f"dispatch exceeds the device memory budget "
                    f"(cyclone.memory.budgetFraction); request shed after "
                    f"{self.server.shed_after_s * 1e3:.0f} ms"))
            else:
                keep.append(r)
        if keep:
            self._requeue_front(keep)
            with self._cv:
                if not self._stop:
                    self._cv.wait(timeout=max(self.server.window_s, 0.005))

    # -- dispatch ---------------------------------------------------------------

    def _dispatch(self, batch: List[_Request], rows: int) -> None:
        from cycloneml_tpu_torch.parallel import faults
        from cycloneml_tpu_torch.parallel.resilience import (
            backoff_delay, classify_failure,
        )
        t_batch = time.perf_counter()
        bucket = bucket_for(rows, self.server.max_batch)
        if not self._admitted(bucket):
            self._shed_or_requeue(batch)
            return
        parts = [r.x for r in batch]
        tr = tracing.active()
        span = (tr.span("serving", self.name, rows=rows, bucket=bucket,
                        n_requests=len(batch), instance=self.instance)
                if tr else tracing.NOOP_SPAN)
        attempt = 0
        with span:
            while True:
                try:
                    faults.inject("serving.dispatch", model=self.name,
                                  bucket=bucket)
                    margins = self._run(bucket, parts)
                    break
                except Exception as e:
                    kind = classify_failure(e)
                    if (kind == "transient"
                            and attempt < self.server.max_retries):
                        attempt += 1
                        with self._cv:
                            self.retries += 1
                        self.server.registry.counter("serving.retries").inc()
                        tracing.instant("retry", point="serving.dispatch",
                                        attempt=attempt, model=self.name)
                        time.sleep(backoff_delay(attempt - 1, base_s=0.01,
                                                 max_s=0.2,
                                                 rng=self._rng))
                        continue
                    status = 503 if kind == "transient" else 500
                    err = ServingError(
                        f"{self.name!r} dispatch failed ({kind}) after "
                        f"{attempt} retries: {e}", status=status, cause=e)
                    for r in batch:
                        r.future.set_exception(err)
                    self.server.registry.counter("serving.failed").inc(
                        len(batch))
                    return
        t_done = time.perf_counter()
        dispatch_s = t_done - t_batch
        margins = margins[:, :rows, :]        # (K, rows, Km)
        if not self.is_gang:
            margins = margins[0]              # (rows, Km)
        # every tally, metric and span before any future completes: a
        # caller reading stats() when predict() returns sees this batch
        reg = self.server.registry
        with self._cv:
            self.requests += len(batch)
            self.rows += rows
            self.batches += 1
            if len(batch) > 1:
                self.coalesced += len(batch)
        reg.counter("serving.requests").inc(len(batch))
        reg.counter("serving.rows").inc(rows)
        reg.counter("serving.batches").inc()
        reg.timer("serving.dispatch").update(dispatch_s)
        reg.histogram("serving.batchRows").update(float(rows))
        reg.histogram("serving.batchRequests").update(float(len(batch)))
        for r in batch:
            e2e = t_done - r.t_enq
            self.latency.update(e2e)
            reg.timer("serving.latency").update(e2e)
            reg.timer("serving.queue").update(max(t_batch - r.t_enq, 0.0))
            if tr is not None:
                tr.record_span("serving", "request", t0=r.t_enq, t1=t_done,
                               parent=span.span_id, model=self.name,
                               rows=r.n, bucket=bucket,
                               queue_s=max(t_batch - r.t_enq, 0.0),
                               dispatch_s=dispatch_s)
        off = 0
        for r in batch:
            part = (margins[:, off:off + r.n, :] if self.is_gang
                    else margins[off:off + r.n, :])
            off += r.n
            try:
                r.future.set_result(self.servable.postprocess(part))
            except Exception as e:
                r.future.set_exception(ServingError(
                    f"postprocessing failed for {self.name!r}: {e}",
                    status=500, cause=e))

    # -- introspection ----------------------------------------------------------

    def stats(self) -> dict:
        lat = self.latency.snapshot()
        with self._cv:
            # one acquisition for the whole tally row, so that a scrape
            # racing a dispatch sees one batch's tallies together
            tallies = {
                "compiles": self.compiles,
                "requests": self.requests,
                "rows": self.rows,
                "batches": self.batches,
                "coalesced": self.coalesced,
                "shed": self.shed,
                "retries": self.retries,
                "requeues": self.requeues,
            }
        return {
            "buckets": list(self.buckets),
            "gang": self.servable.n_models if self.is_gang else 0,
            "quantized": bool(self.server.quantize),
            "nFeatures": self.servable.n_features,
            **tallies,
            "latencyMs": {k: (v * 1e3 if k != "count" else v)
                          for k, v in lat.items()},
        }
