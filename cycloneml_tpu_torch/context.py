"""CycloneContext — the driver entry point of the port.

The counterpart of ``cycloneml_tpu/context.py:CycloneContext``: it owns the
conf and the mesh runtime, makes host-tier datasets (``parallelize``),
broadcasts and accumulators, brackets jobs (``run_job``: a ``job`` span on
the active tracer and the ``jobs.*`` counters and ``job.duration`` timer of
``metrics_registry``), reads libsvm files (``read_libsvm``), counts the
optimizer steps the fits record, keeps the fp8 storage fallbacks they
took, holds the metrics registry that model servers share
(``metrics_registry``, the reference's ``ctx.metrics.registry``), owns the
storage tiers every persisted dataset registers with (``storage``, a
``dataset/storage.StorageManager`` under ``cyclone.storage.deviceBudget``
and ``hostBudget``, closed by ``stop``) and names the checkpoint
directory (``checkpoint_dir``, ``cyclone.checkpoint.dir``).
The listener bus, event journal, UI, metrics sinks and heartbeats are
host-side layers (ROADMAP slice 10, Queue 1 item 12); the mesh rebuild
that ``run_job`` waits out in the reference needs several devices (Queue
1 item 9).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, List, Optional

import torch

from cycloneml_tpu_torch import mesh as mesh_mod
from cycloneml_tpu_torch.conf import (APP_NAME, CHECKPOINT_DIR,
                                      DEFAULT_PARALLELISM, MASTER,
                                      STORAGE_DEVICE_BUDGET,
                                      STORAGE_HOST_BUDGET, CycloneConf)
from cycloneml_tpu_torch.observe import tracing
from cycloneml_tpu_torch.util.metrics import MetricsRegistry

_active_lock = threading.Lock()
_active_context: Optional["CycloneContext"] = None


def active_context() -> Optional["CycloneContext"]:
    """The live context, or None."""
    with _active_lock:
        if _active_context is not None and not _active_context._stopped:
            return _active_context
    return None


class Broadcast:
    """A value shared read-only by every task (the reference's Broadcast,
    ref TorrentBroadcast.scala:58). ``device_value`` is its copy on the
    context's device, made once at first use (tensors and numpy arrays
    are copied, dicts, lists and tuples of them element by element, other
    leaves kept as they are); ``unpersist`` drops that copy and
    ``destroy`` the value too."""

    def __init__(self, ctx: "CycloneContext", value: Any, bid: int):
        self.id = bid
        self._value = value
        self._device_value = None
        self._ctx = ctx

    @property
    def value(self) -> Any:
        return self._value

    @property
    def device_value(self) -> Any:
        if self._device_value is None:
            self._device_value = _to_device(self._value, self._ctx.device)
        return self._device_value

    def unpersist(self) -> None:
        self._device_value = None

    def destroy(self) -> None:
        self._device_value = None
        self._value = None


def _to_device(value: Any, device: torch.device) -> Any:
    import numpy as np
    if isinstance(value, torch.Tensor):
        return value.to(device)
    if isinstance(value, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(value)).to(device)
    if isinstance(value, dict):
        return {k: _to_device(v, device) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_device(v, device) for v in value)
    return value


class Accumulator:
    """A float counter on the context's side that tasks add to (ref
    util/AccumulatorV2.scala:44), safe across the task threads."""

    def __init__(self, initial: float = 0.0, name: str = ""):
        self.name = name
        self._value = initial
        self._lock = threading.Lock()

    def add(self, v) -> None:
        with self._lock:
            self._value += float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0


class CycloneContext:
    def __init__(self, conf: Optional[CycloneConf] = None,
                 master: Optional[str] = None, app_name: Optional[str] = None):
        global _active_context
        with _active_lock:
            if _active_context is not None and not _active_context._stopped:
                raise RuntimeError(
                    "An active CycloneContext already exists in this process; "
                    "use CycloneContext.get_or_create() or stop() it first.")
            self.conf = (conf or CycloneConf()).clone()
            if master is not None:
                self.conf.set(MASTER, master)
            if app_name is not None:
                self.conf.set(APP_NAME, app_name)
            self.app_name = self.conf.get(APP_NAME)
            self.mesh_runtime = mesh_mod.get_or_create(self.conf.get(MASTER))
            self.steps = 0
            self.last_step: Dict[str, float] = {}
            # every fp8 -> bfloat16 storage fallback of this context's fits
            # (dataset.fp8_fallback): the reference posts them on its
            # listener bus, which is ROADMAP slice 10
            self.precision_fallbacks: List[Dict[str, str]] = []
            # every MemoryBudgetExceeded record of the budget guard
            # (observe/costs.check_budget), likewise off the bus
            self.memory_warnings: List[Dict] = []
            # the registry a ModelServer on this context feeds (the
            # reference's MetricsSystem and its sinks are ROADMAP slice 10)
            self.metrics_registry = MetricsRegistry()
            # the storage tiers (the BlockManager's analog): every persisted
            # or cached dataset registers here, so the budgets bound what
            # cold cached datasets hold
            from cycloneml_tpu_torch.dataset.storage import StorageManager
            self.storage = StorageManager(
                device_budget=self.conf.get(STORAGE_DEVICE_BUDGET) or None,
                host_budget=self.conf.get(STORAGE_HOST_BUDGET) or None)
            self._next_broadcast = 0
            self._stopped = False
            _active_context = self

    @classmethod
    def get_or_create(cls, conf: Optional[CycloneConf] = None,
                      **kw) -> "CycloneContext":
        ctx = active_context()
        return ctx if ctx is not None else cls(conf, **kw)

    @property
    def device(self) -> torch.device:
        return self.mesh_runtime.device

    @property
    def default_parallelism(self) -> int:
        """``cyclone.default.parallelism``, or the mesh's device count when
        it is 0."""
        n = self.conf.get(DEFAULT_PARALLELISM)
        return n if n > 0 else self.mesh_runtime.n_devices

    def broadcast(self, value: Any) -> Broadcast:
        self._next_broadcast += 1
        return Broadcast(self, value, self._next_broadcast)

    def accumulator(self, initial: float = 0.0, name: str = "") -> Accumulator:
        return Accumulator(initial, name)

    def parallelize(self, data, num_partitions: Optional[int] = None):
        """A host-tier dataset of ``data`` in ``num_partitions`` partitions
        (default :attr:`default_parallelism`)."""
        from cycloneml_tpu_torch.dataset.dataset import PartitionedDataset
        return PartitionedDataset.from_sequence(
            self, list(data), num_partitions or self.default_parallelism)

    def run_job(self, description: str, fn: Callable[[], Any]) -> Any:
        """Run ``fn()`` as one job: a ``job`` span on the active tracer
        (the spans ``fn`` opens in this thread nest under it), the
        ``jobs.started`` and ``jobs.succeeded`` or ``jobs.failed``
        counters and the ``job.duration`` timer of
        :attr:`metrics_registry`. Its result is returned; its exception
        raised. The reference's JobStart/JobEnd events and FitProfile
        rollup are the listener bus's (Queue 1 item 12)."""
        reg = self.metrics_registry
        reg.counter("jobs.started").inc()
        with tracing.span("job", description):
            try:
                with reg.timer("job.duration"):
                    out = fn()
            except Exception:
                reg.counter("jobs.failed").inc()
                raise
        reg.counter("jobs.succeeded").inc()
        return out

    def read_libsvm(self, path: str, n_features: Optional[int] = None):
        """A libsvm file as a dense dataset
        (:func:`~cycloneml_tpu_torch.dataset.io.read_libsvm`)."""
        from cycloneml_tpu_torch.dataset.io import read_libsvm
        return read_libsvm(self, path, n_features)

    @property
    def checkpoint_dir(self) -> str:
        return self.conf.get(CHECKPOINT_DIR)

    def set_checkpoint_dir(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        self.conf.set(CHECKPOINT_DIR, path)

    def record_step(self, step_metrics: Dict[str, float]) -> None:
        """Count one optimizer step and keep its metrics."""
        self.steps += 1
        self.last_step = dict(step_metrics)

    def stop(self) -> None:
        global _active_context
        with _active_lock:
            if self._stopped:
                return
            self._stopped = True
            if _active_context is self:
                _active_context = None
        self.storage.close()  # spill files and their directory
        mesh_mod.reset()

    def __enter__(self) -> "CycloneContext":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
