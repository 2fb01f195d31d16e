"""CycloneContext — the driver entry point of the port.

The counterpart of ``cycloneml_tpu/context.py:CycloneContext``: it owns the
conf and the mesh runtime, reads libsvm files (``read_libsvm``), counts the
optimizer steps the fits record, keeps the fp8 storage fallbacks they
took, and holds the metrics registry that model servers share
(``metrics_registry``, the reference's ``ctx.metrics.registry``).
The listener bus, event journal, UI, metrics sinks, storage tiers and
heartbeats are host-side layers (ROADMAP slice 10).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import torch

from cycloneml_tpu_torch import mesh as mesh_mod
from cycloneml_tpu_torch.conf import APP_NAME, MASTER, CycloneConf
from cycloneml_tpu_torch.util.metrics import MetricsRegistry

_active_lock = threading.Lock()
_active_context: Optional["CycloneContext"] = None


def active_context() -> Optional["CycloneContext"]:
    """The live context, or None."""
    with _active_lock:
        if _active_context is not None and not _active_context._stopped:
            return _active_context
    return None


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

    def read_libsvm(self, path: str, n_features: Optional[int] = None):
        """A libsvm file as a dense dataset
        (:func:`~cycloneml_tpu_torch.dataset.io.read_libsvm`)."""
        from cycloneml_tpu_torch.dataset.io import read_libsvm
        return read_libsvm(self, path, n_features)

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
        mesh_mod.reset()

    def __enter__(self) -> "CycloneContext":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
