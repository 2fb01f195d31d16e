"""The memory budget guard — the part of the reference's
``cycloneml_tpu/observe/costs.py`` that routes fits (:439-542).

The reference predicts a program's peak device memory with XLA's
``memory_analysis``. The port has no compiled program to ask, so it
predicts a fit's peak ANALYTICALLY from shapes (:func:`predict_fit_peak`):
the bytes of the dataset's device arrays plus the fit's working set. A
fit whose prediction exceeds ``cyclone.memory.budgetFraction`` x the
device's memory records a ``MemoryBudgetExceeded`` warning in
``ctx.memory_warnings`` and degrades: to the out-of-core streaming engine
where the fit has a streaming twin (:class:`OutOfCoreRequired`, caught by
the estimator), else it warns or raises (:class:`MemoryBudgetError`).

The guard arms only when ``cyclone.memory.budgetFraction`` is set
explicitly (:func:`guard_armed`); the reference also arms it under full
tracing, which is ROADMAP Queue 1 item 12 here, as is the listener bus the
reference posts the record on.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Iterable, Optional

import torch

logger = logging.getLogger(__name__)


class MemoryBudgetError(RuntimeError):
    """Raised when ``cyclone.memory.budgetAction=raise`` and a fit's
    predicted peak device memory exceeds the budget with nothing left to
    degrade to."""


class OutOfCoreRequired(RuntimeError):
    """Internal degradation signal: the fit's predicted peak exceeds the
    budget, and its owner declared a streaming fallback
    (``DeviceLBFGS.oocore_fallback``) that ``cyclone.oocore.mode`` allows.
    The estimator catches it and re-routes the fit through the streaming
    engine; it never reaches user code. Carries the :class:`BudgetVerdict`."""

    def __init__(self, name: str, verdict: "BudgetVerdict"):
        super().__init__(
            f"{name}: {verdict.predicted_bytes} bytes predicted over the "
            f"{verdict.budget_bytes}-byte budget — degrading to the "
            f"out-of-core streaming engine")
        self.name = name
        self.verdict = verdict


@dataclass
class BudgetVerdict:
    """The result of one budget check."""

    exceeded: bool
    predicted_bytes: int
    budget_bytes: int
    limit_bytes: int
    fraction: float
    action: str


def device_memory_limit(conf=None, device=None) -> Optional[int]:
    """The device memory bytes the guard divides into:
    ``cyclone.memory.deviceBytes`` when set; else the total of
    ``torch.cuda.mem_get_info`` on a CUDA ``device``; else (the CPU, whose
    "device" memory is host RAM, the reference's host-platform branch) the
    host's RAM. None when nothing is known."""
    if conf is not None:
        from cycloneml_tpu_torch.conf import MEMORY_DEVICE_BYTES
        override = int(conf.get(MEMORY_DEVICE_BYTES))
        if override > 0:
            return override
    if device is not None and torch.device(device).type == "cuda":
        return int(torch.cuda.mem_get_info(torch.device(device))[1])
    try:
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    except (ValueError, OSError, AttributeError):
        return None


def guard_armed(conf) -> bool:
    """The guard arms only when ``cyclone.memory.budgetFraction`` is set
    explicitly in the conf."""
    from cycloneml_tpu_torch.conf import MEMORY_BUDGET_FRACTION
    return conf is not None and conf.contains_raw(MEMORY_BUDGET_FRACTION.key)


def tensor_bytes(tensors: Iterable) -> int:
    """Bytes of the tensors among ``tensors`` (anything else counts 0)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if torch.is_tensor(t))


def predict_fit_peak(arrays: Iterable, n_coef: int, d: int, m: int = 10,
                     acc_bytes: int = 4, parts: Optional[int] = None,
                     device=None) -> int:
    """A fit's predicted peak device bytes, from shapes:

        peak = sum(bytes of the device arrays the fit reads)
               + parts * (d + 3) * 8            (K1/K2's float64 partials)
               + 2 * m * n_coef * acc_bytes     (the L-BFGS history S, Y)
               + 4 * n_coef * acc_bytes         (coef, gradient, direction,
                                                 trial point)

    ``arrays``: the dataset's device arrays (X, y, w) and the fit's
    replicated vectors; ``acc_bytes``: the accumulator tier's element
    size. ``parts`` defaults, on a CUDA ``device``, to 32 CTAs on every SM
    (an upper bound on the sweep's resident CTAs), and to 0 on the CPU,
    where the plain versions hold no partials."""
    if parts is None:
        parts = 0
        if device is not None and torch.device(device).type == "cuda":
            props = torch.cuda.get_device_properties(torch.device(device))
            parts = 32 * props.multi_processor_count
    return (tensor_bytes(arrays) + parts * (d + 3) * 8
            + 2 * m * n_coef * acc_bytes + 4 * n_coef * acc_bytes)


def check_budget(name: str, predicted_bytes: int, conf=None, ctx=None,
                 device=None, allow_raise: bool = True
                 ) -> Optional[BudgetVerdict]:
    """Compare a prediction against ``cyclone.memory.budgetFraction`` x
    :func:`device_memory_limit`. On excess: a ``MemoryBudgetExceeded``
    record in ``ctx.memory_warnings``, a warning, and a
    :class:`MemoryBudgetError` only under ``budgetAction=raise`` with
    ``allow_raise`` (callers with a degradation left pass False and
    escalate themselves). None when the conf or the limit is unknown."""
    if conf is None and ctx is not None:
        conf = getattr(ctx, "conf", None)
    if conf is None:
        return None
    from cycloneml_tpu_torch.conf import (MEMORY_BUDGET_ACTION,
                                          MEMORY_BUDGET_FRACTION)
    fraction = float(conf.get(MEMORY_BUDGET_FRACTION))
    action = str(conf.get(MEMORY_BUDGET_ACTION))
    limit = device_memory_limit(conf, device)
    if not limit:
        return None
    budget = int(limit * fraction)
    peak = int(predicted_bytes)
    verdict = BudgetVerdict(exceeded=peak > budget, predicted_bytes=peak,
                            budget_bytes=budget, limit_bytes=limit,
                            fraction=fraction, action=action)
    if not verdict.exceeded:
        return verdict
    logger.warning(
        "memory budget exceeded: %s predicts %d bytes peak device memory "
        "> budget %d (%.3g of %d); action=%s", name, peak, budget, fraction,
        limit, action)
    record = getattr(ctx, "memory_warnings", None)
    if record is not None:
        record.append({"event": "MemoryBudgetExceeded", "program": name,
                       "predicted_bytes": peak, "budget_bytes": budget,
                       "limit_bytes": limit, "fraction": fraction,
                       "action": action})
    if action == "raise" and allow_raise:
        raise MemoryBudgetError(
            f"{name} predicts {peak} bytes peak device memory, over the "
            f"{budget}-byte budget ({fraction:g} x {limit}); set "
            f"cyclone.memory.budgetAction=warn (default) to proceed")
    return verdict
