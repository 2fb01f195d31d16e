"""Deterministic fault injection: the chaos harness.

The port's counterpart of ``cycloneml_tpu/parallel/faults.py`` (:116-317).
Faults are scheduled, not sprayed: a :class:`FaultSchedule` names the
injection point, the invocation numbers (1-based, counted only while an
injector is installed) and the fault to fire: an exception instance, a
``delay_s`` (a slow step) or a callable. Probabilistic windows draw from a
``random.Random(seed)`` owned by the injector, so a fixed seed replays the
same faults. With no injector installed every :func:`inject` site is one
read of a module global.

Injection points of the port:

======================== =================================================
point                    fired from
======================== =================================================
``checkpoint.save``      ``TrainingCheckpointer.save`` entry
                         (``util/checkpoint.py``), before any file
``checkpoint.commit``    after the checkpoint's files are written and
                         fsync'd, before the atomic rename (a crash here
                         leaves an invisible tmp directory)
``checkpoint.restore``   ``TrainingCheckpointer.restore`` entry, and
                         ``restore_newest_verifiable`` once a load
                         begins (never on an empty directory)
``serving.dispatch``     every model-server batch dispatch
                         (``serving/batcher.py``): transient faults
                         retry with backoff, permanent faults shed the
                         batch with a 5xx ServingError, never a hang
======================== =================================================

The reference's other points (collectives, heartbeats, out-of-core
staging, multihost, elastic capacity and the autoscaler) need several
devices and come with ROADMAP Queue 1 item 9; its flight-recorder trigger
on each fired fault is item 12. Each fired fault is a ``fault`` instant in
the active trace.

Usage::

    sched = FaultSchedule(seed=0)
    sched.at("serving.dispatch", 1, TransientCollectiveError("flake"))
    with FaultInjector(sched) as inj:
        server.predict("m", x)
    assert inj.log == [("serving.dispatch", 1, "TransientCollectiveError")]
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from cycloneml_tpu_torch.observe import tracing

logger = logging.getLogger(__name__)


class FaultInjected(Exception):
    """Base of the injected failures."""


class TransientCollectiveError(FaultInjected):
    """A step that would succeed on retry (a flaky link, a preempted
    step): the retry-with-backoff class."""


class DeviceLostError(FaultInjected):
    """A device is gone: its programs and arrays are dead, a retry cannot
    help; recovery rebuilds the mesh over the survivors."""

    def __init__(self, msg: str = "device lost",
                 lost_workers: Sequence[str] = ()):
        super().__init__(msg)
        self.lost_workers = list(lost_workers)


class HostLostError(DeviceLostError):
    """A whole host (one process of a multi-host mesh, with its devices)
    is gone: the device-loss recovery class; ``lost_workers`` aliases
    ``lost_hosts``."""

    def __init__(self, msg: str = "host lost",
                 lost_hosts: Sequence[str] = ()):
        super().__init__(msg, lost_workers=lost_hosts)
        self.lost_hosts = list(lost_hosts)


class PreemptionNotice(FaultInjected):
    """A decommission notice, not a loss: ``lost_hosts`` will be
    reclaimed after ``drain_window_s`` seconds, and the mesh is still
    alive when it surfaces. Deliberately not a DeviceLostError."""

    def __init__(self, msg: str = "preemption notice",
                 lost_hosts: Sequence[str] = (),
                 drain_window_s: Optional[float] = None):
        super().__init__(msg)
        self.lost_hosts = list(lost_hosts)
        self.drain_window_s = drain_window_s


class MidSaveCrash(FaultInjected):
    """Stands in for the process dying mid-checkpoint-save."""


class InjectedConnectionReset(ConnectionResetError, FaultInjected):
    """A peer reset on a socket: an OSError, so handlers of the real
    error treat it as one."""


class SlowStep(FaultInjected):
    """The name a delay fault is logged under (the fault is a sleep)."""


class _Spec:
    __slots__ = ("point", "first", "last", "fault", "p", "delay_s")

    def __init__(self, point: str, first: int, last: int, fault: Any,
                 p: float, delay_s: float):
        self.point = point
        self.first = first
        self.last = last
        self.fault = fault
        self.p = p
        self.delay_s = delay_s


class FaultSchedule:
    """Declarative fault plan: (point, invocation window) -> fault."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._specs: List[_Spec] = []

    def at(self, point: str, invocation, fault: Any = None, *,
           delay_s: float = 0.0) -> "FaultSchedule":
        """Fire ``fault`` at the given 1-based invocation number(s) of
        ``point``: an exception instance (raised), a callable (called with
        the site's keyword arguments), or None with ``delay_s`` (a slow
        step)."""
        invs = invocation if isinstance(invocation, (list, tuple, set, range)) \
            else [invocation]
        for n in invs:
            self._specs.append(_Spec(point, int(n), int(n), fault, 1.0,
                                     delay_s))
        return self

    def window(self, point: str, first: int, last: int, fault: Any = None, *,
               p: float = 1.0, delay_s: float = 0.0) -> "FaultSchedule":
        """Fire ``fault`` on invocations ``first..last`` (inclusive) of
        ``point``, each with probability ``p`` from the seeded RNG."""
        self._specs.append(_Spec(point, int(first), int(last), fault, p,
                                 delay_s))
        return self

    def specs_for(self, point: str) -> List[_Spec]:
        return [s for s in self._specs if s.point == point]


_lock = threading.Lock()
_active: Optional["FaultInjector"] = None


class FaultInjector:
    """Counts invocations per injection point and fires scheduled faults.

    A context manager (installs and uninstalls the process-global
    injector). ``log`` holds every fired fault as ``(point, invocation,
    fault_name)``."""

    def __init__(self, schedule: FaultSchedule):
        self.schedule = schedule
        self.counts: Dict[str, int] = {}
        self.log: List[Tuple[str, int, str]] = []
        self._rng = random.Random(schedule.seed)
        self._lock = threading.Lock()

    def __enter__(self) -> "FaultInjector":
        install(self)
        return self

    def __exit__(self, *exc) -> None:
        uninstall(self)

    def fire(self, point: str, **info) -> None:
        with self._lock:
            n = self.counts.get(point, 0) + 1
            self.counts[point] = n
            spec = None
            for s in self.schedule.specs_for(point):
                if s.first <= n <= s.last:
                    # one draw per in-window invocation: a fixed seed
                    # replays exactly
                    if s.p >= 1.0 or self._rng.random() < s.p:
                        spec = s
                        break
            if spec is None:
                return
            fault = spec.fault
            name = (type(fault).__name__ if isinstance(fault, BaseException)
                    else getattr(fault, "__name__", "SlowStep"))
            self.log.append((point, n, name))
        logger.warning("chaos: injecting %s at %s#%d", name, point, n)
        tracing.instant("fault", point=point, invocation=n, fault=name)
        if spec.delay_s:
            time.sleep(spec.delay_s)
        if fault is None:
            return
        if isinstance(fault, BaseException):
            raise fault
        fault(point=point, invocation=n, **info)


def install(injector: FaultInjector) -> None:
    global _active
    with _lock:
        if _active is not None and _active is not injector:
            raise RuntimeError("a FaultInjector is already installed")
        _active = injector


def uninstall(injector: Optional[FaultInjector] = None) -> None:
    global _active
    with _lock:
        if injector is None or _active is injector:
            _active = None


def inject(point: str, **info) -> None:
    """Injection site: one global read unless an injector is installed."""
    inj = _active
    if inj is not None:
        inj.fire(point, **info)
