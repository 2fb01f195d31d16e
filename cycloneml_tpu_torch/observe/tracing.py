"""Span tracing: hierarchical spans over the port's host-side phases.

The port's counterpart of the span half of ``cycloneml_tpu/observe/
tracing.py`` (:69-465): every instrumented boundary opens a :class:`Span`
(kind, name, wall window, attributes) nested under the current thread's
open span, and the process-global :class:`Tracer` collects them. The model
server records ``compile`` spans (one a bucket at registration: on the
card the bucket's CUDA graph capture), one ``serving`` span a dispatch and
one ``request`` span a request, and ``instant`` annotations for retries
and injected faults.

Off by default: every site reads one module global, and :func:`span`
returns the shared :data:`NOOP_SPAN`. Chrome-trace export, per-fit
profiles, counter tracks and the flight-recorder ring are ROADMAP Queue 1
item 12.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["Span", "NOOP_SPAN", "Tracer", "enable", "disable", "active",
           "span", "instant", "current_span_id"]


class Span:
    """One closed (or instant) span; ``t0``/``t1`` are
    ``time.perf_counter`` readings."""

    __slots__ = ("span_id", "parent_id", "kind", "name", "t0", "t1", "tid",
                 "attrs")

    def __init__(self, span_id: str, parent_id: str, kind: str, name: str,
                 tid: int, attrs: Dict[str, Any]):
        self.span_id = span_id
        self.parent_id = parent_id
        self.kind = kind
        self.name = name
        self.t0 = 0.0
        self.t1 = 0.0
        self.tid = tid
        self.attrs = attrs

    @property
    def duration_s(self) -> float:
        return max(self.t1 - self.t0, 0.0)

    def __repr__(self) -> str:
        return (f"Span({self.kind}:{self.name} id={self.span_id} "
                f"parent={self.parent_id or '-'} dur={self.duration_s:.6f})")


class _NoopSpan:
    """Shared do-nothing span: the whole disabled-tracing surface."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def annotate(self, **attrs) -> None:
        pass

    @property
    def span_id(self) -> str:
        return ""


NOOP_SPAN = _NoopSpan()


class _LiveSpan:
    """Context manager recording one span into its tracer."""

    __slots__ = ("_tracer", "span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self.span = span

    def __enter__(self) -> "_LiveSpan":
        stack = self._tracer._stack()
        if stack and not self.span.parent_id:
            self.span.parent_id = stack[-1].span_id
        stack.append(self.span)
        self.span.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.span.t1 = time.perf_counter()
        stack = self._tracer._stack()
        if stack and stack[-1] is self.span:
            stack.pop()
        self._tracer._record(self.span)
        return False

    def annotate(self, **attrs) -> None:
        """Attach attributes, during or after the ``with`` block."""
        self.span.attrs.update(attrs)

    @property
    def span_id(self) -> str:
        return self.span.span_id


class Tracer:
    """Collects spans process-wide; thread-safe.

    Parents are per thread (a thread-local span stack). Across threads the
    parent is passed explicitly: the serving worker records each request's
    span after the fact (:meth:`record_span`) under its dispatch span.

    The buffer is a ring: past ``max_spans`` the oldest span is dropped
    and counted in ``dropped``. ``registry`` (a
    :class:`~cycloneml_tpu_torch.util.metrics.MetricsRegistry`) receives
    every closed span in the timer ``span.<kind>`` and every instant in
    the counter ``trace.<name>``.
    """

    def __init__(self, max_spans: int = 100_000, registry=None):
        self.max_spans = max(1, int(max_spans))
        self.registry = registry
        self._spans: "collections.deque[Span]" = collections.deque()
        self.dropped = 0
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def current_span_id(self) -> str:
        stack = self._stack()
        return stack[-1].span_id if stack else ""

    def span(self, kind: str, name: str = "", parent: str = "",
             **attrs) -> _LiveSpan:
        s = Span(f"s{next(self._ids)}", parent, kind, name or kind,
                 threading.get_ident(), attrs)
        return _LiveSpan(self, s)

    def instant(self, name: str, **attrs) -> None:
        """A zero-duration annotation under the current span."""
        s = Span(f"s{next(self._ids)}", self.current_span_id(), "instant",
                 name, threading.get_ident(), attrs)
        s.t0 = s.t1 = time.perf_counter()
        self._record(s)

    def record_span(self, kind: str, name: str = "", t0: float = 0.0,
                    t1: float = 0.0, parent: str = "", **attrs) -> Span:
        """Record an already-timed span (``t0``/``t1`` are
        ``perf_counter`` readings), for a lifetime that spans threads: a
        request queued on the caller's thread and dispatched on the
        lane's."""
        s = Span(f"s{next(self._ids)}", parent, kind, name or kind,
                 threading.get_ident(), attrs)
        s.t0, s.t1 = t0, t1
        self._record(s)
        return s

    def _record(self, s: Span) -> None:
        with self._lock:
            self._spans.append(s)
            while len(self._spans) > self.max_spans:
                self._spans.popleft()
                self.dropped += 1
        reg = self.registry
        if reg is not None:
            try:
                if s.kind == "instant":
                    reg.counter(f"trace.{s.name}").inc()
                else:
                    reg.timer(f"span.{s.kind}").update(s.duration_s)
            except Exception:
                pass  # a broken metrics bridge must not fail the traced work

    def snapshot(self) -> List[Span]:
        """The spans still in the ring, oldest first."""
        with self._lock:
            return list(self._spans)


# the process-global switch: the disabled path is one read of _tracer
_lock = threading.Lock()
_tracer: Optional[Tracer] = None


def enable(max_spans: int = 100_000, registry=None) -> Tracer:
    """Install (or return the installed) process-global tracer."""
    global _tracer
    with _lock:
        if _tracer is None:
            _tracer = Tracer(max_spans=max_spans, registry=registry)
        return _tracer


def disable() -> Optional[Tracer]:
    """Uninstall and return the global tracer (None when already off); the
    returned tracer stays readable."""
    global _tracer
    with _lock:
        t, _tracer = _tracer, None
        return t


def active() -> Optional[Tracer]:
    return _tracer


def span(kind: str, name: str = "", **attrs):
    """A span under the current thread's context; :data:`NOOP_SPAN` when
    tracing is off."""
    t = _tracer
    if t is None:
        return NOOP_SPAN
    return t.span(kind, name, **attrs)


def instant(name: str, **attrs) -> None:
    t = _tracer
    if t is not None:
        t.instant(name, **attrs)


def current_span_id() -> str:
    t = _tracer
    if t is None:
        return ""
    return t.current_span_id()
