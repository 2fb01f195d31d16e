"""Metrics: counters, gauges, windowed histograms and timers in a named
registry, and the Prometheus text exposition of a registry's values.

The port's counterpart of the registry half of
``cycloneml_tpu/util/metrics.py`` (:24-210, :250-360). The periodic sinks
(console, CSV), the ``/metrics`` HTTP endpoint and ``MetricsSystem`` are
ROADMAP Queue 1 item 12. The model server feeds one registry, shared
through ``CycloneContext.metrics_registry``.
"""

from __future__ import annotations

import collections
import math
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional


class Counter:
    def __init__(self):
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def count(self) -> int:
        with self._lock:
            return self._v


class Gauge:
    """Value supplier polled at report time."""

    def __init__(self, fn: Callable[[], float]):
        self._fn = fn

    def poll(self) -> float:
        """Raw read; raises whatever the callback raises (the registry's
        scrape skips a gauge that raises)."""
        return float(self._fn())

    @property
    def value(self) -> float:
        try:
            return self.poll()
        except Exception:
            return float("nan")


class Histogram:
    """Streaming count and sum, and nearest-rank quantiles over a sliding
    window of the last ``window`` samples."""

    def __init__(self, window: int = 1024):
        self._window = window
        self._samples: "collections.deque[float]" = collections.deque(
            maxlen=max(1, window))
        self._count = 0
        self._sum = 0.0
        self._lock = threading.Lock()

    def update(self, v: float) -> None:
        with self._lock:
            self._count += 1
            self._sum += v
            self._samples.append(v)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def mean(self) -> float:
        # both moments under one lock: a concurrent update must not pair
        # a new sum with an old count
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    @staticmethod
    def _rank(s: List[float], q: float) -> float:
        """Nearest-rank quantile over sorted samples."""
        if not s:
            return 0.0
        return s[min(len(s) - 1, int(math.ceil(q * len(s))) - 1)]

    def quantile(self, q: float) -> float:
        with self._lock:
            s = sorted(self._samples)
        return self._rank(s, q)

    def snapshot(self) -> Dict[str, float]:
        """count, mean, p50, p95, p99 and max, from one sorted copy."""
        with self._lock:
            count, total = self._count, self._sum
            s = sorted(self._samples)
        return {"count": count, "mean": (total / count if count else 0.0),
                "p50": self._rank(s, 0.5), "p95": self._rank(s, 0.95),
                "p99": self._rank(s, 0.99), "max": self._rank(s, 1.0)}


class Timer(Histogram):
    """Histogram of durations in seconds with a context-manager API. Start
    times live on a per-thread stack, so one shared timer is safe under
    nesting and across threads."""

    def __init__(self, window: int = 1024):
        super().__init__(window)
        self._local = threading.local()

    def __enter__(self):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        stack.append(time.perf_counter())
        return self

    def __exit__(self, *exc):
        self.update(time.perf_counter() - self._local.stack.pop())


class MetricsRegistry:
    """Named metric map."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, factory: Callable[[], Any]):
        with self._lock:
            if name not in self._metrics:
                self._metrics[name] = factory()
            return self._metrics[name]

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def histogram(self, name: str) -> Histogram:
        return self._get_or_create(name, Histogram)

    def timer(self, name: str) -> Timer:
        return self._get_or_create(name, Timer)

    def gauge(self, name: str, fn: Callable[[], float]) -> Gauge:
        return self._get_or_create(name, lambda: Gauge(fn))

    def remove(self, name: str) -> None:
        with self._lock:
            self._metrics.pop(name, None)

    def types(self) -> Dict[str, str]:
        """name -> Prometheus type (counter, gauge or summary: timers are
        histograms and report as summaries)."""
        with self._lock:
            items = list(self._metrics.items())
        out: Dict[str, str] = {}
        for name, m in items:
            if isinstance(m, Counter):
                out[name] = "counter"
            elif isinstance(m, Gauge):
                out[name] = "gauge"
            elif isinstance(m, Histogram):
                out[name] = "summary"
        return out

    def values(self) -> Dict[str, float]:
        """Flatten to name -> scalar; a histogram gives ``name.count``,
        ``name.mean``, ``name.p50`` ... A gauge whose callback raises is
        skipped."""
        out: Dict[str, float] = {}
        with self._lock:
            items = list(self._metrics.items())
        for name, m in items:
            if isinstance(m, Counter):
                out[name] = m.count
            elif isinstance(m, Gauge):
                try:
                    out[name] = m.poll()
                except Exception:
                    continue
            elif isinstance(m, Histogram):
                for k, v in m.snapshot().items():
                    out[f"{name}.{k}"] = v
        return out


def _finite(v) -> bool:
    # NaN and +-inf: Prometheus scrapers reject non-finite samples
    return not (isinstance(v, float) and not math.isfinite(v))


# one k="v" pair inside a metric name's label block; values may carry the
# exposition format's escapes \" \\ \n
_LABEL_PAIR_RE = re.compile(r'([A-Za-z_][A-Za-z0-9_.\-]*)="((?:[^"\\]|\\.)*)"')
_LABEL_ESC_RE = re.compile(r"\\(.)")


def _unescape_label(v: str) -> str:
    return _LABEL_ESC_RE.sub(
        lambda m: "\n" if m.group(1) == "n" else m.group(1), v)


def _escape_label(v: str) -> str:
    return (v.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _split_labels(name: str):
    """``'req.total{model="a",tenant="t"}'`` -> ``('req.total', [('model',
    'a'), ('tenant', 't')])``; a plain or malformed name -> ``(name,
    None)``."""
    i = name.find("{")
    if i < 0 or not name.endswith("}"):
        return name, None
    block, pairs, pos = name[i + 1:-1], [], 0
    while pos < len(block):
        m = _LABEL_PAIR_RE.match(block, pos)
        if m is None:
            return name, None
        pairs.append((m.group(1), _unescape_label(m.group(2))))
        pos = m.end()
        if pos < len(block):
            if block[pos] != ",":
                return name, None
            pos += 1
    return name[:i], pairs


def prometheus_text(values: Dict[str, float], prefix: str = "cyclone",
                    types: Optional[Dict[str, str]] = None) -> str:
    """The Prometheus text exposition of ``values``
    (:meth:`MetricsRegistry.values`). With ``types``
    (:meth:`MetricsRegistry.types`) ``# TYPE`` lines are emitted and a
    summary renders as quantile, ``_sum`` and ``_count`` series. Names
    with a ``{k="v"}`` suffix emit labeled series, one ``# TYPE`` line a
    family."""
    def safe(k: str) -> str:
        return re.sub(r"[^A-Za-z0-9_:]", "_", f"{prefix}_{k}")

    types = types or {}
    lines: List[str] = []
    consumed = set()
    for base in sorted(n for n, t in types.items() if t == "summary"):
        cnt = values.get(f"{base}.count")
        consumed.update(f"{base}.{k}"
                        for k in ("count", "mean", "p50", "p95", "p99",
                                  "max"))
        if cnt is None or not _finite(cnt):
            continue
        s = safe(base)
        lines.append(f"# TYPE {s} summary")
        for q, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99"),
                       ("1", "max")):
            v = values.get(f"{base}.{key}")
            if v is not None and _finite(v):
                lines.append(f'{s}{{quantile="{q}"}} {v}')
        mean = values.get(f"{base}.mean", 0.0)
        if _finite(mean):
            lines.append(f"{s}_sum {mean * cnt}")
        lines.append(f"{s}_count {int(cnt)}")
    # the other series, grouped by family (the name without labels)
    series = []
    for k, v in values.items():
        if k in consumed or not _finite(v):
            continue
        base, pairs = _split_labels(k)
        if pairs:
            lbl = "{" + ",".join(
                f'{re.sub(r"[^A-Za-z0-9_]", "_", lk)}="{_escape_label(lv)}"'
                for lk, lv in pairs) + "}"
        else:
            lbl = ""
        series.append((safe(base), lbl, types.get(k) or types.get(base), v))
    series.sort(key=lambda s: (s[0], s[1]))
    fam_type: Dict[str, str] = {}
    for fam, _, t, _ in series:
        if t in ("counter", "gauge") and fam not in fam_type:
            fam_type[fam] = t
    prev_fam = None
    for fam, lbl, _, v in series:
        if fam != prev_fam:
            prev_fam = fam
            if fam in fam_type:
                lines.append(f"# TYPE {fam} {fam_type[fam]}")
        lines.append(f"{fam}{lbl} {v}")
    return "\n".join(lines) + "\n"
