"""Metrics registry: labeled counters, gauges and histograms, with a
scoped stack.

The port's own small copy of ``repro/obs/metrics.py`` (pure Python; never
touches a device). What it keeps: ``MetricsRegistry`` (counters, last-value
gauges, and histograms of raw observations summarised at snapshot time),
the ``scoped()`` registry stack (records land in every scope down to the
first ``isolate=True`` one, else the process-global base), the
module-level ``inc`` / ``set_gauge`` / ``observe``, the percentile math the
tracer's summaries use (``percentile``, ``summarize``), and the
``kernel_dispatch_total{op,backend,m_bucket,bits}`` counter schema.

One difference from the reference: there the counter is recorded at jit
trace time; the port runs eagerly, so every call of a kernel op counts.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Iterator, Optional


def percentile(values, q: float) -> Optional[float]:
    """q-th percentile (0..100) by linear interpolation between closest
    ranks, numpy's default 'linear' method; None for an empty input."""
    xs = sorted(float(v) for v in values)
    if not xs:
        return None
    if len(xs) == 1:
        return xs[0]
    rank = (q / 100.0) * (len(xs) - 1)
    lo = math.floor(rank)
    hi = math.ceil(rank)
    if lo == hi:
        return xs[int(rank)]
    frac = rank - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


def summarize(values) -> dict:
    """count/mean/min/max/p50/p95/p99 of raw observations (every field but
    count None for an empty series)."""
    xs = [float(v) for v in values]
    if not xs:
        return {"count": 0, "mean": None, "min": None, "max": None,
                "p50": None, "p95": None, "p99": None}
    return {
        "count": len(xs),
        "mean": sum(xs) / len(xs),
        "min": min(xs),
        "max": max(xs),
        "p50": percentile(xs, 50),
        "p95": percentile(xs, 95),
        "p99": percentile(xs, 99),
    }


_Key = tuple  # (name, ((label, value), ...))


def _key(name: str, labels: dict) -> _Key:
    return (name, tuple(sorted((str(k), str(v)) for k, v in labels.items())))


def _fmt_key(key: _Key) -> str:
    name, labels = key
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


class MetricsRegistry:
    """Labeled counters, last-value gauges and histograms."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[_Key, float] = {}
        self._gauges: dict[_Key, Any] = {}
        self._hists: dict[_Key, list] = {}

    def inc(self, name: str, value: float = 1, **labels) -> None:
        k = _key(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0) + value

    def set_counter(self, name: str, value: float, **labels) -> None:
        with self._lock:
            self._counters[_key(name, labels)] = value

    def set_gauge(self, name: str, value, **labels) -> None:
        with self._lock:
            self._gauges[_key(name, labels)] = value

    def observe(self, name: str, value: float, **labels) -> None:
        k = _key(name, labels)
        with self._lock:
            self._hists.setdefault(k, []).append(float(value))

    def get(self, name: str, default: float = 0, **labels) -> float:
        return self._counters.get(_key(name, labels), default)


    def counter_total(self, name: str, **labels) -> float:
        """Sum of a counter over all label sets matching ``labels``."""
        want = set((str(k), str(v)) for k, v in labels.items())
        return sum(v for (n, ls), v in self._counters.items()
                   if n == name and want <= set(ls))

    def snapshot(self) -> dict:
        """JSON-ready view with flat ``name{k=v,...}`` keys; histograms
        become ``summarize`` summaries."""
        with self._lock:
            return {
                "counters": {_fmt_key(k): v
                             for k, v in sorted(self._counters.items())},
                "gauges": {_fmt_key(k): v
                           for k, v in sorted(self._gauges.items())},
                "histograms": {_fmt_key(k): summarize(v)
                               for k, v in sorted(self._hists.items())},
            }


_GLOBAL = MetricsRegistry()
_STACK: list[tuple[MetricsRegistry, bool]] = []   # (registry, isolate)


def active_registries() -> Iterator[MetricsRegistry]:
    """Innermost scope outward, stopping at the first isolating scope,
    else down to the process-global base."""
    for reg, isolate in reversed(_STACK):
        yield reg
        if isolate:
            return
    yield _GLOBAL


@contextlib.contextmanager
def scoped(isolate: bool = False, registry: Optional[MetricsRegistry] = None):
    """Push a registry (a fresh one unless ``registry`` is given) for the
    block; yields it."""
    reg = MetricsRegistry() if registry is None else registry
    _STACK.append((reg, isolate))
    try:
        yield reg
    finally:
        _STACK.pop()


def inc(name: str, value: float = 1, **labels) -> None:
    for reg in active_registries():
        reg.inc(name, value, **labels)


def set_gauge(name: str, value, **labels) -> None:
    for reg in active_registries():
        reg.set_gauge(name, value, **labels)


def observe(name: str, value: float, **labels) -> None:
    for reg in active_registries():
        reg.observe(name, value, **labels)


KERNEL_DISPATCH = "kernel_dispatch_total"


def m_bucket(m: Optional[int]) -> str:
    """Row-count bucket: exact for m <= 8, power-of-two ``le{N}`` above."""
    if m is None:
        return "na"
    m = int(m)
    if m <= 8:
        return str(m)
    return f"le{1 << (m - 1).bit_length()}"


def record_kernel_dispatch(op: str, backend: str, *, m: Optional[int] = None,
                           bits: Optional[int] = None) -> None:
    inc(KERNEL_DISPATCH, op=op, backend=backend, m_bucket=m_bucket(m),
        bits="na" if bits is None else str(bits))
