"""Observability of the port, host-side and torch-free: the metrics
registry (``metrics.py``) and the request tracer (``trace.py``)."""

from . import metrics  # noqa: F401
from .metrics import MetricsRegistry, percentile, scoped, summarize  # noqa: F401
from .trace import FakeClock, Span, Tracer  # noqa: F401
