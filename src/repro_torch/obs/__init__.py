"""Observability of the port: the metrics registry (``metrics.py``)."""
