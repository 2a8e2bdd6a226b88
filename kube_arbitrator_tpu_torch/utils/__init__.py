"""Utilities: the metrics registry and the concurrency sanitizer shim."""
from .metrics import Histogram, MetricsRegistry, metrics

__all__ = ["Histogram", "MetricsRegistry", "metrics"]
