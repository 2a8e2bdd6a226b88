"""Utilities: the metrics registry, tracing, the flight recorder, the time
series, the kernel profiler and the concurrency sanitizer shim."""
from .metrics import Histogram, MetricsRegistry, metrics

__all__ = ["Histogram", "MetricsRegistry", "metrics"]
