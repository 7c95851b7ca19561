"""Telemetry: the shared metrics registry (counters and gauges)."""

from .registry import (Counter, Gauge, MetricsRegistry,  # noqa: F401
                       get_registry, set_registry)
