"""Metrics registry: counters and gauges.

Ports ``Counter``, ``Gauge``, ``MetricsRegistry``, ``get_registry`` and
``set_registry`` of ``deepspeed_tpu/telemetry/registry.py``: plain host-side
Python, shared by the comm facade (``comm/facade/fused[/<op>]``,
``comm/facade/fallbacks[/<op>]``) and the comms ledger
(``comm/<op>/{calls,bytes,wire_bytes}``). Histograms and sketches come with
a later slice.

The JAX package bumps these counters at trace time, once per traced
program; the port runs eagerly, so it bumps them once per call.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional


class Counter:
    """Monotonically increasing count (events, bytes, retries)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-observed value (occupancy, loss scale, free blocks)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value: Optional[float] = None
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> Optional[float]:
        with self._lock:
            return self._value


class MetricsRegistry:
    """Get-or-create store of named metrics. A name is bound to one metric
    kind for the registry's lifetime; asking for it as another kind
    raises."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric '{name}' already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def metrics(self) -> Dict[str, object]:
        with self._lock:
            return dict(self._metrics)

    def snapshot(self) -> Dict[str, object]:
        """Every metric's value, by name."""
        return {name: m.value for name, m in self.metrics().items()}

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


_DEFAULT = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _DEFAULT


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    global _DEFAULT
    _DEFAULT = registry
    return registry
