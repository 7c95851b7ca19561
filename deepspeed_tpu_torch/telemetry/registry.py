"""Metrics registry: counters, gauges, histograms with percentile summaries.

Ports ``deepspeed_tpu/telemetry/registry.py`` (host Python; the port keeps its own
copy and imports nothing of the JAX package).

The reference scatters its numbers across ``utils/timer.py`` aggregates,
``monitor/`` event tuples and the CommsLogger's ad-hoc dicts. This registry
is the one shared store they all feed: plain host-side Python (no device
traffic, no torch import), safe to update from the training loop, the
inference engines and the comm facade alike. Exporters
(:mod:`deepspeed_tpu_torch.telemetry.sinks`) render snapshots of it.

Metric names are ``/``-separated paths (``train/step_time_s``,
``comm/all_reduce/bytes``); the Prometheus exporter flattens them to
``_``-separated series names.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Dict, List, Optional, Tuple


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


class Histogram:
    """Streaming distribution with percentile summaries.

    Keeps exact count/sum/min/max plus a bounded window of the most recent
    ``window`` observations for percentile estimates — deterministic (no
    sampling) and the right bias for operational telemetry, where "p99 over
    the recent past" beats "p99 since process start".
    """

    __slots__ = ("name", "count", "sum", "min", "max", "_window", "_buf",
                 "_pos", "_lock")

    def __init__(self, name: str, window: int = 1024):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._window = window
        self._buf: List[float] = []
        self._pos = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            if len(self._buf) < self._window:
                self._buf.append(v)
            else:  # ring: overwrite oldest
                self._buf[self._pos] = v
                self._pos = (self._pos + 1) % self._window

    @staticmethod
    def _rank(data: List[float], p: float) -> Optional[float]:
        """Linear-interpolated percentile of an already-sorted list."""
        if not data:
            return None
        if len(data) == 1:
            return data[0]
        rank = (p / 100.0) * (len(data) - 1)
        lo = int(rank)
        hi = min(lo + 1, len(data) - 1)
        frac = rank - lo
        return data[lo] * (1.0 - frac) + data[hi] * frac

    def percentile(self, p: float) -> Optional[float]:
        """Linear-interpolated percentile over the recent window.
        ``p`` in [0, 100]."""
        with self._lock:
            data = sorted(self._buf)
        return self._rank(data, p)

    def percentiles(self, ps: List[float]) -> List[Optional[float]]:
        """Several percentiles from ONE sorted copy of the window."""
        with self._lock:
            data = sorted(self._buf)
        return [self._rank(data, p) for p in ps]

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def summary(self) -> Dict[str, Optional[float]]:
        p50, p90, p99 = self.percentiles([50, 90, 99])
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "mean": self.mean,
            "p50": p50,
            "p90": p90,
            "p99": p99,
        }


class SketchHistogram:
    """Mergeable log-bucketed quantile sketch (DDSketch-style).

    Values map to geometric buckets ``(gamma^(i-1), gamma^i]`` with
    ``gamma = (1+alpha)/(1-alpha)``, so any quantile read from bucket
    midpoints carries a guaranteed relative error ``<= alpha`` — no
    sample window, no sort. ``observe`` is O(1) (a dict increment),
    ``percentile`` is O(buckets), and ``merge`` is bucket-count
    addition: associative, commutative, with the empty sketch as
    identity. That algebra is what makes replica→fleet→cell→region
    digest rollups exact — merging per-cell sketches gives the SAME
    bucket counts as observing the pooled stream directly.

    Negative values mirror into a second bucket map; magnitudes below
    ``ZERO_EPS`` land in a dedicated zero bucket. ``count``/``sum``/
    ``min``/``max`` stay exact. Everything is deterministic: bucket
    index is a pure function of the value, and :meth:`serialize`
    emits index-sorted rows, so equal observation multisets produce
    bit-identical serialized forms regardless of arrival order.
    """

    ZERO_EPS = 1e-12

    __slots__ = ("name", "alpha", "count", "sum", "min", "max", "_gamma",
                 "_ln_gamma", "_zero", "_pos", "_neg", "_lock")

    def __init__(self, name: str, alpha: float = 0.01):
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"sketch {name}: alpha must be in (0, 1), "
                             f"got {alpha}")
        self.name = name
        self.alpha = float(alpha)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._gamma = (1.0 + self.alpha) / (1.0 - self.alpha)
        self._ln_gamma = math.log(self._gamma)
        self._zero = 0
        self._pos: Dict[int, int] = {}
        self._neg: Dict[int, int] = {}
        self._lock = threading.Lock()

    def _index(self, magnitude: float) -> int:
        return int(math.ceil(math.log(magnitude) / self._ln_gamma))

    def _midpoint(self, index: int) -> float:
        # midpoint of (gamma^(i-1), gamma^i] that bounds relative error
        # by alpha: 2*gamma^i / (gamma + 1)
        return 2.0 * math.pow(self._gamma, index) / (self._gamma + 1.0)

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            a = abs(v)
            if a < self.ZERO_EPS:
                self._zero += 1
            elif v > 0:
                i = self._index(a)
                self._pos[i] = self._pos.get(i, 0) + 1
            else:
                i = self._index(a)
                self._neg[i] = self._neg.get(i, 0) + 1

    def _walk(self) -> List[Tuple[float, int]]:
        """Buckets in ascending value order as ``(estimate, count)``
        rows. Caller holds the lock."""
        rows: List[Tuple[float, int]] = []
        for i in sorted(self._neg, reverse=True):
            rows.append((-self._midpoint(i), self._neg[i]))
        if self._zero:
            rows.append((0.0, self._zero))
        for i in sorted(self._pos):
            rows.append((self._midpoint(i), self._pos[i]))
        return rows

    def percentile(self, p: float) -> Optional[float]:
        """Bucket-walk percentile, ``p`` in [0, 100]. The returned
        estimate is within ``alpha`` relative error of the exact
        same-rank order statistic (rank ``floor(p/100 * (n-1))``)."""
        with self._lock:
            return self._percentile_locked(p)

    def _percentile_locked(self, p: float) -> Optional[float]:
        if self.count == 0:
            return None
        target = int(math.floor((p / 100.0) * (self.count - 1) + 1e-9))
        seen = 0
        for est, n in self._walk():
            seen += n
            if seen > target:
                return est
        return self.max  # unreachable unless float drift; stay safe

    @property
    def mean(self) -> Optional[float]:
        with self._lock:
            return self.sum / self.count if self.count else None

    def merge(self, other: "SketchHistogram") -> "SketchHistogram":
        """Fold ``other`` into this sketch. Bucket addition — associative
        and commutative, so any rollup tree order gives one answer."""
        if abs(other.alpha - self.alpha) > 1e-12:
            raise ValueError(
                f"sketch {self.name}: cannot merge alpha={other.alpha} "
                f"into alpha={self.alpha}")
        # lock ordering: acquire other's snapshot first, then mutate
        # under our own lock — never hold both
        with other._lock:
            o_count, o_sum = other.count, other.sum
            o_min, o_max = other.min, other.max
            o_zero = other._zero
            o_pos = dict(other._pos)
            o_neg = dict(other._neg)
        with self._lock:
            self.count += o_count
            self.sum += o_sum
            if o_min is not None:
                self.min = o_min if self.min is None else min(self.min, o_min)
            if o_max is not None:
                self.max = o_max if self.max is None else max(self.max, o_max)
            self._zero += o_zero
            for i, n in o_pos.items():
                self._pos[i] = self._pos.get(i, 0) + n
            for i, n in o_neg.items():
                self._neg[i] = self._neg.get(i, 0) + n
        return self

    def serialize(self) -> Dict[str, Any]:
        """Stable wire form: index-sorted bucket rows, exact aggregates.
        Equal observation multisets serialize bit-identically."""
        with self._lock:
            return {
                "alpha": self.alpha,
                "count": self.count,
                "sum": self.sum,
                "min": self.min,
                "max": self.max,
                "zero": self._zero,
                "pos": [[i, self._pos[i]] for i in sorted(self._pos)],
                "neg": [[i, self._neg[i]] for i in sorted(self._neg)],
            }

    @classmethod
    def deserialize(cls, name: str, d: Dict[str, Any]) -> "SketchHistogram":
        s = cls(name, alpha=float(d["alpha"]))
        s.count = int(d["count"])
        s.sum = float(d["sum"])
        s.min = None if d.get("min") is None else float(d["min"])
        s.max = None if d.get("max") is None else float(d["max"])
        s._zero = int(d.get("zero", 0))
        s._pos = {int(i): int(n) for i, n in d.get("pos", [])}
        s._neg = {int(i): int(n) for i, n in d.get("neg", [])}
        return s

    def bucket_bounds(self) -> List[Tuple[float, int]]:
        """``(upper_bound, count)`` rows in ascending bound order for
        cumulative-bucket exporters: negative buckets close at
        ``-gamma^(i-1)``, the zero bucket at ``ZERO_EPS``, positive
        buckets at ``gamma^i``."""
        with self._lock:
            rows: List[Tuple[float, int]] = []
            for i in sorted(self._neg, reverse=True):
                rows.append((-math.pow(self._gamma, i - 1), self._neg[i]))
            if self._zero:
                rows.append((self.ZERO_EPS, self._zero))
            for i in sorted(self._pos):
                rows.append((math.pow(self._gamma, i), self._pos[i]))
            return rows

    def summary(self) -> Dict[str, Optional[float]]:
        with self._lock:   # one consistent snapshot (lock is not
            return {       # reentrant: use the _locked percentile)
                "count": self.count,
                "sum": self.sum,
                "min": self.min,
                "max": self.max,
                "mean": self.sum / self.count if self.count else None,
                "p50": self._percentile_locked(50),
                "p90": self._percentile_locked(90),
                "p99": self._percentile_locked(99),
            }


class MetricsRegistry:
    """Get-or-create store of named metrics.

    A name is bound to one metric kind for the registry's lifetime;
    re-requesting it with a different kind is a programming error and
    raises instead of silently shadowing.
    """

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, **kwargs)
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

    def histogram(self, name: str, window: int = 1024) -> Histogram:
        return self._get(name, Histogram, window=window)

    def sketch(self, name: str, alpha: float = 0.01) -> SketchHistogram:
        return self._get(name, SketchHistogram, alpha=alpha)

    def metrics(self) -> Dict[str, object]:
        with self._lock:
            return dict(self._metrics)

    def snapshot(self) -> Dict[str, object]:
        """JSON-serializable view of every metric: counters/gauges as
        scalars, histograms as their summary dict."""
        out: Dict[str, object] = {}
        for name, m in self.metrics().items():
            if isinstance(m, (Histogram, SketchHistogram)):
                out[name] = m.summary()
            else:
                out[name] = m.value
        return out

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


# ----------------------------------------------------------------------
# default registry: the shared store the comm facade, inference engines and
# resilience counters feed when not handed an explicit one
_DEFAULT = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _DEFAULT


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    global _DEFAULT
    _DEFAULT = registry
    return registry
