"""Telemetry sinks: where step records and registry snapshots go.

Ports ``deepspeed_tpu/telemetry/sinks.py`` (host Python; the port keeps its own
copy and imports nothing of the JAX package).

A sink is anything with ``write(record: dict)`` and ``close()``. The
``Telemetry`` facade fans each step record out to every configured sink:

* :class:`JsonlSink` — structured machine-readable log, one JSON object
  per line (the format the smoke test and golden-file test validate).
* :class:`PrometheusTextExporter` — renders the metrics registry in the
  Prometheus text exposition format to a file on every ``export_every``-th
  record (atomic rename, so a scraper never reads a torn file).
* :class:`MonitorSink` — adapts any object with ``write_events(events)``
  (the JAX package's ``MonitorMaster`` shape: TensorBoard/CSV/W&B
  writers; the port has no ``monitor/`` package yet, so the adapter is
  duck-typed) into this fan-out.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional

from ..utils.logging import logger
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       SketchHistogram)


class JsonlSink:
    """Append-only JSONL writer; ``flush_every`` bounds record loss on
    crash (1 = flush per record, the default for small step counts)."""

    def __init__(self, path: str, flush_every: int = 1):
        self.path = path
        self.flush_every = max(1, int(flush_every))
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")
        self._pending = 0

    def write(self, record: Dict[str, Any]) -> None:
        self._f.write(json.dumps(record, default=_json_default) + "\n")
        self._pending += 1
        if self._pending >= self.flush_every:
            self._f.flush()
            self._pending = 0

    def close(self) -> None:
        if self._f is not None and not self._f.closed:
            self._f.flush()
            self._f.close()


def _json_default(x):
    # numpy / torch scalars that slipped into a record
    if hasattr(x, "item"):
        return x.item()
    return str(x)


_PROM_NAME = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return _PROM_NAME.sub("_", name)


def render_prometheus(registry: MetricsRegistry,
                      prefix: str = "dst") -> str:
    """Render every metric in ``registry`` in the Prometheus text format.
    Exact-window :class:`Histogram` exports as a summary (count/sum +
    p50/p90/p99 quantiles); :class:`SketchHistogram` exports as a native
    Prometheus histogram — cumulative ``_bucket{le=...}`` series straight
    from the sketch's log-bucket upper bounds, so server-side quantile
    math (``histogram_quantile``) and cross-scrape aggregation work."""
    lines = []
    for name, m in sorted(registry.metrics().items()):
        pname = f"{prefix}_{_prom_name(name)}"
        if isinstance(m, Counter):
            lines.append(f"# TYPE {pname} counter")
            lines.append(f"{pname} {m.value}")
        elif isinstance(m, Gauge):
            if m.value is None:
                continue
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {m.value}")
        elif isinstance(m, SketchHistogram):
            lines.append(f"# TYPE {pname} histogram")
            cum = 0
            for ub, n in m.bucket_bounds():
                cum += n
                lines.append(
                    f"{pname}_bucket{{le=\"{ub}\"}} {cum}")
            lines.append(f"{pname}_bucket{{le=\"+Inf\"}} {m.count}")
            lines.append(f"{pname}_sum {m.sum}")
            lines.append(f"{pname}_count {m.count}")
        elif isinstance(m, Histogram):
            lines.append(f"# TYPE {pname} summary")
            for q in (50, 90, 99):
                v = m.percentile(q)
                if v is not None:
                    lines.append(
                        f"{pname}{{quantile=\"{q / 100}\"}} {v}")
            lines.append(f"{pname}_sum {m.sum}")
            lines.append(f"{pname}_count {m.count}")
    return "\n".join(lines) + ("\n" if lines else "")


class PrometheusTextExporter:
    """Writes the registry to ``path`` in text exposition format. With
    ``path=None`` it only serves :meth:`render` (pull-style use)."""

    def __init__(self, registry: MetricsRegistry, path: Optional[str] = None,
                 export_every: int = 1, prefix: str = "dst"):
        self.registry = registry
        self.path = path
        self.export_every = max(1, int(export_every))
        self.prefix = prefix
        self._since_export = 0
        if path:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)

    def render(self) -> str:
        return render_prometheus(self.registry, prefix=self.prefix)

    def export(self) -> None:
        if not self.path:
            return
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(self.render())
        os.replace(tmp, self.path)

    # sink protocol: a step record arriving is the export trigger; the
    # content comes from the registry, not the record
    def write(self, record: Dict[str, Any]) -> None:
        self._since_export += 1
        if self._since_export >= self.export_every:
            self.export()
            self._since_export = 0

    def close(self) -> None:
        try:
            self.export()
        except OSError as e:  # closing must not mask the real failure
            logger.warning(f"prometheus export on close failed: {e}")


class MonitorSink:
    """Adapter: step records -> scalar events for any ``monitor`` with
    ``write_events([(name, value, step), ...])`` (and optionally
    ``close()``) — the JAX package's MonitorMaster surface, duck-typed."""

    # record field -> legacy event name (the series the reference's
    # _write_monitor emitted, plus the new throughput/memory series)
    SCALARS = (
        ("loss", "Train/loss"),
        ("lr", "Train/lr"),
        ("grad_norm", "Train/grad_norm"),
        ("wall_time_s", "Train/step_time_s"),
        ("tokens_per_s", "Train/tokens_per_s"),
        ("samples_per_s", "Train/samples_per_s"),
        ("mfu", "Train/mfu"),
    )

    def __init__(self, monitor: Any):
        self.monitor = monitor

    def write(self, record: Dict[str, Any]) -> None:
        step = int(record.get("step", 0))
        events = []
        for field_name, event_name in self.SCALARS:
            v = record.get(field_name)
            if v is not None:
                events.append((event_name, float(v), step))
        for k, v in (record.get("memory") or {}).items():
            events.append((f"Memory/{k}", float(v), step))
        if events:
            self.monitor.write_events(events)

    def close(self) -> None:
        close = getattr(self.monitor, "close", None)
        if close is not None:
            close()
