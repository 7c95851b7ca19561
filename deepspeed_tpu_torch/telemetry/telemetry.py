"""The telemetry facade: one pipeline from metric sources to sinks.

Ports ``deepspeed_tpu/telemetry/telemetry.py`` (host Python; the port keeps its own
copy and imports nothing of the JAX package).

``Telemetry`` owns the metrics registry, the configured sinks and the
stall detector, and is the single object the engines talk to. The train
engine calls :meth:`record_step` once per optimizer step; the inference
engines call :meth:`record_request`; everything else (comm facade,
resilience counters) feeds the shared registry directly.

A process-global instance (installed by the first engine whose config
enables telemetry, or explicitly via :func:`configure_telemetry`) lets
code without a config handle — the comm facade, the ragged engine's KV
allocator — reach the same registry. When nothing installed one,
:func:`get_telemetry` returns a disabled instance whose hooks are cheap
no-ops, so instrumented call sites need no conditional imports.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional

from ..utils.logging import logger
from .heartbeat import Heartbeat, StallDetector
from .registry import MetricsRegistry, get_registry
from .sinks import JsonlSink, MonitorSink, PrometheusTextExporter
from .spans import RequestStats, StepStats


class Telemetry:
    """Fan-out pipeline: StepStats / request metrics -> registry + sinks."""

    def __init__(self, config: Any = None, registry: Optional[MetricsRegistry] = None,
                 monitor: Any = None):
        # config is a config.TelemetryConfig (duck-typed to avoid a hard
        # dependency direction between the config and telemetry layers)
        self.config = config
        self.registry = registry if registry is not None else get_registry()
        self.sinks: List[Any] = []
        self.stall_detector: Optional[StallDetector] = None
        self.heartbeat: Optional[Heartbeat] = None
        self._closed = False
        self._requests_path: Optional[str] = None
        self._requests_sink: Optional[JsonlSink] = None
        # spans arrive concurrently from the serving driver thread and
        # client threads (submit/cancel emit outside the serving lock):
        # serialize sink creation + writes or lines tear
        self._requests_lock = threading.Lock()

        enabled = bool(getattr(config, "enabled", False))
        if enabled:
            # file sinks are rank-0-only (same discipline as log_dist): on
            # a multi-process pod every host sees the same global metrics,
            # and N writers appending to one steps.jsonl on shared storage
            # would interleave duplicate records and race the atomic
            # renames. In-registry series still update on every process.
            from ..utils.logging import _process_index

            writer_rank = _process_index() == 0
            out_dir = getattr(config, "output_dir", "telemetry") or "telemetry"
            jsonl_path = getattr(config, "jsonl_path", None)
            if jsonl_path is None:
                jsonl_path = os.path.join(out_dir, "steps.jsonl")
            if jsonl_path and writer_rank:  # "" disables the sink explicitly
                self.sinks.append(JsonlSink(
                    jsonl_path,
                    flush_every=getattr(config, "flush_every", 1)))
            prom_path = getattr(config, "prometheus_path", None)
            if prom_path and writer_rank:
                self.sinks.append(PrometheusTextExporter(
                    self.registry, prom_path,
                    export_every=getattr(config, "export_every", 10)))
            if getattr(config, "stall_detection", True):
                self.stall_detector = StallDetector(
                    window=getattr(config, "stall_window", 20),
                    factor=getattr(config, "stall_factor", 3.0),
                    warmup_steps=getattr(config, "stall_warmup_steps", 2))
            hb_path = getattr(config, "heartbeat_path", None)
            if hb_path and writer_rank:
                self.heartbeat = Heartbeat(hb_path)
            # serving-request spans get their own JSONL stream (a step
            # sink must see only step records — one file, one schema);
            # created lazily on the first span so train-only runs never
            # touch a requests.jsonl
            req_path = getattr(config, "requests_jsonl_path", None)
            if req_path is None:
                req_path = os.path.join(out_dir, "requests.jsonl")
            self._requests_path = req_path if writer_rank else None
            # request-scoped tracing + flight recorder (tracing.py):
            # installing the pipeline installs (or, with tracing off,
            # CLEARS) its tracer — same process-global discipline as
            # set_telemetry/set_registry, and re-initializing with
            # tracing=false must actually turn a previous tracer off.
            # Disabled Telemetry stubs (enabled=false) never touch the
            # tracer: a directly-installed one must survive them.
            from .tracing import configure_tracing

            configure_tracing(config)
        if monitor is not None:
            self.sinks.append(MonitorSink(monitor))
        self.enabled = enabled

    # -- training -------------------------------------------------------
    @property
    def wants_step_records(self) -> bool:
        """True when the engine must assemble per-step StepStats (and
        therefore fetch scalars / sync per step): any sink configured, or
        stall detection / heartbeat active (they consume records too, even
        with every file sink disabled or on non-writer ranks). The
        telemetry-off, monitor-off path must see False so it keeps the
        seed's sync discipline."""
        return not self._closed and bool(
            self.sinks or self.stall_detector is not None
            or self.heartbeat is not None)

    def record_step(self, stats: StepStats) -> Dict[str, Any]:
        """Run stall detection, update the registry, fan out to sinks.
        Returns the emitted record dict."""
        if self.stall_detector is not None:
            # normalized per optimizer step: mixing per-step records with
            # train_steps(k) blocks must not read as a k x stall
            stats.stalled = self.stall_detector.observe(
                stats.step,
                stats.wall_time_s / max(1, int(getattr(stats, "n_steps", 1) or 1)))
        n = max(1, int(getattr(stats, "n_steps", 1) or 1))
        r = self.registry
        r.counter("train/steps").inc(n)
        r.histogram("train/step_time_s").observe(stats.wall_time_s / n)
        # host-overhead ledger, normalized per optimizer step so per-step
        # and train_steps(k) records land in comparable distributions
        if stats.host_ms is not None:
            r.histogram("train/host_ms").observe(stats.host_ms / n)
        if stats.data_wait_ms is not None:
            r.histogram("train/data_wait_ms").observe(stats.data_wait_ms / n)
        if stats.dispatch_gap_ms is not None:
            r.histogram("train/dispatch_gap_ms").observe(stats.dispatch_gap_ms)
        if stats.tokens_per_s:
            r.gauge("train/tokens_per_s").set(stats.tokens_per_s)
        if stats.mfu:
            r.gauge("train/mfu").set(stats.mfu)
        if stats.loss is not None:
            r.gauge("train/loss").set(stats.loss)
        if stats.skipped:
            r.counter("train/skipped_steps").inc()
        if stats.stalled:
            r.counter("train/stalled_steps").inc()
        if self.heartbeat is not None:
            self.heartbeat.beat(stats.step)
        record = stats.to_record()
        for sink in self.sinks:
            try:
                sink.write(record)
            except Exception as e:  # a broken sink must not kill training
                logger.warning(f"telemetry sink {type(sink).__name__} "
                               f"failed: {e}")
        return record

    # -- inference ------------------------------------------------------
    def record_request(self, latency_s: Optional[float] = None,
                       ttft_s: Optional[float] = None,
                       new_tokens: int = 0,
                       decode_tokens_per_s: Optional[float] = None) -> None:
        """Each argument is observed independently, so engines that learn
        TTFT and completion at different times (the ragged engine: first
        logits vs. flush) report in two calls. A request counts as one
        request when its end-to-end ``latency_s`` is reported."""
        if not self.enabled:  # the nothing-configured global stub
            return
        r = self.registry
        if latency_s is not None:
            r.counter("inference/requests").inc()
            r.histogram("inference/request_latency_s").observe(latency_s)
        if ttft_s is not None:
            r.histogram("inference/ttft_s").observe(ttft_s)
        if new_tokens:
            r.counter("inference/generated_tokens").inc(new_tokens)
        if decode_tokens_per_s is not None:
            r.histogram("inference/decode_tokens_per_s").observe(
                decode_tokens_per_s)

    # -- serving --------------------------------------------------------
    def record_request_span(self, stats: RequestStats) -> Dict[str, Any]:
        """One serving request reached a terminal state: update the
        ``serving/*`` registry series and append the span record to the
        requests JSONL stream (validated by REQUEST_RECORD_SCHEMA).
        Returns the emitted record dict."""
        record = stats.to_record()
        if not self.enabled:
            return record
        r = self.registry
        # hot-path serving metrics are SKETCHES (docs/observability.md
        # "Sketch vs exact-window"): O(1) observe, mergeable up the
        # replica→region rollup, bounded relative error on percentiles.
        # Low-rate training metrics keep the exact-window Histogram.
        if stats.queue_wait_s is not None:
            r.sketch("serving/queue_wait_s").observe(stats.queue_wait_s)
        if stats.ttft_s is not None:
            r.sketch("serving/ttft_s").observe(stats.ttft_s)
        if stats.latency_s is not None:
            r.sketch("serving/request_latency_s").observe(stats.latency_s)
        if stats.tokens_per_s is not None:
            r.sketch("serving/tokens_per_s").observe(stats.tokens_per_s)
        if stats.new_tokens:
            r.counter("serving/generated_tokens").inc(stats.new_tokens)
        if stats.in_slo is not None:
            r.counter("serving/slo_judged").inc()
            if stats.in_slo:
                r.counter("serving/slo_met").inc()
        if not self._closed and self._requests_path:
            with self._requests_lock:
                try:
                    if self._requests_sink is None:
                        self._requests_sink = JsonlSink(self._requests_path)
                    self._requests_sink.write(record)
                except Exception as e:   # a broken sink must not kill serving
                    logger.warning(f"telemetry requests sink failed: {e}")
                    if self._requests_sink is None:
                        # the sink could not even be constructed (unwritable
                        # path): disable it instead of re-raising every span
                        self._requests_path = None
        return record

    # -- lifecycle ------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for sink in self.sinks:
            try:
                sink.close()
            except Exception as e:
                logger.warning(f"telemetry sink {type(sink).__name__} "
                               f"close failed: {e}")
        self.sinks = []
        with self._requests_lock:
            if self._requests_sink is not None:
                try:
                    self._requests_sink.close()
                except Exception as e:
                    logger.warning(
                        f"telemetry requests sink close failed: {e}")
                self._requests_sink = None


# ----------------------------------------------------------------------
_GLOBAL: Optional[Telemetry] = None
_DISABLED = None  # lazy singleton for the nothing-configured path


def get_telemetry() -> Telemetry:
    """The installed global Telemetry, or a disabled no-op instance."""
    global _DISABLED
    if _GLOBAL is not None:
        return _GLOBAL
    if _DISABLED is None:
        _DISABLED = Telemetry(config=None)
    return _DISABLED


def set_telemetry(t: Optional[Telemetry]) -> Optional[Telemetry]:
    """Install ``t`` as the process-global telemetry (None to clear).

    Installing a pipeline also makes its registry the process default, so
    call sites that only know the registry (the comm facade, resilience
    counters) feed the same store the pipeline's exporters render."""
    global _GLOBAL
    _GLOBAL = t
    if t is not None:
        from .registry import set_registry

        set_registry(t.registry)
    return t


def configure_telemetry(config: Any = None,
                        registry: Optional[MetricsRegistry] = None,
                        monitor: Any = None) -> Telemetry:
    """Create a Telemetry from a TelemetryConfig and install it globally."""
    return set_telemetry(Telemetry(config, registry=registry, monitor=monitor))
