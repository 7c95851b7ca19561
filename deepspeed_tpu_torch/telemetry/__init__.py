"""Unified telemetry: the shared metrics registry, request/step span
records, sinks, heartbeat and stall detection, the request-scoped tracer
and the replica digest (ports ``deepspeed_tpu/telemetry``; ``slo.py``
comes with the fleet)."""

from .registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    SketchHistogram,
    get_registry,
    set_registry,
)
from .digest import (  # noqa: F401
    DigestAccumulator,
    DigestSource,
    TelemetryDigest,
)
from .spans import (  # noqa: F401
    REQUEST_RECORD_SCHEMA,
    SCHEMA_VERSION,
    STEP_RECORD_SCHEMA,
    RequestStats,
    StepStats,
    validate_request_record,
    validate_step_record,
)
from .sinks import (  # noqa: F401
    JsonlSink,
    MonitorSink,
    PrometheusTextExporter,
    render_prometheus,
)
from .heartbeat import Heartbeat, StallDetector  # noqa: F401
from .telemetry import (  # noqa: F401
    Telemetry,
    configure_telemetry,
    get_telemetry,
    set_telemetry,
)
from .tracing import (  # noqa: F401
    FlightRecorder,
    Span,
    Tracer,
    configure_tracing,
    get_tracer,
    set_tracer,
    trace_tree_problems,
    use_tracer,
    validate_chrome_trace,
)
