"""Per-step span records and their machine-readable schema.

Ports ``deepspeed_tpu/telemetry/spans.py`` (host Python; the port keeps its own
copy and imports nothing of the JAX package).

``StepStats`` is the one record answering "where did the step time go":
wall time, phase breakdown (where the execution model can attribute it),
throughput, MFU, comm-time breakdown, device-memory watermarks and the
training scalars. The JSONL sink writes one of these per step; the smoke
test and golden-file test validate every emitted line against
:data:`STEP_RECORD_SCHEMA`.

Phase attribution caveat (TPU-first honesty): the fused ``train_batch``
path compiles forward+backward+optimizer into ONE XLA program, so
``forward_s``/``backward_s``/``optimizer_s`` are ``null`` there — only the
compat ``forward()``/``backward()``/``step()`` path can time the phases
separately from the host. ``comm`` carries the CommsLogger's per-op
breakdown (bytes always; latencies once
the JAX package's ``deepspeed_tpu.comm.measure_comm_latencies`` has backfilled them).

Host-overhead ledger (docs/performance.md): ``host_ms`` is the host time
from step entry to dispatch-complete (hooks, collate-side work, transfer +
execute dispatch — everything that serializes the Python loop but not the
device), ``data_wait_ms`` the host time spent waiting for / producing
input batches since the previous record, and ``dispatch_gap_ms`` the gap
between the previous step call returning and this one entering. A record
may cover ``n_steps`` optimizer steps when the engine ran a compiled
multi-step block (``train_steps(k)``); throughput fields are already
scaled, per-step host overhead is ``(host_ms + data_wait_ms) / n_steps``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

SCHEMA_VERSION = 1


def _clock_timestamp() -> float:
    """Span timestamps come from the injectable clock seam — epoch
    seconds under the WallClock (so archived v1 JSONL streams keep
    validating unchanged), virtual-epoch seconds under a SimClock (so
    simulated runs are bit-reproducible). Imported lazily: telemetry
    loads before the resilience package in some import orders."""
    from ..resilience.clock import get_clock

    return get_clock().time()

# field -> (types, required). Required fields must be present and non-None
# in every emitted record; optional fields must type-check when present.
STEP_RECORD_SCHEMA: Dict[str, tuple] = {
    "schema_version": ((int,), True),
    "step": ((int,), True),
    "timestamp": ((float, int), True),
    "wall_time_s": ((float, int), True),
    "tokens_per_s": ((float, int), True),
    "samples_per_s": ((float, int), True),
    "mfu": ((float, int), True),
    "loss": ((float, int), False),
    "grad_norm": ((float, int), False),
    "loss_scale": ((float, int), False),
    "lr": ((float, int), False),
    "skipped": ((bool,), False),
    "forward_s": ((float, int), False),
    "backward_s": ((float, int), False),
    "optimizer_s": ((float, int), False),
    "comm_s": ((float, int), False),
    "comm": ((dict,), True),
    # max local quantization round-trip rel error across the step's
    # compressed collectives (comm_compression.error_stats)
    "quant_rel_err": ((float, int), False),
    "memory": ((dict,), True),
    "stalled": ((bool,), True),
    "n_steps": ((int,), False),
    "host_ms": ((float, int), False),
    "data_wait_ms": ((float, int), False),
    "dispatch_gap_ms": ((float, int), False),
    # distributed-tracing join keys (telemetry/tracing.py): present only
    # when a tracer is installed. Optional — NOT a schema-version bump —
    # with the same discipline as client_request_id/wire_bytes: archived
    # v1/v2 JSONL streams predate them and must keep validating.
    "trace_id": ((str,), False),
    "span_id": ((str,), False),
    # model version the step trained/served (rollout-aware runtimes
    # stamp it; optional — archived streams predate versioned serving)
    "model_version": ((int,), False),
}


@dataclass
class StepStats:
    """One training step's span record (see module docstring)."""

    step: int
    wall_time_s: float
    tokens_per_s: float = 0.0
    samples_per_s: float = 0.0
    mfu: float = 0.0
    loss: Optional[float] = None
    grad_norm: Optional[float] = None
    loss_scale: Optional[float] = None
    lr: Optional[float] = None
    skipped: Optional[bool] = None
    forward_s: Optional[float] = None
    backward_s: Optional[float] = None
    optimizer_s: Optional[float] = None
    comm_s: Optional[float] = None
    quant_rel_err: Optional[float] = None
    # optimizer steps covered by this record (>1 for train_steps(k) blocks)
    n_steps: int = 1
    # host-overhead ledger (see module docstring)
    host_ms: Optional[float] = None
    data_wait_ms: Optional[float] = None
    dispatch_gap_ms: Optional[float] = None
    # tracing join keys: the tracer's "train/step" span for this record
    trace_id: Optional[str] = None
    span_id: Optional[str] = None
    # model version in service when the step ran (None = unversioned)
    model_version: Optional[int] = None
    # per-op comm breakdown: {op: {"count": int, "bytes": int, "time_s": float}}
    comm: Dict[str, Dict[str, float]] = field(default_factory=dict)
    # device-memory watermarks from utils/memory.py (hbm_peak_gb, ...)
    memory: Dict[str, float] = field(default_factory=dict)
    stalled: bool = False
    timestamp: float = field(default_factory=_clock_timestamp)

    def to_record(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["schema_version"] = SCHEMA_VERSION
        return d


# ----------------------------------------------------------------------
# serving-request spans (docs/serving.md): one record per request reaching
# a terminal state (FINISHED / CANCELLED / REJECTED). Written by the
# ServingEngine through Telemetry.record_request_span into
# <output_dir>/requests.jsonl — a separate stream from steps.jsonl so each
# file validates against exactly one schema.
REQUEST_RECORD_SCHEMA: Dict[str, tuple] = {
    "schema_version": ((int,), True),
    "uid": ((int,), True),
    # the LOGICAL request id: stable across re-routing / fail-over /
    # prefill→decode hand-off between replicas, so one request stays one
    # id in requests.jsonl however many engines served it. Optional in
    # the schema (not a version bump): every record emitted since the
    # field landed carries it, but archived version-1 streams predate it
    # and must keep validating.
    "client_request_id": ((str,), False),
    "state": ((str,), True),
    "priority": ((int,), True),
    "prompt_tokens": ((int,), True),
    "new_tokens": ((int,), True),
    "timestamp": ((float, int), True),
    "queue_wait_s": ((float, int), False),
    "ttft_s": ((float, int), False),
    "latency_s": ((float, int), False),
    "tokens_per_s": ((float, int), False),
    "preemptions": ((int,), True),
    "retries": ((int,), True),
    # speculative-decoding ledger (serving tick): draft tokens proposed /
    # accepted over the request's life. Optional — NOT a schema-version
    # bump — same discipline as client_request_id: archived v1/v2
    # streams predate speculative serving and must keep validating.
    "spec_proposed": ((int,), False),
    "spec_accepted": ((int,), False),
    # model version that served the request (serving/rollout.py) —
    # Optional, NOT a schema-version bump, same discipline as
    # client_request_id: archived streams predate versioned serving.
    "model_version": ((int,), False),
    # tenant id the request was submitted under (per-tenant SLO
    # accounting, telemetry/slo.py). Optional — NOT a schema-version
    # bump — archived streams predate multi-tenant serving.
    "tenant": ((str,), False),
    "in_slo": ((bool,), False),
    "error": ((str,), False),
    # distributed-tracing join keys (telemetry/tracing.py): the request's
    # trace and its root span. Optional — archived v1/v2 streams predate
    # tracing and keep validating (same discipline as client_request_id).
    "trace_id": ((str,), False),
    "span_id": ((str,), False),
}

_REQUEST_STATES = ("finished", "cancelled", "rejected",
                   "queued", "prefill", "decode")


@dataclass
class RequestStats:
    """One serving request's span record: where its latency went
    (queue wait vs TTFT vs decode) and how it ended."""

    uid: int
    state: str
    client_request_id: str = ""
    priority: int = 0
    prompt_tokens: int = 0
    new_tokens: int = 0
    queue_wait_s: Optional[float] = None
    ttft_s: Optional[float] = None
    latency_s: Optional[float] = None
    tokens_per_s: Optional[float] = None
    preemptions: int = 0
    retries: int = 0
    # speculative drafting ledger: None when the request never drafted
    spec_proposed: Optional[int] = None
    spec_accepted: Optional[int] = None
    # serving model version (None predates versioned serving)
    model_version: Optional[int] = None
    # tenant id (None = untenanted; feeds per-tenant SLO attainment)
    tenant: Optional[str] = None
    in_slo: Optional[bool] = None      # None = request carried no SLO
    error: Optional[str] = None
    # tracing join keys: the request's trace and root span (tracer on)
    trace_id: Optional[str] = None
    span_id: Optional[str] = None
    timestamp: float = field(default_factory=_clock_timestamp)

    def to_record(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["schema_version"] = SCHEMA_VERSION
        return d


def validate_request_record(record: Dict[str, Any]) -> List[str]:
    """Validate one requests.jsonl record against
    :data:`REQUEST_RECORD_SCHEMA`. Returns violation strings; empty means
    valid."""
    errors = _validate_against(record, REQUEST_RECORD_SCHEMA)
    state = record.get("state") if isinstance(record, dict) else None
    if isinstance(state, str) and state not in _REQUEST_STATES:
        errors.append(f"unknown request state '{state}'")
    return errors


def _validate_against(record: Dict[str, Any],
                      schema: Dict[str, tuple]) -> List[str]:
    errors: List[str] = []
    if not isinstance(record, dict):
        return [f"record is {type(record).__name__}, expected dict"]
    for name, (types, required) in schema.items():
        if name not in record or record[name] is None:
            if required:
                errors.append(f"missing required field '{name}'")
            continue
        v = record[name]
        # bool is an int subclass; reject it where int means "number"
        if isinstance(v, bool) and bool not in types:
            errors.append(f"field '{name}' is bool, expected {types}")
        elif not isinstance(v, types):
            errors.append(
                f"field '{name}' is {type(v).__name__}, expected {types}")
    if record.get("schema_version") not in (None, SCHEMA_VERSION):
        errors.append(
            f"schema_version {record.get('schema_version')} != {SCHEMA_VERSION}")
    return errors


def validate_step_record(record: Dict[str, Any]) -> List[str]:
    """Validate one JSONL step record against :data:`STEP_RECORD_SCHEMA`.
    Returns a list of violation strings; empty means valid."""
    errors = _validate_against(record, STEP_RECORD_SCHEMA)
    if errors and not isinstance(record, dict):
        return errors
    if isinstance(record.get("comm"), dict):
        for op, entry in record["comm"].items():
            if not isinstance(entry, dict):
                errors.append(f"comm['{op}'] is not a dict")
                continue
            for k in ("count", "bytes", "time_s"):
                if not isinstance(entry.get(k), (int, float)) or \
                        isinstance(entry.get(k), bool):
                    errors.append(f"comm['{op}']['{k}'] missing or non-numeric")
            # v2 bytes-on-wire ledger field: optional so archived v1
            # snapshots keep validating, but must be numeric when present
            if "wire_bytes" in entry and (
                    not isinstance(entry["wire_bytes"], (int, float))
                    or isinstance(entry["wire_bytes"], bool)):
                errors.append(f"comm['{op}']['wire_bytes'] non-numeric")
    if isinstance(record.get("memory"), dict):
        for k, v in record["memory"].items():
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                errors.append(f"memory['{k}'] non-numeric")
    return errors
