"""Request-scoped distributed tracing + flight recorder.

Ports ``deepspeed_tpu/telemetry/tracing.py`` (host Python; the port keeps its own
copy and imports nothing of the JAX package).

The serving stack spans a router, N replicas, disaggregated KV
hand-off, failover re-routes and retries; flat counters and per-
lifecycle span *records* (spans.py) say what happened to a request but
not *when/where* along its timeline. This module is the causal layer:

* :class:`Span` — one timed node in a trace tree (``trace_id`` /
  ``span_id`` / ``parent_id``), with point :meth:`~Tracer.event` marks
  attached to open spans. A request's whole life — router decision,
  queue wait, prefill, KV hand-off, decode, retries, failover
  re-routes, terminal — is ONE tree even when it crosses replicas.
* :class:`Tracer` — the per-process span store: bounded ring buffer of
  finished spans, Chrome-trace/Perfetto JSON export
  (:meth:`~Tracer.export_chrome_trace`), and a canonical trace hash
  (:meth:`~Tracer.canonical_hash`). Every timestamp comes from the
  injectable clock seam (:mod:`deepspeed_tpu_torch.resilience.clock`), so
  traces are **bit-deterministic under SimClock**: the same DST seed
  produces the same canonical hash (gated by ``scripts/trace_smoke.py``).
* :class:`FlightRecorder` — a bounded in-memory ring of recent
  spans/events that :meth:`~FlightRecorder.dump`\\ s on demand. The
  serving layer auto-dumps it on invariant-audit failure (DST),
  watchdog fire, tick-fault retry exhaustion and ``PreemptionGuard``
  latch, so the moments *before* a failure are on disk without anyone
  attaching a debugger. ``heartbeat.py`` exports its depth / dropped
  count / last-dump path for external watchers.

Tracing is **off by default**: :func:`get_tracer` returns a disabled
tracer whose entry points return a shared no-op span and touch neither
the clock nor any lock — the serving tick path and the fused
``train_steps`` scan pay one attribute check (the same zero-sync
contract as the step telemetry's).
The dslint ``trace-hygiene`` rule bans ``span()`` / ``event()`` /
flight-recorder ``note()`` calls inside jitted code: spans observe the
HOST side of the program, never live inside it.

Determinism contract (docs/observability.md): span/trace ids are drawn
from per-tracer counters (never wall entropy), timestamps from the
clock seam, and :meth:`~Tracer.canonical_hash` normalizes ids to
first-seen order and drops volatile attrs (``uid``,
``client_request_id``) — so two runs of the same seeded schedule on
fresh tracers hash identically even in one process.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

#: attr keys excluded from the canonical hash: process-lifetime counters
#: (request uids keep incrementing across runs) and filesystem paths
VOLATILE_ATTRS = frozenset({"uid", "client_request_id", "path",
                            "shadow_uid"})


def _clock_time() -> float:
    """Span timestamps ride the injectable clock seam (lazy import:
    telemetry loads before resilience in some import orders)."""
    from ..resilience.clock import get_clock

    return get_clock().time()


class Span:
    """One node of a trace tree. Mutated only through its Tracer."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "track",
                 "t_start", "t_end", "attrs", "events", "_annotation")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str], name: str,
                 track: Optional[str], t_start: Optional[float],
                 attrs: Optional[Dict[str, Any]] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.track = track
        self.t_start = t_start
        self.t_end: Optional[float] = None
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}
        self.events: List[Tuple[float, str, Dict[str, Any]]] = []
        # open torch.profiler.record_function range when the profiler
        # bridge wrapped this span (scoped spans only — ranges are
        # thread-bound)
        self._annotation = None

    @property
    def is_noop(self) -> bool:
        return self.span_id == ""

    @property
    def open(self) -> bool:
        return self.t_end is None and not self.is_noop

    def to_dict(self) -> Dict[str, Any]:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "name": self.name,
                "track": self.track, "t_start": self.t_start,
                "t_end": self.t_end, "attrs": dict(self.attrs),
                "events": [{"t": t, "name": n, "attrs": dict(a)}
                           for t, n, a in self.events]}


#: the shared do-nothing span every disabled-tracer entry point returns
_NOOP_SPAN = Span(trace_id="", span_id="", parent_id=None, name="",
                  track=None, t_start=None)


def _ring_append(ring: deque, capacity: int, item: Any) -> int:
    """Bounded-ring append (caller holds the owning lock). Returns the
    number of evicted records so every ring keeps the same
    drop-accounting invariant (`dropped += _ring_append(...)`)."""
    evicted = 1 if len(ring) == capacity else 0
    ring.append(item)
    return evicted


class FlightRecorder:
    """Bounded ring of recent span/event records (black box). Appends
    are lock-protected list ops; :meth:`dump` snapshots under the lock
    and does its file I/O OUTSIDE it (dslint lock-discipline)."""

    def __init__(self, capacity: int = 512,
                 dump_dir: Optional[str] = None):
        self.capacity = max(1, int(capacity))
        self.dump_dir = dump_dir
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.dropped = 0
        self.dumps = 0
        self.last_dump_path: Optional[str] = None
        self.last_dump_reason: Optional[str] = None
        self.last_dump: Optional[Dict[str, Any]] = None
        self._dump_seq = itertools.count()

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._ring)

    def note(self, kind: str, **fields: Any) -> None:
        """Append one event record to the ring (the flight-recorder
        entry point the dslint trace-hygiene rule bans inside jitted
        code — recorder appends are host-side observability)."""
        rec = {"kind": kind, "t": _clock_time(), **fields}
        with self._lock:
            self.dropped += _ring_append(self._ring, self.capacity, rec)

    def note_span(self, span: Span) -> None:
        rec = {"kind": "span", **span.to_dict()}
        with self._lock:
            self.dropped += _ring_append(self._ring, self.capacity, rec)

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def dump(self, reason: str, path: Optional[str] = None
             ) -> Optional[str]:
        """Write the ring to a JSON file (auto-named under ``dump_dir``
        when ``path`` is None). With neither configured, the payload is
        kept on ``self.last_dump`` instead — callers that only want the
        in-memory black box (the DST harness) never touch disk."""
        with self._lock:
            records = list(self._ring)
            n = next(self._dump_seq)
            dropped = self.dropped   # written under the lock by note()
        payload = {"version": 1, "reason": reason, "t": _clock_time(),
                   "depth": len(records), "dropped": dropped,
                   "records": records}
        if path is None and self.dump_dir is not None:
            import os

            os.makedirs(self.dump_dir, exist_ok=True)
            path = os.path.join(self.dump_dir,
                                f"flight_{n:03d}_{reason}.json")
        wrote = False
        if path is not None:
            try:
                # atomic temp+rename: dumps fire exactly at failure
                # moments (watchdog, latch, retry exhaustion) when the
                # process may die mid-write, and a torn JSON is useless
                # to a post-mortem
                from ..utils.fileio import write_json_atomic

                write_json_atomic(path, payload, indent=1)
                wrote = True
            except OSError as e:
                from ..utils.logging import logger

                logger.warning(
                    f"flight recorder dump to {path} failed: {e}")
        with self._lock:
            # all published last_dump* state flips under ONE lock
            # section: concurrent dumps (watchdog vs driver thread) must
            # never tear reason/payload/path apart for a reader
            self.dumps += 1
            self.last_dump_reason = reason
            self.last_dump = payload
            if wrote:
                self.last_dump_path = path
        return path if wrote else None


class _TlsStack(threading.local):
    def __init__(self):
        self.stack: List[Span] = []


class Tracer:
    """Span-tree tracer with bounded storage (see module docstring).

    Two span surfaces:

    * :meth:`span` — a context manager for HOST-scoped work (one
      thread, begin and end in one frame). Nested ``span()`` calls on
      the same thread parent automatically. When a ``torch.profiler``
      trace is active, the same name is emitted as a
      ``record_function`` range so tracer spans line up with the
      profiler's device timeline.
    * :meth:`begin_span` / :meth:`finish_span` — explicit segments for
      state machines whose phases start and end in different frames
      (or threads, or replicas): the serving request path. Explicit
      segments never touch the thread-local stack and are never
      bridged to the profiler (annotations are thread-bound).
    """

    def __init__(self, enabled: bool = False, ring_size: int = 4096,
                 flight_capacity: int = 512,
                 flight_dump_dir: Optional[str] = None,
                 xla_bridge: bool = True):
        self.enabled = bool(enabled)
        self.ring_size = max(1, int(ring_size))
        self.xla_bridge = bool(xla_bridge)
        self.flight = FlightRecorder(flight_capacity, flight_dump_dir)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.ring_size)
        self._open: Dict[str, Span] = {}
        self._trace_seq = itertools.count(1)
        self._span_seq = itertools.count(1)
        self._tls = _TlsStack()
        self.dropped = 0

    # -- span lifecycle --------------------------------------------------
    def new_trace(self, name: str, track: Optional[str] = None,
                  **attrs: Any) -> Span:
        """Open a new root span (a fresh trace_id)."""
        if not self.enabled:
            return _NOOP_SPAN
        with self._lock:
            tid = f"t{next(self._trace_seq)}"
            sid = f"s{next(self._span_seq)}"
            span = Span(tid, sid, None, name, track, _clock_time(), attrs)
            self._open[sid] = span
        return span

    def begin_span(self, name: str, parent: Optional[Span],
                   track: Optional[str] = None, **attrs: Any) -> Span:
        """Open a child span under ``parent`` (a root when parent is
        None/no-op — callers that lost their root still trace)."""
        if not self.enabled:
            return _NOOP_SPAN
        if parent is None or parent.is_noop:
            return self.new_trace(name, track=track, **attrs)
        with self._lock:
            sid = f"s{next(self._span_seq)}"
            span = Span(parent.trace_id, sid, parent.span_id, name,
                        track if track is not None else parent.track,
                        _clock_time(), attrs)
            self._open[sid] = span
        return span

    def finish_span(self, span: Optional[Span],
                    t_end: Optional[float] = None, **attrs: Any) -> None:
        """Close an open span: stamp its end, merge ``attrs``, move it
        into the ring and the flight recorder."""
        if span is None or span.is_noop or not self.enabled:
            return
        ann, span._annotation = span._annotation, None
        if ann is not None:
            ann.__exit__(None, None, None)
        with self._lock:
            if span.t_end is not None:      # double-finish: keep first
                return
            span.t_end = float(t_end) if t_end is not None \
                else _clock_time()
            if attrs:
                span.attrs.update(attrs)
            self._open.pop(span.span_id, None)
            self.dropped += _ring_append(self._ring, self.ring_size, span)
        self.flight.note_span(span)

    def span_complete(self, name: str, t_start: float, t_end: float,
                      parent: Optional[Span] = None,
                      track: Optional[str] = None, **attrs: Any) -> Span:
        """Record an already-timed span (measurement harnesses that
        compute their windows before reporting them)."""
        if not self.enabled:
            return _NOOP_SPAN
        with self._lock:
            if parent is not None and not parent.is_noop:
                tid, pid = parent.trace_id, parent.span_id
            else:
                tid, pid = f"t{next(self._trace_seq)}", None
            sid = f"s{next(self._span_seq)}"
            span = Span(tid, sid, pid, name, track, float(t_start), attrs)
            span.t_end = float(t_end)
            self.dropped += _ring_append(self._ring, self.ring_size, span)
        self.flight.note_span(span)
        return span

    def event(self, span: Optional[Span], name: str,
              **attrs: Any) -> None:
        """Point event attached to an open span (the request root,
        usually): retries, preemptions, failover re-routes, injected
        faults — the marks between phase boundaries."""
        if not self.enabled or span is None or span.is_noop:
            return
        with self._lock:
            if span.t_end is None:
                span.events.append((_clock_time(), name, dict(attrs)))

    @contextlib.contextmanager
    def span(self, name: str, parent: Optional[Span] = None,
             track: Optional[str] = None, **attrs: Any) -> Iterator[Span]:
        """Scoped span for same-thread work; nests via a thread-local
        stack and bridges to a ``torch.profiler`` range when a
        profiler trace is active."""
        if not self.enabled:
            yield _NOOP_SPAN
            return
        if parent is None and self._tls.stack:
            parent = self._tls.stack[-1]
        sp = (self.begin_span(name, parent, track=track, **attrs)
              if parent is not None
              else self.new_trace(name, track=track, **attrs))
        if self.xla_bridge:
            import torch

            if torch.autograd.profiler._is_profiler_enabled:
                sp._annotation = torch.profiler.record_function(name)
                sp._annotation.__enter__()
        self._tls.stack.append(sp)
        try:
            yield sp
        finally:
            self._tls.stack.pop()
            self.finish_span(sp)

    # -- introspection ---------------------------------------------------
    def spans(self) -> List[Span]:
        """Finished spans, oldest first (bounded by ``ring_size``)."""
        with self._lock:
            return list(self._ring)

    def open_spans(self) -> List[Span]:
        with self._lock:
            return list(self._open.values())

    def spans_for_trace(self, trace_id: str) -> List[Span]:
        with self._lock:
            out = [s for s in self._ring if s.trace_id == trace_id]
            out.extend(s for s in self._open.values()
                       if s.trace_id == trace_id)
        return out

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._open.clear()
            self.dropped = 0

    # -- canonical hash --------------------------------------------------
    def canonical_rows(self) -> List[tuple]:
        """Normalized, order-stable rows for hashing: ids mapped to
        first-seen ordinals, volatile attrs dropped (see module
        docstring's determinism contract)."""
        spans = sorted(self.spans(),
                       key=lambda s: (s.t_start, s.trace_id, s.span_id))
        tid_ord: Dict[str, int] = {}
        sid_ord: Dict[str, int] = {}
        for s in spans:
            tid_ord.setdefault(s.trace_id, len(tid_ord))
            sid_ord.setdefault(s.span_id, len(sid_ord))
        rows = []
        for s in spans:
            attrs = tuple(sorted((k, repr(v)) for k, v in s.attrs.items()
                                 if k not in VOLATILE_ATTRS))
            events = tuple(
                (round(t, 9), n,
                 tuple(sorted((k, repr(v)) for k, v in a.items()
                              if k not in VOLATILE_ATTRS)))
                for t, n, a in s.events)
            rows.append((tid_ord[s.trace_id], sid_ord[s.span_id],
                         sid_ord.get(s.parent_id, -1), s.name, s.track,
                         round(s.t_start, 9),
                         round(s.t_end, 9) if s.t_end is not None else None,
                         attrs, events))
        return rows

    def canonical_hash(self) -> str:
        """sha256 over the canonical rows — the determinism witness:
        same seeded schedule on a fresh tracer, same hash."""
        import hashlib

        payload = "\n".join(repr(r) for r in self.canonical_rows())
        return hashlib.sha256(payload.encode("utf-8")).hexdigest()

    # -- export ----------------------------------------------------------
    def export_chrome_trace(self, path: Optional[str] = None
                            ) -> Dict[str, Any]:
        """Chrome-trace/Perfetto JSON (``chrome://tracing`` / ui.perfetto
        .dev): one complete ("X") event per finished span on a per-track
        tid, instant ("i") events for span marks, thread-name metadata
        per track. Span identity rides in ``args`` so the tree survives
        the flat event list."""
        spans = self.spans()
        tracks: Dict[str, int] = {}

        def tid_of(track: Optional[str]) -> int:
            return tracks.setdefault(track or "main", len(tracks))

        events: List[Dict[str, Any]] = []
        for s in spans:
            tid = tid_of(s.track)
            args = {"trace_id": s.trace_id, "span_id": s.span_id}
            if s.parent_id:
                args["parent_id"] = s.parent_id
            args.update({k: v for k, v in s.attrs.items()})
            events.append({
                "ph": "X", "name": s.name, "cat": "span",
                "ts": s.t_start * 1e6,
                "dur": max(0.0, (s.t_end - s.t_start) * 1e6),
                "pid": 0, "tid": tid, "args": args,
            })
            for t, name, attrs in s.events:
                events.append({
                    "ph": "i", "name": name, "cat": "event",
                    "ts": t * 1e6, "s": "t", "pid": 0, "tid": tid,
                    "args": {"trace_id": s.trace_id,
                             "span_id": s.span_id, **attrs},
                })
        for track, tid in tracks.items():
            events.append({"ph": "M", "name": "thread_name", "pid": 0,
                           "tid": tid, "args": {"name": track}})
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w", encoding="utf-8") as fh:
                json.dump(doc, fh, indent=1, sort_keys=True)
                fh.write("\n")
        return doc


def validate_chrome_trace(doc: Any) -> List[str]:
    """Structural validation of an exported Chrome-trace document (the
    trace lane's schema check). Returns violation strings; empty means
    valid."""
    errors: List[str] = []
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        return ["document must be a dict with a traceEvents list"]
    for i, ev in enumerate(doc["traceEvents"]):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not a dict")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "i", "M"):
            errors.append(f"{where}: unknown ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            errors.append(f"{where}: missing name")
        for k in ("pid", "tid"):
            if not isinstance(ev.get(k), int):
                errors.append(f"{where}: missing integer {k}")
        if ph in ("X", "i"):
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or isinstance(ts, bool):
                errors.append(f"{where}: missing numeric ts")
        if ph == "X":
            dur = ev.get("dur")
            if (not isinstance(dur, (int, float))
                    or isinstance(dur, bool) or dur < 0):
                errors.append(f"{where}: X event needs dur >= 0")
            args = ev.get("args")
            if not isinstance(args, dict) or "span_id" not in args \
                    or "trace_id" not in args:
                errors.append(f"{where}: X event args need "
                              f"trace_id/span_id")
    return errors


def trace_tree_problems(spans: List[Span]) -> List[str]:
    """Connectivity audit over one trace's spans: exactly one root,
    every parent present (no orphans), every span closed. The DST
    auditor runs this per terminal request — a failover/disagg request
    must still be ONE connected tree."""
    problems: List[str] = []
    if not spans:
        return ["trace has no spans"]
    ids = {s.span_id for s in spans}
    roots = [s for s in spans if s.parent_id is None]
    if len(roots) != 1:
        problems.append(f"expected exactly one root span, found "
                        f"{len(roots)} ({[s.name for s in roots]})")
    for s in spans:
        if s.parent_id is not None and s.parent_id not in ids:
            problems.append(f"orphan span '{s.name}' ({s.span_id}): "
                            f"parent {s.parent_id} missing")
        if s.t_end is None:
            problems.append(f"span '{s.name}' ({s.span_id}) never "
                            f"finished")
    return problems


# ----------------------------------------------------------------------
# request-path helpers: the serving layer stores its trace state ON the
# request object (``_trace_root`` open root span, ``_trace_seg`` open
# lifecycle segment) so the tree follows the request across replicas.

def ensure_request_root(req: Any, **attrs: Any) -> None:
    """Open the request's root span if it has none (single-engine
    submissions; the fleet opens it earlier to capture routing)."""
    tr = get_tracer()
    if not tr.enabled or getattr(req, "_trace_root", None) is not None:
        return
    req._trace_root = tr.new_trace("request", **attrs)


def begin_request_segment(req: Any, name: str,
                          track: Optional[str] = None,
                          **attrs: Any) -> None:
    """Close the request's open lifecycle segment (if any) and begin
    the next one — queue → prefill → decode → handoff → ... — as a
    child of its root."""
    tr = get_tracer()
    root = getattr(req, "_trace_root", None)
    if not tr.enabled or root is None:
        return
    seg = getattr(req, "_trace_seg", None)
    if seg is not None:
        tr.finish_span(seg)
    req._trace_seg = tr.begin_span(name, root, track=track, **attrs)


def end_request_segment(req: Any, **attrs: Any) -> None:
    tr = get_tracer()
    seg = getattr(req, "_trace_seg", None)
    if seg is not None:
        tr.finish_span(seg, **attrs)
        req._trace_seg = None


def request_event(req: Any, name: str, **attrs: Any) -> None:
    """Point event on the request's root span (retry, preempt,
    failover, reroute, ...)."""
    tr = get_tracer()
    root = getattr(req, "_trace_root", None)
    if not tr.enabled or root is None:
        return
    tr.event(root, name, **attrs)


def finish_request_trace(req: Any, **attrs: Any) -> None:
    """Terminal closure: end the open segment and the root. Called from
    the one place every terminal request passes through
    (``serving.server.emit_request_span``) so exactly one closure per
    request."""
    tr = get_tracer()
    root = getattr(req, "_trace_root", None)
    if root is None or root.is_noop:
        return
    end_request_segment(req, outcome=attrs.get("state"))
    tr.finish_span(root, **attrs)


# ----------------------------------------------------------------------
_TRACER: Optional[Tracer] = None
_DISABLED: Optional[Tracer] = None


def get_tracer() -> Tracer:
    """The installed process-global tracer, or the shared disabled
    instance (every entry point a cheap no-op)."""
    global _DISABLED
    if _TRACER is not None:
        return _TRACER
    if _DISABLED is None:
        _DISABLED = Tracer(enabled=False)
    return _DISABLED


def set_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install ``tracer`` process-globally (None restores the disabled
    default). Returns the previously installed tracer."""
    global _TRACER
    prev = _TRACER
    _TRACER = tracer
    return prev


@contextlib.contextmanager
def use_tracer(tracer: Tracer) -> Iterator[Tracer]:
    """Scoped :func:`set_tracer` — the DST harness's entry seam."""
    prev = set_tracer(tracer)
    try:
        yield tracer
    finally:
        set_tracer(prev)


def configure_tracing(config: Any = None) -> Optional[Tracer]:
    """Build + install a Tracer from a TelemetryConfig's tracing knobs
    (``telemetry.tracing`` et al., config.py). Returns the installed
    tracer, or None (and clears any installed one) when tracing is
    disabled."""
    if not bool(getattr(config, "tracing", False)):
        set_tracer(None)
        return None
    tracer = Tracer(
        enabled=True,
        ring_size=int(getattr(config, "trace_ring", 4096)),
        flight_capacity=int(getattr(config, "flight_capacity", 512)),
        flight_dump_dir=getattr(config, "flight_dump_dir", None),
    )
    set_tracer(tracer)
    return tracer
