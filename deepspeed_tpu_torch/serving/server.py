"""The serving front-end: request lifecycle over the ragged engine.

Ports ``deepspeed_tpu/serving/server.py``'s ``ServingEngine``, the
replica a fleet drives:

* ``submit()`` with bounded-queue backpressure: a full queue rejects
  explicitly (state REJECTED) instead of buffering unboundedly;
* a background driver thread runs one engine tick at a time — the policy
  (:mod:`.scheduler`) picks the request set, the engine's Dynamic-SplitFuse
  packing fits it into one ragged step;
* ``stream()`` yields tokens as the driver emits them;
* ``cancel()`` at any lifecycle stage releases the engine state it holds
  (slot + KV pages) with zero leaked blocks;
* preempted requests resume bit-exactly: the driver re-prefills
  ``prompt + emitted`` and greedy decode continues the identical stream;
* a tick fault (device error, injected chaos) discards the touched
  engine state — never publishing suspect KV into the prefix cache — and
  re-queues each touched request until its retry budget is spent;
* ``drain()`` stops admission and serves out the backlog; a
  :class:`~deepspeed_tpu_torch.resilience.preemption.PreemptionGuard`
  latch drains the same way (finish live work, reject the queue);
* a watchdog thread flags stuck ticks (``serving/stuck_ticks``) when a
  device call wedges past ``stuck_tick_timeout_s``, and after
  ``stuck_tick_escalate_polls`` consecutive stuck polls marks the replica
  watchdog-unhealthy;
* the replica lifecycle a fleet drives: ``stop_admission`` /
  ``resume_admission``, ``hot_swap`` (a version bump with a warm-up
  countdown; a failed or injected-corrupt load keeps the old version),
  ``kill`` + ``migrate_out`` (decodes leave as KV exports for ``adopt``
  elsewhere) or ``evacuate`` (everything re-queues, engine state
  discarded), ``steal_queued``, the disaggregated hand-off callback and
  the global KV tier's replica side (prefix export / adoption pens,
  residency snapshots);
* with ``serving.speculative``, eligible decodes carry prompt-lookup draft
  chains that the engine verifies in the tick's one ragged step
  (``put_spec``); the streams stay token-identical to plain serving.

Serving decodes greedily (argmax on the engine's returned logits).

Telemetry: per-request span records (queue wait, TTFT, tokens/s — see
:class:`~deepspeed_tpu_torch.telemetry.spans.RequestStats`), queue-depth /
KV-occupancy gauges and admitted / rejected / preempted counters under
``serving[/<replica_id>]/...``, request trace segments, and the replica's
:class:`~deepspeed_tpu_torch.telemetry.digest.DigestSource`.

The driver thread launches the CUDA work: it selects the server's device
before its first tick, and every launch goes to PyTorch's current stream
of that thread.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..inference.ragged import PoolExhausted, block_balance_report
from ..resilience.clock import Clock, get_clock
from ..resilience.locksan import named_rlock
from ..telemetry.tracing import (begin_request_segment, end_request_segment,
                                 ensure_request_root, finish_request_trace,
                                 get_tracer, request_event)
from ..utils.device import resolve_device
from ..utils.logging import log_dist, logger
from .request import Request, RequestState
from .scheduler import CapacityView, SchedulerPolicy, make_policy


def emit_request_span(telemetry, req: Request, digest=None) -> None:
    """Emit one terminal request's span record — shared by the
    ServingEngine retire path and fleet-level rejections (a request shed
    before it ever reached a replica must still appear in
    requests.jsonl: one logical request, one record, no matter where it
    died). ``digest`` is the emitting tier's
    :class:`~deepspeed_tpu_torch.telemetry.digest.DigestSource`: the same
    terminal observations also feed the replica→region rollup plane."""
    from ..telemetry.spans import RequestStats

    # terminal trace closure lives HERE because every terminal request
    # passes through exactly once (replica retire backlog, fleet shed,
    # failover-cancel) — the root span ends with the request, whatever
    # killed it, and the span/ledger join keys ride the record below
    finish_request_trace(req, state=req.state.value,
                         new_tokens=len(req.tokens),
                         preemptions=req.preemptions, retries=req.retries,
                         error=req.error)
    root = getattr(req, "_trace_root", None)
    n = len(req.tokens)
    decode_s = (req.t_finish - req.t_first_token
                if req.t_finish is not None
                and req.t_first_token is not None else None)
    # SLO verdict: judge completions against their deadlines; a
    # rejected or failed request that CARRIED an SLO is a miss (the
    # terminal timestamp is not a serve time — judging it would read
    # near-100% attainment exactly when the system sheds load); a
    # user cancel is the caller's choice, not judged
    had_slo = (req.deadline_s is not None
               or req.ttft_deadline_s is not None)
    if req.state is RequestState.FINISHED:
        in_slo = req.in_slo()
    elif req.state is RequestState.CANCELLED and req.error is None:
        in_slo = None
    else:
        in_slo = False if had_slo else None
    if digest is not None:
        # rollup-plane copy of the hot-path observations: sketch
        # observes are O(1) and the digest publishes deltas upward on
        # the monitor cadence (telemetry/digest.py)
        digest.count("requests")
        digest.observe("queue_wait_s", req.queue_wait_s)
        digest.observe("ttft_s", req.ttft_s)
        if req.state is RequestState.FINISHED:
            digest.observe("request_latency_s", req.latency_s)
        if decode_s and n > 1:
            digest.observe("tokens_per_s", (n - 1) / decode_s)
        if n:
            digest.count("generated_tokens", n)
    # the rollup plane above feeds regardless of the registry sink: the
    # region's SLO tracker and digest rollups must see every terminal
    # request even when telemetry output is disabled
    if not telemetry.enabled:
        return
    telemetry.record_request_span(RequestStats(
        uid=req.uid, state=req.state.value,
        client_request_id=req.client_request_id, priority=req.priority,
        prompt_tokens=len(req.prompt), new_tokens=n,
        queue_wait_s=req.queue_wait_s, ttft_s=req.ttft_s,
        # latency only for served requests: near-zero reject/cancel
        # "latencies" would drag the histogram DOWN exactly when the
        # system sheds load (same shedding guard as in_slo below)
        latency_s=(req.latency_s
                   if req.state is RequestState.FINISHED else None),
        # n tokens span n-1 decode intervals (the first token ends
        # prefill): n/decode_s would inflate the rate, infinitely so
        # for single-token requests
        tokens_per_s=((n - 1) / decode_s if decode_s and n > 1 else None),
        preemptions=req.preemptions, retries=req.retries,
        spec_proposed=(req.spec_proposed if req.spec_proposed else None),
        spec_accepted=(req.spec_accepted if req.spec_proposed else None),
        model_version=req.model_version,
        tenant=req.tenant,
        in_slo=in_slo, error=req.error,
        trace_id=(root.trace_id if root is not None and not root.is_noop
                  else None),
        span_id=(root.span_id if root is not None and not root.is_noop
                 else None)))


def stream_tokens(server, prompt: Sequence[int], **kwargs):
    """Streaming generator over any submit/cancel surface — shared by
    :meth:`ServingEngine.stream` and ``ServingFleet.stream``. Yields
    tokens as the driver emits them; breaking out (or ``close()``-ing
    the generator) cancels the request."""
    if "on_token" in kwargs:
        raise ValueError("stream() owns the on_token callback")
    q: "queue_mod.Queue[int]" = queue_mod.Queue()
    req = server.submit(prompt, on_token=q.put, **kwargs)
    if req.state is RequestState.REJECTED:
        raise RuntimeError(f"request rejected: {req.error}")
    try:
        emitted = 0
        while True:
            try:
                yield q.get(timeout=0.05)
                emitted += 1
            except queue_mod.Empty:
                if req.is_terminal:
                    break
        while emitted < len(req.tokens):   # tokens raced the sentinel
            yield q.get_nowait()
            emitted += 1
        if req.state is RequestState.REJECTED:
            # shed after admission to the queue (deadline expiry,
            # drain, preemption latch) — must not read as a
            # successful empty/partial generation
            raise RuntimeError(f"request rejected: {req.error}")
        if req.state is RequestState.CANCELLED and req.error:
            raise RuntimeError(f"request failed: {req.error}")
    finally:
        if not req.is_terminal:
            server.cancel(req)


class ServingEngine:
    """SLO-aware continuous-batching front-end over a
    :class:`~deepspeed_tpu_torch.inference.ragged.RaggedInferenceEngine`.

    ``device`` defaults to ``"cuda"`` (raising without a CUDA device
    unless ``device="cpu"`` is asked for) and must be the engine's.
    ``start=False`` leaves the driver and watchdog threads off; :meth:`step`
    then runs one deterministic tick at a time."""

    def __init__(self, engine, config: Any = None,
                 policy: Optional[SchedulerPolicy] = None,
                 preemption_guard: Any = None,
                 start: bool = True,
                 replica_id: Optional[str] = None,
                 on_handoff=None,
                 on_retire=None,
                 clock: Optional[Clock] = None,
                 device=None):
        from ..config import ServingConfig

        if config is None:
            config = ServingConfig()
        elif isinstance(config, dict):
            config = ServingConfig.from_dict(config)
        self.config = config
        self.device = resolve_device(device)
        if engine.device != self.device:
            raise ValueError(f"ServingEngine on {self.device} over an engine "
                             f"on {engine.device}: pass the engine's device")
        self._engine = engine
        self.policy = policy if policy is not None else make_policy(
            config.policy, **(dict(kv_pressure=config.kv_pressure,
                                   reject_expired=config.reject_expired,
                                   preemption=config.preemption)
                              if config.policy == "slo" else {}))
        self._guard = preemption_guard
        # fleet wiring: a replica_id namespaces this engine's metrics
        # (serving/<replica_id>/...) so N replicas don't stomp one gauge;
        # on_handoff receives (request, KVExport) when a handoff-flagged
        # request finishes prefill; on_retire fires once per terminal
        # request (both called OUTSIDE the serving lock, driver thread)
        self.replica_id = replica_id
        self._metric_prefix = (f"serving/{replica_id}" if replica_id
                               else "serving")
        # replica-tier digest source (telemetry/digest.py): terminal
        # request observations + tick timings collected here, published
        # as deltas up the fleet→cell→region rollup on the monitor
        # cadence — region reads never scan replicas
        from ..telemetry.digest import DigestSource

        self.digest = DigestSource(replica_id or "serving")
        self._on_handoff = on_handoff
        self._on_retire = on_retire
        # every deadline, latency stamp and poll interval reads this
        # clock; a SimClock here makes the whole driver virtual-time
        # (docs/dst.md)
        self._clock = clock if clock is not None else get_clock()
        # speculative decoding (docs/serving.md "Speculative scheduling"):
        # drafting needs the engine's draft/verify surface; per-PRIORITY
        # acceptance EMAs drive the token credit that sizes chains.
        # Declared kv_quant must match the engine's own mode — a fleet
        # whose replicas disagree on pool storage would corrupt every
        # disaggregated hand-off at import time, so fail at construction.
        self._spec_on = bool(getattr(config, "speculative", False)) and \
            hasattr(engine, "put_spec") and hasattr(engine, "draft_tokens")
        self._spec_ema_by_class: Dict[int, float] = {}
        want_quant = str(getattr(config, "kv_quant", "none"))
        have_quant = str(getattr(engine.config, "kv_quant", "none"))
        if want_quant != "none" and want_quant != have_quant:
            raise ValueError(
                f"serving.kv_quant='{want_quant}' but the engine stores "
                f"KV as '{have_quant}' — configure both from one source")
        self._kv_quant = have_quant
        # model-version ledger (docs/serving.md "Rollout, canary, and
        # migration"): the version of the weights this engine serves.
        # Monotonic ints, bumped by hot_swap(); requests are stamped at
        # placement and continuations are version-affine — a stream
        # started on version N is never continued on N+1 (the DST
        # two-version-stream invariant).
        self.model_version = int(getattr(config, "model_version", 0) or 0)
        # AOT-warmup countdown after a hot swap: the new version is
        # compiled/warmed for this many ticks before the replica takes
        # traffic again (counts down in _tick even when idle)
        self._warmup_remaining = 0
        # built through the locksan seam: a plain RLock in production,
        # an order-recording wrapper under tests/DST (docs/dst.md)
        self._lock = named_rlock("ServingEngine._lock")
        self._queue: List[Request] = []
        self._live: Dict[int, Request] = {}
        self._requests: Dict[int, Request] = {}   # uid -> non-terminal req
        self._accepting = True
        self._span_backlog: List[Request] = []   # retired, span not yet emitted
        self._adoptions: List[tuple] = []        # (req, KVExport) to import
        self._handoff_backlog: List[tuple] = []  # (req, KVExport) to ship
        self._handoffs_in_flight = 0             # popped, export not done
        # global KV tier pens (docs/serving.md "Global KV tier"). Unlike
        # _adoptions these hold NO requests and no allocator refs —
        # adoption is best-effort prefetch, never owed work — so they are
        # excluded from pending_work/_idle_locked and dropping them at
        # kill/close is free. Processed on the driver thread only.
        self._prefix_export_requests: List[tuple] = []  # (tokens, on_ready)
        self._prefix_adoptions: List[Any] = []          # PrefixExport
        self._kv_tier = None                     # fleet's KVTier (or None)
        self._kv_member = ""                     # our name in the directory
        self._residency: Optional[tuple] = None  # (hashes, t_captured)
        self._last_residency_pub = float("-inf")
        self._cold_readmits_seen = 0
        self._last_gauges: Optional[tuple] = None
        self._stop_evt = threading.Event()
        self._tick_count = 0
        self._in_tick = False
        self._tick_started = 0.0
        self._stuck_reported = False
        # stuck-tick escalation (docs/fault_tolerance.md "Gray
        # failures"): consecutive wedged watchdog polls; past the
        # configured budget the replica marks ITSELF unhealthy and the
        # fleet monitor evacuates it instead of log-and-hope
        self._stuck_polls = 0
        self._watchdog_unhealthy = False
        # gray-failure evidence: busy engine ticks and the degraded
        # subset since the fleet monitor last drained them (the per-poll
        # distress-ratio sample feeding serving/health.py)
        self._busy_ticks = 0
        self._distress_ticks = 0
        self._driver: Optional[threading.Thread] = None
        self._watchdog: Optional[threading.Thread] = None
        if getattr(config, "speculative", False) and not self._spec_on:
            logger.warning(
                "ServingEngine: serving.speculative requested but the "
                "engine has no put_spec/draft_tokens surface — serving "
                "plain decode")
        log_dist(f"ServingEngine{f'[{replica_id}]' if replica_id else ''}: "
                 f"policy={self.policy.name} "
                 f"max_queue={config.max_queue} device={self.device} "
                 f"preemption={getattr(self.policy, 'preemption', False)}"
                 + (f" speculative=on(lookahead={config.spec_lookahead})"
                    if self._spec_on else "")
                 + (f" kv_quant={self._kv_quant}"
                    if self._kv_quant != "none" else ""))
        if start:
            self.start()

    # -- telemetry (resolved per call: pipeline may install later) -------
    @property
    def _telemetry(self):
        from ..telemetry import get_telemetry

        return get_telemetry()

    def _count(self, name: str, n: float = 1.0) -> None:
        self._telemetry.registry.counter(
            f"{self._metric_prefix}/{name}").inc(n)

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        if self._driver is not None:
            return
        self._driver = threading.Thread(target=self._drive, daemon=True,
                                        name="serving-driver")
        self._driver.start()
        if self.config.stuck_tick_timeout_s > 0:
            self._watchdog = threading.Thread(target=self._watch, daemon=True,
                                              name="serving-watchdog")
            self._watchdog.start()

    def submit(self, prompt: Sequence[int], *,
               max_new_tokens: Optional[int] = None,
               eos_token_id: Optional[int] = None,
               priority: int = 0,
               deadline_s: Optional[float] = None,
               ttft_deadline_s: Optional[float] = None,
               client_request_id: Optional[str] = None,
               on_token=None) -> Request:
        """Enqueue a request. Returns immediately; the request may come
        back already REJECTED (backpressure — full queue, serving closed,
        or a prompt the engine can never hold). Callers stream via
        ``on_token`` or block on ``request.result()``."""
        req = Request(prompt=list(prompt),
                      max_new_tokens=(max_new_tokens if max_new_tokens
                                      is not None
                                      else self.config.default_max_new_tokens),
                      eos_token_id=eos_token_id, priority=priority,
                      deadline_s=deadline_s, ttft_deadline_s=ttft_deadline_s,
                      client_request_id=client_request_id,
                      on_token=on_token)
        return self.submit_request(req)

    def submit_request(self, req: Request,
                       requeue: bool = False) -> Optional[Request]:
        """Enqueue an existing QUEUED :class:`Request` — the fleet-facing
        half of :meth:`submit`: the router builds (or re-routes) the
        request object and each replica only validates and queues it.
        ``t_submit`` is preserved when already set (a failed-over request
        keeps its ORIGINAL clock: its deadlines are promises to the
        caller, not to whichever replica ends up serving it).

        ``requeue`` marks the CONTINUATION of an already-admitted request
        (fail-over, hand-off fallback): like :meth:`adopt` it bypasses
        the admission gate and the ``max_queue`` bound — a draining
        replica must serve out admitted work, not shed it. Only a
        stopped driver refuses a requeue, and it does so NON-terminally
        (returns None with the request untouched) so the caller can
        place it on another replica."""
        if req.state is not RequestState.QUEUED:
            raise ValueError(
                f"submit_request needs a QUEUED request, got {req.state.name}")
        # the request's whole lifecycle is timed on ITS owner's clock: a
        # Request built under the global clock but submitted to an
        # engine with an injected one would otherwise mix timebases
        # (virtual t_submit vs wall t_finish corrupts every SLO verdict)
        req._clock = self._clock
        if req.t_submit is None:
            req.t_submit = self._clock.now()
        # tracing: single-engine submissions open the root here (the
        # fleet opens it earlier, around routing); every (re)queue is a
        # fresh "queue" segment on the owning replica's track
        ensure_request_root(req, prompt_tokens=len(req.prompt),
                            priority=req.priority)
        with self._lock:
            if requeue and self._stop_evt.is_set():
                return None
            if (requeue and req.tokens
                    and req.model_version is not None
                    and req.model_version != self.model_version):
                # version affinity: a continuation with tokens already
                # out must finish on the version that emitted them — a
                # mixed-version stream is exactly what the DST
                # two-version invariant forbids. NON-terminal refusal
                # (like the stopped-driver case): the caller re-places
                # it on a same-version replica or cancels it explicitly.
                return None
            if not requeue and not self._accepting:
                self._reject(req, "serving closed to new requests")
            elif (len(req.prompt) + req.max_new_tokens
                    > self._engine.config.max_context):
                # would deadlock FCFS at the head of the queue forever
                self._reject(req, "prompt + max_new_tokens exceeds "
                                  "engine max_context")
            elif (self._engine.blocks_needed(len(req.prompt)
                                             + req.max_new_tokens)
                    > self._engine.allocator.n_blocks):
                # same deadlock via the KV pool: a request that can never
                # hold all its pages at once can never finish — it would
                # head-of-line-block FCFS (and thrash mid-decode recovery
                # under any policy) forever
                self._reject(req, "prompt + max_new_tokens exceeds "
                                  "engine KV pool capacity")
            elif not requeue and len(self._queue) >= self.config.max_queue:
                # backpressure is for NEW work; a failed-over continuation
                # was already admitted once and queues past the bound
                # rather than being shed
                self._reject(req, "admission queue full")
            else:
                if not req.tokens:
                    # stamp (or re-stamp) the serving version: with no
                    # tokens out yet nothing binds the stream, so a
                    # failed-over prefill may legally restart on the new
                    # version — only emitted tokens create affinity
                    req.model_version = self.model_version
                self._requests[req.uid] = req
                self._enqueue_locked(req, requeue=bool(requeue))
        self._flush_spans()
        return req

    def _enqueue_locked(self, req: Request, *, requeue: bool = False,
                        **attrs) -> None:
        """Append to the admission queue (serving lock held) and open
        the request's "queue" trace segment — the append + segment pair
        lives HERE only, so every (re-)queue edge — fresh submit,
        preemption, tick-fault retry, adopt fallback, handoff-callback
        recovery — lands on the request's tree."""
        self._queue.append(req)
        begin_request_segment(req, "queue", track=self.replica_id,
                              requeue=requeue, **attrs)

    def adopt(self, req: Request, kv_export) -> bool:
        """Hand-off arrival (disaggregated decode replica): take over a
        request whose KV a prefill replica already computed. The import
        happens on the DRIVER thread at the next tick boundary — engine
        state is only ever touched from there — so this just queues the
        (request, export) pair. If the import cannot land (pool pressure,
        geometry), the request falls back to the normal resume path:
        re-queued here and re-prefilled from ``prompt + tokens``.

        Unlike :meth:`submit_request` this does NOT check ``_accepting``:
        a hand-off is the continuation of an already-admitted request,
        and a draining fleet must serve out exactly these (admission
        closed, backlog finishes). A stopped driver (killed / closed
        replica) REFUSES — returns False with the request untouched, so
        the fleet can place it elsewhere (nothing here would ever
        process the pen)."""
        with self._lock:
            if self._stop_evt.is_set():
                return False
            if (req.tokens and req.model_version is not None
                    and req.model_version != self.model_version):
                # version affinity (same contract as submit_request): a
                # hand-off with tokens out must land on ITS version
                return False
            if not req.tokens:
                req.model_version = self.model_version
            self._requests[req.uid] = req
            self._adoptions.append((req, kv_export))
        return True

    # -- global KV tier surface (docs/serving.md "Global KV tier") -------
    def enable_kv_tier(self, tier, member: str) -> None:
        """Attach this replica to the fleet's :class:`KVTier`: engine
        hooks (cold-tier spill + synchronous directory invalidation on
        eviction) plus the residency-publish cadence state. Called by
        the fleet at spawn, before traffic routes here; the directory
        invalidate closure takes only the directory's LEAF lock, so it
        is legal from the eviction path under the engine's own locks."""
        eng = self._engine
        if not hasattr(eng, "enable_kv_tier"):
            return
        with self._lock:
            self._kv_tier = tier
            self._kv_member = member
        eng.enable_kv_tier(
            member=member,
            cold_tier=tier.cold,
            on_invalidate=self._kvtier_invalidate)

    def _kvtier_invalidate(self, h: int) -> None:
        """Eviction hook: remove the hash from the directory AND from
        the pending residency snapshot. The second half closes a
        publish race — the fleet's poll republishes the snapshot
        captured at the last publish tick, and without the scrub an
        eviction landing between capture and publish would resurrect
        the entry after its pages were freed (the exact
        entry-outlives-pages shape invariant #17 hunts)."""
        with self._lock:
            tier, member = self._kv_tier, self._kv_member
            if self._residency is not None and h in self._residency[0]:
                hashes, t = self._residency
                self._residency = ([x for x in hashes if x != h], t)
        if tier is not None:
            tier.directory.invalidate(member, h)

    def request_prefix_export(self, tokens, on_ready) -> bool:
        """Donor-side adoption pen: the DRIVER pops this at its next
        tick and runs the engine's prefix gather OUTSIDE the serving
        lock, then calls ``on_ready(export_or_None)`` (also outside the
        lock, donor driver thread). Best-effort: a killed/closed driver
        refuses (False) and a dropped pen simply never fires on_ready —
        the importer side prefills locally, degraded but never lost."""
        with self._lock:
            if self._stop_evt.is_set() or self._kv_tier is None:
                return False
            self._prefix_export_requests.append((list(tokens), on_ready))
        return True

    def adopt_prefix(self, export) -> bool:
        """Importer-side adoption pen: the driver verifies the export's
        checksum and imports it into the prefix cache at its next tick
        (engine state is driver-thread-confined, same rule as
        :meth:`adopt`). Holds no request and no pool references."""
        with self._lock:
            if self._stop_evt.is_set() or self._kv_tier is None:
                return False
            self._prefix_adoptions.append(export)
        return True

    def residency_snapshot(self) -> Optional[tuple]:
        """(prefix hashes, t_captured) from the driver's last publish
        tick, or None before the first one. The fleet's poll stamps the
        directory with t_captured — NOT poll time — so a wedged driver's
        entries age past the staleness bound instead of being kept
        artificially fresh."""
        with self._lock:
            return self._residency

    def stop_admission(self) -> None:
        """Close the front door (submissions reject) without touching the
        backlog — the graceful scale-down shape: the fleet stops routing
        here, live work serves out, then ``close()`` is safe."""
        with self._lock:
            self._accepting = False

    def resume_admission(self) -> None:
        """Re-open the front door after a drain that did NOT end in
        close/kill — the rollout controller's flip-abort and rollback
        paths (docs/serving.md "Rollout, canary, and migration")."""
        with self._lock:
            if not self._stop_evt.is_set() and self._warmup_remaining == 0:
                self._accepting = True

    def hot_swap(self, version: int, load_fn=None,
                 warmup_ticks: Optional[int] = None) -> bool:
        """Swap the serving weights to ``version`` in place — the
        zero-downtime deploy primitive (docs/serving.md "Rollout,
        canary, and migration"). Contract: admission must already be
        stopped and the backlog drained (the rollout controller's
        drain-and-flip seam) — swapping under live work would serve one
        stream from two versions.

        ``load_fn`` performs the actual weight load (checkpoint-streamed
        on the real path, a no-op in the DST sim); a load failure —
        including an injected corrupt new-version checkpoint — FALLS
        BACK: the old weights are untouched, admission resumes on the
        old version, and False is returned so the controller can retry
        or roll back. A failed swap never strands the replica.

        On success the version is bumped and the replica stays
        non-accepting for ``warmup_ticks`` engine ticks — the AOT-warmup
        window where the new version compiles before taking traffic
        (the countdown runs even on idle ticks)."""
        with self._lock:
            if self._stop_evt.is_set():
                return False
            if self._accepting or not self._idle_locked():
                raise RuntimeError(
                    f"hot_swap needs a drained, admission-stopped engine "
                    f"(accepting={self._accepting}, "
                    f"pending={not self._idle_locked()})")
            old = self.model_version
        from ..resilience.chaos import get_fault_injector

        failure: Optional[str] = None
        inj = get_fault_injector()
        if inj is not None and inj.should_corrupt_swap():
            failure = "injected corrupt checkpoint"
        if failure is None and load_fn is not None:
            try:
                load_fn()
            except Exception as e:
                # swap fallback IS the handler: the old weights are
                # intact, so the loss-free response to ANY load failure
                # is resume-on-old-version; InjectedFault (BaseException)
                # still propagates
                failure = f"{type(e).__name__}: {e}"
        if failure is not None:
            self._count("swap_failed")
            logger.warning(
                f"ServingEngine"
                f"{f'[{self.replica_id}]' if self.replica_id else ''}: "
                f"hot swap to version {version} failed ({failure}); "
                f"serving stays on version {old}")
            with self._lock:
                if not self._stop_evt.is_set():
                    self._accepting = True
            return False
        if warmup_ticks is None:
            warmup_ticks = self.config.rollout.warmup_ticks
        with self._lock:
            self.model_version = int(version)
            self._warmup_remaining = max(0, int(warmup_ticks))
            if self._warmup_remaining == 0:
                self._accepting = True
        self._count("swaps")
        log_dist(f"ServingEngine"
                 f"{f'[{self.replica_id}]' if self.replica_id else ''}: "
                 f"hot-swapped {old} -> {version} "
                 f"(warmup {warmup_ticks} ticks)")
        return True

    def migrate_out(self) -> Tuple[List[Request], List[tuple]]:
        """Live-migration harvest — the first-class sibling of
        :meth:`evacuate` (docs/serving.md "Rollout, canary, and
        migration"). Call after ``kill()``: unlike the failure path, the
        engine state here is TRUSTED, so decodes with a complete KV
        footprint are exported over the quantized ``export_kv`` wire for
        adoption elsewhere instead of being recomputed.

        Returns ``(queued, exports)``: ``queued`` holds every request
        with nothing worth shipping (queue, pens, mid-prefill live work
        — these re-route and re-prefill normally), ``exports`` the
        ``(request, KVExport)`` pairs to :meth:`adopt` on the
        destination. Zero blocks stay behind either way."""
        with self._lock:
            queued: List[Request] = list(self._queue)
            exports: List[tuple] = []
            for uid, req in list(self._live.items()):
                seq = self._engine.seqs.get(uid)
                if (req.state is RequestState.DECODE and req.tokens
                        and seq is not None and seq.pending == 0):
                    # complete, trusted KV: ship it (the driver is
                    # joined, so the export copy under our lock cannot
                    # stall a tick — nothing else runs here)
                    export = self._engine.export_kv(uid)
                    self._engine.preempt(uid)
                    req.transition(RequestState.QUEUED)
                    req._pending_token = None
                    exports.append((req, export))
                else:
                    # mid-prefill (or no tokens out): nothing a KV
                    # import could resume — release and re-prefill
                    self._release_engine_state(uid, publish=True)
                    req.transition(RequestState.QUEUED)
                    req._pending_token = None
                    queued.append(req)
            for req, _ in self._adoptions:        # never imported
                queued.append(req)
            for req, export in self._handoff_backlog:  # already exported
                exports.append((req, export))
            for req in queued:
                request_event(req, "migrate", replica=self.replica_id)
                end_request_segment(req, outcome="migrated")
            for req, _ in exports:
                request_event(req, "migrate", replica=self.replica_id,
                              kv_shipped=True)
                end_request_segment(req, outcome="migrated")
            self._queue.clear()
            self._live.clear()
            self._adoptions.clear()
            self._handoff_backlog.clear()
            # kv-tier pens hold no requests/refs: drop, never migrate
            self._prefix_export_requests.clear()
            self._prefix_adoptions.clear()
            self._requests.clear()
            for req in queued:
                self._engine.clear_resume(req.uid)
            for req, _ in exports:
                self._engine.clear_resume(req.uid)
            self._accepting = False
        return queued, exports

    def kill(self) -> None:
        """Abrupt stop — the injected-replica-death shape. Joins the
        driver/watchdog threads (the in-flight tick completes; a real
        crash would tear mid-tick, which is exactly the suspect-KV case
        ``evacuate`` assumes) but does NOT drain, retire or release
        anything: the fleet harvests survivors via :meth:`evacuate`."""
        self._stop_evt.set()
        self._join_threads()

    def evacuate(self) -> List[Request]:
        """Post-``kill`` harvest: every non-terminal request, re-queued
        for another replica. Engine state of live requests is DISCARDED
        (suspect KV is never published into the prefix cache — the
        replica died, nothing it computed since its last publish can be
        trusted), so the allocator balances and the requests resume
        bit-exactly elsewhere from their token streams."""
        with self._lock:
            orphans: List[Request] = []
            for req in list(self._queue):
                orphans.append(req)
            for uid, req in list(self._live.items()):
                self._release_engine_state(uid, publish=False)
                req.transition(RequestState.QUEUED)
                req._pending_token = None
                orphans.append(req)
            for req, _ in self._adoptions:       # never imported: no state
                orphans.append(req)
            for req, _ in self._handoff_backlog:  # exported + released
                orphans.append(req)
            for req in orphans:
                request_event(req, "evacuate", replica=self.replica_id)
                end_request_segment(req, outcome="evacuated")
            self._queue.clear()
            self._live.clear()
            self._adoptions.clear()
            self._handoff_backlog.clear()
            self._prefix_export_requests.clear()
            self._prefix_adoptions.clear()
            self._requests.clear()
            for req in orphans:
                # these uids never come back to THIS engine
                self._engine.clear_resume(req.uid)
            self._accepting = False
        return orphans

    def stream(self, prompt: Sequence[int], **kwargs):
        """Generator yielding tokens as the driver emits them. Breaking
        out (or ``close()``-ing the generator) cancels the request."""
        return stream_tokens(self, prompt, **kwargs)

    def cancel(self, req) -> bool:
        """Cancel by Request or uid. QUEUED requests die immediately;
        live ones are released by the driver at the next tick boundary.
        Returns False for unknown/already-terminal requests."""
        with self._lock:
            if not isinstance(req, Request):
                req = self._requests.get(int(req))
            if req is None or req.is_terminal:
                return False
            req._cancel_requested = True
            # only requests actually sitting in OUR queue die here; ones
            # parked in the adoption/handoff pens (state QUEUED too) are
            # retired by the driver at their next boundary, where their
            # pen entry is dropped with them
            if req.state is RequestState.QUEUED and req in self._queue:
                self._queue.remove(req)
                self._retire(req, RequestState.CANCELLED)
        self._flush_spans()
        return True

    def drain(self, timeout: Optional[float] = None,
              reject_queued: bool = False) -> bool:
        """Stop accepting new requests and serve out the backlog. With
        ``reject_queued`` the queue is rejected instead of served (the
        preemption-latch shutdown shape). Returns True when every request
        reached a terminal state within ``timeout``."""
        with self._lock:
            self._accepting = False
            if reject_queued:
                for req in list(self._queue):
                    self._queue.remove(req)
                    self._reject(req, "rejected at drain")
        self._flush_spans()
        deadline = self._clock.deadline(
            timeout if timeout is not None else self.config.drain_timeout_s)
        while self._clock.now() < deadline:
            with self._lock:
                if self._idle_locked():
                    return True
            self._clock.sleep(self.config.poll_interval_s)
        with self._lock:
            return self._idle_locked()

    def _idle_locked(self) -> bool:
        """No request in any pre-terminal holding pen (lock held):
        queue, live set, deferred adoptions, un-shipped handoffs —
        including ones mid-export on the driver thread."""
        return (not self._queue and not self._live
                and not self._adoptions and not self._handoff_backlog
                and not self._handoffs_in_flight)

    def close(self, timeout: Optional[float] = None) -> None:
        """Graceful shutdown: drain, cancel whatever would not finish,
        stop the driver + watchdog threads."""
        drained = self.drain(timeout=timeout)
        if not drained:
            with self._lock:
                stuck = (list(self._queue) + list(self._live.values())
                         + [req for req, _ in self._adoptions])
            for req in stuck:
                self.cancel(req)
            t0 = self._clock.now()
            while self._clock.now() - t0 < 5.0:
                with self._lock:
                    if self._idle_locked():
                        break
                self._clock.sleep(self.config.poll_interval_s)
        self._stop_evt.set()
        self._join_threads()
        self._flush_handoffs()
        self._flush_spans()
        self._update_gauges()

    def _join_threads(self) -> None:
        """Join the driver and watchdog (a device call in flight on the
        driver completes first)."""
        for t in (self._driver, self._watchdog):
            if t is not None:
                t.join(timeout=30.0)
                if t.is_alive():
                    logger.error(f"ServingEngine: {t.name} thread did not "
                                 f"stop within 30 s")
        self._driver = self._watchdog = None

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- introspection ---------------------------------------------------
    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    @property
    def warmup_remaining(self) -> int:
        """Ticks left in the post-hot-swap AOT-warmup window (0 = warm)."""
        with self._lock:
            return self._warmup_remaining

    @property
    def live_requests(self) -> int:
        with self._lock:
            return len(self._live)

    @property
    def pending_work(self) -> int:
        """Every request this replica still owes an outcome: queued,
        live, AND the adoption/handoff pens — the count the fleet's load
        view and scale-down reaping must use (the pens are invisible to
        ``queue_depth``/``live_requests``, and closing a replica with a
        parked adoption would cancel admitted work)."""
        with self._lock:
            return (len(self._queue) + len(self._live)
                    + len(self._adoptions) + len(self._handoff_backlog)
                    + self._handoffs_in_flight)

    def snapshot(self) -> Tuple[int, int, int]:
        """(queue_depth, live, pending_work) under ONE lock acquisition —
        the cell-digest publisher reads every replica each poll, and
        three separate locked property reads per replica would triple
        the digest's lock traffic for values that must be mutually
        consistent anyway."""
        with self._lock:
            pens = (len(self._adoptions) + len(self._handoff_backlog)
                    + self._handoffs_in_flight)
            return (len(self._queue), len(self._live),
                    len(self._queue) + len(self._live) + pens)

    def gray_drain(self) -> Tuple[int, int]:
        """(busy_ticks, distress_ticks) since the previous drain, in one
        lock acquisition — the fleet monitor folds the ratio into this
        replica's :class:`~deepspeed_tpu_torch.serving.health.ReplicaHealth`
        score each poll. Draining (rather than cumulative counters)
        keeps every poll's sample independent, so one bad burst ages out
        of the EWMA instead of haunting the lifetime average."""
        with self._lock:
            out = (self._busy_ticks, self._distress_ticks)
            self._busy_ticks = 0
            self._distress_ticks = 0
            return out

    @property
    def watchdog_unhealthy(self) -> bool:
        """True once the stuck-tick watchdog escalated — the fleet
        monitor's health sweep evacuates this replica. Lock-free read of
        a watchdog-thread-owned bool (same sampling contract as
        ``_in_tick``): a stale read delays evacuation one poll."""
        return self._watchdog_unhealthy

    def _gray_note(self, distress: bool) -> None:
        """Book one busy engine tick (and whether it was degraded) for
        the fleet monitor's distress-ratio sample."""
        with self._lock:
            self._busy_ticks += 1
            if distress:
                self._distress_ticks += 1

    def steal_queued(self, max_n: int) -> List[Request]:
        """Remove up to ``max_n`` requests from the TAIL of the admission
        queue for placement elsewhere (the region's heal-time rebalance
        seam). Only QUEUED, cancel-free requests are taken — they hold
        no engine state, so moving them is pure bookkeeping; the head of
        the queue stays (it is closest to admission HERE, moving it
        would add latency, not shed it). The stolen requests stay QUEUED
        and MUST be re-routed by the caller: a steal without a matching
        re-route is a lost request, exactly what the DST conservation
        invariant exists to catch."""
        out: List[Request] = []
        with self._lock:
            for req in reversed(list(self._queue)):
                if len(out) >= max_n:
                    break
                if req._cancel_requested:
                    continue      # must die here, where cancel() saw it
                self._queue.remove(req)
                self._requests.pop(req.uid, None)
                end_request_segment(req, outcome="rebalanced")
                out.append(req)
            for req in out:
                # a previously preempted uid's resume marker must not
                # suppress telemetry when the uid re-prefills elsewhere
                self._engine.clear_resume(req.uid)
        return out

    def block_leaks(self) -> List[str]:
        """Allocator block-balance problems (empty = zero leak). Valid
        when idle (post-drain); mid-tick reads race the driver."""
        return block_balance_report(self._engine)["problems"]

    # -- driver ----------------------------------------------------------
    def step(self) -> bool:
        """One deterministic driver iteration — the manual-driving seam
        (``start=False``) the fleet's :meth:`~.fleet.ServingFleet.step`
        and the DST harness (docs/dst.md) use instead of the background
        thread. Returns False when idle."""
        return self._tick()

    def _drive(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        poll = self.config.poll_interval_s
        while not self._stop_evt.is_set():
            try:
                # start-time/flag writes must precede _in_tick: the
                # watchdog samples these fields without the lock, and the
                # reverse order lets it judge a fresh tick against the
                # previous tick's stale clock after an idle stretch
                self._tick_started = self._clock.now()
                self._stuck_reported = False
                self._in_tick = True
                did_work = self._tick()
            except Exception:
                # a driver-loop bug must not silently wedge every caller
                # (tick faults are handled inside _tick; InjectedFault, a
                # BaseException, still crashes through)
                logger.exception("ServingEngine: driver tick crashed")
                did_work = False
            finally:
                self._in_tick = False
            if not did_work:
                self._clock.wait_event(self._stop_evt, poll)

    def _watch(self) -> None:
        timeout = self.config.stuck_tick_timeout_s
        while not self._clock.wait_event(self._stop_evt,
                                         min(1.0, timeout / 4)):
            self._watchdog_check()

    def _watchdog_check(self) -> None:
        """One watchdog poll, factored out of the thread loop so the
        SimClock regression test can drive it deterministically. A tick
        wedged past the timeout logs once per tick (as before); after
        ``stuck_tick_escalate_polls`` CONSECUTIVE wedged polls the
        replica marks itself watchdog-unhealthy so the fleet monitor
        evacuates it — a permanently wedged device call is a gray
        failure no amount of logging fixes."""
        timeout = self.config.stuck_tick_timeout_s
        if not (self._in_tick
                and self._clock.now() - self._tick_started > timeout):
            # tick finished (or a fresh one started): the escalation
            # budget demands CONSECUTIVE wedged polls
            self._stuck_polls = 0
            return
        self._stuck_polls += 1
        if not self._stuck_reported:
            self._stuck_reported = True
            self._count("stuck_ticks")
            logger.warning(
                f"ServingEngine: tick {self._tick_count} stuck for "
                f"> {timeout:.0f}s (device call wedged?)")
            tracer = get_tracer()
            if tracer.enabled:
                # black box of the ticks leading into the wedge
                # (watchdog thread; no serving lock held here)
                tracer.flight.note("stuck_tick",
                                   replica=self.replica_id,
                                   tick=self._tick_count)
                tracer.flight.dump("watchdog-stuck-tick")
        escalate = self.config.stuck_tick_escalate_polls
        if (escalate > 0 and not self._watchdog_unhealthy
                and self._stuck_polls >= escalate):
            self._watchdog_unhealthy = True
            self._count("watchdog_escalations")
            logger.error(
                f"ServingEngine: tick {self._tick_count} still wedged "
                f"after {self._stuck_polls} watchdog polls — marking "
                f"replica unhealthy for fleet evacuation")

    def _check_latch(self) -> None:
        """Preemption-latch poll, at the top of every tick (driver thread
        OR manual stepping — it used to live in the thread loop only,
        which made the latch invisible to deterministically-driven
        tests/simulations)."""
        if self._guard is None or not self._guard.should_stop:
            return
        with self._lock:
            accepting = self._accepting
        if not accepting:
            return
        logger.warning("ServingEngine: preemption latched — draining "
                       "(finishing live requests, rejecting the queue)")
        tracer = get_tracer()
        if tracer.enabled:
            tracer.flight.note("preemption_latch", replica=self.replica_id)
        with self._lock:
            self._accepting = False
            for req in list(self._queue):
                self._queue.remove(req)
                self._reject(req, "preemption drain")
        self._flush_spans()
        if tracer.enabled:
            # auto-dump the black box at the latch (outside the lock:
            # the dump is file I/O when a dump dir is configured)
            tracer.flight.dump("preemption-latch")

    def _tick_warmup(self) -> None:
        """Post-hot-swap AOT-warmup countdown, at the top of every tick
        — INCLUDING idle ones (an idle replica must still finish warming
        up and re-open, so this cannot ride ``_tick_count``, which only
        advances on busy ticks). Admission re-opens when it reaches
        zero."""
        reopened = False
        with self._lock:
            if self._warmup_remaining > 0:
                self._warmup_remaining -= 1
                if (self._warmup_remaining == 0
                        and not self._stop_evt.is_set()):
                    self._accepting = True
                    reopened = True
        if reopened:
            self._count("warmup_done")

    def _maybe_degrade_tick(self) -> bool:
        """Injected canary SLO regression (chaos ``degrade_version``):
        stall this tick — no admission, no engine put, virtual time still
        advances — when the injector degrades THIS replica's model
        version. Only busy ticks stall: an idle degraded replica must
        still report idle, or the fleet would never quiesce."""
        with self._lock:
            busy = bool(self._queue or self._requests)
            version = self.model_version
        if not busy:
            return False
        from ..resilience.chaos import get_fault_injector

        inj = get_fault_injector()
        if inj is None:
            return False
        if not (inj.should_degrade_replica(self.replica_id)
                or inj.should_degrade_tick(version)):
            return False
        self._count("degraded_ticks")
        # a degraded busy tick is the canonical distress sample: the
        # fleet monitor's next gray_drain() sees busy=1, distress=1
        self._gray_note(distress=True)
        self._flush_spans()
        self._update_gauges()
        return True

    def _tick(self) -> bool:
        """One driver iteration; times the productive ticks into the
        hot-path tick sketch (zero-width under a SimClock — the sketch
        stays deterministic; on a wall clock it is the real tick time)."""
        t0 = self._clock.now()
        did = self._tick_inner()
        if did:
            dt = self._clock.now() - t0
            self.digest.observe("tick_s", dt)
            t = self._telemetry
            if t.enabled:
                t.registry.sketch(
                    f"{self._metric_prefix}/tick_s").observe(dt)
        return did

    def _tick_inner(self) -> bool:
        """One driver iteration: latch poll, adoptions, cancellations,
        admission (+ preemption), one engine ``put()`` — a verify step
        when speculative chains are drafted — and token dispatch.
        Returns False when idle."""
        self._check_latch()
        self._tick_warmup()
        if self._maybe_degrade_tick():
            return True
        self._import_adoptions()
        self._service_kv_tier()
        with self._lock:
            self._process_cancellations()
            capacity = self._admit()
            uids, toks, drafts = self._build_feed(capacity)
        if not uids:
            self._flush_spans()
            self._update_gauges()
            return False
        self._tick_count += 1
        self._count("ticks")
        # a productive tick is a clean distress sample; the fault path
        # below flips it to distressed inside _on_tick_fault
        self._gray_note(distress=False)
        try:
            from ..resilience.chaos import get_fault_injector

            inj = get_fault_injector()
            if inj is not None:
                inj.on_serving_tick(self._tick_count)
            uids, logits, verified = self._put_with_recovery(uids, toks,
                                                             drafts)
        except Exception as e:   # InjectedFault crashes (BaseException) pass
            self._on_tick_fault(uids, e)
            self._flush_spans()
            return True
        accepted = self._verify_drafts(verified)
        with self._lock:
            handoffs, emissions, finished = self._dispatch(uids, logits,
                                                           accepted)
        # user callbacks run OUTSIDE the serving lock (dslint
        # lock-discipline): caller code under our lock could re-enter
        # submit()/cancel() or stall every client of this replica.
        # Ordering contract for stream(): tokens are delivered BEFORE
        # the request turns terminal below, so the post-sentinel drain
        # in stream_tokens() still sees every token.
        for req, tok in emissions:
            try:
                req.on_token(tok)
            except Exception:
                logger.exception(
                    f"ServingEngine: on_token callback failed "
                    f"(request {req.uid}); cancelling its stream")
                req._cancel_requested = True
        with self._lock:
            self._finish(finished)
        self._export_handoffs(handoffs)
        self._flush_handoffs()
        self._flush_spans()
        self._update_gauges()
        return True

    # -- tick phases (driver thread; engine work OUTSIDE the lock) -------
    def _import_adoptions(self) -> None:
        """Import handed-off KV for adopted requests (driver thread only:
        the engine's pool is single-writer). The import itself — a full
        KV page copy — runs OUTSIDE the serving lock, which guards only
        the request structures; holding it across a multi-MB copy would
        stall every submit()/cancel() on this replica. An import that
        cannot land falls back to the normal resume path — the request
        re-queues HERE and re-prefills ``prompt + tokens`` — so a tight
        decode pool degrades to recompute, never to a lost request."""
        with self._lock:
            if not self._adoptions:
                return
            adoptions, self._adoptions = self._adoptions, []
        from ..resilience.chaos import get_fault_injector

        inj = get_fault_injector()
        deferred = []
        now = self._clock.now()
        for req, export in adoptions:
            if req._cancel_requested:
                with self._lock:
                    self._retire(req, RequestState.CANCELLED)
                continue
            if not req.tokens:
                # no emitted token to continue from — nothing a KV import
                # can resume; take the ordinary prefill path instead
                with self._lock:
                    self._enqueue_locked(req, requeue=True)
                continue
            if not self._engine._free_slots:
                # slot exhaustion is TRANSIENT (a live decode finishing
                # frees one, and adoptions run before admission each
                # tick): defer rather than burn the export on a
                # re-prefill that would queue behind the same slots
                deferred.append((req, export))
                continue
            try:
                if inj is not None:
                    # flaky-import chaos (docs/dst.md `flaky_import`):
                    # raises a RECOVERABLE fault every Nth import, which
                    # the fallback below absorbs into a re-prefill
                    inj.on_import_kv()
                self._engine.import_kv(req.uid, export)
            except Exception as e:
                logger.warning(
                    f"ServingEngine: KV import for request {req.uid} "
                    f"failed ({type(e).__name__}: {e}); falling back to "
                    f"re-prefill")
                self._count("adopt_fallbacks")
                request_event(req, "adopt_fallback",
                              replica=self.replica_id,
                              reason=type(e).__name__)
                with self._lock:
                    self._enqueue_locked(req, requeue=True)
                    # a failed import costs a re-prefill: distress
                    # evidence for the gray health score
                    self._distress_ticks += 1
                continue
            with self._lock:
                req.transition(RequestState.PREFILL)
                req.transition(RequestState.DECODE)
                req.t_admit = now
                if req.t_first_admit is None:
                    req.t_first_admit = now
                # the prefill replica emitted at least one token; feeding
                # the last one continues the greedy stream bit-exactly
                req._pending_token = req.tokens[-1]
                self._live[req.uid] = req
                begin_request_segment(req, "decode",
                                      track=self.replica_id,
                                      imported_pages=export.n_pages)
            self._count("adopted")
        if deferred:
            with self._lock:
                self._adoptions.extend(deferred)

    def _service_kv_tier(self) -> None:
        """Drain the global-KV-tier pens and refresh the residency
        snapshot (driver thread only — the engine's pool and prefix
        cache are single-writer). All engine work runs OUTSIDE the
        serving lock: a prefix gather/scatter is a multi-page copy and
        the lock guards only request structures. Failures here never
        touch a request — adoption is prefetch; the worst outcome is
        the local prefill that would have happened anyway."""
        with self._lock:
            tier = self._kv_tier
            if tier is None:
                return
            exports, self._prefix_export_requests = \
                self._prefix_export_requests, []
            adoptions, self._prefix_adoptions = self._prefix_adoptions, []
        from .kvtier import CorruptExport

        for tokens, on_ready in exports:
            export = None
            try:
                export = self._engine.export_prefix(tokens)
            except (ValueError, RuntimeError) as e:
                # donor isolation: a gather fault costs only this
                # prefetch, never the donor's tick
                logger.warning(
                    f"ServingEngine: prefix export failed "
                    f"({type(e).__name__}: {e}); adoption skipped")
            if export is not None:
                self._count("prefix_donated")
                self.digest.count("kvtier/donated")
            try:
                on_ready(export)
            except Exception:
                logger.exception(
                    "ServingEngine: prefix-export on_ready callback "
                    "failed")
        for export in adoptions:
            try:
                if self._engine.import_prefix(export):
                    self._count("prefix_adopted")
                    self.digest.count("kvtier/adopted")
            except CorruptExport:
                # the checksum gate fired: the wire lied. Counted apart
                # from plain fallbacks — corruption detected-and-refused
                # is the invariant (#19); landing silently would not be
                self._count("prefix_adopt_corrupt")
                self.digest.count("kvtier/adopt_corrupt")
            except (ValueError, RuntimeError) as e:
                # geometry mismatch / pool exhaustion: degrade to local
                # prefill (the request was never parked on this pen)
                self._count("prefix_adopt_fallbacks")
                self.digest.count("kvtier/adopt_fallback")
                logger.warning(
                    f"ServingEngine: prefix adoption failed "
                    f"({type(e).__name__}: {e}); serving by local "
                    f"prefill")
        self._snapshot_residency(tier)

    def _snapshot_residency(self, tier) -> None:
        """Refresh the residency snapshot on the publish cadence (driver
        thread). Reads the engine's prefix-cache keys without any
        serving lock — the cache is driver-owned — then swaps the
        published tuple under the lock for the fleet's poll to read.
        Cold-readmit deltas ride the same cadence into the routing
        counters (serving/route/cold_readmit, satellite of the
        residency/affinity outcome set)."""
        now = self._clock.now()
        with self._lock:
            if (now - self._last_residency_pub
                    < tier.config.publish_interval_s):
                return
            self._last_residency_pub = now
        eng = self._engine
        hashes = (eng.prefix_residency_hashes()
                  if hasattr(eng, "prefix_residency_hashes") else [])
        readmits = int(getattr(eng, "kvtier_cold_readmits", 0))
        with self._lock:
            delta = readmits - self._cold_readmits_seen
            self._cold_readmits_seen = readmits
            self._residency = (hashes, now)
        if delta > 0:
            t = self._telemetry
            if t.enabled:
                t.registry.counter("serving/route/cold_readmit").inc(delta)
            self.digest.count("route/cold_readmit", delta)

    def _export_handoffs(self, reqs: List[Request]) -> None:
        """Export + release engine state for requests leaving through the
        hand-off seam (driver thread, OUTSIDE the serving lock — same
        stall argument as the import side). The prompt pages are
        published into OUR prefix cache on the way out (repeat prefixes
        still hit this prefill replica). ``_handoffs_in_flight`` keeps
        drain honest across the window where the request is in no pen."""
        for req in reqs:
            export = self._engine.export_kv(req.uid)
            self._engine.preempt(req.uid)
            self._engine.clear_resume(req.uid)   # leaves this engine for good
            req.transition(RequestState.QUEUED)
            req._pending_token = None
            begin_request_segment(req, "handoff", track=self.replica_id,
                                  pages=export.n_pages)
            with self._lock:
                self._handoff_backlog.append((req, export))
                self._handoffs_in_flight -= 1
            self._count("handoffs_out")

    def _process_cancellations(self) -> None:
        for uid, req in list(self._live.items()):
            if req._cancel_requested:
                # a hedge loser's KV is suspect (the replica lost the race
                # for a reason): discard it unpublished instead of
                # offering it to the prefix cache
                self._release_engine_state(
                    uid, publish=not getattr(req, "_discard_kv", False))
                del self._live[uid]
                self._retire(req, RequestState.CANCELLED)

    def _admit(self) -> CapacityView:
        """Policy-ordered admission pass (lock held). Returns the tick's
        :class:`CapacityView` — ``_build_feed`` reuses it for the
        speculative token-credit arithmetic, so admission and drafting
        judge the same capacity."""
        now = self._clock.now()
        capacity = CapacityView(self._engine,
                                reserve_output=self.config.reserve_output_blocks,
                                live=list(self._live.values()))
        for req in self.policy.admission_order(list(self._queue), now):
            if req._cancel_requested:
                # requeued (fault retry / mid-tick eviction) with a
                # cancel pending: die here, not after another prefill
                self._queue.remove(req)
                self._retire(req, RequestState.CANCELLED)
                continue
            reason = self.policy.should_reject(req, now)
            if reason is not None:
                self._queue.remove(req)
                self._reject(req, reason)
                continue
            if not capacity.fits(req):
                victims = self.policy.preemption_victims(
                    req, list(self._live.values()), capacity, now)
                for victim in victims:
                    self._preempt(victim)
                    capacity.uncharge_live(victim)
                if not victims or not capacity.fits(req):
                    if self.policy.head_of_line_blocking:
                        break
                    continue
            self._queue.remove(req)
            req.transition(RequestState.PREFILL)
            req.t_admit = now
            if req.t_first_admit is None:
                req.t_first_admit = now
            req._pending_token = None
            self._live[req.uid] = req
            capacity.charge(req)
            begin_request_segment(req, "prefill", track=self.replica_id,
                                  policy=self.policy.name,
                                  resume_tokens=len(req.tokens))
            self._count("admitted")
        return capacity

    def _preempt(self, victim: Request) -> None:
        self._release_engine_state(victim.uid, publish=True)
        self._live.pop(victim.uid, None)
        victim.transition(RequestState.QUEUED)
        victim.preemptions += 1
        victim._pending_token = None
        request_event(victim, "preempt", replica=self.replica_id,
                      tokens_in=len(victim.tokens))
        self._enqueue_locked(victim, requeue=True)
        self._count("preempted")
        logger.info(f"ServingEngine: preempted request {victim.uid} "
                    f"(priority {victim.priority}, "
                    f"{len(victim.tokens)} tokens in)")

    def _build_feed(self, capacity: Optional[CapacityView] = None
                    ) -> Tuple[List[int], List[List[int]], List[List[int]]]:
        """Assemble this tick's ``put()`` arguments: full resume context
        for freshly admitted requests, empty continuation chunks for
        mid-prefill ones, one pending decode token each for the rest.

        With speculative serving on, eligible decodes additionally get a
        draft chain — sized by the class acceptance credit
        (``CapacityView.chain_len_for``) and spent strictly out of the
        tick's token-budget SLACK (``CapacityView.draft_budget``): the
        prefill backlog's claim comes off the top, so drafting can slow
        only itself, never prompt progress or another decode's feed."""
        uids: List[int] = []
        toks: List[List[int]] = []
        drafts: List[List[int]] = []
        decode_rows: List[Tuple[int, Request]] = []
        prefill_tokens = 0
        for uid, req in self._live.items():
            seq = self._engine.seqs.get(uid)
            if seq is None:
                uids.append(uid)
                toks.append(req.prompt + req.tokens)
                drafts.append([])
                prefill_tokens += len(req.prompt) + len(req.tokens)
            elif seq.pending > 0:
                uids.append(uid)
                toks.append([])
                drafts.append([])
                prefill_tokens += seq.pending
            elif req._pending_token is not None:
                uids.append(uid)
                toks.append([req._pending_token])
                drafts.append([])
                decode_rows.append((len(uids) - 1, req))
        if self._spec_on and capacity is not None and decode_rows:
            slack = capacity.draft_budget(len(decode_rows), prefill_tokens)
            cfg = self.config
            for i, req in decode_rows:
                if slack <= 0:
                    break
                if req._spec_disabled:
                    continue
                ema = self._spec_ema_by_class.get(req.priority, 1.0)
                k = CapacityView.chain_len_for(ema, cfg.spec_lookahead)
                seq = self._engine.seqs[req.uid]
                k = min(k, slack,
                        self._engine.config.max_context - seq.seen - 1,
                        req.max_new_tokens - len(req.tokens) - 1)
                if k <= 0:
                    continue
                guesses = self._engine.draft_tokens(
                    req.uid, req._pending_token, cfg.spec_ngram, k)
                if guesses:
                    drafts[i] = guesses
                    slack -= len(guesses)
        return uids, toks, drafts

    # -- tick phases (lock NOT held) ------------------------------------
    def _put_with_recovery(self, uids, toks, drafts=None):
        """One engine tick; on KV-pool exhaustion, preempt the cheapest
        decode and retry. Tokens are admitted to the engine's descriptors
        before its pool check, so retries feed empty chunks — and an
        evicted victim must leave the feed entirely, or put() would mint
        a fresh empty descriptor for it and leak its slot.

        With draft chains the first attempt runs the verify step
        (``put_spec``); a PoolExhausted there strips every draft token
        before raising, so the retry degrades to a PLAIN put of the
        already-admitted feed — speculation is never worth an eviction."""
        uids, toks = list(uids), list(toks)
        use_spec = drafts is not None and any(drafts)
        drafts = list(drafts) if use_spec else None
        attempts = 0
        while True:
            try:
                if use_spec:
                    out, verified = self._engine.put_spec(uids, toks, drafts)
                    return uids, out, verified
                return uids, self._engine.put(uids, toks), {}
            except PoolExhausted:
                # the typed catch matters: a generic device RuntimeError
                # (a CUDA out-of-memory) must take the tick-fault path
                # once, not preempt healthy decodes and re-run the failing
                # step live-count times
                use_spec = False       # drafts were stripped on the raise
                with self._lock:
                    # the attempt bound reads _live under the lock: an
                    # unlocked len() races concurrent submit / cancel
                    if attempts >= len(self._live):
                        raise
                    attempts += 1
                    victim = self._pool_pressure_victim(set(uids))
                    if victim is None:
                        raise
                    self._preempt(victim)
                    if victim.uid in uids:
                        i = uids.index(victim.uid)
                        uids.pop(i)
                        toks.pop(i)
                    if not uids:
                        raise
                toks = [[] for _ in uids]   # already admitted: continue only

    def _pool_pressure_victim(self, feed_uids) -> Optional[Request]:
        """Mid-tick eviction pick when the pool runs dry despite admission
        control: the lowest-priority, latest-deadline decode — preferring
        one outside this tick's feed (cheaper: nothing to rebuild)."""
        pool = [r for r in self._live.values()
                if r.state is RequestState.DECODE]
        if not pool:
            return None
        dl = getattr(self.policy, "_deadline_key", lambda r: float("inf"))
        pool.sort(key=lambda r: (r.priority, -dl(r)))
        for r in pool:
            if r.uid not in feed_uids:
                return r
        return pool[0]

    def _on_tick_fault(self, uids, exc: Exception) -> None:
        """A tick died (device error / injected chaos). Engine state for
        every touched uid is suspect — ``seen`` may have advanced without
        its KV being written — so it is DISCARDED (never published into
        the prefix cache) and each request retries from its token stream,
        or fails once its budget is spent. No block leaks either way."""
        self._count("tick_faults")
        logger.warning(f"ServingEngine: tick {self._tick_count} fault: "
                       f"{type(exc).__name__}: {exc}")
        budget_spent = False
        with self._lock:
            # the busy tick was booked clean in _tick_inner; a faulted
            # tick is distress evidence for the gray health score
            self._distress_ticks += 1
            for uid in uids:
                self._release_engine_state(uid, publish=False)
                req = self._live.pop(uid, None)
                if req is None:
                    continue
                req._pending_token = None
                request_event(req, "tick_fault", replica=self.replica_id,
                              error=type(exc).__name__, retry=req.retries)
                if req._cancel_requested:
                    # no point retrying a request the caller already
                    # abandoned (cancel landed while put() was in flight)
                    self._retire(req, RequestState.CANCELLED)
                    continue
                req.retries += 1
                if req.retries <= self.config.tick_retry_limit:
                    req.transition(RequestState.QUEUED)
                    self._enqueue_locked(req, requeue=True,
                                         retry=req.retries)
                else:
                    req.error = (f"tick fault after {req.retries - 1} "
                                 f"retries: {exc}")
                    budget_spent = True
                    self._retire(req, RequestState.CANCELLED)
        if budget_spent:
            tracer = get_tracer()
            if tracer.enabled:
                # retry budget exhausted: dump the black box (outside
                # the serving lock — the dump may write a file)
                tracer.flight.note("tick_fault_retry_exhausted",
                                   replica=self.replica_id,
                                   tick=self._tick_count)
                tracer.flight.dump("tick-fault-exhausted")

    def _verify_drafts(self, verified) -> Dict[int, List[int]]:
        """Greedy accept/trim pass over the tick's verified draft chains
        (driver thread, OUTSIDE the serving lock — the rejected-tail
        trim may touch the device for a copy-on-write page). For each
        chain the longest argmax-matching prefix is accepted — row 0 is
        exactly the plain tick's logits, so the emitted stream is
        TOKEN-IDENTICAL to non-speculative serving by induction — then
        the engine rewinds to the validated context. Returns uid -> the
        emitted tokens ``_dispatch`` applies under the lock; acceptance
        feeds the per-request rolling EMA (fallback floor) and the
        per-class credit EMA (chain sizing).

        A trim that FAILS (its copy-on-write boundary page can allocate,
        so PoolExhausted is reachable here) is contained per uid: that
        request takes the tick-fault path — engine state discarded, this
        round's accepted tokens withheld (they re-generate bit-equal on
        the resume re-prefill), requeue under the retry budget — and
        every other uid's acceptance proceeds. Letting it escape would
        skip ``_on_tick_fault`` entirely and leave already-trimmed and
        not-yet-trimmed streams silently diverged from their requests."""
        if not verified:
            return {}
        with self._lock:
            reqs = {uid: self._live.get(uid) for uid in verified}
        eng = self._engine
        cfg = self.config
        accepted: Dict[int, List[int]] = {}
        failed: Dict[int, Exception] = {}
        tick_prop = tick_acc = 0
        for uid, (chain, rows) in verified.items():
            req = reqs.get(uid)
            seq = eng.seqs.get(uid)
            a = np.argmax(np.asarray(rows), axis=-1)
            matched = 0
            while (matched < len(chain) - 1
                   and int(a[matched]) == chain[matched + 1]):
                matched += 1
            proposed = len(chain) - 1
            tick_prop += proposed
            tick_acc += matched
            if req is None or seq is None:      # evicted mid-tick
                continue
            emitted = [int(x) for x in a[:matched + 1]]
            emitted = emitted[:max(0, req.max_new_tokens - len(req.tokens))]
            if req.eos_token_id is not None and req.eos_token_id in emitted:
                emitted = emitted[:emitted.index(req.eos_token_id) + 1]
            # rewind to the validated context: fed = chain, validated =
            # the pending token + accepted (and emitted) proposals
            keep = seq.seen - len(chain) + len(emitted)
            try:
                if keep < seq.seen:
                    eng.trim(uid, keep)
            except Exception as e:
                failed[uid] = e
                continue
            accepted[uid] = emitted
            if proposed:
                req.spec_proposed += proposed
                req.spec_accepted += matched
                rate = matched / proposed
                alpha = cfg.spec_ema
                req._spec_ema = (1 - alpha) * req._spec_ema + alpha * rate
                with self._lock:
                    # the class credit is read by _build_feed under the
                    # serving lock
                    cur = self._spec_ema_by_class.get(req.priority, 1.0)
                    self._spec_ema_by_class[req.priority] = \
                        (1 - alpha) * cur + alpha * rate
                request_event(req, "spec_verify", replica=self.replica_id,
                              proposed=proposed, accepted=matched)
                if (not req._spec_disabled
                        and req.spec_proposed
                        >= cfg.spec_floor_min_proposed
                        and req._spec_ema < cfg.spec_accept_floor):
                    # rolling acceptance under the floor: this request's
                    # context is unpredictable — stop paying for drafts
                    # (plain decode; the stream is identical either way)
                    req._spec_disabled = True
                    self._count("spec_fallbacks")
                    request_event(req, "spec_fallback",
                                  replica=self.replica_id,
                                  ema=round(req._spec_ema, 4))
        if tick_prop:
            self._count("spec_proposed", tick_prop)
            self._count("spec_accepted", tick_acc)
            if hasattr(eng, "record_spec"):
                eng.record_spec(proposed=tick_prop, accepted=tick_acc,
                                rounds=1)
        if failed:
            # per-uid tick-fault recovery: discard the suspect engine
            # state (the chain residue is still on the stream), requeue
            # under the retry budget — resumed bit-exactly from the
            # tokens delivered BEFORE this tick
            self._on_tick_fault(list(failed),
                                next(iter(failed.values())))
        return accepted

    def _dispatch(self, uids, logits: np.ndarray,
                  accepted: Optional[Dict[int, List[int]]] = None
                  ) -> Tuple[List[Request], List[Tuple[Request, int]],
                             List[int]]:
        """Turn the tick's logits into emitted tokens, completions and
        telemetry. Returns (handoff requests, (request, token) pairs for
        ``on_token`` delivery, finished uids) — the KV exports, the user
        callbacks and the FINISHED retirements all happen back in
        ``_tick`` AFTER this lock-held pass: callbacks must not run
        under the serving lock, and retirement must come after delivery
        so ``stream()`` never sees a terminal request with undelivered
        tokens."""
        now = self._clock.now()
        finished: List[int] = []
        handoffs: List[Request] = []
        emissions: List[Tuple[Request, int]] = []
        for row, uid in zip(logits, uids):
            req = self._live.get(uid)
            if req is None or np.isnan(row[0]):
                continue                      # evicted mid-tick / prefilling
            if accepted and uid in accepted:
                # speculative chain: apply the whole accepted run (tokens
                # delivered in order, before any terminal transition —
                # the stream() drain contract holds per token)
                emitted = accepted[uid]
                self._note_served_version(req)
                for tok in emitted:
                    req.tokens.append(tok)
                    if req.on_token is not None:
                        emissions.append((req, tok))
                req._pending_token = emitted[-1]
                if (len(req.tokens) >= req.max_new_tokens
                        or (req.eos_token_id is not None
                            and emitted[-1] == req.eos_token_id)):
                    finished.append(uid)
                continue
            tok = int(np.argmax(row))
            if req.state is RequestState.PREFILL:
                req.transition(RequestState.DECODE)
                if req.t_first_token is None:
                    req.t_first_token = now
                begin_request_segment(req, "decode",
                                      track=self.replica_id)
            self._note_served_version(req)
            req.tokens.append(tok)
            req._pending_token = tok
            if req.on_token is not None:
                emissions.append((req, tok))
            if (len(req.tokens) >= req.max_new_tokens
                    or (req.eos_token_id is not None
                        and tok == req.eos_token_id)):
                finished.append(uid)
            elif (req._handoff_requested and self._on_handoff is not None
                    and self._engine.seqs.get(uid) is not None
                    and self._engine.seqs[uid].pending == 0):
                # disaggregated hand-off: prefill is done and the first
                # token(s) resolved — hand the request to
                # ``_export_handoffs`` (KV export + release outside the
                # lock), which ships it to a decode replica via the
                # fleet callback
                self._live.pop(uid)
                self._requests.pop(uid, None)
                self._handoffs_in_flight += 1
                handoffs.append(req)
        return handoffs, emissions, finished

    def _finish(self, finished: List[int]) -> None:
        """Retire this tick's completed requests (lock held; runs after
        token delivery). Only the driver thread pops ``_live``, so the
        uids are still present — the guard covers nothing but a
        mid-close evacuate()."""
        for uid in finished:
            req = self._live.pop(uid, None)
            if req is None:
                continue
            self._engine.flush([uid])         # publishes into prefix cache
            self._retire(req, RequestState.FINISHED)

    # -- shared helpers --------------------------------------------------
    def _note_served_version(self, req: Request) -> None:
        """Record that THIS engine's version is emitting tokens for
        ``req`` (lock held, just before the append). Consecutive
        duplicates collapse, so the list stays the ordered set of
        distinct serving versions — the DST two-version-stream auditor
        reads it directly."""
        v = self.model_version
        if not req.served_versions or req.served_versions[-1] != v:
            req.served_versions.append(v)

    def _release_engine_state(self, uid: int, publish: bool) -> None:
        """Release whatever the engine holds for ``uid``. ``publish``
        offers full KV blocks to the prefix cache (cancel / preempt);
        tick faults must not (the KV may be torn)."""
        if uid not in self._engine.seqs:
            return
        if publish:
            self._engine.preempt(uid)
        else:
            self._engine.discard(uid)

    def _reject(self, req: Request, reason: str) -> None:
        req.error = reason
        self._retire(req, RequestState.REJECTED)

    def _retire(self, req: Request, state: RequestState) -> None:
        req.transition(state)
        self._requests.pop(req.uid, None)
        # a preempted/faulted request that dies without re-admission must
        # not leave a stale resume marker behind (uid-reuse telemetry)
        self._engine.clear_resume(req.uid)
        self._count({RequestState.FINISHED: "completed",
                     RequestState.CANCELLED: "cancelled",
                     RequestState.REJECTED: "rejected"}[state])
        # span emission does disk I/O (JSONL write + flush): defer it out
        # of the serving lock — every _retire caller holds it, and a slow
        # sink must not stall submit()/cancel()/the next tick
        self._span_backlog.append(req)

    def _flush_handoffs(self) -> None:
        """Deliver exported requests to the fleet OUTSIDE the serving
        lock: the callback routes to (and locks) another replica, and
        holding our lock across that is a lock-order inversion waiting
        to happen."""
        if not self._handoff_backlog:
            return
        with self._lock:
            backlog, self._handoff_backlog = self._handoff_backlog, []
        for req, export in backlog:
            try:
                self._on_handoff(req, export)
            except Exception:
                # the request's engine state is already released; the one
                # recovery that loses nothing is re-queueing it here
                logger.exception(
                    f"ServingEngine: handoff callback failed for request "
                    f"{req.uid}; re-queueing locally")
                with self._lock:
                    self._requests[req.uid] = req
                    self._enqueue_locked(req, requeue=True)

    def _flush_spans(self) -> None:
        """Emit deferred request spans OUTSIDE the serving lock (the
        request objects are terminal and immutable by now)."""
        if not self._span_backlog:   # unlocked peek: the idle driver loop
            return                   # must not take the lock every poll
        with self._lock:
            backlog, self._span_backlog = self._span_backlog, []
        for req in backlog:
            self._emit_span(req)
            if self._on_retire is not None:
                try:
                    self._on_retire(req)
                except Exception:
                    logger.exception(
                        f"ServingEngine: on_retire callback failed "
                        f"(request {req.uid})")

    def _emit_span(self, req: Request) -> None:
        gate = getattr(req, "_hedge", None)
        if gate is not None:
            # a terminal leg decides a still-undecided hedge race (the
            # primary wins by default: its outcome is what the client
            # sees; a shadow that dies first just failed to help)
            gate.settle(req.uid)
            if gate.is_suppressed(req.uid):
                # decided loser: the ledger judges the client request
                # once, on the winning leg — no span, no SLO verdict. The
                # trace tree still closes (an open root would read as a
                # leaked request)
                finish_request_trace(req, state=req.state.value,
                                     new_tokens=len(req.tokens),
                                     error=req.error,
                                     hedge_suppressed=True)
                self._count("hedge_suppressed_spans")
                return
        emit_request_span(self._telemetry, req, digest=self.digest)

    def _update_gauges(self) -> None:
        t = self._telemetry
        if not t.enabled:
            return
        with self._lock:
            depth, live = len(self._queue), len(self._live)
            # the last-published compare-and-set runs under the lock:
            # driver ticks and a main-thread close() both publish.
            # kv_occupancy is host-side allocator arithmetic — the same
            # class of locked engine read as _admit's CapacityView.
            snap = (depth, live, self._engine.kv_occupancy())
            if snap == self._last_gauges:   # idle loop: don't re-publish
                return                      # unchanged values every poll
            self._last_gauges = snap
            spec_credit = (min(self._spec_ema_by_class.values())
                           if self._spec_on and self._spec_ema_by_class
                           else None)
        r = t.registry
        r.gauge(f"{self._metric_prefix}/queue_depth").set(depth)
        r.gauge(f"{self._metric_prefix}/live_requests").set(live)
        r.gauge(f"{self._metric_prefix}/kv_occupancy").set(snap[2])
        if spec_credit is not None:
            # the serving-level acceptance credit (worst class is the
            # honest headline — one cold class means drafts are being
            # throttled somewhere)
            r.gauge(f"{self._metric_prefix}/spec_credit").set(spec_credit)
        if self._kv_quant != "none":
            # pool headroom under quantized storage: the capacity win
            # shows up as this gauge staying high at fixed byte budget
            r.gauge(f"{self._metric_prefix}/kv_quant_headroom").set(
                1.0 - snap[2])
