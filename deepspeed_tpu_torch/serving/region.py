"""The region front-end: a fleet of fleets behind two-tier routing.

Ports ``deepspeed_tpu/serving/region.py`` (host Python; the port keeps its
own copy). Every cell's fleet runs its replicas on the region's device
(the card unless ``device="cpu"`` is asked for).

``Region`` scales the serving plane one failure domain up: N
:class:`~.cell.ServingCell` cells (each one :class:`~.fleet.ServingFleet`
— the unit a rack/pod outage kills at once) behind a single
submit/stream/cancel/drain/close surface. The design goals, in order:

* **O(1)-in-replicas routing** — a request costs one brownout check,
  one cell-ring walk over PUBLISHED :class:`~.cell.CellDigest` reads
  (never a replica scan), then the chosen cell's own router (its ring
  walk over a bounded replica set). Per-route work is independent of
  the total replica count, pinned by a test — the property that lets
  one process simulate thousands of replicas.
* **Provable chaos tolerance** — the failure modes that dominate at
  region scale are first-class, typed, and auditable by the
  deterministic simulator (``resilience/dst.py``): a whole-cell outage
  harvests every admitted request and re-places it on reachable cells
  through the bit-exact re-prefill resume path (the replica's
  evacuation discipline lifted one tier — the dead cell's KV is suspect
  in toto); an inter-cell partition makes
  cross-cell hand-off/KV adoption fail with the typed
  :class:`~.cell.CellUnreachable` and degrade to re-prefill on a
  reachable cell (degraded, never lost); a partitioned-but-alive cell
  keeps serving its admitted work locally and is NOT failed over — the
  region has no cross-partition fencing, so re-routing a live cell's
  requests would mint the double-ownership the DST heal-convergence
  invariant exists to catch.
* **Explicit brownout, never silent drops** — when demand exceeds
  reachable capacity the region sheds NEW work below a priority floor
  that climbs one tier per multiple of
  ``region.brownout_queue_per_replica`` (the brownout ladder), each
  shed retiring with a REJECTED span; entry/exit and every cell
  death/partition land in the flight recorder so the post-mortem
  timeline shows the trigger next to the fallout.

Route retries at BOTH tiers draw from the request's own
:class:`~deepspeed_tpu_torch.resilience.retry.RetryBudget`
(:func:`~.fleet.route_budget_for` — one budget per request lifecycle,
shared by the fleet's replica loop and the region's cell loop) with
jittered exponential backoff, so a flapping or partitioned cell is
given up on explicitly instead of hammered forever — while a fresh
request always starts with a full budget.

Lock order (``resilience/locksan.py`` ``DOCUMENTED_LOCK_ORDER``):
``Region._lock`` ->
``ServingCell._lock`` -> ``ServingFleet._lock`` ->
``ServingEngine._lock``. Fleet->region callbacks (retire hook, route /
hand-off escalation) are invoked by the fleet OUTSIDE its own lock, so
taking the region lock there cannot invert the order.

Telemetry: counters/gauges under ``serving/region/...``; each cell's
fleet under ``serving/<cell>/fleet/...`` and its replicas under
``serving/<cell>/replica-N/...`` — per-cell namespacing end to end.
"""

from __future__ import annotations

import collections
import hashlib
import json
import random
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..config import FleetConfig, RegionConfig, ServingConfig
from ..resilience.chaos import get_fault_injector, is_reachable
from ..resilience.clock import Clock, get_clock
from ..resilience.locksan import named_rlock
from ..telemetry import get_telemetry
from ..telemetry.digest import DigestAccumulator, DigestSource
from ..telemetry.slo import SLOObjective, TenantSLOTracker
from ..telemetry.tracing import get_tracer, request_event
from ..utils.device import resolve_device
from ..utils.logging import log_dist, logger
from .cell import CellDigest, CellUnreachable, ServingCell, check_reachable
from .fleet import ServingFleet, route_budget_for
from .request import Request, RequestState
from .rollout import RolloutController
from .router import ConsistentHashRing, _hash64, prefix_key
from .server import emit_request_span, stream_tokens

#: the brownout ladder's top rung: an effectively-infinite priority
#: floor (shed ALL new work) without overflowing int arithmetic when
#: reachable capacity is zero and pressure divides to infinity
FLOOR_MAX = 1 << 30


class Region:
    """Cell-based fleet-of-fleets serving front-end. Same call surface as
    :class:`ServingFleet` / :class:`ServingEngine`, one tier up.

    ``engine_factory`` must return a fresh engine per call — it is
    handed to every cell's fleet. ``config`` is the
    :class:`~deepspeed_tpu_torch.config.RegionConfig`; ``fleet_config`` /
    ``serving_config`` apply to every cell identically (cells are
    interchangeable failure domains). ``device`` defaults to ``"cuda"``
    (raising without a CUDA device unless ``device="cpu"`` is asked
    for) and is handed to every cell's fleet, which checks that each
    engine the factory returns lives on it. With ``start=False`` nothing
    ticks on its own: drive deterministically via :meth:`step`.
    """

    def __init__(self, engine_factory, config: Any = None,
                 fleet_config: Any = None,
                 serving_config: Any = None,
                 preemption_guard: Any = None,
                 start: bool = True,
                 clock: Optional[Clock] = None,
                 name: str = "region",
                 device=None):
        self.device = resolve_device(device)
        if config is None:
            config = RegionConfig()
        elif isinstance(config, dict):
            config = RegionConfig.from_dict(config)
        self.config = config
        if fleet_config is None:
            fleet_config = FleetConfig()
        elif isinstance(fleet_config, dict):
            fleet_config = FleetConfig.from_dict(fleet_config)
        self._fleet_config = fleet_config
        if serving_config is None:
            serving_config = ServingConfig()
        elif isinstance(serving_config, dict):
            serving_config = ServingConfig.from_dict(serving_config)
        self._serving_config = serving_config
        self.name = name
        self._factory = engine_factory
        self._guard = preemption_guard
        self._start_drivers = start
        self._clock = clock if clock is not None else get_clock()
        # locksan seam: plain RLock in production, order-recording
        # wrapper under tests (resilience/locksan.py)
        self._lock = named_rlock("Region._lock")
        self._cells: Dict[str, ServingCell] = {}
        self._ring = ConsistentHashRing(vnodes=config.cell_ring_vnodes)
        self._requests: Dict[int, Tuple[Request, str]] = {}
        self._accepting = True
        self._shed_backlog: List[Request] = []
        # region telemetry plane (telemetry/digest.py, telemetry/slo.py):
        # per-cell digest deltas are absorbed on the rollup cadence into
        # ONE accumulator + SLO tracker — the flat per-request SLA deque
        # this replaces was a region-wide scan magnet and carried no
        # tenant attribution. All rollup state is touched only by the
        # monitor/poll thread (the digest-refresh discipline).
        self._slo_objective = SLOObjective(
            target=config.slo_target,
            window_s=config.slo_window_s,
            fast_window_s=config.slo_fast_window_s,
            slow_window_s=config.slo_slow_window_s,
            fast_burn_threshold=config.slo_fast_burn,
            slow_burn_threshold=config.slo_slow_burn,
            min_samples=config.slo_min_samples)
        self._slo = TenantSLOTracker(self._slo_objective)
        self._tel_rollup = DigestAccumulator()
        self._region_tel = DigestSource("region")
        # final deltas pulled from cells at death (kill_cell), absorbed
        # by the next rollup pass on the poll thread
        self._salvaged_digests: List[Any] = []
        self._rollup_tick = 0
        self._rollup_hasher = hashlib.sha256()
        #: per-rollup work accounting, pinned by tests: digest
        #: rows absorbed in the LAST rollup pass and cumulatively —
        #: O(cells), independent of replica count
        self.rollup_work_last = 0
        self.rollup_work_total = 0
        self.rollup_count = 0
        self._stop_evt = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        # route retries draw from the REQUEST's own budget
        # (route_budget_for): fleet-internal replica retries and
        # region-level cell retries share the request's pool, so a
        # partitioned cell cannot be hammered forever by EITHER tier's
        # re-route loop (resilience/retry.py).
        # Deterministic jitter, same rule as the cell tier: name-seeded
        # rng so a DST replay draws the identical backoff sequence.
        self._route_rng = random.Random(f"{name}/route")
        # brownout ladder state: floor 0 = off; floor
        # f sheds NEW requests with priority < f
        self._brownout_floor = 0
        #: (t, kind, priority, floor) rows while a brownout is active —
        #: the soak's strictly-priority-ordered shedding gate reads
        #: this. Bounded: a production region under sustained overload
        #: appends one row per admit/shed for as long as a floor is
        #: up, and the audit only ever needs a recent window
        self.brownout_log: collections.deque = collections.deque(
            maxlen=4096)
        self._partition_epoch_seen = 0
        self._partition_active = False
        self._cell_chaos_fired = False
        # per-route work accounting, pinned by tests: digest lookups +
        # ring steps for the LAST route and cumulatively — must be
        # independent of replica count per request
        self.route_work_last = 0
        self.route_work_total = 0
        for i in range(config.cells):
            self._spawn_cell(f"cell-{i}")
        # the region's prefix key must match the cells' prefix-cache
        # unit (same rule as the fleet's affinity ring one tier down)
        self._block_size = 16
        first = next(iter(self._cells.values()), None)
        if first is not None and first.fleet.replicas:
            eng = first.fleet.replicas[0].engine
            self._block_size = int(getattr(eng.config, "kv_block_size", 16))
        # zero-downtime rollout controller (serving/rollout.py): owns
        # the canary/promote/rollback state machine, stepped from poll()
        self._rollout = RolloutController(self, serving_config.rollout,
                                          self._clock)
        log_dist(f"Region[{name}]: {len(self._cells)} cells x "
                 f"{fleet_config.replicas} replicas "
                 f"router={fleet_config.router} "
                 f"brownout_step={config.brownout_queue_per_replica}")
        self._refresh_digests()
        if start:
            self._monitor = threading.Thread(target=self._monitor_loop,
                                             daemon=True,
                                             name="region-monitor")
            self._monitor.start()

    def _spawn_cell(self, name: str) -> ServingCell:
        fleet = ServingFleet(
            self._factory_for(name), self._fleet_config,
            self._serving_config,
            preemption_guard=self._guard,
            start=self._start_drivers,
            clock=self._clock,
            name=name,
            device=self.device,
            on_retire=self._on_fleet_retire,
            on_handoff_escalation=(
                lambda req, export, _src=name:
                self._escalate_handoff(_src, req, export)),
            on_route_escalation=(
                lambda req, _src=name:
                self._escalate_route(_src, req)))
        cell = ServingCell(name, fleet, self._clock)
        # ring membership changes outside the lock: cells join only at
        # construction (single-threaded), and the vnode insertion loop
        # has no business running under the routing lock
        self._ring.join(name)
        with self._lock:
            self._cells[name] = cell
        return cell

    def _factory_for(self, cell_name: str):
        # indirection point: multi-host deployments bind each cell's
        # factory to its own host group; in-process every cell shares
        # one factory
        return self._factory

    # -- telemetry -------------------------------------------------------
    @property
    def _telemetry(self):
        return get_telemetry()

    def _count(self, name: str, n: float = 1.0) -> None:
        self._telemetry.registry.counter(f"serving/region/{name}").inc(n)

    def _update_gauges(self) -> None:
        t = self._telemetry
        if not t.enabled:
            return
        with self._lock:
            cells = list(self._cells.values())
            floor = self._brownout_floor
        alive = [c for c in cells if c.alive]
        reachable = [c for c in alive
                     if is_reachable(self.name, c.name)]
        depth = 0
        quarantined = 0
        for c in reachable:
            # bind once: a concurrent mark_dead() nulls c.digest
            d = c.digest
            if d is not None:
                depth += d.queue_depth
                # gray-failure detection stays O(cells): the per-cell
                # quarantine count rides the published digest, so the
                # region-wide graying signal never scans a replica
                quarantined += d.quarantined
        r = t.registry
        r.gauge("serving/region/cells").set(len(alive))
        r.gauge("serving/region/reachable_cells").set(len(reachable))
        r.gauge("serving/region/queue_depth").set(depth)
        r.gauge("serving/region/brownout_floor").set(floor)
        r.gauge("serving/region/quarantined_replicas").set(quarantined)

    # -- submission ------------------------------------------------------
    def submit(self, prompt: Sequence[int], *,
               max_new_tokens: Optional[int] = None,
               eos_token_id: Optional[int] = None,
               priority: int = 0,
               deadline_s: Optional[float] = None,
               ttft_deadline_s: Optional[float] = None,
               client_request_id: Optional[str] = None,
               tenant: Optional[str] = None,
               on_token=None) -> Request:
        """Route a request through the cell ring. Same contract as
        ``ServingFleet.submit``: returns immediately, possibly already
        REJECTED (brownout shed, no reachable cell, backpressure)."""
        req = Request(
            prompt=list(prompt),
            max_new_tokens=(max_new_tokens if max_new_tokens is not None
                            else self._serving_config.default_max_new_tokens),
            eos_token_id=eos_token_id, priority=priority,
            deadline_s=deadline_s, ttft_deadline_s=ttft_deadline_s,
            client_request_id=client_request_id, tenant=tenant,
            on_token=on_token)
        # one timebase per lifecycle (the fleet/engine rule, one tier up)
        req._clock = self._clock
        req.t_submit = self._clock.now()
        tracer = get_tracer()
        if tracer.enabled:
            req._trace_root = tracer.new_trace(
                "request", prompt_tokens=len(req.prompt),
                priority=req.priority)
        self._route_request(req)
        self._flush_shed()
        return req

    def _cell_eligible(self, name: str, refused: set,
                       counter: List[int]) -> Optional[CellDigest]:
        """Digest-only eligibility read (NO fleet/replica access): the
        entire per-cell routing cost. ``counter`` meters the work."""
        counter[0] += 1
        if name in refused:
            return None
        cell = self._cells.get(name)
        if cell is None or not cell.alive:
            return None
        if not is_reachable(self.name, name):
            return None
        d = cell.digest
        if d is None or not d.accepting or d.healthy_replicas <= 0:
            return None
        return d

    def _pick_cell(self, prompt: Sequence[int],
                   refused: set) -> Optional[str]:
        """Two-tier hash tier one: walk the cell ring from the prompt's
        prefix-key hash, judging each candidate by its PUBLISHED digest;
        then the optional spill valve (an overloaded primary cell spills
        to the least-loaded reachable one — affinity is a throughput
        optimisation, not a hostage situation, at this tier too)."""
        work = [0]
        digests: Dict[str, CellDigest] = {}

        def eligible(name: str) -> bool:
            d = self._cell_eligible(name, refused, work)
            if d is None:
                return False
            digests[name] = d
            return True

        h = _hash64(",".join(map(str, prefix_key(prompt,
                                                 self._block_size))))
        chosen = self._ring.walk(h, eligible)
        spill = self.config.cell_spill_load
        if (chosen is not None and spill > 0
                and digests[chosen].load_per_replica >= spill):
            # the spill scan reads every cell's DIGEST (O(cells),
            # replica-independent — the same accounting unit as the walk)
            for name in self._cells:
                if name not in digests:
                    d = self._cell_eligible(name, refused, work)
                    if d is not None:
                        digests[name] = d
            alt = min(digests,
                      key=lambda n: (digests[n].load_per_replica, n))
            if digests[alt].load_per_replica \
                    < digests[chosen].load_per_replica:
                chosen = alt
        # global KV tier, cell tier (serving/kvtier.py):
        # when the walk's choice holds no fresh residency for this
        # prefix but another eligible cell's fleet directory does,
        # prefer that cell. An O(cells) leaf-lock peek — the same
        # accounting unit as the walk and the spill scan — and purely
        # advisory: a lying directory just lands the request on a cell
        # that prefills locally.
        tiered = any(getattr(c.fleet, "kv_tier", None) is not None
                     for c in self._cells.values())
        if (tiered and chosen is not None
                and not self._cell_has_residency(chosen, h)):
            for name in sorted(self._cells):
                if name == chosen:
                    continue
                d = digests.get(name)
                if d is None:
                    d = self._cell_eligible(name, refused, work)
                    if d is None:
                        continue
                    digests[name] = d
                if self._cell_has_residency(name, h):
                    chosen = name
                    self._count("cell_residency_hits")
                    break
        self.route_work_last = work[0]
        self.route_work_total += work[0]
        return chosen

    def _cell_has_residency(self, name: str, h: int) -> bool:
        """True when ``name``'s fleet runs the global KV tier AND its
        prefix directory holds a bounded-staleness-fresh entry for the
        prompt's prefix hash (cells publish replica residency in the
        same hash space the rings walk). The directory lock is a LEAF,
        so this peek is legal under the region lock."""
        cell = self._cells.get(name)
        if cell is None:
            return False
        tier = getattr(cell.fleet, "kv_tier", None)
        if tier is None:
            return False
        return tier.directory.has_fresh(h, self._clock.now())

    def _route_request(self, req: Request, requeue: bool = False) -> bool:
        """Tier-one placement loop. New work passes the brownout gate;
        continuations (cell failover, cross-cell degrade) bypass it —
        they were already admitted. Failures ALWAYS end in a terminal
        REJECTED span (never silent); refusals retry other cells under
        the request's own budget, shared with the fleet tier's loop."""
        tracer = get_tracer()
        if requeue:
            request_event(req, "region_reroute")
        refused: set = set()
        backoff = self._fleet_config.route_backoff_s
        while True:
            span = tracer.begin_span(
                "region_route", getattr(req, "_trace_root", None),
                requeue=bool(requeue), attempt=len(refused))
            with self._lock:
                if not self._accepting and not requeue:
                    tracer.finish_span(span, error="region closed")
                    self._reject(req, "region closed to new requests")
                    return False
                floor = self._brownout_floor
                if not requeue and floor > 0 and req.priority < floor:
                    tracer.finish_span(span, error="brownout",
                                       floor=floor)
                    self._shed_brownout(req, floor)
                    return False
                name = self._pick_cell(req.prompt, refused)
                # bind the route-work meter while the lock is still
                # held: _pick_cell writes it under this lock, and the
                # unlocked read below the release raced a concurrent
                # route's write
                work = self.route_work_last
                if name is None:
                    tracer.finish_span(span, error="no reachable cell")
                    # a transiently empty health view (every digest
                    # stale, browned out mid-heal, a spill racing a
                    # quarantine) must not reject outright while live
                    # cells exist: retry the siblings under the
                    # request's own budget with the existing jittered
                    # backoff — the sleep runs OUTSIDE the lock below.
                    # A region with no live reachable cell at all is a
                    # different animal: nothing a retry can find.
                    retryable = any(
                        c.alive and is_reachable(self.name, c.name)
                        for c in self._cells.values())
                    if not retryable:
                        self._reject(req, "no reachable cell with capacity")
                        return False
                else:
                    self._requests[req.uid] = (req, name)
                    cell = self._cells[name]
            if name is None:
                if not route_budget_for(
                        req, self._fleet_config.route_retry_budget).take(
                            "region_route"):
                    request_event(req, "route_budget_exhausted")
                    self._reject(req, "no reachable cell with capacity")
                    self._flush_shed()
                    return False
                self._count("route_retries")
                refused.clear()   # a refused cell may have healed by now
                d = backoff
                if d > 0:
                    d *= 1.0 + self._route_rng.uniform(
                        0.0, self._fleet_config.route_backoff_jitter)
                    self._clock.sleep(d)
                backoff = min(backoff * 2.0, 1.0)
                continue
            accepted = cell.fleet.route_request(req, requeue=requeue,
                                                shed=False)
            tracer.finish_span(span, cell=name, accepted=accepted,
                               work=work)
            if accepted:
                self._count("routed")
                if floor > 0 and not requeue:
                    with self._lock:
                        self.brownout_log.append(
                            {"t": self._clock.now(), "kind": "admit",
                             "priority": req.priority, "floor": floor})
                return True
            refused.add(name)
            with self._lock:
                ent = self._requests.get(req.uid)
                if ent is not None and ent[1] == name:
                    del self._requests[req.uid]
            if not route_budget_for(
                    req, self._fleet_config.route_retry_budget).take(
                        "region_route"):
                request_event(req, "route_budget_exhausted")
                logger.warning(f"Region[{self.name}]: route retry budget "
                               f"exhausted for request {req.uid}")
                self._reject(req, "route retry budget exhausted")
                return False
            self._count("route_retries")
            d = backoff
            if d > 0:
                d *= 1.0 + self._route_rng.uniform(
                    0.0, self._fleet_config.route_backoff_jitter)
                self._clock.sleep(d)
            backoff = min(backoff * 2.0, 1.0)

    # -- shedding --------------------------------------------------------
    def _shed_brownout(self, req: Request, floor: int) -> None:
        """Priority-tiered load shed (region lock held, reentrant). The
        span (emitted at the next flush, outside the lock) carries the
        brownout reason — sheds are EXPLICIT: a terminal REJECTED span
        per shed request, audited by the DST shed-span invariant."""
        self.brownout_log.append(
            {"t": self._clock.now(), "kind": "shed",
             "priority": req.priority, "floor": floor})
        self._count("brownout_sheds")
        request_event(req, "brownout_shed", floor=floor)
        self._reject(req, f"brownout: shed at priority {req.priority} "
                          f"< floor {floor}")

    def _reject(self, req: Request, reason: str) -> None:
        """Region-level shed. Same observable contract as fleet/replica
        rejects: terminal REJECTED + span in requests.jsonl + an SLA
        miss when the request carried an SLO. Span I/O deferred out of
        the lock (the fleet's backlog discipline, one tier up)."""
        req.error = reason
        req.transition(RequestState.REJECTED)
        self._count("rejected")
        with self._lock:
            self._shed_backlog.append(req)

    def _flush_shed(self) -> None:
        if not self._shed_backlog:
            return
        with self._lock:
            backlog, self._shed_backlog = self._shed_backlog, []
        for req in backlog:
            emit_request_span(self._telemetry, req, digest=self._region_tel)
            # a region-tier shed never reached a fleet, so its SLO
            # verdict enters the plane HERE (fleet-retired requests are
            # recorded by their fleet's source — never twice)
            had_slo = (req.deadline_s is not None
                       or req.ttft_deadline_s is not None)
            if had_slo and not (req.state is RequestState.CANCELLED
                                and req.error is None):
                self._region_tel.slo_verdict(req.tenant, req.model_version,
                                             False)
                self._region_tel.count("slo_judged")
            self._on_fleet_retire(req)

    # -- fleet callbacks (invoked OUTSIDE fleet locks) -------------------
    def _on_fleet_retire(self, req: Request) -> None:
        # SLO verdicts live in the rollup plane (the fleet's digest
        # source records them); the region only clears its routing entry
        with self._lock:
            self._requests.pop(req.uid, None)

    def _escalate_route(self, src_cell: str, req: Request) -> bool:
        """A cell found no replica for a CONTINUATION: place it on
        another cell (re-prefill resume — the request's engine state is
        already gone). True = the region took responsibility (placed or
        terminally shed); False = untouched."""
        self._count("route_escalations")
        request_event(req, "cross_cell_reroute", source=src_cell)
        with self._lock:
            ent = self._requests.get(req.uid)
            if ent is not None and ent[1] == src_cell:
                del self._requests[req.uid]
        self._route_request(req, requeue=True)
        self._flush_shed()
        return True     # placed or region-shed — either way, handled

    def _escalate_handoff(self, src_cell: str, req: Request,
                          export) -> bool:
        """Cross-cell KV adoption: the source cell has nobody to decode
        a prefilled hand-off. Offer the (request, KV export) pair to
        reachable cells in digest-load order; an active partition makes
        the pair's transfer fail TYPED (:class:`CellUnreachable`); when
        nobody reachable can adopt, the pair is handed BACK to the
        source fleet (False return), whose prefill replica decodes it
        itself — the KV is already there, and a region-side re-prefill
        would land back on that same live prefill pool with the
        hand-off flag re-armed, ping-ponging forever. Only when local
        decode is impossible too does the fleet escalate the route for
        a full re-prefill on a reachable cell — degraded, never
        lost."""
        with self._lock:
            cells = [c for c in self._cells.values()
                     if c.alive and c.name != src_cell]
        candidates = []
        for c in cells:
            # bind once: a concurrent mark_dead() nulls c.digest
            d = c.digest
            if d is not None and d.accepting and d.healthy_replicas > 0:
                candidates.append((c.name, d))
        candidates.sort(key=lambda nd: (nd[1].load_per_replica, nd[0]))
        for name, _d in candidates:
            try:
                # the KV pages travel cell-to-cell: BOTH the inter-cell
                # link and the region's control link must be up
                check_reachable(src_cell, name, op="kv_adoption")
                check_reachable(self.name, name, op="kv_adoption")
            except CellUnreachable as e:
                self._count("partition_blocked_handoffs")
                request_event(req, "partition_degrade", target=name,
                              op=e.op)
                continue
            # table entry BEFORE the placement: a fast replica could
            # adopt, decode and retire the request while we are still
            # here, and the retire hook must find the entry to pop —
            # registering after the fact would resurrect it as a stale
            # row (the convergence invariant's terminal-in-table case)
            with self._lock:
                self._requests[req.uid] = (req, name)
            if self._cells[name].fleet.place_handoff(req, export):
                self._count("handoff_escalations")
                request_event(req, "cross_cell_handoff",
                              source=src_cell, target=name)
                return True
            # refusal: point the row BACK at the source cell, do not
            # delete it — the pair is handed back to the source fleet on
            # the False return below, and a deleted row would strand the
            # request ownerless in the region table (version-affine
            # hand-offs made cross-cell refusal a common outcome, not a
            # scale-down race). The ent guard keeps a concurrent retire
            # from being resurrected as a stale row.
            with self._lock:
                ent = self._requests.get(req.uid)
                if ent is not None and ent[1] == name:
                    self._requests[req.uid] = (req, src_cell)
        # nobody reachable can adopt the KV: hand the pair back to the
        # source fleet (False), whose prefill replica decodes it itself
        # as the last resort — the KV is already THERE, and a re-prefill
        # from here would just land back on that same prefill pool with
        # the hand-off flag re-armed (an endless prefill->hand-off->
        # degrade cycle). The fleet escalates the route back up only
        # when local decode is impossible too.
        self._count("handoff_degrades")
        request_event(req, "handoff_degraded", source=src_cell)
        return False

    # -- streaming / cancel ----------------------------------------------
    def stream(self, prompt: Sequence[int], **kwargs):
        """Generator yielding tokens as they are emitted (see
        ``ServingEngine.stream``)."""
        return stream_tokens(self, prompt, **kwargs)

    def cancel(self, req) -> bool:
        """Cancel by Request or uid, wherever in the region it lives."""
        with self._lock:
            if not isinstance(req, Request):
                ent = self._requests.get(int(req))
                if ent is None:
                    return False
                req = ent[0]
            if req.is_terminal:
                return False
            req._cancel_requested = True
            ent = self._requests.get(req.uid)
            cell = self._cells.get(ent[1]) if ent is not None else None
        if cell is not None:
            cell.fleet.cancel(req)
        return True

    # -- monitor ---------------------------------------------------------
    def poll(self) -> None:
        """One monitor pass: injected chaos, partition-state tracking,
        digest refresh (the ONE place replicas are scanned), dead-cell
        detection, the brownout ladder. Tests call it directly; the
        monitor thread loops it."""
        self._check_chaos()
        self._check_partitions()
        self._refresh_digests()
        self._check_dead_cells()
        self._update_brownout()
        self._rollout.step()
        self._flush_shed()
        self._update_gauges()

    def _monitor_loop(self) -> None:
        while not self._clock.wait_event(self._stop_evt,
                                         self.config.health_interval_s):
            try:
                self.poll()
            except Exception:
                logger.exception("Region: monitor pass crashed")

    def _check_chaos(self) -> None:
        if self._cell_chaos_fired:
            return
        inj = get_fault_injector()
        if inj is None:
            return
        with self._lock:
            cells = [c for c in self._cells.values() if c.alive]
        for cell in cells:
            if inj.should_kill_cell(cell.index, cell.ticks()):
                self._cell_chaos_fired = True
                self.kill_cell(cell.name, reason="chaos: injected cell "
                                                 "outage")
                return

    def _check_partitions(self) -> None:
        """Track the injector's partition epoch; on a change, record the
        new connectivity in the flight recorder (a partition is exactly
        the event whose trigger/fallout adjacency a post-mortem needs)
        and — on heal — rebalance queued work onto rejoined capacity."""
        inj = get_fault_injector()
        epoch = 0 if inj is None else inj.partition_epoch
        with self._lock:
            # epoch compare-then-stamp under the region lock: poll()
            # runs on the monitor thread AND via manual step(), and the
            # unlocked check could double-run (or skip) one epoch's
            # heal rebalance
            if epoch == self._partition_epoch_seen:
                return
            self._partition_epoch_seen = epoch
            active = inj is not None and inj.partitioned
            was_active = self._partition_active
            self._partition_active = active
        tracer = get_tracer()
        if active:
            unreachable = sorted(
                name for name in self._cells
                if not is_reachable(self.name, name))
            self._count("partitions_detected")
            logger.warning(f"Region: partition detected; unreachable "
                           f"cells: {unreachable or 'none (inter-cell only)'}")
            if tracer.enabled:
                tracer.flight.note("partition_detected",
                                   unreachable=",".join(unreachable))
                tracer.flight.dump("partition-detected")
        elif was_active:
            self._count("partitions_healed")
            logger.warning("Region: partition healed; rebalancing")
            if tracer.enabled:
                tracer.flight.note("partition_healed")
            self._rebalance()

    def _refresh_digests(self) -> None:
        with self._lock:
            cells = [c for c in self._cells.values() if c.alive]
        for cell in cells:
            cell.publish_digest()
        with self._lock:
            self._rollup_tick += 1
            tick = self._rollup_tick
        if tick % self.config.telemetry_rollup_every == 0:
            self._publish_rollup(cells)

    def _publish_rollup(self, cells: Optional[List[ServingCell]] = None
                        ) -> None:
        """One telemetry rollup pass (monitor cadence, every
        ``telemetry_rollup_every``-th digest refresh): pull each live
        cell's telemetry digest delta, fold it into the region
        accumulator and the SLO tracker, then evaluate burn-rate
        alerts. Work is O(cells x digest rows) — independent of replica
        count, metered by ``rollup_work_last``. Deterministic: no RNG,
        no extra clock advance, stable cell order — the per-seed digest
        stream hashes bit-identically under the deterministic simulator."""
        if cells is None:
            with self._lock:
                cells = [c for c in self._cells.values() if c.alive]
        now = self._clock.now()
        digests = []
        with self._lock:
            salvaged, self._salvaged_digests = self._salvaged_digests, []
        digests.extend(d for d in salvaged if not d.is_empty())
        for cell in cells:
            d = cell.publish_telemetry(now)
            if d is not None and not d.is_empty():
                digests.append(d)
        own = self._region_tel.publish(now)
        if not own.is_empty():
            digests.append(own)
        work = 0
        for d in digests:
            work += self._tel_rollup.absorb(d)
            self._slo.record(
                now, d.tenants, d.versions,
                ok=int(d.counters.get("slo_met", 0)),
                judged=int(d.counters.get("slo_judged", 0)))
            self._rollup_hasher.update(json.dumps(
                d.to_dict(), sort_keys=True).encode("utf-8"))
        with self._lock:
            self.rollup_count += len(digests)
            self.rollup_work_last = work
            self.rollup_work_total += work
        self._emit_slo_alerts(self._slo.check_alerts(now))
        t = self._telemetry
        if t.enabled and digests:
            r = t.registry
            for tenant in self._slo.tenants():
                _, ratio = self._slo.tenant_attainment(tenant, now)
                if ratio is not None:
                    r.gauge(
                        f"serving/region/slo/{tenant}/attainment"
                    ).set(ratio)
            # global-vs-local prefix hit rate (serving/kvtier.py): the per-outcome routing counters ride the
            # fleet→cell→region digests absorbed above, so the region
            # can report what share of prefix-routable work landed on a
            # directory-confirmed holder vs the plain affinity ring
            res = self._tel_rollup.counter("route/residency_hit")
            aff = self._tel_rollup.counter("route/affinity_hit")
            stale = self._tel_rollup.counter("route/directory_stale")
            routed = res + aff + stale
            if routed > 0:
                r.gauge("serving/region/kvtier/global_hit_share").set(
                    res / routed)
                r.gauge("serving/region/kvtier/directory_stale_share").set(
                    stale / routed)
            cold = self._tel_rollup.counter("route/cold_readmit")
            if cold > 0:
                r.gauge("serving/region/kvtier/cold_readmits").set(cold)

    def _emit_slo_alerts(self, transitions: List[Dict[str, Any]]) -> None:
        """Mirror SLO alert transitions into the registry and flight
        recorder (the alert_log itself is the tracker's)."""
        if not transitions:
            return
        tracer = get_tracer()
        for tr in transitions:
            self._count(f"slo_alerts_{tr['state']}")
            logger.warning(
                f"Region: SLO burn-rate alert {tr['state']} "
                f"(tenant={tr['tenant']} window={tr['window']} "
                f"burn={tr['burn']:.2f})")
            if tracer.enabled:
                tracer.flight.note("slo_alert", tenant=tr["tenant"],
                                   window=tr["window"], state=tr["state"],
                                   burn=tr["burn"])

    def _check_dead_cells(self) -> None:
        """A cell whose digest reports zero healthy replicas and whose
        fleet will not respawn them is DEAD — declare it (flight-dump),
        harvest, re-place. Respawning fleets are left to self-heal: a
        premature declaration would double-place work the respawned
        replicas still own."""
        with self._lock:
            cells = [c for c in self._cells.values() if c.alive]
        for cell in cells:
            d = cell.digest
            if (d is not None and d.healthy_replicas == 0
                    and not cell.fleet.config.respawn):
                self.kill_cell(cell.name,
                               reason="no healthy replicas left")

    def _update_brownout(self) -> None:
        """Walk the brownout ladder from reachable-capacity pressure
        (queued per healthy reachable replica, digests only). The floor
        climbs immediately with pressure; it descends only through the
        ``brownout_exit_ratio`` hysteresis band, so the region does not
        flap at a threshold."""
        with self._lock:
            cells = [c for c in self._cells.values()
                     if c.alive and is_reachable(self.name, c.name)]
        queue = healthy = 0
        for c in cells:
            d = c.digest
            if d is None:
                continue
            queue += d.queue_depth
            healthy += d.healthy_replicas
        if healthy <= 0:
            pressure = float("inf") if queue else 0.0
        else:
            pressure = queue / healthy
        step = self.config.brownout_queue_per_replica
        level = (FLOOR_MAX if pressure == float("inf")
                 else min(FLOOR_MAX, int(pressure // step)))
        tracer = get_tracer()
        # SLO-plane coupling (telemetry/slo.py): while any tenant's FAST
        # burn-rate alert is firing, the ladder holds its floor — queue
        # pressure easing is not recovery if a tenant is still burning
        # error budget. The alert auto-clears when its window's samples
        # age out, so a quiet region always descends eventually.
        slo_hold = self._slo.has_fast_burn()
        with self._lock:
            cur = self._brownout_floor
            if level > cur:
                new = level
            elif level < cur and not slo_hold and pressure \
                    <= self.config.brownout_exit_ratio * cur * step:
                # <= not <: at exit_ratio 0 (a value validation allows)
                # a fully drained region (pressure 0.0) must still
                # descend, or one transient burst sheds low-priority
                # work forever
                new = level
            else:
                new = cur
            self._brownout_floor = new
        if new == cur:
            return
        if cur == 0 and new > 0:
            self._count("brownout_entered")
            logger.warning(f"Region: BROWNOUT entered (floor {new}, "
                           f"pressure {pressure:.1f}/replica)")
            if tracer.enabled:
                tracer.flight.note("brownout_entered", floor=new)
                tracer.flight.dump("brownout-entered")
        elif cur > 0 and new == 0:
            self._count("brownout_exited")
            logger.warning("Region: brownout exited")
            if tracer.enabled:
                tracer.flight.note("brownout_exited")
                tracer.flight.dump("brownout-exited")
        else:
            self._count("brownout_floor_moves")
            if tracer.enabled:
                tracer.flight.note("brownout_floor", floor=new)

    # -- chaos / failover -----------------------------------------------
    def kill_cell(self, name: str, reason: str = "killed") -> bool:
        """Whole-cell outage: correlated death of every replica in one
        failure domain. The cell leaves the ring, every admitted request
        is harvested (its KV discarded as suspect) and re-placed on
        reachable cells through the bit-exact re-prefill resume path —
        under load, zero admitted requests are lost: each finishes
        elsewhere or retires with a REJECTED span."""
        with self._lock:
            cell = self._cells.get(name)
            if cell is None or not cell.alive:
                return False
            self._ring.leave(name)
        logger.warning(f"Region: cell {name} died ({reason})")
        self._count("cell_outages")
        tracer = get_tracer()
        if tracer.enabled:
            tracer.flight.note("cell_outage", cell=name, reason=reason)
            tracer.flight.dump("cell-outage")
        orphans = cell.kill(reason)
        # salvage the dead cell's last unpublished telemetry delta
        # (publish_telemetry returns None once DEAD): spans the cell
        # emitted before dying must still reach the rollup plane, or
        # region sketches would silently undercount on outage seeds
        salvage = cell.fleet.collect_telemetry_digest(self._clock.now())
        if not salvage.is_empty():
            with self._lock:
                self._salvaged_digests.append(salvage)
        self._failover_orphans(orphans, source=name)
        self._update_brownout()     # reachable capacity just shrank
        self._update_gauges()
        return True

    def _failover_orphans(self, orphans: List[Request],
                          source: str) -> None:
        if orphans:
            self._count("cell_failovers", len(orphans))
        for req in orphans:
            request_event(req, "cell_failover", source=source)
            if req._cancel_requested:
                req.transition(RequestState.CANCELLED)
                self._count("cancelled")
                emit_request_span(self._telemetry, req,
                                  digest=self._region_tel)
                self._on_fleet_retire(req)
                continue
            self._route_request(req, requeue=True)
        self._flush_shed()

    def _rebalance(self) -> None:
        """Heal-time rebalance: re-spread QUEUED (stateless) work from
        cells that bore the partition onto rejoined capacity. Only
        requests holding no engine state move — live decodes stay where
        their KV lives. Conservative by design: steal only the excess
        above the reachable mean + threshold."""
        if self.config.rebalance_threshold <= 0:
            return
        self._refresh_digests()
        with self._lock:
            alive = [c for c in self._cells.values()
                     if c.alive and is_reachable(self.name, c.name)]
        # snapshot each digest ONCE: a concurrent mark_dead() nulls it
        snap = []
        for c in alive:
            d = c.digest
            if d is not None and d.healthy_replicas > 0:
                snap.append((c, d))
        if len(snap) < 2:
            return
        total_q = sum(d.queue_depth for _c, d in snap)
        total_h = sum(d.healthy_replicas for _c, d in snap)
        mean = total_q / max(1, total_h)
        moved = 0
        cells = [c for c, _d in snap]
        loads = {c.name: d.load_per_replica for c, d in snap}
        healthy = {c.name: d.healthy_replicas for c, d in snap}
        for cell in sorted(cells, key=lambda c: (-loads[c.name], c.name)):
            excess = loads[cell.name] - (mean
                                         + self.config.rebalance_threshold)
            if excess <= 0:
                continue
            n = int(excess * healthy[cell.name])
            if n <= 0:
                continue
            stolen = cell.fleet.steal_queued(n)
            with self._lock:
                for req in stolen:
                    self._requests.pop(req.uid, None)
            for req in stolen:
                request_event(req, "rebalance", source=cell.name)
                target = min((name for name in loads
                              if name != cell.name),
                             key=lambda name: (loads[name], name))
                # entry before placement (see _escalate_handoff): the
                # retire hook must always find the row to pop
                with self._lock:
                    self._requests[req.uid] = (req, target)
                placed = self._cells[target].fleet.route_request(
                    req, requeue=True, shed=False)
                if placed:
                    loads[target] += 1.0 / max(1, healthy[target])
                    moved += 1
                else:
                    # target refused (raced a stop): normal region
                    # re-route — places or sheds with a span
                    with self._lock:
                        ent = self._requests.get(req.uid)
                        if ent is not None and ent[1] == target:
                            del self._requests[req.uid]
                    self._route_request(req, requeue=True)
        if moved:
            self._count("rebalanced", moved)
            logger.info(f"Region: rebalanced {moved} queued requests "
                        f"after heal")
        self._flush_shed()

    # -- shutdown --------------------------------------------------------
    def drain(self, timeout: Optional[float] = None,
              reject_queued: bool = False) -> bool:
        """Stop admission region-wide and serve out every cell's
        backlog (partitioned cells included: in-process their fleets
        still run — a real deployment drains them when connectivity
        returns)."""
        with self._lock:
            self._accepting = False
            cells = [c for c in self._cells.values() if c.alive]
        budget = (timeout if timeout is not None
                  else self._serving_config.drain_timeout_s)
        deadline = self._clock.deadline(budget)
        ok = True
        for cell in cells:
            left = max(0.0, deadline - self._clock.now())
            ok = cell.fleet.drain(timeout=left,
                                  reject_queued=reject_queued) and ok
        return ok

    def close(self, timeout: Optional[float] = None) -> None:
        self.drain(timeout=timeout)
        self._stop_evt.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
            self._monitor = None
        with self._lock:
            cells = [c for c in self._cells.values() if c.alive]
        for cell in cells:
            cell.fleet.close(timeout=timeout)
        self._flush_shed()
        # final rollup: absorb the tail of every cell's telemetry delta
        # (requests that retired after the last monitor pass) so the
        # region accumulator's counts match the pooled request stream
        self._publish_rollup()
        self._update_gauges()

    def __enter__(self) -> "Region":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- deterministic driving (tests / DST) -----------------------------
    def step(self) -> bool:
        """Manual-mode driver: one region poll plus one fleet step per
        live cell (the deterministic simulator's drive seam). Partitioned cells
        STILL step: their compute is local, only their network is cut."""
        self.poll()
        did = False
        with self._lock:
            cells = [c for c in self._cells.values() if c.alive]
        for cell in cells:
            did = cell.step() or did
        return did

    # -- rollout (serving/rollout.py) ------------------------------------
    def start_rollout(self, version: int,
                      fraction: Optional[float] = None,
                      load_fn=None) -> bool:
        """Begin a zero-downtime rollout to ``version`` (canary slice
        ``fraction``, defaulting to the configured one; ``load_fn``
        streams the new weights inside each replica's hot_swap). The
        controller advances on the monitor cadence — poll :attr:`rollout`
        for progress."""
        return self._rollout.start(version, fraction=fraction,
                                   load_fn=load_fn)

    def migrate_replica(self, cell_name: str, replica_name: str,
                        reason: str = "migration") -> bool:
        """Live-migrate one replica under traffic (first-class
        evacuate + re-place: drain admission, spawn the replacement on
        the victim's version, hand its KV over the quantized export
        wire, re-route the rest — zero requests lost)."""
        with self._lock:
            cell = self._cells.get(cell_name)
        if cell is None or not cell.alive:
            return False
        return cell.fleet.migrate_replica(replica_name, reason=reason)

    @property
    def rollout(self) -> RolloutController:
        return self._rollout

    @property
    def version_log(self) -> List[Dict[str, Any]]:
        """The rollout controller's justification ledger (the DST
        per-tenant monotonicity invariant reads it)."""
        return self._rollout.version_log

    # -- introspection ---------------------------------------------------
    @property
    def cells(self) -> List[ServingCell]:
        with self._lock:
            return list(self._cells.values())

    @property
    def live_cells(self) -> List[ServingCell]:
        with self._lock:
            return [c for c in self._cells.values() if c.alive]

    @property
    def brownout_floor(self) -> int:
        with self._lock:
            return self._brownout_floor

    @property
    def queue_depth(self) -> int:
        return sum(c.fleet.queue_depth for c in self.live_cells)

    @property
    def live_requests(self) -> int:
        return sum(c.fleet.live_requests for c in self.live_cells)

    def in_sla_ratio(self) -> Optional[float]:
        """Region-wide windowed SLO attainment, read from the rollup
        plane (None until a judged verdict lands in the window)."""
        return self._slo.attainment(self._clock.now())

    # -- telemetry plane: the region's rollups ---------------------------
    @property
    def slo(self) -> TenantSLOTracker:
        """The region's SLO tracker: per-tenant/per-version attainment,
        burn-rate alert state and the alert transition log."""
        return self._slo

    @property
    def slo_alert_log(self):
        return self._slo.alert_log

    @property
    def rollup_hash(self) -> str:
        """Running SHA-256 over every absorbed digest's canonical form —
        the simulator's bit-identity witness for the digest stream."""
        return self._rollup_hasher.hexdigest()

    def telemetry_snapshot(self) -> Dict[str, Any]:
        """Region-scale merged telemetry view (counters + sketch
        summaries) — answered from the digest accumulator, never from a
        replica scan."""
        return self._tel_rollup.snapshot()

    def telemetry_percentile(self, metric: str,
                             p: float) -> Optional[float]:
        """Percentile of one hot-path metric over the MERGED region
        sketch (``alpha``-bounded relative error, telemetry/registry.py).
        Metrics use the digest short names: ``ttft_s``,
        ``request_latency_s``, ``tokens_per_s``, ``queue_wait_s``,
        ``tick_s``."""
        return self._tel_rollup.percentile(metric, p)

    def block_leaks(self) -> List[str]:
        """Region-wide KV leak audit: the union of every cell's fleet
        audit, dead cells included (their evacuations must balance)."""
        problems: List[str] = []
        for cell in self.cells:
            problems.extend(cell.block_leaks())
        return problems
