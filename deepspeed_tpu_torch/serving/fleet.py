"""Multi-replica serving: one front-end, N engine replicas.

Ports ``deepspeed_tpu/serving/fleet.py`` (host Python; the port keeps its
own copy). ``ServingFleet`` exposes the ``submit / stream / cancel / drain
/ close`` surface of one :class:`~.server.ServingEngine` over N replicas,
each a :class:`~deepspeed_tpu_torch.inference.ragged.RaggedInferenceEngine`
on the fleet's device (the card unless ``device="cpu"`` is asked for):

* routing (:mod:`.router`) — least-loaded, prefix-affinity consistent
  hashing, or residency-aware over the global KV tier's directory. Refused
  picks past the first draw from the request's own :class:`RetryBudget`
  with jittered exponential backoff (seeded by the fleet's name, so the
  backoff sequence is the JAX package's). A dead replica's in-flight
  requests fail over to the survivors through the re-prefill resume path
  (its KV is suspect and never published), and the greedy streams
  continue unchanged.
* disaggregated prefill/decode — prefill replicas compute prompt KV and
  hand the pages to a decode replica through the engine's ``export_kv`` /
  ``import_kv`` (a failed import degrades to a re-prefill there).
* the gray-failure plane (:mod:`.health`) — health scores with
  quarantine and probation, routing circuit breakers, hedged dispatch of
  interactive requests whose first token is late.
* versions — a tenant-sticky canary slice (``set_canary``), per-version
  in-SLA windows, live migration (``migrate_replica``).
* elastic sizing — :meth:`ServingFleet.autoscale_once` sizes the serving
  pool with :func:`deepspeed_tpu_torch.elasticity.compute_serving_replicas`
  (queue depth, KV demand, in-SLA ratio); :meth:`ServingFleet.scale_to`
  grows through the factory and shrinks by graceful drain. Dead capacity
  below ``min_replicas`` is respawned with exponential backoff.

Threading: the fleet owns one monitor thread (chaos, health, respawn,
gray plane, hedges, residency publishing, autoscale); each replica keeps
its own driver, which launches its engine's work on the fleet's device.
Lock order is strictly fleet -> replica: the callbacks replica drivers
invoke (``on_handoff`` / ``on_retire``) run outside the replica's serving
lock. With ``start=False`` nothing runs on its own and :meth:`step`
drives one poll and one tick per replica.

A region's hooks (``on_retire``, ``on_handoff_escalation``,
``on_route_escalation``, the cell ``name``) are plain arguments here;
:class:`~.region.Region` sets them for each of its cells' fleets.

Telemetry: the fleet's counters and gauges live under
``serving[/<name>]/fleet/...`` (``routed``, ``affinity_{hits,misses}``,
``handoffs``, ``failovers``, ``respawns``, ``scale_{ups,downs}``,
``hedges``, ...; gauges ``replicas`` and ``queue_depth``), the residency
router's outcomes under ``serving/route/...``, each replica's under
``serving/<replica>/...``.
"""

from __future__ import annotations

import collections
import itertools
import random
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..config import FleetConfig, ServingConfig
from ..elasticity import ServingElasticityConfig, compute_serving_replicas
from ..inference.ragged import block_balance_report
from ..resilience.chaos import get_fault_injector
from ..resilience.clock import Clock, get_clock
from ..resilience.counters import record_restart
from ..resilience.locksan import named_rlock
from ..resilience.retry import RetryBudget
from ..telemetry import get_telemetry
from ..telemetry.digest import DigestSource
from ..telemetry.tracing import get_tracer, request_event
from ..utils.device import resolve_device
from ..utils.logging import log_dist, logger
from .kvtier import KVTier
from .health import (BreakerState, CircuitBreaker, HealthState, HedgePair,
                     ReplicaHealth)
from .request import Request, RequestState
from .router import (NoHealthyReplica, PrefixAffinityRouter,
                     ResidencyAwareRouter, RouterPolicy, _hash64,
                     least_loaded_pick, make_router, prefix_key)
from .server import ServingEngine, emit_request_span, stream_tokens


def route_budget_for(req: Request, size: int) -> RetryBudget:
    """The request's route-retry budget, created at first need and
    carried on the request itself. ONE budget per request LIFECYCLE,
    drawn from by every tier that re-routes it — this fleet's replica
    loop, a region's cell loop, failover and hand-off continuations —
    so a refusing or partitioned target is given up on explicitly
    rather than hammered forever. Scoping the pool to the request (not
    the fleet/region) matters: a process-lifetime pool would let past
    refusals accumulated across OTHER requests permanently starve
    future, healthy work of its retries."""
    budget = getattr(req, "_route_budget", None)
    if budget is None:
        budget = RetryBudget(size)
        req._route_budget = budget
    return budget


class ReplicaState:
    HEALTHY = "healthy"
    DRAINING = "draining"
    DEAD = "dead"


class Replica:
    """One engine + its serving front-end, plus fleet-side bookkeeping."""

    def __init__(self, name: str, engine, serving: ServingEngine,
                 role: str = "unified"):
        self.name = name
        self.engine = engine
        self.serving = serving
        self.role = role                  # "unified" | "prefill" | "decode"
        self.state = ReplicaState.HEALTHY
        self.index = int(name.rsplit("-", 1)[-1]) if "-" in name else 0

    @property
    def accepting(self) -> bool:
        return self.state == ReplicaState.HEALTHY and self.serving._accepting

    @property
    def version(self) -> int:
        """The model version this replica serves (hot_swap bumps it)."""
        return self.serving.model_version

    @property
    def load(self) -> int:
        # pending_work, not queue+live: the adoption/handoff pens hold
        # admitted requests too, and both routing and scale-down reaping
        # must see them
        return self.serving.pending_work

    @property
    def driver_alive(self) -> bool:
        d = self.serving._driver
        return d is not None and d.is_alive()


class ServingFleet:
    """Replicated serving front-end; same call surface as ServingEngine.

    ``engine_factory()`` must return a FRESH
    :class:`~deepspeed_tpu_torch.inference.ragged.RaggedInferenceEngine`
    (own KV pool, same model weights) per call — replicas share nothing
    but parameters. ``serving_config`` is the per-replica ServingConfig
    (dict or object); ``config`` the
    :class:`~deepspeed_tpu_torch.config.FleetConfig` (dict or object).
    ``device`` defaults to ``"cuda"`` (raising without a CUDA device
    unless ``device="cpu"`` is asked for); every replica's engine must be
    on it, and every replica's ServingEngine is built for it. With
    ``start=False`` nothing ticks on its own: tests drive
    deterministically via :meth:`step` (one poll + one tick per replica).
    """

    def __init__(self, engine_factory, config: Any = None,
                 serving_config: Any = None,
                 router: Optional[RouterPolicy] = None,
                 preemption_guard: Any = None,
                 start: bool = True,
                 clock: Optional[Clock] = None,
                 name: Optional[str] = None,
                 on_retire=None,
                 on_handoff_escalation=None,
                 on_route_escalation=None,
                 device=None):
        self.device = resolve_device(device)
        if config is None:
            config = FleetConfig()
        elif isinstance(config, dict):
            config = FleetConfig.from_dict(config)
        self.config = config
        if serving_config is None:
            serving_config = ServingConfig()
        elif isinstance(serving_config, dict):
            serving_config = ServingConfig.from_dict(serving_config)
        self._serving_config = serving_config
        self._factory = engine_factory
        self._guard = preemption_guard
        self._start_drivers = start
        # cell identity: a named
        # fleet IS one cell of a region — its replica names and every
        # metric it emits are namespaced serving/<name>/... so N cells
        # never stomp one gauge, and the trace tracks read cell/replica
        self.name = name
        self._metric_root = (f"serving/{name}/fleet" if name
                             else "serving/fleet")
        # route-retry discipline: refusals past the first draw from the
        # request's OWN budget (route_budget_for) — shared by every tier
        # that re-routes it, never by other requests — with jittered
        # exponential backoff. Deterministic jitter: the rng is seeded
        # by the fleet's name, so a replay (and the JAX package's fleet of
        # the same name) draws the identical backoff sequence.
        self._route_rng = random.Random(name or "fleet")
        # region wiring: _retire_hook fires once per terminal request
        # AFTER the fleet's own bookkeeping (outside the fleet lock);
        # _handoff_escalation is offered (req, export) when no replica
        # in THIS fleet can take a disaggregated hand-off — the region
        # places it on another cell (True = taken)
        self._retire_hook = on_retire
        self._handoff_escalation = on_handoff_escalation
        self._route_escalation = on_route_escalation
        # the fleet's timebase: health/autoscale intervals, respawn
        # backoff, drain budgets, request submit stamps — and every
        # replica it spawns inherits it
        self._clock = clock if clock is not None else get_clock()
        # locksan seam: plain RLock in production, order-recording
        # wrapper under tests (resilience/locksan.py)
        self._lock = named_rlock("ServingFleet._lock")
        self._replicas: Dict[str, Replica] = {}
        self._requests: Dict[int, Tuple[Request, str]] = {}  # uid -> (req, replica)
        self._name_counter = itertools.count()
        self._accepting = True
        self._stop_evt = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self._last_autoscale = 0.0
        self._chaos_fired = False
        # sliding in-SLA window feeding the autoscaler (True/False per
        # SLO-carrying terminal request; cancels and SLO-less skipped)
        self._sla_window = collections.deque(maxlen=config.sla_window)
        # fleet-tier digest source (telemetry/digest.py): per-tenant /
        # per-version SLO verdicts recorded at retire time, published as
        # deltas up the cell→region rollup alongside the replica sketches
        self.telemetry_source = DigestSource(
            f"{name}/fleet" if name else "fleet")
        # versioned serving: _fleet_version is what NEW replicas (spawn,
        # respawn, migration replacement) serve; _canary is the active
        # (version, traffic_fraction) canary split or None; per-version
        # in-SLA windows feed the rollout controller's canary-vs-stable
        # regression check
        self._fleet_version = int(
            getattr(serving_config, "model_version", 0) or 0)
        self._canary: Optional[Tuple[int, float]] = None
        self._version_sla: Dict[int, collections.deque] = {}
        self._shed_backlog: List[Request] = []   # fleet-rejected, span due
        # gray-failure resilience plane (serving/health.py): per-replica
        # continuous health scores with quarantine/probation, routing
        # circuit breakers, and the hedged-dispatch ledger (BOTH legs'
        # uids map to their shared HedgePair gate). All three are
        # monitor-driven and fleet-lock-protected; dead replicas keep
        # their entries so transition history survives.
        self._health: Dict[str, ReplicaHealth] = {}
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._hedges: Dict[int, HedgePair] = {}
        self._hedge_done: List[HedgePair] = []
        self._hedged_total = 0
        # respawn backoff (exponential, reset once healthy; per-fleet
        # since replicas are interchangeable)
        self._respawn_after = 0.0
        self._respawn_delay = 0.5
        if router is not None:
            self.router = router
        else:
            self.router = make_router(
                config.router, block_size=self._probe_block_size(),
                vnodes=config.affinity_vnodes,
                spill_load=config.affinity_spill_load)
        # global KV tier (serving/kvtier.py): one prefix
        # directory (+ optional fleet-wide host cold tier) shared by
        # every replica; built BEFORE the spawn loop so replicas wire
        # their eviction/spill hooks at construction. With the tier on,
        # an affinity router is upgraded in place to the residency-aware
        # subclass — same ring, same spill valve, directory consulted
        # first — and an explicitly "residency"-configured (or injected
        # residency-aware) router just gets the directory attached.
        self.kv_tier = None
        kv_cfg = getattr(serving_config, "kv_tier", None)
        if kv_cfg is not None and kv_cfg.enabled:
            self.kv_tier = KVTier(kv_cfg)
            if isinstance(self.router, ResidencyAwareRouter):
                self.router.set_directory(self.kv_tier.directory,
                                          self._clock.now)
            elif isinstance(self.router, PrefixAffinityRouter):
                self.router = ResidencyAwareRouter(
                    block_size=self.router.block_size,
                    vnodes=self.router.vnodes,
                    spill_load=self.router.spill_load,
                    directory=self.kv_tier.directory,
                    now_fn=self._clock.now)
        if config.disaggregated:
            for _ in range(config.prefill_replicas):
                self._spawn(role="prefill")
            for _ in range(config.replicas):
                self._spawn(role="decode")
        else:
            for _ in range(config.replicas):
                self._spawn(role="unified")
        log_dist(f"ServingFleet: {len(self._replicas)} replicas "
                 f"router={self.router.name} "
                 f"disaggregated={config.disaggregated} "
                 f"autoscale={config.autoscale}")
        if start:
            self._monitor = threading.Thread(target=self._monitor_loop,
                                             daemon=True,
                                             name="fleet-monitor")
            self._monitor.start()

    def _probe_block_size(self) -> int:
        # the affinity key must match the engines' prefix-cache unit; all
        # replicas share one config, so any instance answers. No replica
        # exists yet at router-construction time, so build one eagerly
        # only when the router actually needs the block size.
        if self.config.router not in ("prefix_affinity", "residency"):
            return 16
        eng = self._factory()
        with self._lock:
            self._pending_engine = eng
        return eng.config.kv_block_size

    # -- telemetry -------------------------------------------------------
    @property
    def _telemetry(self):
        return get_telemetry()

    def _count(self, name: str, n: float = 1.0) -> None:
        self._telemetry.registry.counter(f"{self._metric_root}/{name}").inc(n)

    def _update_gauges(self) -> None:
        t = self._telemetry
        if not t.enabled:
            return
        with self._lock:
            healthy = [r for r in self._replicas.values()
                       if r.state == ReplicaState.HEALTHY]
            depth = sum(r.serving.queue_depth for r in healthy)
        t.registry.gauge(f"{self._metric_root}/replicas").set(len(healthy))
        t.registry.gauge(f"{self._metric_root}/queue_depth").set(depth)

    # -- replica lifecycle ----------------------------------------------
    def _spawn(self, role: str = "unified") -> Replica:
        """Build one replica (engine via the factory + a namespaced
        ServingEngine) and register it with the router."""
        with self._lock:
            # the probe engine hand-off is shared between __init__ and
            # the monitor thread's respawn path — take-and-clear must be
            # atomic; the factory call itself
            # stays outside the lock (it builds a whole engine)
            engine = getattr(self, "_pending_engine", None)
            self._pending_engine = None
            fleet_version = self._fleet_version
        if engine is None:
            engine = self._factory()
        if engine.device != self.device:
            raise ValueError(f"ServingFleet on {self.device}: the engine "
                             f"factory returned an engine on "
                             f"{engine.device}")
        name = f"replica-{next(self._name_counter)}"
        if self.name:
            # cell-namespaced replica id: metrics land under
            # serving/<cell>/replica-N/... and trace tracks read the
            # same path, so a region's timeline groups by failure domain
            name = f"{self.name}/{name}"
        serving = ServingEngine(
            engine, self._serving_config,
            preemption_guard=self._guard,
            start=self._start_drivers,
            replica_id=name,
            on_handoff=(self._on_handoff if role == "prefill" else None),
            on_retire=self._on_retire,
            clock=self._clock,
            device=self.device)
        # new capacity serves the fleet's CURRENT version: a mid-rollout
        # respawn or migration replacement must not resurrect the config
        # default and silently widen (or shrink) the canary
        serving.model_version = fleet_version
        if self.kv_tier is not None:
            serving.enable_kv_tier(self.kv_tier, name)
        rep = Replica(name, engine, serving, role=role)
        with self._lock:
            self._replicas[name] = rep
            # the routing ring hashes over the replicas that PREFILL —
            # that's where prompt KV is computed and where the prefix
            # cache pays off. Disaggregated: the prefill pool; unified:
            # everyone. Decode replicas never own a ring segment (their
            # placement is least-loaded at hand-off time: the pages are
            # new to all of them).
            prefills = (role == "prefill" if self.config.disaggregated
                        else role == "unified")
            if prefills:
                self.router.on_join(name)
        self._update_gauges()
        return rep

    def _view(self, role: Optional[str] = None, live: bool = False,
              refused=(), version: Optional[int] = None) -> Dict[str, int]:
        """name -> load routing view. ``live=False``: replicas accepting
        NEW work (health-checked admission view). ``live=True``: anything
        not DEAD — the continuation view (draining replicas finish
        admitted work, they just take no new admissions). ``role``
        filters; None = any serving (non-prefill) role. ``refused`` names
        are excluded (stop-race retry loops). ``version`` restricts to
        replicas serving exactly that model version — the canary split
        and the version-affine continuation path.

        The gray-failure plane filters HERE, on the NEW-work view only,
        which is what both routers walk — so quarantine and open
        breakers are consulted ahead of the ring walk without the
        router ever knowing they exist. Continuations (``live=True``)
        still reach a quarantined replica: it is degraded, not dead,
        and moving admitted streams would turn a p99 problem into
        recompute load."""
        gray = not live and (self.config.quarantine or self.config.breakers)
        now = self._clock.now() if gray else 0.0
        out = {}
        for r in self._replicas.values():
            if r.name in refused:
                continue
            if (r.state == ReplicaState.DEAD) if live else not r.accepting:
                continue
            if role is not None and r.role != role:
                continue
            if role is None and r.role == "prefill":
                continue
            if version is not None and r.version != version:
                continue
            if gray and not self._gray_admits_locked(r.name, now):
                continue
            out[r.name] = r.load
        return out

    def _gray_admits_locked(self, name: str, now: float) -> bool:
        """NEW-work eligibility per the gray plane (fleet lock held):
        quarantined replicas are drained out of the view; an open
        breaker excludes until its cooldown elapses, then admits the
        single deterministic half-open probe."""
        if self.config.quarantine:
            h = self._health.get(name)
            if h is not None and not h.routable:
                return False
        if self.config.breakers:
            b = self._breakers.get(name)
            if b is not None and not b.admits(now):
                return False
        return True

    # -- versioned serving: canary, versions, migration ------------------
    def set_canary(self, version: int, fraction: float) -> None:
        """Open a canary split: ``fraction`` of NEW traffic routes to
        replicas serving ``version``, the rest to the stable version.
        The slice is tenant-sticky (hash of the tenant key, not a coin
        flip per request), so one tenant sees ONE version for the whole
        rollout."""
        with self._lock:
            self._canary = (int(version), max(0.0, min(1.0, fraction)))

    def clear_canary(self) -> None:
        with self._lock:
            self._canary = None

    def set_fleet_version(self, version: int) -> None:
        """Move the version NEW capacity serves (promotion / rollback).
        Existing replicas are untouched — the rollout controller flips
        them one by one through drain + ``hot_swap``."""
        with self._lock:
            self._fleet_version = int(version)

    @property
    def fleet_version(self) -> int:
        with self._lock:
            return self._fleet_version

    def version_counts(self) -> Dict[int, int]:
        """model version -> live (non-DEAD) replica count — the rollout
        controller's progress view."""
        with self._lock:
            out: Dict[int, int] = {}
            for r in self._replicas.values():
                if r.state != ReplicaState.DEAD:
                    out[r.version] = out.get(r.version, 0) + 1
            return out

    def version_sla(self, version: int) -> Tuple[int, Optional[float]]:
        """(samples, in-SLA ratio) for SLO-carrying requests served by
        ``version`` — the canary regression check compares this between
        canary and stable."""
        with self._lock:
            win = self._version_sla.get(int(version))
            if not win:
                return 0, None
            return len(win), sum(win) / len(win)

    def _canary_slice(self, req: Request) -> bool:
        """Whether ``req`` falls in the canary traffic slice.
        Tenant-sticky: keyed on ``req.tenant`` (falling back to the
        stable ``client_request_id``) through the same process-stable
        hash the affinity ring uses, so the split is deterministic
        across replays and restarts."""
        canary = self._canary
        if canary is None:
            return False
        key = req.tenant if req.tenant is not None else req.client_request_id
        return (_hash64(f"canary:{key}") % 1000) < canary[1] * 1000.0

    def _versioned_view(self, role, live, refused, hard, soft,
                        req: Optional[Request] = None) -> Dict[str, int]:
        """Version-constrained routing view (fleet lock held). A HARD
        version (continuation affinity) never falls back — serving the
        stream from another version is the one thing routing must never
        do; a SOFT one (canary preference) degrades to the
        unconstrained view when the preferred version has no accepting
        capacity (canary still warming, stable side mid-flip). A spill
        is stamped on the request (``_canary_spilled``): an
        availability-over-affinity placement, not a version choice."""
        want = hard if hard is not None else soft
        view = self._view(role, live=live, refused=refused, version=want)
        if not view and want is not None and hard is None:
            view = self._view(role, live=live, refused=refused)
            if view:
                self._count("canary_spills")
                if req is not None:
                    req._canary_spilled = True
        return view

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
        """Route a request to a replica. Same contract as
        ``ServingEngine.submit``: returns immediately, possibly already
        REJECTED (no healthy replica, or the target's backpressure)."""
        req = Request(
            prompt=list(prompt),
            max_new_tokens=(max_new_tokens if max_new_tokens is not None
                            else self._serving_config.default_max_new_tokens),
            eos_token_id=eos_token_id, priority=priority,
            deadline_s=deadline_s, ttft_deadline_s=ttft_deadline_s,
            client_request_id=client_request_id, tenant=tenant,
            on_token=on_token)
        # adopt the fleet's clock before stamping (same timebase rule as
        # ServingEngine.submit_request: injected clock != global clock
        # must not split a request's lifecycle across two timebases)
        req._clock = self._clock
        req.t_submit = self._clock.now()
        # tracing: the root opens HERE, before routing, so the router
        # decision is the tree's first child even for fleet-level sheds
        tracer = get_tracer()
        if tracer.enabled:
            req._trace_root = tracer.new_trace(
                "request", prompt_tokens=len(req.prompt),
                priority=req.priority)
        self._route(req)
        self._flush_shed()
        return req

    def route_request(self, req: Request, requeue: bool = False,
                      shed: bool = True) -> bool:
        """Public routing entry for an EXISTING request — the region's
        cell tier hands pre-built requests here after its own cell pick
        (two-tier routing: cell ring, then this fleet's router). With
        ``shed=False`` a placement failure returns False with the
        request untouched (still QUEUED) so the caller can try another
        cell, instead of terminally rejecting it here."""
        return self._route(req, requeue=requeue, shed=shed)

    def _route(self, req: Request, requeue: bool = False,
               shed: bool = True, refused=()) -> bool:
        """Pick a replica and enqueue. ``requeue`` marks the continuation
        of an already-admitted request (fail-over, hand-off fallback): it
        bypasses the fleet and replica admission gates — a draining fleet
        must serve out admitted work — and may land on DRAINING (never
        DEAD) replicas. A pick whose driver stopped between the view
        snapshot and the enqueue refuses non-terminally; the loop places
        the request elsewhere — but NOT for free: every retry past the
        first pick draws from the request's own :class:`RetryBudget`
        (:func:`route_budget_for` — shared with the region tier's cell
        loop) with jittered exponential backoff between attempts, so a
        refusing (stopping, partitioned) target is given up on
        explicitly instead of hammered in a tight loop. ``shed=False``:
        failures return False with the request untouched (region
        multi-cell retry)."""
        tracer = get_tracer()
        if requeue:
            request_event(req, "reroute")
        refused = set(refused)   # hedge shadows pre-refuse the primary's
        backoff = self.config.route_backoff_s   # replica (failure domain)
        while True:
            # the router decision is a span of its own on the request's
            # tree: replica pick + (for the affinity ring) hit/miss/spill
            # verdict, one span per routing attempt
            route_span = tracer.begin_span(
                "route", getattr(req, "_trace_root", None),
                requeue=bool(requeue), attempt=len(refused))
            fail: Optional[str] = None
            name = ""
            with self._lock:
                if not self._accepting and not requeue:
                    fail = "fleet closed to new requests"
                else:
                    # version constraints: a continuation with
                    # tokens out is HARD-bound to the version that
                    # emitted them (a mixed-version stream is the
                    # two-version violation); fresh work gets a SOFT
                    # canary-vs-stable preference that degrades to any
                    # capacity rather than shedding
                    hard = (req.model_version
                            if requeue and req.tokens
                            and req.model_version is not None else None)
                    soft = None
                    if hard is None and self._canary is not None:
                        soft = (self._canary[0] if self._canary_slice(req)
                                else self._fleet_version)
                        if soft == self._canary[0]:
                            self._count("canary_assigned")
                    if self.config.disaggregated:
                        # prefill pool first — routed by the CONFIGURED
                        # router below (affinity composes with
                        # disaggregation: the ring hashes the prefill
                        # replicas, where repeat prefixes find their
                        # cached KV); the handoff hook ships the result
                        # onward
                        view = self._versioned_view(
                            "prefill", requeue, refused, hard, soft, req)
                        if not view:
                            # degrade: unified path on whatever can serve
                            view = self._versioned_view(
                                None, requeue, refused, hard, soft, req)
                            req._handoff_requested = False
                        else:
                            req._handoff_requested = True
                    else:
                        view = self._versioned_view(
                            None, requeue, refused, hard, soft, req)
                    if not view:
                        fail = ("no healthy replica" if hard is None else
                                f"no live replica serving version {hard}")
                    else:
                        try:
                            name = self.router.route(view, req.prompt)
                        except NoHealthyReplica:
                            fail = "no healthy replica"
                if fail is None:
                    if isinstance(self.router, PrefixAffinityRouter):
                        self._count("affinity_hits"
                                    if self.router.last_was_primary
                                    else "affinity_misses")
                    if isinstance(self.router, ResidencyAwareRouter) \
                            and self.router.last_outcome is not None:
                        # per-outcome routing ledger (the residency
                        # router's fallback matrix): registry
                        # counters are the operator surface, the digest
                        # copy rides the fleet→cell→region rollup so the
                        # region can report global-vs-local hit rates
                        outcome = {"residency": "residency_hit",
                                   "affinity": "affinity_hit",
                                   "directory_stale": "directory_stale"}[
                                       self.router.last_outcome]
                        t = self._telemetry
                        if t.enabled:
                            t.registry.counter(
                                f"serving/route/{outcome}").inc()
                        self.telemetry_source.count(f"route/{outcome}")
                    # router verdict captured under the lock (router
                    # state mutates per route()); the span finishes only
                    # after the enqueue, so a refused pick is marked as
                    # such and the trace shows which replica ACCEPTED
                    route_info = self.router.route_info()
                    self._requests[req.uid] = (req, name)
                    replica = self._replicas[name]
                    if self.config.breakers:
                        b = self._breakers.get(name)
                        if b is not None:
                            # no-op unless half-open: this request IS
                            # the breaker's single deterministic probe
                            b.claim_probe()
            if fail is not None:
                # failure handling OUTSIDE the fleet lock: the requeue
                # escalation hook re-routes through the REGION (its lock
                # sits ABOVE ours in the documented order)
                tracer.finish_span(route_span, error=fail)
                return self._shed_or_escalate(req, requeue, shed, fail)
            accepted = replica.serving.submit_request(
                req, requeue=requeue) is not None
            tracer.finish_span(route_span, replica=name,
                               accepted=accepted, **route_info)
            if accepted:
                self._count("routed")
                if self.kv_tier is not None:
                    self._maybe_adopt_prefix(req, name)
                return True
            refused.add(name)      # stopped mid-race: try the next one
            self._breaker_event(name, ok=False)
            with self._lock:
                ent = self._requests.get(req.uid)
                if ent is not None and ent[1] == name:
                    del self._requests[req.uid]
            if not route_budget_for(
                    req, self.config.route_retry_budget).take("fleet_route"):
                request_event(req, "route_budget_exhausted")
                logger.warning(
                    f"ServingFleet{f'[{self.name}]' if self.name else ''}: "
                    f"route retry budget exhausted for request {req.uid}")
                if shed:
                    self._reject(req, "route retry budget exhausted")
                return False
            self._count("route_retries")
            d = backoff
            if d > 0:
                d *= 1.0 + self._route_rng.uniform(
                    0.0, self.config.route_backoff_jitter)
                self._clock.sleep(d)
            backoff = min(backoff * 2.0, 1.0)

    def _shed_or_escalate(self, req: Request, requeue: bool, shed: bool,
                          reason: str) -> bool:
        """A placement failure's endgame. ``shed=False``: hand the
        untouched request back to the caller (the region's multi-cell
        loop). Continuations (``requeue``) of a region-managed fleet
        first get offered one tier up — a cell with no replica left must
        not shed work another cell could finish — and only then retire
        with a REJECTED span (explicit, never silent). Runs WITHOUT the
        fleet lock: the escalation re-enters routing through the region,
        whose lock sits above ours."""
        if not shed:
            return False
        if requeue and self._route_escalation is not None:
            # ownership leaves this fleet: drop our table row BEFORE the
            # hand-over. The region may place the request on another
            # cell, whose retire hook never reaches this table — a row
            # left behind would leak for the fleet's lifetime and
            # resolve cancels to a replica that no longer owns the work.
            # (If the region routes it back here, placement writes a
            # fresh row.)
            with self._lock:
                self._requests.pop(req.uid, None)
            try:
                if self._route_escalation(req):
                    self._count("route_escalations")
                    return True
            except Exception:
                logger.exception(
                    f"ServingFleet: route escalation failed for request "
                    f"{req.uid}")
        self._reject(req, reason)
        return False

    # -- global KV tier ---------------------------------------------------
    def _maybe_adopt_prefix(self, req: Request, target: str) -> None:
        """Best-effort cross-replica prefix prefetch, fired AFTER the
        request was accepted (never on its critical path): when the
        directory says a DIFFERENT healthy replica holds the prompt's
        full-block prefix, pen a prefix export on that donor; its driver
        gathers the quantized pages outside its lock and the on_ready
        callback pens the import on the target's driver. Every leg is
        droppable — a dead donor, refused pen, failed gather, corrupt
        wire or full pool all end in the target prefilling locally.
        Runs OUTSIDE the fleet lock (takes it briefly for the replica
        lookup); the donor's driver later runs on_ready, which only
        touches the target's own pen lock."""
        tier = self.kv_tier
        if tier is None or not tier.config.adoption:
            return
        router = self.router
        if not isinstance(router, ResidencyAwareRouter):
            return
        if router.last_outcome == "residency":
            return                 # the target already holds the prefix
        key = prefix_key(req.prompt, router.block_size)
        if len(key) < router.block_size:
            return                 # nothing a prefix cache could hold
        fresh, _ = tier.directory.holders(_hash64(",".join(map(str, key))),
                                          self._clock.now())
        donor_serving = target_serving = None
        with self._lock:
            tgt = self._replicas.get(target)
            if tgt is not None and tgt.state != ReplicaState.DEAD:
                target_serving = tgt.serving
            for m in fresh:
                if m == target:
                    continue
                rep = self._replicas.get(m)
                if rep is not None and rep.state == ReplicaState.HEALTHY:
                    donor_serving = rep.serving
                    break
        if donor_serving is None or target_serving is None:
            return

        def _on_ready(export, _t=target_serving):
            if export is None:
                return             # donor evicted it meanwhile: plain miss
            _t.adopt_prefix(export)

        if donor_serving.request_prefix_export(list(key), _on_ready):
            self._count("adopt_prefetches")
            self.telemetry_source.count("kvtier/adopt_requested")

    def _kvtier_drop(self, name: str) -> None:
        """Directory scrub at the replica-death/retire boundary: the
        member's entries must never outlive its pages. Idempotent; the
        directory lock is a leaf, so this is legal under the fleet
        lock."""
        if self.kv_tier is not None:
            self.kv_tier.drop_member(name)

    def stream(self, prompt: Sequence[int], **kwargs):
        """Generator yielding tokens as they are emitted (see
        ``ServingEngine.stream``)."""
        return stream_tokens(self, prompt, **kwargs)

    def cancel(self, req) -> bool:
        """Cancel by Request or uid, wherever the request currently
        lives. A request in flight between replicas (handoff/failover)
        carries the flag with it and dies at its next boundary."""
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
            replica = self._replicas.get(ent[1]) if ent is not None else None
        if replica is not None:
            replica.serving.cancel(req)
        return True

    # -- shutdown --------------------------------------------------------
    def drain(self, timeout: Optional[float] = None,
              reject_queued: bool = False) -> bool:
        """Stop admission fleet-wide and serve out every backlog. Prefill
        replicas drain first so their handoffs land before the decode
        replicas are judged empty."""
        with self._lock:
            self._accepting = False
            replicas = list(self._replicas.values())
        for r in replicas:
            if r.state == ReplicaState.HEALTHY:
                r.serving.stop_admission()
        budget = (timeout if timeout is not None
                  else self._serving_config.drain_timeout_s)
        deadline = self._clock.deadline(budget)
        ordered = ([r for r in replicas if r.role == "prefill"]
                   + [r for r in replicas if r.role != "prefill"])
        ok = True
        for r in ordered:
            if r.state == ReplicaState.DEAD:
                continue
            left = max(0.0, deadline - self._clock.now())
            ok = r.serving.drain(timeout=left, reject_queued=reject_queued) \
                and ok
        return ok

    def close(self, timeout: Optional[float] = None) -> None:
        """Graceful shutdown: drain, then close every replica and stop
        the monitor."""
        self.drain(timeout=timeout)
        self._stop_evt.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
            self._monitor = None
        with self._lock:
            replicas = list(self._replicas.values())
        for r in replicas:
            if r.state != ReplicaState.DEAD:
                r.serving.close(timeout=timeout)
        self._flush_shed()
        self._update_gauges()

    def __enter__(self) -> "ServingFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- introspection ---------------------------------------------------
    @property
    def replicas(self) -> List[Replica]:
        with self._lock:
            return list(self._replicas.values())

    @property
    def healthy_replicas(self) -> List[Replica]:
        with self._lock:
            return [r for r in self._replicas.values()
                    if r.state == ReplicaState.HEALTHY]

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return sum(r.serving.queue_depth for r in self._replicas.values()
                       if r.state != ReplicaState.DEAD)

    @property
    def live_requests(self) -> int:
        with self._lock:
            return sum(r.serving.live_requests
                       for r in self._replicas.values()
                       if r.state != ReplicaState.DEAD)

    def block_leaks(self) -> List[str]:
        """Fleet-wide KV leak audit: the union of every replica's
        block-balance problems, each prefixed with its replica name
        (empty list = zero leaks everywhere, dead replicas included —
        evacuation discards their sequences, so their allocators must
        balance too). Valid when idle; mid-tick reads race drivers."""
        problems: List[str] = []
        for r in self.replicas:
            for p in block_balance_report(r.engine)["problems"]:
                problems.append(f"{r.name}: {p}")
        return problems

    def digest_fields(self) -> Dict[str, Any]:
        """One summarizing pass over this fleet for the cell digest:
        every replica is visited
        ONCE, here, on the publish cadence — the region's per-route path
        reads the published digest and never scans replicas."""
        with self._lock:
            replicas = list(self._replicas.values())
            accepting = self._accepting
            quarantined = sum(
                1 for r in replicas
                if r.state == ReplicaState.HEALTHY
                and (h := self._health.get(r.name)) is not None
                and h.state == HealthState.QUARANTINED)
        queue = live = pending = healthy = 0
        kv = 0.0
        for r in replicas:
            if r.state == ReplicaState.DEAD:
                continue
            q, lv, pw = r.serving.snapshot()
            queue += q
            live += lv
            pending += pw
            if r.state == ReplicaState.HEALTHY:
                healthy += 1
                kv = max(kv, float(r.engine.kv_demand()))
        return {"queue_depth": queue, "live": live, "pending_work": pending,
                "healthy_replicas": healthy, "kv_demand": kv,
                "in_sla": self.in_sla_ratio(),
                "accepting": accepting and healthy > 0,
                "quarantined": quarantined}

    def in_sla_ratio(self) -> Optional[float]:
        """Fraction of recent SLO-carrying requests that met their SLO
        (None until one lands) — the autoscaler's quality signal."""
        with self._lock:
            if not self._sla_window:
                return None
            return sum(self._sla_window) / len(self._sla_window)

    def collect_telemetry_digest(self, t: float):
        """One rollup pass over this fleet (cell tier calls it on the
        monitor cadence): publish-and-merge every live replica's digest
        delta plus the fleet's own verdict source into ONE fixed-size
        digest for the region. The per-replica walk happens HERE, never
        on a region read."""
        with self._lock:
            replicas = list(self._replicas.values())
        out = self.telemetry_source.publish(t)
        for r in replicas:
            # DEAD replicas included: a replica that died after emitting
            # spans still holds unpublished deltas, and deltas already
            # observed are valid history — skipping them would undercount
            # the pooled stream
            out.merge(r.serving.digest.publish(t))
        return out

    # -- replica-driver callbacks (OUTSIDE the replica's serving lock) ---
    def _on_retire(self, req: Request) -> None:
        # hedge conservation (serving/health.py HedgePair): a terminal
        # leg decides a still-undecided race; a DECIDED loser's verdict
        # is suppressed — the SLO ledger judges the client request once,
        # on the winning leg (the loser's span was already gated at the
        # replica). Table cleanup below still runs for both legs.
        gate = getattr(req, "_hedge", None)
        if gate is not None:
            gate.settle(req.uid)
        suppressed = gate is not None and gate.is_suppressed(req.uid)
        # same verdict discipline as the request span: completions judged
        # against their deadlines, sheds with an SLO count as misses,
        # user cancels not judged
        had_slo = (req.deadline_s is not None
                   or req.ttft_deadline_s is not None)
        if suppressed:
            verdict = None
        elif req.state is RequestState.FINISHED:
            verdict = req.in_slo()
        elif had_slo and not (req.state is RequestState.CANCELLED
                              and req.error is None):
            verdict = False
        else:
            verdict = None
        with self._lock:
            ent = self._requests.pop(req.uid, None)
            if verdict is not None:
                self._sla_window.append(bool(verdict))
                self._note_version_sla(req, bool(verdict))
        if verdict is not None:
            # rollup-plane verdict (outside the fleet lock — the source
            # has its own leaf lock): per-tenant attainment and the
            # canary judge both read this via the region's SLO tracker
            self.telemetry_source.slo_verdict(req.tenant,
                                              req.model_version,
                                              bool(verdict))
            self.telemetry_source.count("slo_judged")
            if verdict:
                self.telemetry_source.count("slo_met")
        if self.config.breakers and ent is not None and not suppressed:
            # breaker evidence from real outcomes: a clean finish closes
            # (or keeps closed) the serving replica's breaker, an
            # errored death (tick-fault budget spent, injected fault)
            # counts against it. Sheds and user cancels are not the
            # replica's fault and stay neutral.
            if req.state is RequestState.FINISHED:
                self._breaker_event(ent[1], ok=True)
            elif req.state is RequestState.CANCELLED and req.error:
                self._breaker_event(ent[1], ok=False)
        if self._retire_hook is not None:
            # region bookkeeping, chained OUTSIDE the fleet lock (the
            # hook takes the Region lock; region -> cell -> fleet is the
            # documented order, so fleet-under-region would invert it)
            try:
                self._retire_hook(req)
            except Exception:
                logger.exception(
                    f"ServingFleet: retire hook failed (request {req.uid})")

    def _note_version_sla(self, req: Request, ok: bool) -> None:
        """Fold one SLO verdict into the request's version window (fleet
        lock held) — the rollout controller's canary-vs-stable signal."""
        v = req.model_version
        if v is None:
            return
        win = self._version_sla.get(v)
        if win is None:
            win = self._version_sla[v] = collections.deque(
                maxlen=self.config.sla_window)
        win.append(bool(ok))

    def place_handoff(self, req: Request, export,
                      allow_prefill_fallback: bool = True) -> bool:
        """Place a prefilled (request, KV export) pair on a live replica
        of THIS fleet for decode — least-loaded (the pages are new to
        every decode replica, affinity buys nothing here).
        ``allow_prefill_fallback`` lets a prefill replica decode it
        itself as the last resort (clearing the flag, or its next
        first-token would hand off again in an endless loop); the
        region's escalation path disables the fallback on the FIRST
        local attempt so healthy decode capacity on another cell is
        preferred over cannibalizing the local prefill pool. Returns
        False with the request untouched when nothing qualifies — the
        cross-cell adoption path calls this on another cell's fleet, so
        refusal must stay non-terminal here."""
        # a hand-off with tokens out is HARD version-affine (same
        # contract as routing): the adopting replica must serve the
        # version that emitted them, or adopt() refuses anyway
        hard = (req.model_version if req.tokens
                and req.model_version is not None else None)
        refused: set = set()
        while True:
            with self._lock:
                view = self._view("decode", live=True, refused=refused,
                                  version=hard)
                if not view and allow_prefill_fallback:
                    view = self._view("prefill", live=True,
                                      refused=refused, version=hard)
                    req._handoff_requested = False
                if not view:
                    return False
                name = least_loaded_pick(view)
                self._requests[req.uid] = (req, name)
                replica = self._replicas[name]
            if replica.serving.adopt(req, export):
                self._count("handoffs")
                return True
            # the pick stopped between the view snapshot and adopt()
            # (scale-down reap / kill race): place it elsewhere
            refused.add(name)
            with self._lock:
                ent = self._requests.get(req.uid)
                if ent is not None and ent[1] == name:
                    del self._requests[req.uid]

    def _on_handoff(self, req: Request, export) -> None:
        """A prefill replica finished a flagged request's prompt: ship
        the KV to a decode replica. A hand-off is the CONTINUATION of an
        admitted request, so draining replicas (admission closed,
        serving out) still take it — only dead ones are excluded.
        Placement preference: the local decode pool, then (region mode)
        ESCALATION to another cell's decode pool — cross-cell KV
        adoption, partition-checked by the region — then a local
        prefill replica decoding it itself (the KV is already here),
        then a route escalation for a full re-prefill on another cell;
        only when nobody anywhere can take it is the request shed, with
        a span, never silently (degraded, never lost)."""
        if self.place_handoff(req, export,
                              allow_prefill_fallback=(
                                  self._handoff_escalation is None)):
            return
        if self._handoff_escalation is not None:
            # same table discipline as _shed_or_escalate: the region may
            # place the pair on another cell, so this fleet's row (still
            # naming the prefill replica) must go before the hand-over —
            # any placement back here writes a fresh row
            with self._lock:
                self._requests.pop(req.uid, None)
            try:
                if self._handoff_escalation(req, export):
                    return
            except Exception:
                logger.exception(
                    f"ServingFleet: handoff escalation failed for "
                    f"request {req.uid}")
            # the region had nowhere better either: local prefill-pool
            # decode is now the preferred fallback — the KV is already
            # here (a cross-cell re-prefill would recompute it on the
            # slow path, or ping-pong back to this very pool)
            if self.place_handoff(req, export,
                                  allow_prefill_fallback=True):
                return
        # nothing HERE can decode it: drop the export and escalate the
        # route for a full re-prefill continuation elsewhere (region
        # mode), else shed with a span — never silently
        req._handoff_requested = False
        self._shed_or_escalate(req, requeue=True, shed=True,
                               reason="no live replica for decode handoff")
        self._flush_shed()

    def _reject(self, req: Request, reason: str) -> None:
        """Fleet-level shed (no replica ever owned the request). Same
        observable contract as a replica-level reject: span emitted into
        requests.jsonl and — when the request carried an SLO — a miss in
        the autoscaler's in-SLA window (shedding is exactly the signal
        that must drive scale-up). The span write is DEFERRED to
        :meth:`_flush_shed` — most callers hold the fleet lock, and sink
        I/O under it would stall every submit/cancel/poll exactly when
        the system sheds load (same discipline as the replica span
        backlog)."""
        req.error = reason
        req.transition(RequestState.REJECTED)
        self._count("rejected")
        with self._lock:    # reentrant: most (not all) callers hold it
            self._shed_backlog.append(req)

    def _flush_shed(self) -> None:
        """Emit deferred fleet-shed spans OUTSIDE the fleet lock (the
        requests are terminal and immutable by now)."""
        if not self._shed_backlog:
            return
        with self._lock:
            backlog, self._shed_backlog = self._shed_backlog, []
        for req in backlog:
            emit_request_span(self._telemetry, req)
            self._on_retire(req)

    # -- health / chaos / failover --------------------------------------
    def shutdown_abrupt(self, reason: str = "cell outage") -> List[Request]:
        """Whole-fleet death — the CELL-outage shape (correlated replica
        death: the entire failure domain went dark at once). Every
        replica is flipped DEAD and killed, every non-terminal request
        harvested and returned UNROUTED (state QUEUED, engine state
        discarded — the whole cell's KV is suspect): there are no
        survivors here to fail over to, so placement is the REGION's
        job, one tier up. The monitor stops; the fleet is done."""
        with self._lock:
            self._accepting = False
            replicas = list(self._replicas.values())
            for rep in replicas:
                if rep.state != ReplicaState.DEAD:
                    rep.state = ReplicaState.DEAD
                    self.router.on_leave(rep.name)
                    self._kvtier_drop(rep.name)
        self._stop_evt.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
            self._monitor = None
        orphans: List[Request] = []
        for rep in replicas:
            rep.serving.kill()
            orphans.extend(rep.serving.evacuate())
        with self._lock:
            self._requests.clear()
        logger.warning(f"ServingFleet{f'[{self.name}]' if self.name else ''}"
                       f": abrupt shutdown ({reason}); "
                       f"{len(orphans)} requests harvested")
        self._update_gauges()
        return orphans

    def steal_queued(self, max_n: int) -> List[Request]:
        """Harvest up to ``max_n`` QUEUED requests off this fleet's most
        loaded replicas (the region's heal-time rebalance seam — see
        ``ServingEngine.steal_queued`` for the per-replica contract).
        The stolen requests stay QUEUED and must be re-routed by the
        caller."""
        out: List[Request] = []
        with self._lock:
            replicas = sorted(
                (r for r in self._replicas.values()
                 if r.state == ReplicaState.HEALTHY),
                key=lambda r: (-r.load, r.name))
        for rep in replicas:
            if len(out) >= max_n:
                break
            got = rep.serving.steal_queued(max_n - len(out))
            with self._lock:
                for req in got:
                    self._requests.pop(req.uid, None)
            out.extend(got)
        return out

    def kill_replica(self, name: str, reason: str = "killed") -> bool:
        """Abrupt replica death (tests, chaos, ops). In-flight work fails
        over to the survivors when ``config.failover`` is on."""
        with self._lock:
            rep = self._replicas.get(name)
            if rep is None or rep.state == ReplicaState.DEAD:
                return False
            rep.state = ReplicaState.DEAD
            self.router.on_leave(name)
            self._kvtier_drop(name)
        logger.warning(f"ServingFleet: replica {name} died ({reason})")
        rep.serving.kill()
        orphans = rep.serving.evacuate()
        self._failover_orphans(orphans, source=name)
        self._update_gauges()
        return True

    def migrate_replica(self, name: str,
                        reason: str = "migration") -> bool:
        """Live replica migration — evacuate + re-place UNDER traffic,
        promoted from the failure path to a first-class operation. The
        order is
        spawn-first: a same-role, same-version replacement joins the
        router, THEN the victim stops admission, its driver is joined,
        and its work moves — decodes with complete KV over the quantized
        ``export_kv``/``adopt`` wire (no recompute), everything else
        through the normal re-route path. Unlike :meth:`kill_replica`
        the victim's engine state is trusted, so nothing re-prefills
        that doesn't have to.

        Returns False (untouched) when ``name`` is unknown or not
        HEALTHY — a migration raced by death/drain falls back to the
        failover path that is already running."""
        with self._lock:
            victim = self._replicas.get(name)
            if victim is None or victim.state != ReplicaState.HEALTHY:
                return False
            victim.state = ReplicaState.DRAINING
            self.router.on_leave(name)
            version = victim.version
            role = victim.role
        victim.serving.stop_admission()
        logger.info(f"ServingFleet{f'[{self.name}]' if self.name else ''}: "
                    f"migrating {name} ({reason})")
        # replacement first: capacity never dips below the pre-migration
        # count, and the victim's work has somewhere version-compatible
        # to land. _spawn stamps _fleet_version, so pin the victim's
        # ACTUAL version after (a canary replica migrates as a canary).
        replacement = self._spawn(role=role)
        replacement.serving.model_version = version
        with self._lock:
            victim.state = ReplicaState.DEAD
            self._kvtier_drop(name)
        victim.serving.kill()
        queued, exports = victim.serving.migrate_out()
        self._count("migrations")
        moved_kv = 0
        for req, export in exports:
            if req._cancel_requested:
                # honor the pending cancel at the boundary (same terminal
                # contract as the failover path)
                req.transition(RequestState.CANCELLED)
                self._count("cancelled")
                emit_request_span(self._telemetry, req)
                self._on_retire(req)
                continue
            request_event(req, "migrate_adopt", source=name,
                          target=replacement.name)
            with self._lock:
                self._requests[req.uid] = (req, replacement.name)
            if replacement.serving.adopt(req, export):
                moved_kv += 1
                continue
            # adopt refused (replacement raced a kill/version flip):
            # degrade to the ordinary re-route continuation — the KV is
            # recomputed, the request is never lost
            with self._lock:
                ent = self._requests.get(req.uid)
                if ent is not None and ent[1] == replacement.name:
                    del self._requests[req.uid]
            self._route(req, requeue=True)
        if moved_kv:
            self._count("migrated_kv", moved_kv)
        # queued / mid-prefill work re-routes unconditionally — a
        # migration is an OPERATION, not a death, so it must not shed
        # under failover=False the way _failover_orphans would
        for req in queued:
            if req._cancel_requested:
                req.transition(RequestState.CANCELLED)
                self._count("cancelled")
                emit_request_span(self._telemetry, req)
                self._on_retire(req)
                continue
            request_event(req, "migrate_reroute", source=name)
            self._route(req, requeue=True)
        self._flush_shed()
        self._update_gauges()
        return True

    def _failover_orphans(self, orphans: List[Request],
                          source: str) -> None:
        """Re-place (or shed, per config) requests harvested from a dead
        or force-closed replica. Runs WITHOUT the fleet lock."""
        if self.config.failover:
            if orphans:
                self._count("failovers", len(orphans))
            for req in orphans:
                request_event(req, "failover", source=source)
                if req._cancel_requested:
                    # honor the pending cancel here (its replica is gone)
                    # with the full terminal contract: span + counter,
                    # same as a replica-level retire
                    req.transition(RequestState.CANCELLED)
                    self._count("cancelled")
                    emit_request_span(self._telemetry, req)
                    self._on_retire(req)
                    continue
                self._route(req, requeue=True)
        else:
            for req in orphans:
                self._reject(req, f"replica {source} died")
        self._flush_shed()

    def poll(self) -> None:
        """One monitor pass: driver health, injected chaos, respawn,
        autoscale-interval check. The monitor thread loops this; tests
        call it directly for determinism."""
        self._check_chaos()
        self._check_health()
        self._check_respawn()
        self._check_gray()
        self._check_hedges()
        self._resolve_hedges()
        self._publish_residency()
        if self.config.autoscale:
            now = self._clock.now()
            interval = self.config.autoscale_interval_s
            inj = get_fault_injector()
            if inj is not None:
                # injected controller lag: the decision cadence slows,
                # so demand runs ahead of capacity like it does behind a
                # real autoscaler's observe/decide/boot loop
                interval += getattr(inj, "autoscaler_lag_s", 0.0)
            with self._lock:
                # interval check-then-stamp under the lock: poll() runs
                # on the monitor thread AND via manual step() — unlocked
                # it could double-fire one interval's autoscale decision
                due = now - self._last_autoscale >= interval
                if due:
                    self._last_autoscale = now
            if due:
                self.autoscale_once()
        self._flush_shed()
        self._update_gauges()

    def _publish_residency(self) -> None:
        """Push every live replica's last residency snapshot into the
        prefix directory. Rides the
        existing monitor cadence — no extra thread, no extra wakeups —
        and stamps entries with the snapshot's CAPTURE time, so a
        replica whose driver stopped snapshotting ages past the
        staleness bound instead of looking perpetually fresh. The
        ``stale_directory`` chaos knob injects a deterministic bogus
        hash there (``KVTier.publish_residency``), recorded in the
        injector's ground-truth ledger."""
        tier = self.kv_tier
        if tier is None:
            return
        with self._lock:
            live = [(r.name, r.serving)
                    for r in self._replicas.values()
                    if r.state != ReplicaState.DEAD]
        for name, serving in live:
            tier.publish_residency(name, serving.residency_snapshot())

    def _monitor_loop(self) -> None:
        while not self._clock.wait_event(self._stop_evt,
                                         self.config.health_interval_s):
            try:
                self.poll()
            except Exception:
                logger.exception("ServingFleet: monitor pass crashed")

    def _check_chaos(self) -> None:
        if self._chaos_fired:
            return
        inj = get_fault_injector()
        if inj is None:
            return
        with self._lock:
            candidates = [(r.name, r.index, r.serving._tick_count)
                          for r in self._replicas.values()
                          if r.state == ReplicaState.HEALTHY]
        for name, index, ticks in candidates:
            if inj.should_kill_replica(index, ticks):
                self._chaos_fired = True
                self.kill_replica(name, reason="chaos: injected death")
                return

    def _check_health(self) -> None:
        """A replica whose driver thread died (unhandled crash, real
        process trouble) is treated exactly like injected death —
        DRAINING replicas included: their backlog still needs a driver,
        and an unnoticed death would strand it forever. A replica whose
        stuck-tick watchdog ESCALATED (N consecutive wedged polls —
        ``serving.stuck_tick_escalate_polls``) is evacuated the same
        way: its driver is alive but wedged inside a device call, which
        is worse — it still looks routable. The escalation check runs
        in manual-step mode too (the watchdog check itself is driven by
        tests there); only the thread-liveness check needs threads."""
        with self._lock:
            wedged = [r.name for r in self._replicas.values()
                      if r.state != ReplicaState.DEAD
                      and r.serving.watchdog_unhealthy]
        for name in wedged:
            self._count("watchdog_evacuations")
            self.kill_replica(name, reason="stuck-tick watchdog escalation")
        if not self._start_drivers:
            return              # manual-step mode: no threads to check
        with self._lock:
            sick = [r.name for r in self._replicas.values()
                    if r.state != ReplicaState.DEAD and not r.driver_alive]
        for name in sick:
            self.kill_replica(name, reason="driver thread dead")

    def _check_respawn(self) -> None:
        """Replace dead capacity while the healthy count sits below
        ``min_replicas``, with exponential backoff (deterministic:
        replicas are stateless to replace)."""
        if not self.config.respawn:
            return
        with self._lock:
            # each pool is audited against its own floor: the serving
            # (non-prefill) pool against min_replicas — same denominator
            # as scale_to/autoscale, else healthy prefill replicas mask
            # dead decode capacity — and, in disaggregated mode, the
            # prefill pool against prefill_replicas (losing it silently
            # degrades every request to unified re-prefill serving)
            healthy = sum(1 for r in self._replicas.values()
                          if r.state == ReplicaState.HEALTHY
                          and r.role != "prefill")
            prefill = sum(1 for r in self._replicas.values()
                          if r.state == ReplicaState.HEALTHY
                          and r.role == "prefill")
            want_prefill = (self.config.prefill_replicas
                            if self.config.disaggregated else 0)
            if self.config.disaggregated and prefill < want_prefill:
                role, have, floor = "prefill", prefill, want_prefill
            elif healthy < self.config.min_replicas:
                role = "decode" if self.config.disaggregated else "unified"
                have, floor = healthy, self.config.min_replicas
            else:
                self._respawn_delay = 0.5
                return
            if not self._accepting:
                return
            if self._clock.now() < self._respawn_after:
                return
            self._respawn_after = self._clock.now() + self._respawn_delay
            self._respawn_delay = min(self._respawn_delay * 2.0, 30.0)
        rep = self._spawn(role=role)
        self._count("respawns")
        record_restart()
        logger.warning(f"ServingFleet: respawned {role} capacity as "
                       f"{rep.name} ({have}/{floor} healthy)")

    # -- gray-failure plane (serving/health.py) ---------------------------
    def _gray_routable_locked(self, prefill: bool) -> int:
        """HEALTHY replicas of the given pool still in the NEW-work
        routing view per the quarantine machine (fleet lock held) — the
        capacity-floor denominator."""
        n = 0
        for r in self._replicas.values():
            if r.state != ReplicaState.HEALTHY:
                continue
            if (r.role == "prefill") != prefill:
                continue
            h = self._health.get(r.name)
            if h is None or h.routable:
                n += 1
        return n

    def _check_gray(self) -> None:
        """One gray-health monitor pass: drain each HEALTHY replica's
        distress counters into its continuous health score, advance the
        quarantine/probation machines, and enforce the capacity floor
        in BOTH directions — a quarantine that would hold the routable
        pool below ``min_replicas`` is deferred (the breach counter
        keeps accumulating; the next poll with headroom acts on it),
        and deaths that strand the pool below the floor release the
        longest-quarantined survivor back to probation."""
        cfg = self.config
        if not cfg.quarantine:
            return
        now = self._clock.now()
        entered: List[str] = []
        released: List[str] = []
        with self._lock:
            for r in list(self._replicas.values()):
                if r.state != ReplicaState.HEALTHY:
                    continue
                h = self._health.get(r.name)
                if h is None:
                    h = self._health[r.name] = ReplicaHealth(
                        r.name,
                        threshold=cfg.quarantine_threshold,
                        breach_polls=cfg.quarantine_after,
                        dwell_s=cfg.quarantine_dwell_s,
                        readmit_polls=cfg.quarantine_readmit_polls)
                floor = (cfg.prefill_replicas if r.role == "prefill"
                         else cfg.min_replicas)
                headroom = (self._gray_routable_locked(r.role == "prefill")
                            - (1 if h.routable else 0) >= floor)
                busy, distress = r.serving.gray_drain()
                if busy:
                    h.observe(distress / busy, now, can_quarantine=headroom)
                elif h.state == HealthState.ACTIVE:
                    h.idle_decay()
                else:
                    # a drained replica serves no NEW work, so idle IS
                    # its steady state: a zero-distress sample keeps
                    # the dwell clock and probation re-admission moving
                    h.observe(0.0, now, can_quarantine=headroom)
                if h.should_quarantine() and headroom:
                    h.quarantine(now)
                    entered.append(r.name)
            # the floor can break AFTER a quarantine (deaths, drains):
            # release the longest-quarantined survivors until it holds
            while self._gray_routable_locked(False) < cfg.min_replicas:
                q = [h for h in (self._health.get(r.name)
                                 for r in self._replicas.values()
                                 if r.state == ReplicaState.HEALTHY
                                 and r.role != "prefill")
                     if h is not None
                     and h.state == HealthState.QUARANTINED]
                if not q:
                    break
                q.sort(key=lambda h: (h.since, h.name))
                q[0].release(now)
                released.append(q[0].name)
        tag = f"ServingFleet{f'[{self.name}]' if self.name else ''}"
        for name in entered:
            self._count("quarantines")
            logger.warning(f"{tag}: quarantined {name} "
                           f"(gray-failure score breach)")
        for name in released:
            self._count("quarantine_floor_releases")
            logger.warning(f"{tag}: released {name} from quarantine "
                           f"(capacity floor)")

    def _breaker_event(self, name: str, ok: bool) -> None:
        """Fold one route/serve outcome into ``name``'s circuit breaker
        (no-op with breakers off, or for a replica already reaped)."""
        if not self.config.breakers:
            return
        now = self._clock.now()
        with self._lock:
            if name not in self._replicas:
                return
            b = self._breakers.get(name)
            if b is None:
                b = self._breakers[name] = CircuitBreaker(
                    name, failure_limit=self.config.breaker_failures,
                    cooldown_s=self.config.breaker_cooldown_s)
            before = b.state
            if ok:
                b.record_success(now)
            else:
                b.record_failure(now)
            opened = (b.state == BreakerState.OPEN
                      and before != BreakerState.OPEN)
        if opened:
            self._count("breaker_opens")
            logger.warning(
                f"ServingFleet{f'[{self.name}]' if self.name else ''}: "
                f"circuit breaker OPEN for {name}")

    def _check_hedges(self) -> None:
        """Hedged dispatch: an interactive request (TTFT deadline) with no first
        token by ``hedge_ttft_fraction`` of its TTFT budget gets ONE
        backup leg dispatched to a second replica through the normal
        route path. The gate in serving/health.py guarantees
        conservation: first token wins, the loser's tokens never reach
        the client, its span/SLO verdict are suppressed and its KV dies
        un-published."""
        if not self.config.hedge:
            return
        now = self._clock.now()
        to_hedge: List[Tuple[Request, str]] = []
        with self._lock:
            for req, rname in list(self._requests.values()):
                if (req.ttft_deadline_s is None or req.t_submit is None
                        or req.is_terminal or req.tokens
                        or req.t_first_token is not None
                        or getattr(req, "_hedge", None) is not None):
                    continue
                if (now - req.t_submit >= req.ttft_deadline_s
                        * self.config.hedge_ttft_fraction):
                    to_hedge.append((req, rname))
        for req, rname in to_hedge:
            self._dispatch_hedge(req, rname)

    def _dispatch_hedge(self, primary: Request,
                        primary_replica: str) -> None:
        """Build and route the backup leg for ``primary``. The shadow
        is a fresh Request (own uid) sharing the client_request_id,
        prompt and deadlines; the primary's replica is pre-refused so
        the two legs never share a failure domain. Runs WITHOUT the
        fleet lock — routing takes it per attempt."""
        shadow = Request(
            prompt=list(primary.prompt),
            max_new_tokens=primary.max_new_tokens,
            eos_token_id=primary.eos_token_id,
            priority=primary.priority,
            deadline_s=primary.deadline_s,
            ttft_deadline_s=primary.ttft_deadline_s,
            client_request_id=primary.client_request_id,
            tenant=primary.tenant)
        shadow._clock = self._clock
        shadow.t_submit = primary.t_submit   # the client's clock started then
        pair = HedgePair(primary, shadow)
        inner = primary.on_token
        primary.on_token = (lambda tok, _p=pair, _u=primary.uid, _i=inner:
                            _p.deliver(_u, _i, tok))
        shadow.on_token = (lambda tok, _p=pair, _u=shadow.uid, _i=inner:
                           _p.deliver(_u, _i, tok))
        primary._hedge = pair
        shadow._hedge = pair
        if primary.tokens or primary.t_first_token is not None:
            # the primary raced the gate wiring to its first token: it
            # won outright — the gate stays (transparent to a winner),
            # no shadow is dispatched
            pair.settle(primary.uid)
            pair.resolved = True
            return
        request_event(primary, "hedge", shadow_uid=shadow.uid)
        with self._lock:
            self._hedges[primary.uid] = pair
            self._hedges[shadow.uid] = pair
            self._hedged_total += 1
        if self._route(shadow, shed=False, refused=(primary_replica,)):
            self._count("hedges")
        else:
            # nowhere to place the backup: the hedge quietly failed and
            # the primary continues as the sole (default-winning) leg;
            # no span, no verdict — the loser is suppressed by contract
            pair.settle(shadow.uid)
            pair.resolved = True
            shadow.error = "hedge shadow unplaceable"
            shadow.transition(RequestState.REJECTED)
            self._count("hedge_unplaced")

    def _resolve_hedges(self) -> None:
        """Cancel decided losers and GC both-terminal pairs. The loser
        dies with ``_discard_kv`` set: its engine state is SUSPECT (it
        lost the race for a reason) and is discarded un-published at
        the replica's cancel boundary."""
        if not self.config.hedge:
            return
        losers: List[Request] = []
        with self._lock:
            seen = set()
            for pair in self._hedges.values():
                if id(pair) in seen:
                    continue
                seen.add(id(pair))
                if pair.resolved or pair.winner_uid is None:
                    continue
                pair.resolved = True
                loser = pair.loser
                if loser is not None and not loser.is_terminal:
                    losers.append(loser)
        for req in losers:
            req._discard_kv = True
            self.cancel(req)
            self._count("hedge_losses")
        with self._lock:
            # GC the uid rows once both legs are terminal; the pair
            # object survives in _hedge_done (gray_snapshot reports the
            # whole ledger)
            done = [uid for uid, p in self._hedges.items()
                    if p.primary.is_terminal and p.shadow.is_terminal]
            dropped = set()
            for uid in done:
                p = self._hedges.pop(uid)
                if id(p) not in dropped:
                    dropped.add(id(p))
                    self._hedge_done.append(p)

    def gray_snapshot(self) -> Dict[str, Any]:
        """Read-only view of the gray plane (health scores, breakers,
        hedge ledger)."""
        with self._lock:
            pairs = []
            seen = set()
            for p in list(self._hedges.values()) + self._hedge_done:
                if id(p) in seen:
                    continue
                seen.add(id(p))
                pairs.append(p.snapshot())
            return {
                "health": {n: h.snapshot()
                           for n, h in self._health.items()},
                "breakers": {n: b.snapshot()
                             for n, b in self._breakers.items()},
                "hedges": pairs,
                "hedged_total": self._hedged_total,
            }

    # -- autoscaling -----------------------------------------------------
    def _elastic_config(self):
        c = self.config
        return ServingElasticityConfig(
            min_replicas=c.min_replicas, max_replicas=c.max_replicas,
            scale_up_queue_per_replica=c.scale_up_queue_per_replica,
            scale_down_queue_per_replica=c.scale_down_queue_per_replica,
            kv_high=c.kv_high, sla_low=c.sla_low)

    def autoscale_once(self) -> int:
        """One controller decision: measure, size via the shared
        elasticity policy, apply. Returns the target count."""
        with self._lock:
            scalable = [r for r in self._replicas.values()
                        if r.state != ReplicaState.DEAD
                        and r.role != "prefill"]
            healthy = [r for r in scalable
                       if r.state == ReplicaState.HEALTHY]
            queue_depth = sum(r.serving.queue_depth for r in scalable)
            # demand, not raw occupancy: cache-reclaimable pages are
            # capacity, and counting them would ratchet the fleet to
            # max_replicas after any warm-cache burst
            kv = (max(r.engine.kv_demand() for r in healthy)
                  if healthy else 0.0)
        target = compute_serving_replicas(
            max(1, len(healthy)), queue_depth=queue_depth, kv_occupancy=kv,
            in_sla_ratio=self.in_sla_ratio(), config=self._elastic_config())
        self.scale_to(target)
        return target

    def scale_to(self, n: int) -> None:
        """Grow to / shrink toward ``n`` serving (non-prefill) replicas.
        Scale-down is graceful: the least-loaded replica stops admission,
        serves out, and only then closes (finished by later polls)."""
        with self._lock:
            if not self._accepting:
                # draining/closing fleet: spawning replicas that can
                # never receive work just burns engines moments before
                # close() tears them down (the backlog reads as load
                # until it serves out)
                return
            # selection and state flip under ONE lock acquisition: a
            # stale snapshot could resurrect a replica kill_replica()
            # just flipped to DEAD
            healthy = [r for r in self._replicas.values()
                       if r.state == ReplicaState.HEALTHY
                       and r.role != "prefill"]
            delta = n - len(healthy)
            victims: List[Replica] = []
            if delta < 0:
                victims = sorted(healthy, key=lambda r: (r.load, r.name))
                victims = victims[:min(-delta, max(0, len(healthy) - 1))]
                for r in victims:
                    r.state = ReplicaState.DRAINING
                    self.router.on_leave(r.name)
        if delta > 0:
            role = "decode" if self.config.disaggregated else "unified"
            for _ in range(delta):
                self._spawn(role=role)
                self._count("scale_ups")
        for r in victims:
            r.serving.stop_admission()
            self._count("scale_downs")
        # reap drained replicas (from this call or earlier ones). DEAD is
        # flipped BEFORE close(): once close sets the replica's stop
        # event it refuses continuations, so it must already be out of
        # every requeue/handoff view (adopt()'s refusal return covers
        # the one in-flight call that raced the flip)
        with self._lock:
            drained = [r for r in self._replicas.values()
                       if r.state == ReplicaState.DRAINING and r.load == 0]
            for r in drained:
                r.state = ReplicaState.DEAD
                self._kvtier_drop(r.name)
        for r in drained:
            r.serving.close(timeout=5.0)
            # a continuation enqueued in the window between the DEAD flip
            # and close() stopping the driver would otherwise be stranded
            # in a joined-dead replica — harvest and re-place it
            stragglers = r.serving.evacuate()
            if stragglers:
                self._failover_orphans(stragglers, source=r.name)
            logger.info(f"ServingFleet: scale-down of {r.name} complete")
        self._update_gauges()

    # -- deterministic driving (tests / smoke) ---------------------------
    def step(self) -> bool:
        """Manual-mode driver: one monitor poll plus one tick per live
        replica. Returns True when any replica did work. Only meaningful
        with ``start=False`` (no competing threads)."""
        self.poll()
        did = False
        for r in self.replicas:
            if r.state == ReplicaState.DEAD:
                continue
            did = r.serving._tick() or did
        return did
