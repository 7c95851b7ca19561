"""Zero-downtime model rollout: canary, auto-rollback, drain-and-flip.

Ports ``deepspeed_tpu/serving/rollout.py`` (host Python; the port keeps
its own copy).

The :class:`RolloutController` turns a model-version change from a cold
restart into a first-class, invariant-guarded fleet operation. It owns
one state
machine, stepped from the region monitor (``Region.poll``), that moves
a region from serving version ``v`` to version ``v+1`` — or provably
back to ``v``:

    IDLE --start()--> CANARY --warm--> OBSERVING --window clean--> PROMOTING
                         |                 |                          |
                         |                 | SLO regression           |
                         v                 v                          v
                     ROLLING_BACK <--- ROLLING_BACK              DONE (all
                         |          (swap-retry / flip-attempt    replicas
                         v           budgets spent roll back too)  flipped)
                    ROLLED_BACK

* **CANARY** — one replica (first live cell, first healthy replica;
  deterministic order) is drained behind ``stop_admission``, its weights
  hot-swapped (``ServingEngine.hot_swap``: checkpoint-streamed load +
  AOT warmup before admission re-opens), and a tenant-sticky
  ``canary_fraction`` slice of new traffic is routed to the new version
  through the fleet's version-aware ring view.
* **OBSERVING** — for ``canary_observe_ticks`` controller steps the
  canary's per-version in-SLA window is compared against the stable
  version's; a regression past ``slo_regression_threshold`` (with at
  least ``min_canary_samples`` canary verdicts) triggers automatic
  rollback.
* **PROMOTING** — remaining replicas are drained and flipped one at a
  time, cell-by-cell in sorted order, each serving out its admitted
  work first (zero requests lost, bounded capacity dip). New capacity
  (respawns, scale-ups) already spawns on the new version.
* **ROLLING_BACK** — the canary slice closes, fleet version returns to
  stable, and every replica serving the abandoned version is drained
  and flipped back. The rollout converges to ROLLED_BACK — the DST
  rollback-convergence invariant audits that it neither wedges nor
  leaves a replica stranded on the rolled-back version.

Every version decision lands in :attr:`version_log` — the justification
ledger the DST per-tenant version-monotonicity invariant checks a
version DECREASE against (a tenant may only ever move backwards across
a logged rollback; anything else is a routing bug).

Faults the controller must survive (``resilience/chaos.py``): a corrupt
new-version checkpoint (``hot_swap`` falls back to the old weights; the
controller retries up to ``swap_retry_limit`` then rolls back), the
flip victim dying mid-flip (re-target, up to ``max_flip_attempts``),
and an injected canary SLO regression (must roll back, and the
rollback must converge).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from ..resilience.chaos import get_fault_injector
from ..resilience.locksan import named_rlock
from ..telemetry.tracing import get_tracer
from ..utils.logging import log_dist, logger


class RolloutPhase:
    """Controller phases (str constants, same idiom as ReplicaState)."""

    IDLE = "idle"
    CANARY = "canary"
    OBSERVING = "observing"
    PROMOTING = "promoting"
    ROLLING_BACK = "rolling_back"
    DONE = "done"
    ROLLED_BACK = "rolled_back"


#: phases a new rollout may start from
_STARTABLE = (RolloutPhase.IDLE, RolloutPhase.DONE, RolloutPhase.ROLLED_BACK)
#: terminal phases (the rollout is over; the controller is re-armable)
TERMINAL_PHASES = (RolloutPhase.DONE, RolloutPhase.ROLLED_BACK)

#: numeric phase encoding for the ``serving/rollout/phase`` gauge
_PHASE_GAUGE = {RolloutPhase.IDLE: 0, RolloutPhase.CANARY: 1,
                RolloutPhase.OBSERVING: 2, RolloutPhase.PROMOTING: 3,
                RolloutPhase.ROLLING_BACK: 4, RolloutPhase.DONE: 5,
                RolloutPhase.ROLLED_BACK: 6}


class RolloutController:
    """One in-flight rollout for a :class:`~.region.Region`.

    Stepped from the region monitor (``Region.poll`` -> :meth:`step`);
    all fleet/engine access happens through the public fleet surface,
    so the lock order stays ``RolloutController._lock`` ->
    ``ServingFleet._lock`` -> ``ServingEngine._lock`` (the controller
    is never called from under a fleet lock). ``load_fn`` (optional,
    from :meth:`start`) is invoked inside each replica's ``hot_swap``
    to stream the new version's weights — in DST it stays None and the
    flip is a pure version change."""

    def __init__(self, region, config: Any, clock) -> None:
        self._region = region
        self.config = config
        self._clock = clock
        self._lock = named_rlock("RolloutController._lock")
        self._phase = RolloutPhase.IDLE
        self.target_version: Optional[int] = None
        self.stable_version: Optional[int] = None
        self._fraction = 0.0
        self._load_fn: Optional[Callable[[], None]] = None
        #: in-progress flip: {"cell", "name", "target", "retries",
        #: "stopped"} — one replica at a time, by design (bounded dip)
        self._flip: Optional[Dict[str, Any]] = None
        self._flip_attempts = 0
        self._observe_left = 0
        #: justification ledger: {"t", "kind", "version"} rows. Kinds:
        #: start / canary_live / promote / done / swap_failed /
        #: flip_death / rollback / rolled_back. The DST monotonicity
        #: auditor accepts a tenant's version DECREASE only across a
        #: "rollback" row for the abandoned version.
        self.version_log: List[Dict[str, Any]] = []

    # -- telemetry -------------------------------------------------------
    def _count(self, name: str, n: float = 1.0) -> None:
        from ..telemetry import get_telemetry

        get_telemetry().registry.counter(f"serving/rollout/{name}").inc(n)

    def _update_gauges(self) -> None:
        from ..telemetry import get_telemetry

        t = get_telemetry()
        if not t.enabled:
            return
        with self._lock:
            phase, target = self._phase, self.target_version
        t.registry.gauge("serving/rollout/phase").set(_PHASE_GAUGE[phase])
        t.registry.gauge("serving/rollout/target_version").set(
            -1 if target is None else target)

    def _log(self, kind: str, version: int) -> None:
        """Append a version_log row (controller lock held)."""
        self.version_log.append(
            {"t": self._clock.now(), "kind": kind, "version": int(version)})

    # -- introspection ---------------------------------------------------
    @property
    def phase(self) -> str:
        with self._lock:
            return self._phase

    @property
    def active(self) -> bool:
        with self._lock:
            return self._phase not in (RolloutPhase.IDLE,) + TERMINAL_PHASES

    def _fleets(self):
        """Live cells' fleets, sorted by cell name (deterministic)."""
        return [c.fleet for c in sorted(self._region.live_cells,
                                        key=lambda c: c.name)]

    def _version_counts(self) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for fleet in self._fleets():
            for v, n in fleet.version_counts().items():
                out[v] = out.get(v, 0) + n
        return out

    def _version_sla(self, version: int) -> Tuple[int, Optional[float]]:
        """Region-wide (samples, in-SLA ratio) for one version, read
        from the region's SLO plane (telemetry/slo.py): one windowed
        read of rollup-fed verdicts instead of a per-fleet deque scan —
        the canary judge's cost no longer grows with fleet count."""
        return self._region.slo.version_attainment(version,
                                                   self._clock.now())

    # -- lifecycle -------------------------------------------------------
    def start(self, version: int, fraction: Optional[float] = None,
              load_fn: Optional[Callable[[], None]] = None) -> bool:
        """Begin rolling the region to ``version``. Refused (False) when
        a rollout is already in flight or the version does not move
        forward — versions are monotonic by contract; only a ROLLBACK
        (controller-logged) ever lowers what a tenant sees."""
        fleets = self._fleets()
        if not fleets:
            return False
        stable = fleets[0].fleet_version
        with self._lock:
            if self._phase not in _STARTABLE:
                logger.warning(
                    f"rollout: refusing start({version}) mid-rollout "
                    f"(phase {self._phase})")
                return False
            if int(version) <= stable:
                logger.warning(
                    f"rollout: refusing start({version}): not ahead of "
                    f"stable version {stable}")
                return False
            self._phase = RolloutPhase.CANARY
            self.target_version = int(version)
            self.stable_version = stable
            self._fraction = (self.config.canary_fraction
                              if fraction is None
                              else max(0.0, min(1.0, float(fraction))))
            self._load_fn = load_fn
            self._flip = None
            self._flip_attempts = 0
            self._observe_left = int(self.config.canary_observe_ticks)
            self._log("start", self.target_version)
        for fleet in fleets:
            fleet.set_canary(int(version), self._fraction)
        self._count("starts")
        tracer = get_tracer()
        if tracer.enabled:
            tracer.flight.note("rollout_start", version=int(version),
                               stable=stable)
        log_dist(f"rollout: {stable} -> {version} started "
                 f"(canary {self._fraction:.0%})")
        self._update_gauges()
        return True

    def step(self) -> None:
        """One controller step (region monitor cadence). Cheap when
        idle; at most one replica is mid-flip at any time."""
        with self._lock:
            phase = self._phase
        if phase in (RolloutPhase.IDLE,) + TERMINAL_PHASES:
            return
        if phase == RolloutPhase.CANARY:
            self._step_canary()
        elif phase == RolloutPhase.OBSERVING:
            self._step_observing()
        elif phase == RolloutPhase.PROMOTING:
            self._step_promoting()
        elif phase == RolloutPhase.ROLLING_BACK:
            self._step_rolling_back()
        self._update_gauges()

    # -- flip engine (one replica at a time) -----------------------------
    def _pick_flip_target(self, to_version: int) -> Optional[Dict[str, Any]]:
        """First healthy replica NOT serving ``to_version``, cells in
        sorted order — the cell-by-cell discipline."""
        for cell in sorted(self._region.live_cells, key=lambda c: c.name):
            for rep in sorted(cell.fleet.healthy_replicas,
                              key=lambda r: r.name):
                if rep.version != to_version:
                    return {"cell": cell.name, "name": rep.name,
                            "target": to_version, "retries": 0,
                            "stopped": False}
        return None

    def _find_replica(self, flip: Dict[str, Any]):
        """(cell, replica) for an in-progress flip, or (None, None) when
        either side died under us."""
        for cell in self._region.live_cells:
            if cell.name != flip["cell"]:
                continue
            for rep in cell.fleet.replicas:
                if rep.name == flip["name"]:
                    from .fleet import ReplicaState

                    if rep.state == ReplicaState.DEAD:
                        return cell, None
                    return cell, rep
            return cell, None
        return None, None

    def _step_flip(self, to_version: int) -> str:
        """Advance the current flip by one step. Returns:

        * ``"flipping"`` — in progress (draining / warming / retrying);
        * ``"flipped"``  — one replica finished flipping this step;
        * ``"clean"``    — nothing left to flip to ``to_version``;
        * ``"failed"``   — budgets spent (swap retries / flip attempts).
        """
        with self._lock:
            flip = self._flip
            load_fn = self._load_fn
        if flip is None:
            flip = self._pick_flip_target(to_version)
            if flip is None:
                return "clean"
            with self._lock:
                if self._flip_attempts >= self.config.max_flip_attempts:
                    return "failed"
                self._flip_attempts += 1
                self._flip = flip
        cell, rep = self._find_replica(flip)
        if rep is None:
            # the victim (or its whole cell) died mid-flip: the fleet's
            # failover already harvested its work; re-target next step
            with self._lock:
                self._flip = None
            self._count("flip_retargets")
            return "flipping"
        if not flip["stopped"]:
            rep.serving.stop_admission()
            flip["stopped"] = True
            return "flipping"
        if rep.load > 0:
            return "flipping"   # admission stopped; serving out
        if rep.version == flip["target"]:
            # swap landed on an earlier step; wait out the AOT warmup
            # (admission re-opens when the countdown hits zero)
            if not rep.accepting:
                return "flipping"
            with self._lock:
                self._flip = None
                self._flip_attempts = 0
            return "flipped"
        inj = get_fault_injector()
        if inj is not None and inj.should_die_at_flip():
            # chaos: the replica process dies exactly at the swap point.
            # Kill through the fleet so failover/respawn run the normal
            # death path; the flip re-targets (attempt-budgeted).
            self._count("flip_deaths")
            with self._lock:
                self._log("flip_death", flip["target"])
                self._flip = None
            cell.fleet.kill_replica(rep.name,
                                    reason="chaos: death mid-flip")
            return "flipping"
        try:
            ok = rep.serving.hot_swap(flip["target"], load_fn=load_fn)
        except RuntimeError:
            # raced a late continuation between the drain check and the
            # swap (production interleaving; impossible under DST's
            # single-threaded drive): still busy, try next step
            return "flipping"
        if ok:
            self._count("flips")
            return "flipping"   # now warming; "flipped" once accepting
        # corrupt/failed weight load: hot_swap already fell back to the
        # old weights and re-opened admission — the replica is serving,
        # never stranded. Retry (re-drain) up to the budget.
        self._count("swap_failures")
        with self._lock:
            self._log("swap_failed", flip["target"])
            flip["retries"] += 1
            flip["stopped"] = False
            if flip["retries"] > self.config.swap_retry_limit:
                self._flip = None
                return "failed"
        return "flipping"

    # -- phase steps -----------------------------------------------------
    def _step_canary(self) -> None:
        with self._lock:
            target = self.target_version
        outcome = self._step_flip(target)
        if outcome == "failed":
            self._begin_rollback("canary flip budgets spent")
            return
        counts = self._version_counts()
        if counts.get(target, 0) > 0 \
                and outcome in ("flipped", "clean"):
            with self._lock:
                self._phase = RolloutPhase.OBSERVING
                self._log("canary_live", target)
            self._count("canaries_live")
            log_dist(f"rollout: canary live on version "
                     f"{target}; observing")

    def _step_observing(self) -> None:
        with self._lock:
            target = self.target_version
            stable = self.stable_version
        counts = self._version_counts()
        if counts.get(target, 0) == 0:
            # canary capacity died; re-flip one (attempt-budgeted)
            with self._lock:
                self._phase = RolloutPhase.CANARY
            return
        c_n, c_ratio = self._version_sla(target)
        s_n, s_ratio = self._version_sla(stable)
        if (c_n >= self.config.min_canary_samples
                and c_ratio is not None and s_ratio is not None
                and (s_ratio - c_ratio)
                > self.config.slo_regression_threshold):
            self._count("canary_regressions")
            tracer = get_tracer()
            if tracer.enabled:
                tracer.flight.note("canary_regression",
                                   canary=round(c_ratio, 4),
                                   stable=round(s_ratio, 4))
            self._begin_rollback(
                f"canary in-SLA {c_ratio:.2f} vs stable {s_ratio:.2f}")
            return
        with self._lock:
            self._observe_left -= 1
            done = self._observe_left <= 0
        if done:
            with self._lock:
                self._phase = RolloutPhase.PROMOTING
                self._log("promote", target)
            # new capacity (respawns, scale-ups) now spawns on the new
            # version, and BOTH sides of the former split prefer it —
            # tenants only ever move up from here
            for fleet in self._fleets():
                fleet.set_fleet_version(target)
                fleet.clear_canary()
            self._count("promotions")
            log_dist(f"rollout: canary window clean; promoting "
                     f"version {target}")

    def _step_promoting(self) -> None:
        with self._lock:
            target = self.target_version
        outcome = self._step_flip(target)
        if outcome == "failed":
            self._begin_rollback("promote flip budgets spent")
            return
        if outcome == "clean":
            with self._lock:
                self._phase = RolloutPhase.DONE
                self._log("done", target)
                self._flip = None
            self._count("completed")
            tracer = get_tracer()
            if tracer.enabled:
                tracer.flight.note("rollout_done", version=target)
            log_dist(f"rollout: version {target} fully promoted")

    def _begin_rollback(self, reason: str) -> None:
        with self._lock:
            target = self.target_version
            stable = self.stable_version
            self._phase = RolloutPhase.ROLLING_BACK
            self._log("rollback", target)
            self._flip = None
            # rollback gets a fresh flip-attempt budget: the budget that
            # was spent belongs to the FORWARD direction's bad luck, and
            # rollback must converge even after it
            self._flip_attempts = 0
        for fleet in self._fleets():
            fleet.clear_canary()
            fleet.set_fleet_version(stable)
        self._count("rollbacks")
        tracer = get_tracer()
        if tracer.enabled:
            tracer.flight.note("rollout_rollback", version=target,
                               reason=reason)
            tracer.flight.dump("rollout-rollback")
        logger.warning(f"rollout: ROLLING BACK version {target} "
                       f"({reason})")

    def _step_rolling_back(self) -> None:
        with self._lock:
            target = self.target_version
            stable = self.stable_version
        outcome = self._step_flip(stable)
        if outcome == "failed":
            # even rollback flips are budgeted, but a rollback that
            # gives up would strand replicas on the abandoned version —
            # reset the budget and keep draining (the DST convergence
            # invariant bounds this with the liveness slack)
            with self._lock:
                self._flip_attempts = 0
            self._count("rollback_retries")
            return
        if outcome == "clean":
            with self._lock:
                self._phase = RolloutPhase.ROLLED_BACK
                self._log("rolled_back", target)
                self._flip = None
            self._count("rolled_back")
            log_dist(f"rollout: rolled back to version "
                     f"{stable}; no replica serves {target}")
