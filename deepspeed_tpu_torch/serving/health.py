"""Gray-failure plane: continuous health scores with quarantine and
probation, per-replica routing circuit breakers, and the hedged-dispatch
gate.

Ports ``deepspeed_tpu/serving/health.py`` (host Python; the port keeps its
own copy). Host-only state machines driven by the fleet monitor on the
injected clock, so every transition is a function of the observations:

* :class:`ReplicaHealth` — one distress-ratio sample per monitor poll
  (degraded busy ticks / busy ticks) lands in a
  :class:`~deepspeed_tpu_torch.telemetry.registry.SketchHistogram` and
  folds into an EWMA score. A sustained breach quarantines the replica
  (out of the new-work view only; live streams finish in place); after a
  dwell it goes to probation, and clean polls re-admit it. Every
  re-quarantine doubles the dwell (capped at 16x), and re-admission never
  resets it, so a noisy replica cannot flap.
* :class:`CircuitBreaker` — closed -> open after consecutive failures,
  half-open after a cooldown with exactly one probe.
* :class:`HedgePair` — the two legs of one hedged request: the first leg
  to deliver a token wins, the loser's tokens never reach the client, its
  span and SLO verdict are suppressed, and its KV is discarded
  unpublished.

Nothing here takes fleet or engine locks: the fleet mutates these objects
under its own lock.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from ..telemetry.registry import SketchHistogram

__all__ = ["ReplicaHealth", "CircuitBreaker", "HedgePair",
           "HealthState", "BreakerState"]


class HealthState:
    """Quarantine state-machine states (plain strings — they appear in
    transition logs, digests and DST traces, where enum reprs would
    churn the canonical hashes)."""

    ACTIVE = "active"
    QUARANTINED = "quarantined"
    PROBATION = "probation"


class ReplicaHealth:
    """Continuous health score + quarantine/probation state machine for
    one replica.  Driven by :meth:`observe` once per fleet monitor poll;
    all timing comes from the caller-supplied ``now`` (the injected
    clock), never the wall clock."""

    def __init__(self, name: str, *, threshold: float = 0.5,
                 breach_polls: int = 3, dwell_s: float = 8.0,
                 readmit_polls: int = 3, ewma: float = 0.45) -> None:
        self.name = name
        self.threshold = float(threshold)
        self.breach_polls = int(breach_polls)
        self.base_dwell_s = float(dwell_s)
        self.dwell_s = float(dwell_s)
        self.readmit_polls = int(readmit_polls)
        self.ewma = float(ewma)
        self.state = HealthState.ACTIVE
        self.score = 0.0
        # distress-ratio samples; mergeable up the digest plane
        self.sketch = SketchHistogram(f"serving/health/{name}/distress",
                                      alpha=0.01)
        self._breaches = 0
        self._clean = 0
        self._quarantines = 0      # lifetime quarantine entries
        self._since = 0.0          # entry time of the current state
        # (t, from, to) rows — the no-flap invariant's evidence
        self.transitions: List[Tuple[float, str, str]] = []

    # -- scoring -------------------------------------------------------
    def observe(self, distress_ratio: float, now: float,
                can_quarantine: bool = True) -> None:
        """Fold one poll's distress ratio (degraded busy ticks / busy
        ticks, in [0, 1]) into the score and advance the state machine.
        ``can_quarantine`` is the caller's capacity-floor headroom: a
        probation breach with the floor binding stays IN probation
        (clean streak reset, no readmission progress) instead of
        re-quarantining — degraded capacity beats no capacity, and a
        quarantine the floor would instantly release is pure churn."""
        r = min(1.0, max(0.0, float(distress_ratio)))
        self.sketch.observe(r)
        self.score += self.ewma * (r - self.score)
        breached = self.score > self.threshold
        if self.state == HealthState.ACTIVE:
            if breached:
                self._breaches += 1
            else:
                self._breaches = 0
        elif self.state == HealthState.QUARANTINED:
            if now - self._since >= self.dwell_s:
                self._move(HealthState.PROBATION, now)
        elif self.state == HealthState.PROBATION:
            if breached:
                if can_quarantine:
                    self._move(HealthState.QUARANTINED, now)
                else:
                    self._clean = 0
            else:
                self._clean += 1
                if self._clean >= self.readmit_polls:
                    self._move(HealthState.ACTIVE, now)

    def idle_decay(self) -> None:
        """An idle poll (no busy ticks) decays the score toward clean —
        a replica that serves nothing can produce no fresh evidence."""
        self.score *= (1.0 - self.ewma)

    # -- transitions (fleet calls these under ITS lock) ----------------
    def should_quarantine(self) -> bool:
        return (self.state == HealthState.ACTIVE
                and self._breaches >= self.breach_polls)

    def quarantine(self, now: float) -> None:
        self._move(HealthState.QUARANTINED, now)

    def release(self, now: float) -> None:
        """Capacity-floor release: the fleet dropped below
        ``min_replicas`` AFTER this replica was quarantined, so it goes
        back to probation early — degraded capacity beats no capacity."""
        if self.state == HealthState.QUARANTINED:
            self._move(HealthState.PROBATION, now)

    @property
    def since(self) -> float:
        """Entry time of the current state (floor release evicts the
        LONGEST-quarantined replica first — it has had the most dwell)."""
        return self._since

    def _move(self, to: str, now: float) -> None:
        # every mutation runs in the fleet monitor under
        # ServingFleet._lock (or single-threaded in tests)
        if to == HealthState.QUARANTINED:
            if self._quarantines:
                # every RE-entry doubles the dwell (capped at 16x base)
                # and a clean readmission deliberately does NOT reset
                # it: hysteresis must bound churn through the FULL
                # quarantine -> probation -> active -> breach cycle,
                # not just a probation breach — a dwell reset on
                # readmit lets an intermittent straggler flap on a
                # fixed short period
                self.dwell_s = min(self.base_dwell_s * 16.0,
                                   self.dwell_s * 2.0)
            self._quarantines += 1
        self.transitions.append((float(now), self.state, to))
        self.state = to
        self._since = float(now)
        self._breaches = 0
        self._clean = 0

    @property
    def routable(self) -> bool:
        """Eligible for NEW work: ACTIVE and PROBATION route (probation
        traffic IS the canary probe); QUARANTINED is drained."""
        return self.state != HealthState.QUARANTINED

    def snapshot(self) -> Dict[str, Any]:
        return {"name": self.name, "state": self.state,
                "score": round(self.score, 6), "dwell_s": self.dwell_s,
                "p99": self.sketch.percentile(99.0),
                "transitions": list(self.transitions)}


class BreakerState:
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


class CircuitBreaker:
    """Per-replica routing circuit breaker: ``failure_limit``
    consecutive failures open it for ``cooldown_s`` (injected clock);
    once the cooldown elapses it goes half-open and admits exactly one
    deterministic probe — the probe's outcome closes or re-opens it."""

    def __init__(self, name: str, *, failure_limit: int = 4,
                 cooldown_s: float = 5.0) -> None:
        self.name = name
        self.failure_limit = int(failure_limit)
        self.cooldown_s = float(cooldown_s)
        self.state = BreakerState.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probe_out = False
        self.transitions: List[Tuple[float, str, str]] = []

    def record_failure(self, now: float) -> None:
        if self.state == BreakerState.HALF_OPEN:
            # the probe failed: straight back to open, fresh cooldown
            self._probe_out = False
            self._move(BreakerState.OPEN, now)
            self._opened_at = float(now)
            return
        self._failures += 1
        if (self.state == BreakerState.CLOSED
                and self._failures >= self.failure_limit):
            self._move(BreakerState.OPEN, now)
            self._opened_at = float(now)

    def record_success(self, now: float) -> None:
        self._failures = 0
        if self.state == BreakerState.HALF_OPEN:
            self._probe_out = False
            self._move(BreakerState.CLOSED, now)

    def admits(self, now: float) -> bool:
        """Routing-view eligibility. Open -> half-open happens here (the
        cooldown is checked against the injected clock); half-open
        admits only while its single probe slot is unclaimed."""
        if self.state == BreakerState.CLOSED:
            return True
        if self.state == BreakerState.OPEN:
            if now - self._opened_at >= self.cooldown_s:
                self._move(BreakerState.HALF_OPEN, now)
                self._probe_out = False
                return True
            return False
        return not self._probe_out

    def claim_probe(self) -> None:
        """The half-open probe slot was taken by a routed request; no
        second request is admitted until its outcome reports back."""
        if self.state == BreakerState.HALF_OPEN:
            self._probe_out = True

    def _move(self, to: str, now: float) -> None:
        self.transitions.append((float(now), self.state, to))
        self.state = to

    def snapshot(self) -> Dict[str, Any]:
        return {"name": self.name, "state": self.state,
                "failures": self._failures,
                "transitions": list(self.transitions)}


class HedgePair:
    """The two legs of one hedged client request and the conservation
    gate between them.

    ``primary`` is the original request (the client's callback rides on
    it at submit time); ``shadow`` is the backup dispatched when the
    TTFT deadline came at risk.  The FIRST leg to deliver a token wins;
    from that point the loser's tokens are dropped at the gate (never
    delivered), its span and SLO verdict are suppressed, and the fleet
    cancels it with its KV discarded un-published.  If the primary goes
    terminal before any token was delivered, the primary wins by
    default — its reject/cancel/failure IS the client-visible outcome.
    The gate's lock is a private leaf (nothing is acquired under it).
    """

    def __init__(self, primary, shadow) -> None:
        self.primary = primary
        self.shadow = shadow
        self.winner_uid: Optional[int] = None
        self.resolved = False       # loser cancellation has been issued
        self._mu = threading.Lock()

    def deliver(self, leg_uid: int, inner, token: int) -> None:
        """The per-leg on_token gate: decide the winner on the first
        token ever delivered, then let only the winner through."""
        with self._mu:
            if self.winner_uid is None:
                self.winner_uid = leg_uid
            won = self.winner_uid == leg_uid
        if won and inner is not None:
            inner(token)

    def settle(self, leg_uid: int) -> None:
        """A leg went terminal while the race was undecided: that leg
        wins by default (primary terminal = the client-visible outcome;
        shadow terminal = the hedge quietly failed, primary continues)."""
        other = (self.shadow.uid if leg_uid == self.primary.uid
                 else self.primary.uid)
        with self._mu:
            if self.winner_uid is None:
                # a terminal PRIMARY wins by default; a terminal SHADOW
                # loses by default (the primary keeps serving)
                self.winner_uid = (leg_uid if leg_uid == self.primary.uid
                                   else other)

    @property
    def loser(self):
        if self.winner_uid is None:
            return None
        return (self.shadow if self.winner_uid == self.primary.uid
                else self.primary)

    @property
    def winner(self):
        if self.winner_uid is None:
            return None
        return (self.primary if self.winner_uid == self.primary.uid
                else self.shadow)

    def is_suppressed(self, uid: int) -> bool:
        """True when ``uid`` is a DECIDED loser: its span + SLO verdict
        must not be emitted (the ledger judges the request once)."""
        with self._mu:
            return self.winner_uid is not None and uid != self.winner_uid

    def snapshot(self) -> Dict[str, Any]:
        with self._mu:
            return {"client_request_id": self.primary.client_request_id,
                    "primary_uid": self.primary.uid,
                    "shadow_uid": self.shadow.uid,
                    "winner_uid": self.winner_uid,
                    "resolved": self.resolved}
