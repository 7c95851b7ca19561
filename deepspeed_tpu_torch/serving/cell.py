"""A serving cell: one fleet wrapped as a region-level failure domain.

Ports ``deepspeed_tpu/serving/cell.py`` (host Python; the port keeps its
own copy).

At pod scale the failure modes that matter are CORRELATED — a rack
power event or a ToR switch takes out every replica of a
:class:`~.fleet.ServingFleet` at once, and a fabric fault partitions
whole groups of cells from each other while each keeps serving locally.
The :class:`ServingCell` is the unit those failures act on: it wraps
one fleet, owns its place on the region's consistent-hash cell ring,
and summarizes its load/health into a :class:`CellDigest` the region
routes by.

The digest is **published, not scanned**: the cell walks its replicas
once per monitor poll (``publish_digest``) and stores an immutable
snapshot; the region's per-request route path does a dictionary read —
O(1) in replica count — so one process can simulate thousands of
replicas without O(N) per-route scans.

Cross-cell flows (request hand-off, KV adoption, evacuation targets)
must consult the partition oracle
(:func:`~deepspeed_tpu_torch.resilience.chaos.is_reachable`) and fail with
the typed :class:`CellUnreachable` across a severed pair — in one
process every object is trivially "reachable", so the type system is
what keeps the simulation honest about the network.

Lock order (``resilience/locksan.py`` ``DOCUMENTED_LOCK_ORDER``): Region
-> ServingCell -> ServingFleet -> ServingEngine. Cell state reads by the region's
route path touch only the published digest reference, never a fleet or
replica lock.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ..resilience.chaos import is_reachable
from ..resilience.locksan import named_rlock
from .fleet import ServingFleet
from .request import Request


class CellUnreachable(RuntimeError):
    """A cross-cell operation (route, hand-off, KV adoption) crossed an
    active network partition. TYPED so recovery code can distinguish
    "the network said no" (degrade to a reachable cell, re-prefill)
    from a programming error — and so a broad ``except Exception``
    recovery block can never paper over a severed link silently."""

    def __init__(self, src: str, dst: str, op: str = "reach"):
        super().__init__(
            f"cell {dst} unreachable from {src} during {op} "
            f"(network partition)")
        self.src = src
        self.dst = dst
        self.op = op


def check_reachable(src: str, dst: str, op: str = "reach") -> None:
    """Raise :class:`CellUnreachable` when an active partition severs
    ``src`` from ``dst`` (no injector installed = network whole)."""
    if not is_reachable(src, dst):
        raise CellUnreachable(src, dst, op=op)


class CellState:
    UP = "up"
    DEAD = "dead"


@dataclass(frozen=True)
class CellDigest:
    """Immutable load/health summary of one cell, published on the
    monitor cadence. Everything the region's routing, spill, brownout
    and dead-cell detection need — and NOTHING that requires touching a
    replica at route time."""

    t: float                      # publish instant (region clock)
    queue_depth: int
    live: int
    pending_work: int
    healthy_replicas: int
    kv_demand: float
    in_sla: Optional[float]
    accepting: bool
    # gray-failure plane (serving/health.py):
    # replicas drained out of the NEW-work view by quarantine — still
    # counted in healthy_replicas (they are alive and serving admitted
    # work), but region-level detection reads this to spot a graying
    # cell in O(cells)
    quarantined: int = 0

    @property
    def load_per_replica(self) -> float:
        """Queued work per healthy replica — the spill/brownout pressure
        unit (inf when nothing healthy: an empty cell is infinitely
        loaded for placement purposes)."""
        if self.healthy_replicas <= 0:
            return float("inf")
        return self.queue_depth / self.healthy_replicas


class ServingCell:
    """One fleet as a failure domain: digest publisher + life-cycle
    holder. The region owns construction (it wires the shared retry
    budget, retire hook and hand-off escalation into the fleet) and
    calls :meth:`publish_digest` from its monitor; everything else is a
    thin, lock-ordered pass-through to the fleet."""

    def __init__(self, name: str, fleet: ServingFleet, clock) -> None:
        self.name = name
        self.fleet = fleet
        self.index = int(name.rsplit("-", 1)[-1]) if "-" in name else 0
        self._clock = clock
        # locksan seam: plain RLock in production, order-recording
        # wrapper under tests (resilience/locksan.py)
        self._lock = named_rlock("ServingCell._lock")
        self._state = CellState.UP
        self._digest: Optional[CellDigest] = None

    # -- state -----------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def alive(self) -> bool:
        return self.state == CellState.UP

    def mark_dead(self) -> bool:
        """Flip to DEAD (idempotent). Returns True on the transition."""
        with self._lock:
            if self._state == CellState.DEAD:
                return False
            self._state = CellState.DEAD
            # a dead cell's last digest must not keep attracting routes
            # in the window before the region's ring drops it
            self._digest = None
        return True

    # -- digest ----------------------------------------------------------
    @property
    def digest(self) -> Optional[CellDigest]:
        """The last published digest (None before the first publish or
        after death). A bare attribute read under the cell lock — the
        route path's ONLY per-cell cost."""
        with self._lock:
            return self._digest

    def publish_digest(self) -> Optional[CellDigest]:
        """Walk the fleet once and publish a fresh digest (monitor
        cadence — the one place replica scans happen)."""
        with self._lock:
            if self._state == CellState.DEAD:
                return None
        fields = self.fleet.digest_fields()
        d = CellDigest(t=self._clock.now(), **fields)
        with self._lock:
            if self._state == CellState.DEAD:   # died mid-scan
                return None
            self._digest = d
        return d

    def publish_telemetry(self, t: float):
        """Collect this cell's telemetry digest delta (replica sketches
        + fleet verdict source merged into one fixed-size
        :class:`~deepspeed_tpu_torch.telemetry.digest.TelemetryDigest`) for
        the region's rollup — same publish-not-scan cadence as
        :meth:`publish_digest`, a separate channel so the routing digest
        stays a flat frozen row."""
        with self._lock:
            if self._state == CellState.DEAD:
                return None
        return self.fleet.collect_telemetry_digest(t)

    # -- failure / shutdown ---------------------------------------------
    def kill(self, reason: str = "cell outage") -> List[Request]:
        """Whole-cell death: every replica dies at once, every
        non-terminal request is harvested (QUEUED, engine state
        discarded — the cell's KV is suspect in toto) and returned for
        the REGION to place on reachable cells."""
        self.mark_dead()
        return self.fleet.shutdown_abrupt(reason=reason)

    def ticks(self) -> int:
        """Max engine tick count across replicas — the chaos injector's
        cell-age signal (:meth:`FaultInjector.should_kill_cell`)."""
        counts = [r.serving._tick_count for r in self.fleet.replicas]
        return max(counts) if counts else 0

    def step(self) -> bool:
        """Manual-mode drive: one fleet step (monitor poll + one tick
        per live replica)."""
        return self.fleet.step()

    # -- introspection ---------------------------------------------------
    def block_leaks(self) -> List[str]:
        return [f"{self.name}: {p}" for p in self.fleet.block_leaks()]

    def to_dict(self) -> Dict[str, Any]:
        d = self.digest
        return {"name": self.name, "state": self.state,
                "digest": None if d is None else dict(d.__dict__)}
