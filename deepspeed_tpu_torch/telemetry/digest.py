"""Hierarchical telemetry digests: replica → fleet → cell → region.

Ports ``deepspeed_tpu/telemetry/digest.py`` (host Python; the port keeps its own
copy and imports nothing of the JAX package).

The flat registry keeps every replica's metrics as ``serving/<cell>/
replica-N/...`` names in one namespace, so any fleet/cell/region view is
a full-namespace scan — O(total replicas) per read, exactly the class of
scan ROADMAP item 1 says thousands of simulated replicas will expose.
This module is the publish-not-scan fix, the same discipline
``ServingCell.publish_digest`` already applies to routing state:

* each tier owns a :class:`DigestSource` — a leaf-locked collector of
  counter deltas, sketch observations and per-tenant/per-version SLO
  verdicts;
* ``publish()`` snapshots AND RESETS the source, so every published
  :class:`TelemetryDigest` is a *delta*: merging a stream of digests
  reproduces the total exactly (sketch bucket addition is associative
  and commutative — see :class:`SketchHistogram`), and no observation
  is ever counted twice;
* the region folds per-cell digests into one :class:`DigestAccumulator`
  whose ``percentile()``/``snapshot()`` answer region-scale questions
  from O(cells) merged state — per-tick rollup work is independent of
  replica count.

Everything here is deterministic on virtual time: no RNG, no clock
reads (timestamps are passed in by the caller), stable iteration
orders. Under DST the per-seed digest stream hashes bit-identically
(``scripts/slo_lane.py``).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from .registry import SketchHistogram

# canonical short metric names carried inside digests (tier prefixes are
# added only at the region's registry boundary)
LATENCY_METRICS = ("queue_wait_s", "ttft_s", "request_latency_s",
                   "tokens_per_s", "tick_s")


class TelemetryDigest:
    """One tier's published telemetry delta: counter deltas, mergeable
    sketches, and per-tenant / per-model-version SLO verdict counts.

    Digests are created and merged on the publishing/rollup thread only
    (the region poll pulls them, mirroring ``publish_digest``); the
    sketches inside carry their own locks, the scalar maps need none.
    ``merge`` is associative and commutative with the empty digest as
    identity, so merge-of-digests equals digest-of-union.
    """

    __slots__ = ("t", "source", "alpha", "counters", "sketches",
                 "tenants", "versions")

    def __init__(self, t: float, source: str, alpha: float = 0.01):
        self.t = float(t)
        self.source = source
        self.alpha = float(alpha)
        self.counters: Dict[str, float] = {}
        self.sketches: Dict[str, SketchHistogram] = {}
        # tenant/version -> [in_slo_count, judged_count] deltas
        self.tenants: Dict[str, List[int]] = {}
        self.versions: Dict[int, List[int]] = {}

    @property
    def rows(self) -> int:
        """Bounded row count — the 'fixed-size' witness the rollup-cost
        gate meters (independent of how many requests fed the delta)."""
        return (len(self.counters) + len(self.sketches)
                + len(self.tenants) + len(self.versions))

    def is_empty(self) -> bool:
        return self.rows == 0

    def merge(self, other: "TelemetryDigest") -> "TelemetryDigest":
        for k, v in other.counters.items():
            self.counters[k] = self.counters.get(k, 0.0) + v
        for k, s in other.sketches.items():
            mine = self.sketches.get(k)
            if mine is None:
                mine = SketchHistogram(k, alpha=self.alpha)
                self.sketches[k] = mine
            mine.merge(s)
        for k, v in other.tenants.items():
            row = self.tenants.setdefault(k, [0, 0])
            row[0] += v[0]
            row[1] += v[1]
        for k, v in other.versions.items():
            row = self.versions.setdefault(k, [0, 0])
            row[0] += v[0]
            row[1] += v[1]
        return self

    def to_dict(self) -> Dict[str, Any]:
        """Canonical (key-sorted) wire form — the bit-identity surface
        the SLO lane hashes per seed."""
        return {
            "t": self.t,
            "source": self.source,
            "alpha": self.alpha,
            "counters": {k: self.counters[k]
                         for k in sorted(self.counters)},
            "sketches": {k: self.sketches[k].serialize()
                         for k in sorted(self.sketches)},
            "tenants": {k: list(self.tenants[k])
                        for k in sorted(self.tenants)},
            "versions": {str(k): list(self.versions[k])
                         for k in sorted(self.versions)},
        }


class DigestSource:
    """Leaf-locked telemetry collector with snapshot-and-reset publish.

    One per tier (replica engine, fleet, region front-end). Writers call
    ``observe``/``count``/``slo_verdict`` from their own threads; the
    rollup thread calls ``publish`` on its cadence and gets the delta
    since the previous publish. The lock is a private leaf — nothing
    blocking runs under it and no other lock is ever taken inside it.
    """

    def __init__(self, source: str, alpha: float = 0.01):
        self.source = source
        self.alpha = float(alpha)
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._sketches: Dict[str, SketchHistogram] = {}
        self._tenants: Dict[str, List[int]] = {}
        self._versions: Dict[int, List[int]] = {}

    def count(self, metric: str, n: float = 1.0) -> None:
        with self._lock:
            self._counters[metric] = self._counters.get(metric, 0.0) + n

    def observe(self, metric: str, v: Optional[float]) -> None:
        if v is None:
            return
        with self._lock:
            s = self._sketches.get(metric)
            if s is None:
                s = SketchHistogram(metric, alpha=self.alpha)
                self._sketches[metric] = s
        s.observe(v)   # sketch carries its own lock

    def slo_verdict(self, tenant: Optional[str], version: Optional[int],
                    ok: bool) -> None:
        """Record one judged SLO verdict (``ok`` = request met its SLO)
        against the request's tenant and model version."""
        with self._lock:
            if tenant is not None:
                row = self._tenants.setdefault(tenant, [0, 0])
                row[0] += 1 if ok else 0
                row[1] += 1
            if version is not None:
                row = self._versions.setdefault(int(version), [0, 0])
                row[0] += 1 if ok else 0
                row[1] += 1

    def publish(self, t: float) -> TelemetryDigest:
        """Snapshot-and-reset: return the delta since the last publish."""
        d = TelemetryDigest(t, self.source, alpha=self.alpha)
        with self._lock:
            d.counters = self._counters
            d.sketches = self._sketches
            d.tenants = self._tenants
            d.versions = self._versions
            self._counters = {}
            self._sketches = {}
            self._tenants = {}
            self._versions = {}
        return d


class DigestAccumulator:
    """Running merge of published digests — the region's O(cells) view.

    ``absorb`` returns the digest's bounded row count so callers can
    meter rollup work (the replica-independence gate). Reads answer from
    the merged state: ``percentile`` walks one merged sketch, never a
    pooled sample window.
    """

    def __init__(self, alpha: float = 0.01):
        self.alpha = float(alpha)
        self._total = TelemetryDigest(0.0, "accumulator", alpha=alpha)
        self.absorbed = 0

    def absorb(self, digest: TelemetryDigest) -> int:
        rows = digest.rows
        self._total.merge(digest)
        self.absorbed += 1
        return rows

    def counter(self, metric: str) -> float:
        return self._total.counters.get(metric, 0.0)

    def sketch(self, metric: str) -> Optional[SketchHistogram]:
        return self._total.sketches.get(metric)

    def percentile(self, metric: str, p: float) -> Optional[float]:
        s = self._total.sketches.get(metric)
        return s.percentile(p) if s is not None else None

    def tenant_totals(self) -> Dict[str, Tuple[int, int]]:
        return {k: (v[0], v[1]) for k, v in self._total.tenants.items()}

    def version_totals(self) -> Dict[int, Tuple[int, int]]:
        return {k: (v[0], v[1]) for k, v in self._total.versions.items()}

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready region view: counters as scalars, sketches as
        summary dicts (count/sum/min/max/mean/p50/p90/p99)."""
        out: Dict[str, Any] = {}
        for k in sorted(self._total.counters):
            out[k] = self._total.counters[k]
        for k in sorted(self._total.sketches):
            out[k] = self._total.sketches[k].summary()
        return out
