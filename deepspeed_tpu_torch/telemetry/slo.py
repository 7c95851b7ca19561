"""Per-tenant SLO objectives and multi-window burn-rate alerting.

Ports ``deepspeed_tpu/telemetry/slo.py`` (host Python; the port keeps its
own copy).

An :class:`SLOObjective` states the contract: a target fraction of
SLO-carrying requests in SLA over a rolling window. The
:class:`TenantSLOTracker` measures attainment against it per tenant
(and per model version, for the rollout canary judge) from the digest
rollup plane (:mod:`deepspeed_tpu_torch.telemetry.digest`): the region feeds
it one ``(t, verdict-deltas)`` row per absorbed digest, so tracking
cost scales with digest count, never request count.

Alerting follows the multi-window burn-rate recipe (the SRE-workbook
shape, on VIRTUAL time): ``burn = miss_rate / error_budget`` where
``error_budget = 1 - target``. A *fast* window (5-minute-equivalent)
catches cliffs; a *slow* window (1-hour-equivalent) catches smolder.
Each (tenant, window) pair has fire/clear hysteresis — an alert fires
at its burn threshold and clears only below ``clear_ratio`` of it, or
when the window's samples age out entirely. Every transition is
appended to :attr:`TenantSLOTracker.alert_log` — a deterministic,
replayable stream, hashable per simulator seed — and mirrored into
the metrics registry and flight recorder by the region.

No RNG, no clock reads (``now`` is always passed in), stable iteration
orders: same digest stream, same alerts, bit-identical.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Any, Deque, Dict, List, Optional, Tuple

#: window labels (stable wire strings in alert rows)
FAST, SLOW = "fast", "slow"


@dataclass(frozen=True)
class SLOObjective:
    """One SLO contract: ``target`` in-SLA ratio, measured over
    ``window_s`` of virtual time, alerted through fast/slow burn-rate
    windows. Defaults follow the classic 95%-target multiwindow page:
    fast threshold 14.4 burns a 30-day budget in ~2 days, slow 6 in ~5.
    """

    target: float = 0.95
    window_s: float = 240.0
    fast_window_s: float = 300.0
    slow_window_s: float = 3600.0
    fast_burn_threshold: float = 14.4
    slow_burn_threshold: float = 6.0
    clear_ratio: float = 0.5
    min_samples: int = 4

    def __post_init__(self):
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"slo target must be in (0, 1), got "
                             f"{self.target}")
        for f in ("window_s", "fast_window_s", "slow_window_s"):
            if getattr(self, f) <= 0:
                raise ValueError(f"slo {f} must be > 0")
        for f in ("fast_burn_threshold", "slow_burn_threshold"):
            if getattr(self, f) <= 0:
                raise ValueError(f"slo {f} must be > 0")
        if not 0.0 < self.clear_ratio <= 1.0:
            raise ValueError(f"slo clear_ratio must be in (0, 1], got "
                             f"{self.clear_ratio}")
        if self.min_samples < 1:
            raise ValueError(f"slo min_samples must be >= 1, got "
                             f"{self.min_samples}")

    @property
    def error_budget(self) -> float:
        return 1.0 - self.target

    def burn_rate(self, attainment: float) -> float:
        return (1.0 - attainment) / self.error_budget

    def to_dict(self) -> Dict[str, Any]:
        return {
            "target": self.target, "window_s": self.window_s,
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
            "fast_burn_threshold": self.fast_burn_threshold,
            "slow_burn_threshold": self.slow_burn_threshold,
            "clear_ratio": self.clear_ratio,
            "min_samples": self.min_samples,
        }


#: one verdict-delta row: (t, in_slo_count, judged_count)
_Row = Tuple[float, int, int]


def _window_totals(rows: Deque[_Row], now: float,
                   window_s: float) -> Tuple[int, int]:
    """(ok, judged) over rows with ``t > now - window_s`` (rows are
    appended in non-decreasing t, so scan from the right)."""
    cutoff = now - window_s
    ok = judged = 0
    for t, o, n in reversed(rows):
        if t <= cutoff:
            break
        ok += o
        judged += n
    return ok, judged


class TenantSLOTracker:
    """Windowed SLO attainment per tenant / version / region-wide, with
    multi-window burn-rate alerting.

    Single-threaded by design: the region's rollup pass (monitor
    thread, or manual ``poll()``) is the only caller — the same
    discipline as :class:`~deepspeed_tpu_torch.telemetry.digest.DigestAccumulator`.
    """

    def __init__(self, objective: Optional[SLOObjective] = None):
        self.objective = objective if objective is not None \
            else SLOObjective()
        self._tenants: Dict[str, Deque[_Row]] = {}
        self._versions: Dict[int, Deque[_Row]] = {}
        self._global: Deque[_Row] = collections.deque()
        #: {"t", "tenant", "window", "state", "burn"} transition rows —
        #: the lane's bit-identity witness. Bounded like brownout_log.
        self.alert_log: Deque[Dict[str, Any]] = collections.deque(
            maxlen=4096)
        self._active: Dict[Tuple[str, str], bool] = {}

    # -- feed (one call per absorbed digest) -----------------------------
    def record(self, t: float,
               tenants: Dict[str, List[int]],
               versions: Dict[int, List[int]],
               ok: int, judged: int) -> None:
        """Fold one digest's verdict deltas in at virtual time ``t``."""
        horizon = max(self.objective.slow_window_s,
                      self.objective.window_s)
        for k in sorted(tenants):
            o, n = tenants[k][0], tenants[k][1]
            if n:
                self._tenants.setdefault(
                    k, collections.deque()).append((t, o, n))
        for k in sorted(versions):
            o, n = versions[k][0], versions[k][1]
            if n:
                self._versions.setdefault(
                    k, collections.deque()).append((t, o, n))
        if judged:
            self._global.append((t, int(ok), int(judged)))
        self._prune(t - horizon)

    def _prune(self, cutoff: float) -> None:
        for rows in list(self._tenants.values()) \
                + list(self._versions.values()) + [self._global]:
            while rows and rows[0][0] <= cutoff:
                rows.popleft()

    # -- attainment reads ------------------------------------------------
    def attainment(self, now: float,
                   window_s: Optional[float] = None) -> Optional[float]:
        """Region-wide in-SLA ratio over the objective window (None
        until a verdict lands in it)."""
        ok, judged = _window_totals(
            self._global, now,
            self.objective.window_s if window_s is None else window_s)
        return ok / judged if judged else None

    def tenant_attainment(self, tenant: str, now: float,
                          window_s: Optional[float] = None
                          ) -> Tuple[int, Optional[float]]:
        rows = self._tenants.get(tenant)
        if not rows:
            return 0, None
        ok, judged = _window_totals(
            rows, now,
            self.objective.window_s if window_s is None else window_s)
        return judged, (ok / judged if judged else None)

    def version_attainment(self, version: int, now: float,
                           window_s: Optional[float] = None
                           ) -> Tuple[int, Optional[float]]:
        """(samples, ratio) for one model version — the rollout canary
        judge's signal, read from the plane instead of per-fleet deques."""
        rows = self._versions.get(int(version))
        if not rows:
            return 0, None
        ok, judged = _window_totals(
            rows, now,
            self.objective.window_s if window_s is None else window_s)
        return judged, (ok / judged if judged else None)

    def tenants(self) -> List[str]:
        return sorted(self._tenants)

    def active_alerts(self) -> List[Tuple[str, str]]:
        """Currently-firing (tenant, window) pairs, sorted."""
        return sorted(k for k, v in self._active.items() if v)

    def has_fast_burn(self) -> bool:
        """True while any tenant's FAST window alert is firing — the
        brownout ladder's descend-hold signal."""
        return any(v and k[1] == FAST for k, v in self._active.items())

    # -- alerting --------------------------------------------------------
    def check_alerts(self, now: float) -> List[Dict[str, Any]]:
        """Evaluate every (tenant, window) pair at ``now``; return (and
        log) the transitions. Deterministic: sorted tenant order, pure
        function of the recorded rows."""
        obj = self.objective
        transitions: List[Dict[str, Any]] = []
        windows = ((FAST, obj.fast_window_s, obj.fast_burn_threshold),
                   (SLOW, obj.slow_window_s, obj.slow_burn_threshold))
        for tenant in sorted(self._tenants):
            rows = self._tenants[tenant]
            for label, win_s, threshold in windows:
                key = (tenant, label)
                active = self._active.get(key, False)
                ok, judged = _window_totals(rows, now, win_s)
                if judged < obj.min_samples:
                    # not enough evidence to judge; an active alert
                    # whose samples aged out entirely auto-clears (the
                    # tenant went quiet — nothing is burning budget)
                    if active and judged == 0:
                        self._active[key] = False
                        transitions.append(self._log(now, tenant, label,
                                                     "clear", 0.0))
                    continue
                burn = obj.burn_rate(ok / judged)
                if not active and burn >= threshold:
                    self._active[key] = True
                    transitions.append(self._log(now, tenant, label,
                                                 "firing", burn))
                elif active and burn <= threshold * obj.clear_ratio:
                    self._active[key] = False
                    transitions.append(self._log(now, tenant, label,
                                                 "clear", burn))
        return transitions

    def _log(self, t: float, tenant: str, window: str, state: str,
             burn: float) -> Dict[str, Any]:
        row = {"t": t, "tenant": tenant, "window": window,
               "state": state, "burn": round(burn, 6)}
        self.alert_log.append(row)
        return row
