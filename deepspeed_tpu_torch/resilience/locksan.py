"""Runtime lock-order sanitizer — the dynamic half of dsrace.

Ports ``deepspeed_tpu/resilience/locksan.py`` (host Python; the port keeps its own
copy and imports nothing of the JAX package).

dslint's lock-discipline and races rules model locks statically; this
module checks what threads actually DO. When a :class:`LockSanitizer`
is installed (tests, the DST soak's sanitizer leg — never production),
the serving tier's locks — built through :func:`named_lock` /
:func:`named_rlock` instead of bare ``threading.Lock()`` — become
instrumented wrappers that record every acquisition:

* **order** — acquiring lock B while holding lock A records the edge
  ``A -> B``. Edges between documented tiers are checked against the
  region -> cell -> fleet -> replica order (docs/serving.md); an
  inversion is a violation.
* **cycles** — every new edge runs a DFS over the accumulated edge
  graph; a cycle is a deadlock two schedules away, flagged immediately
  with the virtual-time stamp of the closing edge (the DST soak runs
  on ``SimClock``, so "when" is deterministic).
* **same-tier nesting** — two different INSTANCES of the same lock
  name held together (replica lock under replica lock) has no defined
  order and is flagged.
* **self-deadlock** — re-acquiring a held non-reentrant ``Lock``
  raises immediately instead of hanging the run.

Cross-validation (scripts/race_lane.py, the dst_soak sanitizer leg):
every runtime-observed edge must exist in dslint's static lock graph
(the JAX package's ``deepspeed_tpu.analysis.rules.locks.collect_lock_graph``) — a
miss means the static model has a false negative and fails the lane —
and the static graph's documented-tier edges must be exercised by the
soak (the coverage half of the report).

With no sanitizer installed, :func:`named_lock`/:func:`named_rlock`
return plain ``threading`` primitives: zero production overhead, and
dslint's model treats the construction seam as the lock it wraps.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from .clock import get_clock

#: the documented serving-tier lock order, outermost first — mirrored
#: from analysis/rules/locks.py (suffix-matched display names)
DOCUMENTED_LOCK_ORDER: Sequence[str] = (
    "Region._lock",
    "ServingCell._lock",
    "ServingFleet._lock",
    "ServingEngine._lock",
)


class LockOrderViolation(RuntimeError):
    """Raised on acquisition in strict mode (and always for a
    self-deadlock, which would otherwise hang the process)."""


@dataclass
class EdgeInfo:
    outer: str
    inner: str
    count: int = 0
    first_vt: float = 0.0       # clock.now() at first observation
    threads: Set[str] = field(default_factory=set)


class LockSanitizer:
    """Acquisition-order recorder + checker. Thread-safe; its own
    bookkeeping is guarded by a private raw mutex (never itself
    sanitized)."""

    def __init__(self, order: Sequence[str] = DOCUMENTED_LOCK_ORDER,
                 strict: bool = False) -> None:
        self.order = tuple(order)
        self.strict = strict
        self.edges: Dict[Tuple[str, str], EdgeInfo] = {}
        self.violations: List[Dict[str, object]] = []
        self.acquires: Dict[str, int] = {}
        self._graph: Dict[str, Set[str]] = {}
        self._mu = threading.Lock()
        self._tls = threading.local()

    # -- per-thread held stack -------------------------------------------
    def _held(self) -> List[Tuple[int, str]]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        return stack

    def _order_pos(self, name: str) -> Optional[int]:
        for i, suffix in enumerate(self.order):
            if name == suffix or name.endswith("." + suffix):
                return i
        return None

    def _violation(self, kind: str, **fields) -> None:
        rec = {"kind": kind, "vt": get_clock().now(),
               "thread": threading.current_thread().name, **fields}
        with self._mu:
            self.violations.append(rec)
        if self.strict:
            raise LockOrderViolation(f"{kind}: {fields}")

    def _find_cycle(self, start: str, target: str) -> Optional[List[str]]:
        """Path target -> ... -> start in the edge graph (caller adds
        start -> target, closing the cycle). Caller holds _mu."""
        stack = [(target, [target])]
        seen: Set[str] = set()
        while stack:
            cur, path = stack.pop()
            if cur == start:
                return path
            if cur in seen:
                continue
            seen.add(cur)
            for nxt in sorted(self._graph.get(cur, ())):
                stack.append((nxt, path + [nxt]))
        return None

    # -- wrapper callbacks ------------------------------------------------
    def on_acquired(self, lock: "_SanLockBase") -> None:
        """Called by a wrapper AFTER its real lock is acquired."""
        held = self._held()
        name = lock.san_name
        with self._mu:
            self.acquires[name] = self.acquires.get(name, 0) + 1
        if any(ident == id(lock) for ident, _ in held):
            # re-entrant acquire of the same instance: no new edges
            held.append((id(lock), name))
            return
        vt = get_clock().now()
        outer_names = []
        seen: Set[str] = set()
        for ident, outer in held:
            if outer in seen:
                continue
            seen.add(outer)
            outer_names.append(outer)
        for outer in outer_names:
            if outer == name:
                # a DIFFERENT instance with the same name: same-tier
                # nesting has no defined order (replica under replica)
                self._violation("same-tier-nesting", lock=name)
                continue
            new_edge = False
            cycle = None
            with self._mu:
                info = self.edges.get((outer, name))
                if info is None:
                    info = EdgeInfo(outer=outer, inner=name, first_vt=vt)
                    self.edges[(outer, name)] = info
                    new_edge = True
                info.count += 1
                info.threads.add(threading.current_thread().name)
                if new_edge:
                    cycle = self._find_cycle(outer, name)
                    self._graph.setdefault(outer, set()).add(name)
            po, pi = self._order_pos(outer), self._order_pos(name)
            if po is not None and pi is not None and pi < po:
                self._violation("order-inversion", outer=outer,
                                inner=name,
                                documented=" -> ".join(self.order))
            if cycle is not None:
                self._violation(
                    "lock-cycle",
                    cycle=" -> ".join([outer] + cycle))
        held.append((id(lock), name))

    def on_released(self, lock: "_SanLockBase") -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == id(lock):
                del held[i]
                return
        self._violation("release-unheld", lock=lock.san_name)

    def held_names(self) -> List[str]:
        """This thread's currently held lock names, outermost first."""
        return [name for _, name in self._held()]

    # -- reporting --------------------------------------------------------
    def edge_pairs(self) -> Set[Tuple[str, str]]:
        with self._mu:
            return set(self.edges)

    def report(self) -> Dict[str, object]:
        with self._mu:
            return {
                "edges": [{"outer": e.outer, "inner": e.inner,
                           "count": e.count, "first_vt": e.first_vt,
                           "threads": sorted(e.threads)}
                          for e in sorted(self.edges.values(),
                                          key=lambda e: (e.outer,
                                                         e.inner))],
                "violations": list(self.violations),
                "acquires": dict(sorted(self.acquires.items())),
                "order": list(self.order),
            }


class _SanLockBase:
    """Shared wrapper shape over a real threading lock. Supports the
    ``with`` protocol plus acquire/release/locked, which is everything
    the serving tier uses."""

    _REENTRANT = False

    def __init__(self, name: str, san: LockSanitizer) -> None:
        self.san_name = name
        self._san = san
        self._real = (threading.RLock() if self._REENTRANT
                      else threading.Lock())

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not self._REENTRANT:
            held = self._san._held()
            if any(ident == id(self) for ident, _ in held):
                # acquiring a held non-reentrant Lock deadlocks for
                # real — surface it instead of hanging the run
                self._san._violation("self-deadlock", lock=self.san_name)
                raise LockOrderViolation(
                    f"self-deadlock on non-reentrant {self.san_name}")
        got = self._real.acquire(blocking, timeout)
        if got:
            try:
                self._san.on_acquired(self)
            except LockOrderViolation:
                # strict mode raised mid-bookkeeping: the stack entry
                # was never pushed, so release the REAL lock before
                # propagating — a caught strict violation must leave no
                # lock held and no inconsistent per-thread stack
                self._real.release()
                raise
        return got

    def release(self) -> None:
        try:
            self._san.on_released(self)
        finally:
            # a strict-mode release-unheld raise must still release the
            # real lock (it was held by contract of calling release)
            self._real.release()

    def locked(self) -> bool:
        return self._real.locked()

    def __enter__(self) -> "_SanLockBase":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class SanLock(_SanLockBase):
    _REENTRANT = False


class SanRLock(_SanLockBase):
    _REENTRANT = True

    def locked(self) -> bool:          # RLock has no .locked() pre-3.12
        if self._real.acquire(blocking=False):
            self._real.release()
            return False
        return True


# ----------------------------------------------------------------------
_SANITIZER: Optional[LockSanitizer] = None


def get_locksan() -> Optional[LockSanitizer]:
    return _SANITIZER


def install_locksan(san: Optional[LockSanitizer]) -> Optional[LockSanitizer]:
    """Install (or, with None, remove) the process-global sanitizer.
    Only locks CONSTRUCTED while a sanitizer is installed are
    instrumented — install before building the stack under test."""
    global _SANITIZER
    prev = _SANITIZER
    _SANITIZER = san
    return prev


@contextlib.contextmanager
def use_locksan(order: Sequence[str] = DOCUMENTED_LOCK_ORDER,
                strict: bool = False) -> Iterator[LockSanitizer]:
    """Scoped sanitizer install — the DST soak / test entry seam:

        with use_locksan() as san:
            report = run_schedule(schedule)
        assert not san.violations
    """
    san = LockSanitizer(order=order, strict=strict)
    prev = install_locksan(san)
    try:
        yield san
    finally:
        install_locksan(prev)


def named_lock(name: str):
    """A ``threading.Lock`` — or, when a sanitizer is installed, an
    instrumented wrapper reporting to it under ``name`` (the static
    lock model's display name, e.g. ``"ServingEngine._lock"``)."""
    san = _SANITIZER
    if san is None:
        return threading.Lock()
    return SanLock(name, san)


def named_rlock(name: str):
    """A ``threading.RLock`` — or its instrumented wrapper (see
    :func:`named_lock`)."""
    san = _SANITIZER
    if san is None:
        return threading.RLock()
    return SanRLock(name, san)
