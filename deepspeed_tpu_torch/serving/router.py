"""Request routing across serving replicas.

Ports ``deepspeed_tpu/serving/router.py`` (host Python; the port keeps its
own copy). The fleet (:mod:`.fleet`) asks a router which replica each
prompt lands on:

* :class:`LeastLoadedRouter` — the healthy replica with the smallest load
  (queued + live + penned requests); ties break by name.
* :class:`PrefixAffinityRouter` — consistent hashing over the prompt's
  full-block prefix (the unit the engines' prefix caches share), so
  repeat traffic lands on the replica already holding its KV pages. The
  ring (:class:`ConsistentHashRing`, ``vnodes`` points per replica,
  sorted by a sha256-derived 64-bit hash) is the JAX package's point for
  point: a join moves ~1/(N+1) of the keys, all to the joiner; a leave
  moves only the leaver's keys. A ``spill_load`` valve sends a pick that
  is already that loaded to a strictly emptier replica.
* :class:`ResidencyAwareRouter` — affinity routing that first asks the
  global KV tier's :class:`~.kvtier.PrefixDirectory` which healthy
  replica holds the prefix (bounded staleness), falling back to the ring.

Routers see names and a caller-built ``name -> load`` view only: the
fleet drops dead, draining, quarantined and breaker-open replicas from
that view before the ring is walked.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


class NoHealthyReplica(RuntimeError):
    """Every replica is dead or draining — nothing can take the request."""


def _hash64(data: str) -> int:
    """Stable 64-bit hash (sha256-derived: identical across processes and
    runs — python's ``hash()`` is salted per process and would reshuffle
    the ring on every restart, defeating affinity)."""
    return int.from_bytes(
        hashlib.sha256(data.encode("utf-8")).digest()[:8], "big")


def prefix_key(prompt: Sequence[int], block_size: int) -> Tuple[int, ...]:
    """The routing key for a prompt: its longest cacheable full-block
    prefix (mirrors ``PrefixCache.match`` — full blocks only, capped at
    ``len(prompt) - 1`` so the key matches what a replica could actually
    hold). Prompts shorter than one full block key on the whole prompt:
    identical short prompts should still co-locate."""
    k = (len(prompt) - 1) // block_size
    if k <= 0:
        return tuple(int(t) for t in prompt)
    return tuple(int(t) for t in prompt[: k * block_size])


def least_loaded_pick(replicas: Dict[str, float]) -> str:
    """THE least-loaded selection (ties break by name for determinism) —
    one definition shared by the baseline router, the affinity router's
    degrade/spill paths, and the fleet's prefill/handoff placement."""
    if not replicas:
        raise NoHealthyReplica("no healthy replica to route to")
    return min(replicas.items(), key=lambda kv: (kv[1], kv[0]))[0]


class ConsistentHashRing:
    """The classic consistent-hash ring over member names — the ONE
    construction both routing tiers use: the fleet's replica ring
    (:class:`PrefixAffinityRouter`) and, in the JAX package, the region's
    cell ring. ``vnodes`` virtual points per member,
    sorted by a process-stable sha256-derived hash; a key routes to the
    first point clockwise. Membership changes move a bounded key set:
    a join moves ~1/(N+1) of keys (all TO the joiner), a leave moves
    only the leaver's own keys — the property failover at BOTH tiers
    depends on (one dead cell must not reshuffle the healthy cells'
    working sets any more than one dead replica may)."""

    def __init__(self, vnodes: int = 64):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.vnodes = int(vnodes)
        self._ring: List[Tuple[int, str]] = []   # (point, member) sorted
        self._points: List[int] = []             # parallel sorted points
        self._members: set = set()

    @property
    def members(self) -> set:
        return set(self._members)

    def join(self, member: str) -> None:
        if member in self._members:
            return
        self._members.add(member)
        for i in range(self.vnodes):
            point = _hash64(f"{member}#{i}")
            j = bisect.bisect_left(self._points, point)
            self._points.insert(j, point)
            self._ring.insert(j, (point, member))

    def leave(self, member: str) -> None:
        if member not in self._members:
            return
        self._members.discard(member)
        keep = [(p, r) for p, r in self._ring if r != member]
        self._ring = keep
        self._points = [p for p, _ in keep]

    def walk(self, h: int,
             eligible: Optional[Callable[[str], bool]] = None
             ) -> Optional[str]:
        """First member clockwise from ``h``, skipping ones ``eligible``
        rejects (each DISTINCT member is offered to ``eligible`` at most
        once — the walk's cost is O(distinct members examined), not
        O(vnodes)). None when the ring is empty or nothing qualifies."""
        if not self._ring:
            return None
        start = bisect.bisect_right(self._points, h) % len(self._ring)
        seen: set = set()
        for off in range(len(self._ring)):
            _, rep = self._ring[(start + off) % len(self._ring)]
            if rep in seen:
                continue
            seen.add(rep)
            if eligible is None or eligible(rep):
                return rep
            if len(seen) == len(self._members):
                break
        return None


class RouterPolicy:
    """Base router: pick a replica name for a prompt.

    ``replicas`` is the caller's current view: an ordered mapping of
    name -> load (smaller = less loaded) restricted to replicas that can
    accept work — health filtering happens before the router sees them.
    """

    name = "base"

    def route(self, replicas: Dict[str, float],
              prompt: Sequence[int]) -> str:
        raise NotImplementedError

    def route_info(self) -> Dict[str, Any]:
        """Attrs describing the LAST ``route()`` verdict — consumed by
        the fleet's per-request "route" tracer span (telemetry/
        tracing.py) so the affinity hit/miss decision is visible on the
        request's timeline. Stateless routers report nothing."""
        return {}

    # membership hooks (stateful routers maintain a ring)
    def on_join(self, replica: str) -> None:
        pass

    def on_leave(self, replica: str) -> None:
        pass


class LeastLoadedRouter(RouterPolicy):
    """Route to the least-loaded healthy replica (ties break by name for
    determinism)."""

    name = "least_loaded"

    def route(self, replicas: Dict[str, float],
              prompt: Sequence[int]) -> str:
        return least_loaded_pick(replicas)


class PrefixAffinityRouter(RouterPolicy):
    """Consistent-hash routing on the prompt's full-block prefix.

    ``spill_load`` (0 = off) is the load-shedding valve: when the ring's
    choice already carries at least that much load AND some other healthy
    replica is strictly less loaded, the request spills to least-loaded
    instead — affinity is a throughput optimisation, not a hostage
    situation. Spills are reported as affinity misses.
    """

    name = "prefix_affinity"

    def __init__(self, block_size: int, vnodes: int = 64,
                 spill_load: int = 0):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.block_size = int(block_size)
        self.vnodes = int(vnodes)
        self.spill_load = int(spill_load)
        self._hash_ring = ConsistentHashRing(vnodes=vnodes)
        # set by route(): True when the last pick was the ring's primary
        # owner (an affinity hit), False on ring-walk fallback or spill
        self.last_was_primary: Optional[bool] = None
        # set by route(): True when the spill valve redirected the pick
        self.last_spilled: bool = False

    # -- membership ------------------------------------------------------
    def on_join(self, replica: str) -> None:
        self._hash_ring.join(replica)

    def on_leave(self, replica: str) -> None:
        self._hash_ring.leave(replica)

    # -- routing ---------------------------------------------------------
    def _hash_for(self, prompt: Sequence[int]) -> int:
        return _hash64(",".join(map(str,
                                    prefix_key(prompt, self.block_size))))

    def owner(self, prompt: Sequence[int],
              eligible: Optional[Callable[[str], bool]] = None
              ) -> Optional[str]:
        """The ring's pick for this prompt: the first replica clockwise
        from the key's hash, skipping ones ``eligible`` rejects. None
        when the ring is empty or nothing is eligible."""
        return self.owner_from_hash(self._hash_for(prompt), eligible)

    def owner_from_hash(self, h: int,
                        eligible: Optional[Callable[[str], bool]] = None
                        ) -> Optional[str]:
        """Ring walk from a precomputed key hash (``route`` needs both
        the unconditional primary and the health-filtered pick — hashing
        the prompt once serves both walks)."""
        return self._hash_ring.walk(h, eligible)

    def route(self, replicas: Dict[str, float],
              prompt: Sequence[int]) -> str:
        if not replicas:
            raise NoHealthyReplica("no healthy replica to route to")
        # the ring may know replicas the health view excludes (draining /
        # dead): walk past them. Primary = first ring owner regardless of
        # health — routing to anyone else counts as an affinity miss.
        h = self._hash_for(prompt)
        primary = self.owner_from_hash(h)
        chosen = self.owner_from_hash(h, eligible=lambda r: r in replicas)
        if chosen is None:
            # membership drifted (replica joined the fleet but not the
            # ring yet, or vice versa): degrade to least-loaded
            chosen = least_loaded_pick(replicas)
        self.last_spilled = False
        if self.spill_load > 0 and replicas[chosen] >= self.spill_load:
            alt = least_loaded_pick(replicas)
            if replicas[alt] < replicas[chosen]:
                chosen = alt
                self.last_spilled = True
        self.last_was_primary = (chosen == primary)
        return chosen

    def route_info(self) -> Dict[str, Any]:
        return {"affinity_hit": self.last_was_primary,
                "spilled": self.last_spilled}


class ResidencyAwareRouter(PrefixAffinityRouter):
    """Prefix-affinity routing that consults the global KV tier's
    :class:`~.kvtier.PrefixDirectory` FIRST (docs/serving.md "Global KV
    tier"): when a bounded-staleness-fresh directory entry says some
    healthy replica already holds the prompt's full-block prefix, the
    request routes to the least-loaded such holder — *residency* beats
    pure hash affinity, because the pages are where they are, not where
    the ring says they should be (failover, spills and adoption all move
    pages off the ring owner). The fallback matrix:

    * fresh holder in the health view  -> residency pick
    * entries exist but all stale      -> affinity ring (outcome
      ``directory_stale`` — the directory lied or lagged; the ring is
      never wrong about *where to build* the prefix, only about where it
      already exists)
    * no entry / no healthy holder     -> affinity ring (plain miss)
    * residency pick over ``spill_load`` while someone idles -> affinity
      ring path with its spill valve (residency is a throughput
      optimisation, not a hostage situation — same rule as affinity)

    The directory is attached after construction (``set_directory``) —
    the fleet builds it only when ``serving.kv_tier.enabled``; without
    one this router IS a ``PrefixAffinityRouter``, bit-for-bit."""

    name = "residency"

    def __init__(self, block_size: int, vnodes: int = 64,
                 spill_load: int = 0, directory=None, now_fn=None):
        super().__init__(block_size=block_size, vnodes=vnodes,
                         spill_load=spill_load)
        self.directory = directory
        self.now_fn = now_fn if now_fn is not None else (lambda: 0.0)
        # set by route(): "residency" | "affinity" | "directory_stale"
        self.last_outcome: Optional[str] = None

    def set_directory(self, directory, now_fn) -> None:
        self.directory = directory
        self.now_fn = now_fn

    def route(self, replicas: Dict[str, float],
              prompt: Sequence[int]) -> str:
        if not replicas:
            raise NoHealthyReplica("no healthy replica to route to")
        stale_only = False
        if self.directory is not None:
            h = self._hash_for(prompt)
            fresh, stale_only = self.directory.holders(h, self.now_fn())
            eligible = [m for m in fresh if m in replicas]
            if eligible:
                chosen = min(eligible, key=lambda n: (replicas[n], n))
                over = (self.spill_load > 0
                        and replicas[chosen] >= self.spill_load
                        and min(replicas.values()) < replicas[chosen])
                if not over:
                    self.last_spilled = False
                    self.last_was_primary = \
                        (chosen == self.owner_from_hash(h))
                    self.last_outcome = "residency"
                    return chosen
        chosen = super().route(replicas, prompt)
        self.last_outcome = "directory_stale" if stale_only else "affinity"
        return chosen

    def route_info(self) -> Dict[str, Any]:
        info = super().route_info()
        info["outcome"] = self.last_outcome
        return info


def make_router(name: str, *, block_size: int = 16, vnodes: int = 64,
                spill_load: int = 0) -> RouterPolicy:
    """Router factory for config-driven selection."""
    if name == "least_loaded":
        return LeastLoadedRouter()
    if name == "prefix_affinity":
        return PrefixAffinityRouter(block_size=block_size, vnodes=vnodes,
                                    spill_load=spill_load)
    if name == "residency":
        return ResidencyAwareRouter(block_size=block_size, vnodes=vnodes,
                                    spill_load=spill_load)
    raise ValueError(f"unknown router '{name}' (expected 'least_loaded', "
                     "'prefix_affinity' or 'residency')")
