"""Pluggable admission / preemption policies for the serving driver.

Ports ``deepspeed_tpu/serving/scheduler.py``. The driver loop
(:mod:`.server`) runs one engine tick at a time; a policy decides, per
tick, *which* queued requests to admit and *which* live decodes to evict
under KV pressure. The engine's Dynamic-SplitFuse packing then fits the
admitted set into the step; a policy never touches the token budget.

Two policies ship:

* :class:`FCFSPolicy` — strict arrival order with head-of-line blocking
  (the request at the head that does not fit stalls everyone behind it),
  no rejection, no preemption. This is the reference baseline: what the
  FastGen/MII front-end does absent any SLO machinery, and the A/B
  control the evidence lane measures against.
* :class:`SLOPolicy` — deadline-aware serving: admission ordered by
  (priority tier, earliest absolute deadline); queued requests whose
  deadline already passed are rejected instead of burning engine capacity
  on guaranteed SLO misses; smaller feasible requests may overtake a
  misfit (no head-of-line blocking); and under KV-pool pressure — or
  outright slot exhaustion — the lowest-priority / latest-deadline live
  decodes are preempted to make room for strictly-higher-priority
  arrivals. Preempted requests re-queue
  with their generated tokens and resume bit-exactly (re-prefill rides
  the prefix cache when enabled).

A policy sees capacity only through :class:`CapacityView` — a per-tick
closure over the engine's ``can_schedule`` that accounts for requests
already admitted earlier in the same tick.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from .request import Request, RequestState


class CapacityView:
    """Read-only admission oracle for one tick: slots + KV blocks,
    charged incrementally as the driver admits. When reserving output,
    LIVE requests' not-yet-materialised growth (admitted on an earlier
    tick, still decoding toward max_new_tokens) is charged too —
    otherwise the reservation only binds on the admitting tick and two
    requests admitted one tick apart can still exhaust the pool
    mid-decode."""

    def __init__(self, engine, reserve_output: bool = True,
                 live: Sequence[Request] = ()):
        self._engine = engine
        self._reserve_output = reserve_output
        self._admitted_uids: List[int] = []
        self._admitted_lens: List[int] = []
        self._live_reserved: dict = {}        # uid -> future-growth blocks
        if reserve_output:
            for r in live:
                seq = engine.seqs.get(r.uid)
                if seq is None:
                    continue
                need = engine.blocks_needed(len(r.prompt) + r.max_new_tokens)
                self._live_reserved[r.uid] = max(0, need - len(seq.blocks))

    def _length_for(self, req: Request) -> int:
        """Blocks to charge at admission: the resume context plus (when
        reserving) the whole remaining output, so a request admitted now
        cannot exhaust the pool mid-decode."""
        ctx = len(req.prompt) + len(req.tokens)
        if self._reserve_output:
            ctx += max(0, req.max_new_tokens - len(req.tokens))
        return ctx

    @property
    def free_slots(self) -> int:
        return (len(self._engine._free_slots)
                - len(self._admitted_uids))

    def fits(self, req: Request) -> bool:
        if self.free_slots < 1:
            return False
        if self._length_for(req) > self._engine.config.max_context:
            return False
        if not self._engine.can_schedule(
                self._admitted_uids + [req.uid],
                self._admitted_lens + [self._length_for(req)]):
            return False
        return self.blocks_short(req) <= 0

    def charge(self, req: Request) -> None:
        """Record an admission so later ``fits`` calls see the cost."""
        self._admitted_uids.append(req.uid)
        self._admitted_lens.append(self._length_for(req))

    def uncharge_live(self, req: Request) -> None:
        """Drop a live request's future-growth reservation (it was
        preempted this tick: its blocks and reservation are gone)."""
        self._live_reserved.pop(req.uid, None)

    def blocks_short(self, req: Request) -> int:
        """KV blocks missing for ``req`` (0 when it fits the pool),
        counting this tick's admissions AND live requests' reserved
        future growth. Drives how much the preemption pass must evict."""
        need = self._engine.blocks_needed(self._length_for(req))
        for length in self._admitted_lens:
            need += self._engine.blocks_needed(length)
        need += sum(self._live_reserved.values())
        return max(0, need - self._engine._available_blocks())

    # -- speculative token credit: drafting spends only the tick's
    # token-budget slack, sized by the class acceptance EMA
    def draft_budget(self, n_decodes: int, prefill_tokens: int) -> int:
        """Token-budget slack draft chains may add this tick: the engine
        budget minus one token a live decode minus the prefill backlog's
        claim (pending prompt tokens, capped at the budget). Prefill's
        claim comes off the top, so drafting never starves prompt
        progress; with no slack the tick is a plain decode."""
        budget = self._engine.config.token_budget
        claim = min(max(0, int(prefill_tokens)), budget)
        return max(0, budget - max(0, int(n_decodes)) - claim)

    @staticmethod
    def chain_len_for(accept_ema: float, lookahead: int) -> int:
        """Draft length under the class acceptance EMA: the lookahead
        scaled by the EMA (rounded). A cold class keeps a one-token probe,
        or its EMA could never move again; a hopeless request is the
        fallback latch's business (``spec_accept_floor``)."""
        if lookahead < 1:
            return 0
        c = min(1.0, max(0.0, float(accept_ema)))
        return max(1, min(int(lookahead), int(c * lookahead + 0.5)))

    def evictable_blocks(self, seq) -> int:
        """Pages that actually become schedulable if ``seq`` is evicted:
        those whose every non-cache reference is this sequence's own
        (they end up free, or cache-only-held — which admission reclaims
        on demand). Pages shared with another live sequence stay held
        and must not be credited, or preemption evicts decodes without
        making the candidate fit."""
        alloc = self._engine.allocator
        cache = self._engine.prefix_cache
        cache_refs = cache._block_refs if cache is not None else {}
        counts: dict = {}
        for b in seq.blocks:
            counts[int(b)] = counts.get(int(b), 0) + 1
        return sum(1 for b, n in counts.items()
                   if alloc.refcount(b) <= n + cache_refs.get(b, 0))

    @property
    def occupancy(self) -> float:
        return self._engine.kv_occupancy()


class SchedulerPolicy:
    """Base policy: order the queue; optionally reject and preempt."""

    name = "base"
    #: stop admitting at the first queued request that does not fit
    #: (True = strict FIFO semantics with head-of-line blocking)
    head_of_line_blocking = True

    def admission_order(self, queued: Sequence[Request],
                        now: float) -> List[Request]:
        raise NotImplementedError

    def should_reject(self, req: Request, now: float) -> Optional[str]:
        """Reject reason for a queued request, or None to keep it."""
        return None

    def preemption_victims(self, candidate: Request,
                           live: Sequence[Request],
                           capacity: CapacityView,
                           now: float) -> List[Request]:
        """Live requests to evict so ``candidate`` can be admitted.
        Empty list = do not preempt (candidate stays queued)."""
        return []


class FCFSPolicy(SchedulerPolicy):
    """First-come-first-served: the no-SLO baseline."""

    name = "fcfs"
    head_of_line_blocking = True

    def admission_order(self, queued, now):
        return sorted(queued, key=lambda r: (r.t_submit, r.uid))


class SLOPolicy(SchedulerPolicy):
    """Deadline-aware admission (priority tiers, then EDF) with expired-
    request rejection and preemption of lower-priority decodes under KV
    pressure or slot exhaustion."""

    name = "slo"
    head_of_line_blocking = False

    def __init__(self, kv_pressure: float = 0.90,
                 reject_expired: bool = True,
                 preemption: bool = True):
        # preempt only when the pool is genuinely tight — below this
        # occupancy a misfit is a transient (e.g. slot exhaustion) and
        # eviction would thrash the cache for nothing
        self.kv_pressure = float(kv_pressure)
        self.reject_expired = bool(reject_expired)
        self.preemption = bool(preemption)

    @staticmethod
    def _deadline_key(req: Request) -> float:
        dl = req.absolute_deadline()
        return dl if dl is not None else float("inf")

    def admission_order(self, queued, now):
        # higher priority first; within a tier, earliest deadline first
        # (EDF is optimal for feasible single-machine deadline schedules);
        # deadline-less requests trail their tier in arrival order
        return sorted(queued, key=lambda r: (-r.priority,
                                             self._deadline_key(r),
                                             r.t_submit, r.uid))

    def should_reject(self, req: Request, now: float) -> Optional[str]:
        if not self.reject_expired:
            return None
        dl = req.absolute_deadline()
        if dl is not None and now > dl:
            return "deadline expired in queue"
        if (req.ttft_deadline_s is not None and req.t_submit is not None
                and req.t_first_token is None
                and now > req.t_submit + req.ttft_deadline_s):
            # the SLO verdict requires EVERY deadline to hold, so a
            # missed TTFT is unsalvageable even with a live end-to-end
            # deadline: serving it is pure goodput loss
            return "ttft deadline expired in queue"
        return None

    def preemption_victims(self, candidate, live, capacity, now):
        if not self.preemption:
            return []
        # two distinct shortages trigger eviction: KV-pool pressure (the
        # occupancy gate keeps transient misfits from thrashing the cache)
        # and SLOT exhaustion — every sequence slot held by a
        # lower-priority decode. Slot shortage bypasses the occupancy
        # gate: one eviction frees exactly one slot, and without it a
        # high-priority arrival could starve behind low-priority decodes
        # while the KV pool sits half empty.
        slot_short = capacity.free_slots < 1
        if not slot_short and capacity.occupancy < self.kv_pressure:
            return []
        # victims: DECODE-state requests of strictly lower priority —
        # never equal-tier (thrash: two peers evicting each other), never
        # mid-prefill (their KV is the most expensive to rebuild per
        # token emitted so far). Latest deadline dies first.
        pool = [r for r in live
                if r.state is RequestState.DECODE
                and r.priority < candidate.priority]
        pool.sort(key=lambda r: (r.priority, -self._deadline_key(r),
                                 -(r.t_submit or 0.0)))
        short = capacity.blocks_short(candidate)
        victims: List[Request] = []
        freed = 0
        for r in pool:
            if freed >= short and (victims or not slot_short):
                break
            victims.append(r)
            # credit only pages that genuinely become schedulable —
            # pages shared with another live sequence stay held — plus
            # the victim's reserved-but-unmaterialised future growth
            seq = capacity._engine.seqs.get(r.uid)
            freed += capacity.evictable_blocks(seq) if seq is not None else 0
            freed += capacity._live_reserved.get(r.uid, 0)
        if freed < short or (slot_short and not victims):
            return []          # evicting would not make the candidate fit
        return victims


def make_policy(name: str, **kwargs) -> SchedulerPolicy:
    """Policy factory for config-driven selection."""
    if name == "fcfs":
        return FCFSPolicy()
    if name == "slo":
        return SLOPolicy(**kwargs)
    raise ValueError(f"unknown scheduler policy '{name}' "
                     "(expected 'fcfs' or 'slo')")
