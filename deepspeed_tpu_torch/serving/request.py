"""Request descriptor and lifecycle state machine for the serving layer.

Ports ``deepspeed_tpu/serving/request.py`` (host Python; the port keeps
its own copy).

A :class:`Request` is the unit the serving front-end schedules: one
prompt, one output stream, one SLO. The state machine is the contract
every scheduler policy and the driver loop must respect:

    QUEUED -> PREFILL -> DECODE -> FINISHED
       |         |          |
       |         +----------+--> QUEUED     (preemption / tick-fault retry)
       |         |          |
       +---------+----------+--> CANCELLED  (user cancel; fault budget spent)
       |
       +--> REJECTED                        (full queue; hopeless deadline)

FINISHED / CANCELLED / REJECTED are terminal; any other transition is a
programming error and raises :class:`InvalidTransition` instead of
silently corrupting accounting. The re-queue edge (preemption) carries
the tokens generated so far: on re-admission the engine prefills
``prompt + emitted`` — with the prefix cache on, mostly from cached KV
pages — and greedy decode continues the stream bit-exactly.

The reference's serving front-end (MII / FastGen,
``mii/batching/ragged_batching.py``) tracks the same lifecycle across
several ad-hoc queues; here it is one explicit, validated enum.
"""

from __future__ import annotations

import enum
import itertools
import threading
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from ..resilience.clock import get_clock


class RequestState(enum.Enum):
    QUEUED = "queued"        # submitted, not yet admitted to the engine
    PREFILL = "prefill"      # admitted; prompt KV being built (SplitFuse)
    DECODE = "decode"        # prompt done; generating one token per tick
    FINISHED = "finished"    # max_new_tokens or EOS reached
    CANCELLED = "cancelled"  # user cancel or fault budget exhausted
    REJECTED = "rejected"    # never admitted (full queue / hopeless SLO)


TERMINAL_STATES = frozenset(
    {RequestState.FINISHED, RequestState.CANCELLED, RequestState.REJECTED})

_VALID_TRANSITIONS = {
    RequestState.QUEUED: {RequestState.PREFILL, RequestState.CANCELLED,
                          RequestState.REJECTED},
    RequestState.PREFILL: {RequestState.DECODE, RequestState.QUEUED,
                           RequestState.CANCELLED},
    RequestState.DECODE: {RequestState.FINISHED, RequestState.QUEUED,
                          RequestState.CANCELLED},
    RequestState.FINISHED: set(),
    RequestState.CANCELLED: set(),
    RequestState.REJECTED: set(),
}


class InvalidTransition(RuntimeError):
    """An illegal request state transition (driver/scheduler bug)."""


_uid_counter = itertools.count(1)


@dataclass
class Request:
    """One serving request: prompt in, token stream out, SLO attached.

    ``priority`` — larger is more important; the SLO policy admits higher
    tiers first and preempts lower tiers under KV pressure. ``deadline_s``
    / ``ttft_deadline_s`` are RELATIVE to submission; absolute clocks are
    derived at submit time. ``on_token`` is invoked from the driver thread
    once per emitted token — it must be cheap and must not call back into
    the serving engine (deadlock: the driver holds the engine lock).
    """

    prompt: List[int]
    max_new_tokens: int = 128
    eos_token_id: Optional[int] = None
    priority: int = 0
    deadline_s: Optional[float] = None       # end-to-end SLO, from submit
    ttft_deadline_s: Optional[float] = None  # first-token SLO, from submit
    on_token: Optional[Callable[[int], None]] = None
    uid: int = field(default_factory=lambda: next(_uid_counter))
    # stable LOGICAL id: survives re-routing, fail-over and prefill→decode
    # hand-off across replicas, so one request is one id in requests.jsonl
    # no matter how many engines touched it. Defaults to a uid-derived
    # string; callers pass their own to correlate with client-side logs.
    client_request_id: Optional[str] = None
    # tenant key for canary routing (serving/rollout.py): requests from
    # one tenant land on one side of the canary split for the whole
    # rollout — a tenant never sees the version ping-pong a per-request
    # coin flip would produce. None falls back to client_request_id.
    tenant: Optional[str] = None

    # -- lifecycle bookkeeping (driver-owned; read-only for callers) ----
    state: RequestState = RequestState.QUEUED
    tokens: List[int] = field(default_factory=list)   # emitted so far
    error: Optional[str] = None
    preemptions: int = 0
    retries: int = 0          # tick-fault re-queues (distinct from preempts)
    # speculative-decoding ledger (serving tick, docs/serving.md):
    # draft tokens proposed/accepted for THIS request across its whole
    # life (they travel with it through failover/hand-off) — stamped
    # into the terminal RequestStats record
    spec_proposed: int = 0
    spec_accepted: int = 0
    # model-version ledger (serving/rollout.py): ``model_version`` is the
    # version this request was ROUTED to (stamped at placement; may be
    # re-stamped while no tokens are out yet), ``served_versions`` the
    # distinct versions that actually EMITTED tokens, in order — the DST
    # two-version-stream invariant audits len(set(served_versions)) <= 1
    model_version: Optional[int] = None
    served_versions: List[int] = field(default_factory=list)
    t_submit: Optional[float] = None     # clock.now() stamps
    t_admit: Optional[float] = None      # last admission (re-set on resume)
    t_first_admit: Optional[float] = None
    t_first_token: Optional[float] = None
    t_finish: Optional[float] = None

    def __post_init__(self):
        self.prompt = [int(t) for t in self.prompt]
        if not self.prompt:
            raise ValueError("Request needs a non-empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        if self.client_request_id is None:
            self.client_request_id = f"req-{self.uid:08d}"
        elif not isinstance(self.client_request_id, str):
            raise ValueError("client_request_id must be a string")
        if self.tenant is not None and not isinstance(self.tenant, str):
            raise ValueError("tenant must be a string")
        self._done = threading.Event()
        # the clock this request's whole lifecycle is timed on, captured
        # at construction: deadlines, terminal stamps and SLO verdicts
        # must all read ONE timebase even if the global seam is swapped
        # mid-flight (a request submitted under a SimClock is judged
        # under it to the end)
        self._clock = get_clock()
        # driver-internal: the next token to feed the engine (produced by
        # the previous tick's logits, not yet admitted as context)
        self._pending_token: Optional[int] = None
        self._cancel_requested = False
        # fleet-internal: hand this request from its prefill replica to a
        # decode replica once its first token resolves (disaggregated mode)
        self._handoff_requested = False
        # routing witness, stamped by the fleet: the soft canary/stable
        # version preference had no accepting capacity and this request
        # spilled to whatever could serve (availability over version
        # affinity)
        self._canary_spilled = False
        # speculative-decoding driver state: rolling per-request
        # acceptance EMA (optimistic start — a fresh request gets full
        # drafts until it proves unpredictable) and the per-request
        # fallback latch (below the configured floor drafting stops for
        # good; the stream stays token-identical either way)
        self._spec_ema = 1.0
        self._spec_disabled = False
        # distributed tracing (telemetry/tracing.py): the request's open
        # root span and its current lifecycle segment. Both stay None
        # with tracing off; the tree travels WITH the request across
        # replicas (failover, disaggregated hand-off) so its whole life
        # is one connected trace.
        self._trace_root = None
        self._trace_seg = None

    # -- state machine --------------------------------------------------
    def transition(self, new: RequestState) -> None:
        if new not in _VALID_TRANSITIONS[self.state]:
            raise InvalidTransition(
                f"request {self.uid}: illegal transition "
                f"{self.state.name} -> {new.name}")
        self.state = new
        if new in TERMINAL_STATES:
            self.t_finish = self._clock.now()
            self._done.set()

    @property
    def is_terminal(self) -> bool:
        return self.state in TERMINAL_STATES

    @property
    def is_live(self) -> bool:
        """Admitted to the engine (holds a slot + KV blocks)."""
        return self.state in (RequestState.PREFILL, RequestState.DECODE)

    # -- deadlines ------------------------------------------------------
    def absolute_deadline(self) -> Optional[float]:
        if self.deadline_s is None or self.t_submit is None:
            return None
        return self.t_submit + self.deadline_s

    def in_slo(self, now: Optional[float] = None) -> Optional[bool]:
        """Whether the request met its SLO (None when it carries none).
        For a finished request this judges the finish time; for a live
        one, whether the SLO is still achievable as of ``now``."""
        dl = self.absolute_deadline()
        verdicts = []
        if dl is not None:
            t = self.t_finish if self.t_finish is not None else \
                (now if now is not None else self._clock.now())
            verdicts.append(t <= dl)
        if self.ttft_deadline_s is not None and self.t_submit is not None:
            t = self.t_first_token
            if t is None:
                t = now if now is not None else self._clock.now()
            verdicts.append(t <= self.t_submit + self.ttft_deadline_s)
        if not verdicts:
            return None
        return all(verdicts)

    # -- results --------------------------------------------------------
    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until terminal. Returns False on timeout. Waits on the
        request's clock: under a SimClock this pumps the simulation's
        drive function instead of parking the thread."""
        return self._clock.wait_event(self._done, timeout)

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Wait and return the emitted tokens. Raises on non-FINISHED
        terminal states (cancelled / rejected requests have no result)."""
        if not self.wait(timeout):
            raise TimeoutError(f"request {self.uid} still {self.state.name}")
        if self.state is not RequestState.FINISHED:
            raise RuntimeError(
                f"request {self.uid} ended {self.state.name}"
                + (f": {self.error}" if self.error else ""))
        return list(self.tokens)

    # -- spans ----------------------------------------------------------
    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.t_submit is None or self.t_first_admit is None:
            return None
        return self.t_first_admit - self.t_submit

    @property
    def ttft_s(self) -> Optional[float]:
        if self.t_submit is None or self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit

    @property
    def latency_s(self) -> Optional[float]:
        if self.t_submit is None or self.t_finish is None:
            return None
        return self.t_finish - self.t_submit
