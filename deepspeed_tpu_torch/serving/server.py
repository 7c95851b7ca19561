"""The serving front-end: request lifecycle over the ragged engine.

Ports the ``ServingEngine`` core of ``deepspeed_tpu/serving/server.py``:

* ``submit()`` with bounded-queue backpressure: a full queue rejects
  explicitly (state REJECTED) instead of buffering unboundedly;
* a background driver thread runs one engine tick at a time — the policy
  (:mod:`.scheduler`) picks the request set, the engine's Dynamic-SplitFuse
  packing fits it into one ragged step;
* ``stream()`` yields tokens as the driver emits them;
* ``cancel()`` at any lifecycle stage releases the engine state it holds
  (slot + KV pages) with zero leaked blocks;
* preempted requests resume bit-exactly: the driver re-prefills
  ``prompt + emitted`` and greedy decode continues the identical stream;
* a tick fault (device error) discards the touched engine state — never
  publishing suspect KV into the prefix cache — and re-queues each touched
  request until its retry budget is spent;
* ``drain()`` stops admission and serves out the backlog;
* with ``serving.speculative``, eligible decodes carry prompt-lookup
  draft chains that the engine verifies in the tick's one ragged step
  (``put_spec``); the longest greedy-matching prefix is accepted and the
  rejected tail trimmed, so the streams stay token-identical to plain
  serving. Drafting spends only the tick's token-budget slack and is
  sized by a per-priority-class acceptance EMA; a request whose own EMA
  falls below the floor latches to plain decode.

Serving decodes greedily (argmax on the engine's returned logits).

The driver thread launches the CUDA work: it selects the server's device
before its first tick, and every launch goes to PyTorch's current stream
of that thread.

Not in the port yet (ROADMAP.md, Queue A items 4-5): hot swap,
migration and hand-off, adoption and the global KV tier, telemetry
spans, request events and digest, the stuck-tick watchdog and
preemption latch, chaos injection and gray-failure evidence.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..inference.ragged import PoolExhausted, block_balance_report
from ..resilience.clock import Clock, get_clock
from ..utils.device import resolve_device
from ..utils.logging import log_dist, logger
from .request import Request, RequestState
from .scheduler import CapacityView, SchedulerPolicy, make_policy


def stream_tokens(server, prompt: Sequence[int], **kwargs):
    """Streaming generator over a submit/cancel surface. Yields tokens as
    the driver emits them; breaking out (or ``close()``-ing the generator)
    cancels the request."""
    if "on_token" in kwargs:
        raise ValueError("stream() owns the on_token callback")
    q: "queue_mod.Queue[int]" = queue_mod.Queue()
    req = server.submit(prompt, on_token=q.put, **kwargs)
    if req.state is RequestState.REJECTED:
        raise RuntimeError(f"request rejected: {req.error}")
    try:
        emitted = 0
        while True:
            try:
                yield q.get(timeout=0.05)
                emitted += 1
            except queue_mod.Empty:
                if req.is_terminal:
                    break
        while emitted < len(req.tokens):   # tokens raced the sentinel
            yield q.get_nowait()
            emitted += 1
        if req.state is RequestState.REJECTED:
            raise RuntimeError(f"request rejected: {req.error}")
        if req.state is RequestState.CANCELLED and req.error:
            raise RuntimeError(f"request failed: {req.error}")
    finally:
        if not req.is_terminal:
            server.cancel(req)


class ServingEngine:
    """SLO-aware continuous-batching front-end over a
    :class:`~deepspeed_tpu_torch.inference.ragged.RaggedInferenceEngine`.

    ``device`` defaults to ``"cuda"`` (raising without a CUDA device
    unless ``device="cpu"`` is asked for) and must be the engine's.
    ``start=False`` leaves the driver thread off; :meth:`step` then runs
    one deterministic tick at a time."""

    def __init__(self, engine, config: Any = None,
                 policy: Optional[SchedulerPolicy] = None,
                 start: bool = True,
                 clock: Optional[Clock] = None,
                 device=None):
        from ..config import ServingConfig

        if config is None:
            config = ServingConfig()
        elif isinstance(config, dict):
            config = ServingConfig.from_dict(config)
        self.config = config
        self.device = resolve_device(device)
        if engine.device != self.device:
            raise ValueError(f"ServingEngine on {self.device} over an engine "
                             f"on {engine.device}: pass the engine's device")
        # a declared kv_quant must match the engine's own KV storage
        want_quant = str(config.kv_quant)
        have_quant = str(getattr(engine.config, "kv_quant", "none"))
        if want_quant != "none" and want_quant != have_quant:
            raise ValueError(
                f"serving.kv_quant='{want_quant}' but the engine stores "
                f"KV as '{have_quant}' — configure both from one source")
        self._engine = engine
        # speculative decoding needs the engine's draft / verify surface;
        # per-priority-class acceptance EMAs size the chains
        self._spec_on = bool(config.speculative) and \
            hasattr(engine, "put_spec") and hasattr(engine, "draft_tokens")
        self._spec_ema_by_class: Dict[int, float] = {}
        if config.speculative and not self._spec_on:
            logger.warning(
                "ServingEngine: serving.speculative requested but the "
                "engine has no put_spec/draft_tokens surface — serving "
                "plain decode")
        self.policy = policy if policy is not None else make_policy(
            config.policy, **(dict(kv_pressure=config.kv_pressure,
                                   reject_expired=config.reject_expired,
                                   preemption=config.preemption)
                              if config.policy == "slo" else {}))
        # every deadline, latency stamp and poll interval reads this clock
        self._clock = clock if clock is not None else get_clock()
        self._lock = threading.RLock()
        self._queue: List[Request] = []
        self._live: Dict[int, Request] = {}
        self._requests: Dict[int, Request] = {}   # uid -> non-terminal req
        self._accepting = True
        self._stop_evt = threading.Event()
        self._tick_count = 0
        self._driver: Optional[threading.Thread] = None
        log_dist(f"ServingEngine: policy={self.policy.name} "
                 f"max_queue={config.max_queue} device={self.device}"
                 + (f" speculative=on(lookahead={config.spec_lookahead})"
                    if self._spec_on else ""))
        if start:
            self.start()

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        if self._driver is not None:
            return
        self._driver = threading.Thread(target=self._drive, daemon=True,
                                        name="serving-driver")
        self._driver.start()

    def submit(self, prompt: Sequence[int], *,
               max_new_tokens: Optional[int] = None,
               eos_token_id: Optional[int] = None,
               priority: int = 0,
               deadline_s: Optional[float] = None,
               ttft_deadline_s: Optional[float] = None,
               client_request_id: Optional[str] = None,
               on_token=None) -> Request:
        """Enqueue a request. Returns immediately; the request may come
        back already REJECTED (full queue, serving closed, or a prompt the
        engine can never hold). Callers stream via ``on_token`` or block
        on ``request.result()``."""
        req = Request(prompt=list(prompt),
                      max_new_tokens=(max_new_tokens if max_new_tokens
                                      is not None
                                      else self.config.default_max_new_tokens),
                      eos_token_id=eos_token_id, priority=priority,
                      deadline_s=deadline_s, ttft_deadline_s=ttft_deadline_s,
                      client_request_id=client_request_id,
                      on_token=on_token)
        return self.submit_request(req)

    def submit_request(self, req: Request) -> Request:
        """Enqueue an existing QUEUED :class:`Request` (validated against
        the engine's context and pool capacity)."""
        if req.state is not RequestState.QUEUED:
            raise ValueError(
                f"submit_request needs a QUEUED request, got {req.state.name}")
        req._clock = self._clock
        if req.t_submit is None:
            req.t_submit = self._clock.now()
        with self._lock:
            if not self._accepting:
                self._reject(req, "serving closed to new requests")
            elif (len(req.prompt) + req.max_new_tokens
                    > self._engine.config.max_context):
                # would deadlock FCFS at the head of the queue forever
                self._reject(req, "prompt + max_new_tokens exceeds "
                                  "engine max_context")
            elif (self._engine.blocks_needed(len(req.prompt)
                                             + req.max_new_tokens)
                    > self._engine.allocator.n_blocks):
                # same deadlock via the KV pool: a request that can never
                # hold all its pages at once can never finish
                self._reject(req, "prompt + max_new_tokens exceeds "
                                  "engine KV pool capacity")
            elif len(self._queue) >= self.config.max_queue:
                self._reject(req, "admission queue full")
            else:
                self._requests[req.uid] = req
                self._queue.append(req)
        return req

    def stream(self, prompt: Sequence[int], **kwargs):
        """Generator yielding tokens as the driver emits them. Breaking
        out (or ``close()``-ing the generator) cancels the request."""
        return stream_tokens(self, prompt, **kwargs)

    def cancel(self, req) -> bool:
        """Cancel by Request or uid. QUEUED requests die immediately;
        live ones are released by the driver at the next tick boundary.
        Returns False for unknown/already-terminal requests."""
        with self._lock:
            if not isinstance(req, Request):
                req = self._requests.get(int(req))
            if req is None or req.is_terminal:
                return False
            req._cancel_requested = True
            if req.state is RequestState.QUEUED and req in self._queue:
                self._queue.remove(req)
                self._retire(req, RequestState.CANCELLED)
        return True

    def drain(self, timeout: Optional[float] = None,
              reject_queued: bool = False) -> bool:
        """Stop accepting new requests and serve out the backlog. With
        ``reject_queued`` the queue is rejected instead of served. Returns
        True when every request reached a terminal state within
        ``timeout``."""
        with self._lock:
            self._accepting = False
            if reject_queued:
                for req in list(self._queue):
                    self._queue.remove(req)
                    self._reject(req, "rejected at drain")
        deadline = self._clock.deadline(
            timeout if timeout is not None else self.config.drain_timeout_s)
        while self._clock.now() < deadline:
            with self._lock:
                if self._idle_locked():
                    return True
            self._clock.sleep(self.config.poll_interval_s)
        with self._lock:
            return self._idle_locked()

    def _idle_locked(self) -> bool:
        return not self._queue and not self._live

    def close(self, timeout: Optional[float] = None) -> None:
        """Graceful shutdown: drain, cancel whatever would not finish,
        stop the driver thread."""
        if not self.drain(timeout=timeout):
            with self._lock:
                stuck = list(self._queue) + list(self._live.values())
            for req in stuck:
                self.cancel(req)
            t0 = self._clock.now()
            while self._clock.now() - t0 < 5.0:
                with self._lock:
                    if self._idle_locked():
                        break
                self._clock.sleep(self.config.poll_interval_s)
        self._stop_evt.set()
        if self._driver is not None:
            self._driver.join(timeout=30.0)
            if self._driver.is_alive():
                logger.error("ServingEngine: driver thread did not stop "
                             "within 30 s")
        self._driver = None

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- introspection ---------------------------------------------------
    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    @property
    def live_requests(self) -> int:
        with self._lock:
            return len(self._live)

    def block_leaks(self) -> List[str]:
        """Allocator block-balance problems (empty = zero leak). Valid
        when idle (post-drain); mid-tick reads race the driver."""
        return block_balance_report(self._engine)["problems"]

    # -- driver ----------------------------------------------------------
    def step(self) -> bool:
        """One deterministic driver iteration — the manual-driving seam
        (``start=False``). Returns False when idle."""
        return self._tick()

    def _drive(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        poll = self.config.poll_interval_s
        while not self._stop_evt.is_set():
            try:
                did_work = self._tick()
            except Exception:
                # a driver-loop bug must not silently wedge every caller
                logger.exception("ServingEngine: driver tick crashed")
                did_work = False
            if not did_work:
                self._clock.wait_event(self._stop_evt, poll)

    def _tick(self) -> bool:
        """One driver iteration: cancellations, admission (+ preemption),
        one engine ``put()`` (``put_spec`` when draft chains ride along)
        and token dispatch. Returns False when idle."""
        with self._lock:
            self._process_cancellations()
            capacity = self._admit()
            uids, toks, drafts = self._build_feed(capacity)
        if not uids:
            return False
        self._tick_count += 1
        try:
            uids, logits, verified = self._put_with_recovery(uids, toks,
                                                             drafts)
        except Exception as e:
            self._on_tick_fault(uids, e)
            return True
        accepted = self._verify_drafts(verified)
        with self._lock:
            emissions, finished = self._dispatch(uids, logits, accepted)
        # user callbacks run OUTSIDE the serving lock, and BEFORE the
        # request turns terminal below, so stream() sees every token
        for req, tok in emissions:
            try:
                req.on_token(tok)
            except Exception:
                logger.exception(
                    f"ServingEngine: on_token callback failed "
                    f"(request {req.uid}); cancelling its stream")
                req._cancel_requested = True
        with self._lock:
            self._finish(finished)
        return True

    # -- tick phases (serving lock held) ---------------------------------
    def _process_cancellations(self) -> None:
        for uid, req in list(self._live.items()):
            if req._cancel_requested:
                self._release_engine_state(uid, publish=True)
                del self._live[uid]
                self._retire(req, RequestState.CANCELLED)

    def _admit(self) -> CapacityView:
        """Policy-ordered admission pass. Returns the tick's capacity
        view."""
        now = self._clock.now()
        capacity = CapacityView(self._engine,
                                reserve_output=self.config.reserve_output_blocks,
                                live=list(self._live.values()))
        for req in self.policy.admission_order(list(self._queue), now):
            if req._cancel_requested:
                self._queue.remove(req)
                self._retire(req, RequestState.CANCELLED)
                continue
            reason = self.policy.should_reject(req, now)
            if reason is not None:
                self._queue.remove(req)
                self._reject(req, reason)
                continue
            if not capacity.fits(req):
                victims = self.policy.preemption_victims(
                    req, list(self._live.values()), capacity, now)
                for victim in victims:
                    self._preempt(victim)
                    capacity.uncharge_live(victim)
                if not victims or not capacity.fits(req):
                    if self.policy.head_of_line_blocking:
                        break
                    continue
            self._queue.remove(req)
            req.transition(RequestState.PREFILL)
            req._pending_token = None
            self._live[req.uid] = req
            capacity.charge(req)
        return capacity

    def _preempt(self, victim: Request) -> None:
        self._release_engine_state(victim.uid, publish=True)
        self._live.pop(victim.uid, None)
        victim.transition(RequestState.QUEUED)
        victim.preemptions += 1
        victim._pending_token = None
        self._queue.append(victim)
        logger.info(f"ServingEngine: preempted request {victim.uid} "
                    f"(priority {victim.priority}, "
                    f"{len(victim.tokens)} tokens in)")

    def _build_feed(self, capacity: CapacityView
                    ) -> Tuple[List[int], List[List[int]], List[List[int]]]:
        """This tick's ``put()`` arguments: full resume context for
        freshly admitted requests, empty continuation chunks for
        mid-prefill ones, one pending decode token each for the rest.

        With speculative serving on, eligible decodes also get a draft
        chain, sized by the class acceptance credit
        (``CapacityView.chain_len_for``) and paid for out of the tick's
        token-budget slack (``CapacityView.draft_budget``)."""
        uids: List[int] = []
        toks: List[List[int]] = []
        drafts: List[List[int]] = []
        decode_rows: List[Tuple[int, Request]] = []
        prefill_tokens = 0
        for uid, req in self._live.items():
            seq = self._engine.seqs.get(uid)
            if seq is None:
                uids.append(uid)
                toks.append(req.prompt + req.tokens)
                prefill_tokens += len(req.prompt) + len(req.tokens)
            elif seq.pending > 0:
                uids.append(uid)
                toks.append([])
                prefill_tokens += seq.pending
            elif req._pending_token is not None:
                uids.append(uid)
                toks.append([req._pending_token])
                decode_rows.append((len(uids) - 1, req))
            else:
                continue
            drafts.append([])
        if self._spec_on and decode_rows:
            slack = capacity.draft_budget(len(decode_rows), prefill_tokens)
            cfg = self.config
            for i, req in decode_rows:
                if slack <= 0:
                    break
                if req._spec_disabled:
                    continue
                ema = self._spec_ema_by_class.get(req.priority, 1.0)
                k = CapacityView.chain_len_for(ema, cfg.spec_lookahead)
                seq = self._engine.seqs[req.uid]
                k = min(k, slack,
                        self._engine.config.max_context - seq.seen - 1,
                        req.max_new_tokens - len(req.tokens) - 1)
                if k <= 0:
                    continue
                guesses = self._engine.draft_tokens(
                    req.uid, req._pending_token, cfg.spec_ngram, k)
                if guesses:
                    drafts[i] = guesses
                    slack -= len(guesses)
        return uids, toks, drafts

    # -- tick phases (lock NOT held) ------------------------------------
    def _put_with_recovery(self, uids, toks, drafts):
        """One engine tick; on KV-pool exhaustion, preempt the cheapest
        decode and retry. Tokens are admitted to the engine's descriptors
        before its pool check, so retries feed empty chunks — and an
        evicted victim leaves the feed entirely. Returns (uids, logits,
        verified chains).

        With draft chains the first attempt is the verify step
        (``put_spec``); a PoolExhausted there strips every draft token
        before raising, so the retry is a plain put of the admitted feed:
        speculation is never worth an eviction."""
        uids, toks = list(uids), list(toks)
        use_spec = any(drafts)
        attempts = 0
        while True:
            try:
                if use_spec:
                    out, verified = self._engine.put_spec(uids, toks,
                                                          list(drafts))
                    return uids, out, verified
                return uids, self._engine.put(uids, toks), {}
            except PoolExhausted:
                # typed catch: a device error takes the tick-fault path
                # once instead of preempting healthy decodes
                use_spec = False       # the drafts were stripped
                with self._lock:
                    if attempts >= len(self._live):
                        raise
                    attempts += 1
                    victim = self._pool_pressure_victim(set(uids))
                    if victim is None:
                        raise
                    self._preempt(victim)
                    if victim.uid in uids:
                        i = uids.index(victim.uid)
                        uids.pop(i)
                        toks.pop(i)
                    if not uids:
                        raise
                toks = [[] for _ in uids]   # already admitted: continue only

    def _pool_pressure_victim(self, feed_uids) -> Optional[Request]:
        """Mid-tick eviction pick when the pool runs dry despite admission
        control: the lowest-priority, latest-deadline decode — preferring
        one outside this tick's feed."""
        pool = [r for r in self._live.values()
                if r.state is RequestState.DECODE]
        if not pool:
            return None
        dl = getattr(self.policy, "_deadline_key", lambda r: float("inf"))
        pool.sort(key=lambda r: (r.priority, -dl(r)))
        for r in pool:
            if r.uid not in feed_uids:
                return r
        return pool[0]

    def _on_tick_fault(self, uids, exc: Exception) -> None:
        """A tick died. Engine state for every touched uid is suspect, so
        it is DISCARDED (never published into the prefix cache) and each
        request retries from its token stream, or fails once its budget
        is spent. No block leaks either way."""
        logger.warning(f"ServingEngine: tick {self._tick_count} fault: "
                       f"{type(exc).__name__}: {exc}")
        with self._lock:
            for uid in uids:
                self._release_engine_state(uid, publish=False)
                req = self._live.pop(uid, None)
                if req is None:
                    continue
                req._pending_token = None
                if req._cancel_requested:
                    self._retire(req, RequestState.CANCELLED)
                    continue
                req.retries += 1
                if req.retries <= self.config.tick_retry_limit:
                    req.transition(RequestState.QUEUED)
                    self._queue.append(req)
                else:
                    req.error = (f"tick fault after {req.retries - 1} "
                                 f"retries: {exc}")
                    self._retire(req, RequestState.CANCELLED)

    def _verify_drafts(self, verified) -> Dict[int, List[int]]:
        """Greedy accept / trim pass over the tick's verified draft chains
        (driver thread, outside the serving lock: a trim may copy a
        page). Each chain's longest argmax-matching prefix is accepted —
        row 0 is exactly the plain tick's logits, so the stream is
        token-identical to plain serving by induction — and the engine
        rewinds to the validated context. Returns uid -> the tokens that
        ``_dispatch`` emits. Acceptance feeds the request's rolling EMA
        (the fallback latch) and its class's EMA (chain sizing).

        A trim that fails (its copy-on-write page may not be allocable)
        sends that request down the tick-fault path, this round's tokens
        withheld (the resume re-prefill produces them again), while every
        other uid's acceptance proceeds."""
        if not verified:
            return {}
        with self._lock:
            reqs = {uid: self._live.get(uid) for uid in verified}
        eng = self._engine
        cfg = self.config
        accepted: Dict[int, List[int]] = {}
        failed: Dict[int, Exception] = {}
        tick_prop = tick_acc = 0
        for uid, (chain, rows) in verified.items():
            req = reqs.get(uid)
            seq = eng.seqs.get(uid)
            a = np.argmax(np.asarray(rows), axis=-1)
            matched = 0
            while (matched < len(chain) - 1
                   and int(a[matched]) == chain[matched + 1]):
                matched += 1
            proposed = len(chain) - 1
            tick_prop += proposed
            tick_acc += matched
            if req is None or seq is None:      # evicted mid-tick
                continue
            emitted = [int(x) for x in a[:matched + 1]]
            emitted = emitted[:max(0, req.max_new_tokens - len(req.tokens))]
            if req.eos_token_id is not None and req.eos_token_id in emitted:
                emitted = emitted[:emitted.index(req.eos_token_id) + 1]
            # fed = the chain; validated = the pending token and the
            # accepted (and emitted) proposals
            keep = seq.seen - len(chain) + len(emitted)
            try:
                if keep < seq.seen:
                    eng.trim(uid, keep)
            except Exception as e:
                failed[uid] = e
                continue
            accepted[uid] = emitted
            if proposed:
                req.spec_proposed += proposed
                req.spec_accepted += matched
                rate = matched / proposed
                alpha = cfg.spec_ema
                req._spec_ema = (1 - alpha) * req._spec_ema + alpha * rate
                with self._lock:
                    cur = self._spec_ema_by_class.get(req.priority, 1.0)
                    self._spec_ema_by_class[req.priority] = \
                        (1 - alpha) * cur + alpha * rate
                if (not req._spec_disabled
                        and req.spec_proposed >= cfg.spec_floor_min_proposed
                        and req._spec_ema < cfg.spec_accept_floor):
                    # this request's context is unpredictable: stop paying
                    # for drafts (the stream is the same either way)
                    req._spec_disabled = True
        if tick_prop:
            eng.record_spec(proposed=tick_prop, accepted=tick_acc, rounds=1)
        if failed:
            # discard the suspect engine state (the chain is still on the
            # stream) and requeue under the retry budget: the resume
            # re-prefills the tokens delivered before this tick
            self._on_tick_fault(list(failed), next(iter(failed.values())))
        return accepted

    # -- dispatch (serving lock held) ------------------------------------
    def _dispatch(self, uids, logits: np.ndarray,
                  accepted: Dict[int, List[int]]
                  ) -> Tuple[List[Tuple[Request, int]], List[int]]:
        """Turn the tick's logits (and accepted draft runs) into emitted
        tokens. Returns ((request, token) pairs for ``on_token`` delivery,
        finished uids); delivery and retirement happen back in
        ``_tick``."""
        now = self._clock.now()
        finished: List[int] = []
        emissions: List[Tuple[Request, int]] = []
        for row, uid in zip(logits, uids):
            req = self._live.get(uid)
            if req is None or np.isnan(row[0]):
                continue                      # evicted mid-tick / prefilling
            if uid in accepted:
                # a verified chain: the whole accepted run, in order
                emitted = accepted[uid]
                for tok in emitted:
                    req.tokens.append(tok)
                    if req.on_token is not None:
                        emissions.append((req, tok))
                req._pending_token = emitted[-1]
                if (len(req.tokens) >= req.max_new_tokens
                        or (req.eos_token_id is not None
                            and emitted[-1] == req.eos_token_id)):
                    finished.append(uid)
                continue
            tok = int(np.argmax(row))
            if req.state is RequestState.PREFILL:
                req.transition(RequestState.DECODE)
                if req.t_first_token is None:
                    req.t_first_token = now
            req.tokens.append(tok)
            req._pending_token = tok
            if req.on_token is not None:
                emissions.append((req, tok))
            if (len(req.tokens) >= req.max_new_tokens
                    or (req.eos_token_id is not None
                        and tok == req.eos_token_id)):
                finished.append(uid)
        return emissions, finished

    def _finish(self, finished: List[int]) -> None:
        """Retire this tick's completed requests (after token delivery)."""
        for uid in finished:
            req = self._live.pop(uid, None)
            if req is None:
                continue
            self._engine.flush([uid])         # publishes into prefix cache
            self._retire(req, RequestState.FINISHED)

    # -- shared helpers --------------------------------------------------
    def _release_engine_state(self, uid: int, publish: bool) -> None:
        """Release whatever the engine holds for ``uid``. ``publish``
        offers full KV blocks to the prefix cache (cancel / preempt);
        tick faults must not (the KV may be torn)."""
        if uid not in self._engine.seqs:
            return
        if publish:
            self._engine.preempt(uid)
        else:
            self._engine.discard(uid)

    def _reject(self, req: Request, reason: str) -> None:
        req.error = reason
        self._retire(req, RequestState.REJECTED)

    def _retire(self, req: Request, state: RequestState) -> None:
        req.transition(state)
        self._requests.pop(req.uid, None)
        # a preempted/faulted request that dies without re-admission must
        # not leave a stale resume marker behind
        self._engine.clear_resume(req.uid)
