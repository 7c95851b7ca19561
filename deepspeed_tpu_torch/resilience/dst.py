"""Deterministic simulation testing (DST) for the serving stack.

Ports ``deepspeed_tpu/resilience/dst.py`` (host Python; the port keeps its
own copy). One seed gives the same schedule, and the same ``trace_hash``
and ``span_hash``, in both packages: the run is a pure function of the
schedule, and the port's serving layer is held to the JAX package's by
comparing the two hashes (``tests/test_torch_dst.py``).

A FoundationDB-style harness: the whole :class:`~deepspeed_tpu_torch.serving.ServingFleet`
— router, replicas, scheduler policies, failover, disaggregated
hand-off, autoscaler — runs single-threaded under a virtual-time
:class:`~.clock.SimClock`, driven tick by tick against a *seeded fault
schedule* (request arrivals, cancellations, injected tick faults,
replica deaths, preemption latches, scale events, load gaps). No real
threads, no wall clock, no jitter: the entire execution is a pure
function of the schedule, so

* one CI run soaks hundreds of randomized schedules;
* every event is followed by an **invariant audit** (KV block-balance
  partition, request state-machine legality, no-lost-request
  conservation, span/SLO-ledger consistency, stream-delivery
  completeness, monotone virtual time);
* a failure reproduces from ``(seed)`` alone — and
  :func:`shrink_schedule` delta-debugs the failing schedule down to a
  minimal event list, emitted as a regression artifact;
* the same seed produces a **bit-identical event-trace hash**, asserted
  in tests/test_torch_dst.py.

The same discipline runs one failure-domain up:
:func:`generate_region_schedule` / :func:`run_region_schedule` drive
the real :class:`~deepspeed_tpu_torch.serving.Region` (cells of fleets,
two-tier routing) through region-scale chaos — whole-cell outages,
inter-cell partitions + heals, autoscaler lag — audited by
:class:`RegionInvariantAuditor` (every fleet invariant region-wide,
plus heal convergence / single ownership and shed-span).

The device is replaced by :class:`SimEngine` — a host-only model of the
ragged engine's serving contract that *reuses the real*
:class:`~deepspeed_tpu_torch.inference.ragged.BlockedAllocator`,
:class:`~deepspeed_tpu_torch.inference.ragged.PrefixCache` and
:class:`~deepspeed_tpu_torch.inference.ragged.SequenceDescriptor`, so the
block-balance audit exercises the actual refcount accounting the
serving layer must keep balanced; only the model math is replaced by a
deterministic next-token function of the context. Everything above the
engine — ``serving/``, the schedulers, the fleet — is the real shipped
code. :class:`SimEngine` holds no tensor: it reports ``device`` as the
CPU so that the serving layer's device checks accept it, and
:func:`run_schedule` / :func:`run_region_schedule` build their fleet and
region with ``device="cpu"`` (the default would ask for the card).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..inference.ragged import (BlockedAllocator, NgramIndex, PoolExhausted,
                                PrefixCache, SequenceDescriptor,
                                block_balance_report)
from ..telemetry.registry import MetricsRegistry
from ..telemetry.telemetry import Telemetry, set_telemetry
from ..telemetry.tracing import Tracer, trace_tree_problems, use_tracer
from ..utils.logging import logger
from .chaos import (FaultInjector, TickFault, get_fault_injector,
                    install_fault_injector)
from .clock import SimClock, use_clock

__all__ = ["SimConfig", "SimEngine", "SimKVExport", "SimEvent", "Schedule",
           "RegionSchedule", "SimReport", "generate_schedule",
           "generate_region_schedule", "run_schedule",
           "run_region_schedule", "shrink_schedule", "dump_repro",
           "load_repro", "spec_identity_problems"]


# ----------------------------------------------------------------------
# the simulated engine
# ----------------------------------------------------------------------

@dataclass
class SimConfig:
    """Geometry of a :class:`SimEngine` — the same knobs as
    :class:`~deepspeed_tpu_torch.inference.ragged.RaggedConfig`, sized small so
    slot/pool pressure is reachable within a short schedule."""

    token_budget: int = 32
    max_seqs: int = 4
    kv_block_size: int = 4
    n_kv_blocks: int = 40
    max_context: int = 96
    enable_prefix_cache: bool = True
    vocab: int = 48
    # declared KV storage mode: the sim has no payload to quantize —
    # carrying the knob keeps the serving-layer validation and the
    # export/import geometry contract (mode must match across the
    # disaggregated hand-off) exercised at fleet scale, and the
    # token-identity audit witnesses that quantized runs stay
    # greedy-bit-exact (tokens are a pure function of context)
    kv_quant: str = "none"

    def to_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)


@dataclass
class SimKVExport:
    """The simulation's stand-in for
    :class:`~deepspeed_tpu_torch.inference.ragged.KVExport`: same bookkeeping
    fields and import-side validation, no page payload (there are no
    pages to copy — the importer re-charges the allocator exactly like
    the real importer does)."""

    uid: int
    tokens: List[int]
    seen: int
    prompt_len: int
    kv_block_size: int
    n_pages: int
    kv_quant: str = "none"      # must match the importer's declared mode


def _next_token(ctx: Sequence[int], vocab: int) -> int:
    """The simulated model: a deterministic pure function of the full
    context (FNV-1a fold), so preempt/failover/hand-off resumes are
    bit-exact iff the serving layer reconstructs the context exactly."""
    h = 2166136261
    for t in ctx:
        h = ((h ^ (int(t) & 0xFFFFFFFF)) * 16777619) & 0xFFFFFFFF
    return h % vocab


class SimEngine:
    """Host-only ragged engine standing in for
    :class:`~deepspeed_tpu_torch.inference.ragged.RaggedInferenceEngine` under
    the serving layer: identical serving-facing surface (``put`` /
    ``flush`` / ``preempt`` / ``discard`` / ``clear_resume`` /
    ``export_kv`` / ``import_kv`` / capacity queries) with the real
    allocator + prefix-cache accounting and Dynamic-SplitFuse admission
    semantics — tokens are admitted to descriptors BEFORE the pool
    check, exactly like the device engine, so ``PoolExhausted`` recovery
    retries with empty continuation chunks.

    ``device`` is the CPU: the serving layer checks that an engine lives
    on its replica's device, and a simulated engine holds no tensor."""

    device = torch.device("cpu")

    def __init__(self, config: Optional[SimConfig] = None):
        self.config = config if config is not None else SimConfig()
        cfg = self.config
        self.allocator = BlockedAllocator(cfg.n_kv_blocks)
        self.prefix_cache = (PrefixCache(cfg.kv_block_size)
                             if cfg.enable_prefix_cache else None)
        self.seqs: Dict[int, SequenceDescriptor] = {}
        self._free_slots: List[int] = list(range(cfg.max_seqs))
        self._resume_uids: set = set()
        self.tick_count = 0
        # speculative-decoding surface (mirrors the ragged engine):
        # per-uid memoized n-gram indices + the acceptance-stats dict
        self._ngram_idx: Dict[int, NgramIndex] = {}
        self.spec_stats = {"proposed": 0, "accepted": 0, "rounds": 0}
        # global KV tier seams (mirrors RaggedInferenceEngine; wired by
        # ServingEngine.enable_kv_tier when serving.kv_tier is on)
        self._cold_tier = None
        self._on_prefix_invalidate = None
        self._kv_tier_member = ""
        self.kvtier_cold_spills = 0
        self.kvtier_cold_readmits = 0
        self.kvtier_adopt_imports = 0
        self.kvtier_corrupt_landed = 0

    # -- capacity queries (formulas identical to the ragged engine) -----
    def _available_blocks(self) -> int:
        free = self.allocator.free_blocks
        if self.prefix_cache is not None:
            free += self.prefix_cache.reclaimable_blocks(self.allocator)
        return free

    def blocks_needed(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.config.kv_block_size) + 1

    def can_schedule(self, uids: Sequence[int],
                     lengths: Sequence[int]) -> bool:
        bs = self.config.kv_block_size
        new = [u for u in uids if u not in self.seqs]
        need_blocks = 0
        for uid, length in zip(uids, lengths):
            if uid in self.seqs:
                seq = self.seqs[uid]
                total = seq.seen + length
                need_blocks += max(0, -(-total // bs) - len(seq.blocks))
            else:
                need_blocks += self.blocks_needed(length)
        return (len(new) <= len(self._free_slots)
                and need_blocks <= self._available_blocks())

    def kv_occupancy(self) -> float:
        return 1.0 - self.allocator.free_blocks / self.allocator.n_blocks

    def kv_demand(self) -> float:
        return 1.0 - self._available_blocks() / self.allocator.n_blocks

    # -- lifecycle -------------------------------------------------------
    def flush(self, uids: Sequence[int]) -> None:
        for uid in uids:
            seq = self.seqs.pop(uid, None)
            self._ngram_idx.pop(uid, None)
            if seq is not None:
                if self.prefix_cache is not None:
                    self.prefix_cache.publish(seq.tokens, seq.blocks,
                                              seq.seen, self.allocator)
                self.allocator.free(seq.blocks)
                self._free_slots.append(seq.slot)

    def preempt(self, uid: int) -> List[int]:
        seq = self.seqs.get(uid)
        if seq is None:
            return []
        toks = list(seq.tokens[:seq.seen])
        self.flush([uid])
        self._resume_uids.add(uid)
        return toks

    def discard(self, uid: int) -> None:
        seq = self.seqs.pop(uid, None)
        self._ngram_idx.pop(uid, None)
        if seq is None:
            return
        self.allocator.free(seq.blocks)
        self._free_slots.append(seq.slot)
        self._resume_uids.add(uid)

    def trim(self, uid: int, length: int) -> None:
        """Mirror of the ragged engine's ``trim`` minus the device page
        copy: rewind to ``length`` tokens, free now-unused blocks, and —
        refcount parity with the real copy-on-write — swap the boundary
        block for a private one when it is shared, so the block-balance
        audit exercises identical accounting on the spec-decode rewind
        path."""
        seq = self.seqs[uid]
        if not 0 <= length <= seq.seen:
            raise ValueError(
                f"uid {uid}: trim length {length} outside [0, "
                f"seen={seq.seen}]")
        bs = self.config.kv_block_size
        keep = -(-length // bs) if length else 0
        cow_new = None
        if (length % bs and keep <= len(seq.blocks)
                and self.allocator.refcount(seq.blocks[keep - 1]) > 1):
            if (self.allocator.free_blocks < 1
                    and self.prefix_cache is not None):
                self.prefix_cache.evict_for(self.allocator, 1)
            if self.allocator.refcount(seq.blocks[keep - 1]) > 1:
                cow_new = self.allocator.allocate(1)[0]
        seq.tokens = seq.tokens[:length]
        seq.seen = length
        ngi = self._ngram_idx.get(uid)
        if ngi is not None:
            ngi.truncate(length)
        if keep < len(seq.blocks):
            self.allocator.free(seq.blocks[keep:])
            del seq.blocks[keep:]
        if cow_new is not None:
            old = seq.blocks[keep - 1]
            self.allocator.release([old])
            seq.blocks[keep - 1] = cow_new

    # -- speculative drafting (same surface as the ragged engine) -------
    def draft_tokens(self, uid: int, next_token: Optional[int],
                     ngram: int, k: int) -> List[int]:
        seq = self.seqs[uid]
        idx = self._ngram_idx.get(uid)
        if idx is None or idx.ngram != int(ngram):
            idx = NgramIndex(ngram)
            self._ngram_idx[uid] = idx
        idx.sync(seq.tokens)
        return idx.lookup([] if next_token is None else [int(next_token)], k)

    def record_spec(self, proposed: int = 0, accepted: int = 0,
                    rounds: int = 0) -> None:
        from ..telemetry import get_telemetry

        s = self.spec_stats
        s["proposed"] += int(proposed)
        s["accepted"] += int(accepted)
        s["rounds"] += int(rounds)
        t = get_telemetry()
        if t.enabled and s["proposed"]:
            t.registry.gauge("inference/spec_acceptance").set(
                s["accepted"] / s["proposed"])

    def clear_resume(self, uid: int) -> None:
        self._resume_uids.discard(uid)

    # -- KV hand-off seam ------------------------------------------------
    def export_kv(self, uid: int) -> SimKVExport:
        seq = self.seqs.get(uid)
        if seq is None:
            raise KeyError(f"uid {uid} has no live sequence to export")
        if seq.pending:
            raise ValueError(f"uid {uid}: {seq.pending} tokens still "
                             "pending prefill")
        if seq.seen == 0 or not seq.blocks:
            raise ValueError(f"uid {uid}: nothing prefilled yet")
        return SimKVExport(uid=uid, tokens=list(seq.tokens), seen=seq.seen,
                           prompt_len=seq.prompt_len,
                           kv_block_size=self.config.kv_block_size,
                           n_pages=len(seq.blocks),
                           kv_quant=self.config.kv_quant)

    def import_kv(self, uid: int, export: SimKVExport) -> None:
        cfg = self.config
        if uid in self.seqs:
            raise ValueError(f"uid {uid} already live in this engine")
        if export.kv_block_size != cfg.kv_block_size:
            raise ValueError("KV geometry mismatch")
        if getattr(export, "kv_quant", "none") != cfg.kv_quant:
            raise ValueError(
                f"KV quant-mode mismatch: engine '{cfg.kv_quant}' vs "
                f"export '{getattr(export, 'kv_quant', 'none')}'")
        if export.seen != len(export.tokens):
            raise ValueError(
                f"export seen {export.seen} != tokens {len(export.tokens)}")
        if export.seen > cfg.max_context:
            raise ValueError("export context exceeds max_context")
        need = -(-export.seen // cfg.kv_block_size)
        if export.n_pages != need:
            raise ValueError(
                f"export carries {export.n_pages} pages for "
                f"{export.seen} tokens")
        if not self._free_slots:
            raise RuntimeError("no free sequence slots; flush() first")
        if need > self.allocator.free_blocks and self.prefix_cache is not None:
            self.prefix_cache.evict_for(self.allocator, need)
        blocks = self.allocator.allocate(need)    # may raise PoolExhausted
        self.seqs[uid] = SequenceDescriptor(
            uid=uid, slot=self._free_slots.pop(),
            tokens=[int(t) for t in export.tokens], seen=int(export.seen),
            blocks=blocks, t_admitted=None, t_created=None,
            prompt_len=int(export.prompt_len))
        self._resume_uids.discard(uid)

    # -- global KV tier (payload-free mirror of the ragged engine) -------
    def enable_kv_tier(self, *, member: str = "", cold_tier=None,
                       on_invalidate=None) -> None:
        """Same seam as the ragged engine: record the tier hooks and
        attach the eviction callback. Sim exports carry no pages — the
        checksum covers the token stream, which is exactly what the
        injected wire corruption flips."""
        self._kv_tier_member = member
        self._cold_tier = cold_tier
        self._on_prefix_invalidate = on_invalidate
        if self.prefix_cache is not None and (
                cold_tier is not None or on_invalidate is not None):
            self.prefix_cache.on_evict = self._on_prefix_evict

    def _sim_geometry(self):
        cfg = self.config
        return (cfg.kv_block_size, 1, 1, 1, "sim", cfg.kv_quant)

    def _make_prefix_export(self, key, blocks):
        from ..serving.kvtier import PrefixExport

        cfg = self.config
        return PrefixExport(
            tokens=key, n_pages=len(blocks),
            block_size=cfg.kv_block_size, n_layers=1, n_kv_heads=1,
            head_dim=1, dtype="sim", kv_quant=cfg.kv_quant,
            wire_bytes=len(blocks) * cfg.kv_block_size,
            logical_bytes=2 * len(blocks) * cfg.kv_block_size,
            source=self._kv_tier_member)

    def _on_prefix_evict(self, key, blocks) -> None:
        # invalidate FIRST (the directory entry must not outlive the
        # pages), then spill a host copy — same order as the real engine
        if self._on_prefix_invalidate is not None:
            from ..serving.kvtier import prefix_hash

            self._on_prefix_invalidate(prefix_hash(key))
        if self._cold_tier is not None:
            if self._cold_tier.put(self._make_prefix_export(key, blocks)):
                self.kvtier_cold_spills += 1

    def prefix_residency_hashes(self) -> List[int]:
        if self.prefix_cache is None:
            return []
        from ..serving.kvtier import prefix_hash

        return [prefix_hash(k) for k in self.prefix_cache._entries]

    def export_prefix(self, tokens: Sequence[int]):
        """Donor side of cross-replica adoption: longest resident
        full-block prefix of ``tokens`` as a payload-free PrefixExport
        (None on a miss). The ``corrupt_adopt`` chaos knob flips a
        token AFTER the checksum is stamped — the importer's verify
        must catch it."""
        if self.prefix_cache is None:
            return None
        key, blocks = self.prefix_cache.lookup(tokens)
        if key is None:
            return None
        export = self._make_prefix_export(key, blocks)
        inj = get_fault_injector()
        if inj is not None and inj.on_prefix_export():
            export.tokens = ((export.tokens[0] ^ 0x1,) + export.tokens[1:])
        return export

    def import_prefix(self, export) -> bool:
        """Importer side: checksum FIRST (invariant #19), geometry,
        capacity, publish — identical discipline to the ragged engine,
        with the same ``_kvtier_skip_verify`` planted-bug seam."""
        from ..serving.kvtier import CorruptExport

        if self.prefix_cache is None:
            raise ValueError("prefix cache disabled; nothing to adopt into")
        cfg = self.config
        if not export.verify():
            if not getattr(self, "_kvtier_skip_verify", False):
                raise CorruptExport(
                    "prefix export failed checksum verification "
                    "(corrupted in transit)")
            self.kvtier_corrupt_landed += 1
        if export.geometry() != self._sim_geometry():
            raise ValueError(
                f"prefix KV geometry mismatch: engine "
                f"{self._sim_geometry()} vs export {export.geometry()}")
        need = export.n_pages
        if need <= 0 or need != len(export.tokens) // cfg.kv_block_size \
                or len(export.tokens) % cfg.kv_block_size:
            raise ValueError(
                f"prefix export carries {need} pages for "
                f"{len(export.tokens)} tokens (full blocks required)")
        if len(export.tokens) > cfg.max_context:
            raise ValueError("prefix length exceeds max_context")
        if tuple(export.tokens) in self.prefix_cache._entries:
            return False
        if need > self.allocator.free_blocks:
            self.prefix_cache.evict_for(self.allocator, need)
        blocks = self.allocator.allocate(need)    # may raise PoolExhausted
        self.prefix_cache.publish(list(export.tokens), blocks,
                                  len(export.tokens), self.allocator)
        self.allocator.release(blocks)
        self.kvtier_adopt_imports += 1
        return True

    def _cold_readmit(self, tokens: Sequence[int]) -> None:
        bs = self.config.kv_block_size
        for k in range((len(tokens) - 1) // bs, 0, -1):
            key = tuple(int(t) for t in tokens[:k * bs])
            if key in self.prefix_cache._entries:
                return
            export = self._cold_tier.get(key)
            if export is None:
                continue
            try:
                if self.import_prefix(export):
                    self.kvtier_cold_readmits += 1
            except (ValueError, RuntimeError):
                pass
            return

    # -- the step --------------------------------------------------------
    def _admit_tokens(self, uids: Sequence[int],
                      tokens: Sequence[Sequence[int]]) -> None:
        """Admission shared by put()/put_spec() (the mirror of the real
        engine's same-named helper): fresh uids get a slot + cached
        prefix adoption, existing ones append their chunk."""
        for uid, toks in zip(uids, tokens):
            new = uid not in self.seqs
            if new:
                if not self._free_slots:
                    raise RuntimeError("no free sequence slots; flush() first")
                self._resume_uids.discard(uid)
                self.seqs[uid] = SequenceDescriptor(
                    uid=uid, slot=self._free_slots.pop())
            seq = self.seqs[uid]
            seq.tokens.extend(int(t) for t in toks)
            if new:
                seq.prompt_len = len(seq.tokens)
                if self.prefix_cache is not None and seq.tokens:
                    if self._cold_tier is not None:
                        # re-admission BEFORE the match: a spilled prefix
                        # comes back through the checksummed import path
                        # and the match below finds it like a local one
                        self._cold_readmit(seq.tokens)
                    shared, blocks = self.prefix_cache.match(seq.tokens)
                    if shared:
                        self.allocator.retain(blocks)
                        seq.blocks = list(blocks)
                        seq.seen = shared

    def _pack_splitfuse(self) -> List[Tuple[SequenceDescriptor, int]]:
        """Dynamic SplitFuse packing: shortest-pending first into the one
        token budget (same policy as the device engine)."""
        sched: List[Tuple[SequenceDescriptor, int]] = []
        budget = self.config.token_budget
        pending = sorted((s for s in self.seqs.values() if s.pending > 0),
                         key=lambda s: s.pending)
        for seq in pending:
            take = min(seq.pending, budget)
            if take == 0:
                break
            sched.append((seq, take))
            budget -= take
        return sched

    def _validate_sched(self, sched) -> List[int]:
        """Context bound + whole-schedule pool check BEFORE any
        allocation, evicting cached prefixes first — an exhausted pool
        must leave every descriptor consistent (tokens admitted, seen
        unchanged) for the retry path. Returns per-entry block needs."""
        cfg = self.config
        needs = []
        for seq, take in sched:
            total = seq.seen + take
            if total > cfg.max_context:
                raise ValueError(
                    f"uid {seq.uid}: context {total} exceeds max_context")
            needs.append(max(0, -(-total // cfg.kv_block_size)
                             - len(seq.blocks)))
        need_total = sum(needs)
        if (need_total > self.allocator.free_blocks
                and self.prefix_cache is not None):
            self.prefix_cache.evict_for(self.allocator, need_total)
        if need_total > self.allocator.free_blocks:
            raise PoolExhausted(
                f"KV pool exhausted: need {need_total}, have "
                f"{self.allocator.free_blocks}")
        return needs

    def put(self, uids: Sequence[int],
            tokens: Sequence[Sequence[int]]) -> np.ndarray:
        cfg = self.config
        self._admit_tokens(uids, tokens)
        sched = self._pack_splitfuse()
        if not sched:
            raise ValueError("put() called with no pending tokens")
        needs = self._validate_sched(sched)
        for (seq, take), n in zip(sched, needs):
            if n:
                seq.blocks.extend(self.allocator.allocate(n))
            seq.seen += take
        self.tick_count += 1
        scheduled = {seq.uid for seq, _ in sched}
        out = np.full((len(uids), cfg.vocab), np.nan, np.float32)
        for i, uid in enumerate(uids):
            seq = self.seqs[uid]
            if seq.pending == 0 and uid in scheduled:
                out[i] = 0.0
                out[i, _next_token(seq.tokens, cfg.vocab)] = 1.0
        return out

    def put_spec(self, uids: Sequence[int],
                 tokens: Sequence[Sequence[int]],
                 drafts: Sequence[Sequence[int]]):
        """Mirror of the ragged engine's ``put_spec``: one step verifying
        draft chains alongside prefill/decode traffic, same all-or-strip
        budget semantics and the same strip-on-PoolExhausted contract.
        Rows are the sim's one-hot "logits": row ``j`` is
        ``onehot(next(context through chain[j]))``, so greedy acceptance
        in the serving layer reproduces EXACTLY the plain tick-by-tick
        stream — the token-identity invariant's witness at fleet scale."""
        cfg = self.config
        self._admit_tokens(uids, tokens)
        # validate EVERY chain before appending ANY draft token (the
        # real engine's discipline: a raise mid-append would leave
        # earlier uids' unverified drafts in their streams)
        for uid, d in zip(uids, drafts):
            if d and self.seqs[uid].pending != 1:
                raise ValueError(
                    f"uid {uid}: a draft chain continues exactly one "
                    f"pending decode token, found "
                    f"pending={self.seqs[uid].pending}")
        appended: Dict[int, int] = {}
        for uid, d in zip(uids, drafts):
            if not d:
                continue
            self.seqs[uid].tokens.extend(int(t) for t in d)
            appended[uid] = len(d)
        try:
            sched = self._pack_splitfuse()
            if not sched:
                raise ValueError("put_spec() called with no pending tokens")
            take_of = {seq.uid: take for seq, take in sched}
            for uid in list(appended):       # all-or-strip under budget
                seq = self.seqs[uid]
                chain_len = 1 + appended[uid]
                take = take_of.get(uid, 0)
                if take < chain_len:
                    strip = chain_len - max(take, 1)
                    if strip:
                        del seq.tokens[len(seq.tokens) - strip:]
                        appended[uid] -= strip
                    if appended[uid] <= 0:
                        appended.pop(uid)
            sched = [(seq, min(take, seq.pending))
                     for seq, take in sched if seq.pending > 0]
            needs = self._validate_sched(sched)
        except BaseException:
            # strip every remaining draft token: the recovery retry is a
            # PLAIN put of the admitted feed, exactly as the real engine
            for uid, n in appended.items():
                seq = self.seqs[uid]
                del seq.tokens[len(seq.tokens) - n:]
            raise
        seen0: Dict[int, int] = {}
        for (seq, take), n in zip(sched, needs):
            if n:
                seq.blocks.extend(self.allocator.allocate(n))
            seen0[seq.uid] = seq.seen
            seq.seen += take
        self.tick_count += 1
        scheduled = {seq.uid for seq, _ in sched}
        out = np.full((len(uids), cfg.vocab), np.nan, np.float32)
        for i, uid in enumerate(uids):
            seq = self.seqs[uid]
            if seq.pending == 0 and uid in scheduled:
                out[i] = 0.0
                out[i, _next_token(seq.tokens, cfg.vocab)] = 1.0
        verified: Dict[int, Tuple[List[int], np.ndarray]] = {}
        for seq, take in sched:
            if seq.uid in appended:
                s0 = seen0[seq.uid]
                chain = [int(t) for t in seq.tokens[s0:s0 + take]]
                rows = np.zeros((take, cfg.vocab), np.float32)
                for j in range(take):
                    rows[j, _next_token(seq.tokens[:s0 + j + 1],
                                        cfg.vocab)] = 1.0
                verified[seq.uid] = (chain, rows)
        return out, verified


# ----------------------------------------------------------------------
# schedules
# ----------------------------------------------------------------------

@dataclass
class SimEvent:
    """One scheduled simulation event at virtual time ``t``. Kinds:

    * ``submit`` — one request (``ix`` is its stable logical id);
    * ``cancel`` — cancel submit ``target`` if still live;
    * ``tick_fault`` — arm ``n`` injected :class:`TickFault` ticks;
    * ``replica_death`` — kill the ``which``-th healthy replica;
    * ``latch`` — trip the preemption guard (graceful drain);
    * ``scale`` — ``fleet.scale_to(n)``;
    * ``stall`` — advance virtual time by ``dt`` without ticking (a load
      gap: queued deadlines keep running).
    """

    t: float
    kind: str
    payload: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"t": self.t, "kind": self.kind, **self.payload}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SimEvent":
        d = dict(d)
        return cls(t=float(d.pop("t")), kind=str(d.pop("kind")), payload=d)


@dataclass
class Schedule:
    """A complete, replayable simulation input: configs + event list.
    ``run_schedule(generate_schedule(seed))`` is a pure function — same
    seed, same trace hash."""

    seed: int
    horizon: float
    engine_cfg: Dict[str, Any]
    fleet_cfg: Dict[str, Any]
    serving_cfg: Dict[str, Any]
    events: List[SimEvent]

    def to_dict(self) -> Dict[str, Any]:
        return {"seed": self.seed, "horizon": self.horizon,
                "engine_cfg": self.engine_cfg, "fleet_cfg": self.fleet_cfg,
                "serving_cfg": self.serving_cfg,
                "events": [e.to_dict() for e in self.events]}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Schedule":
        return cls(seed=int(d["seed"]), horizon=float(d["horizon"]),
                   engine_cfg=dict(d["engine_cfg"]),
                   fleet_cfg=dict(d["fleet_cfg"]),
                   serving_cfg=dict(d["serving_cfg"]),
                   events=[SimEvent.from_dict(e) for e in d["events"]])

    def replace_events(self, events: List[SimEvent]) -> "Schedule":
        return Schedule(seed=self.seed, horizon=self.horizon,
                        engine_cfg=dict(self.engine_cfg),
                        fleet_cfg=dict(self.fleet_cfg),
                        serving_cfg=dict(self.serving_cfg),
                        events=list(events))


@dataclass
class RegionSchedule(Schedule):
    """A region-scale schedule: the base fields plus the
    :class:`~deepspeed_tpu_torch.config.RegionConfig` dict and region-scale
    event kinds (``cell_outage``, ``partition``, ``heal``,
    ``autoscaler_lag``).
    ``run_region_schedule(generate_region_schedule(seed))`` is a pure
    function, same as the fleet tier."""

    region_cfg: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        d = super().to_dict()
        d["region_cfg"] = dict(self.region_cfg)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RegionSchedule":
        return cls(seed=int(d["seed"]), horizon=float(d["horizon"]),
                   engine_cfg=dict(d["engine_cfg"]),
                   fleet_cfg=dict(d["fleet_cfg"]),
                   serving_cfg=dict(d["serving_cfg"]),
                   region_cfg=dict(d.get("region_cfg", {})),
                   events=[SimEvent.from_dict(e) for e in d["events"]])

    def replace_events(self, events: List[SimEvent]) -> "RegionSchedule":
        return RegionSchedule(seed=self.seed, horizon=self.horizon,
                              engine_cfg=dict(self.engine_cfg),
                              fleet_cfg=dict(self.fleet_cfg),
                              serving_cfg=dict(self.serving_cfg),
                              region_cfg=dict(self.region_cfg),
                              events=list(events))


def _event_order(e: SimEvent):
    """Deterministic total order for schedule events (repr-keyed payload
    tie-break: payload values are mixed types, so direct comparison
    could raise)."""
    return (e.t, e.kind, sorted(map(repr, e.payload.items())))


def generate_schedule(seed: int) -> Schedule:
    """Expand a seed into a randomized fault schedule: fleet/serving
    config draws plus a time-ordered event list composing the existing
    injectors (tick faults, replica death, preemption latch) with
    request traffic sized to hit slot/KV pressure, deadline expiry,
    rejection and cancellation paths."""
    import random

    rng = random.Random(seed)
    engine_cfg = SimConfig().to_dict()
    disaggregated = rng.random() < 0.20
    replicas = rng.randint(1, 3)
    fleet_cfg: Dict[str, Any] = {
        "replicas": replicas,
        "router": rng.choice(["least_loaded", "prefix_affinity"]),
        "failover": True,
        "respawn": rng.random() < 0.5,
        "autoscale": rng.random() < 0.25,
        "autoscale_interval_s": 4.0,
        "min_replicas": 1,
        "max_replicas": 4,
    }
    if disaggregated:
        fleet_cfg.update(disaggregated=True, prefill_replicas=1,
                         replicas=max(1, replicas - 1))
    serving_cfg: Dict[str, Any] = {
        "policy": "slo" if rng.random() < 0.8 else "fcfs",
        "max_queue": rng.choice([4, 8, 32]),
        "tick_retry_limit": rng.randint(0, 2),
        "reserve_output_blocks": rng.random() < 0.7,
        "kv_pressure": rng.choice([0.5, 0.8, 0.9]),
        "stuck_tick_timeout_s": 0.0,      # no watchdog thread in the sim
        "drain_timeout_s": 600.0,
        # drain loops sleep this long per pump step; the default 2ms
        # would take 60k pumped fleet steps to burn a virtual timeout
        "poll_interval_s": 0.25,
    }
    horizon = float(rng.randint(30, 70))
    vocab = engine_cfg["vocab"]
    events: List[SimEvent] = []
    n_req = rng.randint(6, 16)
    # a few shared prefixes so prefix-cache adoption + affinity routing
    # actually trigger
    prefixes = [[rng.randrange(1, vocab) for _ in range(8)]
                for _ in range(2)]
    for ix in range(n_req):
        t = round(rng.uniform(0.0, horizon * 0.6), 3)
        if rng.random() < 0.3:
            prompt = list(rng.choice(prefixes)) + [
                rng.randrange(1, vocab) for _ in range(rng.randint(1, 4))]
        else:
            prompt = [rng.randrange(1, vocab)
                      for _ in range(rng.randint(3, 14))]
        payload: Dict[str, Any] = {
            "ix": ix, "prompt": prompt,
            "max_new": rng.randint(1, 12),
            "priority": rng.randint(0, 2),
        }
        if rng.random() < 0.5:
            payload["deadline"] = round(rng.uniform(4.0, 40.0), 3)
        if rng.random() < 0.3:
            payload["ttft_deadline"] = round(rng.uniform(2.0, 12.0), 3)
        if rng.random() < 0.2:
            payload["eos"] = rng.randrange(0, vocab)
        if rng.random() < 0.06:
            # hopeless geometry: exercises the up-front reject paths
            payload["max_new"] = engine_cfg["max_context"] * 2
        events.append(SimEvent(t=t, kind="submit", payload=payload))
        if rng.random() < 0.15:
            events.append(SimEvent(
                t=round(t + rng.uniform(0.5, 10.0), 3), kind="cancel",
                payload={"target": ix}))
    for _ in range(rng.randint(0, 3)):
        events.append(SimEvent(t=round(rng.uniform(1.0, horizon * 0.7), 3),
                               kind="tick_fault",
                               payload={"n": rng.randint(1, 2)}))
    for _ in range(rng.randint(0, 2) if replicas > 1 or fleet_cfg["respawn"]
                   else 0):
        events.append(SimEvent(t=round(rng.uniform(2.0, horizon * 0.8), 3),
                               kind="replica_death",
                               payload={"which": rng.randint(0, 3)}))
    if rng.random() < 0.10:
        events.append(SimEvent(t=round(rng.uniform(horizon * 0.5,
                                                   horizon * 0.9), 3),
                               kind="latch", payload={}))
    if not disaggregated and rng.random() < 0.3:
        for _ in range(rng.randint(1, 2)):
            events.append(SimEvent(
                t=round(rng.uniform(2.0, horizon * 0.8), 3), kind="scale",
                payload={"n": rng.randint(1, 3)}))
    if rng.random() < 0.25:
        events.append(SimEvent(t=round(rng.uniform(1.0, horizon * 0.6), 3),
                               kind="stall",
                               payload={"dt": round(rng.uniform(3.0,
                                                                20.0), 3)}))
    events.sort(key=_event_order)
    # speculative serving + quantized-KV draws — appended AFTER the event
    # stream so pre-existing seeds keep their exact event sequences (the
    # regression-seed corpus stays meaningful). The invariants must hold
    # with drafts verifying inside the tick (multiple tokens per request
    # per tick) and with the quantized pool/wire mode declared end to
    # end; invariant #10 (token identity) witnesses that neither changes
    # WHICH tokens any request emits.
    if rng.random() < 0.35:
        serving_cfg.update(
            speculative=True,
            spec_lookahead=rng.choice([2, 4]),
            spec_ngram=2,
            spec_accept_floor=rng.choice([0.0, 0.3]),
            spec_floor_min_proposed=8)
    kvq = rng.choice(["none", "none", "int8", "int4"])
    engine_cfg["kv_quant"] = kvq
    serving_cfg["kv_quant"] = kvq
    # gray-failure plane draws (serving/health.py) — appended AFTER
    # every pre-existing draw, same regression-corpus rationale as
    # above. Config and fault draws are INDEPENDENT on purpose:
    # quarantine may run under clean traffic (the no-flap invariant's
    # null case) and a straggler may limp with the plane off (the
    # mitigation-off baseline a TTFT comparison needs).
    if rng.random() < 0.55:
        fleet_cfg.update(
            quarantine=True,
            quarantine_threshold=rng.choice([0.4, 0.5]),
            quarantine_after=rng.choice([2, 3]),
            quarantine_dwell_s=rng.choice([6.0, 10.0]),
            quarantine_readmit_polls=rng.choice([2, 3]))
    if rng.random() < 0.5:
        fleet_cfg.update(
            breakers=True,
            breaker_failures=rng.choice([3, 4]),
            breaker_cooldown_s=rng.choice([4.0, 8.0]))
    if rng.random() < 0.45:
        fleet_cfg.update(hedge=True,
                         hedge_ttft_fraction=rng.choice([0.5, 0.6]))
    if replicas > 1 and rng.random() < 0.45:
        events.append(SimEvent(
            t=round(rng.uniform(1.0, horizon * 0.5), 3),
            kind="degraded_tick",
            payload={"which": rng.randint(0, 3), "k": rng.randint(2, 4)}))
    if rng.random() < 0.3:
        events.append(SimEvent(
            t=round(rng.uniform(1.0, horizon * 0.6), 3),
            kind="stall_burst",
            payload={"which": rng.randint(0, 3), "n": rng.randint(2, 6)}))
    if rng.random() < 0.25:
        events.append(SimEvent(
            t=round(rng.uniform(0.0, horizon * 0.4), 3),
            kind="flaky_import", payload={"every": rng.choice([2, 3])}))
    # global KV tier draws (serving/kvtier.py; invariants #17-#19) —
    # appended at the very end, same regression-corpus rationale: the
    # directory, residency routing, cross-replica adoption and the cold
    # tier run with their three fault kinds (stale directory entries,
    # adoption-wire corruption, cold-tier pressure drops). Independent
    # of every earlier draw, so old seeds replay bit-identically with
    # the tier off.
    if rng.random() < 0.45:
        serving_cfg["kv_tier"] = {
            "enabled": True,
            "publish_interval_s": rng.choice([0.5, 1.0]),
            "directory_staleness_s": rng.choice([3.0, 6.0]),
            "adoption": rng.random() < 0.8,
            "cold_tier": rng.random() < 0.8,
            "cold_capacity_pages": rng.choice([16, 64, 128]),
        }
        # a tiered seed must actually EXERCISE the tier: residency
        # routing needs a prefix router and a second replica, adoption
        # needs concurrent same-prefix load spilling off the affinity
        # pick, and cold spill/readmit needs pool pressure. Tiered
        # seeds are new schedules, so reshaping them here does not
        # perturb the pre-existing corpus.
        fleet_cfg["router"] = rng.choice(["prefix_affinity", "residency"])
        if not fleet_cfg.get("disaggregated"):
            fleet_cfg["replicas"] = max(fleet_cfg["replicas"], 2)
        engine_cfg["n_kv_blocks"] = rng.choice([20, 28, 40])
        # stragglers land deep in the run, AFTER pressure evictions
        # spilled the shared prefixes — the cold-readmit path's
        # trigger. The tail of the burst REPEATS earlier burst prompts
        # verbatim: a repeat's block-aligned prefix keys are exactly
        # the keys the earlier request's cache levels spilled under
        # pressure, so the repeat rides cold re-admission (or the
        # device cache, when the level survived) instead of a cold
        # re-prefill.
        burst_prompts: List[List[int]] = []
        for j in range(rng.randint(4, 8)):
            if burst_prompts and rng.random() < 0.4:
                prompt = list(rng.choice(burst_prompts))
            else:
                prompt = list(rng.choice(prefixes)) + [
                    rng.randrange(1, vocab)
                    for _ in range(rng.randint(1, 3))]
                burst_prompts.append(prompt)
            events.append(SimEvent(
                t=round(rng.uniform(horizon * 0.1, horizon * 0.95), 3),
                kind="submit",
                payload={"ix": n_req + j, "prompt": prompt,
                         "max_new": rng.randint(1, 8),
                         "priority": rng.randint(0, 2)}))
        if rng.random() < 0.5:
            events.append(SimEvent(
                t=round(rng.uniform(1.0, horizon * 0.6), 3),
                kind="stale_directory",
                payload={"every": rng.choice([2, 3])}))
        if rng.random() < 0.5:
            events.append(SimEvent(
                t=round(rng.uniform(1.0, horizon * 0.6), 3),
                kind="corrupt_adopt",
                payload={"every": rng.choice([1, 2])}))
        if rng.random() < 0.4:
            events.append(SimEvent(
                t=round(rng.uniform(1.0, horizon * 0.6), 3),
                kind="cold_pressure",
                payload={"every": rng.choice([2, 3])}))
    return Schedule(seed=seed, horizon=horizon, engine_cfg=engine_cfg,
                    fleet_cfg=fleet_cfg, serving_cfg=serving_cfg,
                    events=events)


def generate_region_schedule(seed: int) -> RegionSchedule:
    """Expand a seed into a REGION-scale fault schedule: N cells of M
    replicas behind the two-tier router, request traffic (with bursts
    sized to trip the brownout ladder), and the failure modes that
    dominate at pod scale — whole-cell outages, inter-cell partitions
    (with and without the region front-end on the severed side), heals,
    and autoscaler lag — composed with every fleet-tier fault kind."""
    import random

    # a distinct stream from generate_schedule: region seed N must not
    # be the fleet-tier seed N wearing a different config
    rng = random.Random(f"region-{seed}")
    engine_cfg = SimConfig().to_dict()
    n_cells = rng.randint(2, 3)
    replicas = rng.randint(1, 2)
    disaggregated = rng.random() < 0.25
    fleet_cfg: Dict[str, Any] = {
        "replicas": replicas,
        "router": rng.choice(["least_loaded", "prefix_affinity"]),
        "failover": True,
        "respawn": rng.random() < 0.4,
        "autoscale": rng.random() < 0.25,
        "autoscale_interval_s": 4.0,
        "min_replicas": 1,
        "max_replicas": 3,
        "route_backoff_s": 0.05,
    }
    if disaggregated:
        fleet_cfg.update(disaggregated=True, prefill_replicas=1,
                         replicas=max(1, replicas - 1))
    region_cfg: Dict[str, Any] = {
        "cells": n_cells,
        "cell_ring_vnodes": 16,
        "brownout_queue_per_replica": rng.choice([2.0, 4.0, 8.0]),
        "rebalance_threshold": rng.choice([0.0, 1.0, 2.0]),
        "cell_spill_load": rng.choice([0, 0, 6]),
    }
    serving_cfg: Dict[str, Any] = {
        "policy": "slo" if rng.random() < 0.8 else "fcfs",
        "max_queue": rng.choice([8, 32]),
        "tick_retry_limit": rng.randint(0, 2),
        "reserve_output_blocks": rng.random() < 0.7,
        "kv_pressure": rng.choice([0.5, 0.8, 0.9]),
        "stuck_tick_timeout_s": 0.0,
        "drain_timeout_s": 600.0,
        "poll_interval_s": 0.25,
    }
    horizon = float(rng.randint(40, 80))
    vocab = engine_cfg["vocab"]
    events: List[SimEvent] = []
    prefixes = [[rng.randrange(1, vocab) for _ in range(8)]
                for _ in range(2)]

    def add_submit(ix: int, t: float) -> None:
        if rng.random() < 0.3:
            prompt = list(rng.choice(prefixes)) + [
                rng.randrange(1, vocab) for _ in range(rng.randint(1, 4))]
        else:
            prompt = [rng.randrange(1, vocab)
                      for _ in range(rng.randint(3, 14))]
        payload: Dict[str, Any] = {
            "ix": ix, "prompt": prompt,
            "max_new": rng.randint(1, 10),
            "priority": rng.randint(0, 2),
        }
        if rng.random() < 0.5:
            payload["deadline"] = round(rng.uniform(4.0, 40.0), 3)
        if rng.random() < 0.25:
            payload["ttft_deadline"] = round(rng.uniform(2.0, 12.0), 3)
        if rng.random() < 0.2:
            payload["eos"] = rng.randrange(0, vocab)
        if rng.random() < 0.04:
            payload["max_new"] = engine_cfg["max_context"] * 2
        events.append(SimEvent(t=t, kind="submit", payload=payload))
        if rng.random() < 0.12:
            events.append(SimEvent(
                t=round(t + rng.uniform(0.5, 10.0), 3), kind="cancel",
                payload={"target": ix}))

    ix = 0
    for _ in range(rng.randint(8, 18)):
        add_submit(ix, round(rng.uniform(0.0, horizon * 0.6), 3))
        ix += 1
    if rng.random() < 0.45:
        # a correlated burst: the brownout ladder's natural trigger
        t0 = round(rng.uniform(2.0, horizon * 0.5), 3)
        for _ in range(rng.randint(6, 14)):
            add_submit(ix, round(t0 + rng.uniform(0.0, 1.5), 3))
            ix += 1
    for _ in range(rng.randint(0, 2)):
        events.append(SimEvent(t=round(rng.uniform(1.0, horizon * 0.7), 3),
                               kind="tick_fault",
                               payload={"n": rng.randint(1, 2)}))
    for _ in range(rng.randint(0, 2)):
        events.append(SimEvent(t=round(rng.uniform(2.0, horizon * 0.8), 3),
                               kind="replica_death",
                               payload={"cell": rng.randint(0, 3),
                                        "which": rng.randint(0, 3)}))
    if n_cells > 1 and rng.random() < 0.5:
        events.append(SimEvent(t=round(rng.uniform(3.0, horizon * 0.7), 3),
                               kind="cell_outage",
                               payload={"which": rng.randint(0, 3)}))
    if n_cells > 1 and rng.random() < 0.55:
        t_p = round(rng.uniform(2.0, horizon * 0.6), 3)
        far = sorted(rng.sample(range(n_cells),
                                rng.randint(1, n_cells - 1)))
        events.append(SimEvent(t=t_p, kind="partition",
                               payload={"far": far,
                                        "sever_region":
                                        rng.random() < 0.6}))
        if rng.random() < 0.85:
            events.append(SimEvent(
                t=round(t_p + rng.uniform(4.0, 25.0), 3), kind="heal",
                payload={}))
    if rng.random() < 0.3:
        events.append(SimEvent(t=round(rng.uniform(1.0, horizon * 0.5), 3),
                               kind="autoscaler_lag",
                               payload={"dt": rng.choice([5.0, 10.0,
                                                          20.0])}))
    if rng.random() < 0.08:
        events.append(SimEvent(t=round(rng.uniform(horizon * 0.5,
                                                   horizon * 0.9), 3),
                               kind="latch", payload={}))
    if not disaggregated and rng.random() < 0.2:
        events.append(SimEvent(t=round(rng.uniform(2.0, horizon * 0.8), 3),
                               kind="scale",
                               payload={"cell": rng.randint(0, 3),
                                        "n": rng.randint(1, 3)}))
    if rng.random() < 0.2:
        events.append(SimEvent(t=round(rng.uniform(1.0, horizon * 0.6), 3),
                               kind="stall",
                               payload={"dt": round(rng.uniform(3.0,
                                                                15.0), 3)}))
    events.sort(key=_event_order)
    # speculative + kv-quant draws appended after the event stream (same
    # rationale as generate_schedule): region chaos — cell outages,
    # partitions, cross-cell adoption — must preserve token identity
    # with drafts and quantized hand-offs in play
    if rng.random() < 0.3:
        serving_cfg.update(
            speculative=True, spec_lookahead=rng.choice([2, 4]),
            spec_ngram=2, spec_accept_floor=rng.choice([0.0, 0.3]),
            spec_floor_min_proposed=8)
    kvq = rng.choice(["none", "none", "int8", "int4"])
    engine_cfg["kv_quant"] = kvq
    serving_cfg["kv_quant"] = kvq
    # rollout / canary / migration draws — appended AFTER every
    # pre-existing draw, same regression-corpus rationale as above.
    # Tenants are stamped onto the already-generated submits in list
    # order (payload keys only; the run-time sort's repr tie-break is
    # deterministic either way), then the version-flip machinery is
    # composed with the chaos the rest of the schedule already throws:
    # rollouts mid-death, migrations mid-partition, injected canary SLO
    # regressions, corrupt new-version checkpoints and deaths mid-flip.
    for e in events:
        if e.kind == "submit" and rng.random() < 0.8:
            e.payload["tenant"] = f"tenant-{rng.randrange(0, 6)}"
    serving_cfg["rollout"] = {
        "canary_fraction": rng.choice([0.25, 0.5]),
        "canary_observe_ticks": rng.choice([40, 80, 160]),
        "slo_regression_threshold": rng.choice([0.15, 0.25]),
        "min_canary_samples": rng.choice([2, 3]),
        "warmup_ticks": rng.choice([0, 1, 2]),
        "swap_retry_limit": 2,
        "max_flip_attempts": 4,
    }
    if rng.random() < 0.55:
        t_r = round(rng.uniform(2.0, horizon * 0.5), 3)
        events.append(SimEvent(t=t_r, kind="rollout",
                               payload={"version": 1,
                                        "fraction": rng.choice(
                                            [0.3, 0.5, 1.0])}))
        if rng.random() < 0.45:
            events.append(SimEvent(
                t=round(t_r + rng.uniform(1.0, 10.0), 3),
                kind="canary_regress", payload={}))
        if rng.random() < 0.30:
            events.append(SimEvent(
                t=round(t_r - rng.uniform(0.1, 1.5), 3),
                kind="corrupt_swap", payload={"n": rng.randint(1, 2)}))
        if rng.random() < 0.25:
            events.append(SimEvent(
                t=round(t_r - rng.uniform(0.1, 1.5), 3),
                kind="flip_death",
                payload={"ordinal": rng.randint(1, 2)}))
    for _ in range(rng.randint(0, 2)):
        events.append(SimEvent(t=round(rng.uniform(2.0, horizon * 0.8), 3),
                               kind="migrate",
                               payload={"cell": rng.randint(0, 3),
                                        "replica": rng.randint(0, 3)}))
    # gray-failure plane draws — appended after every pre-existing draw
    # (same corpus rationale); the region tier composes quarantine,
    # breakers and hedging with cell outages, partitions and rollouts
    if rng.random() < 0.5:
        fleet_cfg.update(
            quarantine=True,
            quarantine_threshold=rng.choice([0.4, 0.5]),
            quarantine_after=rng.choice([2, 3]),
            quarantine_dwell_s=rng.choice([6.0, 10.0]),
            quarantine_readmit_polls=rng.choice([2, 3]))
    if rng.random() < 0.4:
        fleet_cfg.update(
            breakers=True,
            breaker_failures=rng.choice([3, 4]),
            breaker_cooldown_s=rng.choice([4.0, 8.0]))
    if rng.random() < 0.35:
        fleet_cfg.update(hedge=True,
                         hedge_ttft_fraction=rng.choice([0.5, 0.6]))
    if rng.random() < 0.4:
        events.append(SimEvent(
            t=round(rng.uniform(1.0, horizon * 0.5), 3),
            kind="degraded_tick",
            payload={"cell": rng.randint(0, 3),
                     "which": rng.randint(0, 3),
                     "k": rng.randint(2, 4)}))
    if rng.random() < 0.25:
        events.append(SimEvent(
            t=round(rng.uniform(1.0, horizon * 0.6), 3),
            kind="stall_burst",
            payload={"cell": rng.randint(0, 3),
                     "which": rng.randint(0, 3),
                     "n": rng.randint(2, 6)}))
    if rng.random() < 0.2:
        events.append(SimEvent(
            t=round(rng.uniform(0.0, horizon * 0.4), 3),
            kind="flaky_import", payload={"every": rng.choice([2, 3])}))
    # global KV tier draws — appended at the very end (see
    # generate_schedule); at region scale the tier additionally
    # composes with cell outages/partitions (whole-member directory
    # drops) and the cell-residency routing preference
    if rng.random() < 0.40:
        serving_cfg["kv_tier"] = {
            "enabled": True,
            "publish_interval_s": rng.choice([0.5, 1.0]),
            "directory_staleness_s": rng.choice([3.0, 6.0]),
            "adoption": rng.random() < 0.8,
            "cold_tier": rng.random() < 0.8,
            "cold_capacity_pages": rng.choice([16, 64, 128]),
        }
        # same reshaping as the fleet tier: tiered region seeds get a
        # prefix router, a second replica per cell, pool pressure, and
        # a shared-prefix burst so the directory/adoption/cold paths
        # run hot (tiered seeds are new schedules — no corpus impact)
        fleet_cfg["router"] = rng.choice(["prefix_affinity", "residency"])
        if not fleet_cfg.get("disaggregated"):
            fleet_cfg["replicas"] = max(fleet_cfg["replicas"], 2)
        engine_cfg["n_kv_blocks"] = rng.choice([20, 28, 40])
        burst_prompts: List[List[int]] = []
        for _ in range(rng.randint(4, 8)):
            if burst_prompts and rng.random() < 0.4:
                prompt = list(rng.choice(burst_prompts))
            else:
                prompt = list(rng.choice(prefixes)) + [
                    rng.randrange(1, vocab)
                    for _ in range(rng.randint(1, 3))]
                burst_prompts.append(prompt)
            events.append(SimEvent(
                t=round(rng.uniform(horizon * 0.1, horizon * 0.95), 3),
                kind="submit",
                payload={"ix": ix, "prompt": prompt,
                         "max_new": rng.randint(1, 8),
                         "priority": rng.randint(0, 2)}))
            ix += 1
        if rng.random() < 0.5:
            events.append(SimEvent(
                t=round(rng.uniform(1.0, horizon * 0.6), 3),
                kind="stale_directory",
                payload={"every": rng.choice([2, 3])}))
        if rng.random() < 0.5:
            events.append(SimEvent(
                t=round(rng.uniform(1.0, horizon * 0.6), 3),
                kind="corrupt_adopt",
                payload={"every": rng.choice([1, 2])}))
        if rng.random() < 0.4:
            events.append(SimEvent(
                t=round(rng.uniform(1.0, horizon * 0.6), 3),
                kind="cold_pressure",
                payload={"every": rng.choice([2, 3])}))
    return RegionSchedule(seed=seed, horizon=horizon,
                          engine_cfg=engine_cfg, fleet_cfg=fleet_cfg,
                          serving_cfg=serving_cfg, region_cfg=region_cfg,
                          events=events)


# ----------------------------------------------------------------------
# harness internals
# ----------------------------------------------------------------------

class _ScheduledFaultInjector(FaultInjector):
    """The soak's tick-fault arm: schedule events arm N failures, the
    next N serving ticks (fleet-wide) raise :class:`TickFault` through
    the production injector hook."""

    def __init__(self) -> None:
        super().__init__()
        self._armed = 0

    def arm(self, n: int) -> None:
        self._armed += int(n)

    def on_serving_tick(self, tick: int) -> None:
        if self._armed > 0:
            self._armed -= 1
            self._count("serving_tick_fail")
            raise TickFault(f"dst: injected serving tick fault (tick {tick})")


class _CaptureTelemetry(Telemetry):
    """Enabled telemetry with a fresh registry and an in-memory span
    capture instead of file sinks — the auditor's ledger view."""

    def __init__(self) -> None:
        super().__init__(config=None, registry=MetricsRegistry())
        self.enabled = True
        self.spans: List[Any] = []

    def record_request_span(self, stats):
        record = super().record_request_span(stats)
        self.spans.append(stats)
        return record


class _SimGuard:
    """Preemption-latch stand-in (the production guard is signal-bound)."""

    def __init__(self) -> None:
        self.should_stop = False


@dataclass
class _Tracked:
    """Harness-side bookkeeping for one submitted request."""

    ix: int
    req: Any
    delivered: List[int] = field(default_factory=list)


class _Trace:
    """Canonical event trace; its hash is the determinism witness."""

    def __init__(self) -> None:
        self.rows: List[tuple] = []

    def event(self, vt: float, kind: str, payload: Dict[str, Any]) -> None:
        canon = tuple(sorted((k, self._c(v)) for k, v in payload.items()))
        self.rows.append(("E", round(vt, 6), kind, canon))

    def tick(self, n: int, vt: float, fleet, tracked: List[_Tracked]) -> None:
        reps = tuple((r.name, r.state, r.serving._tick_count,
                      len(r.serving._queue), len(r.serving._live),
                      r.serving.pending_work)
                     for r in fleet.replicas)
        states: Dict[str, int] = {}
        total_tokens = 0
        for t in tracked:
            states[t.req.state.value] = states.get(t.req.state.value, 0) + 1
            total_tokens += len(t.req.tokens)
        self.rows.append(("T", n, round(vt, 6), reps,
                          tuple(sorted(states.items())), total_tokens))

    def tick_region(self, n: int, vt: float, region,
                    tracked: List[_Tracked]) -> None:
        cells = tuple(
            (c.name, c.state, tuple(
                (r.name, r.state, r.serving._tick_count,
                 len(r.serving._queue), len(r.serving._live),
                 r.serving.pending_work)
                for r in c.fleet.replicas))
            for c in region.cells)
        states: Dict[str, int] = {}
        total_tokens = 0
        for t in tracked:
            states[t.req.state.value] = states.get(t.req.state.value, 0) + 1
            total_tokens += len(t.req.tokens)
        self.rows.append(("T", n, round(vt, 6), cells,
                          tuple(sorted(states.items())), total_tokens,
                          region.brownout_floor))

    def finish(self, tracked: List[_Tracked]) -> None:
        self.rows.append(("F", tuple(
            (t.ix, t.req.state.value, tuple(t.req.tokens),
             round(t.req.t_finish, 6) if t.req.t_finish is not None else None)
            for t in tracked)))

    def hash(self) -> str:
        payload = "\n".join(repr(r) for r in self.rows)
        return hashlib.sha256(payload.encode("utf-8")).hexdigest()

    @staticmethod
    def _c(v):
        if isinstance(v, list):
            return tuple(v)
        return v


#: virtual seconds a score-breaching replica may stay ACTIVE while the
#: capacity floor has headroom before quarantine convergence (#15) is
#: violated — the honest monitor acts on the very poll it observes the
#: breach, so anything past a few polls is a detector that never fires
QUARANTINE_SLACK_S = 30.0
#: virtual seconds the routable pool may transiently sit below the
#: capacity floor (a death mid-event is repaired at the next monitor
#: poll's floor-release pass)
FLOOR_SLACK_S = 5.0
#: no-flap bound (#16): max quarantine entries per replica inside any
#: FLAP_WINDOW_S of virtual time. Doubled-dwell hysteresis caps the
#: honest machine at 5 entries per 100 virtual seconds even with the
#: shortest drawn dwell and a breach on every probation poll.
FLAP_WINDOW_S = 100.0
FLAP_LIMIT = 6


class InvariantAuditor:
    """The post-event audits. Each returns a list of violation strings;
    an empty list after every event of every schedule is the soak's
    pass condition."""

    def __init__(self, fleet, clock, capture: _CaptureTelemetry,
                 tracer: Optional[Tracer] = None,
                 vocab: Optional[int] = None,
                 injector: Optional[FaultInjector] = None) -> None:
        self.fleet = fleet
        self.clock = clock
        self.capture = capture
        self.tracer = tracer
        # the run's injector: #15's ground truth for WHICH replica the
        # schedule degraded (straggler_evidence_snapshot)
        self.injector = injector
        # sim vocab arms invariant #10 (greedy token-identity): the
        # expected stream is recomputable from the prompt alone because
        # the sim model is a pure function of context
        self.vocab = vocab
        self._expected: Dict[int, List[int]] = {}
        # trace_ids whose tree was already audited: each request's tree
        # is checked ONCE, when it first turns terminal — re-scanning
        # the whole span ring per terminal request per tick would make
        # the soak quadratic in run length
        self._trees_checked: set = set()
        self._last_now = clock.now()
        # gray-plane audit state (#15): replica -> first audit instant
        # a should-quarantine breach was seen with floor headroom, and
        # fleet-pool -> first audit instant the floor was seen broken
        self._q_pending: Dict[str, float] = {}
        self._floor_breach: Dict[str, float] = {}

    def _replicas(self):
        """Every replica under audit. The region subclass widens this to
        all cells' fleets — every invariant below then holds REGION-wide
        for free (conservation across cell death, ownership across
        partitions)."""
        return list(self.fleet.replicas)

    def _fleets(self):
        """Every fleet under audit (the gray-plane invariants #14-#16
        read per-fleet health/breaker/hedge ledgers). The region
        subclass widens this to all cells' fleets."""
        return [self.fleet]

    def _hedge_pairs(self):
        """Every HedgePair the audited fleets ever minted (live uid rows
        plus the both-terminal ledger), deduplicated."""
        pairs = []
        seen: set = set()
        for fleet in self._fleets():
            for p in list(fleet._hedges.values()) + list(fleet._hedge_done):
                if id(p) in seen:
                    continue
                seen.add(id(p))
                pairs.append(p)
        return pairs

    def audit(self, tracked: List[_Tracked]) -> List[str]:
        from ..serving.request import RequestState

        v: List[str] = []
        # 5. monotone virtual time
        now = self.clock.now()
        if now < self._last_now:
            v.append(f"[time] virtual time went backwards: "
                     f"{self._last_now} -> {now}")
        self._last_now = now
        # 1. KV block-balance partition, every replica incl. dead ones
        for rep in self._replicas():
            for p in block_balance_report(rep.engine)["problems"]:
                v.append(f"[block-balance] {rep.name}: {p}")
        # 2. request state-machine legality / containment
        for rep in self._replicas():
            srv = rep.serving
            for r in srv._queue:
                if r.state is not RequestState.QUEUED:
                    v.append(f"[state] {rep.name}: request {r.uid} in queue "
                             f"with state {r.state.name}")
            for uid, r in srv._live.items():
                if r.state not in (RequestState.PREFILL, RequestState.DECODE):
                    v.append(f"[state] {rep.name}: live request {uid} in "
                             f"state {r.state.name}")
            for uid, r in srv._requests.items():
                if r.is_terminal:
                    v.append(f"[state] {rep.name}: terminal request {uid} "
                             f"still registered")
        # 3. conservation: every submitted request is terminal or owned
        # by exactly one replica (no lost, no duplicated requests)
        for t in tracked:
            owners = [rep.name for rep in self._replicas()
                      if t.req.uid in rep.serving._requests]
            if t.req.is_terminal:
                if owners:
                    v.append(f"[conservation] r{t.ix} terminal but still "
                             f"owned by {owners}")
            elif len(owners) != 1:
                v.append(f"[conservation] r{t.ix} ({t.req.state.name}) "
                         f"owned by {owners} — expected exactly one owner")
        # 4. span / SLO ledger consistency. Hedged requests are judged
        # PAIR-wise by invariant #14 below (the two legs share one
        # ledger slot — the winner's); the per-uid rules here cover the
        # unhedged ones, with shadow uids admitted as known emitters.
        pairs = self._hedge_pairs()
        hedged = {p.primary.uid: p for p in pairs}
        shadow_uids = {p.shadow.uid for p in pairs}
        span_count: Dict[int, int] = {}
        for s in self.capture.spans:
            span_count[s.uid] = span_count.get(s.uid, 0) + 1
        known = {t.req.uid for t in tracked} | shadow_uids
        for uid in span_count:
            if uid not in known:
                v.append(f"[span-ledger] span for unknown uid {uid}")
        for t in tracked:
            if t.req.uid in hedged:
                continue
            n = span_count.get(t.req.uid, 0)
            if t.req.is_terminal and n != 1:
                v.append(f"[span-ledger] r{t.ix} terminal with {n} spans "
                         f"(exactly one expected)")
            elif not t.req.is_terminal and n != 0:
                v.append(f"[span-ledger] r{t.ix} live with {n} spans")
        judged = sum(1 for s in self.capture.spans if s.in_slo is not None)
        met = sum(1 for s in self.capture.spans if s.in_slo is True)
        reg = self.capture.registry
        if reg.counter("serving/slo_judged").value != judged:
            v.append(f"[slo-ledger] slo_judged counter "
                     f"{reg.counter('serving/slo_judged').value} != "
                     f"{judged} judged spans")
        if reg.counter("serving/slo_met").value != met:
            v.append(f"[slo-ledger] slo_met counter "
                     f"{reg.counter('serving/slo_met').value} != {met} "
                     f"met spans")
        # 6. stream-delivery completeness: on_token delivered exactly the
        # emitted stream, in order, across preempt/retry/failover. For a
        # hedged request the client-visible stream is the WINNER leg's —
        # the loser may have emitted tokens into its Request before the
        # gate dropped them, and that is exactly what must never leak.
        for t in tracked:
            pair = hedged.get(t.req.uid)
            if pair is not None:
                w = pair.winner
                want = list(w.tokens) if w is not None else []
                if t.delivered != want:
                    v.append(f"[delivery] r{t.ix} (hedged): delivered "
                             f"{t.delivered} != winner leg's emitted "
                             f"{want}")
                continue
            if t.delivered != list(t.req.tokens):
                v.append(f"[delivery] r{t.ix}: delivered {t.delivered} != "
                         f"emitted {list(t.req.tokens)}")
        # 10. greedy token-identity: every emitted stream is a PREFIX of
        # the pure-function greedy expectation recomputed from the
        # prompt alone — speculative decoding, quantized KV, preemption,
        # failover and disaggregated hand-off may change WHEN tokens
        # emit, never WHICH (the serving layer's token-identity
        # contract, witnessed at fleet scale on every audit)
        if self.vocab:
            for t in tracked:
                n = len(t.req.tokens)
                if not n:
                    continue
                want = self._expected_stream(t.req, n)
                if list(t.req.tokens) != want:
                    v.append(f"[token-identity] r{t.ix}: emitted "
                             f"{list(t.req.tokens)} != greedy expectation "
                             f"{want}")
        # 11. version-stream atomicity: one request's token stream is
        # emitted by ONE model version end to end (serving/rollout.py's
        # hot-swap contract). A flip that lets a swapped replica resume
        # a mid-stream request, or a version-blind failover resume,
        # would splice two versions into one stream — the continuation
        # gate must refuse and re-route instead.
        for t in tracked:
            if len(set(t.req.served_versions)) > 1:
                v.append(f"[version-stream] r{t.ix}: stream served by "
                         f"versions {t.req.served_versions} — a request "
                         f"is one version end to end")
        # 7. trace-tree connectivity: a terminal request's spans — across
        # however many replicas served it (failover, disagg hand-off) —
        # must form ONE closed connected tree: exactly one root, no
        # orphan parents, nothing left open
        if self.tracer is not None and self.tracer.enabled:
            for t in tracked:
                root = getattr(t.req, "_trace_root", None)
                if not t.req.is_terminal or root is None or root.is_noop \
                        or root.trace_id in self._trees_checked:
                    continue
                self._trees_checked.add(root.trace_id)
                for p in trace_tree_problems(
                        self.tracer.spans_for_trace(root.trace_id)):
                    v.append(f"[trace-tree] r{t.ix}: {p}")
        v.extend(self._audit_gray(pairs, span_count, now))
        v.extend(self._audit_kvtier())
        return v

    def _audit_gray(self, pairs, span_count: Dict[int, int],
                    now: float) -> List[str]:
        """The gray-failure plane's invariants:

        * **#14 hedge conservation** — of a hedged pair's two legs,
          exactly one wins; the loser's span/SLO verdict never reaches
          the ledger (at most one span across the pair, exactly one
          once both legs are terminal, and it is the winner's).
        * **#15 quarantine convergence + capacity floor** — a replica
          whose health machine demands quarantine while the floor has
          headroom is drained within ``QUARANTINE_SLACK_S``; the
          routable pool never sits below the floor for more than
          ``FLOOR_SLACK_S`` (quarantine defers/releases around it).
        * **#16 no-flap** — doubled-dwell hysteresis bounds quarantine
          churn: more than ``FLAP_LIMIT`` quarantine entries for one
          replica inside any ``FLAP_WINDOW_S`` of virtual time means
          the machine is flapping.
        """
        from ..serving.fleet import ReplicaState
        from ..serving.health import HealthState

        v: List[str] = []
        # 14. hedge conservation
        for pair in pairs:
            cid = pair.primary.client_request_id
            n = (span_count.get(pair.primary.uid, 0)
                 + span_count.get(pair.shadow.uid, 0))
            if n > 1:
                v.append(f"[hedge] {cid}: {n} spans across the two legs "
                         f"— the ledger judged the request more than "
                         f"once")
            if pair.winner_uid is not None:
                if pair.winner_uid not in (pair.primary.uid,
                                           pair.shadow.uid):
                    v.append(f"[hedge] {cid}: winner uid "
                             f"{pair.winner_uid} is neither leg")
                loser = pair.loser
                if loser is not None and span_count.get(loser.uid, 0):
                    v.append(f"[hedge] {cid}: decided LOSER leg "
                             f"{loser.uid} emitted a span — its verdict "
                             f"must be suppressed")
            if pair.primary.is_terminal and pair.shadow.is_terminal:
                if pair.winner_uid is None:
                    v.append(f"[hedge] {cid}: both legs terminal with "
                             f"no winner decided")
                elif n != 1:
                    v.append(f"[hedge] {cid}: both legs terminal with "
                             f"{n} spans (exactly one — the winner's — "
                             f"expected)")
        # 15. quarantine convergence + capacity floor
        for fi, fleet in enumerate(self._fleets()):
            cfg = fleet.config
            if not cfg.quarantine:
                continue
            ftag = fleet.name or f"fleet{fi}"
            pending_keys: set = set()
            pools = ((False,) if not cfg.disaggregated else (False, True))
            for prefill in pools:
                routable = pool = 0
                breaching: List[str] = []
                for r in fleet.replicas:
                    if (r.state is not ReplicaState.HEALTHY
                            or (r.role == "prefill") != prefill):
                        continue
                    pool += 1
                    h = fleet._health.get(r.name)
                    if h is None or h.routable:
                        routable += 1
                    if h is not None and h.should_quarantine():
                        breaching.append(r.name)
                floor = min(cfg.prefill_replicas if prefill
                            else cfg.min_replicas, pool)
                pkey = f"{ftag}/{'prefill' if prefill else 'decode'}"
                if routable < floor:
                    first = self._floor_breach.setdefault(pkey, now)
                    if now - first > FLOOR_SLACK_S:
                        v.append(f"[quarantine-floor] {pkey}: {routable} "
                                 f"routable < floor {floor} for "
                                 f"{now - first:.0f} virtual seconds — "
                                 f"quarantine drained below the "
                                 f"capacity floor")
                else:
                    self._floor_breach.pop(pkey, None)
                headroom = routable - 1 >= floor
                for name in breaching:
                    key = f"{ftag}/{name}"
                    if not headroom:
                        # the floor binds: deferral is the CORRECT
                        # behavior, restart the convergence timer
                        continue
                    pending_keys.add(key)
                    first = self._q_pending.setdefault(key, now)
                    if now - first > QUARANTINE_SLACK_S:
                        v.append(f"[quarantine] {key}: health machine "
                                 f"demanded quarantine for "
                                 f"{now - first:.0f} virtual seconds "
                                 f"with floor headroom, never drained")
            for key in list(self._q_pending):
                if key.startswith(f"{ftag}/") and key not in pending_keys:
                    self._q_pending.pop(key)
        # 16. no-flap
        for fleet in self._fleets():
            for h in fleet._health.values():
                entries = [t for (t, _frm, to) in h.transitions
                           if to == HealthState.QUARANTINED]
                for i in range(len(entries)):
                    j = i
                    while (j + 1 < len(entries)
                           and entries[j + 1] - entries[i]
                           <= FLAP_WINDOW_S):
                        j += 1
                    if j - i + 1 > FLAP_LIMIT:
                        v.append(f"[flap] {h.name}: {j - i + 1} "
                                 f"quarantine entries within "
                                 f"{FLAP_WINDOW_S:.0f} virtual seconds "
                                 f"— hysteresis is not bounding churn")
                        break
        return v

    def _audit_kvtier(self) -> List[str]:
        """The global KV tier's invariants:

        * **#17 directory-residency containment** — a directory entry
          never outlives its pages: every (member, hash) entry names a
          LIVE (non-DEAD) replica whose prefix cache currently holds
          that full-block prefix. The only exemption is a hash the
          fault injector itself planted (``stale_directory`` lies) —
          those must age out via the staleness bound, never be trusted,
          and are bookkept in ``injector.injected_stale``.
        * **#18 cold-tier accounting + integrity** — the host cold
          tier's page accounting is exact (``used == sum(entries)``,
          ``used <= capacity``) and every resident export still passes
          its checksum (spills gather from live pages, so a cold entry
          that fails verify() was corrupted INSIDE the tier).
        * **#19 corruption never lands** — a prefix export that fails
          checksum verification is NEVER imported into a device pool:
          ``kvtier_corrupt_landed`` stays zero on every engine (the
          ``corrupt_adopt`` fault kind feeds the wire-corruption side;
          the ``_kvtier_skip_verify`` seam is the planted-bug tooth).
        """
        from ..serving.fleet import ReplicaState

        v: List[str] = []
        injected = (self.injector.injected_stale_snapshot()
                    if self.injector is not None else set())
        for fi, fleet in enumerate(self._fleets()):
            tier = getattr(fleet, "kv_tier", None)
            if tier is None:
                continue
            ftag = fleet.name or f"fleet{fi}"
            reps = {r.name: r for r in fleet.replicas}
            # 17. directory-residency containment
            for member in tier.directory.members():
                rep = reps.get(member)
                if rep is None or rep.state is ReplicaState.DEAD:
                    v.append(f"[kv-directory] {ftag}: entries for "
                             f"{'unknown' if rep is None else 'dead'} "
                             f"member {member} — the entries outlived "
                             f"their replica")
                    continue
                resident = set(rep.engine.prefix_residency_hashes()) \
                    if hasattr(rep.engine, "prefix_residency_hashes") \
                    else set()
                for h in tier.directory.entries_for(member):
                    if h not in resident and (member, h) not in injected:
                        v.append(f"[kv-directory] {ftag}/{member}: entry "
                                 f"{h:#018x} not resident in the "
                                 f"member's prefix cache — the entry "
                                 f"outlived its pages")
            # 18. cold-tier accounting + integrity
            cold = tier.cold
            if cold is not None:
                pages = cold.entry_pages()
                used = cold.used_pages
                if used != sum(pages):
                    v.append(f"[kv-cold] {ftag}: used_pages {used} != "
                             f"sum of entries {sum(pages)} — page "
                             f"accounting drifted")
                if used > cold.capacity_pages:
                    v.append(f"[kv-cold] {ftag}: used_pages {used} over "
                             f"capacity {cold.capacity_pages} — LRU "
                             f"pressure valve failed")
                for e in cold.entries_snapshot():
                    if not e.verify():
                        v.append(f"[kv-cold] {ftag}: entry for "
                                 f"{len(e.tokens)}-token prefix fails "
                                 f"checksum — corrupted inside the "
                                 f"cold tier")
        # 19. corruption never lands (all replicas, dead included — a
        # corrupt import that landed before the kill still landed)
        for rep in self._replicas():
            landed = getattr(rep.engine, "kvtier_corrupt_landed", 0)
            if landed:
                v.append(f"[kv-adopt] {rep.name}: {landed} corrupt "
                         f"prefix export(s) imported into the device "
                         f"pool — verify-before-import is breached")
        return v

    def _expected_stream(self, req, n: int) -> List[int]:
        """First ``n`` tokens of the sim model's greedy stream for
        ``req`` — grown lazily and memoized per uid (the audit runs
        after every event; recomputing the FNV chain from scratch each
        time would be quadratic in run length)."""
        exp = self._expected.setdefault(req.uid, [])
        if len(exp) < n:
            ctx = list(req.prompt) + exp
            while len(exp) < n:
                t = _next_token(ctx, self.vocab)
                exp.append(t)
                ctx.append(t)
        return exp[:n]

    def final(self, tracked: List[_Tracked], engines: List[SimEngine]
              ) -> List[str]:
        """Post-close audit: everything terminal, zero leaked pages on
        every engine ever built (dead replicas included)."""
        v: List[str] = []
        for t in tracked:
            if not t.req.is_terminal:
                v.append(f"[liveness] r{t.ix} not terminal after close "
                         f"({t.req.state.name})")
        for i, eng in enumerate(engines):
            for p in block_balance_report(eng)["problems"]:
                v.append(f"[leak] engine{i}: {p}")
            if eng.prefix_cache is not None:
                eng.prefix_cache.drop_all(eng.allocator)
            if eng.allocator.free_blocks != eng.allocator.n_blocks:
                v.append(f"[leak] engine{i}: "
                         f"{eng.allocator.n_blocks - eng.allocator.free_blocks}"
                         f" pages never freed")
        return v


class RegionInvariantAuditor(InvariantAuditor):
    """The region tier's audits: every base invariant widened to ALL
    cells' replicas (conservation now holds across cell death and
    partitions for free), plus three region-specific invariants:

    * **#8 heal convergence / single ownership** — a request is never
      owned by replicas of two cells (the double-ownership a fenceless
      cross-partition failover would mint), and the region's routing
      table always names the cell that actually owns it: after a heal,
      both sides agree — nothing stranded on both, nothing stranded on
      neither (the zero-owner half is base invariant #3). Terminal
      requests linger in NO table, region or cell fleet — a stale
      ownership row is a leak in the making.
    * **#9 shed-span** — every REJECTED request (brownout sheds
      included) retired with exactly one span whose recorded state is
      ``rejected`` and a human-readable reason: load shedding is
      explicit, never silent.
    * The base liveness rail doubles as the partition-tolerance check:
      requests on a severed-but-alive cell must still finish (the cell
      computes locally) — a harness or region bug that stalls them
      trips [liveness].
    * **#12 per-tenant version monotonicity** — once a tenant has been
      served by model version V, no later request of theirs is served
      by an older one, UNLESS the rollout controller logged a rollback
      of the newer version (its justification ledger,
      ``region.version_log``) or the request spilled off its version
      preference for availability (``_canary_spilled``).
    * **#13 rollback convergence** — a controller that enters
      ROLLING_BACK must reach ROLLED_BACK within the liveness slack,
      and a terminal phase must MATCH the fleet: DONE ⇒ every live
      replica on the target version, ROLLED_BACK ⇒ every live replica
      back on stable (the leaky-promote / phantom-rollback detector).
    """

    def __init__(self, region, clock, capture: _CaptureTelemetry,
                 tracer: Optional[Tracer] = None,
                 vocab: Optional[int] = None,
                 injector: Optional[FaultInjector] = None) -> None:
        super().__init__(fleet=None, clock=clock, capture=capture,
                         tracer=tracer, vocab=vocab, injector=injector)
        self.region = region
        # rollout-invariant state (#12/#13): per tenant, the noted
        # (submit-order, served-version) entries; the uids whose FIRST
        # served version was already folded in (one note per request —
        # the audit runs after every event); and when the controller
        # was first seen ROLLING_BACK (the convergence timer)
        self._tenant_seen: Dict[str, List[Dict[str, Any]]] = {}
        self._version_noted: set = set()
        self._rb_since: Optional[float] = None

    def _replicas(self):
        out = []
        for cell in self.region.cells:
            out.extend(cell.fleet.replicas)
        return out

    def _fleets(self):
        return [cell.fleet for cell in self.region.cells]

    def audit(self, tracked: List[_Tracked]) -> List[str]:
        from ..serving.request import RequestState

        v = super().audit(tracked)
        region = self.region
        # 8. convergence: cell-level ownership vs the region table
        owner_cells: Dict[int, List[str]] = {}
        for cell in region.cells:
            for rep in cell.fleet.replicas:
                for uid in rep.serving._requests:
                    cells = owner_cells.setdefault(uid, [])
                    if cell.name not in cells:
                        cells.append(cell.name)
        with region._lock:
            table = {uid: name for uid, (_r, name)
                     in region._requests.items()}
        fleet_tables: Dict[str, set] = {}
        for cell in region.cells:
            with cell.fleet._lock:
                fleet_tables[cell.name] = set(cell.fleet._requests)
        for t in tracked:
            uid = t.req.uid
            if t.req.is_terminal:
                if uid in table:
                    v.append(f"[convergence] r{t.ix} terminal but still "
                             f"in the region table ({table[uid]})")
                # a terminal request must not linger in any cell's FLEET
                # table either — escalation paths that hand ownership up
                # to the region must drop the source fleet's row, or the
                # row leaks for the fleet's lifetime
                stale = [name for name, uids in fleet_tables.items()
                         if uid in uids]
                if stale:
                    v.append(f"[convergence] r{t.ix} terminal but still "
                             f"in fleet table(s) {stale} — stale "
                             f"ownership row")
                continue
            cells = owner_cells.get(uid, [])
            if len(cells) > 1:
                v.append(f"[convergence] r{t.ix} owned by replicas of "
                         f"{cells} — double ownership across cells")
            elif cells:
                if uid not in table:
                    v.append(f"[convergence] r{t.ix} owned by "
                             f"{cells[0]} but missing from the region "
                             f"table")
                elif table[uid] != cells[0]:
                    v.append(f"[convergence] r{t.ix}: region table says "
                             f"{table[uid]} but {cells[0]} owns it")
        # 9. shed-span: rejects carry exactly one 'rejected' span + a
        # reason (the silent-shed detector)
        spans_by_uid: Dict[int, List[Any]] = {}
        for s in self.capture.spans:
            spans_by_uid.setdefault(s.uid, []).append(s)
        for t in tracked:
            if t.req.state is not RequestState.REJECTED:
                continue
            spans = spans_by_uid.get(t.req.uid, [])
            if len(spans) != 1 or spans[0].state != "rejected":
                v.append(f"[shed-span] r{t.ix} rejected with "
                         f"{[s.state for s in spans]} span(s) — "
                         f"expected exactly one 'rejected'")
            elif not t.req.error:
                v.append(f"[shed-span] r{t.ix} rejected without a "
                         f"reason — silent shed")
        # 12. per-tenant version monotonicity, in SUBMISSION order: for
        # any two of a tenant's requests, the earlier-submitted one must
        # not be served by a NEWER version than the later-submitted one
        # (canary stickiness means one tenant sees one side of the split
        # for a whole rollout; emission order is explicitly NOT the
        # contract — an in-flight pre-rollout request legally finishes
        # on the old version after the tenant's canary requests saw the
        # new one). The two licenses for a decrease: a controller-logged
        # "rollback" row for the newer version (the justification
        # ledger), or EITHER endpoint spilling off its version
        # preference for availability (a spill onto the canary version
        # never moved the tenant forward, and a spill off it is not a
        # downgrade — availability beat affinity, witnessed on the
        # request).
        rolled_back = {row["version"] for row in region.version_log
                       if row["kind"] == "rollback"}
        for t in tracked:
            if t.req.uid in self._version_noted or not t.req.served_versions:
                continue
            self._version_noted.add(t.req.uid)
            key = t.req.tenant or t.req.client_request_id
            me = {"order": (t.req.t_submit if t.req.t_submit is not None
                            else 0.0, t.req.uid),
                  "ver": t.req.served_versions[0],
                  "spilled": bool(getattr(t.req, "_canary_spilled",
                                          False)),
                  "ix": t.ix}
            entries = self._tenant_seen.setdefault(key, [])
            for o in entries:
                early, late = ((o, me) if o["order"] <= me["order"]
                               else (me, o))
                if (early["ver"] > late["ver"]
                        and early["ver"] not in rolled_back
                        and not early["spilled"] and not late["spilled"]):
                    v.append(f"[version-monotonic] tenant {key}: "
                             f"r{late['ix']} served by version "
                             f"{late['ver']} though earlier-submitted "
                             f"r{early['ix']} saw {early['ver']} with "
                             f"no rollback logged")
            entries.append(me)
        # 13. rollback convergence: ROLLING_BACK is a transient, never a
        # destination — it must reach ROLLED_BACK within the liveness
        # slack; and a terminal phase must agree with the fleet's actual
        # versions (checked on every audit while terminal, so a respawn
        # or autoscale that resurrects the abandoned version trips too)
        from ..serving.fleet import ReplicaState
        from ..serving.rollout import RolloutPhase, TERMINAL_PHASES
        ro = region.rollout
        phase = ro.phase
        now = self.clock.now()
        if phase == RolloutPhase.ROLLING_BACK:
            if self._rb_since is None:
                self._rb_since = now
            elif now - self._rb_since > LIVENESS_SLACK_TICKS:
                v.append(f"[rollback-convergence] controller stuck "
                         f"ROLLING_BACK for {now - self._rb_since:.0f} "
                         f"virtual seconds — rollback never converges")
        else:
            self._rb_since = None
        if phase in TERMINAL_PHASES and ro.target_version is not None:
            want = (ro.target_version if phase == RolloutPhase.DONE
                    else ro.stable_version)
            wrong = sorted(r.name for r in self._replicas()
                           if r.state is not ReplicaState.DEAD
                           and r.version != want)
            if wrong:
                v.append(f"[rollback-convergence] phase {phase} but "
                         f"replica(s) {wrong} not on version {want}")
        return v


# ----------------------------------------------------------------------
# the simulation driver
# ----------------------------------------------------------------------

@dataclass
class SimReport:
    """Outcome of one schedule run."""

    seed: int
    trace_hash: str
    violations: List[str]
    n_ticks: int
    n_events: int
    submitted: int
    finished: int
    cancelled: int
    rejected: int
    tokens: Dict[int, List[int]]          # logical ix -> emitted stream
    # logical ix -> terminal state value ("finished"/"cancelled"/...) —
    # the spec-on/off identity gate compares streams exactly for
    # requests finished in BOTH runs and prefix-wise otherwise (spec
    # changes WHEN a timing-dependent cancel/fault lands, never WHICH
    # tokens precede it)
    states: Dict[int, str] = field(default_factory=dict)
    # canonical hash of the run's span tree (telemetry/tracing.py): the
    # second determinism witness — same seed, same request timelines
    span_hash: str = ""
    n_spans: int = 0
    # the span timeline (span dicts), kept only for failing runs so
    # dump_repro can ship the event timeline with the repro
    spans: Optional[List[Dict[str, Any]]] = None
    # region runs only: the brownout admit/shed rows — the soak's
    # strictly-priority-ordered shedding gate reads these
    brownout_log: Optional[List[Dict[str, Any]]] = None
    # logical ix -> first-token latency in virtual seconds, for
    # requests that streamed at least one token — what a p99 TTFT
    # comparison of the gray plane on and off reads
    ttfts: Dict[int, float] = field(default_factory=dict)
    # gray-failure plane snapshot (health scores, breakers, hedge
    # ledger): the fleet's for fleet runs, per-cell for region runs
    gray: Optional[Dict[str, Any]] = None

    @property
    def ok(self) -> bool:
        return not self.violations

    def summary(self) -> Dict[str, Any]:
        return {"seed": self.seed, "trace_hash": self.trace_hash,
                "span_hash": self.span_hash, "n_spans": self.n_spans,
                "violations": self.violations, "ticks": self.n_ticks,
                "events": self.n_events, "submitted": self.submitted,
                "finished": self.finished, "cancelled": self.cancelled,
                "rejected": self.rejected}


#: extra virtual ticks past the last event before a non-quiescent fleet
#: counts as a liveness violation (a request parked forever IS a lost
#: request — the conservation invariant's temporal half)
LIVENESS_SLACK_TICKS = 600


def run_schedule(schedule: Schedule,
                 engine_factory: Optional[Callable[[], SimEngine]] = None,
                 stop_on_violation: bool = True) -> SimReport:
    """Execute one schedule under virtual time and audit every event.
    Pure: same schedule, same report (bit-identical ``trace_hash``)."""
    from ..serving.fleet import ServingFleet
    from ..serving.request import RequestState
    from ..telemetry.registry import get_registry, set_registry
    from ..telemetry.telemetry import get_telemetry

    clock = SimClock()
    capture = _CaptureTelemetry()
    injector = _ScheduledFaultInjector()
    # a FRESH tracer per run: span/trace ids restart from 1, so two runs
    # of the same schedule in one process produce identical canonical
    # hashes (the bit-determinism witness); the flight
    # recorder stays in-memory (no dump dir) and auto-dumps on the first
    # invariant violation so a repro carries the black box too
    tracer = Tracer(enabled=True, ring_size=16384, flight_capacity=2048)
    prev_telemetry = get_telemetry()
    # set_telemetry(capture) below also swaps the process-default
    # registry; restoring telemetry alone would leave the default
    # registry pointing at the sim's capture forever (set_telemetry(None)
    # deliberately does not touch the registry) — save it explicitly
    prev_registry = get_registry()
    engines: List[SimEngine] = []
    sim_cfg = SimConfig(**schedule.engine_cfg)

    def factory() -> SimEngine:
        eng = (engine_factory() if engine_factory is not None
               else SimEngine(sim_cfg))
        engines.append(eng)
        return eng

    trace = _Trace()
    tracked: List[_Tracked] = []
    violations: List[str] = []
    n_ticks = 0
    with use_clock(clock), use_tracer(tracer):
        set_telemetry(capture)
        install_fault_injector(injector)
        try:
            guard = _SimGuard()
            # the simulated engines hold no tensor: the fleet runs on
            # the CPU by request (its default would be the card)
            fleet = ServingFleet(factory, dict(schedule.fleet_cfg),
                                 dict(schedule.serving_cfg),
                                 preemption_guard=guard, start=False,
                                 device="cpu")
            auditor = InvariantAuditor(fleet, clock, capture,
                                       tracer=tracer, vocab=sim_cfg.vocab,
                                       injector=injector)
            events = sorted(schedule.events, key=_event_order)
            i = 0
            while True:
                while i < len(events) and events[i].t <= clock.now() + 1e-9:
                    ev = events[i]
                    i += 1
                    _apply_event(fleet, ev, tracked, guard, injector, clock)
                    trace.event(clock.now(), ev.kind, ev.payload)
                    step_violations = auditor.audit(tracked)
                    violations.extend(step_violations)
                    if step_violations and stop_on_violation:
                        break
                if violations and stop_on_violation:
                    break
                did = fleet.step()
                clock.advance(1.0)
                n_ticks += 1
                step_violations = auditor.audit(tracked)
                violations.extend(step_violations)
                trace.tick(n_ticks, clock.now(), fleet, tracked)
                if step_violations and stop_on_violation:
                    break
                quiescent = (not did and fleet.queue_depth == 0
                             and all(t.req.is_terminal for t in tracked))
                if i >= len(events) and quiescent:
                    break
                if not did and i < len(events) and events[i].t > clock.now():
                    clock.advance(events[i].t - clock.now())
                if n_ticks > schedule.horizon + LIVENESS_SLACK_TICKS:
                    stuck = [t.ix for t in tracked if not t.req.is_terminal]
                    violations.append(
                        f"[liveness] simulation did not quiesce within "
                        f"{n_ticks} ticks; live requests: {stuck}")
                    break
            # shutdown: the drain loops sleep on the clock; the pump
            # steps the fleet so virtual time AND work both progress
            clock.pump = fleet.step
            fleet.close(timeout=30.0)
            clock.pump = None
            violations.extend(auditor.audit(tracked))
            violations.extend(auditor.final(tracked, engines))
            trace.finish(tracked)
            if violations:
                # invariant-audit failure: snapshot the black box (in
                # memory — dump_repro ships it with the repro artifact)
                tracer.flight.note("invariant_audit_failed",
                                   n_violations=len(violations))
                tracer.flight.dump("invariant-audit")
        finally:
            install_fault_injector(None)
            set_telemetry(prev_telemetry
                          if prev_telemetry is not None
                          and prev_telemetry.enabled else None)
            set_registry(prev_registry)
    states = [t.req.state for t in tracked]
    return SimReport(
        seed=schedule.seed, trace_hash=trace.hash(),
        violations=violations, n_ticks=n_ticks, n_events=len(schedule.events),
        submitted=len(tracked),
        finished=sum(s is RequestState.FINISHED for s in states),
        cancelled=sum(s is RequestState.CANCELLED for s in states),
        rejected=sum(s is RequestState.REJECTED for s in states),
        tokens={t.ix: list(t.req.tokens) for t in tracked},
        states={t.ix: t.req.state.value for t in tracked},
        span_hash=tracer.canonical_hash(), n_spans=len(tracer.spans()),
        spans=([s.to_dict() for s in tracer.spans()]
               if violations else None),
        ttfts={t.ix: round(t.req.t_first_token - t.req.t_submit, 6)
               for t in tracked
               if t.req.t_first_token is not None
               and t.req.t_submit is not None},
        gray=fleet.gray_snapshot())


def _apply_event(fleet, ev: SimEvent, tracked: List[_Tracked], guard,
                 injector: _ScheduledFaultInjector, clock: SimClock) -> None:
    p = ev.payload
    if ev.kind == "submit":
        entry = _Tracked(ix=int(p["ix"]), req=None)
        entry.req = fleet.submit(
            list(p["prompt"]), max_new_tokens=int(p["max_new"]),
            priority=int(p.get("priority", 0)),
            deadline_s=p.get("deadline"),
            ttft_deadline_s=p.get("ttft_deadline"),
            eos_token_id=p.get("eos"),
            tenant=p.get("tenant"),
            on_token=entry.delivered.append)
        tracked.append(entry)
    elif ev.kind == "cancel":
        target = int(p["target"])
        for t in tracked:
            if t.ix == target and not t.req.is_terminal:
                fleet.cancel(t.req)
                break
    elif ev.kind == "tick_fault":
        injector.arm(int(p.get("n", 1)))
    elif ev.kind == "replica_death":
        healthy = sorted(r.name for r in fleet.healthy_replicas)
        if healthy:
            name = healthy[int(p.get("which", 0)) % len(healthy)]
            fleet.kill_replica(name, reason="dst: scheduled death")
    elif ev.kind == "latch":
        guard.should_stop = True
    elif ev.kind == "scale":
        fleet.scale_to(int(p["n"]))
    elif ev.kind == "stall":
        clock.advance(float(p.get("dt", 1.0)))
    elif ev.kind == "degraded_tick":
        healthy = sorted(r.name for r in fleet.healthy_replicas)
        if healthy:
            name = healthy[int(p.get("which", 0)) % len(healthy)]
            injector.degrade_replica(name, int(p.get("k", 2)))
    elif ev.kind == "stall_burst":
        healthy = sorted(r.name for r in fleet.healthy_replicas)
        if healthy:
            name = healthy[int(p.get("which", 0)) % len(healthy)]
            injector.arm_stall_burst(name, int(p.get("n", 1)))
    elif ev.kind == "flaky_import":
        injector.flaky_import_every = int(p.get("every", 0))
    elif ev.kind == "stale_directory":
        injector.stale_directory_every = int(p.get("every", 0))
    elif ev.kind == "corrupt_adopt":
        injector.corrupt_adopt_every = int(p.get("every", 0))
    elif ev.kind == "cold_pressure":
        injector.cold_pressure_every = int(p.get("every", 0))
    else:
        raise ValueError(f"unknown simulation event kind '{ev.kind}'")


def run_region_schedule(schedule: RegionSchedule,
                        engine_factory: Optional[Callable[[], SimEngine]] = None,
                        region_factory=None,
                        stop_on_violation: bool = True) -> SimReport:
    """Execute one REGION schedule under virtual time, auditing after
    every event and tick with :class:`RegionInvariantAuditor`. Pure:
    same schedule, same (trace_hash, span_hash). ``region_factory``
    lets tests plant region-layer bugs (the auditor's teeth), exactly
    as ``engine_factory`` plants engine bugs one tier down."""
    from ..serving.region import Region
    from ..serving.request import RequestState
    from ..telemetry.registry import get_registry, set_registry
    from ..telemetry.telemetry import get_telemetry

    clock = SimClock()
    capture = _CaptureTelemetry()
    injector = _ScheduledFaultInjector()
    tracer = Tracer(enabled=True, ring_size=32768, flight_capacity=2048)
    prev_telemetry = get_telemetry()
    prev_registry = get_registry()
    engines: List[SimEngine] = []
    sim_cfg = SimConfig(**schedule.engine_cfg)

    def factory() -> SimEngine:
        eng = (engine_factory() if engine_factory is not None
               else SimEngine(sim_cfg))
        engines.append(eng)
        return eng

    trace = _Trace()
    tracked: List[_Tracked] = []
    violations: List[str] = []
    n_ticks = 0
    with use_clock(clock), use_tracer(tracer):
        set_telemetry(capture)
        install_fault_injector(injector)
        try:
            guard = _SimGuard()
            builder = (region_factory if region_factory is not None
                       else Region)
            # on the CPU by request, as run_schedule's fleet
            region = builder(factory, dict(schedule.region_cfg),
                             dict(schedule.fleet_cfg),
                             dict(schedule.serving_cfg),
                             preemption_guard=guard, start=False,
                             device="cpu")
            auditor = RegionInvariantAuditor(region, clock, capture,
                                             tracer=tracer,
                                             vocab=sim_cfg.vocab,
                                             injector=injector)
            events = sorted(schedule.events, key=_event_order)
            i = 0
            while True:
                while i < len(events) and events[i].t <= clock.now() + 1e-9:
                    ev = events[i]
                    i += 1
                    _apply_region_event(region, ev, tracked, guard,
                                        injector, clock)
                    trace.event(clock.now(), ev.kind, ev.payload)
                    step_violations = auditor.audit(tracked)
                    violations.extend(step_violations)
                    if step_violations and stop_on_violation:
                        break
                if violations and stop_on_violation:
                    break
                did = region.step()
                clock.advance(1.0)
                n_ticks += 1
                step_violations = auditor.audit(tracked)
                violations.extend(step_violations)
                trace.tick_region(n_ticks, clock.now(), region, tracked)
                if step_violations and stop_on_violation:
                    break
                quiescent = (not did and region.queue_depth == 0
                             and all(t.req.is_terminal for t in tracked))
                if i >= len(events) and quiescent:
                    break
                if not did and i < len(events) and events[i].t > clock.now():
                    clock.advance(events[i].t - clock.now())
                if n_ticks > schedule.horizon + LIVENESS_SLACK_TICKS:
                    stuck = [t.ix for t in tracked if not t.req.is_terminal]
                    violations.append(
                        f"[liveness] region simulation did not quiesce "
                        f"within {n_ticks} ticks; live requests: {stuck}")
                    break
            clock.pump = region.step
            region.close(timeout=30.0)
            clock.pump = None
            violations.extend(auditor.audit(tracked))
            violations.extend(auditor.final(tracked, engines))
            trace.finish(tracked)
            if violations:
                tracer.flight.note("invariant_audit_failed",
                                   n_violations=len(violations))
                tracer.flight.dump("invariant-audit")
        finally:
            install_fault_injector(None)
            set_telemetry(prev_telemetry
                          if prev_telemetry is not None
                          and prev_telemetry.enabled else None)
            set_registry(prev_registry)
    states = [t.req.state for t in tracked]
    return SimReport(
        seed=schedule.seed, trace_hash=trace.hash(),
        violations=violations, n_ticks=n_ticks, n_events=len(schedule.events),
        submitted=len(tracked),
        finished=sum(s is RequestState.FINISHED for s in states),
        cancelled=sum(s is RequestState.CANCELLED for s in states),
        rejected=sum(s is RequestState.REJECTED for s in states),
        tokens={t.ix: list(t.req.tokens) for t in tracked},
        states={t.ix: t.req.state.value for t in tracked},
        span_hash=tracer.canonical_hash(), n_spans=len(tracer.spans()),
        spans=([s.to_dict() for s in tracer.spans()]
               if violations else None),
        brownout_log=list(region.brownout_log),
        ttfts={t.ix: round(t.req.t_first_token - t.req.t_submit, 6)
               for t in tracked
               if t.req.t_first_token is not None
               and t.req.t_submit is not None},
        gray={c.name: c.fleet.gray_snapshot() for c in region.cells})


def _apply_region_event(region, ev: SimEvent, tracked: List[_Tracked],
                        guard, injector: _ScheduledFaultInjector,
                        clock: SimClock) -> None:
    p = ev.payload
    if ev.kind == "submit":
        entry = _Tracked(ix=int(p["ix"]), req=None)
        entry.req = region.submit(
            list(p["prompt"]), max_new_tokens=int(p["max_new"]),
            priority=int(p.get("priority", 0)),
            deadline_s=p.get("deadline"),
            ttft_deadline_s=p.get("ttft_deadline"),
            eos_token_id=p.get("eos"),
            tenant=p.get("tenant"),
            on_token=entry.delivered.append)
        tracked.append(entry)
    elif ev.kind == "cancel":
        target = int(p["target"])
        for t in tracked:
            if t.ix == target and not t.req.is_terminal:
                region.cancel(t.req)
                break
    elif ev.kind == "tick_fault":
        injector.arm(int(p.get("n", 1)))
    elif ev.kind == "replica_death":
        cells = sorted((c for c in region.live_cells),
                       key=lambda c: c.name)
        if cells:
            cell = cells[int(p.get("cell", 0)) % len(cells)]
            healthy = sorted(r.name for r in cell.fleet.healthy_replicas)
            if healthy:
                name = healthy[int(p.get("which", 0)) % len(healthy)]
                cell.fleet.kill_replica(name, reason="dst: scheduled death")
    elif ev.kind == "cell_outage":
        cells = sorted(c.name for c in region.live_cells)
        if cells:
            region.kill_cell(cells[int(p.get("which", 0)) % len(cells)],
                             reason="dst: scheduled cell outage")
    elif ev.kind == "partition":
        names = sorted(c.name for c in region.cells)
        far = {names[int(ix) % len(names)] for ix in p.get("far", [])}
        near = set(names) - far
        if p.get("sever_region", True):
            near.add(region.name)
        if far and near:
            injector.sever(sorted(near), sorted(far))
    elif ev.kind == "heal":
        injector.heal_partitions()
    elif ev.kind == "autoscaler_lag":
        injector.set_autoscaler_lag(float(p.get("dt", 5.0)))
    elif ev.kind == "latch":
        guard.should_stop = True
    elif ev.kind == "scale":
        cells = sorted((c for c in region.live_cells),
                       key=lambda c: c.name)
        if cells:
            cell = cells[int(p.get("cell", 0)) % len(cells)]
            cell.fleet.scale_to(int(p["n"]))
    elif ev.kind == "stall":
        clock.advance(float(p.get("dt", 1.0)))
    elif ev.kind == "rollout":
        # start() refuses mid-rollout / non-advancing versions itself —
        # a schedule may legally draw a rollout that lands as a no-op
        region.start_rollout(int(p["version"]), fraction=p.get("fraction"))
    elif ev.kind == "migrate":
        cells = sorted((c for c in region.live_cells),
                       key=lambda c: c.name)
        if cells:
            cell = cells[int(p.get("cell", 0)) % len(cells)]
            healthy = sorted(r.name for r in cell.fleet.healthy_replicas)
            if healthy:
                name = healthy[int(p.get("replica", 0)) % len(healthy)]
                region.migrate_replica(cell.name, name,
                                       reason="dst: scheduled migration")
    elif ev.kind == "canary_regress":
        # injected canary SLO regression: the new version stalls every
        # other busy tick from here on — the observe window must catch
        # the ratio gap and the controller must roll back
        ro = region.rollout
        target = ro.target_version
        if ro.active and target is not None:
            injector.degrade_model_version(int(target))
    elif ev.kind == "corrupt_swap":
        injector.arm_corrupt_swap(int(p.get("n", 1)))
    elif ev.kind == "flip_death":
        injector.arm_flip_death(int(p.get("ordinal", 1)))
    elif ev.kind in ("degraded_tick", "stall_burst"):
        cells = sorted((c for c in region.live_cells),
                       key=lambda c: c.name)
        if cells:
            cell = cells[int(p.get("cell", 0)) % len(cells)]
            healthy = sorted(r.name for r in cell.fleet.healthy_replicas)
            if healthy:
                name = healthy[int(p.get("which", 0)) % len(healthy)]
                if ev.kind == "degraded_tick":
                    injector.degrade_replica(name, int(p.get("k", 2)))
                else:
                    injector.arm_stall_burst(name, int(p.get("n", 1)))
    elif ev.kind == "flaky_import":
        injector.flaky_import_every = int(p.get("every", 0))
    elif ev.kind == "stale_directory":
        injector.stale_directory_every = int(p.get("every", 0))
    elif ev.kind == "corrupt_adopt":
        injector.corrupt_adopt_every = int(p.get("every", 0))
    elif ev.kind == "cold_pressure":
        injector.cold_pressure_every = int(p.get("every", 0))
    else:
        raise ValueError(f"unknown region simulation event '{ev.kind}'")


# ----------------------------------------------------------------------
# shrinking + regression artifacts
# ----------------------------------------------------------------------

def spec_identity_problems(rep_on: "SimReport",
                           rep_off: "SimReport") -> List[str]:
    """Token-identity comparison of one schedule run spec-on vs spec-off
    (the gate a soak and the regression seeds share): every
    request's two streams must agree on their common prefix (speculation
    may move WHEN a timing-dependent cancel/fault/deadline lands, never
    WHICH tokens precede it), and a request FINISHED in both runs must
    emit the exact same stream."""
    problems: List[str] = []
    for ix in sorted(set(rep_on.tokens) | set(rep_off.tokens)):
        a = rep_on.tokens.get(ix, [])
        b = rep_off.tokens.get(ix, [])
        n = min(len(a), len(b))
        if a[:n] != b[:n]:
            problems.append(f"r{ix}: spec-on prefix {a[:n]} != spec-off "
                            f"{b[:n]}")
        elif (rep_on.states.get(ix) == "finished"
                and rep_off.states.get(ix) == "finished" and a != b):
            problems.append(f"r{ix}: finished in both runs but spec-on "
                            f"emitted {a} vs spec-off {b}")
    return problems


def shrink_schedule(schedule: Schedule,
                    fails: Optional[Callable[[Schedule], bool]] = None,
                    max_runs: int = 500) -> Schedule:
    """Delta-debug a failing schedule to a minimal reproduction (ddmin
    over the event list; configs are kept — they are part of the seed's
    identity). ``fails(schedule) -> bool`` defaults to "run_schedule
    reports violations". The result still fails, and is 1-minimal up to
    the run budget: removing any single remaining event makes it pass."""
    if fails is None:
        def fails(s: Schedule) -> bool:
            runner = (run_region_schedule if isinstance(s, RegionSchedule)
                      else run_schedule)
            return bool(runner(s).violations)

    events = list(schedule.events)
    if not fails(schedule.replace_events(events)):
        raise ValueError("shrink_schedule needs a failing schedule")
    runs = 0
    n = 2
    while len(events) >= 2 and runs < max_runs:
        chunk = max(1, len(events) // n)
        reduced = False
        for start in range(0, len(events), chunk):
            candidate = events[:start] + events[start + chunk:]
            if not candidate:
                continue
            runs += 1
            if fails(schedule.replace_events(candidate)):
                events = candidate
                n = max(2, n - 1)
                reduced = True
                break
            if runs >= max_runs:
                break
        if not reduced:
            if chunk == 1:
                break
            n = min(len(events), n * 2)
    # final 1-minimality pass: try dropping each remaining event once
    i = 0
    while i < len(events) and runs < max_runs and len(events) > 1:
        candidate = events[:i] + events[i + 1:]
        runs += 1
        if fails(schedule.replace_events(candidate)):
            events = candidate
        else:
            i += 1
    logger.info(f"dst: shrank schedule from {len(schedule.events)} to "
                f"{len(events)} events in {runs} runs")
    return schedule.replace_events(events)


def dump_repro(schedule: Schedule, violations: List[str],
               path: str,
               timeline: Optional[List[Dict[str, Any]]] = None) -> str:
    """Write a failing (ideally shrunk) schedule as a JSON regression
    artifact; ``load_repro`` + ``run_schedule`` replays it exactly.
    ``timeline`` (``SimReport.spans``) attaches the failing run's span
    timeline, so the repro says not just *what* broke but *when/where*
    along each request's life."""
    payload: Dict[str, Any] = {"version": 1, "violations": violations,
                               "schedule": schedule.to_dict()}
    if timeline is not None:
        payload["timeline"] = timeline
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return path


def load_repro(path: str) -> Tuple[Schedule, List[str]]:
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    sched = data["schedule"]
    cls = RegionSchedule if "region_cfg" in sched else Schedule
    return (cls.from_dict(sched), list(data.get("violations", [])))
