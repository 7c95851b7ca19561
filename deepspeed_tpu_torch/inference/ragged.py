"""Ragged / continuous-batching inference with a paged KV cache.

Ports ``deepspeed_tpu/inference/ragged.py`` (FastGen v2 parity: ``put`` /
``query`` / ``can_schedule`` / ``flush``, a refcounted block allocator, an
optional prefix cache, Dynamic SplitFuse packing). Each ``put`` packs all
pending decodes plus as many prompt tokens as fit the token budget into
one ragged step, then runs the decoder layer by layer: RMSNorm → QKV →
RoPE → scatter the step's K/V into the paged pool → paged attention (the
hand-written Hopper kernel, :mod:`deepspeed_tpu_torch.ops.paged_attention`)
→ o-proj → RMSNorm → gated-SiLU MLP. The head runs only on each
sequence's last token. The other matrix products stay ``torch.matmul``.

Quantized pools (``kv_quant`` ``"int8"`` / ``"int4"``): each K/V
head-vector is quantized on its way into the pool
(:func:`~deepspeed_tpu_torch.ops.quantizer.quantize_kv`, one fp32 scale
per head-vector), payload and scale scattered together, and the
paged-attention kernel dequantizes in its read. At a fixed pool byte
budget (:func:`kv_blocks_for_bytes`) an int8 pool holds about twice, an
int4 pool about four times the pages of a bf16 one.

PyTorch runs eagerly, so the step is not compiled; the JAX package's
static shapes are kept all the same — the step width is rounded up to a
token bucket and the page walk to a power of two — because they fix the
shapes the kernel sees. The multi-step decode is a Python loop over the
same core (``lax.scan`` in the JAX package).

In place where JAX donated buffers: the KV pool is updated in place by
every step, and the engine casts and moves the model's weights in place
to the engine's dtype and device.

Not in this slice (later slices, ROADMAP.md): tensor parallelism,
speculative ``put_spec`` / drafts, ``export_kv`` / ``import_kv`` (with or
without scales), the global KV tier, ``trim``, and sampling with
temperature > 0.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.norms import rms_norm
from ..ops.paged_attention import paged_attention, plan_paged_work
from ..ops.quantizer import quantize_kv, quantized_nbytes
from ..ops.ragged_host import build_batch, fill_tables
from ..ops.rotary import apply_rotary, rope_frequencies
from ..utils.device import resolve_device
from ..utils.logging import log_dist


class PoolExhausted(RuntimeError):
    """The KV page pool cannot satisfy a schedule's block demand — the
    RECOVERABLE condition the serving driver answers by preempting a
    decode and retrying (distinct from a device error)."""


class BlockedAllocator:
    """Refcounted free-list allocator over ``n_blocks`` KV pages: a page
    returns to the free list only when every holder — sequences and the
    prefix cache — has released it."""

    def __init__(self, n_blocks: int):
        self.n_blocks = n_blocks
        self._free: List[int] = list(range(n_blocks))
        self._ref: Dict[int, int] = {}

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def allocate(self, n: int) -> List[int]:
        if n > len(self._free):
            raise PoolExhausted(
                f"KV pool exhausted: need {n}, have {len(self._free)}")
        out, self._free = self._free[:n], self._free[n:]
        for b in out:
            self._ref[b] = 1
        return out

    def retain(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            self._ref[int(b)] += 1

    def release(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            b = int(b)
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                self._free.append(b)

    def refcount(self, block: int) -> int:
        return self._ref.get(int(block), 0)

    # historical name: a release, not an unconditional free
    free = release


class PrefixCache:
    """LRU cache of computed KV pages keyed by full-block token prefixes.

    When a sequence is flushed, its full KV blocks are published under the
    token prefix they encode; a new prompt sharing that prefix adopts the
    pages (refcounted via :class:`BlockedAllocator`) and skips their
    prefill. Sharing covers FULL blocks only and is capped at
    ``len(prompt) - 1`` tokens, so the engine's scatters only write
    positions at or after the shared region's end."""

    def __init__(self, block_size: int):
        self.block_size = block_size
        # prefix tuple -> block ids (one cache retain each), oldest first
        self._entries: "collections.OrderedDict[Tuple[int, ...], List[int]]" \
            = collections.OrderedDict()
        # per-block count of CACHE references (across nested entries)
        self._block_refs: Dict[int, int] = {}
        self.hits = 0
        self.misses = 0

    def match(self, prompt: Sequence[int]) -> Tuple[int, List[int]]:
        """Longest cached full-block prefix of ``prompt``, capped so at
        least one prompt token remains to prefill. Returns
        (shared_token_count, blocks) — blocks are NOT yet retained."""
        bs = self.block_size
        for k in range((len(prompt) - 1) // bs, 0, -1):
            key = tuple(int(t) for t in prompt[: k * bs])
            ent = self._entries.get(key)
            if ent is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return k * bs, ent
        self.misses += 1
        return 0, []

    def _hold(self, key, blocks, allocator: BlockedAllocator) -> None:
        allocator.retain(blocks)
        for b in blocks:
            self._block_refs[b] = self._block_refs.get(b, 0) + 1
        self._entries[key] = blocks

    def publish(self, tokens: Sequence[int], blocks: Sequence[int], seen: int,
                allocator: BlockedAllocator) -> None:
        """Offer a flushed sequence's full blocks to the cache (the cache
        retains them; the sequence's own refs are released separately)."""
        bs = self.block_size
        k = min(seen, len(tokens)) // bs
        if k <= 0:
            return
        key = tuple(int(t) for t in tokens[: k * bs])
        if key in self._entries:
            self._entries.move_to_end(key)
            return
        held = [int(b) for b in blocks[:k]]
        self._hold(key, held, allocator)
        # keys are exact tuples: every nested full-block level gets its
        # own entry (same pages, one retain per level)
        for kk in range(k - 1, 0, -1):
            kkey = key[: kk * bs]
            if kkey in self._entries:
                break
            self._hold(kkey, held[:kk], allocator)

    def _evict_one(self, allocator: BlockedAllocator) -> None:
        _, blocks = self._entries.popitem(last=False)   # LRU
        allocator.release(blocks)
        for b in blocks:
            self._block_refs[b] -= 1
            if self._block_refs[b] == 0:
                del self._block_refs[b]

    def evict_for(self, allocator: BlockedAllocator, need: int) -> None:
        """LRU-evict entries until ``need`` blocks are free (or empty)."""
        while allocator.free_blocks < need and self._entries:
            self._evict_one(allocator)

    def reclaimable_blocks(self, allocator: BlockedAllocator) -> int:
        """Distinct pages that would return to the free list if the whole
        cache dropped: pages whose every reference is the cache's own."""
        return sum(1 for b, n in self._block_refs.items()
                   if allocator.refcount(b) == n)


def block_balance_report(engine) -> Dict[str, Any]:
    """Audit the engine's KV-page accounting: every page must be exactly
    one of free / sequence-held / cache-held, and the allocator's
    refcount for each held page must equal its number of holders.
    Returns ``{"free", "held", "problems"}``; empty ``problems`` means zero
    leaks. Host-side only."""
    alloc = engine.allocator
    free = set(alloc._free)
    held = set(alloc._ref)
    problems: List[str] = []
    if len(free) != len(alloc._free):
        problems.append("duplicate pages in the free list")
    overlap = free & held
    if overlap:
        problems.append(f"pages both free and referenced: "
                        f"{sorted(overlap)[:8]}")
    vanished = set(range(alloc.n_blocks)) - free - held
    if vanished:
        problems.append(f"pages leaked (not free, not referenced): "
                        f"{sorted(vanished)[:8]}")
    expected: Dict[int, int] = {}
    for seq in engine.seqs.values():
        for b in seq.blocks:
            expected[int(b)] = expected.get(int(b), 0) + 1
    if engine.prefix_cache is not None:
        for b, n in engine.prefix_cache._block_refs.items():
            expected[int(b)] = expected.get(int(b), 0) + n
    for b in sorted(held | set(expected)):
        have, want = alloc._ref.get(b, 0), expected.get(b, 0)
        if have != want:
            problems.append(f"page {b}: allocator refcount {have} != "
                            f"{want} holders")
    return {"free": len(free), "held": len(held), "problems": problems}


def assert_block_balance(engine, expect_free: Optional[int] = None) -> None:
    """Raise AssertionError on any block-accounting imbalance (and, when
    given, on ``free != expect_free``)."""
    rep = block_balance_report(engine)
    if rep["problems"]:
        raise AssertionError("KV block balance violated: "
                             + "; ".join(rep["problems"]))
    if expect_free is not None and rep["free"] != expect_free:
        raise AssertionError(
            f"KV free-page count {rep['free']} != expected {expect_free} "
            f"({rep['held']} pages still referenced)")


_KV_BITS = {"none": 0, "int8": 8, "int4": 4}


def kv_page_bytes(model_config, ragged_config) -> int:
    """Bytes one KV page (K + V, all layers) takes in the pool under
    ``ragged_config.kv_quant``: the payload plus, when quantized, one fp32
    scale per head-vector."""
    c, cfg = model_config, ragged_config
    rows = c.n_layers * c.n_kv_heads * cfg.kv_block_size      # per K or V
    bits = _KV_BITS[cfg.kv_quant]
    if bits == 0:
        itemsize = torch.empty((), dtype=cfg.dtype).element_size()
        return 2 * rows * c.head_dim * itemsize
    return 2 * quantized_nbytes(rows * c.head_dim, bits, c.head_dim)


def kv_blocks_for_bytes(budget_bytes: int, model_config,
                        ragged_config) -> int:
    """Pages a ``budget_bytes`` KV pool holds under the config's
    ``kv_quant`` mode (at least 1)."""
    return max(1, int(budget_bytes)
               // kv_page_bytes(model_config, ragged_config))


@dataclass
class SequenceDescriptor:
    """uid, slot, tokens seen/scheduled, owned KV blocks."""

    uid: int
    slot: int
    tokens: List[int] = field(default_factory=list)  # full known token stream
    seen: int = 0                                    # tokens already in KV
    blocks: List[int] = field(default_factory=list)

    @property
    def pending(self) -> int:
        return len(self.tokens) - self.seen


@dataclass
class RaggedConfig:
    """Knobs mirroring FastGen's DSStateManagerConfig + RaggedBatchConfig:
    max_ragged_batch_size = token_budget, max_tracked_sequences =
    max_seqs, the pool's block count and size."""

    token_budget: int = 256
    max_seqs: int = 8
    kv_block_size: int = 16
    n_kv_blocks: int = 256
    max_context: int = 2048
    dtype: torch.dtype = torch.bfloat16
    # sampling: only greedy (0.0) in this slice; top-k / top-p come with
    # temperature sampling
    temperature: float = 0.0
    # automatic prefix caching: completed sequences publish their full KV
    # blocks into an LRU cache keyed by the token prefix; new prompts
    # sharing a full-block prefix skip its prefill
    enable_prefix_cache: bool = False
    # quantized KV storage ("none" | "int8" | "int4"): pages hold int8
    # payloads or int4 nibbles with one fp32 scale per K/V head-vector
    kv_quant: str = "none"


class RaggedInferenceEngine:
    """Continuous-batching engine over a
    :class:`~deepspeed_tpu_torch.models.transformer.Transformer`.

    ``put(uids, tokens)`` runs ONE ragged step mixing prefill chunks and
    decodes (Dynamic SplitFuse) and returns next-token logits per uid
    (NaN rows for uids whose prompt is still being prefilled across
    steps). ``generate`` drives put/decode_steps/flush to completion.
    ``device`` defaults to ``"cuda"``; without a CUDA device it raises
    unless ``device="cpu"`` is asked for. The model's weights are cast
    and moved in place to ``config.dtype`` on ``device``.
    """

    def __init__(self, model, config: Optional[RaggedConfig] = None,
                 device=None):
        self.config = cfg = config or RaggedConfig()
        self.device = resolve_device(device)
        self.model = model
        c = model.config
        if cfg.max_context > c.max_seq_len:
            raise ValueError(
                f"max_context {cfg.max_context} exceeds model "
                f"max_seq_len {c.max_seq_len} (RoPE/position table bound)")
        if cfg.max_context % cfg.kv_block_size != 0:
            raise ValueError(
                f"max_context {cfg.max_context} must be a multiple of "
                f"kv_block_size {cfg.kv_block_size}")
        if cfg.kv_quant not in _KV_BITS:
            raise ValueError(
                f"kv_quant must be 'none', 'int8' or 'int4', got "
                f"'{cfg.kv_quant}'")
        self._kv_bits = _KV_BITS[cfg.kv_quant]
        if self._kv_bits == 4 and c.head_dim % 2:
            raise ValueError(
                f"kv_quant='int4' packs two channels per byte and needs an "
                f"even head_dim, got {c.head_dim}")
        if cfg.temperature != 0.0:
            raise NotImplementedError(
                "sampling with temperature > 0 comes in a later slice; "
                "this slice decodes greedily (temperature=0.0)")
        if c.window_binds(cfg.max_context):
            log_dist("RaggedInferenceEngine: binding sliding window — "
                     "banded paged attention")
        model.to(device=self.device, dtype=cfg.dtype)
        self.allocator = BlockedAllocator(cfg.n_kv_blocks)
        self.prefix_cache = (PrefixCache(cfg.kv_block_size)
                             if cfg.enable_prefix_cache else None)
        self.seqs: Dict[int, SequenceDescriptor] = {}
        self._free_slots = list(range(cfg.max_seqs))
        # uids whose next admission is a RESUME (post-preempt/discard); the
        # request telemetry of a later slice skips their TTFT/latency
        # records, and the server clears markers of uids that went terminal
        self._resume_uids: set = set()
        self.max_pages = cfg.max_context // cfg.kv_block_size
        # paged KV pool: per-layer [n_blocks + 1, hkv, block, hd] tensors;
        # the last page is the sink that padding lanes scatter into, so an
        # inactive lane never aliases a live page. Quantized pools hold
        # int8 [.., hd] or nibble-packed uint8 [.., hd // 2] payloads, plus
        # (k scales, v scales) [n_blocks + 1, hkv, block] fp32 leaves; all
        # start at zero, so an unwritten page dequantizes to zeros
        pages = (cfg.n_kv_blocks + 1, c.n_kv_heads, cfg.kv_block_size)
        shape, dtype = {
            0: (pages + (c.head_dim,), cfg.dtype),
            8: (pages + (c.head_dim,), torch.int8),
            4: (pages + (c.head_dim // 2,), torch.uint8)}[self._kv_bits]
        n_leaves = 4 if self._kv_bits else 2
        self.kv_pool = tuple(
            tuple(torch.zeros(pages if i >= 2 else shape,
                              dtype=torch.float32 if i >= 2 else dtype,
                              device=self.device)
                  for _ in range(c.n_layers)) for i in range(n_leaves))
        self._angles = rope_frequencies(c.rotary_dim, c.max_seq_len,
                                        c.rope_theta, device=self.device)
        # per-layer sliding windows (0 = global causal)
        aw = c.attn_windows
        self._windows = tuple(int(w) if 0 < int(w) < cfg.max_context else 0
                              for w in aw) if aw is not None \
            else (0,) * c.n_layers
        # ragged-step token buckets (ascending, capped by the budget): a
        # decode-heavy step runs at the smallest fitting width
        self._buckets = [b for b in (64, 256, 1024) if b < cfg.token_budget] \
            + [cfg.token_budget]
        log_dist(f"RaggedInferenceEngine: budget={cfg.token_budget} "
                 f"blocks={cfg.n_kv_blocks}x{cfg.kv_block_size} "
                 f"device={self.device}")

    # -- scheduling API (parity engine_v2.query/can_schedule) -----------
    def query(self, uid: int) -> Tuple[int, int]:
        """(max new tokens schedulable for uid now, free kv blocks),
        accounting for the uid's remaining context window and the blocks
        it could still claim."""
        seen = self.seqs[uid].seen if uid in self.seqs else 0
        owned = len(self.seqs[uid].blocks) if uid in self.seqs else 0
        ctx_room = self.config.max_context - seen
        slack_in_blocks = owned * self.config.kv_block_size - seen
        avail = self._available_blocks()
        kv_room = slack_in_blocks + avail * self.config.kv_block_size
        return (max(0, min(self.config.token_budget, ctx_room, kv_room)),
                avail)

    def _available_blocks(self) -> int:
        """Free pages plus cache-only-held pages (evicted on demand)."""
        free = self.allocator.free_blocks
        if self.prefix_cache is not None:
            free += self.prefix_cache.reclaimable_blocks(self.allocator)
        return free

    def blocks_needed(self, n_tokens: int) -> int:
        """KV pages a fresh sequence of ``n_tokens`` is charged at
        admission (its pages at full length, +1 write scratch) — the one
        formula the serving layer's admission and over-pool reject use."""
        return -(-int(n_tokens) // self.config.kv_block_size) + 1

    def can_schedule(self, uids: Sequence[int], lengths: Sequence[int]) -> bool:
        """Whether prompts of the given lengths fit (slots + kv blocks)."""
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

    def flush(self, uids: Sequence[int]) -> None:
        """Release sequence state + KV blocks. With the prefix cache on,
        the sequence's full KV blocks are published first."""
        for uid in uids:
            seq = self.seqs.pop(uid, None)
            if seq is not None:
                if self.prefix_cache is not None:
                    self.prefix_cache.publish(seq.tokens, seq.blocks,
                                              seq.seen, self.allocator)
                self.allocator.free(seq.blocks)
                self._free_slots.append(seq.slot)

    def preempt(self, uid: int) -> List[int]:
        """Release ``uid``'s slot + KV blocks without retiring it (the
        serving layer's eviction hook). Full KV blocks are published into
        the prefix cache first (when enabled). Returns the KV-backed token
        stream."""
        seq = self.seqs.get(uid)
        if seq is None:
            return []
        toks = list(seq.tokens[:seq.seen])
        self.flush([uid])
        self._resume_uids.add(uid)
        return toks

    def discard(self, uid: int) -> None:
        """Drop ``uid``, releasing its blocks + slot while publishing
        NOTHING into the prefix cache — the recovery hook for a failed
        step whose KV integrity is unknown."""
        seq = self.seqs.pop(uid, None)
        if seq is None:
            return
        self.allocator.free(seq.blocks)
        self._free_slots.append(seq.slot)
        self._resume_uids.add(uid)

    def clear_resume(self, uid: int) -> None:
        """Forget a ``preempt()``/``discard()`` resume marker for a uid
        that will never be re-admitted."""
        self._resume_uids.discard(uid)

    def kv_occupancy(self) -> float:
        """Fraction of the paged KV pool held by live sequences or the
        prefix cache (1.0 = exhausted)."""
        return 1.0 - self.allocator.free_blocks / self.allocator.n_blocks

    # -- step ------------------------------------------------------------
    def _admit_tokens(self, uids: Sequence[int],
                      tokens: Sequence[Sequence[int]]) -> None:
        """Fresh uids get a slot (and adopt the longest cached full-block
        prefix); existing ones append their chunk."""
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
            if new and self.prefix_cache is not None and seq.tokens:
                shared, blocks = self.prefix_cache.match(seq.tokens)
                if shared:
                    self.allocator.retain(blocks)
                    seq.blocks = list(blocks)
                    seq.seen = shared

    def _pack_splitfuse(self) -> List[Tuple[SequenceDescriptor, int]]:
        """Dynamic SplitFuse packing: decodes (and short prompt tails)
        first, then the longest-pending prefill fills the leftover
        budget."""
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

    @torch.inference_mode()
    def put(self, uids: Sequence[int],
            tokens: Sequence[Sequence[int]]) -> np.ndarray:
        """Admit new tokens for ``uids`` and run one ragged step.

        Returns [len(uids), vocab] fp32 logits of each sequence's latest
        processed token; rows are NaN while a long prompt is still
        mid-prefill (call put(uid, []) again to continue it)."""
        cfg = self.config
        self._admit_tokens(uids, tokens)
        sched = self._pack_splitfuse()
        if not sched:
            raise ValueError("put() called with no pending tokens")
        # validate + allocate for the WHOLE schedule before mutating any
        # sequence state (seen never advances without its KV written)
        needs = self._validate_sched(sched)
        flat_tokens, flat_slot, flat_pos, last_idx = \
            self._allocate_and_build(sched, needs)
        last_index = {}
        for (seq, take), li in zip(sched, last_idx):
            seq.seen += take
            last_index[seq.uid] = int(li)
        # per-slot index of the row whose logits we need (sequences not in
        # this schedule keep a harmless 0 — their rows are never read)
        sel_idx = np.zeros((cfg.max_seqs,), np.int64)
        for uid, idx in last_index.items():
            sel_idx[self.seqs[uid].slot] = idx
        live_pages = self._live_pages_bucket()
        x = self._core(self._dev(flat_tokens), self._dev(flat_slot),
                       self._dev(flat_pos), self._dev(self._host_tables()),
                       live_pages, self._paged_work(flat_slot, live_pages))
        # head only on each sequence's selected (last) token; only the
        # [max_seqs, vocab] rows travel to the host
        logits = self.model._head(x[self._dev(sel_idx)]).cpu().numpy()
        out = np.full((len(uids), logits.shape[-1]), np.nan, np.float32)
        for i, uid in enumerate(uids):
            seq = self.seqs[uid]
            if seq.pending == 0 and uid in last_index:
                out[i] = logits[seq.slot]
        return out

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _validate_sched(self, sched) -> List[int]:
        """Validate a (seq, take) schedule WITHOUT mutating anything:
        context bound, pool demand (evicting cached prefixes if needed),
        batch-width fit. Returns per-entry new-block needs."""
        cfg = self.config
        needs = []
        for seq, take in sched:
            new_total = seq.seen + take
            if new_total > cfg.max_context:
                raise ValueError(
                    f"uid {seq.uid}: context {new_total} exceeds "
                    f"max_context {cfg.max_context}")
            needs.append(-(-new_total // cfg.kv_block_size) - len(seq.blocks))
        self._check_pool(needs)
        scheduled = sum(take for _, take in sched)
        if scheduled > cfg.token_budget:
            raise ValueError(f"scheduled tokens {scheduled} exceed "
                             f"token_budget {cfg.token_budget}")
        return needs

    def _allocate_and_build(self, sched, needs):
        """Grant blocks and build the flat step batch. T rounds the
        scheduled token count up to a bucket, not the full budget."""
        scheduled = sum(take for _, take in sched)
        T = next(b for b in self._buckets if b >= scheduled)
        chunks, seens_l, slots_l = [], [], []
        for (seq, take), need in zip(sched, needs):
            if need > 0:
                seq.blocks.extend(self.allocator.allocate(need))
            chunks.append(seq.tokens[seq.seen:seq.seen + take])
            seens_l.append(seq.seen)
            slots_l.append(seq.slot)
        return build_batch(chunks, seens_l, slots_l, T)

    def _check_pool(self, needs) -> None:
        """The whole schedule's new-block demand must fit the pool before
        ANY uid is granted blocks; cache-held pages are evicted LRU first."""
        short = sum(n for n in needs if n > 0)
        if short > self.allocator.free_blocks and self.prefix_cache is not None:
            self.prefix_cache.evict_for(self.allocator, short)
        if short > self.allocator.free_blocks:
            raise PoolExhausted(
                f"KV pool exhausted: need {short} blocks, have "
                f"{self.allocator.free_blocks}; flush() finished "
                "sequences first")

    def _host_tables(self) -> np.ndarray:
        live = list(self.seqs.values())
        return fill_tables([s.blocks for s in live], [s.slot for s in live],
                           self.config.max_seqs, self.max_pages)

    def _paged_work(self, flat_slot: np.ndarray, live_pages: int):
        """The paged-attention work list of one step, planned once on the
        host from the slots the kernels read (padding lanes' -1 clamped to
        0, as ``_core`` does; the padding lanes themselves marked, so they
        neither join a tile nor thin the decode lanes' splits) and shared
        by every layer; None off the card."""
        if self.device.type != "cuda":
            return None
        return plan_paged_work(
            np.maximum(flat_slot, 0), len(flat_slot),
            min(live_pages, self.max_pages), self.kv_pool[0][0],
            dtype=self.config.dtype, quantized=bool(self._kv_bits),
            pad=flat_slot < 0)

    def _live_pages_bucket(self) -> int:
        """Page-walk bound for this step: smallest power of two >= the
        longest live sequence's page count."""
        most = max((len(s.blocks) for s in self.seqs.values()), default=1)
        b = 1
        while b < most:
            b *= 2
        return min(b, self.max_pages)

    @torch.inference_mode()
    def decode_steps(self, first_tokens: Dict[int, int], k: int,
                     eos_token_id: Optional[int] = None) -> Dict[int, List[int]]:
        """Greedily decode ``k`` tokens for every uid in ``first_tokens``,
        one ragged step per token with the tokens fed back on the device
        (no host round trip inside the chunk).

        ``first_tokens[uid]`` is the next input token (from the previous
        step's logits, not yet admitted). Returns uid -> the k tokens
        generated after it; the last one is returned un-processed — feed
        it as the next call's first token. Every uid must be fully
        prefilled. With ``eos_token_id``, a lane that emits EOS stops
        feeding (its scatters go to the sink page) and emits EOS fillers."""
        cfg = self.config
        if k < 1:
            raise ValueError(f"decode_steps needs k >= 1, got {k}")
        needs = []
        for uid in first_tokens:
            seq = self.seqs[uid]
            if seq.pending:
                raise ValueError(f"uid {uid} still has pending prefill")
            total = seq.seen + k
            if total > cfg.max_context:
                raise ValueError(
                    f"uid {uid}: decode chunk to {total} exceeds "
                    f"max_context {cfg.max_context}")
            needs.append(-(-total // cfg.kv_block_size) - len(seq.blocks))
        self._check_pool(needs)
        for uid, need in zip(first_tokens, needs):
            if need > 0:
                self.seqs[uid].blocks.extend(self.allocator.allocate(need))

        S = cfg.max_seqs
        toks = np.zeros((S,), np.int32)
        pos = np.zeros((S,), np.int32)
        slots = np.full((S,), -1, np.int32)
        for uid, first in first_tokens.items():
            seq = self.seqs[uid]
            toks[seq.slot] = first
            pos[seq.slot] = seq.seen
            slots[seq.slot] = seq.slot
        eos = -1 if eos_token_id is None else int(eos_token_id)
        toks_t, pos_t, slots_t = self._dev(toks), self._dev(pos), \
            self._dev(slots)
        tables = self._dev(self._host_tables())
        live_pages = self._live_pages_bucket()
        # one decode lane per sequence, each on its own slot: lane items
        # only (no run of one slot makes a tile), so a lane whose slot
        # drops to -1 mid-chunk (EOS) never sits inside a tile
        work = self._paged_work(slots, live_pages)
        alive = slots_t >= 0
        if eos >= 0:
            alive = alive & (toks_t != eos)
        gens = []
        for _ in range(k):
            slots_eff = torch.where(alive, slots_t, torch.full_like(slots_t, -1))
            x = self._core(toks_t, slots_eff, pos_t, tables, live_pages,
                           work)
            nxt = torch.argmax(self.model._head(x), dim=-1).to(torch.int32)
            if eos >= 0:
                nxt = torch.where(alive, nxt, torch.full_like(nxt, eos))
                new_alive = alive & (nxt != eos)
            else:
                new_alive = alive
            pos_t = pos_t + alive.to(pos_t.dtype)
            gens.append(nxt)
            toks_t, alive = nxt, new_alive
        gen = torch.stack(gens, dim=1).cpu().numpy()             # [S, k]

        out = {}
        for uid, first in first_tokens.items():
            seq = self.seqs[uid]
            chain = gen[seq.slot].tolist()
            if eos >= 0:
                # only tokens actually FED are context: first==eos feeds
                # nothing; eos at chain[j] means first + chain[:j] were fed
                if first == eos:
                    fed = []
                elif eos in chain:
                    j = chain.index(eos)
                    fed = [first] + chain[:j]
                else:
                    fed = [first] + chain[:-1]
                seq.tokens.extend(fed)
                seq.seen += len(fed)
            else:
                seq.tokens.extend([first] + chain[:-1])
                seq.seen += k
            out[uid] = chain
        return out

    # -- generation convenience -----------------------------------------
    @staticmethod
    def _sample_first(rows) -> List[int]:
        """First decode token(s) from resolved prefill logits (greedy)."""
        return [int(np.argmax(r)) for r in rows]

    def stream(self, uid: int, prompt: Sequence[int], *,
               max_new_tokens: int = 128,
               eos_token_id: Optional[int] = None,
               decode_chunk: int = 8):
        """Incremental generation: yields decoded tokens as chunks
        complete. The uid is flushed when the stream ends — including
        early consumer breaks and mid-prefill failures."""
        logits = self.put([uid], [list(prompt)])
        try:
            while np.isnan(logits[0]).any():
                logits = self.put([uid], [[]])
            tok = self._sample_first([logits[0]])[0]
            produced = 0
            yield tok
            produced += 1
            if eos_token_id is not None and tok == eos_token_id:
                return
            while produced < max_new_tokens:
                room = self.config.max_context - self.seqs[uid].seen
                if room <= 0:
                    return
                k = max(1, min(decode_chunk, max_new_tokens - produced, room))
                chain = self.decode_steps({uid: tok}, k,
                                          eos_token_id=eos_token_id)[uid]
                for t in chain:
                    yield t
                    produced += 1
                    if eos_token_id is not None and t == eos_token_id:
                        return
                tok = chain[-1]
        finally:
            if uid in self.seqs:
                self.flush([uid])

    def generate(self, prompts: Dict[int, Sequence[int]],
                 max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None,
                 decode_chunk: int = 16) -> Dict[int, List[int]]:
        """SplitFuse put() steps until every prompt is prefilled, then
        ``decode_steps`` chunks of up to ``decode_chunk`` tokens. Greedy.
        Returns uid -> generated tokens."""
        done: Dict[int, List[int]] = {u: [] for u in prompts}
        first = self._prefill_first(prompts, done)
        live = {u: t for u, t in first.items()
                if len(done[u]) < max_new_tokens
                and not (eos_token_id is not None and t == eos_token_id)}
        while live:
            budget = min(max_new_tokens - len(done[u]) for u in live)
            room = min(self.config.max_context - self.seqs[u].seen
                       for u in live)
            k = max(1, min(decode_chunk, budget, room))
            gens = self.decode_steps(live, k, eos_token_id=eos_token_id)
            nxt = {}
            for u, chain in gens.items():
                stop = False
                for t in chain:
                    done[u].append(t)
                    if eos_token_id is not None and t == eos_token_id:
                        stop = True
                        break
                if (not stop and len(done[u]) < max_new_tokens
                        and self.seqs[u].seen < self.config.max_context):
                    nxt[u] = chain[-1]
            live = nxt
        for u in done:
            done[u] = done[u][:max_new_tokens]
        self.flush(list(prompts))
        return done

    def _prefill_first(self, prompts: Dict[int, Sequence[int]],
                       done: Dict[int, List[int]]) -> Dict[int, int]:
        """Run SplitFuse prefill to completion for ``prompts``, collecting
        each uid's first decode token as its row resolves (long prompts
        span several put() steps)."""
        uids = list(prompts)
        logits = self.put(uids, [list(p) for p in prompts.values()])
        first: Dict[int, int] = {}
        while True:
            pending, resolved = [], []
            for u, row in zip(uids, logits):
                if np.isnan(row).any():
                    pending.append(u)
                else:
                    resolved.append((u, row))
            if resolved:
                toks_out = self._sample_first([r for _, r in resolved])
                for (u, _), t in zip(resolved, toks_out):
                    first[u] = t
            if not pending:
                break
            uids = pending
            logits = self.put(pending, [[] for _ in pending])
        for u, t in first.items():
            done[u].append(t)
        return first

    # -- the ragged forward ------------------------------------------------
    def _core(self, tokens: torch.Tensor, slots: torch.Tensor,
              positions: torch.Tensor, block_tables: torch.Tensor,
              live_pages: int, work=None) -> torch.Tensor:
        """The shared ragged forward over [T] lanes (int32 tokens, slots
        with -1 on padding lanes, positions) and the per-sequence
        [max_seqs, max_pages] int32 block tables -> hidden states [T, d];
        ``work`` is the step's paged-attention work list (``_paged_work``).
        Updates the KV pool in place: each layer scatters this step's K/V
        into its pages BEFORE the attention kernel reads them (same
        stream), so the tokens of one prefill chunk see each other."""
        model = self.model
        c = model.config
        cfg = self.config
        bs = cfg.kv_block_size
        x = model._embed(tokens)                                   # [T, d]
        active = slots >= 0
        safe_slot = torch.clamp(slots, min=0)
        pos_l = positions.long()
        # page = table[pos // bs], row = pos % bs; padding lanes (and any
        # lane past the context window) scatter into the sink page
        page = block_tables[safe_slot.long(),
                            torch.clamp(pos_l // bs, max=self.max_pages - 1)]
        page = torch.where(active & (positions < cfg.max_context),
                           page.long(), cfg.n_kv_blocks)
        row = pos_l % bs
        rope_pos = positions[:, None]
        for li, blk in enumerate(model.layers):
            kp, vp = self.kv_pool[0][li], self.kv_pool[1][li]
            ks = self.kv_pool[2][li] if self._kv_bits else None
            vs = self.kv_pool[3][li] if self._kv_bits else None
            h = rms_norm(x, blk.attn_norm_w, c.norm_eps)
            q = (h @ blk.wq).reshape(-1, c.n_heads, c.head_dim)
            kk = (h @ blk.wk).reshape(-1, c.n_kv_heads, c.head_dim)
            vv = (h @ blk.wv).reshape(-1, c.n_kv_heads, c.head_dim)
            q = apply_rotary(q[:, None], self._angles, rope_pos,
                             rotary_dim=c.rotary_dim,
                             interleaved=c.rope_interleaved)[:, 0]
            kk = apply_rotary(kk[:, None], self._angles, rope_pos,
                              rotary_dim=c.rotary_dim,
                              interleaved=c.rope_interleaved)[:, 0]
            # pool [pages, hkv, block, hd]; two advanced indices around a
            # slice put the lane dim first: the value is [T, hkv, hd].
            # Quantized pools take the payload and its scale [T, hkv]
            if self._kv_bits:
                kk, sk = quantize_kv(kk, self._kv_bits)
                vv, sv = quantize_kv(vv, self._kv_bits)
                ks[page, :, row] = sk
                vs[page, :, row] = sv
            kp[page, :, row] = kk.to(kp.dtype)
            vp[page, :, row] = vv.to(vp.dtype)
            attn = paged_attention(q.contiguous(), kp, vp, block_tables,
                                   positions, seq_slots=safe_slot,
                                   live_pages=live_pages,
                                   window=self._windows[li], k_scale=ks,
                                   v_scale=vs, kv_bits=self._kv_bits,
                                   work=work)
            attn = attn.to(x.dtype).reshape(-1, c.n_heads * c.head_dim)
            x = x + attn @ blk.wo
            h = rms_norm(x, blk.mlp_norm_w, c.norm_eps)
            x = x + model._mlp(h, blk)
        return x
