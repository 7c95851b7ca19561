"""Ragged / continuous-batching inference with a paged KV cache.

Ports ``deepspeed_tpu/inference/ragged.py`` (FastGen v2 parity: ``put`` /
``query`` / ``can_schedule`` / ``flush``, a refcounted block allocator, an
optional prefix cache, Dynamic SplitFuse packing). Each ``put`` packs all
pending decodes plus as many prompt tokens as fit the token budget into
one ragged step, then runs the decoder layer by layer: the model's norm
(RMSNorm, or LayerNorm with its bias) → QKV (+ biases) → RoPE where the
model has it (learned positions enter with the embedding) → scatter the
step's K/V into the paged pool → paged attention (the hand-written
Hopper kernel, :mod:`deepspeed_tpu_torch.ops.paged_attention`) → o-proj
(+ bias) → norm → the model's MLP. The head runs only on each sequence's
last token. The other matrix products stay ``torch.matmul``. The Llama,
GPT-2 and OPT flag sets run here, and GPT-MoE: the MLP is the model's own
``_mlp``, for an MoE model the no-drop expert route
(:func:`~deepspeed_tpu_torch.parallel.moe.no_drop_moe`, one grouped GEMM
a projection); ALiBi,
parallel residual and attention-scale overrides raise as in the JAX
engine (the v1 engine serves them). Encoders (``causal=False`` or
``prenorm=False``) raise too: the JAX engine takes them and computes
them causally and pre-normed (ROADMAP.md Queue C, C7).

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

Beyond ``put``: sampled decoding (``temperature`` / ``top_k`` / ``top_p``,
drawn on the device from a generator reseeded from ``(seed, step)``, so a
sampled stream does not depend on how ``decode_steps`` chunks it);
``trim`` with copy-on-write of a shared boundary page; prompt-lookup
drafts (:class:`NgramIndex`, ``draft_tokens``) verified by ``put_spec``
(the serving tick's speculative step) and ``generate_speculative``; the
disaggregated hand-off ``export_kv`` / ``import_kv`` (:class:`KVExport`,
quantized payload and scales as pooled); and the global KV tier's seams
``export_prefix`` / ``import_prefix`` (checksummed
:class:`~deepspeed_tpu_torch.serving.kvtier.PrefixExport`), the prefix
cache's eviction hook and the cold-tier re-admission. Every path that
runs the model plans its paged-attention work list with ``_paged_work``.

Telemetry (the global pipeline of :mod:`deepspeed_tpu_torch.telemetry`,
resolved per call): per-request TTFT at the first logits and latency at
``flush``, per-step ``inference/ragged_steps`` / ``scheduled_tokens`` /
occupancy series, the ``record_spec`` mirror and the hand-off counters;
all host dict updates. ``export_prefix`` carries the chaos injector's
wire-corruption hook.

Tensor parallelism (``topology`` with a ``model`` axis above 1, FastGen
v2's TP configuration): one process per rank. Each rank holds its shard
of the model (``Transformer.shard_``: ``n_heads / tp`` heads, ``d_ff /
tp`` of the MLP, ``vocab / tp`` of the embedding and head) and
``n_kv_heads / tp`` heads of every page of the pool (payload and scales
together). Group rank 0 is the controller: it runs everything on the
host, as the JAX package's single controller does (admission,
SplitFuse, the allocator, the prefix cache, preemption, the host
builder), and before each device step it broadcasts one step record
(``core``: the flat lanes, block tables, page walk and selected rows;
``decode``: a ``decode_steps`` chunk; ``copy_page``; ``stop``) to the
other ranks, which replay it on their shard in :meth:`RaggedInferenceEngine.
serve_worker`. Every rank plans the step's paged-attention work list
from the record itself. The head's logit columns are gathered on every
rank, so a decode chunk's greedy or reseeded sampled tokens are the same
on every rank without another message. A step that fails on the
controller (a rank that died or hung, within the process group's
timeout) raises :class:`RankFailure`, and every later step raises it
too: the engine never carries on with fewer ranks. Every flag set the
engine serves and GPT-MoE (each rank ``d_ff / tp`` of every expert) run
sharded. ``put_spec`` and ``generate_speculative`` verify on ``core``
records whose ``sel`` is ``[max_seqs, k_max]``; a rejected tail's
copy-on-write is a ``copy_page`` record. The KV hand-off, prefix export
/ adoption and the KV tier (the prefix cache's eviction hook and the
cold-tier re-admission run inside the controller's admission) move pages
through two more records: ``gather_pages`` (every rank's head slices of
a page list gathered on the controller) and ``write_pages`` (an import's
head slices, payload and scales, scattered to their ranks). Exports keep
the full-head layout, so engines of any model axis hand off to each
other.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import hashlib
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..comm import comm
from ..comm.comm import record_collective
from ..ops.paged_attention import paged_attention, plan_paged_work
from ..ops.quantizer import quantize_kv, quantized_nbytes
from ..ops.ragged_host import build_batch, fill_tables
from ..ops.rotary import apply_rotary, rope_frequencies
from ..serving.kvtier import CorruptExport, PrefixExport, prefix_hash
from ..utils.device import resolve_device
from ..utils.logging import log_dist
from .engine import _sample


class PoolExhausted(RuntimeError):
    """The KV page pool cannot satisfy a schedule's block demand — the
    RECOVERABLE condition the serving driver answers by preempting a
    decode and retrying (distinct from a device error)."""


class RankFailure(RuntimeError):
    """A tensor-parallel step failed on the controller, so the model
    group's ranks are no longer in step: this and every later step of the
    engine raise it."""


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
    positions at or after the shared region's end.

    ``on_evict(key, blocks)``, when set, runs as an entry is evicted and
    before its references drop (its pages are still valid to read): the
    global KV tier's directory-invalidate and cold-spill seam."""

    def __init__(self, block_size: int, on_evict=None):
        self.block_size = block_size
        # prefix tuple -> block ids (one cache retain each), oldest first
        self._entries: "collections.OrderedDict[Tuple[int, ...], List[int]]" \
            = collections.OrderedDict()
        # per-block count of CACHE references (across nested entries)
        self._block_refs: Dict[int, int] = {}
        self.hits = 0
        self.misses = 0
        self.on_evict = on_evict

    def __len__(self) -> int:
        return len(self._entries)

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

    def lookup(self, tokens: Sequence[int]) -> Tuple[Optional[Tuple[int, ...]],
                                                     List[int]]:
        """Longest full-block prefix entry covering ``tokens``, without
        :meth:`match`'s one-token-to-prefill cap (adoption and export want
        whole entries). Refreshes the entry's recency; counts no hit or
        miss. Returns (key, blocks) or (None, [])."""
        bs = self.block_size
        for k in range(len(tokens) // bs, 0, -1):
            key = tuple(int(t) for t in tokens[: k * bs])
            ent = self._entries.get(key)
            if ent is not None:
                self._entries.move_to_end(key)
                return key, ent
        return None, []

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
        key, blocks = self._entries.popitem(last=False)   # LRU
        if self.on_evict is not None:
            # before the release: a cold-spill copy reads the pages while
            # this entry's references still keep them off the free list
            self.on_evict(key, blocks)
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

    def drop_all(self, allocator: BlockedAllocator) -> None:
        while self._entries:
            self._evict_one(allocator)


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


def _dtype_name(dtype: torch.dtype) -> str:
    """The JAX spelling of a floating dtype ("bfloat16", "float32"), so
    the two packages' export geometries compare equal."""
    return str(dtype).replace("torch.", "")


def _prompt_lookup(ctx: Sequence[int], ngram: int, k: int) -> List[int]:
    """Prompt-lookup drafting: if the trailing ``ngram`` of ``ctx``
    occurred earlier, propose the (up to ``k``) tokens that followed its
    most recent earlier occurrence with a full ``k``-token continuation,
    else those of the occurrence with the longest continuation."""
    if k <= 0 or ngram <= 0 or len(ctx) <= ngram:
        return []
    arr = np.asarray(ctx, np.int32)
    pat = arr[-ngram:]
    win = np.lib.stride_tricks.sliding_window_view(arr[:-1], ngram)
    hits = np.nonzero((win == pat).all(axis=1))[0]
    if len(hits) == 0:
        return []
    cont_len = np.minimum(len(arr) - (hits + ngram), k)
    full = np.nonzero(cont_len == k)[0]
    j = int(hits[full[-1]] if len(full) else hits[np.argmax(cont_len)])
    return arr[j + ngram: j + ngram + k].tolist()


class NgramIndex:
    """Incremental n-gram position index over one sequence's token stream:
    the memoized :func:`_prompt_lookup`, proposing exactly what it does in
    O(new tokens) a draft round. Each full window's start is recorded once
    (key -> ascending starts) as the stream grows; a trim of the tail pops
    exactly the invalidated entries off an append-ordered stack."""

    def __init__(self, ngram: int):
        self.ngram = int(ngram)
        self._toks: List[int] = []
        self._pos: Dict[Tuple[int, ...], List[int]] = {}
        self._order: List[Tuple[int, Tuple[int, ...]]] = []  # (start, key)

    def sync(self, tokens: Sequence[int]) -> None:
        """Index the tokens appended since the last call (the indexed
        prefix must be unchanged; a shorter stream truncates first)."""
        n = self.ngram
        if len(tokens) < len(self._toks):
            self.truncate(len(tokens))
        self._toks.extend(int(t) for t in tokens[len(self._toks):])
        start = self._order[-1][0] + 1 if self._order else 0
        for h in range(start, len(self._toks) - n + 1):
            key = tuple(self._toks[h:h + n])
            self._pos.setdefault(key, []).append(h)
            self._order.append((h, key))

    def truncate(self, length: int) -> None:
        """Drop the stream's tail past ``length``: O(removed)."""
        del self._toks[length:]
        n = self.ngram
        while self._order and self._order[-1][0] + n > length:
            _, key = self._order.pop()
            lst = self._pos[key]
            lst.pop()                            # ascending: the last one
            if not lst:
                del self._pos[key]

    def lookup(self, extra: Sequence[int], k: int) -> List[int]:
        """:func:`_prompt_lookup` of ``tokens + extra`` without rescanning
        the indexed tokens."""
        n = self.ngram
        toks = self._toks
        ctx_len = len(toks) + len(extra)
        if k <= 0 or n <= 0 or ctx_len <= n:
            return []

        def at(i: int) -> int:
            return toks[i] if i < len(toks) else int(extra[i - len(toks)])

        pat = tuple(at(ctx_len - n + j) for j in range(n))
        limit = ctx_len - 1 - n          # last admissible window start
        base = self._pos.get(pat, [])
        hi = bisect.bisect_right(base, min(limit, len(toks) - n))
        # windows that overlap ``extra`` are not indexed: check them here
        manual = [h for h in range(max(0, len(toks) - n + 1), limit + 1)
                  if all(at(h + j) == pat[j] for j in range(n))]
        if hi == 0 and not manual:
            return []
        # the most recent start with a full k-token continuation (manual
        # starts all come after indexed ones), else the earliest start
        full_limit = ctx_len - n - k
        j = next((h for h in reversed(manual) if h <= full_limit), None)
        if j is None:
            idx = bisect.bisect_right(base, full_limit, 0, hi)
            if idx:
                j = base[idx - 1]
        if j is None:
            j = base[0] if hi else manual[0]
        return [at(i) for i in range(j + n, min(j + n + k, ctx_len))]


@dataclass
class KVExport:
    """Host snapshot of one sequence's KV state: the unit of the
    disaggregated prefill -> decode hand-off (``export_kv`` /
    ``import_kv``). ``k_pages``/``v_pages`` are CPU tensors [n_layers,
    n_pages, hkv, block, hd] in the pool's storage (on quantized pools
    the int8 payload, or nibble-packed uint8 [.., hd // 2], with fp32
    ``k_scales``/``v_scales`` [n_layers, n_pages, hkv, block]); the
    importer adopts them bit-identically. ``dtype`` is the engine's
    compute dtype in the JAX spelling ("bfloat16", "float32")."""

    uid: int
    tokens: List[int]          # fed context (prompt + any decoded tokens)
    seen: int                  # tokens whose KV the pages hold
    prompt_len: int
    kv_block_size: int
    n_layers: int
    n_kv_heads: int
    head_dim: int
    dtype: str
    k_pages: torch.Tensor
    v_pages: torch.Tensor
    kv_quant: str = "none"
    k_scales: Optional[torch.Tensor] = None
    v_scales: Optional[torch.Tensor] = None

    @property
    def n_pages(self) -> int:
        return int(self.k_pages.shape[1])

    @property
    def nbytes(self) -> int:
        leaves = [self.k_pages, self.v_pages]
        if self.k_scales is not None:
            leaves += [self.k_scales, self.v_scales]
        return int(sum(t.numel() * t.element_size() for t in leaves))


@dataclass
class SequenceDescriptor:
    """uid, slot, tokens seen/scheduled, owned KV blocks."""

    uid: int
    slot: int
    tokens: List[int] = field(default_factory=list)  # full known token stream
    seen: int = 0                                    # tokens already in KV
    blocks: List[int] = field(default_factory=list)
    # telemetry clocks: t_admitted is cleared once TTFT is recorded;
    # t_created survives until flush() reports end-to-end latency
    t_admitted: Optional[float] = None
    t_created: Optional[float] = None
    prompt_len: int = 0

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
    # sampling (the v1 engine's ``_sample``); 0.0 = greedy
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
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
    and moved in place to ``config.dtype`` on ``device``. ``seed`` seeds
    the sampling streams (the JAX engine's ``rng``): PyTorch's generators,
    so a sampled stream is not the JAX engine's.
    """

    def __init__(self, model, config: Optional[RaggedConfig] = None,
                 device=None, seed: int = 0, topology=None):
        self.config = cfg = config or RaggedConfig()
        self.device = resolve_device(device)
        self.model = model
        c = model.config
        tp = topology.model_parallel_size if topology is not None else 1
        if tp > 1 and c.n_kv_heads % tp:
            raise ValueError(
                f"n_kv_heads {c.n_kv_heads} not divisible by the model "
                f"axis {tp} — TP serving shards the KV pool by head")
        if tp > 1:
            # heads, d_ff and the vocab must divide, before the pool is
            # built
            model._check_tp(tp)
        self.topo = topology
        self._tp = tp
        if cfg.max_context > c.max_seq_len:
            raise ValueError(
                f"max_context {cfg.max_context} exceeds model "
                f"max_seq_len {c.max_seq_len} (RoPE/position table bound)")
        if not c.causal or not c.prenorm:
            # the JAX engine's _core pre-norms every block and attends
            # causally over the paged pool whatever the config says, so it
            # serves an encoder wrong logits (ROADMAP.md Queue C, C7)
            raise NotImplementedError(
                "RaggedInferenceEngine serves causal pre-LN decoders only: "
                "causal=False / prenorm=False (encoders) would be attended "
                "causally and pre-normed over the paged pool, as the JAX "
                "engine silently does (ROADMAP.md Queue C, C7); run an "
                "encoder through init_inference(...).forward or "
                "model.apply")
        if c.position == "alibi" or c.parallel_residual:
            # the ragged step inlines the block math without ALiBi bias /
            # parallel-residual wiring; loud failure beats wrong logits
            raise NotImplementedError(
                "RaggedInferenceEngine does not support ALiBi or parallel-"
                "residual families yet; use InferenceEngine (dense KV cache)")
        if c.attn_scale is not None:
            raise NotImplementedError(
                "RaggedInferenceEngine does not support attention-scale "
                "overrides (GPT-Neo); use InferenceEngine (dense KV cache)")
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
        if cfg.temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0 (0 = greedy), got "
                f"{cfg.temperature}")
        if c.window_binds(cfg.max_context):
            log_dist("RaggedInferenceEngine: binding sliding window — "
                     "banded paged attention")
        if tp > 1 and model._tp_size == 1:
            model.shard_(topology)
        if model._tp_size != tp:
            raise ValueError(f"the model is sharded over a model axis of "
                             f"{model._tp_size}, the topology's is {tp}")
        model.to(device=self.device, dtype=cfg.dtype)
        # this rank's heads; group rank 0 is the controller
        self._hq, self._hkv = c.n_heads // tp, c.n_kv_heads // tp
        self._tp_rank = topology.rank("model") if tp > 1 else 0
        self.is_controller = self._tp_rank == 0
        self._tp_failed: Optional[BaseException] = None
        self.allocator = BlockedAllocator(cfg.n_kv_blocks)
        self.prefix_cache = (PrefixCache(cfg.kv_block_size)
                             if cfg.enable_prefix_cache else None)
        self.seqs: Dict[int, SequenceDescriptor] = {}
        self._free_slots = list(range(cfg.max_seqs))
        # uids whose next admission is a RESUME (post-preempt/discard): the
        # request telemetry skips their TTFT/latency records, and the
        # server clears markers of uids that went terminal
        self._resume_uids: set = set()
        self.max_pages = cfg.max_context // cfg.kv_block_size
        # paged KV pool: per-layer [n_blocks + 1, hkv, block, hd] tensors;
        # the last page is the sink that padding lanes scatter into, so an
        # inactive lane never aliases a live page. Quantized pools hold
        # int8 [.., hd] or nibble-packed uint8 [.., hd // 2] payloads, plus
        # (k scales, v scales) [n_blocks + 1, hkv, block] fp32 leaves; all
        # start at zero, so an unwritten page dequantizes to zeros
        pages = (cfg.n_kv_blocks + 1, self._hkv, cfg.kv_block_size)
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
        # speculative acceptance stats (generate_speculative and the
        # serving tick's verify rounds) and the per-uid memoized n-gram
        # draft indices (extended on draft, truncated by trim, dropped on
        # flush / discard)
        self.spec_stats = {"proposed": 0, "accepted": 0, "rounds": 0}
        self._ngram_idx: Dict[int, NgramIndex] = {}
        # global-KV-tier seams, inert until enable_kv_tier attaches them,
        # and the adoption counters
        self._cold_tier = None
        self._on_prefix_invalidate = None
        self._kv_tier_member = ""
        self.kvtier_cold_spills = 0
        self.kvtier_cold_readmits = 0
        self.kvtier_adopt_imports = 0
        # sampling streams: a decode step reseeds the device generator
        # from (seed, global step), so the stream does not depend on how
        # decode_steps chunks it; prefill first tokens take a stream of
        # their own (one reseed per resolved round) on the host
        self._seed = int(seed)
        self._gen = torch.Generator(device=self.device)
        self._host_gen = torch.Generator()
        self._decode_step_counter = 0
        self._prefill_round_counter = 0
        if tp > 1:
            self._check_same_engines()
        log_dist(f"RaggedInferenceEngine: budget={cfg.token_budget} "
                 f"blocks={cfg.n_kv_blocks}x{cfg.kv_block_size} "
                 f"device={self.device}"
                 + (f" tp={tp} rank={self._tp_rank}" if tp > 1 else ""))

    # -- tensor parallelism: the controller's step records -----------------
    def _check_same_engines(self) -> None:
        """Every rank of the model group must build the same engine
        (config, model config, seed): the workers replay the controller's
        records with their own. A digest of the three is gathered; any
        difference raises on every rank."""
        c = self.model.config
        text = repr((dataclasses.asdict(self.config), dataclasses.asdict(c),
                     self._seed, self._tp))
        mine = int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                              "little") >> 1
        got = comm.tp_gather(torch.tensor([mine], dtype=torch.int64),
                             self.topo.group("model"))
        if bool((got != mine).any()):
            raise ValueError("the model group's ranks built engines with "
                             "different configs, model configs or seeds")

    def _tp_guarded(self, fn):
        """``fn()`` under the model group's failure latch: once a step
        failed, the ranks are out of step, so it and every later one raise
        :class:`RankFailure`."""
        if self._tp_failed is not None:
            raise RankFailure(
                f"model group rank {self._tp_rank}: an earlier step failed "
                f"({type(self._tp_failed).__name__}: {self._tp_failed}); "
                f"the engine does not serve with fewer ranks")
        try:
            return fn()
        except Exception as e:
            self._tp_failed = e
            raise RankFailure(
                f"model group rank {self._tp_rank}: a tensor-parallel step "
                f"failed ({type(e).__name__}: {e}); the ranks are no longer "
                f"in step") from e

    def _send(self, record: Dict[str, Any]) -> None:
        comm.broadcast_record(record, self.topo.group("model"), "model")

    def _device_step(self, op: str, local: Optional[Dict[str, Any]] = None,
                     **record) -> Any:
        """Run one device step (``_REPLAY[op]`` of ``record``). Under
        tensor parallelism the controller first broadcasts the record, and
        the workers replay it in :meth:`serve_worker`. ``local`` holds the
        controller's own arguments of the replay, which are not broadcast
        (an import's pages: ``write_pages`` scatters them)."""
        record["op"] = op
        local = local or {}
        if self._tp <= 1:
            return self._REPLAY[op](self, record, **local)
        if not self.is_controller:
            raise RuntimeError(
                f"model group rank {self._tp_rank} is a worker: it replays "
                f"the controller's steps in serve_worker()")

        def step():
            self._send(record)
            return self._REPLAY[op](self, record, **local)

        return self._tp_guarded(step)

    def serve_worker(self) -> Dict[str, int]:
        """Ranks above 0 of the model group: replay the controller's step
        records on this rank's shard until it sends ``stop``. Returns how
        many records of each op were replayed. A worker may serve again
        after a ``stop``; a failed step raises :class:`RankFailure`."""
        if self._tp <= 1 or self.is_controller:
            raise RuntimeError("serve_worker() runs on the ranks above 0 "
                               "of a tensor-parallel engine's model group")
        group = self.topo.group("model")
        counts: Dict[str, int] = {}
        while True:
            record = self._tp_guarded(
                lambda: comm.broadcast_record(None, group, "model"))
            op = record["op"]
            counts[op] = counts.get(op, 0) + 1
            if op == "stop":
                return counts
            self._tp_guarded(lambda: self._REPLAY[op](self, record))

    def stop_workers(self) -> None:
        """Controller: send the workers ``stop`` (their ``serve_worker``
        returns). Nothing to do without tensor parallelism or after a
        failed step, when the workers cannot be reached in step."""
        if self._tp > 1 and self.is_controller and self._tp_failed is None:
            self._tp_guarded(lambda: self._send({"op": "stop"}))

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

    @property
    def _telemetry(self):
        # resolved per call: the global pipeline may be installed after
        # this engine is constructed
        from ..telemetry import get_telemetry

        return get_telemetry()

    def flush(self, uids: Sequence[int]) -> None:
        """Release sequence state + KV blocks. With the prefix cache on,
        the sequence's full KV blocks are published first."""
        now = time.perf_counter()
        for uid in uids:
            seq = self.seqs.pop(uid, None)
            self._ngram_idx.pop(uid, None)
            if seq is not None:
                if seq.t_created is not None:
                    # the request retires here: end-to-end latency and
                    # the tokens generated past the admitted prompt
                    self._telemetry.record_request(
                        latency_s=now - seq.t_created,
                        new_tokens=max(0, len(seq.tokens) - seq.prompt_len))
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
        seq.t_created = None          # suppress request-retired telemetry
        self.flush([uid])
        self._resume_uids.add(uid)
        return toks

    def discard(self, uid: int) -> None:
        """Drop ``uid``, releasing its blocks + slot while publishing
        NOTHING into the prefix cache — the recovery hook for a failed
        step whose KV integrity is unknown."""
        seq = self.seqs.pop(uid, None)
        self._ngram_idx.pop(uid, None)
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

    def _note_ttft(self, seq: SequenceDescriptor, now: float) -> None:
        """The prompt is fully prefilled and its first logits are on the
        host: record TTFT once (latency follows at ``flush``)."""
        if seq.t_admitted is not None:
            self._telemetry.record_request(ttft_s=now - seq.t_admitted)
            seq.t_admitted = None

    def _record_step_telemetry(self, sched) -> None:
        """Per-ragged-step series: scheduled tokens and pool occupancy
        (host dict updates only)."""
        t = self._telemetry
        if not t.enabled:
            return
        r = t.registry
        r.counter("inference/ragged_steps").inc()
        r.counter("inference/scheduled_tokens").inc(
            sum(take for _, take in sched))
        r.gauge("inference/kv_occupancy").set(self.kv_occupancy())
        r.gauge("inference/live_sequences").set(len(self.seqs))

    def kv_demand(self) -> float:
        """Fraction of the pool that live demand holds: pages the prefix
        cache could reclaim do not count (a warm cache may fill the pool
        at idle without being pressure)."""
        return 1.0 - self._available_blocks() / self.allocator.n_blocks

    # -- speculative drafting -------------------------------------------
    def draft_tokens(self, uid: int, next_token: Optional[int],
                     ngram: int, k: int) -> List[int]:
        """Prompt-lookup draft for ``uid``'s next decode step: up to ``k``
        tokens continuing ``tokens + [next_token]`` (the pending token, not
        yet fed, as a virtual suffix), from the uid's memoized
        :class:`NgramIndex`."""
        seq = self.seqs[uid]
        idx = self._ngram_idx.get(uid)
        if idx is None or idx.ngram != int(ngram):
            idx = NgramIndex(ngram)
            self._ngram_idx[uid] = idx
        idx.sync(seq.tokens)
        return idx.lookup([] if next_token is None else [int(next_token)], k)

    def record_spec(self, proposed: int = 0, accepted: int = 0,
                    rounds: int = 0) -> None:
        """Fold one speculative verify outcome into ``spec_stats`` and the
        telemetry registry (``inference/spec_*`` counters and the
        acceptance gauge)."""
        s = self.spec_stats
        s["proposed"] += int(proposed)
        s["accepted"] += int(accepted)
        s["rounds"] += int(rounds)
        t = self._telemetry
        if not t.enabled:
            return
        r = t.registry
        if rounds:
            r.counter("inference/spec_rounds").inc(rounds)
        if proposed:
            r.counter("inference/spec_proposed").inc(proposed)
        if accepted:
            r.counter("inference/spec_accepted").inc(accepted)
        if s["proposed"]:
            r.gauge("inference/spec_acceptance").set(
                s["accepted"] / s["proposed"])

    # -- KV export / import (disaggregated prefill -> decode hand-off) ---
    def _gather_pages(self, blocks: Sequence[int]):
        """Host copies of ``blocks`` from every layer's leaves, stacked
        [n_layers, n_pages, n_kv_heads, ...] with every KV head (a
        ``gather_pages`` step: under tensor parallelism each rank's head
        slices are gathered on the controller): (k, v, k_scales or None,
        v_scales or None)."""
        return self._device_step("gather_pages",
                                 blocks=np.asarray(list(blocks), np.int64))

    def _replay_gather_pages(self, rec: Dict[str, Any]):
        idx = self._dev(rec["blocks"])
        out = [torch.stack([leaf[idx] for leaf in group]).cpu()
               for group in self.kv_pool]
        if self._tp > 1:
            # the head dim (2) of each rank's slice; bytes on the wire, so
            # every pool dtype crosses the host transport
            group = self.topo.group("model")
            parts = [comm.gather(t.view(torch.uint8), group) for t in out]
            if not self.is_controller:
                return None
            out = [torch.cat(p, dim=2).view(t.dtype)
                   for p, t in zip(parts, out)]
        return tuple(out) if self._kv_bits else (out[0], out[1], None, None)

    def _logical_bytes(self, n_pages: int) -> int:
        """What an unquantized copy of ``n_pages`` pages would move: the
        ledger's denominator for the wire bytes of a hand-off."""
        c = self.model.config
        itemsize = torch.empty((), dtype=self.config.dtype).element_size()
        return (2 * n_pages * c.n_layers * c.n_kv_heads
                * self.config.kv_block_size * c.head_dim * itemsize)

    def _geometry(self) -> Tuple[int, int, int, int, str, str]:
        c, cfg = self.model.config, self.config
        return (cfg.kv_block_size, c.n_layers, c.n_kv_heads, c.head_dim,
                _dtype_name(cfg.dtype), cfg.kv_quant)

    def export_kv(self, uid: int) -> KVExport:
        """Snapshot ``uid``'s KV pages and token stream for another
        engine to continue (a prefill replica hands a sequence to a
        decode replica). The sequence must be fully prefilled. Nothing is
        released: the caller then ``preempt``s or ``discard``s it."""
        seq = self.seqs.get(uid)
        if seq is None:
            raise KeyError(f"uid {uid} has no live sequence to export")
        if seq.pending:
            raise ValueError(
                f"uid {uid}: {seq.pending} tokens still pending prefill — "
                "a mid-prefill export would hand off torn context")
        if seq.seen == 0 or not seq.blocks:
            raise ValueError(f"uid {uid}: nothing prefilled yet")
        c = self.model.config
        # rows past ``seen`` in the last page are never read; they ride
        # along
        k, v, ks, vs = self._gather_pages(seq.blocks)
        export = KVExport(uid=uid, tokens=list(seq.tokens), seen=seq.seen,
                          prompt_len=seq.prompt_len,
                          kv_block_size=self.config.kv_block_size,
                          n_layers=c.n_layers, n_kv_heads=c.n_kv_heads,
                          head_dim=c.head_dim,
                          dtype=_dtype_name(self.config.dtype),
                          k_pages=k, v_pages=v,
                          kv_quant=self.config.kv_quant,
                          k_scales=ks, v_scales=vs)
        t = self._telemetry
        if t.enabled:
            t.registry.counter("inference/kv_exports").inc()
            t.registry.counter("inference/kv_export_pages").inc(
                len(seq.blocks))
            t.registry.counter("inference/kv_export_bytes").inc(
                export.nbytes)
        record_collective("kv_handoff", self._logical_bytes(len(seq.blocks)),
                          export.nbytes)
        return export

    def import_kv(self, uid: int, export: KVExport) -> None:
        """Adopt an exported sequence: allocate pages from this engine's
        pool (evicting cached prefixes under pressure), write the pages
        (and scales) in as they were exported, and create a live
        descriptor at ``seen``, so the next ``put(uid, [next_token])`` or
        ``decode_steps`` continues the stream without a re-prefill.

        Raises :class:`PoolExhausted` (recoverable) or ``ValueError`` on a
        geometry mismatch; on any failure nothing is mutated."""
        cfg = self.config
        if uid in self.seqs:
            raise ValueError(f"uid {uid} already live in this engine")
        want = self._geometry()
        have = (export.kv_block_size, export.n_layers, export.n_kv_heads,
                export.head_dim, export.dtype, export.kv_quant)
        if want != have:
            raise ValueError(
                f"KV geometry mismatch: engine (block,layers,hkv,hd,dtype,"
                f"kv_quant)={want} vs export {have}")
        if self._kv_bits and (export.k_scales is None
                              or export.v_scales is None):
            raise ValueError(
                f"export tagged kv_quant={export.kv_quant} carries no scales")
        if export.seen != len(export.tokens):
            raise ValueError(
                f"export seen {export.seen} != tokens {len(export.tokens)}")
        if export.seen > cfg.max_context:
            raise ValueError(
                f"export context {export.seen} exceeds max_context "
                f"{cfg.max_context}")
        need = export.n_pages
        if need != -(-export.seen // cfg.kv_block_size):
            raise ValueError(
                f"export carries {need} pages for {export.seen} tokens")
        if not self._free_slots:
            raise RuntimeError("no free sequence slots; flush() first")
        if need > self.allocator.free_blocks and self.prefix_cache is not None:
            self.prefix_cache.evict_for(self.allocator, need)
        blocks = self.allocator.allocate(need)        # may raise PoolExhausted
        try:
            self._write_pages(blocks, export.k_pages, export.v_pages,
                              export.k_scales, export.v_scales)
        except BaseException:
            self.allocator.release(blocks)
            raise
        self.seqs[uid] = SequenceDescriptor(
            uid=uid, slot=self._free_slots.pop(),
            tokens=[int(t) for t in export.tokens], seen=int(export.seen),
            blocks=blocks, prompt_len=int(export.prompt_len))
        # no request telemetry (t_admitted / t_created stay None): the
        # serving layer's request span owns handed-off work end to end
        self._resume_uids.discard(uid)
        t = self._telemetry
        if t.enabled:
            t.registry.counter("inference/kv_imports").inc()

    def _write_pages(self, blocks: Sequence[int], k, v, ks=None,
                     vs=None) -> None:
        """Write imported pages (every KV head) into every layer's leaves
        at ``blocks`` (payload and, on quantized pools, scales: the pool
        ends up holding the exported bytes, never a requantization), as a
        ``write_pages`` step: under tensor parallelism each rank receives
        its head slices. The JAX package pads the page count to a power
        of two to bound its compile cache; the eager port writes exactly
        these pages."""
        groups = (k, v, ks, vs) if self._kv_bits else (k, v)
        for src, leaves in zip(groups, self.kv_pool):
            want = (len(leaves), len(blocks), leaves[0].shape[1] * self._tp) \
                + tuple(leaves[0].shape[2:])
            if tuple(src.shape) != want:
                raise ValueError(
                    f"imported pages {tuple(src.shape)} do not fit leaves "
                    f"{tuple(leaves[0].shape)} x {len(leaves)} layers at "
                    f"{len(blocks)} pages")
        self._device_step("write_pages",
                          local={"groups": groups},
                          blocks=np.asarray(list(blocks), np.int64))

    @torch.inference_mode()
    def _replay_write_pages(self, rec: Dict[str, Any], groups=None) -> None:
        idx = self._dev(rec["blocks"])
        for gi, leaves in enumerate(self.kv_pool):
            leaf0 = leaves[0]
            src = None if groups is None else groups[gi].to(leaf0.dtype)
            if self._tp > 1:
                # this rank's head slices, as bytes (see gather_pages)
                buf = torch.empty((len(leaves), len(idx))
                                  + tuple(leaf0.shape[1:]), dtype=leaf0.dtype)
                parts = None if src is None else [
                    c.contiguous().view(torch.uint8)
                    for c in src.chunk(self._tp, dim=2)]
                src = comm.scatter(parts, buf.view(torch.uint8),
                                   self.topo.group("model")).view(leaf0.dtype)
            src = src.to(self.device)
            for i, leaf in enumerate(leaves):
                leaf[idx] = src[i]

    # -- global KV tier seams ---------------------------------------------
    def enable_kv_tier(self, *, member: str = "", cold_tier=None,
                       on_invalidate=None) -> None:
        """Attach this engine to a global KV tier: ``cold_tier`` (a
        :class:`~deepspeed_tpu_torch.serving.kvtier.ColdTier`) receives
        evicted prefixes, and ``on_invalidate(hash)`` drops the
        directory entry at eviction time."""
        self._kv_tier_member = str(member)
        self._cold_tier = cold_tier
        self._on_prefix_invalidate = on_invalidate
        if self.prefix_cache is not None and (
                cold_tier is not None or on_invalidate is not None):
            self.prefix_cache.on_evict = self._on_prefix_evict

    def _on_prefix_evict(self, key: Tuple[int, ...],
                         blocks: List[int]) -> None:
        """The prefix cache's eviction hook: invalidate the directory
        entry first (it must be gone before the pages can be reused), then
        spill a host copy into the cold tier."""
        if self._on_prefix_invalidate is not None:
            self._on_prefix_invalidate(prefix_hash(key))
        cold = self._cold_tier
        if cold is not None:
            export = self._gather_prefix_export(key, list(blocks))
            if cold.put(export):
                self.kvtier_cold_spills += 1

    def prefix_residency_hashes(self) -> List[int]:
        """Hashes of every resident prefix-cache entry: the set a replica
        publishes into the prefix directory."""
        if self.prefix_cache is None:
            return []
        return [prefix_hash(k) for k in self.prefix_cache._entries]

    def _gather_prefix_export(self, key: Tuple[int, ...],
                              blocks: List[int]) -> PrefixExport:
        """Host-copy ``blocks`` (payload and scales as pooled) into a
        checksummed :class:`PrefixExport`."""
        k, v, ks, vs = self._gather_pages(blocks)
        scales = (ks, vs) if self._kv_bits else None
        wire = sum(t.numel() * t.element_size() for t in (k, v)
                   + (scales or ()))
        block, layers, hkv, hd, dtype, kv_quant = self._geometry()
        return PrefixExport(
            tokens=key, n_pages=len(blocks), block_size=block,
            n_layers=layers, n_kv_heads=hkv, head_dim=hd, dtype=dtype,
            kv_quant=kv_quant, pages=(k, v), scales=scales,
            wire_bytes=wire, logical_bytes=self._logical_bytes(len(blocks)),
            source=self._kv_tier_member)

    def export_prefix(self, tokens: Sequence[int]) -> Optional[PrefixExport]:
        """Snapshot the longest cached full-block prefix of ``tokens`` for
        another replica to adopt; None on a cache miss. The pages are
        retained across the host copy, and the transfer is booked as a
        ``kv_adopt`` row of the bytes-on-wire ledger. An installed chaos
        injector may corrupt the wire payload after the checksum was
        stamped (``on_prefix_export``): the importer's verify must catch
        it."""
        if self.prefix_cache is None:
            return None
        key, blocks = self.prefix_cache.lookup(tokens)
        if not blocks:
            return None
        blocks = list(blocks)
        self.allocator.retain(blocks)
        try:
            export = self._gather_prefix_export(key, blocks)
        finally:
            self.allocator.release(blocks)
        t = self._telemetry
        if t.enabled:
            t.registry.counter("inference/prefix_exports").inc()
            t.registry.counter("inference/prefix_export_pages").inc(
                len(blocks))
            t.registry.counter("inference/prefix_export_bytes").inc(
                export.wire_bytes)
        record_collective("kv_adopt", export.logical_bytes,
                          export.wire_bytes)
        from ..resilience.chaos import get_fault_injector

        inj = get_fault_injector()
        if inj is not None and inj.on_prefix_export():
            # adoption-wire corruption: flip one token after the checksum
            # was stamped
            export.tokens = ((export.tokens[0] ^ 0x1,)
                             + export.tokens[1:])
        return export

    def import_prefix(self, export: PrefixExport) -> bool:
        """Adopt an exported prefix into this engine's prefix cache (no
        live sequence). The checksum is verified first
        (:class:`~deepspeed_tpu_torch.serving.kvtier.CorruptExport`), then
        the geometry; the pages are allocated, written and published, and
        the cache ends holding the only references. Returns False when
        the prefix is already resident; raises ValueError or
        :class:`PoolExhausted` (the caller falls back to prefill)."""
        if self.prefix_cache is None:
            raise ValueError("prefix cache disabled; nothing to adopt into")
        cfg = self.config
        if not export.verify():
            raise CorruptExport("prefix export failed checksum verification "
                                "(corrupted in transit)")
        want = self._geometry()
        if want != export.geometry():
            raise ValueError(
                f"prefix KV geometry mismatch: engine (block,layers,hkv,"
                f"hd,dtype,kv_quant)={want} vs export {export.geometry()}")
        if self._kv_bits and export.scales is None:
            raise ValueError(
                f"export tagged kv_quant={export.kv_quant} carries no "
                f"scales")
        need = export.n_pages
        if need <= 0 or need != len(export.tokens) // cfg.kv_block_size \
                or len(export.tokens) % cfg.kv_block_size:
            raise ValueError(
                f"prefix export carries {need} pages for "
                f"{len(export.tokens)} tokens (full blocks required)")
        if len(export.tokens) > cfg.max_context:
            raise ValueError(
                f"prefix length {len(export.tokens)} exceeds max_context "
                f"{cfg.max_context}")
        if tuple(export.tokens) in self.prefix_cache._entries:
            return False
        if need > self.allocator.free_blocks:
            self.prefix_cache.evict_for(self.allocator, need)
        blocks = self.allocator.allocate(need)    # may raise PoolExhausted
        try:
            k, v = export.pages
            ks, vs = export.scales if self._kv_bits else (None, None)
            self._write_pages(blocks, k, v, ks, vs)
        except BaseException:
            self.allocator.release(blocks)
            raise
        # publish takes the cache's own references, then the allocation's
        # drops: the cache holds the only ones
        self.prefix_cache.publish(export.tokens, blocks, len(export.tokens),
                                  self.allocator)
        self.allocator.release(blocks)
        self.kvtier_adopt_imports += 1
        t = self._telemetry
        if t.enabled:
            t.registry.counter("inference/prefix_imports").inc()
            t.registry.counter("inference/prefix_import_pages").inc(need)
        return True

    def _cold_readmit(self, tokens: Sequence[int]) -> None:
        """Re-admit the longest spilled full-block prefix of ``tokens``
        that the device cache lacks, through :meth:`import_prefix`, so the
        admission match finds it. Best effort: pool pressure or a failed
        verify leaves plain prefill."""
        bs = self.config.kv_block_size
        for k in range((len(tokens) - 1) // bs, 0, -1):
            key = tuple(int(t) for t in tokens[: k * bs])
            if key in self.prefix_cache._entries:
                return              # the device cache is at least as good
            export = self._cold_tier.get(key)
            if export is None:
                continue
            try:
                if self.import_prefix(export):
                    self.kvtier_cold_readmits += 1
                    t = self._telemetry
                    if t.enabled:
                        t.registry.counter(
                            "inference/prefix_cold_readmits").inc()
            except (ValueError, RuntimeError):
                pass                # PoolExhausted / corrupt: plain prefill
            return

    # -- rewind ------------------------------------------------------------
    def trim(self, uid: int, length: int) -> None:
        """Rewind ``uid`` to its first ``length`` tokens, freeing the
        pages past them. Attention reads are position-bounded, so KV past
        the trim point is never read; the next step overwrites it. A
        boundary page that another holder shares (the prefix cache or
        another sequence) is first copied to a private page, allocated
        before anything changes: a failed trim leaves the sequence as it
        was."""
        seq = self.seqs[uid]
        if not 0 <= length <= seq.seen:
            raise ValueError(
                f"uid {uid}: trim length {length} outside [0, seen={seq.seen}]")
        bs = self.config.kv_block_size
        keep = -(-length // bs) if length else 0
        cow_new = None
        if (length % bs and keep <= len(seq.blocks)
                and self.allocator.refcount(seq.blocks[keep - 1]) > 1):
            if (self.allocator.free_blocks < 1
                    and self.prefix_cache is not None):
                self.prefix_cache.evict_for(self.allocator, 1)
            # the eviction may have dropped the cache's reference on the
            # boundary page, making it private
            if self.allocator.refcount(seq.blocks[keep - 1]) > 1:
                cow_new = self.allocator.allocate(1)[0]   # may raise
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
            self._copy_page(old, cow_new)
            self.allocator.release([old])
            seq.blocks[keep - 1] = cow_new

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy page ``src`` to ``dst`` in every leaf of every layer,
        scales included (trim's copy-on-write)."""
        self._device_step("copy_page", src=int(src), dst=int(dst))

    @torch.inference_mode()
    def _replay_copy_page(self, rec: Dict[str, Any]) -> None:
        for leaves in self.kv_pool:
            for leaf in leaves:
                leaf[rec["dst"]].copy_(leaf[rec["src"]])

    # -- step ------------------------------------------------------------
    def _admit_tokens(self, uids: Sequence[int],
                      tokens: Sequence[Sequence[int]]) -> None:
        """put()'s first phase, shared with :meth:`put_spec`: fresh uids
        get a slot (and adopt the longest cached full-block prefix, after
        a cold-tier re-admission when a cold tier is attached); existing
        ones append their chunk."""
        for uid, toks in zip(uids, tokens):
            new = uid not in self.seqs
            if new:
                if not self._free_slots:
                    raise RuntimeError("no free sequence slots; flush() first")
                now = time.perf_counter()
                resumed = uid in self._resume_uids
                self._resume_uids.discard(uid)
                self.seqs[uid] = SequenceDescriptor(
                    uid=uid, slot=self._free_slots.pop(),
                    t_admitted=None if resumed else now,
                    t_created=None if resumed else now)
            seq = self.seqs[uid]
            seq.tokens.extend(int(t) for t in toks)
            if new:
                seq.prompt_len = len(seq.tokens)
            if new and self.prefix_cache is not None and seq.tokens:
                if self._cold_tier is not None:
                    self._cold_readmit(seq.tokens)
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
        # head only on each sequence's selected (last) token; only the
        # [max_seqs, vocab] rows travel to the host
        logits = self._device_step(
            "core", tokens=flat_tokens, slot=flat_slot, pos=flat_pos,
            tables=self._host_tables(), live_pages=self._live_pages_bucket(),
            sel=sel_idx).cpu().numpy()
        out = np.full((len(uids), logits.shape[-1]), np.nan, np.float32)
        now = time.perf_counter()
        for i, uid in enumerate(uids):
            seq = self.seqs[uid]
            if seq.pending == 0 and uid in last_index:
                out[i] = logits[seq.slot]
                self._note_ttft(seq, now)
        self._record_step_telemetry(sched)
        return out

    def put_spec(self, uids: Sequence[int], tokens: Sequence[Sequence[int]],
                 drafts: Sequence[Sequence[int]]
                 ) -> Tuple[np.ndarray, Dict[int, Tuple[List[int], np.ndarray]]]:
        """One ragged step that also verifies speculative draft chains:
        the serving tick's speculative entry point. Prefill chunks, plain
        decodes and draft-extended decodes pack into one step.

        ``drafts[i]`` proposes tokens after ``tokens[i]``, which must then
        be exactly one pending decode token. Returns ``(out, verified)``:
        ``out`` is put()'s [len(uids), vocab] last-row logits (NaN
        mid-prefill rows unchanged); ``verified`` maps each drafted uid to
        ``(chain, rows)``, the chain scheduled (first element the fed
        token) and fp32 logits [len(chain), vocab] for each of its
        positions. The caller accepts the longest greedy-matching prefix
        and must ``trim`` the rejected tail before the uid's next step.

        Chains are all-or-strip under the token budget: proposals the
        budget cannot hold are stripped from the stream, never left as
        pending context. Every chain is validated before any draft token
        is appended, and on PoolExhausted every draft token is stripped
        before the raise, so a retry with a plain ``put`` of empty chunks
        sees exactly put()'s admitted state."""
        cfg = self.config
        self._admit_tokens(uids, tokens)
        for uid, d in zip(uids, drafts):
            if d and self.seqs[uid].pending != 1:
                raise ValueError(
                    f"uid {uid}: a draft chain continues exactly one "
                    f"pending decode token, found "
                    f"pending={self.seqs[uid].pending}")
        appended: Dict[int, int] = {}     # uid -> draft tokens on the stream
        for uid, d in zip(uids, drafts):
            if not d:
                continue
            self.seqs[uid].tokens.extend(int(t) for t in d)
            appended[uid] = len(d)
        try:
            sched = self._pack_splitfuse()
            if not sched:
                raise ValueError("put_spec() called with no pending tokens")
            # all-or-strip: drop the proposals the budget left behind
            take_of = {seq.uid: take for seq, take in sched}
            for uid in list(appended):
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
            for uid, n in appended.items():
                seq = self.seqs[uid]
                del seq.tokens[len(seq.tokens) - n:]
            raise
        flat_tokens, flat_slot, flat_pos, last_idx = \
            self._allocate_and_build(sched, needs)
        k_max = 1
        for seq, take in sched:
            if seq.uid in appended:
                while k_max < take:
                    k_max *= 2
        sel_rows = np.zeros((cfg.max_seqs, k_max), np.int64)
        last_index: Dict[int, int] = {}
        for (seq, take), li in zip(sched, last_idx):
            li = int(li)
            sel_rows[seq.slot, :] = li        # padding rows: never read
            if seq.uid in appended:
                sel_rows[seq.slot, :take] = np.arange(li - take + 1, li + 1)
            seq.seen += take
            last_index[seq.uid] = li
        logits = self._verify_step(flat_tokens, flat_slot, flat_pos, sel_rows)
        out = np.full((len(uids), logits.shape[-1]), np.nan, np.float32)
        now = time.perf_counter()
        for i, uid in enumerate(uids):
            seq = self.seqs[uid]
            if seq.pending == 0 and uid in last_index:
                # sel_rows[slot, -1] is the last scheduled row whether or
                # not the slot carried a chain: put()'s contract holds
                out[i] = logits[seq.slot, -1]
                self._note_ttft(seq, now)
        verified: Dict[int, Tuple[List[int], np.ndarray]] = {}
        for seq, take in sched:
            if seq.uid in appended:
                chain = [int(t) for t in seq.tokens[seq.seen - take:
                                                    seq.seen]]
                verified[seq.uid] = (chain, logits[seq.slot, :take])
        self._record_step_telemetry(sched)
        return out, verified

    def _put_verify(self, uids: Sequence[int],
                    chains: Sequence[List[int]]) -> List[np.ndarray]:
        """Speculative-verify step of :meth:`generate_speculative`: admit
        each uid's token chain and return the logits of every chain row.
        Validates before touching any stream: a failed round leaves no
        unverified draft token behind."""
        cfg = self.config
        sched = [(self.seqs[u], len(c)) for u, c in zip(uids, chains)]
        needs = self._validate_sched(sched)
        for u, c in zip(uids, chains):
            self.seqs[u].tokens.extend(int(t) for t in c)
        flat_tokens, flat_slot, flat_pos, last_idx = \
            self._allocate_and_build(sched, needs)
        k_max = 1
        while k_max < max(take for _, take in sched):
            k_max *= 2
        sel_rows = np.zeros((cfg.max_seqs, k_max), np.int64)
        for (seq, take), li in zip(sched, last_idx):
            li = int(li)
            sel_rows[seq.slot, :take] = np.arange(li - take + 1, li + 1)
            sel_rows[seq.slot, take:] = li      # padding rows: never read
            seq.seen += take
        logits = self._verify_step(flat_tokens, flat_slot, flat_pos, sel_rows)
        return [logits[seq.slot, :take] for seq, take in sched]

    @torch.inference_mode()
    def _verify_step(self, flat_tokens, flat_slot, flat_pos,
                     sel_rows: np.ndarray) -> np.ndarray:
        """The verify step: put()'s forward (its paged-attention work list
        from the same ``_paged_work``), then the head on the [max_seqs,
        k_max] ``sel_rows`` rows (k_max a power of two). -> fp32 logits
        [max_seqs, k_max, vocab] on the host."""
        return self._device_step(
            "core", tokens=flat_tokens, slot=flat_slot, pos=flat_pos,
            tables=self._host_tables(), live_pages=self._live_pages_bucket(),
            sel=sel_rows).cpu().numpy()

    @torch.inference_mode()
    def _replay_core(self, rec: Dict[str, Any]) -> torch.Tensor:
        """A put / verify step: the ragged forward over the record's lanes,
        then the head on the rows ``sel`` names -> fp32 logits ``[*sel.
        shape, vocab]`` on the device."""
        slot, live_pages, sel = rec["slot"], rec["live_pages"], rec["sel"]
        x = self._core(self._dev(rec["tokens"]), self._dev(slot),
                       self._dev(rec["pos"]), self._dev(rec["tables"]),
                       live_pages, self._paged_work(slot, live_pages))
        logits = self.model._head(x[self._dev(sel.reshape(-1))])
        return logits.reshape(sel.shape + (-1,))

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
        return build_batch(chunks, seens_l, slots_l, T,
                           native=self.device.type == "cuda")

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
                           self.config.max_seqs, self.max_pages,
                           native=self.device.type == "cuda")

    def _paged_work(self, flat_slot: np.ndarray, live_pages: int):
        """The paged-attention work list of one step (:meth:`_plan_work`),
        shared by every layer; None off the card, where the wrapper runs
        the plain version."""
        if self.device.type != "cuda":
            return None
        return self._plan_work(flat_slot, live_pages)

    def _plan_work(self, flat_slot: np.ndarray, live_pages: int):
        """Plan a step's work list on the host from the slots the kernels
        read: padding lanes' -1 clamped to 0, as ``_core`` does, and the
        padding lanes marked, so they neither join a tile nor thin the
        real lanes' splits. put, put_spec and decode_steps all plan here,
        with the wrapper's own tile decision."""
        return plan_paged_work(
            np.maximum(flat_slot, 0), len(flat_slot),
            min(live_pages, self.max_pages), self.kv_pool[0][0],
            dtype=self.config.dtype, pad=flat_slot < 0)

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
        """Decode ``k`` tokens (greedy, or sampled under the config's
        temperature / top-k / top-p) for every uid in ``first_tokens``,
        one ragged step per token with the tokens fed back on the device
        (no host round trip inside the chunk). A sampled step draws for
        all ``max_seqs`` rows from the generator reseeded from (seed,
        global step): a stream does not depend on how calls chunk it.

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
        step0 = self._decode_step_counter
        self._decode_step_counter += k
        gen = self._device_step(
            "decode", toks=toks, pos=pos, slots=slots,
            tables=self._host_tables(), live_pages=self._live_pages_bucket(),
            k=int(k), eos=eos, step0=step0).cpu().numpy()        # [S, k]

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

    @torch.inference_mode()
    def _replay_decode(self, rec: Dict[str, Any]) -> torch.Tensor:
        """A ``decode_steps`` chunk: ``k`` ragged steps with the tokens fed
        back on the device -> int32 tokens [max_seqs, k] on the device."""
        eos, step0 = rec["eos"], rec["step0"]
        toks_t, pos_t, slots_t = self._dev(rec["toks"]), \
            self._dev(rec["pos"]), self._dev(rec["slots"])
        tables = self._dev(rec["tables"])
        live_pages = rec["live_pages"]
        # one decode lane per sequence, each on its own slot: lane items
        # only (no run of one slot makes a tile), so a lane whose slot
        # drops to -1 mid-chunk (EOS) never sits inside a tile
        work = self._paged_work(rec["slots"], live_pages)
        alive = slots_t >= 0
        if eos >= 0:
            alive = alive & (toks_t != eos)
        gens = []
        for i in range(rec["k"]):
            slots_eff = torch.where(alive, slots_t, torch.full_like(slots_t, -1))
            x = self._core(toks_t, slots_eff, pos_t, tables, live_pages,
                           work)
            nxt = self._next_tokens(self.model._head(x), step0 + i)
            if eos >= 0:
                nxt = torch.where(alive, nxt, torch.full_like(nxt, eos))
                new_alive = alive & (nxt != eos)
            else:
                new_alive = alive
            pos_t = pos_t + alive.to(pos_t.dtype)
            gens.append(nxt)
            toks_t, alive = nxt, new_alive
        return torch.stack(gens, dim=1)

    _REPLAY = {"core": _replay_core, "decode": _replay_decode,
               "copy_page": _replay_copy_page,
               "gather_pages": _replay_gather_pages,
               "write_pages": _replay_write_pages}

    # -- sampling ----------------------------------------------------------
    def _reseed(self, gen: torch.Generator, stream: str,
                counter: int) -> torch.Generator:
        """Reseed ``gen`` from (seed, stream, counter): each draw of a
        stream is fixed by its counter alone. A reseed only sets the
        generator's host-side state."""
        digest = hashlib.sha256(
            f"{self._seed}:{stream}:{counter}".encode()).digest()
        return gen.manual_seed(int.from_bytes(digest[:8], "little") >> 1)

    def _next_tokens(self, logits: torch.Tensor, step: int) -> torch.Tensor:
        """Next tokens [S] int32 of a decode step's logits [S, vocab], on
        the device: argmax when greedy, else a draw of global decode step
        ``step``."""
        cfg = self.config
        if cfg.temperature == 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return _sample(logits, self._reseed(self._gen, "decode", step),
                       cfg.temperature, cfg.top_k, cfg.top_p)

    def _sample_first(self, rows) -> List[int]:
        """First decode token(s) from resolved prefill logits rows: greedy
        on the host, else one draw a prefill round on the host's stream
        (its counter moves only when sampling, so greedy calls never shift
        a later sampled stream)."""
        cfg = self.config
        if cfg.temperature == 0.0:
            return [int(np.argmax(r)) for r in rows]
        gen = self._reseed(self._host_gen, "prefill",
                           self._prefill_round_counter)
        self._prefill_round_counter += 1
        toks = _sample(torch.from_numpy(np.stack(rows)), gen,
                       cfg.temperature, cfg.top_k, cfg.top_p)
        return [int(t) for t in toks]

    # -- generation convenience -----------------------------------------

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
        ``decode_steps`` chunks of up to ``decode_chunk`` tokens. Greedy
        when ``config.temperature`` is 0, else sampled (the stream does not
        depend on ``decode_chunk``). Returns uid -> generated tokens."""
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

    def generate_speculative(self, prompts: Dict[int, Sequence[int]],
                             max_new_tokens: int = 32,
                             eos_token_id: Optional[int] = None,
                             ngram: int = 3,
                             lookahead: int = 4) -> Dict[int, List[int]]:
        """Prompt-lookup speculative decoding, greedy only. Each round
        drafts up to ``lookahead`` tokens a sequence by matching its
        trailing ``ngram`` against earlier context, verifies every chain
        in one ragged step, accepts the longest matching prefix and trims
        the rejected tail. Greedy acceptance makes the output
        token-identical to ``generate()``; acceptance only changes how
        many steps it takes. Stats land in ``self.spec_stats``."""
        if self.config.temperature != 0.0:
            raise NotImplementedError(
                "speculative decoding is greedy-only (temperature == 0); "
                "sampled acceptance needs rejection sampling")
        done: Dict[int, List[int]] = {u: [] for u in prompts}
        first = self._prefill_first(prompts, done)
        live = {u: t for u, t in first.items()
                if len(done[u]) < max_new_tokens
                and not (eos_token_id is not None and t == eos_token_id)}
        while live:
            # fair-share the token budget so a round fits one step
            share = max(1, self.config.token_budget // len(live))
            v_uids, v_chains = [], []
            for u, t0 in live.items():
                seq = self.seqs[u]
                room = self.config.max_context - seq.seen
                if room <= 0:
                    continue
                k = max(0, min(lookahead, room - 1, share - 1,
                               max_new_tokens - len(done[u]) - 1))
                v_uids.append(u)
                v_chains.append([t0] + self.draft_tokens(u, t0, ngram, k))
            if not v_uids:
                break
            rows = self._put_verify(v_uids, v_chains)
            round_proposed = round_accepted = 0
            nxt: Dict[int, int] = {}
            for u, chain, lr in zip(v_uids, v_chains, rows):
                a = np.argmax(lr, axis=-1)            # [len(chain)]
                matched = 0
                while (matched < len(chain) - 1
                       and int(a[matched]) == chain[matched + 1]):
                    matched += 1
                round_proposed += len(chain) - 1
                round_accepted += matched
                emitted = [int(x) for x in a[:matched + 1]]
                seq = self.seqs[u]
                seen0 = seq.seen - len(chain)
                stop_at = None
                if eos_token_id is not None and eos_token_id in emitted:
                    stop_at = emitted.index(eos_token_id)
                    emitted = emitted[:stop_at + 1]
                # rewind to the validated prefix: the rejected rows are
                # never read, but the token stream must stay clean
                keep = seen0 + (stop_at if stop_at is not None
                                else matched) + 1
                if keep < seq.seen:
                    self.trim(u, keep)
                done[u].extend(emitted)
                if (stop_at is None and len(done[u]) < max_new_tokens
                        and seq.seen < self.config.max_context):
                    nxt[u] = emitted[-1]
            self.record_spec(proposed=round_proposed,
                             accepted=round_accepted, rounds=1)
            live = nxt
        for u in done:
            done[u] = done[u][:max_new_tokens]
        self.flush(list(prompts))
        return done

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
        # learned positions are clamped to the table inside _embed; a lane
        # past the context scatters into the sink page below
        x = model._embed(tokens, positions=positions)              # [T, d]
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
            h = model._norm(x, blk, "attn_norm")
            q, kk, vv = h @ blk.wq, h @ blk.wk, h @ blk.wv
            if c.qkv_bias:
                q, kk, vv = q + blk.bq, kk + blk.bk, vv + blk.bv
            q = q.reshape(-1, self._hq, c.head_dim)
            kk = kk.reshape(-1, self._hkv, c.head_dim)
            vv = vv.reshape(-1, self._hkv, c.head_dim)
            if c.position == "rope":
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
            attn = attn.to(x.dtype).reshape(-1, self._hq * c.head_dim)
            attn = model._row_parallel(attn, blk.wo)
            # attn_o_bias, not use_bias: InternLM has use_bias=False with
            # a real o_proj bias
            if c.attn_o_bias:
                attn = attn + blk.bo
            x = x + attn
            # the model's own FFN over the lanes as one [1, T, d] row (an
            # MoE model routes every lane, padding too, to its top-k
            # experts: harmless, as in the JAX engine); its aux is dropped
            down, _ = model._mlp(model._norm(x, blk, "mlp_norm")[None], blk)
            x = x + down[0]
        return x
