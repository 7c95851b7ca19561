"""Inference engine (v1): generation over a static KV cache, with
ZeRO-Inference weight-only quantization.

Ports ``deepspeed_tpu/inference/engine.py`` on one device: greedy, sampled
and beam-search ``generate`` and a raw-logits ``forward`` over a
:class:`~deepspeed_tpu_torch.models.transformer.Transformer`, through the
KV-cache branch of its ``apply``. PyTorch runs eagerly, so prefill, decode
and the beam step are plain method calls (jitted, donated programs in the
JAX package); the cache is updated in place.

ZeRO-Inference (``quant: {"enabled": True, "bits": 8 | 4, "group_size":
N}``): every floating weight whose JAX leaf has two or more dimensions is
stored as a blockwise-quantized payload plus fp32 block scales, quantized
once at construction by the hand-written quantize kernel
(:func:`deepspeed_tpu_torch.ops.quant.quantize_blockwise`) after the cast
to ``dtype``, so the scales are those of the cast values. The JAX package
stacks layer leaves ``[n_layers, ...]``, so a layer's norm vector is 2-D
there and is quantized too; only ``final_norm_w`` stays as it is. int4
payloads pack two offset-binary nibbles per byte, ``(q + 8)``, element 2k
in the low nibble. Each forward dequantizes with the hand-written
dequantize kernel one layer at a time, just before the layer runs (the JAX
package dequantizes the whole tree at the top of each program), so the
transient bf16 copy is one layer's weights; the values are the same
because the dequantize is elementwise.

Tensor parallelism (``tensor_parallel`` > 1, one process per rank): the
engine builds the topology ``{"model": tp}`` over the process group (its
world size must be ``tp``), cuts the model to this rank's shard
(``Transformer.shard_``, unless it is cut already), binds the topology
and, when ``kernel_backend`` resolves to the fused backend (``"pallas"``,
or ``"auto"`` on the card), binds it too: a decode step's MLP
down-projection then runs as ``matmul_all_reduce`` (TPU kernel row 8,
``models/transformer.py`` ``_down_proj``). The static KV cache holds this
rank's ``n_kv_heads / tp`` heads. Plain SPMD: every rank calls
``generate`` with the same ids, and since the logits are gathered on
every rank and the sampler's generator has the same seed everywhere, the
ranks draw the same tokens; ``generate`` reads no clock, so they stay in
step. ZeRO-Inference quantization under tensor parallelism raises
(ROADMAP.md, Queue A item 6b).

Not ported (later slices, ROADMAP.md Queue A): loading a ``checkpoint``
named in the config.
``generate`` records its request telemetry (TTFT, latency, decode
tokens/s) into the global pipeline when one is enabled.
"""

from __future__ import annotations

import time
from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from ..ops import quant
from ..parallel.mesh import Topology, set_topology
from ..utils.device import resolve_device
from ..utils.logging import log_dist

_DTYPES = {"float32": torch.float32, "fp32": torch.float32,
           "float16": torch.float16, "fp16": torch.float16,
           "half": torch.float16, "bfloat16": torch.bfloat16,
           "bf16": torch.bfloat16}


@dataclass
class InferenceConfig:
    """The settings of the JAX package's ``InferenceConfig`` that this
    engine reads: dtype, tensor_parallel, sampling, the comm kernel
    backend and the ZeRO-Inference ``quant`` block (``{"enabled", "bits",
    "group_size"}``, also accepted as ``quantization``). Any other key
    lands in ``extras``; ``enable_cuda_graph: True`` raises."""

    dtype: str = "bfloat16"
    tensor_parallel: int = 1
    temperature: float = 1.0
    top_k: int = 0                            # 0 = no top-k filter
    top_p: float = 1.0
    seed: int = 0
    kernel_backend: str = "auto"              # auto | xla | pallas
    quant: Dict[str, Any] = field(default_factory=dict)
    extras: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_any(cls, config: Union[None, Dict[str, Any], "InferenceConfig"],
                 **kwargs) -> "InferenceConfig":
        if isinstance(config, InferenceConfig):
            return config
        d = dict(config or {})
        d.update(kwargs)
        tp = d.pop("tensor_parallel", d.pop("mp_size", 1))
        if isinstance(tp, dict):
            tp = tp.get("tp_size", 1)
        q = d.pop("quant", d.pop("quantization", {})) or {}
        if q:
            d["quant"] = dict(q)
        known = {f for f in cls.__dataclass_fields__ if f != "extras"}
        fields = {k: v for k, v in d.items() if k in known}
        extras = {k: v for k, v in d.items() if k not in known}
        return cls(tensor_parallel=int(tp), extras=extras, **fields)

    @property
    def torch_dtype(self) -> torch.dtype:
        if self.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got "
                             f"'{self.dtype}'")
        return _DTYPES[self.dtype]


def _is_wq(x) -> bool:
    return isinstance(x, dict) and "__wq__" in x


class _DequantizedParams(Mapping):
    """A read-only ``{name: tensor}`` view of the engine's stored weights:
    reading a quantized leaf dequantizes it (one kernel launch on CUDA),
    any other leaf is returned as stored. ``compute_dtype`` lets the model
    learn the dtype without reading a layer leaf."""

    def __init__(self, engine: "InferenceEngine"):
        self._engine = engine
        self.compute_dtype = engine.dtype

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._engine._leaf(name)

    def __iter__(self) -> Iterator[str]:
        return iter(self._engine.params)

    def __len__(self) -> int:
        return len(self._engine.params)


class InferenceEngine:
    """Generation engine over a port ``Transformer`` on one device.

    ``params`` (default: the model's own weights) is a ``{name: tensor}``
    dict with the names of the model's ``named_parameters()`` (this
    rank's shards under tensor parallelism). Without
    ``params`` the engine casts and moves the model's weights in place to
    ``config.dtype`` on ``device``, as the ragged engine does; with
    quantization on it then keeps only the quantized copies and empties
    the model's own copy of each quantized leaf, so that the full-width
    weights do not stay resident. ``device`` defaults to ``"cuda"`` and
    raises without a CUDA device unless ``device="cpu"`` is asked for."""

    def __init__(self, model: Any, config: Optional[InferenceConfig] = None,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 device=None):
        self.config = cfg = config or InferenceConfig()
        tp = cfg.tensor_parallel
        if tp > 1 and (cfg.quant or {}).get("enabled", False):
            raise NotImplementedError(
                f"ZeRO-Inference weight quantization with tensor_parallel="
                f"{tp} comes with ROADMAP.md, Queue A item 6b")
        # kernel_backend binds the fused comm backend only under tensor
        # parallelism, as the JAX engine does: at tp 1 it changes nothing
        if cfg.kernel_backend not in ("auto", "xla", "pallas"):
            raise ValueError(f"kernel_backend must be 'auto', 'xla' or "
                             f"'pallas', got '{cfg.kernel_backend}'")
        if cfg.extras.get("checkpoint"):
            raise NotImplementedError(
                "loading a checkpoint named in the config (checkpoint/hf.py) "
                "comes with a later slice (ROADMAP.md, Queue A item 10); "
                "pass (model, params) instead")
        if cfg.extras.get("enable_cuda_graph"):
            raise NotImplementedError(
                "enable_cuda_graph=True: capturing the decode step in a CUDA "
                "graph is later work (ROADMAP.md, Queue B: launch "
                "overhead of the quantized paths)")
        self.device = resolve_device(device)
        self.dtype = cfg.torch_dtype
        self.model = model
        q = cfg.quant
        self._quant_enabled = bool(q.get("enabled", False))
        self._quant_bits = int(q.get("bits", 8))
        self._quant_block = int(q.get("group_size", q.get("block", 256)))
        if self._quant_enabled and self._quant_bits not in (4, 8):
            raise ValueError(f"quant.bits must be 4 or 8, got "
                             f"{self._quant_bits}")
        self.topo = self.comm_backend = None
        if tp > 1:
            self._bind_tensor_parallel(model, tp)
        owned = params is None
        if owned:
            model.to(device=self.device, dtype=self.dtype)
            params = dict(model.named_parameters())
        # cast BEFORE quantizing, as the JAX engine does: the scales are
        # those of the dtype-cast values
        self.params: Dict[str, Any] = {
            n: t.detach().to(device=self.device, dtype=self.dtype)
            if t.is_floating_point() else t.detach().to(self.device)
            for n, t in params.items()}
        self._wq_shapes: Dict[str, Tuple[int, ...]] = {}
        if self._quant_enabled:
            self._quantize_tree(model if owned else None)
            log_dist(f"ZeRO-Inference weight quant: {len(self._wq_shapes)} "
                     f"tensors at {self._quant_bits} bits, block "
                     f"{self._quant_block}")
        self._view = _DequantizedParams(self)
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        log_dist(f"InferenceEngine up: tp={tp} dtype={cfg.dtype} "
                 f"device={self.device}")

    def _bind_tensor_parallel(self, model, tp: int) -> None:
        """The JAX engine's TP path: the topology ``{"model": tp}`` made
        current, the model cut to this rank's shard and bound to it, and
        the fused comm backend bound when ``kernel_backend`` resolves to
        it."""
        from ..comm.backends import resolve_backend

        self.topo = Topology.build({"model": tp})
        set_topology(self.topo)
        if model._tp_size == 1:
            model.shard_(self.topo)
        elif model._tp_size != tp:
            raise ValueError(f"the model is sharded over a model axis of "
                             f"{model._tp_size}, tensor_parallel is {tp}")
        else:
            model.bind_topology(self.topo)
        self.comm_backend = resolve_backend(self.config.kernel_backend,
                                            self.device)
        model.bind_comm_backend(self.comm_backend
                                if self.comm_backend.name == "pallas"
                                else None)

    # -- weight-only quantization (ZeRO-Inference) ----------------------
    def _quantizes(self, name: str, t: torch.Tensor) -> bool:
        """The JAX rule on the JAX leaf: floating, two or more dimensions,
        size a multiple of the block. A layer leaf's JAX leaf is stacked
        ``[n_layers, ...]``: one more dimension, n_layers times the size.
        Where the stacked size divides and the layer's does not, the JAX
        blocks cross layer boundaries, which per-layer leaves cannot
        reproduce: that raises."""
        if not t.is_floating_point():
            return False
        block = self._quant_block
        stacked = name.startswith("layers.")
        n = self.model.config.n_layers if stacked else 1
        if t.dim() + stacked < 2 or (n * t.numel()) % block:
            return False
        if t.numel() % block:
            raise ValueError(
                f"{name}: {t.numel()} elements is not a multiple of "
                f"quant.group_size {block}; the JAX package quantizes the "
                f"stacked [n_layers, ...] leaf in blocks that cross layer "
                f"boundaries, which per-layer leaves cannot reproduce")
        return True

    @torch.no_grad()
    def _quantize_tree(self, model) -> None:
        """Replace each quantizable leaf by ``{"__wq__": payload, "s":
        scales}`` (int8 with the leaf's shape, or packed uint8
        ``[numel // 2]`` at 4 bits). With ``model``, the model's own copy
        of each quantized leaf is emptied right after it is quantized."""
        bits, block = self._quant_bits, self._quant_block
        for name in list(self.params):    # names only: hold one leaf at a time
            t = self.params[name]
            if not self._quantizes(name, t):
                continue
            payload, scale = quant.quantize_blockwise(
                t.contiguous(), bits=bits, block=block, pack=bits == 4)
            self._wq_shapes[name] = tuple(t.shape)
            self.params[name] = {"__wq__": payload, "s": scale}
            if model is not None:
                model.get_parameter(name).data = torch.empty(
                    0, device=self.device, dtype=self.dtype)

    def _leaf(self, name: str) -> torch.Tensor:
        """A weight in ``dtype``: dequantized when stored quantized."""
        leaf = self.params[name]
        if not _is_wq(leaf):
            return leaf
        out = quant.dequantize_blockwise(
            leaf["__wq__"], leaf["s"], block=self._quant_block,
            dtype=self.dtype, packed=self._quant_bits == 4)
        return out.reshape(self._wq_shapes[name])

    def param_bytes(self) -> int:
        """Device bytes of the stored (possibly quantized) weights."""
        total = 0
        for leaf in self.params.values():
            for t in (leaf.values() if _is_wq(leaf) else (leaf,)):
                total += t.numel() * t.element_size()
        return total

    # -- cache and steps -------------------------------------------------
    def _alloc_cache(self, batch: int, max_len: int):
        """The static cache, sharded on heads under tensor parallelism:
        this rank's ``n_kv_heads / tp``."""
        c = self.model.config
        shape = (c.n_layers, batch, max_len,
                 c.n_kv_heads // self.model._tp_size, c.head_dim)
        return (torch.zeros(shape, dtype=self.dtype, device=self.device),
                torch.zeros(shape, dtype=self.dtype, device=self.device))

    def _prefill(self, tokens: torch.Tensor, caches):
        """Fill the cache at [0, s) and return the last position's fp32
        logits [b, vocab] (the head runs on the last position only)."""
        logits, caches = self.model.apply(tokens, params=self._view,
                                          kv_caches=caches, cache_pos=0,
                                          last_token_only=True)
        return logits[:, 0, :], caches

    def _step_logits(self, last_tokens: torch.Tensor, caches, pos: int):
        """One token per row at absolute position ``pos`` (RoPE uses it):
        fp32 logits [b, vocab]."""
        positions = torch.full((1, 1), pos, dtype=torch.long,
                               device=self.device)
        logits, caches = self.model.apply(
            last_tokens[:, None], positions=positions, params=self._view,
            kv_caches=caches, cache_pos=pos)
        return logits[:, 0, :], caches

    def _ids(self, input_ids) -> Tuple[np.ndarray, torch.Tensor]:
        ids = np.asarray(input_ids, dtype=np.int32)
        if ids.ndim != 2:
            raise ValueError(f"input_ids must be [b, s], got {ids.shape}")
        return ids, torch.from_numpy(ids.astype(np.int64)).to(self.device)

    def _check_len(self, max_len: int) -> None:
        if max_len > self.model.config.max_seq_len:
            raise ValueError(f"prompt+new tokens {max_len} exceeds model "
                             f"max_seq_len {self.model.config.max_seq_len}")

    # -- public API ------------------------------------------------------
    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens: int = 64,
                 eos_token_id: Optional[int] = None, num_beams: int = 1,
                 length_penalty: float = 1.0) -> np.ndarray:
        """Greedy (``temperature`` 0) or sampled decode, or beam search
        when ``num_beams`` > 1. input_ids: [b, s] (no padding). Rows that
        emit ``eos_token_id`` emit it from then on; the loop stops when
        every row has. Returns [b, s + generated] as numpy."""
        ids, tokens = self._ids(input_ids)
        if max_new_tokens <= 0:
            return ids
        if num_beams > 1:   # beam search is deterministic (sampling ignored)
            return self._generate_beam(ids, tokens, max_new_tokens,
                                       num_beams, eos_token_id,
                                       length_penalty)
        b, s = ids.shape
        self._check_len(s + max_new_tokens)
        cfg = self.config
        # request telemetry: TTFT and decode throughput, read at the host
        # copies the loop makes anyway (no extra device sync)
        from ..telemetry import get_telemetry

        telem = get_telemetry()
        t_start = time.perf_counter()
        caches = self._alloc_cache(b, s + max_new_tokens)
        logits, caches = self._prefill(tokens, caches)
        next_tok = _sample(logits, self._gen, cfg.temperature, cfg.top_k,
                           cfg.top_p)
        finished = np.zeros((b,), bool)
        step = next_tok.cpu().numpy()
        if eos_token_id is not None:
            finished |= step == eos_token_id
        out = [step]
        t_first = time.perf_counter()   # first token on the host
        n_generated = b   # real tokens produced (finished rows emit padding)
        pos = s
        for _ in range(max_new_tokens - 1):
            if finished.all():
                break
            n_generated += int(b - finished.sum())
            logits, caches = self._step_logits(next_tok, caches, pos)
            next_tok = _sample(logits, self._gen, cfg.temperature,
                               cfg.top_k, cfg.top_p)
            step = next_tok.cpu().numpy()
            if eos_token_id is not None:
                step = np.where(finished, eos_token_id, step)
                finished |= step == eos_token_id
                next_tok = torch.from_numpy(step).to(self.device)
            out.append(step)
            pos += 1
        if telem.enabled:
            t_end = time.perf_counter()
            decode_s = t_end - t_first
            n_decoded = n_generated - b
            telem.record_request(
                latency_s=t_end - t_start, ttft_s=t_first - t_start,
                new_tokens=n_generated,
                decode_tokens_per_s=(n_decoded / decode_s
                                     if n_decoded and decode_s > 0 else None))
        return np.concatenate([ids, np.stack(out, axis=1)], axis=1)

    def _beam_step(self, caches, last_tokens: torch.Tensor, pos: int,
                   scores: torch.Tensor, beams: int):
        """Flat [b * beams] last tokens and scores -> the top 2 * beams
        candidate (score, beams * V index) per row (HF's 2k trick)."""
        logits, caches = self._step_logits(last_tokens, caches, pos)
        logp = torch.log_softmax(logits.float(), dim=-1)
        V = logp.shape[-1]
        total = scores.reshape(-1, beams)[:, :, None] \
            + logp.reshape(-1, beams, V)
        top_scores, top_idx = torch.topk(total.reshape(-1, beams * V),
                                         2 * beams, dim=-1)
        return caches, top_scores, top_idx

    def _generate_beam(self, ids: np.ndarray, tokens: torch.Tensor,
                       max_new_tokens: int, num_beams: int,
                       eos_token_id: Optional[int],
                       length_penalty: float = 1.0) -> np.ndarray:
        """Deterministic beam search with HF ``generate(num_beams=N)``
        semantics, as the JAX engine's: per row, EOS candidates among the
        top 2k move to a finished-hypothesis pool (kept if the pool has
        room or they beat its worst entry), live beams refill to k from the
        rest, and rows stop when the pool is full and no live beam can
        still beat it. Scores normalise by generated length **
        length_penalty. The selection is host code in numpy."""
        k = num_beams
        b, s = ids.shape
        self._check_len(s + max_new_tokens)
        caches = self._alloc_cache(b, s + max_new_tokens)
        logits, caches = self._prefill(tokens, caches)
        logp0 = torch.log_softmax(logits.float(), dim=-1)       # [b, V]
        # expand the caches to [L, b * k, ...] after the (1x) prefill
        caches = tuple(c.repeat_interleave(k, dim=1) for c in caches)

        eos = eos_token_id
        lp = length_penalty
        V = self.model.config.vocab_size
        # pools[r]: finished hypotheses (sum_logprobs, generated tokens
        # without the closing eos, normalising length counting that eos)
        pools = [[] for _ in range(b)]
        done = np.zeros((b,), bool)
        live_scores = np.zeros((b, k), np.float32)
        live_seqs = np.zeros((b, k, 0), np.int64)

        def norm(score_sum, gen_len):
            return score_sum / float(gen_len) ** lp

        def select(cand_scores, cand_idx):
            nonlocal live_scores, live_seqs
            parents = np.zeros((b, k), np.int64)
            new_scores = live_scores.copy()
            new_tokens = np.zeros((b, k), np.int64)
            for r in range(b):
                if done[r]:
                    parents[r] = np.arange(k)   # frozen; results ignored
                    new_tokens[r] = eos if eos is not None else 0
                    continue
                filled = 0
                for rank, (sc, idx) in enumerate(zip(cand_scores[r],
                                                     cand_idx[r])):
                    parent, tok = divmod(int(idx), V)
                    if eos is not None and tok == eos:
                        if rank >= k:   # eos beyond the top-k ranks is
                            continue    # dropped, never pooled (HF)
                        hyp = live_seqs[r, parent].copy()
                        nl = len(hyp) + 1
                        if len(pools[r]) < k:
                            pools[r].append((float(sc), hyp, nl))
                        else:
                            worst_i = min(range(k), key=lambda i: norm(
                                pools[r][i][0], pools[r][i][2]))
                            if norm(float(sc), nl) > norm(
                                    pools[r][worst_i][0],
                                    pools[r][worst_i][2]):
                                pools[r][worst_i] = (float(sc), hyp, nl)
                        continue
                    parents[r, filled] = parent
                    new_scores[r, filled] = sc
                    new_tokens[r, filled] = tok
                    filled += 1
                    if filled == k:
                        break
            live_scores = new_scores
            live_seqs = np.take_along_axis(live_seqs, parents[:, :, None],
                                           axis=1)
            live_seqs = np.concatenate([live_seqs, new_tokens[:, :, None]],
                                       axis=2)
            if eos is not None:
                cur = live_seqs.shape[2]
                for r in range(b):
                    if not done[r] and len(pools[r]) >= k:
                        # early_stopping=False heuristic (HF): stop when the
                        # best running beam cannot beat the pool's worst
                        worst = min(norm(sc, nl) for sc, _, nl in pools[r])
                        done[r] = worst >= norm(float(live_scores[r, 0]),
                                                cur)
            return parents

        # first step: every beam is identical, so the top 2k of the
        # prefill logits are the candidates
        cs0, ci0 = torch.topk(logp0, 2 * k, dim=-1)
        select(cs0.cpu().numpy(), ci0.cpu().numpy())

        pos = s
        for _ in range(max_new_tokens - 1):
            if done.all():
                break
            caches, cand_scores, cand_idx = self._beam_step(
                caches,
                torch.from_numpy(live_seqs[:, :, -1].reshape(-1)).to(
                    self.device),
                pos,
                torch.from_numpy(live_scores.reshape(-1)).to(self.device),
                k)
            parents = select(cand_scores.cpu().numpy(),
                             cand_idx.cpu().numpy())
            flat_parent = (np.arange(b)[:, None] * k + parents).reshape(-1)
            if not (flat_parent == np.arange(b * k)).all():
                idx = torch.from_numpy(flat_parent).to(self.device)
                caches = tuple(c[:, idx] for c in caches)
            pos += 1

        # finalise (HF): open rows add their live beams to the pool; the
        # output is the generation (+ closing eos if finished), eos-padded
        out = np.full((b, max_new_tokens),
                      eos if eos is not None else 0, np.int64)
        longest = 0
        for r in range(b):
            hyps = [(sc, g, nl, True) for sc, g, nl in pools[r]]
            if len(pools[r]) < k or not done[r]:
                hyps += [(float(live_scores[r, j]), live_seqs[r, j],
                          live_seqs.shape[2], False) for j in range(k)]
            best = max(hyps, key=lambda h: norm(h[0], h[2]))
            gen = np.asarray(best[1], np.int64)
            if best[3] and eos is not None and len(gen) < max_new_tokens:
                gen = np.append(gen, eos)
            gen = gen[:max_new_tokens]
            out[r, : len(gen)] = gen
            longest = max(longest, len(gen))
        # crop to the longest generation (earlier-finished rows eos-padded)
        return np.concatenate([ids, out[:, :longest]], axis=1)

    @torch.inference_mode()
    def forward(self, input_ids, **kw) -> torch.Tensor:
        """Raw fp32 logits [b, s, vocab] of ``input_ids`` [b, s]."""
        _, tokens = self._ids(input_ids)
        return self.model.apply(tokens, params=self._view, **kw)

    __call__ = forward


def _filter_logits(logits: torch.Tensor, temperature: float, top_k: int,
                   top_p: float) -> torch.Tensor:
    """Temperature scaling, then the top-k and top-p (nucleus) masks with
    -inf, as the JAX ``_sample`` builds them."""
    logits = logits / max(float(temperature), 1e-6)
    neg_inf = torch.tensor(float("-inf"), dtype=logits.dtype,
                           device=logits.device)
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, neg_inf, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = torch.sum(cum < top_p, dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1,
                              cutoff_idx.clamp(max=logits.shape[-1] - 1))
        logits = torch.where(logits < cutoff, neg_inf, logits)
    return logits


def _sample(logits: torch.Tensor, generator: torch.Generator,
            temperature: float, top_k: int, top_p: float) -> torch.Tensor:
    """Greedy when temperature == 0, else a draw from the filtered logits
    with ``generator`` (PyTorch's stream, not JAX's: the two frameworks
    draw different numbers from one seed). -> int32 [b].

    The draw is ``torch.multinomial``'s for one sample, argmax(p / E) with
    E ~ Exp(1) from ``generator``, written out without multinomial's
    validity check: that check reads a value back to the host, and a
    sampled decode chunk must not wait on the host at every step."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(_filter_logits(logits.float(), temperature, top_k,
                                         top_p), dim=-1)
    race = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return torch.argmax(probs / race, dim=-1).to(torch.int32)
