"""Decoder-only transformer core, as a PyTorch module.

Ports ``deepspeed_tpu/models/transformer.py`` for the Llama flag set: RMSNorm,
gated-SiLU MLP, RoPE (half-split or interleaved, optional partial
``rotary_dim``), GQA, pre-norm, untied LM head, no biases. Other flags
raise ``NotImplementedError``; their families come in later slices.

Weight layout: the JAX package's ``[in, out]`` for ``h @ W`` (``wq`` is
``[d_model, n_heads * head_dim]``, ``lm_head`` is ``[d_model, vocab]``), so
a carried JAX parameter tree loads without transposes
(:mod:`deepspeed_tpu_torch.checkpoint.jax_params`). The JAX package stacks
layer leaves ``[n_layers, ...]``; here each layer is a :class:`Block` in
``Transformer.layers`` holding the same leaf names.

Two paths share the weights:

* serving: the ragged engine (:mod:`deepspeed_tpu_torch.inference.ragged`)
  runs the attention block itself over the paged KV pool and calls
  :meth:`Transformer._embed`, :meth:`Transformer._mlp` and
  :meth:`Transformer._head`, under ``torch.inference_mode()``;
* training: :meth:`Transformer.apply` and :meth:`Transformer.loss`, the
  dense path. Like the JAX package's functional ``apply(params, ...)``,
  they take an optional ``params`` dict (``{name: tensor}`` with the names
  of ``named_parameters()``), so the trainer runs the model on its
  compute-dtype copy of the master weights. Each layer runs under
  ``torch.utils.checkpoint`` when ``remat`` is on, with its weights passed
  in explicitly, so the backward pass replays it on the same tensors.
  Attention is :func:`~deepspeed_tpu_torch.ops.attention.flash_attention`
  (``use_flash``) or the plain ``dot_product_attention``;
* generation: the KV-cache branch of :meth:`Transformer.apply`, which the
  v1 inference engine (:mod:`deepspeed_tpu_torch.inference.engine`) runs
  over a static cache. The new K/V are written into the cache in place at
  ``cache_pos``, and attention is the plain ``dot_product_attention`` over
  the whole cache, as in the JAX package. Layer leaves are read from
  ``params`` one layer at a time, just before the layer runs, so a mapping
  that makes a leaf when it is read (the engine's dequantizing view) holds
  one layer's weights at a time.

Tensor parallelism (``bind_topology`` with a ``model`` axis above 1, after
:meth:`Transformer.shard_` cut this rank's leaves): the JAX package's
Megatron layout (:meth:`Transformer.partition_specs`), made explicit
where GSPMD inserts the collectives. A rank holds ``n_heads / tp`` query
and ``n_kv_heads / tp`` KV heads (column-parallel ``wq`` / ``wk`` /
``wv`` / ``w_gate`` / ``w_up``), the matching rows of the row-parallel
``wo`` / ``w_down``, whose partial products are summed over the model
group, and ``vocab / tp`` rows of ``tok_embed`` and columns of
``lm_head``: the embedding is a masked lookup of the local rows summed
over the group (the JAX one-hot contraction, bit for bit: each row has
one non-zero), and the head's fp32 logit columns are gathered in rank
order. With a fused comm backend bound (``bind_comm_backend``, by the
v1 engine), a one-position decode step's down-projection runs as the
backend's ``matmul_all_reduce`` (:meth:`Transformer._down_proj`).

Sequence parallelism, ALiBi, encoder masks and sliding windows on the
KV-cache path come with later slices.

The module's own parameters never require grad (serving needs none); the
trainer's compute copy does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..comm import comm
from ..ops.attention import dot_product_attention, flash_attention
from ..ops.norms import rms_norm
from ..ops.rotary import apply_rotary, rope_frequencies
from ..parallel.mesh import PartitionSpec as P, shard_slices
from ..runtime.activation_checkpointing import checkpoint_wrapper
from ..utils.device import resolve_device

Params = Dict[str, torch.Tensor]
LAYER_LEAVES = ("attn_norm_w", "wq", "wk", "wv", "wo", "mlp_norm_w",
                "w_gate", "w_up", "w_down")


@dataclass
class TransformerConfig:
    """Copy of the JAX package's config dataclass (same fields and
    defaults), so the two build from the same presets and overrides."""

    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: Optional[int] = None  # GQA; None => MHA
    d_ff: Optional[int] = None        # default 4*d (gelu) or 8/3*d rounded (glu)
    max_seq_len: int = 2048
    norm: str = "rms"                 # rms | layer
    activation: str = "silu_glu"      # silu_glu | gelu | relu
    position: str = "rope"            # rope | learned
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    use_bias: bool = False
    norm_eps: float = 1e-6
    remat: bool = True                # training knobs: no effect on serving
    remat_policy: str = "full"
    use_flash: bool = True
    logits_softcap: float = 0.0
    z_loss: float = 0.0
    loss_chunk_size: int = 0
    sp_attention: str = "auto"
    rope_pct: float = 1.0             # fraction of head_dim rotated (NeoX)
    rope_interleaved: bool = False    # GPT-J pairing instead of half-split
    parallel_residual: bool = False
    embed_norm: bool = False
    causal: bool = True
    prenorm: bool = True
    type_vocab_size: int = 0
    mlm_head: bool = False
    pooler: bool = False
    attn_windows: Optional[Tuple[int, ...]] = None
    attn_scale: Optional[float] = None
    qkv_bias: Optional[bool] = None
    attn_o_bias: Optional[bool] = None

    def __post_init__(self):
        if self.n_kv_heads is None:
            self.n_kv_heads = self.n_heads
        if self.qkv_bias is None:
            self.qkv_bias = self.use_bias
        if self.attn_o_bias is None:
            self.attn_o_bias = self.use_bias
        if self.attn_windows is not None:
            self.attn_windows = tuple(int(w) for w in self.attn_windows)
            if len(self.attn_windows) != self.n_layers:
                raise ValueError(
                    f"attn_windows has {len(self.attn_windows)} entries for "
                    f"{self.n_layers} layers")
            if not self.causal:
                raise ValueError("attn_windows requires a causal model "
                                 "(sliding windows are a decoder feature)")
        if self.d_ff is None:
            if self.activation == "silu_glu":
                self.d_ff = int(8 * self.d_model / 3 / 128 + 1) * 128
            else:
                self.d_ff = 4 * self.d_model
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} is not a multiple of "
                             f"n_heads {self.n_heads}")

    def window_binds(self, length: int) -> bool:
        """True if any per-layer sliding window actually trims attention
        at this sequence/context length (w == length attends everything)."""
        return self.attn_windows is not None \
            and any(0 < w < length for w in self.attn_windows)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def rotary_dim(self) -> int:
        """Rotated dims per head (GPT-NeoX rope_pct), even-rounded."""
        return int(self.head_dim * self.rope_pct) // 2 * 2

    def _shared_param_count(self) -> int:
        """Attention + norms + embeddings (everything but the FFN)."""
        d, v, n = self.d_model, self.vocab_size, self.n_layers
        hd = self.head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        if self.qkv_bias:
            attn += self.n_heads * hd + 2 * self.n_kv_heads * hd
        if self.attn_o_bias:
            attn += d
        norms = (2 * d) * n + (d if self.prenorm else 0)
        if self.norm == "layer":
            norms *= 2  # weights + biases
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.position == "learned":
            emb += self.max_seq_len * d
        emb += self.type_vocab_size * d
        if self.embed_norm:
            emb += 2 * d
        head = 0
        if self.mlm_head:
            head += d * d + d + 2 * d + v  # transform + LN + decoder bias
        if self.pooler:
            head += d * d + d
        return n * attn + norms + emb + head

    def param_count(self) -> int:
        d, f, n = self.d_model, self.d_ff, self.n_layers
        mlp = (3 if self.activation == "silu_glu" else 2) * d * f
        if self.use_bias:
            mlp += f + d
        return self._shared_param_count() + n * mlp

    def _attn_flop_len(self, seq_len: int) -> int:
        """Summed per-layer attention lengths: sliding-window layers attend
        at most ``window`` keys, so min(seq, window)."""
        if self.attn_windows is not None:
            return sum(min(seq_len, w) if w > 0 else seq_len
                       for w in self.attn_windows)
        return self.n_layers * seq_len

    def flops_per_token(self, seq_len: int) -> float:
        """Forward+backward FLOPs/token (standard 6N + attention term)."""
        return 6.0 * self.param_count() \
            + 12.0 * self.d_model * self._attn_flop_len(seq_len)


def _check_supported(c: TransformerConfig) -> None:
    """The Llama flag set only; everything else belongs to a later slice."""
    unsupported = {
        "norm": c.norm != "rms", "activation": c.activation != "silu_glu",
        "position": c.position != "rope", "tie_embeddings": c.tie_embeddings,
        "use_bias": c.use_bias, "qkv_bias": c.qkv_bias,
        "attn_o_bias": c.attn_o_bias, "parallel_residual": c.parallel_residual,
        "embed_norm": c.embed_norm, "causal": not c.causal,
        "prenorm": not c.prenorm, "type_vocab_size": c.type_vocab_size > 0,
        "mlm_head": c.mlm_head, "pooler": c.pooler,
        "attn_scale": c.attn_scale is not None,
        "logits_softcap": c.logits_softcap != 0.0,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"deepspeed_tpu_torch ports the Llama flag set (rms, silu_glu, "
            f"rope, untied head, no bias, pre-norm); {bad} come with their "
            f"model families in a later slice (ROADMAP.md, Queue A)")


class Block(nn.Module):
    """One decoder layer's parameters, named as the JAX leaves, ``[in,
    out]`` layout."""

    def __init__(self, c: TransformerConfig, device, dtype):
        super().__init__()
        hd, d, f = c.head_dim, c.d_model, c.d_ff

        def p(*shape):
            return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                                requires_grad=False)

        self.attn_norm_w = p(d)
        self.wq = p(d, c.n_heads * hd)
        self.wk = p(d, c.n_kv_heads * hd)
        self.wv = p(d, c.n_kv_heads * hd)
        self.wo = p(c.n_heads * hd, d)
        self.mlp_norm_w = p(d)
        self.w_gate = p(d, f)
        self.w_up = p(d, f)
        self.w_down = p(f, d)

    def __getitem__(self, name: str) -> torch.Tensor:
        """``block["wq"]``: a Block reads like the dict of one layer's
        leaves that the training path passes around."""
        return getattr(self, name)


class Transformer(nn.Module):
    """Llama-style decoder. ``device`` defaults to ``"cuda"`` and raises
    without a CUDA device unless ``device="cpu"`` is asked for. Weights
    are made with :meth:`init` from ``seed`` (a seeded ``torch.Generator``
    on the model's device), or loaded from a JAX tree with
    :func:`~deepspeed_tpu_torch.checkpoint.jax_params.load_jax_params`."""

    def __init__(self, config: TransformerConfig, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        _check_supported(config)
        dev = resolve_device(device)
        self.config = c = config

        def p(*shape):
            return nn.Parameter(torch.empty(shape, device=dev, dtype=dtype),
                                requires_grad=False)

        self.tok_embed = p(c.vocab_size, c.d_model)
        self.layers = nn.ModuleList(Block(c, dev, dtype)
                                    for _ in range(c.n_layers))
        self.final_norm_w = p(c.d_model)
        self.lm_head = p(c.d_model, c.vocab_size)
        self.init(seed)
        # tensor parallelism (bind_topology / bind_comm_backend)
        self._topo = None
        self._tp_size, self._tp_rank = 1, 0
        self._comm_backend = None

    @property
    def device(self) -> torch.device:
        return self.tok_embed.device

    # -- tensor parallelism --------------------------------------------
    def partition_specs(self, params: Any = None, topo: Any = None
                        ) -> Dict[str, Any]:
        """The JAX package's tensor-parallel PartitionSpecs of the Llama
        flag set, key for key, over its stacked tree (layer leaves ``[
        n_layers, ...]``, so a layer spec leads with the layer dim):
        column-parallel QKV / gate / up, row-parallel O / down, the
        vocab-sharded embedding and head. ``params`` and ``topo`` are
        taken for the JAX signature; no pipe axis is ported."""
        layers = {"attn_norm_w": P(None, None), "wq": P(None, None, "model"),
                  "wk": P(None, None, "model"), "wv": P(None, None, "model"),
                  "wo": P(None, "model", None), "mlp_norm_w": P(None, None),
                  "w_up": P(None, None, "model"),
                  "w_down": P(None, "model", None),
                  "w_gate": P(None, None, "model")}
        return {"tok_embed": P("model", None), "layers": layers,
                "final_norm_w": P(None), "lm_head": P(None, "model")}

    def leaf_spec(self, name: str) -> P:
        """The spec of one of ``named_parameters()``'s leaves (a layer
        leaf's without the stacked layer dim)."""
        specs = self.partition_specs()
        if name.startswith("layers."):
            return P(*specs["layers"][name.split(".")[-1]][1:])
        return specs[name]

    def local_shard(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a full-width leaf ``name`` (a view)."""
        return t[shard_slices(t.shape, self.leaf_spec(name), self._tp_size,
                              self._tp_rank)]

    @torch.no_grad()
    def shard_(self, topo) -> "Transformer":
        """Cut every leaf to this rank's shard over ``topo``'s model axis,
        in place (each leaf is replaced by a copy of its slice, so the
        full-width tensor is freed), and bind the topology. The heads,
        ``d_ff`` and the vocab must divide by the axis."""
        c = self.config
        tp = topo.model_parallel_size
        if self._tp_size > 1:
            raise ValueError("the model is already sharded")
        for what, n in (("n_heads", c.n_heads), ("n_kv_heads", c.n_kv_heads),
                        ("d_ff", c.d_ff), ("vocab_size", c.vocab_size)):
            if n % tp:
                raise ValueError(f"{what} {n} not divisible by the model "
                                 f"axis {tp}")
        self.bind_topology(topo)
        for name, p in self.named_parameters():
            p.data = self.local_shard(name, p.data).clone()
        return self

    def bind_topology(self, topo) -> "Transformer":
        """Attach the mesh whose ``model`` axis this rank's leaves are
        sharded over (:meth:`shard_` cuts them)."""
        self._topo = topo
        self._tp_size = topo.model_parallel_size
        self._tp_rank = topo.rank("model")
        return self

    def bind_comm_backend(self, backend) -> "Transformer":
        """Attach a fused comm backend (``comm/backends.py``): a decode
        step's MLP down-projection then runs as its ``matmul_all_reduce``
        (:meth:`_down_proj`). The v1 engine binds it under tensor
        parallelism when its ``kernel_backend`` resolves to the fused
        backend."""
        self._comm_backend = backend
        return self

    def _group(self):
        return self._topo.group("model")

    def _all_reduce(self, y: torch.Tensor) -> torch.Tensor:
        """The model group's sum of a row-parallel partial product (the
        psum GSPMD inserts); ``y`` itself without tensor parallelism."""
        if self._tp_size <= 1:
            return y
        nbytes = y.numel() * y.element_size()
        comm.record_collective("all_reduce", nbytes, nbytes, "model",
                               self._tp_size)
        return comm.all_reduce(y, group=self._group())

    def _row_parallel(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``a @ w`` for a weight sharded on its input rows: the partial
        products summed over the model group. The partials stay fp32
        through the sum (exact products, fp32 accumulation: ``torch.mm``
        with an fp32 output on the card, fp32 operands on the CPU) and
        are rounded to ``a``'s dtype once, as one device's full-width
        matmul rounds its sum. Without tensor parallelism, ``a @ w``."""
        if self._tp_size <= 1:
            return a @ w
        flat = a.reshape(-1, a.shape[-1])
        if a.is_cuda and a.dtype != torch.float32:
            y = torch.mm(flat, w, out_dtype=torch.float32)
        else:
            y = flat.float() @ w.float()
        y = self._all_reduce(y).to(a.dtype)
        return y.reshape(*a.shape[:-1], w.shape[-1])

    @torch.no_grad()
    def init(self, seed: int = 0) -> "Transformer":
        """Fill every weight in place from a ``torch.Generator`` seeded
        with ``seed``, with the JAX package's scheme: dense weights
        ~ N(0, 1/fan_in), ``wo`` ~ N(0, 1/(2 d n_layers)), ``w_down``
        ~ N(0, 1/(2 d_ff n_layers)), embeddings ~ N(0, 0.02^2), norms 1.
        (The two frameworks draw different numbers from one seed; tests
        carry JAX weights across instead.)"""
        c = self.config
        gen = torch.Generator(device=self.device).manual_seed(seed)

        def normal_(w, std):
            w.copy_(torch.randn(w.shape, generator=gen, device=self.device,
                                dtype=torch.float32).mul_(std))

        n = c.n_layers
        for blk in self.layers:
            blk.attn_norm_w.fill_(1.0)
            blk.mlp_norm_w.fill_(1.0)
            for name in ("wq", "wk", "wv", "w_gate", "w_up"):
                w = getattr(blk, name)
                normal_(w, 1.0 / math.sqrt(w.shape[0]))
            normal_(blk.wo, 1.0 / math.sqrt(c.d_model * 2 * n))
            normal_(blk.w_down, 1.0 / math.sqrt(c.d_ff * 2 * n))
        normal_(self.tok_embed, 0.02)
        self.final_norm_w.fill_(1.0)
        normal_(self.lm_head, 1.0 / math.sqrt(c.d_model))
        return self

    # ------------------------------------------------------------------
    def _params(self, params: Optional[Mapping[str, torch.Tensor]]
                ) -> Mapping[str, torch.Tensor]:
        return dict(self.named_parameters()) if params is None else params

    def forward(self, tokens, positions=None, return_hidden: bool = False,
                params: Optional[Params] = None, kv_caches=None,
                cache_pos: Optional[int] = None,
                last_token_only: bool = False):
        return self.apply(tokens, positions, return_hidden, params=params,
                          kv_caches=kv_caches, cache_pos=cache_pos,
                          last_token_only=last_token_only)

    def apply(self, tokens: torch.Tensor, positions=None,
              return_hidden: bool = False, *,
              params: Optional[Mapping[str, torch.Tensor]] = None,
              kv_caches=None, cache_pos: Optional[int] = None,
              last_token_only: bool = False):
        """Forward. tokens: [b, s] int -> fp32 logits [b, s, vocab], or the
        pre-head hidden states [b, s, d] with ``return_hidden``. ``params``
        (default: the module's own) maps the names of
        ``named_parameters()`` to tensors; the compute dtype is its
        ``compute_dtype`` attribute where it has one, else its ``wq``'s.

        ``kv_caches``: a ``(k, v)`` pair, each a stacked ``[n_layers, b,
        max_len, hkv, hd]`` tensor or a sequence of per-layer ``[b,
        max_len, hkv, hd]`` tensors. This step's K/V are written into them
        in place at ``cache_pos`` (an int), query i attends cache slots
        ``k <= cache_pos + i``, and ``(out, kv_caches)`` is returned.
        ``positions`` (default ``0..s-1``) are the RoPE positions; decode
        passes the absolute ones. ``last_token_only`` keeps only the last
        position before the head."""
        p = self._params(params)
        c = self.config
        x = self._embed(tokens, p)
        angles = rope_frequencies(c.rotary_dim, c.max_seq_len, c.rope_theta,
                                  device=x.device)
        if kv_caches is None:
            x = self._encode(p, x, angles, positions)
        else:
            x = self._cached_layers(p, x, angles, positions, kv_caches,
                                    cache_pos)
        if last_token_only:
            x = x[:, -1:]
        out = x if return_hidden else self._head(x, p)
        return out if kv_caches is None else (out, kv_caches)

    def _cached_layers(self, p, x, angles, positions, kv_caches,
                       cache_pos: Optional[int]) -> torch.Tensor:
        """The layer stack of the KV-cache branch (JAX ``apply`` with
        ``kv_caches``): each layer's leaves are read just before it runs."""
        c = self.config
        if c.attn_windows is not None and any(w > 0 for w in c.attn_windows):
            raise NotImplementedError(
                "sliding windows on the KV-cache path come with a later "
                "slice (ROADMAP.md, Queue A)")
        ks, vs = kv_caches
        if cache_pos is None:
            raise ValueError("kv_caches needs cache_pos")
        max_len = ks[0].shape[1]
        if not 0 <= int(cache_pos) <= max_len - x.shape[1]:
            raise ValueError(f"cache_pos {cache_pos} + {x.shape[1]} tokens "
                             f"does not fit a cache of {max_len} slots")
        for i in range(c.n_layers):
            lp = {n: p[f"layers.{i}.{n}"] for n in LAYER_LEAVES}
            x = self._block(x, lp, angles, positions,
                            kv_cache=(ks[i], vs[i], int(cache_pos)))
        return x

    def _static_window(self, length: int) -> int:
        """The uniform sliding window that binds at this length, else 0
        (per-layer-varying windows are a later slice's)."""
        c = self.config
        if not c.window_binds(length):
            return 0
        if len(set(c.attn_windows)) != 1:
            raise NotImplementedError(
                "per-layer-varying attention windows in the dense path come "
                "with a later slice (ROADMAP.md, Queue A)")
        return int(c.attn_windows[0])

    def _block(self, x: torch.Tensor, lp: Mapping[str, torch.Tensor],
               angles: torch.Tensor, positions=None,
               window: int = 0, kv_cache=None) -> torch.Tensor:
        """One pre-norm decoder layer. x: [b, s, d]; ``lp`` maps the leaf
        names of :data:`LAYER_LEAVES` to this layer's weights. With
        ``kv_cache`` = (k cache, v cache, cache_pos), this step's K/V are
        written into the caches in place and attention runs over them."""
        c = self.config
        hd = c.head_dim
        b, s, _ = x.shape
        # this rank's heads (all of them without tensor parallelism)
        hq, hkv = c.n_heads // self._tp_size, c.n_kv_heads // self._tp_size
        h = rms_norm(x, lp["attn_norm_w"], c.norm_eps)
        q = (h @ lp["wq"]).reshape(b, s, hq, hd)
        kk = (h @ lp["wk"]).reshape(b, s, hkv, hd)
        vv = (h @ lp["wv"]).reshape(b, s, hkv, hd)
        q = apply_rotary(q, angles, positions, rotary_dim=c.rotary_dim,
                         interleaved=c.rope_interleaved)
        kk = apply_rotary(kk, angles, positions, rotary_dim=c.rotary_dim,
                          interleaved=c.rope_interleaved)
        if kv_cache is not None:
            ck, cv, pos0 = kv_cache
            ck[:, pos0:pos0 + s] = kk
            cv[:, pos0:pos0 + s] = vv
            # query i sits at absolute position pos0 + i and sees every
            # cache slot up to itself (which also masks the unwritten tail)
            q_abs = pos0 + torch.arange(s, device=x.device)
            k_pos = torch.arange(ck.shape[1], device=x.device)
            mask = k_pos[None, :] <= q_abs[:, None]
            attn = dot_product_attention(q, ck, cv, causal=False,
                                         mask=mask[None, None],
                                         scale=c.attn_scale)
        else:
            attend = flash_attention if c.use_flash else dot_product_attention
            attn = attend(q, kk, vv, causal=True, scale=c.attn_scale,
                          window=window)
        x = x + self._row_parallel(attn.reshape(b, s, hq * hd), lp["wo"])
        h = rms_norm(x, lp["mlp_norm_w"], c.norm_eps)
        return x + self._mlp(h, lp)

    def _encode(self, p: Mapping[str, torch.Tensor], x: torch.Tensor,
                angles: torch.Tensor, positions=None) -> torch.Tensor:
        """The layer stack over embedded inputs x: [b, s, d]. With
        ``remat`` (and autograd recording), each layer runs under
        :func:`~deepspeed_tpu_torch.runtime.activation_checkpointing.checkpoint_wrapper`
        with ``remat_policy``: only its input is kept, and the backward
        pass runs it again."""
        c = self.config
        window = self._static_window(x.shape[1])

        def block(x, *leaves):
            return self._block(x, dict(zip(LAYER_LEAVES, leaves)), angles,
                               positions, window)

        if c.remat and torch.is_grad_enabled():
            block = checkpoint_wrapper(block, policy=c.remat_policy)
        for i in range(c.n_layers):
            x = block(x, *(p[f"layers.{i}.{n}"] for n in LAYER_LEAVES))
        return x

    # ------------------------------------------------------------------
    def _targets_from_batch(self, batch: Mapping[str, Any]):
        """(inputs, targets, mask) for next-token CE. batch:
        {"input_ids": [b, s]} with optional "labels" (shifted internally
        when absent) and "loss_mask". The shift keeps the full length and
        masks the last position instead of slicing."""
        tokens = batch["input_ids"]
        if "labels" in batch:
            mask = batch.get("loss_mask")
            return tokens, batch["labels"], (None if mask is None
                                              else mask.float())
        targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
        last_off = torch.ones(tokens.shape, dtype=torch.float32,
                              device=tokens.device)
        last_off[:, -1] = 0.0
        mask = batch.get("loss_mask")
        mask = last_off if mask is None else mask.float() * last_off
        return tokens, targets, mask

    def _ce_terms(self, logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor]):
        """(weighted nll sum, weight sum, z-loss sum) of one [b, s, v]
        fp32 logits block."""
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
        if mask is not None:
            mask = mask[:, : nll.shape[1]].float()
            nll_sum = torch.sum(nll * mask)
            denom = torch.sum(mask)
        else:
            nll_sum = torch.sum(nll)
            denom = torch.tensor(float(nll.numel()), device=nll.device)
        z_sum = torch.zeros([], device=nll.device)
        if self.config.z_loss > 0:
            z = torch.square(torch.logsumexp(logits, dim=-1))
            if mask is not None:
                z = z * mask
            z_sum = torch.sum(z)
        return nll_sum, denom, z_sum

    def loss(self, batch: Mapping[str, Any],
             params: Optional[Params] = None) -> torch.Tensor:
        """Next-token cross entropy (+ z-loss), a 0-dim fp32 tensor. With
        ``loss_chunk_size`` > 0 the head and CE run over token chunks, each
        recomputed in the backward pass, so the full fp32 logits never
        exist at once."""
        p = self._params(params)
        inputs, targets, mask = self._targets_from_batch(batch)
        cs = self.config.loss_chunk_size
        if cs > 0:
            x = self.apply(inputs, return_hidden=True, params=p)
            nll_sum, denom, z_sum = self._ce_chunked(p, x, targets, mask, cs)
        else:
            logits = self.apply(inputs, params=p)
            nll_sum, denom, z_sum = self._ce_terms(logits, targets, mask)
        denom = torch.clamp(denom, min=1.0)
        loss = nll_sum / denom
        if self.config.z_loss > 0:
            loss = loss + self.config.z_loss * z_sum / denom
        return loss

    def _ce_chunked(self, p, x, targets, mask, chunk: int):
        """Head + CE over flattened token chunks of ``chunk`` rows, each
        under a checkpoint: the backward pass recomputes a chunk's logits
        from its [chunk, d] hidden slice instead of storing them."""
        d = x.shape[-1]
        xf = x.reshape(-1, d)
        tf = targets.reshape(-1)
        mf = torch.ones(tf.shape, dtype=torch.float32, device=x.device) \
            if mask is None else mask.reshape(-1).float()

        def body(xc, tc, mc):
            logits = self._head(xc[None], p)          # [1, chunk, vocab]
            return torch.stack(self._ce_terms(logits, tc[None], mc[None]))

        if torch.is_grad_enabled():
            body = checkpoint_wrapper(body, policy="full")
        sums = torch.zeros(3, device=x.device)
        for i in range(0, xf.shape[0], chunk):
            sums = sums + body(xf[i:i + chunk], tf[i:i + chunk],
                               mf[i:i + chunk])
        return sums[0], sums[1], sums[2]

    # ------------------------------------------------------------------
    def _embed(self, tokens: torch.Tensor,
               params: Optional[Mapping[str, torch.Tensor]] = None
               ) -> torch.Tensor:
        """Token embedding: [..., s] -> [..., s, d] in the compute dtype
        (``params.compute_dtype`` where the mapping has one, so that no
        layer leaf is read for it; else the dtype of ``wq``)."""
        p = self._params(params)
        dtype = getattr(p, "compute_dtype", None) or p["layers.0.wq"].dtype
        table = p["tok_embed"]
        if self._tp_size <= 1:
            return F.embedding(tokens.long(), table).to(dtype)
        # vocab-parallel: this rank's rows, zeros for the other ranks'
        # ids, summed over the group. Ids are clipped to the vocab first,
        # as the JAX one-hot path does
        rows = table.shape[0]
        ids = tokens.long().clamp(0, self.config.vocab_size - 1) \
            - self._tp_rank * rows
        mine = (ids >= 0) & (ids < rows)
        x = F.embedding(ids.clamp(0, rows - 1), table).to(dtype)
        x = torch.where(mine[..., None], x, torch.zeros((), dtype=dtype,
                                                        device=x.device))
        return self._all_reduce(x)

    def _mlp(self, h: torch.Tensor, lp) -> torch.Tensor:
        """Gated-SiLU FFN: (silu(h @ w_gate) * (h @ w_up)) @ w_down. ``lp``
        is a :class:`Block` or a dict of one layer's leaves."""
        up = F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])
        return self._down_proj(up, lp["w_down"])

    def _down_proj(self, up: torch.Tensor, w_down: torch.Tensor
                   ) -> torch.Tensor:
        """Row-parallel MLP down-projection, as the JAX package's: with a
        fused backend bound under tensor parallelism and one query
        position in flight (``up`` ``[b, 1, f / tp]``, a v1 decode step),
        the partial matmul and its all-reduce run as the backend's
        ``matmul_all_reduce``; every other shape (prefill, the ragged
        engine's ``[T, f / tp]`` lanes) is a plain matmul followed by the
        model group's all-reduce (:meth:`_row_parallel`)."""
        backend = self._comm_backend
        if (backend is None or self._tp_size <= 1 or up.dim() != 3
                or up.shape[1] != 1):
            return self._row_parallel(up, w_down)
        b, _, f = up.shape
        y = backend.matmul_all_reduce(up.reshape(b, f), w_down, "model",
                                      out_dtype=up.dtype)
        return y.reshape(b, 1, w_down.shape[-1])

    def _head(self, x: torch.Tensor,
              params: Optional[Mapping[str, torch.Tensor]] = None
              ) -> torch.Tensor:
        """Final norm + LM head: [..., d] -> fp32 logits [..., vocab].
        Under tensor parallelism each rank computes its vocab columns and
        the group gathers them in rank order."""
        p = self._params(params)
        x = rms_norm(x, p["final_norm_w"], self.config.norm_eps)
        logits = (x @ p["lm_head"].to(x.dtype)).float()
        if self._tp_size > 1:
            logits = comm.all_gather_columns(logits, self._group(), "model")
        return logits
