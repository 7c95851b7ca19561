"""Transformer core (decoders and encoders), as a PyTorch module.

Ports ``deepspeed_tpu/models/transformer.py`` for every flag of its
config: RMSNorm or LayerNorm (with biases), gated-SiLU or a GELU (tanh
form, ``gelu_exact``) / ReLU / ``quick_gelu`` MLP, RoPE (half-split or
interleaved, optional partial ``rotary_dim``), learned positions, ALiBi
or none (``position="none"``, CLIP's vision tower), GQA, qkv / o / MLP
biases, tied or untied head, ``logits_softcap``, ``attn_scale``,
``parallel_residual``, ``embed_norm`` and per-layer sliding windows
(Llama, GPT-2, OPT, GPT-Neo, GPT-J and Bloom-style flag sets), and the
encoder flags: bidirectional attention (``causal=False``, with an
optional ``[b, s]`` padding ``attn_mask``), post-LN blocks
(``prenorm=False``: the norm after each residual add, no final norm),
segment embeddings (``type_vocab_size``), BERT's MLM head (``mlm_head``)
and the ``[CLS]`` tanh ``pooler`` (BERT, DistilBERT, CLIP's towers).

Weight layout: the JAX package's ``[in, out]`` for ``h @ W`` (``wq`` is
``[d_model, n_heads * head_dim]``, ``lm_head`` is ``[d_model, vocab]``), so
a carried JAX parameter tree loads without transposes
(:mod:`deepspeed_tpu_torch.checkpoint.jax_params`). The JAX package stacks
layer leaves ``[n_layers, ...]``; here each layer is a :class:`Block` in
``Transformer.layers`` holding the same leaf names, those the config
implies (:func:`layer_leaves`, :func:`top_leaves`): a tied model has no
``lm_head``, a model without ``silu_glu`` no ``w_gate``.

The FFN is :meth:`Transformer._mlp`, which returns ``(out, aux loss)``
as the JAX package's does; an MoE model (:mod:`.moe`) overrides it with
its routed expert bank, and the training flags of :meth:`apply`
(``training``, ``generator``, ``return_aux``) reach it from
:meth:`loss`.

Three paths share the weights:

* serving: the ragged engine (:mod:`deepspeed_tpu_torch.inference.ragged`)
  runs the attention block itself over the paged KV pool and calls
  :meth:`Transformer._embed`, :meth:`Transformer._norm`,
  :meth:`Transformer._mlp` and :meth:`Transformer._head`, under
  ``torch.inference_mode()``;
* training: :meth:`Transformer.apply` and :meth:`Transformer.loss`, the
  dense path. Like the JAX package's functional ``apply(params, ...)``,
  they take an optional ``params`` dict (``{name: tensor}`` with the names
  of ``named_parameters()``), so the trainer runs the model on its
  compute-dtype copy of the master weights. Each layer runs under
  ``torch.utils.checkpoint`` when ``remat`` is on, with its weights passed
  in explicitly, so the backward pass replays it on the same tensors.
  Attention is :func:`~deepspeed_tpu_torch.ops.attention.flash_attention`
  (``use_flash``) or the plain ``dot_product_attention``; ALiBi and
  per-layer-varying windows take the plain one, as in the JAX package;
* generation: the KV-cache branch of :meth:`Transformer.apply`, which the
  v1 inference engine (:mod:`deepspeed_tpu_torch.inference.engine`) runs
  over a static cache. The new K/V are written into the cache in place at
  ``cache_pos``, and attention is the plain ``dot_product_attention`` over
  the whole cache, as in the JAX package. Layer leaves are read from
  ``params`` one layer at a time, just before the layer runs, so a mapping
  that makes a leaf when it is read (the engine's dequantizing view) holds
  one layer's weights at a time.

Tensor parallelism (``bind_topology`` with a ``model`` axis above 1, after
:meth:`Transformer.shard_` cut this rank's leaves), for every flag set:
the JAX package's Megatron layout (:meth:`Transformer.partition_specs`),
made explicit where GSPMD inserts the collectives. A rank holds ``n_heads
/ tp`` query and ``n_kv_heads / tp`` KV heads (column-parallel ``wq`` /
``wk`` / ``wv`` / ``w_gate`` / ``w_up`` and ``bq`` / ``bk`` / ``bv`` /
``b_up``) and their ALiBi slopes, the matching rows of the row-parallel
``wo`` / ``w_down``, whose partial products are summed over the model
group before ``bo`` / ``b_down`` are added once, and ``vocab / tp`` rows
of ``tok_embed`` (columns of ``lm_head``, entries of ``mlm_bias``): the
embedding is a masked lookup of the local rows summed over the group (the
JAX one-hot contraction, bit for bit: each row has one non-zero), and
the head's fp32 logit columns (tied, untied or the MLM decoder) are
gathered in rank order. Norms, positions, segments, the MLM transform
and the pooler are replicated. With a fused comm backend bound (``bind_comm_backend``, by the
v1 engine), a one-position decode step's down-projection runs as the
backend's ``matmul_all_reduce`` (:meth:`Transformer._down_proj`).
The model group's collectives are the differentiable ones of
:mod:`~deepspeed_tpu_torch.comm.comm` (serving runs their forward
alone), the Megatron pair that GSPMD inserts in the JAX package's
training step: ``tp_copy`` where a
replicated activation enters a column-parallel weight (Q/K/V, gate/up,
the head; its backward sums the input gradients over the group),
``tp_sum`` for the row-parallel and embedding sums (backward: the
identity), ``tp_gather`` for the head's logit columns (backward: this
rank's columns). Every rank runs the same layers in the same order, so
the remat replay's collectives meet too. Under a ``data`` axis above 1
(the trainer's data parallelism) :meth:`Transformer.loss` returns this
rank's share of the global batch's loss: its rows' terms over the
denominator summed over the data group, so the shares (and their
gradients) sum to the loss of the whole batch, as the JAX package's
GSPMD loss over the data-sharded batch is; a ``data_local`` compute copy
(the trainer's under qgZ) keeps the loss over the rank's rows alone, as
the JAX facade's shard_map loss is. Under ZeRO-3 the trainer passes a
:class:`~deepspeed_tpu_torch.parallel.zero.Zero3Params` view: the layer
loop reads each layer's shards and gathers them inside the layer's remat
region (:meth:`Transformer._encode`).

An encoder without a padding mask takes the flash kernel with
``causal=False``; with one, the plain ``dot_product_attention`` under the
key mask broadcast to ``[b, 1, 1, s]``, as the JAX package computes it
outside any Pallas kernel. Sequence parallelism comes with a later slice.

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
from ..ops.norms import layer_norm, rms_norm
from ..ops.rotary import alibi_slopes, apply_rotary, rope_frequencies
from ..parallel.mesh import PartitionSpec as P, shard_slices
from ..runtime.activation_checkpointing import checkpoint_wrapper
from ..utils.device import resolve_device

Params = Dict[str, torch.Tensor]


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

    def layer_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """One layer's leaves and their shapes (without the JAX stacked
        layer dim), in the order the JAX package's ``init`` makes them
        (the Llama set first); a config with other FFN leaves (MoE's
        expert bank) overrides it."""
        hd, d, f = self.head_dim, self.d_model, self.d_ff
        qd, kvd = self.n_heads * hd, self.n_kv_heads * hd
        s = {"attn_norm_w": (d,), "wq": (d, qd), "wk": (d, kvd),
             "wv": (d, kvd), "wo": (qd, d), "mlp_norm_w": (d,)}
        if self.activation == "silu_glu":
            s["w_gate"] = (d, f)
        s.update(w_up=(d, f), w_down=(f, d))
        if self.norm == "layer":
            s.update(attn_norm_b=(d,), mlp_norm_b=(d,))
        if self.qkv_bias:
            s.update(bq=(qd,), bk=(kvd,), bv=(kvd,))
        if self.attn_o_bias:
            s["bo"] = (d,)
        if self.use_bias:
            s.update(b_up=(f,), b_down=(d,))
        return s


def layer_leaves(c: TransformerConfig) -> Tuple[str, ...]:
    """One layer's leaf names under ``c`` (``c.layer_shapes()``'s keys),
    as the JAX package's ``init`` makes them."""
    return tuple(c.layer_shapes())


def top_leaves(c: TransformerConfig) -> Tuple[str, ...]:
    """The top-level (unstacked) leaf names under ``c``, in the JAX
    ``init``'s order. A post-LN model (``prenorm=False``) has no final
    norm."""
    names = ["tok_embed"]
    if c.prenorm:
        names.append("final_norm_w")
        if c.norm == "layer":
            names.append("final_norm_b")
    if c.position == "learned":
        names.append("pos_embed")
    if c.type_vocab_size > 0:
        names.append("type_embed")
    if c.embed_norm:
        names += ["embed_norm_w", "embed_norm_b"]
    if not c.tie_embeddings:
        names.append("lm_head")
    if c.mlm_head:
        names += ["mlm_dense_w", "mlm_dense_b", "mlm_norm_w", "mlm_norm_b",
                  "mlm_bias"]
    if c.pooler:
        names += ["pooler_w", "pooler_b"]
    return tuple(names)


class Block(nn.Module):
    """One layer's parameters, named as the JAX leaves, ``[in,
    out]`` layout; the config decides which leaves exist
    (:func:`layer_leaves`)."""

    def __init__(self, c: TransformerConfig, device, dtype):
        super().__init__()
        for name, shape in c.layer_shapes().items():
            setattr(self, name, nn.Parameter(
                torch.empty(shape, device=device, dtype=dtype),
                requires_grad=False))

    def __getitem__(self, name: str) -> torch.Tensor:
        """``block["wq"]``: a Block reads like the dict of one layer's
        leaves that the training path passes around."""
        return getattr(self, name)


class _MatmulFp32(torch.autograd.Function):
    """``a @ w`` with an fp32 output (``torch.mm``'s ``out_dtype`` on the
    card, which has no derivative formula); the backward computes dA =
    dY . W^T and dW = A^T . dY in ``a``'s dtype, as the one-device
    product's backward does (dY arrives as ``a``-dtype values in fp32:
    the output is rounded to ``a``'s dtype after the model group's
    sum)."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return torch.mm(a, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g = g.to(a.dtype)
        return g @ w.t(), a.t() @ g


class Transformer(nn.Module):
    """A decoder or encoder of any ported flag set. ``device`` defaults to
    ``"cuda"`` and raises without a CUDA device unless ``device="cpu"``
    is asked for. Weights
    are made with :meth:`init` from ``seed`` (a seeded ``torch.Generator``
    on the model's device), or loaded from a JAX tree with
    :func:`~deepspeed_tpu_torch.checkpoint.jax_params.load_jax_params`."""

    def __init__(self, config: TransformerConfig, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.config = c = config

        def p(*shape):
            return nn.Parameter(torch.empty(shape, device=dev, dtype=dtype),
                                requires_grad=False)

        shapes = self.top_shapes()
        self.tok_embed = p(*shapes["tok_embed"])
        self.layers = nn.ModuleList(Block(c, dev, dtype)
                                    for _ in range(c.n_layers))
        for name in list(shapes)[1:]:
            setattr(self, name, p(*shapes[name]))
        self.init(seed)
        # tensor parallelism (bind_topology / bind_comm_backend)
        self._topo = None
        self._tp_size, self._tp_rank = 1, 0
        self._comm_backend = None

    @property
    def device(self) -> torch.device:
        return self.tok_embed.device

    def top_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """The shape of each top-level leaf (:func:`top_leaves`, in its
        order); a subclass with leaves of its own (CLIP's vision tower)
        adds them here."""
        c = self.config
        d, v = c.d_model, c.vocab_size
        shapes = {"tok_embed": (v, d), "final_norm_w": (d,),
                  "final_norm_b": (d,), "pos_embed": (c.max_seq_len, d),
                  "type_embed": (c.type_vocab_size, d),
                  "embed_norm_w": (d,), "embed_norm_b": (d,),
                  "lm_head": (d, v), "mlm_dense_w": (d, d),
                  "mlm_dense_b": (d,), "mlm_norm_w": (d,),
                  "mlm_norm_b": (d,), "mlm_bias": (v,), "pooler_w": (d, d),
                  "pooler_b": (d,)}
        return {name: shapes[name] for name in top_leaves(c)}

    # -- tensor parallelism --------------------------------------------
    def partition_specs(self, params: Any = None, topo: Any = None
                        ) -> Dict[str, Any]:
        """The JAX package's tensor-parallel PartitionSpecs, key for key,
        over its stacked tree (layer leaves ``[n_layers, ...]``, so a
        layer spec leads with the layer dim): column-parallel QKV / gate /
        up and their biases, row-parallel O / down (their biases
        replicated: added once, after the model group's sum), the
        vocab-sharded embedding, head and MLM decoder bias; norms,
        positions, segments, the MLM transform and the pooler replicated.
        ``params`` (a JAX-layout dict) adds ``lm_head_b`` where it holds
        one, as JAX's does, and so does a model with an LM-head bias
        (:meth:`add_head_bias`); ``topo`` is taken for the JAX signature
        (no pipe axis is ported)."""
        c = self.config
        layers = {"attn_norm_w": P(None, None), "wq": P(None, None, "model"),
                  "wk": P(None, None, "model"), "wv": P(None, None, "model"),
                  "wo": P(None, "model", None), "mlp_norm_w": P(None, None),
                  "w_up": P(None, None, "model"),
                  "w_down": P(None, "model", None)}
        if c.activation == "silu_glu":
            layers["w_gate"] = P(None, None, "model")
        if c.norm == "layer":
            layers.update(attn_norm_b=P(None, None), mlp_norm_b=P(None, None))
        if c.qkv_bias:
            layers.update(bq=P(None, "model"), bk=P(None, "model"),
                          bv=P(None, "model"))
        if c.attn_o_bias:
            layers["bo"] = P(None, None)
        if c.use_bias:
            layers.update(b_up=P(None, "model"), b_down=P(None, None))
        specs: Dict[str, Any] = {"tok_embed": P("model", None),
                                 "layers": layers}
        if c.prenorm:
            specs["final_norm_w"] = P(None)
            if c.norm == "layer":
                specs["final_norm_b"] = P(None)
        if c.position == "learned":
            specs["pos_embed"] = P(None, None)
        if c.type_vocab_size > 0:
            specs["type_embed"] = P(None, None)
        if c.embed_norm:
            specs.update(embed_norm_w=P(None), embed_norm_b=P(None))
        if not c.tie_embeddings:
            specs["lm_head"] = P(None, "model")
            if (isinstance(params, dict) and "lm_head_b" in params) \
                    or "lm_head_b" in self._parameters:
                specs["lm_head_b"] = P("model")
        if c.mlm_head:
            specs.update(mlm_dense_w=P(None, None), mlm_dense_b=P(None),
                         mlm_norm_w=P(None), mlm_norm_b=P(None),
                         mlm_bias=P("model"))
        if c.pooler:
            specs.update(pooler_w=P(None, None), pooler_b=P(None))
        return specs

    @torch.no_grad()
    def add_head_bias(self) -> "Transformer":
        """Give an untied model the LM-head bias ``lm_head_b`` [vocab]
        (zeros; GPT-J checkpoints carry one, JAX ``_head`` adds it to the
        logits), sharded with the head's vocab columns. Call it before
        :meth:`shard_`."""
        if self.config.tie_embeddings:
            raise ValueError("a tied head has no lm_head_b")
        if self._tp_size > 1:
            raise ValueError("add the head bias before shard_()")
        self.lm_head_b = nn.Parameter(
            torch.zeros(self.config.vocab_size, device=self.device,
                        dtype=self.tok_embed.dtype), requires_grad=False)
        return self

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
        if self._tp_size > 1:
            raise ValueError("the model is already sharded")
        self.bind_topology(topo)
        for name, p in self.named_parameters():
            p.data = self.local_shard(name, p.data).clone()
        return self

    def bind_topology(self, topo) -> "Transformer":
        """Attach the mesh whose ``model`` axis this rank's leaves are
        sharded over (:meth:`shard_` cuts them)."""
        self._check_tp(topo.model_parallel_size)
        self._topo = topo
        self._tp_size = topo.model_parallel_size
        self._tp_rank = topo.rank("model")
        return self

    def _check_tp(self, tp: int) -> None:
        """A model axis of ``tp`` must divide the heads, the KV heads,
        ``d_ff`` and the vocab. The JAX package's placement raises on an
        indivisible vocab too (``device_put`` of the vocab-sharded
        embedding); where only the heads do not divide, its v1 engine lets
        GSPMD reshard them, which the port does not (ROADMAP.md, the
        differences)."""
        if tp <= 1:
            return
        c = self.config
        for what, n in (("n_heads", c.n_heads), ("n_kv_heads", c.n_kv_heads),
                        ("d_ff", c.d_ff), ("vocab_size", c.vocab_size)):
            if n % tp:
                raise ValueError(f"{what} {n} not divisible by the model "
                                 f"axis {tp}")

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
        psum GSPMD inserts; ``comm.tp_sum``, whose backward is the
        identity); ``y`` itself without tensor parallelism."""
        if self._tp_size <= 1:
            return y
        return comm.tp_sum(y, self._group())

    def _tp_copy(self, h: torch.Tensor) -> torch.Tensor:
        """``h`` entering a column-parallel weight: under tensor
        parallelism ``comm.tp_copy`` (the identity, whose backward sums
        the ranks' input gradients over the model group); else ``h``."""
        if self._tp_size <= 1:
            return h
        return comm.tp_copy(h, self._group())

    def _data_group(self):
        """The data group of a bound topology with ``data`` above 1 (the
        trainer's data parallelism), else None."""
        topo = self._topo
        if topo is None or topo.data_parallel_size <= 1:
            return None
        return topo.group("data")

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
            y = _MatmulFp32.apply(flat, w)
        else:
            y = flat.float() @ w.float()
        y = self._all_reduce(y).to(a.dtype)
        return y.reshape(*a.shape[:-1], w.shape[-1])

    @torch.no_grad()
    def init(self, seed: int = 0) -> "Transformer":
        """Fill every weight in place from a ``torch.Generator`` seeded
        with ``seed``, with the JAX package's scheme: dense weights
        ~ N(0, 1/fan_in), ``wo`` ~ N(0, 1/(2 d n_layers)), ``w_down``
        ~ N(0, 1/(2 d_ff n_layers)) (:meth:`_leaf_std`), embeddings
        (tokens, positions, segments, CLIP's class token) ~ N(0, 0.02^2),
        norm weights 1, biases 0.
        (The two frameworks draw different numbers from one seed; tests
        carry JAX weights across instead.)"""
        c = self.config
        gen = torch.Generator(device=self.device).manual_seed(seed)

        def normal_(w, std):
            w.copy_(torch.randn(w.shape, generator=gen, device=self.device,
                                dtype=torch.float32).mul_(std))

        drawn = ("wq", "wk", "wv", "wg", "w_gate", "w_up", "wo", "w_down")
        for blk in self.layers:
            for name, w in blk.named_parameters():
                if name.endswith("norm_w"):
                    w.fill_(1.0)
                elif name not in drawn:
                    w.zero_()
            for name in drawn:
                if hasattr(blk, name):
                    w = getattr(blk, name)
                    normal_(w, self._leaf_std(name, w))
        for name in self.top_shapes():
            w = getattr(self, name)
            if name in ("tok_embed", "pos_embed", "type_embed", "cls_embed"):
                normal_(w, 0.02)
            elif w.dim() == 2:
                normal_(w, 1.0 / math.sqrt(w.shape[0]))
            elif name.endswith("norm_w"):
                w.fill_(1.0)
            else:
                w.zero_()
        return self

    def _leaf_std(self, name: str, w: torch.Tensor) -> float:
        """The init's standard deviation of the drawn layer leaf ``name``."""
        c = self.config
        if name == "wo":
            return 1.0 / math.sqrt(c.d_model * 2 * c.n_layers)
        if name == "w_down":
            return 1.0 / math.sqrt(c.d_ff * 2 * c.n_layers)
        return 1.0 / math.sqrt(w.shape[0])

    # ------------------------------------------------------------------
    def _params(self, params: Optional[Mapping[str, torch.Tensor]]
                ) -> Mapping[str, torch.Tensor]:
        return dict(self.named_parameters()) if params is None else params

    def forward(self, tokens, positions=None, return_hidden: bool = False,
                params: Optional[Params] = None, kv_caches=None,
                cache_pos: Optional[int] = None,
                last_token_only: bool = False, token_type_ids=None,
                attn_mask=None):
        return self.apply(tokens, positions, return_hidden, params=params,
                          kv_caches=kv_caches, cache_pos=cache_pos,
                          last_token_only=last_token_only,
                          token_type_ids=token_type_ids, attn_mask=attn_mask)

    def apply(self, tokens: torch.Tensor, positions=None,
              return_hidden: bool = False, *,
              params: Optional[Mapping[str, torch.Tensor]] = None,
              kv_caches=None, cache_pos: Optional[int] = None,
              last_token_only: bool = False,
              token_type_ids: Optional[torch.Tensor] = None,
              attn_mask: Optional[torch.Tensor] = None,
              training: bool = False, return_aux: bool = False,
              generator: Optional[torch.Generator] = None):
        """Forward. tokens: [b, s] int -> fp32 logits [b, s, vocab], or the
        pre-head hidden states [b, s, d] with ``return_hidden``. ``params``
        (default: the module's own) maps the names of
        ``named_parameters()`` to tensors; the compute dtype is its
        ``compute_dtype`` attribute where it has one, else its ``wq``'s.

        ``kv_caches``: a ``(k, v)`` pair, each a stacked ``[n_layers, b,
        max_len, hkv, hd]`` tensor or a sequence of per-layer ``[b,
        max_len, hkv, hd]`` tensors. This step's K/V are written into them
        in place at ``cache_pos`` (an int), query i attends cache slots
        ``k <= cache_pos + i`` (inside its layer's window), and ``(out,
        kv_caches)`` is returned. ``positions`` (default ``0..s-1``) are
        the RoPE and learned-position positions; decode passes the
        absolute ones. ``last_token_only`` keeps only the last position
        before the head.

        Encoders: ``token_type_ids`` [b, s] are the segment ids (zeros
        when None and the config has ``type_embed``); ``attn_mask`` [b, s]
        (1 = attend) masks padded keys of a bidirectional model and
        raises on a causal one. KV-cache decode needs a causal model.

        ``training`` takes an MoE layer's capacity (drop) route, with
        noise from ``generator`` under a noisy gate policy (each layer
        draws from a generator seeded from it, so a remat replay draws
        the same noise); ``return_aux`` returns ``(out, aux)`` with the
        layers' summed aux loss (0.0 for a dense model) on the dense
        path. The KV-cache path drops the aux, as the JAX one does."""
        p = self._params(params)
        c = self.config
        if kv_caches is not None and not c.causal:
            raise ValueError("KV-cache decode requires a causal model")
        x = self._embed(tokens, p, positions=positions,
                        token_type_ids=token_type_ids)
        angles = rope_frequencies(c.rotary_dim, c.max_seq_len, c.rope_theta,
                                  device=x.device) \
            if c.position == "rope" else None
        aux = 0.0
        if kv_caches is None:
            x, aux = self._encode(p, x, angles, positions,
                                  attn_mask=attn_mask, training=training,
                                  generator=generator)
        else:
            x = self._cached_layers(p, x, angles, positions, kv_caches,
                                    cache_pos)
        if last_token_only:
            x = x[:, -1:]
        out = x if return_hidden else self._head(x, p)
        if kv_caches is not None:
            return out, kv_caches
        return (out, aux) if return_aux else out

    def _cached_layers(self, p, x, angles, positions, kv_caches,
                       cache_pos: Optional[int]) -> torch.Tensor:
        """The layer stack of the KV-cache branch (JAX ``apply`` with
        ``kv_caches``): each layer's leaves are read just before it runs,
        and each layer keeps its own window (0 = global)."""
        c = self.config
        ks, vs = kv_caches
        if cache_pos is None:
            raise ValueError("kv_caches needs cache_pos")
        max_len = ks[0].shape[1]
        if not 0 <= int(cache_pos) <= max_len - x.shape[1]:
            raise ValueError(f"cache_pos {cache_pos} + {x.shape[1]} tokens "
                             f"does not fit a cache of {max_len} slots")
        names = layer_leaves(c)
        windows = c.attn_windows or (0,) * c.n_layers
        for i in range(c.n_layers):
            lp = {n: p[f"layers.{i}.{n}"] for n in names}
            x, _ = self._block(x, lp, angles, positions, window=windows[i],
                               kv_cache=(ks[i], vs[i], int(cache_pos)))
        return x

    def _dense_windows(self, length: int) -> Tuple[Tuple[int, ...], bool]:
        """(each layer's window, whether they vary) of the dense path at
        this length, as the JAX ``_encode`` decides: no window where none
        binds (w == length attends everything), one static window where
        all layers share it (the banded flash kernel), else the
        per-layer windows on the plain masked attention (GPT-Neo)."""
        c = self.config
        if not c.window_binds(length):
            return (0,) * c.n_layers, False
        return c.attn_windows, len(set(c.attn_windows)) > 1

    def _norm(self, x: torch.Tensor, leaves, prefix: str) -> torch.Tensor:
        """The config's norm with the leaves ``{prefix}_w`` (and, for
        LayerNorm, ``{prefix}_b``) of ``leaves`` (a :class:`Block`, a
        layer's dict or the top-level params): RMSNorm or LayerNorm."""
        c = self.config
        if c.norm == "rms":
            return rms_norm(x, leaves[f"{prefix}_w"], c.norm_eps)
        return layer_norm(x, leaves[f"{prefix}_w"], leaves[f"{prefix}_b"],
                          c.norm_eps)

    def _alibi_bias(self, skv: int, device) -> torch.Tensor:
        """ALiBi's additive logits [h, 1, skv]: ``slopes * k_pos``. The
        per-row ``-slopes * q_pos`` shift is constant along the softmax
        axis and cancels, so this alone is exact under the row softmax."""
        slopes = alibi_slopes(self.config.n_heads, device=device)
        if self._tp_size > 1:
            # this rank's heads' slopes (GSPMD shards JAX's by head)
            h = self.config.n_heads // self._tp_size
            slopes = slopes[self._tp_rank * h:(self._tp_rank + 1) * h]
        return slopes[:, None, None] * torch.arange(
            skv, dtype=torch.float32, device=device)[None, None, :]

    def _block(self, x: torch.Tensor, lp: Mapping[str, torch.Tensor],
               angles: Optional[torch.Tensor], positions=None,
               window: int = 0, kv_cache=None,
               varying: bool = False,
               attn_mask: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               training: bool = False) -> Tuple[torch.Tensor, Any]:
        """One layer, pre-norm or post-norm (``prenorm=False``: the branch
        reads x and the norm follows each residual add). x: [b, s, d];
        ``lp`` maps the leaf names of :func:`layer_leaves` to this layer's
        weights. With ``kv_cache`` = (k cache, v cache, cache_pos), this
        step's K/V are written into the caches in place and attention runs
        over them. ``window`` (0 = global) bands this layer's attention;
        ``varying`` says the layers' windows differ, which takes the plain
        attention in the dense path (the JAX masked branch).
        ``attn_mask`` [b, s] (1 = attend) masks a bidirectional layer's
        padded keys. Returns (x, the FFN's aux loss); ``generator`` and
        ``training`` go to the FFN (:meth:`_mlp`)."""
        c = self.config
        hd = c.head_dim
        b, s, _ = x.shape
        if attn_mask is not None and c.causal:
            raise NotImplementedError(
                "attn_mask with a causal model is not supported (padding "
                "masks are an encoder feature; causal batches should pack "
                "or left-trim instead)")
        # this rank's heads (all of them without tensor parallelism)
        hq, hkv = c.n_heads // self._tp_size, c.n_kv_heads // self._tp_size
        h = self._norm(x, lp, "attn_norm") if c.prenorm else x
        h = self._tp_copy(h)
        q, kk, vv = h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]
        if c.qkv_bias:
            q, kk, vv = q + lp["bq"], kk + lp["bk"], vv + lp["bv"]
        q = q.reshape(b, s, hq, hd)
        kk = kk.reshape(b, s, hkv, hd)
        vv = vv.reshape(b, s, hkv, hd)
        if c.position == "rope":
            q = apply_rotary(q, angles, positions, rotary_dim=c.rotary_dim,
                             interleaved=c.rope_interleaved)
            kk = apply_rotary(kk, angles, positions, rotary_dim=c.rotary_dim,
                              interleaved=c.rope_interleaved)
        alibi = c.position == "alibi"
        if kv_cache is not None:
            ck, cv, pos0 = kv_cache
            ck[:, pos0:pos0 + s] = kk
            cv[:, pos0:pos0 + s] = vv
            # query i sits at absolute position pos0 + i and sees every
            # cache slot up to itself (which also masks the unwritten
            # tail), inside its layer's window
            q_abs = pos0 + torch.arange(s, device=x.device)
            k_pos = torch.arange(ck.shape[1], device=x.device)
            mask = k_pos[None, :] <= q_abs[:, None]
            if window > 0:
                mask = mask & (k_pos[None, :] > q_abs[:, None] - window)
            attn = dot_product_attention(
                q, ck, cv, causal=False, mask=mask[None, None],
                bias=self._alibi_bias(ck.shape[1], x.device) if alibi
                else None, scale=c.attn_scale)
        elif alibi:
            # the JAX dense ALiBi branch: the plain attention, no scale
            # override and no window
            attn = dot_product_attention(
                q, kk, vv, causal=True, bias=self._alibi_bias(s, x.device))
        elif attn_mask is not None:
            # encoder padding: the padded keys are masked for every query
            attn = dot_product_attention(
                q, kk, vv, causal=False,
                mask=attn_mask.bool()[:, None, None, :], scale=c.attn_scale)
        elif varying or not c.use_flash:
            attn = dot_product_attention(q, kk, vv, causal=c.causal,
                                         scale=c.attn_scale, window=window)
        else:
            attn = flash_attention(q, kk, vv, causal=c.causal,
                                   scale=c.attn_scale, window=window)
        attn = self._row_parallel(attn.reshape(b, s, hq * hd), lp["wo"])
        if c.attn_o_bias:
            attn = attn + lp["bo"]
        if c.parallel_residual:
            # GPT-J / GPT-NeoX: both branches read the same input x
            down, aux = self._mlp(self._norm(x, lp, "mlp_norm"), lp,
                                  generator, training)
            return x + attn + down, aux
        if not c.prenorm:
            x = self._norm(x + attn, lp, "attn_norm")
            down, aux = self._mlp(x, lp, generator, training)
            return self._norm(x + down, lp, "mlp_norm"), aux
        x = x + attn
        down, aux = self._mlp(self._norm(x, lp, "mlp_norm"), lp, generator,
                              training)
        return x + down, aux

    def _encode(self, p: Mapping[str, torch.Tensor], x: torch.Tensor,
                angles: Optional[torch.Tensor] = None, positions=None,
                attn_mask: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Any]:
        """The layer stack over embedded inputs x: [b, s, d], shared by
        the token path (:meth:`apply`) and towers that embed something
        else (CLIP's patches). With ``remat`` (and autograd recording),
        each layer runs under
        :func:`~deepspeed_tpu_torch.runtime.activation_checkpointing.checkpoint_wrapper`
        with ``remat_policy``: only its input is kept, and the backward
        pass runs it again. With ``generator`` and a noisy MoE gate, layer
        i draws its noise from a generator seeded with the i-th of
        ``n_layers`` seeds drawn from it (the JAX per-layer key split), so
        a replay draws the same; a model without one draws nothing.
        Under ZeRO-3 ``p`` is the trainer's
        :class:`~deepspeed_tpu_torch.parallel.zero.Zero3Params`: each
        layer reads its leaves' shards and gathers them inside the block.
        Returns (x, the layers' summed aux loss: 0.0 for dense FFNs)."""
        c = self.config
        windows, varying = self._dense_windows(x.shape[1])
        names = layer_leaves(c)
        seeds = [None] * c.n_layers
        if generator is not None and getattr(c, "noisy_gate_policy", None):
            seeds = torch.randint(0, 2 ** 62, (c.n_layers,),
                                  generator=generator,
                                  device=generator.device).tolist()

        # ZeRO-3 (a Zero3Params view): a layer's leaves come in as this
        # rank's shards and are gathered inside the block, so remat keeps
        # only the shards and its replay gathers again
        gather = getattr(p, "gather_layer", None)
        read = p.__getitem__ if gather is None else p.shard

        def block(x, window, seed, i, *leaves):
            if gather is not None:
                leaves = gather([f"layers.{i}.{n}" for n in names], leaves)
            gen = None if seed is None else \
                torch.Generator(device=x.device).manual_seed(seed)
            return self._block(x, dict(zip(names, leaves)), angles,
                               positions, window, varying=varying,
                               attn_mask=attn_mask, generator=gen,
                               training=training)

        if c.remat and torch.is_grad_enabled():
            block = checkpoint_wrapper(block, policy=c.remat_policy)
        total = 0.0
        for i in range(c.n_layers):
            x, aux = block(x, windows[i], seeds[i], i,
                           *(read(f"layers.{i}.{n}") for n in names))
            total = total + aux
        return x, total

    # ------------------------------------------------------------------
    def _targets_from_batch(self, batch: Mapping[str, Any]):
        """(inputs, targets, mask) for next-token CE. batch:
        {"input_ids": [b, s]} with optional "labels" (shifted internally
        when absent) and "loss_mask". The shift keeps the full length and
        masks the last position instead of slicing. A bidirectional model
        needs explicit "labels" (MLM)."""
        tokens = batch["input_ids"]
        if "labels" in batch:
            mask = batch.get("loss_mask")
            return tokens, batch["labels"], (None if mask is None
                                              else mask.float())
        if not self.config.causal:
            raise ValueError(
                "bidirectional (causal=False) models require explicit "
                "'labels' (+ 'loss_mask') in the batch — next-token "
                "prediction is not a valid encoder objective")
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
             params: Optional[Params] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Next-token (or masked-LM, through explicit labels) cross
        entropy (+ z-loss, + an MoE model's weighted aux loss, from the
        forward's training route with ``generator``'s noise), a 0-dim
        fp32 tensor. An encoder's batch may
        carry "attention_mask" (padding) and "token_type_ids" (segments);
        only encoder configs read them, so a decoder's all-ones
        "attention_mask" does not trip the causal model's mask refusal.
        With ``loss_chunk_size`` > 0 the head and CE run over token
        chunks, each recomputed in the backward pass, so the full fp32
        logits never exist at once. Bound to a topology whose ``data``
        axis is above 1, the loss is this rank's share of the global
        batch's (the module docstring)."""
        p = self._params(params)
        c = self.config
        inputs, targets, mask = self._targets_from_batch(batch)
        fwd = {}
        if not c.causal and "attention_mask" in batch:
            fwd["attn_mask"] = batch["attention_mask"]
        if c.type_vocab_size > 0 and "token_type_ids" in batch:
            fwd["token_type_ids"] = batch["token_type_ids"]
        fwd.update(training=True, return_aux=True, generator=generator)
        cs = c.loss_chunk_size
        if cs > 0:
            x, aux = self.apply(inputs, return_hidden=True, params=p, **fwd)
            nll_sum, denom, z_sum = self._ce_chunked(p, x, targets, mask, cs)
        else:
            logits, aux = self.apply(inputs, params=p, **fwd)
            nll_sum, denom, z_sum = self._ce_terms(logits, targets, mask)
        # a compute copy that is ``data_local`` (the trainer under qgZ)
        # asks for the loss over this rank's rows alone
        group = None if getattr(p, "data_local", False) else \
            self._data_group()
        if group is not None:
            # this rank's share: its terms over the global batch's weight,
            # the aux loss (a mean over rows) over the data ranks
            denom = comm.group_sum(denom.detach(), group, "data")
            aux = aux / self._topo.data_parallel_size
        denom = torch.clamp(denom, min=1.0)
        loss = nll_sum / denom
        if self.config.z_loss > 0:
            loss = loss + self.config.z_loss * z_sum / denom
        # a dense model's aux is the float 0.0: nothing to add
        return loss + aux if torch.is_tensor(aux) else loss

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
               params: Optional[Mapping[str, torch.Tensor]] = None,
               positions: Optional[torch.Tensor] = None,
               token_type_ids: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
        """Token (+ learned position, + segment, + embedding LayerNorm)
        embedding: [..., s] -> [..., s, d] in the compute dtype
        (``params.compute_dtype`` where the mapping has one, so that no
        layer leaf is read for it; else the dtype of ``wq``). Learned
        positions are ``positions`` (default ``0..s-1``), clamped to the
        table as the JAX gather clamps: a multi-step decode lane past the
        context reads the last row, and scatters into the sink page."""
        p = self._params(params)
        c = self.config
        dtype = getattr(p, "compute_dtype", None) or p["layers.0.wq"].dtype
        table = p["tok_embed"]
        if self._tp_size <= 1:
            x = F.embedding(tokens.long(), table).to(dtype)
        else:
            # vocab-parallel: this rank's rows, zeros for the other ranks'
            # ids, summed over the group. Ids are clipped to the vocab
            # first, as the JAX one-hot path does
            rows = table.shape[0]
            ids = tokens.long().clamp(0, c.vocab_size - 1) \
                - self._tp_rank * rows
            mine = (ids >= 0) & (ids < rows)
            x = F.embedding(ids.clamp(0, rows - 1), table).to(dtype)
            x = torch.where(mine[..., None], x,
                            torch.zeros((), dtype=dtype, device=x.device))
            x = self._all_reduce(x)
        if c.position == "learned":
            pos_table = p["pos_embed"]
            if positions is None:
                pos = pos_table[: tokens.shape[-1]]
            else:
                pos = F.embedding(positions.long().clamp(
                    0, c.max_seq_len - 1), pos_table)
            x = x + pos.to(dtype)
        if c.type_vocab_size > 0:
            # BERT: the embedding norm below takes the sum of word,
            # position and segment embeddings
            tt = torch.zeros_like(tokens) if token_type_ids is None \
                else token_type_ids
            x = x + F.embedding(tt.long(), p["type_embed"]).to(dtype)
        if c.embed_norm:
            x = layer_norm(x, p["embed_norm_w"], p["embed_norm_b"],
                           c.norm_eps)
        return x

    def _mlp(self, h: torch.Tensor, lp, generator=None,
             training: bool = False) -> Tuple[torch.Tensor, Any]:
        """The config's FFN -> (out, aux loss): gated SiLU, (silu(h @
        w_gate) * (h @ w_up)) @ w_down, or act(h @ w_up + b_up) @ w_down
        with GELU (tanh form, ``jax.nn.gelu``'s default), ``gelu_exact``
        (erf), ReLU or ``quick_gelu``; ``+ b_down`` with ``use_bias``.
        ``lp`` is a :class:`Block` or a dict of one layer's leaves. The
        dense FFN's aux is the float 0.0 and it takes no ``generator`` or
        ``training``; an MoE model overrides this with its expert bank
        (the JAX ``_mlp(h, lp, rng, training)`` seam)."""
        c = self.config
        h = self._tp_copy(h)
        if c.activation == "silu_glu":
            up = F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])
        else:
            up = h @ lp["w_up"]
            if c.use_bias:
                up = up + lp["b_up"]
            if c.activation == "relu":
                up = F.relu(up)
            elif c.activation == "gelu_exact":
                up = F.gelu(up)
            elif c.activation == "quick_gelu":
                up = up * torch.sigmoid(1.702 * up)
            else:
                up = F.gelu(up, approximate="tanh")
        down = self._down_proj(up, lp["w_down"])
        if c.use_bias:
            down = down + lp["b_down"]
        return down, 0.0

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
        """Final norm (pre-LN models) + LM head (``tok_embed.T`` when
        tied), then ``logits_softcap``: [..., d] -> fp32 logits [...,
        vocab]. With ``mlm_head``, BERT's transform (dense, the FFN's
        activation, LayerNorm) runs before the tied decoder and a vocab
        bias after it. Under tensor parallelism each rank computes its
        vocab columns and the group gathers them in rank order."""
        p = self._params(params)
        c = self.config
        if c.prenorm:
            x = self._norm(x, p, "final_norm")
        if c.mlm_head:
            x = x @ p["mlm_dense_w"].to(x.dtype) + p["mlm_dense_b"].to(x.dtype)
            # HF's BertPredictionHeadTransform reuses the FFN's activation
            if c.activation == "relu":
                x = F.relu(x)
            else:
                x = F.gelu(x, approximate="none" if c.activation ==
                           "gelu_exact" else "tanh")
            x = layer_norm(x, p["mlm_norm_w"], p["mlm_norm_b"], c.norm_eps)
        w_out = p["tok_embed"].T if c.tie_embeddings else p["lm_head"]
        logits = (self._tp_copy(x) @ w_out.to(x.dtype)).float()
        if c.mlm_head:
            logits = logits + p["mlm_bias"].float()
        if "lm_head_b" in self._parameters:  # GPT-J's (this rank's columns)
            logits = logits + p["lm_head_b"].float()
        if self._tp_size > 1:
            logits = comm.tp_gather(logits, self._group())
        if c.logits_softcap > 0:
            logits = torch.tanh(logits / c.logits_softcap) * c.logits_softcap
        return logits

    def pooled(self, hidden: torch.Tensor,
               params: Optional[Mapping[str, torch.Tensor]] = None
               ) -> torch.Tensor:
        """BERT's pooler: tanh of a dense layer on the first (``[CLS]``)
        position of the final hidden states ``[b, s, d]`` (from
        ``apply(..., return_hidden=True)``) -> ``[b, d]``."""
        if not self.config.pooler:
            raise ValueError("model config has pooler=False")
        p = self._params(params)
        cls = hidden[:, 0]
        return torch.tanh(cls @ p["pooler_w"].to(cls.dtype)
                          + p["pooler_b"].to(cls.dtype))
