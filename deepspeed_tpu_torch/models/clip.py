"""CLIP family: contrastive text and vision towers.

Ports ``deepspeed_tpu/models/clip.py``. Both towers run on the shared
:class:`~deepspeed_tpu_torch.models.transformer.Transformer` core:

* the text tower: a causal pre-LN encoder with learned positions and
  quick-GELU; its features are the final-LN hidden state at the EOS
  position, projected without bias;
* the vision tower (:class:`CLIPVision`): a ViT on the same block stack.
  The stride-p patch convolution is a reshape into (c, ph, pw)-ordered
  patch vectors and one matmul (a plain product, outside any kernel in
  both packages), then a learned class token and positions,
  ``embed_norm`` as the pre-LN and ``final_norm`` on the class token as
  the post-LN.

The contrastive head L2-normalizes both embeddings and scales their
products by ``exp(logit_scale)``.

Tensor parallelism (:meth:`CLIP.shard_` / :meth:`CLIP.bind_topology`)
cuts both towers by the JAX package's specs (:meth:`CLIP.partition_specs`,
key for key): each tower's own, the vision tower's unused one-row
``tok_embed``, ``patch_w``, ``cls_embed`` and ``pos_embed`` replicated,
and the projections and ``logit_scale`` replicated. Under a ``data``
axis above 1 (the trainer's data parallelism) :meth:`CLIP.loss` gathers
the projected embeddings of every data rank's rows (``comm.tp_gather``
over the data group, the gradient summed before a rank takes its rows),
so the in-batch negatives are the global batch's, as in the JAX
package's GSPMD loss; each rank returns its share, the loss over the
data ranks. A ``data_local`` compute copy (the trainer's under qgZ)
keeps the rank's own rows, as JAX's shard_map loss does; under ZeRO-3
each tower reads its part of the trainer's view (:meth:`CLIP._tower`).

As in the JAX package, every method takes an optional ``params`` mapping
(default: the model's own weights) keyed by the names of
``CLIP.named_parameters()`` (``text.*``, ``vision.*``, ``text_proj``,
``vision_proj``, ``logit_scale``), so the trainer's compute copy is what
:meth:`CLIP.loss` reads. The towers run without the training flags, as
the JAX ``loss`` runs them; each layer still runs under remat when its
config has ``remat`` and autograd records, as the JAX ``_encode``
checkpoints its blocks whenever ``remat`` is set.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from ..comm import comm
from ..ops.norms import layer_norm
from ..parallel.mesh import PartitionSpec as P
from ..utils.device import resolve_device
from .transformer import Transformer, TransformerConfig


def clip_text_config(vocab_size=49408, d_model=512, n_layers=12, n_heads=8,
                     d_ff=2048, max_seq_len=77, **overrides) -> TransformerConfig:
    kw = dict(vocab_size=vocab_size, d_model=d_model, n_layers=n_layers,
              n_heads=n_heads, d_ff=d_ff, max_seq_len=max_seq_len,
              norm="layer", activation="quick_gelu", position="learned",
              causal=True, tie_embeddings=True, use_bias=True, norm_eps=1e-5)
    kw.update(overrides)
    return TransformerConfig(**kw)


def clip_vision_config(d_model=768, n_layers=12, n_heads=12, d_ff=3072,
                       **overrides) -> TransformerConfig:
    kw = dict(vocab_size=1,  # token table unused by the pixel path
              d_model=d_model, n_layers=n_layers, n_heads=n_heads, d_ff=d_ff,
              max_seq_len=1, norm="layer", activation="quick_gelu",
              position="none",  # learned positions are added in apply_pixels
              causal=False, embed_norm=True, tie_embeddings=True,
              use_bias=True, norm_eps=1e-5)
    kw.update(overrides)
    return TransformerConfig(**kw)


class CLIPVision(Transformer):
    """ViT tower: pixels [b, c, H, W] -> (hidden [b, 1 + n, d], pooled
    [b, d]). Beside the core's leaves it holds ``patch_w`` [c p^2, d],
    ``cls_embed`` [d] and ``pos_embed`` [n_patches + 1, d]."""

    def __init__(self, config: TransformerConfig, image_size: int = 224,
                 patch_size: int = 32, n_channels: int = 3, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        if image_size % patch_size:
            raise ValueError(f"image_size {image_size} is not a multiple of "
                             f"patch_size {patch_size}")
        # plain attributes, set before the core makes (top_shapes) and
        # draws the leaves
        self.image_size = image_size
        self.patch_size = patch_size
        self.n_channels = n_channels
        self.n_patches = (image_size // patch_size) ** 2
        super().__init__(config, device=device, dtype=dtype, seed=seed)

    def top_shapes(self) -> Dict[str, Tuple[int, ...]]:
        d = self.config.d_model
        return {**super().top_shapes(),
                "patch_w": (self.n_channels * self.patch_size ** 2, d),
                "cls_embed": (d,), "pos_embed": (self.n_patches + 1, d)}

    def partition_specs(self, params=None, topo=None):
        """The core's specs with the JAX vision tower's replicated
        leaves: the unused one-row ``tok_embed``, ``patch_w``,
        ``cls_embed`` and ``pos_embed``."""
        specs = super().partition_specs(params, topo)
        specs.update(tok_embed=P(None, None), patch_w=P(None, None),
                     cls_embed=P(None), pos_embed=P(None, None))
        return specs

    def _check_tp(self, tp: int) -> None:
        """The heads and ``d_ff`` must divide by the model axis; the
        one-row token table is replicated, so the vocab need not."""
        if tp <= 1:
            return
        c = self.config
        for what, n in (("n_heads", c.n_heads), ("n_kv_heads", c.n_kv_heads),
                        ("d_ff", c.d_ff)):
            if n % tp:
                raise ValueError(f"{what} {n} not divisible by the model "
                                 f"axis {tp}")

    def apply_pixels(self, pixels: torch.Tensor,
                     params: Optional[Mapping[str, torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """pixels [b, c, H, W] (float) -> (hidden states [b, 1 + n, d],
        the post-LN class token [b, d]) in the dtype of ``params``'
        ``compute_dtype`` where the mapping has one, else of its
        ``layers.0.wq`` (default: the tower's own weights)."""
        c = self.config
        w = self._params(params)
        p = self.patch_size
        b, ch, H, W = pixels.shape
        if ch != self.n_channels or not H == W == self.image_size:
            raise ValueError(f"expected [b, {self.n_channels}, "
                             f"{self.image_size}, {self.image_size}], got "
                             f"{tuple(pixels.shape)}")
        hp = H // p
        dtype = getattr(w, "compute_dtype", None) or w["layers.0.wq"].dtype
        patches = pixels.reshape(b, ch, hp, p, hp, p) \
                        .permute(0, 2, 4, 1, 3, 5) \
                        .reshape(b, hp * hp, ch * p * p).to(dtype)
        x = patches @ w["patch_w"].to(dtype)
        cls = w["cls_embed"].to(dtype).expand(b, 1, c.d_model)
        x = torch.cat([cls, x], dim=1) + w["pos_embed"].to(dtype)
        x = layer_norm(x, w["embed_norm_w"], w["embed_norm_b"], c.norm_eps)
        h, _ = self._encode(w, x)
        pooled = layer_norm(h[:, 0], w["final_norm_w"], w["final_norm_b"],
                            c.norm_eps)
        return h, pooled


@dataclass
class CLIPConfig:
    text: TransformerConfig
    vision: TransformerConfig
    proj_dim: int = 512
    image_size: int = 224
    patch_size: int = 32
    n_channels: int = 3
    eos_token_id: Optional[int] = None  # None -> argmax pooling


class CLIP(nn.Module):
    """The two-tower contrastive model: ``text`` (a
    :class:`~deepspeed_tpu_torch.models.transformer.Transformer`),
    ``vision`` (:class:`CLIPVision`), the projections ``text_proj`` [d_t,
    proj] and ``vision_proj`` [d_v, proj], and the 0-dim ``logit_scale``
    (log(1 / 0.07) at init). The towers' weights are made from ``seed``
    and ``seed + 1``, the projections from ``seed + 2``, on ``device``
    (default ``"cuda"``)."""

    def __init__(self, config: CLIPConfig, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.config = c = config
        self.text = Transformer(c.text, device=dev, dtype=dtype, seed=seed)
        self.vision = CLIPVision(c.vision, c.image_size, c.patch_size,
                                 c.n_channels, device=dev, dtype=dtype,
                                 seed=seed + 1)
        gen = torch.Generator(device=dev).manual_seed(seed + 2)

        def proj(d_in):
            w = torch.randn((d_in, c.proj_dim), generator=gen, device=dev,
                            dtype=torch.float32) / math.sqrt(d_in)
            return nn.Parameter(w.to(dtype), requires_grad=False)

        self.text_proj = proj(c.text.d_model)
        self.vision_proj = proj(c.vision.d_model)
        self.logit_scale = nn.Parameter(torch.tensor(
            math.log(1 / 0.07), device=dev, dtype=dtype), requires_grad=False)
        self._topo = None

    # -- tensor parallelism --------------------------------------------
    def partition_specs(self, params=None, topo=None) -> Dict[str, object]:
        """The JAX package's specs, key for key: each tower's own
        (``params`` a JAX-layout tree, as the towers take it) and the
        projections and ``logit_scale`` replicated."""
        params = params if isinstance(params, dict) else {}
        return {"text": self.text.partition_specs(params.get("text"), topo),
                "vision": self.vision.partition_specs(params.get("vision"),
                                                      topo),
                "text_proj": P(None, None), "vision_proj": P(None, None),
                "logit_scale": P()}

    def leaf_spec(self, name: str) -> P:
        """The spec of one of ``named_parameters()``'s leaves."""
        tower, _, rest = name.partition(".")
        if tower in ("text", "vision") and rest:
            return getattr(self, tower).leaf_spec(rest)
        return self.partition_specs()[name]

    def local_shard(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a full-width leaf ``name`` (a view)."""
        tower, _, rest = name.partition(".")
        if tower in ("text", "vision") and rest:
            return getattr(self, tower).local_shard(rest, t)
        return t

    def shard_(self, topo) -> "CLIP":
        """Cut both towers to this rank's shards over ``topo``'s model
        axis, in place, and bind the topology."""
        self.text.shard_(topo)
        self.vision.shard_(topo)
        self._topo = topo
        return self

    def bind_topology(self, topo) -> "CLIP":
        """Attach the mesh to both towers (their leaves already cut, or a
        model axis of 1)."""
        self.text.bind_topology(topo)
        self.vision.bind_topology(topo)
        self._topo = topo
        return self

    @property
    def device(self) -> torch.device:
        return self.text_proj.device

    def _params(self, params: Optional[Mapping[str, torch.Tensor]]
                ) -> Mapping[str, torch.Tensor]:
        return dict(self.named_parameters()) if params is None else params

    @staticmethod
    def _tower(params: Mapping[str, torch.Tensor], prefix: str
               ) -> Dict[str, torch.Tensor]:
        """The ``prefix.*`` entries of ``params`` with the prefix cut: one
        tower's ``{name: tensor}`` mapping."""
        subtree = getattr(params, "subtree", None)
        if subtree is not None:     # the trainer's ZeRO-3 view
            return subtree(prefix + ".")
        cut = len(prefix) + 1
        return {k[cut:]: v for k, v in params.items()
                if k.startswith(prefix + ".")}

    def text_states(self, tokens: torch.Tensor,
                    params: Optional[Mapping[str, torch.Tensor]] = None
                    ) -> torch.Tensor:
        """tokens [b, s] -> the text tower's final-LN hidden states [b, s,
        d_text]: what a Stable Diffusion UNet cross-attends to."""
        tp = self._tower(self._params(params), "text")
        h = self.text.apply(tokens, return_hidden=True, params=tp)
        return layer_norm(h, tp["final_norm_w"], tp["final_norm_b"],
                          self.config.text.norm_eps)

    def encode_text(self, tokens: torch.Tensor,
                    params: Optional[Mapping[str, torch.Tensor]] = None
                    ) -> torch.Tensor:
        """tokens [b, s] -> projected text embedding [b, proj]: the
        final-LN hidden state at the EOS position (the first
        ``eos_token_id``, or the highest id as in the original CLIP)."""
        p = self._params(params)
        h = self.text_states(tokens, p)
        if self.config.eos_token_id is not None:
            eos = torch.argmax((tokens == self.config.eos_token_id).int(),
                               dim=-1)
        else:
            eos = torch.argmax(tokens, dim=-1)
        pooled = h[torch.arange(h.shape[0], device=h.device), eos]
        return pooled @ p["text_proj"].to(pooled.dtype)

    def encode_image(self, pixels: torch.Tensor,
                     params: Optional[Mapping[str, torch.Tensor]] = None
                     ) -> torch.Tensor:
        """pixels [b, c, H, W] -> projected image embedding [b, proj]."""
        p = self._params(params)
        _, pooled = self.vision.apply_pixels(pixels,
                                             self._tower(p, "vision"))
        return pooled @ p["vision_proj"].to(pooled.dtype)

    def similarity(self, tokens: torch.Tensor, pixels: torch.Tensor,
                   params: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits per text [bt, bi], logits per image [bi, bt])."""
        p = self._params(params)
        return self._contrast(self.encode_text(tokens, p),
                              self.encode_image(pixels, p), p)

    @staticmethod
    def _contrast(t: torch.Tensor, v: torch.Tensor, p
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        t = t / torch.linalg.norm(t, dim=-1, keepdim=True)
        v = v / torch.linalg.norm(v, dim=-1, keepdim=True)
        lpt = (t @ v.T) * torch.exp(p["logit_scale"]).to(t.dtype)
        return lpt, lpt.T

    def loss(self, batch, params: Optional[Mapping[str, torch.Tensor]] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Symmetric InfoNCE over the in-batch pairs of ``batch``
        (``input_ids`` [n, s], ``pixel_values`` [n, c, H, W]), a 0-dim
        tensor in the dtype of ``params``. ``generator`` (the trainer's
        random stream) is not drawn from: the towers have no noise. Under
        a ``data`` axis above 1, this rank's share of the global batch's
        loss (the module docstring)."""
        p = self._params(params)
        t = self.encode_text(batch["input_ids"], p)
        v = self.encode_image(batch["pixel_values"], p)
        topo = self._topo
        dp = 1 if topo is None or getattr(p, "data_local", False) else \
            topo.data_parallel_size
        if dp > 1:
            group = topo.group("data")
            t = comm.tp_gather(t, group, 0, "data", sum_grad=True)
            v = comm.tp_gather(v, group, 0, "data", sum_grad=True)
        lpt, lpi = self._contrast(t, v, p)
        labels = torch.arange(lpt.shape[0], device=lpt.device)[:, None]
        lt = -torch.gather(torch.log_softmax(lpt, -1), -1, labels).mean()
        li = -torch.gather(torch.log_softmax(lpi, -1), -1, labels).mean()
        return 0.5 * (lt + li) / dp
