"""Attention ops.

Ports ``deepspeed_tpu/ops/attention.py``:

* :func:`dot_product_attention` — the plain reference path (dense fp32
  logits, masks, bias, GQA by repeating kv heads).
* :func:`flash_attention` — the dispatcher onto the flash kernels of
  :mod:`.flash_attention` (forward, dq, dk/dv), with their gradient.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .flash_attention import flash_attention_op, repeat_kv


def dot_product_attention(q, k, v, *, causal: bool = True,
                          mask: Optional[torch.Tensor] = None,
                          bias: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None,
                          window: int = 0) -> torch.Tensor:
    """Reference attention. q: [b, sq, hq, d]; k/v: [b, skv, hkv, d].

    Softmax in fp32, probabilities cast to q's dtype before the PV product.
    Causal masking uses absolute positions aligned to the *end* of the KV
    sequence (query i sits at i + skv - sq). ``mask``: optional bool
    (True = attend) broadcastable to [b, h, sq, skv]; ``bias``: optional
    additive logit bias broadcastable to the same; ``window`` > 0 bands
    causal attention to the trailing ``window`` keys (k > q - window).
    Masked logits take fp32's lowest value, as the JAX function does."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    k = repeat_kv(k, hq // hkv)
    v = repeat_kv(v, hq // hkv)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if bias is not None:
        logits = logits + bias.float()
    lowest = torch.finfo(torch.float32).min
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        k_pos = torch.arange(skv, device=q.device)[None, :]
        keep = q_pos >= k_pos
        if window > 0:
            keep = keep & (k_pos > q_pos - window)
        logits = logits.masked_fill(~keep, lowest)
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, lowest))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None,
                    window: int = 0) -> torch.Tensor:
    """Blocked flash attention with its gradient. q: [b, sq, hq, d]; k/v:
    [b, skv, hkv, d] -> [b, sq, hq, d]. ``window`` > 0 (requires causal)
    bands attention to the trailing ``window`` keys; tiles fully below the
    band are skipped.

    On CUDA tensors this runs the hand-written forward, dq and dk/dv
    kernels and raises on a shape they do not take (head_dim outside
    64/128/256, mixed dtypes, non-contiguous inputs); it never falls back
    to :func:`dot_product_attention`. On CPU tensors it runs their plain
    versions. The JAX dispatcher's shape gates (``_use_pallas*``) and its
    pad-to-128 wrapper (``flash_attention_padded``) exist for Mosaic's
    (8, 128) tiling; the CUDA kernels mask the ragged tail of the last
    tile themselves, so any ``sq`` and ``skv`` >= 1 go straight in, and
    neither is ported."""
    out, _lse = flash_attention_op(q, k, v, bool(causal),
                                   None if scale is None else float(scale),
                                   int(window))
    return out
