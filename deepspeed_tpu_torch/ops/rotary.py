"""Rotary position embeddings.

Ports ``rope_frequencies``, ``apply_rotary`` and ``alibi_slopes`` from
``deepspeed_tpu/ops/rotary.py`` (plain tensor code there and here; no
kernel).
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def rope_frequencies(head_dim: int, max_len: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    """Precompute the [max_len, head_dim/2] fp32 angle table."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    return torch.outer(t, inv_freq)


def apply_rotary(x: torch.Tensor, angles: torch.Tensor,
                 positions: Optional[torch.Tensor] = None,
                 rotary_dim: Optional[int] = None,
                 interleaved: bool = False) -> torch.Tensor:
    """Apply RoPE. x: [..., seq, n_heads, head_dim]; angles:
    [max_len, rotary_dim/2]; positions: optional [..., seq] integer
    positions (KV-cache decode offsets).

    ``rotary_dim`` < head_dim rotates only the leading dims (GPT-NeoX
    ``rotary_pct``); ``interleaved`` uses the GPT-J pairing — (x[2i],
    x[2i+1]) rotate together — instead of the Llama/NeoX half-split."""
    if rotary_dim is not None and rotary_dim < x.shape[-1]:
        xr, xp = x[..., :rotary_dim], x[..., rotary_dim:]
        xr = apply_rotary(xr, angles, positions, interleaved=interleaved)
        return torch.cat([xr, xp], dim=-1)
    if positions is None:
        seq = x.shape[-3]
        ang = angles[:seq]                                   # [seq, rd/2]
        ang = ang[(None,) * (x.dim() - 3) + (slice(None), None, slice(None))]
    else:
        ang = angles[positions.long()][..., None, :]  # broadcast over heads
    sin, cos = torch.sin(ang), torch.cos(ang)
    xf = x.float()
    if interleaved:
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
        r1, r2 = x1 * cos - x2 * sin, x1 * sin + x2 * cos
        out = torch.stack([r1, r2], dim=-1).reshape(x.shape)
    else:
        x1, x2 = torch.chunk(xf, 2, dim=-1)
        out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def alibi_slopes(n_heads: int, device=None) -> torch.Tensor:
    """ALiBi per-head slopes [n_heads] fp32 (Press et al. 2022; Bloom's
    position scheme): the geometric sequence of the largest power of two
    of heads at or below ``n_heads``, then every other slope of twice
    that count for the heads left over (Bloom has 14/32/112 heads)."""

    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(n_heads).is_integer():
        slopes = pow2_slopes(n_heads)
    else:
        base = 2 ** math.floor(math.log2(n_heads))
        slopes = pow2_slopes(base)
        slopes += pow2_slopes(2 * base)[0::2][: n_heads - base]
    return torch.tensor(slopes, dtype=torch.float32, device=device)
