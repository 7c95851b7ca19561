"""Blockwise quantization ops (int8 / int4, symmetric and asymmetric).

Ports ``deepspeed_tpu/ops/quantizer.py``. Symmetric ``quantize_blockwise``
and ``dequantize_blockwise`` go through :mod:`.quant` — the hand-written
Hopper kernels on CUDA tensors, their plain versions on CPU tensors — as
the JAX module goes to its Pallas kernels. The asymmetric forms have no
TPU kernel and stay plain tensor code on both devices, as in JAX.

Three int4 layouts exist, each kept where the JAX package uses it:

* :func:`pack_int4`: two's-complement nibbles, element 2k in the low
  nibble (the compressed collectives' wire format);
* :func:`quantize_kv`: channel 2c low, 2c+1 high, two's complement (the
  quantized KV pools, read by the paged-attention kernel);
* :func:`.quant.pack_int4_offset`: offset binary ``q + 8``, element 2k low
  (the v1 inference engine's int4 weights).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import quant


def _reshape_blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    n = x.numel()
    if n % block:
        raise ValueError(f"size {n} not divisible by block {block}")
    return x.reshape(n // block, block)


def quantize_blockwise(x: torch.Tensor, bits: int = 8, block: int = 256,
                       symmetric: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor,
                                  Optional[torch.Tensor]]:
    """-> (q, scale fp32 [blocks], zero fp32 [blocks] | None).

    Symmetric: q int8 in [-2^(bits-1), 2^(bits-1) - 1] with ``x``'s shape.
    Asymmetric: q uint8 in [0, 2^bits - 1] and the per-block minimum as
    the zero point. int4 values live in 8-bit storage."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if symmetric:
        q, scale = quant.quantize_blockwise(x, bits=bits, block=block)
        return q, scale, None
    blocks = _reshape_blocks(x.float(), block)
    qmax = 2.0 ** bits - 1
    lo = blocks.amin(dim=1, keepdim=True)
    hi = blocks.amax(dim=1, keepdim=True)
    scale = quant.ieee_div(hi - lo, qmax)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round((blocks - lo) / scale), 0, qmax) \
        .to(torch.uint8)
    return q.reshape(x.shape), scale[:, 0], lo[:, 0]


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor,
                         zero: Optional[torch.Tensor] = None,
                         block: int = 256,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_blockwise`, in ``dtype``."""
    if zero is None:
        return quant.dequantize_blockwise(q, scale, block=block, dtype=dtype)
    blocks = _reshape_blocks(q.float(), block)
    out = blocks * scale[:, None] + zero[:, None]
    return out.reshape(q.shape).to(dtype)


class _FakeQuantize(torch.autograd.Function):
    """Quantize-dequantize round trip with the straight-through gradient."""

    @staticmethod
    def forward(ctx, x, bits, block, symmetric):
        q, s, z = quantize_blockwise(x, bits=bits, block=block,
                                     symmetric=symmetric)
        return dequantize_blockwise(q, s, z, block=block, dtype=x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def fake_quantize(x: torch.Tensor, bits: int = 8, block: int = 256,
                  symmetric: bool = True) -> torch.Tensor:
    """Quantize-dequantize round trip in the input dtype (quantization-
    aware training). Straight-through estimator: the gradient passes as
    the identity."""
    return _FakeQuantize.apply(x, bits, block, symmetric)


def quantized_nbytes(numel: int, bits: int, block: int) -> int:
    """Wire size of a quantized tensor (payload + fp32 scales). Partial
    bytes round up: an odd numel at int4 still occupies the trailing
    half-filled byte, and a ragged final block still carries a full
    scale."""
    payload = (numel * bits + 7) // 8
    scales = -(-numel // block) * 4
    return payload + scales


def quantize_kv(x: torch.Tensor, bits: int = 8
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-vector symmetric quantization of KV-cache rows: ``x`` [..., hd]
    -> (payload, scale fp32 [...]), one scale per trailing vector (the
    block is head_dim: absmax / 127 for int8, absmax / 7 for int4).

    int8: payload int8 [..., hd]. int4: values clamp to [-8, 7] and two
    adjacent channels pack per byte -> uint8 [..., hd // 2], channel 2c in
    the low nibble and 2c+1 in the high one, two's complement. Each
    dequantized element is within scale / 2 of the input."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    qmax = 2.0 ** (bits - 1) - 1
    xf = x.float()
    scale = quant.ieee_div(xf.abs().amax(dim=-1), qmax)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(xf / scale[..., None]), -qmax - 1, qmax)
    if bits == 8:
        return q.to(torch.int8), scale
    qi = q.to(torch.int32)
    lo = qi[..., 0::2] & 0x0F
    hi = (qi[..., 1::2] & 0x0F) << 4
    return (lo | hi).to(torch.uint8), scale


def unpack_kv_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of the int4 packing in :func:`quantize_kv`: uint8
    [..., hd // 2] -> int32 [..., hd] in [-8, 7]."""
    p = packed.to(torch.int32)
    both = torch.stack([p & 0x0F, (p >> 4) & 0x0F], dim=-1) \
        .reshape(p.shape[:-1] + (-1,))
    return torch.where(both >= 8, both - 16, both)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, bits: int = 8,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Dequantize a :func:`quantize_kv` payload: payload [..., hd or
    hd // 2] * scale [...] -> [..., hd] in ``dtype``."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    vals = unpack_kv_int4(q) if bits == 4 else q.to(torch.int32)
    return (vals.float() * scale[..., None]).to(dtype)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int4 values (int8 storage in [-8, 7], even numel) two nibbles
    per byte, element 2k in the low nibble, 2k+1 in the high one. An odd
    numel raises: a floor division would drop the last element."""
    if q.numel() % 2:
        raise ValueError(
            f"pack_int4 needs an even number of elements (nibbles pair "
            f"two-per-byte), got {q.numel()}; pad the tensor or use an even "
            f"quantization block")
    flat = q.reshape(-1).to(torch.int32)
    return ((flat[0::2] & 0x0F) | ((flat[1::2] & 0x0F) << 4)).to(torch.uint8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: uint8 [n] -> int8 [2n] in [-8, 7]."""
    p = packed.reshape(-1).to(torch.int32)
    both = torch.stack([p & 0x0F, (p >> 4) & 0x0F], dim=-1).reshape(-1)
    return torch.where(both >= 8, both - 16, both).to(torch.int8)
