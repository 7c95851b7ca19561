"""Kernel backends of the compressed-collective facade.

Ports ``deepspeed_tpu/comm/backends.py``. A backend implements three fused
compute-collective entry points, whose meaning is the reference backend's
unfused composition of facade collectives and fp32-accumulating matmuls:

* ``all_gather_matmul`` — ``h @ all_gather(w_shard, dim)``. The fused
  backend runs a ring: tile i's shard is multiplied (dequantized in the
  kernel's prologue when qwZ is on, :func:`~..ops.fused_collectives.
  dequant_matmul`; else :func:`~..ops.fused_collectives.matmul_pallas`)
  while tile i+1's shard is in flight (``ring_permute`` is issued before
  the kernel launches). The gather dim is a non-contraction dim of the
  product, so each tile is an independent column slice of it.
* ``matmul_reduce_scatter`` — the weight gradient ``h.T @ g``, meaned over
  the ZeRO group; the fused backend quantizes it in the matmul's epilogue
  (:func:`~..ops.fused_collectives.matmul_quantize`) and feeds the facade's
  ``quantized_chunk_exchange``.
* ``matmul_all_reduce`` — the sum over ranks of ``x @ w_shard`` (the
  tensor-parallel decode MLP's down-projection), through the rank-ordered
  chunked all-reduce; quantized in the epilogue with a ``qspec``.

The config values of ``comm_compression.kernel_backend`` keep the JAX
package's names so that its configs carry over: ``"xla"`` is
:class:`ReferenceCollectiveBackend` (the unfused composition; matmuls are
``torch.matmul`` of fp32-cast operands), ``"pallas"`` is
:class:`FusedCollectiveBackend` (the hand-written CUDA kernels of
``csrc/fused_collectives.cu`` on CUDA tensors, their plain versions on CPU
tensors), and ``"auto"`` is the fused backend on CUDA and the reference
backend on the CPU, as the JAX package picks Pallas on a TPU only.

What cannot fuse (contraction-dim gathers, non-2-D or mixed-dtype
operands, indivisible blocks, the hierarchical inner hop) takes the
reference backend and is metered in ``comm/facade/fallbacks``; fusions
count under ``comm/facade/fused``. Wire bytes move only through
``comm/compressed.py``. The fused and reference backends agree to fp32
summation order; quantized payloads can then sit one level apart where a
product lands near a rounding boundary.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..ops import fused_collectives as fc
from ..parallel.mesh import collective_axis_size, get_topology
from ..telemetry.registry import get_registry
from . import compressed as cc
from .comm import record_collective


def _note_fused(op: str) -> None:
    reg = get_registry()
    reg.counter("comm/facade/fused").inc()
    reg.counter(f"comm/facade/fused/{op}").inc()


def dot_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with fp32 accumulation (``dot_general`` with
    ``preferred_element_type=float32``): the operands cast to fp32, whose
    products are exact for fp32/fp16/bf16 inputs."""
    return torch.matmul(a.float(), b.float())


def _common_dtype(a: torch.Tensor, b: torch.Tensor):
    """Both operands contiguous in their promoted dtype, as ``dot_general``
    promotes mixed operands (the cast is exact)."""
    t = torch.promote_types(a.dtype, b.dtype)
    return a.to(t).contiguous(), b.to(t).contiguous()


class CollectiveBackend:
    """Protocol of the facade's kernel-backend seam; every rank of the
    axis calls the same entry point with its own shard."""

    name = "base"

    def all_gather_matmul(self, h: torch.Tensor, w_shard: torch.Tensor,
                          axis_name: str, *, dim: int = 1,
                          qspec: Optional[cc.QuantSpec] = None,
                          out_dtype=None, op: str = "qwz_all_gather",
                          stats: Optional[List[torch.Tensor]] = None
                          ) -> torch.Tensor:
        """``h [m, k] @ merge(all_gather(w_shard, dim))`` in fp32
        accumulation, cast to ``out_dtype`` (default ``h.dtype``)."""
        raise NotImplementedError

    def matmul_reduce_scatter(self, h: torch.Tensor, g: torch.Tensor, *,
                              outer_axis: str, outer_world: int,
                              inner_axis: Optional[str] = None,
                              inner_world: int = 1,
                              qspec: Optional[cc.QuantSpec] = None,
                              min_quant_size: int = 0,
                              stats: Optional[List[torch.Tensor]] = None
                              ) -> torch.Tensor:
        """Mean over the ZeRO group of the local weight gradient
        ``h.T @ g`` (``h [m, k]``, ``g [m, n]`` -> fp32 ``[k, n]``)."""
        raise NotImplementedError

    def matmul_all_reduce(self, x: torch.Tensor, w_shard: torch.Tensor,
                          axis_name: str, *,
                          qspec: Optional[cc.QuantSpec] = None,
                          out_dtype=None, op: str = "decode_mlp_all_reduce",
                          stats: Optional[List[torch.Tensor]] = None
                          ) -> torch.Tensor:
        """Sum over ``axis_name`` of ``x [m, k_shard] @ w_shard [k_shard,
        n]``, through the rank-ordered chunked all-reduce."""
        raise NotImplementedError


class ReferenceCollectiveBackend(CollectiveBackend):
    """The unfused composition of facade collectives and fp32-accumulating
    matmuls (config value ``"xla"``, the JAX ``XlaCollectiveBackend``):
    the meaning of the seam, which the fused backend is held to."""

    name = "xla"

    def all_gather_matmul(self, h, w_shard, axis_name, *, dim=1, qspec=None,
                          out_dtype=None, op="qwz_all_gather", stats=None):
        w_full = cc.quantized_all_gather(w_shard, axis_name, dim=dim,
                                         qspec=qspec, op=op, stats=stats)
        return dot_fp32(h, w_full).to(out_dtype or h.dtype)

    def matmul_reduce_scatter(self, h, g, *, outer_axis, outer_world,
                              inner_axis=None, inner_world=1, qspec=None,
                              min_quant_size=0, stats=None):
        dw = dot_fp32(h.t(), g)
        out = cc.hierarchical_pmean(
            dw.reshape(-1), outer_axis=outer_axis, outer_world=outer_world,
            inner_axis=inner_axis, inner_world=inner_world, qspec=qspec,
            min_quant_size=min_quant_size, stats=stats)
        return out.reshape(dw.shape)

    def matmul_all_reduce(self, x, w_shard, axis_name, *, qspec=None,
                          out_dtype=None, op="decode_mlp_all_reduce",
                          stats=None):
        y = dot_fp32(x, w_shard)
        out = cc.chunked_all_reduce(y, axis_name, qspec=qspec, op=op,
                                    reduce="sum", stats=stats)
        return out.to(out_dtype or x.dtype)


class FusedCollectiveBackend(CollectiveBackend):
    """The fused kernels (``ops/fused_collectives.py``) where shapes allow,
    the reference backend otherwise (config value ``"pallas"``, the JAX
    ``PallasFusedBackend``)."""

    name = "pallas"

    def __init__(self, fallback: Optional[CollectiveBackend] = None):
        self.fallback = fallback or ReferenceCollectiveBackend()

    @staticmethod
    def _gather_fusable(h, w_shard, dim, world) -> bool:
        # dim 1 keeps the gather on a non-contraction dim of h @ w, so each
        # ring tile is an independent column slice; a dim-0 shard would
        # split the accumulation. Mixed dtypes fall back: the reference
        # feeds the weight at its own dtype.
        return (world > 1 and h.dim() == 2 and w_shard.dim() == 2
                and dim == 1 and h.shape[1] == w_shard.shape[0]
                and h.dtype == w_shard.dtype)

    def all_gather_matmul(self, h, w_shard, axis_name, *, dim=1, qspec=None,
                          out_dtype=None, op="qwz_all_gather", stats=None):
        world = collective_axis_size(axis_name)
        kw = dict(dim=dim, qspec=qspec, out_dtype=out_dtype, op=op,
                  stats=stats)
        if world <= 1:
            return self.fallback.all_gather_matmul(h, w_shard, axis_name,
                                                   **kw)
        if not self._gather_fusable(h, w_shard, dim, world):
            cc._note_fallback(op)
            return self.fallback.all_gather_matmul(h, w_shard, axis_name,
                                                   **kw)
        quantized = qspec is not None and qspec.divides(w_shard.numel())
        if qspec is not None and not quantized:
            # indivisible shard: the facade's dense fallback meters it
            return self.fallback.all_gather_matmul(h, w_shard, axis_name,
                                                   **kw)
        _note_fused(op)
        out_dtype = out_dtype or h.dtype
        m = h.shape[0]
        k, b = w_shard.shape
        logical = cc._nbytes(w_shard)
        me = get_topology().rank(axis_name)
        out = torch.empty((m, world * b), dtype=torch.float32,
                          device=h.device)
        if quantized:
            record_collective(op, logical, qspec.wire_nbytes(w_shard.numel()),
                              axis_name, world)
            cur = cc._quantize(w_shard.reshape(-1).float(), qspec, stats)
        else:
            record_collective(op, logical, logical, axis_name, world)
            cur = (w_shard.contiguous(),)
        for step in range(world):
            nxt = None
            if step + 1 < world:
                # tile i+1's shard goes on the wire before tile i's kernel
                nxt = [cc.ring_permute(t, axis_name, world=world,
                                       op=f"{op}_ring") for t in cur]
            r = (me - step) % world
            tile = out[:, r * b:(r + 1) * b]
            if quantized:
                fc.dequant_matmul(h, cur[0], cur[1], bits=qspec.bits,
                                  block=qspec.block, b=b,
                                  w_dtype=w_shard.dtype, out=tile)
            else:
                fc.matmul_pallas(h, cur[0], out=tile)
            cur = tuple(p.wait() for p in nxt) if nxt else None
        return out.to(out_dtype)

    def matmul_reduce_scatter(self, h, g, *, outer_axis, outer_world,
                              inner_axis=None, inner_world=1, qspec=None,
                              min_quant_size=0, stats=None):
        two_d = h.dim() == 2 and g.dim() == 2
        numel = h.shape[-1] * g.shape[-1] if two_d else 0
        fusable = (two_d and h.shape[0] == g.shape[0] and outer_world > 1
                   and qspec is not None and inner_world <= 1
                   and numel >= max(min_quant_size, 1)
                   and qspec.divides(numel, outer_world))
        if not fusable:
            if qspec is not None and inner_world > 1 and outer_world > 1 \
                    and two_d:
                cc._note_fallback("qgz_inter_reduce_scatter")
            return self.fallback.matmul_reduce_scatter(
                h, g, outer_axis=outer_axis, outer_world=outer_world,
                inner_axis=inner_axis, inner_world=inner_world, qspec=qspec,
                min_quant_size=min_quant_size, stats=stats)
        _note_fused("qgz_inter_reduce_scatter")
        h, g = _common_dtype(h, g)
        payload, s = fc.matmul_quantize(h, g, bits=qspec.bits,
                                        block=qspec.block, trans_a=True)
        out = cc.quantized_chunk_exchange(
            payload, s, n=numel, axis_name=outer_axis, world=outer_world,
            qspec=qspec, op_prefix="qgz_inter", reduce="mean", stats=stats)
        return out.reshape(h.shape[1], g.shape[1])

    def matmul_all_reduce(self, x, w_shard, axis_name, *, qspec=None,
                          out_dtype=None, op="decode_mlp_all_reduce",
                          stats=None):
        world = collective_axis_size(axis_name)
        if not (x.dim() == 2 and w_shard.dim() == 2
                and x.shape[1] == w_shard.shape[0]):
            cc._note_fallback(op)
            return self.fallback.matmul_all_reduce(
                x, w_shard, axis_name, qspec=qspec, out_dtype=out_dtype,
                op=op, stats=stats)
        out_dtype = out_dtype or x.dtype
        n = x.shape[0] * w_shard.shape[1]
        x, w_shard = _common_dtype(x, w_shard)
        if world > 1 and qspec is not None and qspec.divides(n, world):
            _note_fused(op)
            payload, s = fc.matmul_quantize(x, w_shard, bits=qspec.bits,
                                            block=qspec.block, trans_a=False)
            out = cc.quantized_chunk_exchange(
                payload, s, n=n, axis_name=axis_name, world=world,
                qspec=qspec, op_prefix=op, reduce="sum", stats=stats)
            return out.reshape(x.shape[0], w_shard.shape[1]).to(out_dtype)
        # dense or indivisible (chunked_all_reduce meters the latter): the
        # partial matmul still fuses; the exchange is the shared facade path
        if world > 1:
            _note_fused(op)
        y = fc.matmul_pallas(x, w_shard)
        out = cc.chunked_all_reduce(y, axis_name, qspec=qspec, op=op,
                                    reduce="sum", stats=stats)
        return out.to(out_dtype)


def resolve_backend(name: Optional[str] = "auto",
                    device=None) -> CollectiveBackend:
    """A backend from a ``kernel_backend`` config value: ``"xla"`` (the
    reference), ``"pallas"`` (fused), or ``"auto"`` — fused when
    ``device`` (default: CUDA if available) is a CUDA device, else the
    reference."""
    if name in (None, "auto"):
        dev = torch.device(device) if device is not None else torch.device(
            "cuda" if torch.cuda.is_available() else "cpu")
        name = "pallas" if dev.type == "cuda" else "xla"
    if name == "xla":
        return ReferenceCollectiveBackend()
    if name == "pallas":
        return FusedCollectiveBackend()
    raise ValueError(f"unknown kernel backend {name!r} "
                     f"(expected 'auto', 'xla' or 'pallas')")
