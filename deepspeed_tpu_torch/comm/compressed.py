"""The compressed-collective facade: the ZeRO-3 communication path.

Ports the collectives of ``deepspeed_tpu/comm/compressed.py`` that the
staged ZeRO-3 step and the fused backend run: ``QuantSpec``,
``quantized_all_gather`` (qwZ), ``gather_param_leaf``, ``pmean``, ``pmax``,
``quantized_chunk_exchange``, ``_quantized_pmean_1hop``,
``hierarchical_pmean`` / ``tree_hierarchical_pmean`` (qgZ, the outer hop),
``ring_permute`` and ``chunked_all_reduce``; and ``psum`` / ``pmin`` for
the engine's global norm and finite flag, which GSPMD reduces implicitly
in the JAX engine.

Each function runs on every rank of a mesh axis (``parallel/mesh.py``)
where the JAX one runs inside ``shard_map``, takes the same axis names,
books the same ledger rows (``comm/comm.py`` ``record_collective``) and
meters the same fallbacks (``comm/facade/fallbacks[/<op>]``). Quantize and
dequantize are ``ops/quantizer.py``'s: on CUDA tensors they launch the
blockwise kernels (``csrc/quant.cu``, TPU rows 5 and 6). int4 travels
nibble-packed (``pack_int4``: two's complement, element 2k low).

Reductions over ranks are explicit sums in rank order (row r of an
all_to_all came from rank r), so every rank gets the same bits and the
result does not depend on the backend's reduction order. The dense
fallbacks (``pmean``, the dense qgZ hop, the ragged ``chunked_all_reduce``)
use the backend's all_reduce, whose order is its own, as ``psum`` is XLA's.

Not in this slice: the inner (``zshard``, hpZ) hop of
``hierarchical_pmean`` raises; ``ste_quant_gather`` (the GSPMD path) and
the ``modeled_*`` arithmetic come later (ROADMAP.md, Queue A item 12).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..ops.quant import ieee_div
from ..ops.quantizer import (dequantize_blockwise, pack_int4,
                             quantize_blockwise, quantized_nbytes,
                             unpack_int4)
from ..parallel.mesh import collective_axis_size, get_topology
from ..telemetry.registry import get_registry
from . import comm
from .comm import record_collective


@dataclass(frozen=True)
class QuantSpec:
    """One quantized hop: bit width + block size of the symmetric
    blockwise quantization bracketing the collective."""

    bits: int = 8
    block: int = 256

    def __post_init__(self):
        if self.bits not in (4, 8):
            raise ValueError(f"QuantSpec.bits must be 4 or 8, got {self.bits}")
        if self.block <= 0 or self.block % 2:
            raise ValueError(f"QuantSpec.block must be positive and even, "
                             f"got {self.block}")

    @property
    def qmax(self) -> float:
        return 2.0 ** (self.bits - 1) - 1

    @property
    def rel_error_bound(self) -> float:
        """Per-element error bound relative to the block absmax:
        |x - deq(q(x))| <= scale/2 = absmax / (2*qmax)."""
        return 0.5 / self.qmax

    def wire_nbytes(self, numel: int) -> int:
        return quantized_nbytes(numel, self.bits, self.block)

    def divides(self, numel: int, world: int = 1) -> bool:
        """Whether ``numel`` elements can take this quantized hop across
        ``world`` ranks: chunking and blocking come out even."""
        return numel > 0 and numel % (self.block * max(world, 1)) == 0


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _group(axis_name: str):
    return get_topology().group(axis_name)


def _note_fallback(op: str) -> None:
    reg = get_registry()
    reg.counter("comm/facade/fallbacks").inc()
    reg.counter(f"comm/facade/fallbacks/{op}").inc()


def _rel_err(x: torch.Tensor, deq: torch.Tensor) -> torch.Tensor:
    """Max quantization error of one round trip relative to the tensor's
    absmax (0-dim fp32 tensor on ``x``'s device)."""
    denom = torch.clamp(x.float().abs().max(), min=1e-12)
    return (deq.float() - x.float()).abs().max() / denom


def _quantize(flat: torch.Tensor, spec: QuantSpec,
              stats: Optional[List[torch.Tensor]]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(wire payload, scales) of a flat fp32 tensor; the round trip's
    error goes to ``stats``."""
    q, s, _ = quantize_blockwise(flat, bits=spec.bits, block=spec.block)
    if stats is not None:
        stats.append(_rel_err(flat, dequantize_blockwise(q, s,
                                                         block=spec.block)))
    return (pack_int4(q) if spec.bits == 4 else q), s


def _dequantize_parts(payloads: Sequence[torch.Tensor],
                      scales: Sequence[torch.Tensor], spec: QuantSpec,
                      dtype=torch.float32) -> torch.Tensor:
    """Concatenated wire payloads (rank order) back to values."""
    p = torch.cat([t.reshape(-1) for t in payloads])
    q = unpack_int4(p) if spec.bits == 4 else p
    return dequantize_blockwise(q, torch.cat([s.reshape(-1) for s in scales]),
                                block=spec.block, dtype=dtype)


def _rank_ordered(rows: torch.Tensor, reduce: str, world: int) -> torch.Tensor:
    """Sum (or mean) of ``rows [world, n]`` as ((r0 + r1) + r2) + ...:
    one fixed order on every rank and every device."""
    acc = rows[0].clone()
    for r in range(1, rows.shape[0]):
        acc += rows[r]
    return ieee_div(acc, float(world)) if reduce == "mean" else acc


def _merge_gathered(full: torch.Tensor, world: int, shape: Tuple[int, ...],
                    dim: int) -> torch.Tensor:
    """[world, *shape] -> shape with dim scaled by world, rank-major along
    ``dim``."""
    out = torch.movedim(full, 0, dim)
    return out.reshape(shape[:dim] + (world * shape[dim],) + shape[dim + 1:])


# ----------------------------------------------------------------------
# weight all-gather (qwZ)

def quantized_all_gather(x: torch.Tensor, axis_name: str, *, dim: int = 0,
                         qspec: Optional[QuantSpec] = None,
                         op: str = "qwz_all_gather", out_dtype=None,
                         stats: Optional[List[torch.Tensor]] = None
                         ) -> torch.Tensor:
    """All-gather ``x`` over ``axis_name``, concatenated on ``dim``. With a
    ``qspec`` the wire carries blockwise-quantized ints + fp32 scales (qwZ);
    without one, or when the shard does not block-divide (metered), the
    dense gather runs."""
    world = collective_axis_size(axis_name)
    if world <= 1:
        return x if out_dtype is None else x.to(out_dtype)
    out_dtype = out_dtype or x.dtype
    group = _group(axis_name)
    logical = _nbytes(x)
    if qspec is None or not qspec.divides(x.numel()):
        if qspec is not None:
            _note_fallback(op)
        record_collective(op, logical, logical, axis_name, world)
        return torch.cat(comm.all_gather(x, group), dim=dim).to(out_dtype)
    record_collective(op, logical, qspec.wire_nbytes(x.numel()), axis_name,
                      world)
    payload, s = _quantize(x.reshape(-1).float(), qspec, stats)
    deq = _dequantize_parts(comm.all_gather(payload, group),
                            comm.all_gather(s, group), qspec, out_dtype)
    return _merge_gathered(deq.reshape((world,) + tuple(x.shape)), world,
                           tuple(x.shape), dim)


def gather_param_leaf(x: torch.Tensor, spec, *,
                      outer_axes: Sequence[str] = ("data",),
                      qspec: Optional[QuantSpec] = None, out_dtype=None,
                      stats: Optional[List[torch.Tensor]] = None
                      ) -> torch.Tensor:
    """A full parameter leaf from its ZeRO-3 shard: per sharded dimension,
    a gather over its axis, quantized when the axis is in ``outer_axes``.
    Other (inner, hpZ) axes come with a later slice and raise."""
    for d, entry in enumerate(tuple(spec)):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        for ax in reversed(axes):
            if ax not in outer_axes:
                raise NotImplementedError(
                    f"a dense inner-axis gather over '{ax}' (hpZ) comes "
                    f"with a later slice (ROADMAP.md, Queue A item 12)")
            x = quantized_all_gather(x, ax, dim=d, qspec=qspec,
                                     op="qwz_all_gather", out_dtype=out_dtype,
                                     stats=stats)
    return x if out_dtype is None else x.to(out_dtype)


# ----------------------------------------------------------------------
# gradient reduction (qgZ)

def _axes_tuple(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _dense_reduce(x: torch.Tensor, axes, op) -> Tuple[torch.Tensor, int]:
    world = 1
    for ax in _axes_tuple(axes):
        n = collective_axis_size(ax)
        if n > 1:
            x = comm.all_reduce(x, op, _group(ax))
            world *= n
    return x, world


def pmean(x: torch.Tensor, axes) -> torch.Tensor:
    """Dense mean over one or more mesh axes (losses, small tensors),
    booked as an all_reduce."""
    record_collective("all_reduce", _nbytes(x), _nbytes(x),
                      _axes_tuple(axes)[0])
    y, world = _dense_reduce(x, axes, dist.ReduceOp.SUM)
    return y if world == 1 else ieee_div(y, float(world))


def pmax(x: torch.Tensor, axes) -> torch.Tensor:
    """Dense max over one or more mesh axes (error-stat scalars)."""
    record_collective("all_reduce", _nbytes(x), _nbytes(x),
                      _axes_tuple(axes)[0])
    return _dense_reduce(x, axes, dist.ReduceOp.MAX)[0]


def psum(x: torch.Tensor, axes) -> torch.Tensor:
    """Dense sum over one or more mesh axes (the global norm's squared
    sums, which GSPMD reduces implicitly in the JAX engine)."""
    record_collective("all_reduce", _nbytes(x), _nbytes(x),
                      _axes_tuple(axes)[0])
    return _dense_reduce(x, axes, dist.ReduceOp.SUM)[0]


def pmin(x: torch.Tensor, axes) -> torch.Tensor:
    """Dense min over one or more mesh axes (every rank's finite flag)."""
    record_collective("all_reduce", _nbytes(x), _nbytes(x),
                      _axes_tuple(axes)[0])
    return _dense_reduce(x, axes, dist.ReduceOp.MIN)[0]


def quantized_chunk_exchange(payload: torch.Tensor, s: torch.Tensor, *,
                             n: int, axis_name: str, world: int,
                             qspec: QuantSpec, op_prefix: str,
                             reduce: str = "mean",
                             stats: Optional[List[torch.Tensor]] = None
                             ) -> torch.Tensor:
    """The two quantized hops of a chunked reduction, from an already
    quantized flat payload (wire format) and its fp32 scales: all_to_all
    chunk exchange, rank-ordered reduce of the dequantized chunks (mean or
    sum), re-quantize, all_gather. ``n`` is the logical element count.
    Shared by the facade reduction and the fused backend, so both move
    the same wire bytes."""
    group = _group(axis_name)
    record_collective(f"{op_prefix}_reduce_scatter", n * 4,
                      qspec.wire_nbytes(n), axis_name, world)
    p_recv = comm.all_to_all(payload.reshape(world, -1), group)
    s_recv = comm.all_to_all(s.reshape(world, -1), group)
    chunk_n = n // world
    vals = _dequantize_parts([p_recv], [s_recv], qspec).reshape(world,
                                                                chunk_n)
    chunk = _rank_ordered(vals, reduce, world)
    record_collective(f"{op_prefix}_all_gather", chunk_n * 4,
                      qspec.wire_nbytes(chunk_n), axis_name, world)
    payload2, s2 = _quantize(chunk, qspec, stats)
    return _dequantize_parts(comm.all_gather(payload2, group),
                             comm.all_gather(s2, group), qspec).reshape(n)


def _quantized_pmean_1hop(x: torch.Tensor, axis_name: str, world: int,
                          qspec: QuantSpec, op_prefix: str,
                          stats: Optional[List[torch.Tensor]]
                          ) -> torch.Tensor:
    """Quantized mean over one axis: quantize the local contribution, then
    :func:`quantized_chunk_exchange`. ``x`` is flat fp32 with a size that
    ``qspec`` divides across ``world`` (the caller checks)."""
    payload, s = _quantize(x, qspec, stats)
    return quantized_chunk_exchange(
        payload, s, n=x.numel(), axis_name=axis_name, world=world,
        qspec=qspec, op_prefix=op_prefix, reduce="mean",
        stats=stats).reshape(x.shape)


def hierarchical_pmean(x: torch.Tensor, *, outer_axis: Optional[str],
                       outer_world: int, inner_axis: Optional[str] = None,
                       inner_world: int = 1,
                       qspec: Optional[QuantSpec] = None,
                       min_quant_size: int = 0,
                       stats: Optional[List[torch.Tensor]] = None
                       ) -> torch.Tensor:
    """Gradient mean over the outer (``data``) axis (qgZ): the quantized
    chunk exchange where ``qspec`` divides the tensor and it is at least
    ``min_quant_size``, else the dense mean (booked as
    ``qgz_inter_reduce_dense``, metered when a ``qspec`` was given). The
    inner (hpZ) hop comes with a later slice and raises."""
    if inner_axis is not None and inner_world > 1:
        raise NotImplementedError(
            "the inner (zshard, hpZ) hop of hierarchical_pmean comes with a "
            "later slice (ROADMAP.md, Queue A item 12)")
    quantizable = (outer_world > 1 and qspec is not None
                   and x.numel() >= max(min_quant_size, 1)
                   and qspec.divides(x.numel(), outer_world))
    if not quantizable:
        if outer_world <= 1:
            return x
        if qspec is not None:
            _note_fallback("qgz_inter_reduce_dense")
        record_collective("qgz_inter_reduce_dense", _nbytes(x), _nbytes(x),
                          outer_axis, outer_world)
        y = comm.all_reduce(x, dist.ReduceOp.SUM, _group(outer_axis))
        return ieee_div(y, float(outer_world))
    y = _quantized_pmean_1hop(x.reshape(-1), outer_axis, outer_world, qspec,
                              "qgz_inter", stats)
    return y.reshape(x.shape)


def tree_hierarchical_pmean(grads: Dict[str, Any], *,
                            outer_axis: Optional[str], outer_world: int,
                            inner_axis: Optional[str] = None,
                            inner_world: int = 1,
                            qspec: Optional[QuantSpec] = None,
                            stats: Optional[List[torch.Tensor]] = None
                            ) -> Dict[str, Any]:
    """Leaf-wise :func:`hierarchical_pmean` over a ``{name: grad}`` dict;
    each leaf is reduced flat in fp32 and comes back fp32 in its shape.
    Leaves below ``4 * outer_world * block`` elements take the dense
    mean."""
    min_size = 4 * outer_world * (qspec.block if qspec else 1)
    return {k: hierarchical_pmean(
        g.reshape(-1).float(), outer_axis=outer_axis,
        outer_world=outer_world, inner_axis=inner_axis,
        inner_world=inner_world, qspec=qspec, min_quant_size=min_size,
        stats=stats).reshape(g.shape) for k, g in grads.items()}


# ----------------------------------------------------------------------
# building blocks of the fused backend (comm/backends.py)

def ring_permute(x: torch.Tensor, axis_name: str, *, world: int,
                 op: str = "ring_permute") -> comm.PendingRecv:
    """One ring hop: send ``x`` to the next rank of ``axis_name`` and
    receive the previous rank's. The hop is issued (``isend`` /
    ``irecv``) before this returns and completes in the background; the
    caller collects it with ``.wait()`` after launching the kernel that
    consumes the current tile. Booked per hop with wire == logical."""
    nbytes = _nbytes(x)
    record_collective(op, nbytes, nbytes, axis_name, world)
    return comm.ring_send_recv(x, _group(axis_name))


def chunked_all_reduce(y: torch.Tensor, axis_name: str, *,
                       qspec: Optional[QuantSpec] = None,
                       op: str = "decode_mlp_all_reduce",
                       reduce: str = "sum",
                       stats: Optional[List[torch.Tensor]] = None
                       ) -> torch.Tensor:
    """Deterministic chunked all-reduce over one axis: all_to_all chunk
    exchange, rank-ordered reduce, all_gather. Quantized with a ``qspec``
    that divides the tensor; dense chunked otherwise (metered when a
    ``qspec`` was given); a size that does not chunk-divide takes the
    backend's all_reduce."""
    world = collective_axis_size(axis_name)
    if world <= 1:
        return y
    n = y.numel()
    flat = y.reshape(-1).float()
    if qspec is not None and qspec.divides(n, world):
        payload, s = _quantize(flat, qspec, stats)
        out = quantized_chunk_exchange(
            payload, s, n=n, axis_name=axis_name, world=world, qspec=qspec,
            op_prefix=op, reduce=reduce, stats=stats)
        return out.reshape(y.shape).to(y.dtype)
    if qspec is not None:
        _note_fallback(op)
    group = _group(axis_name)
    if n % world == 0:
        record_collective(f"{op}_reduce_scatter", n * 4, n * 4, axis_name,
                          world)
        recv = comm.all_to_all(flat.reshape(world, -1), group)
        chunk = _rank_ordered(recv, reduce, world)
        record_collective(f"{op}_all_gather", chunk.numel() * 4,
                          chunk.numel() * 4, axis_name, world)
        out = torch.cat(comm.all_gather(chunk, group))
        return out.reshape(y.shape).to(y.dtype)
    record_collective(f"{op}_dense", n * 4, n * 4, axis_name, world)
    out = comm.all_reduce(y, dist.ReduceOp.SUM, group)
    return ieee_div(out, float(world)) if reduce == "mean" else out
