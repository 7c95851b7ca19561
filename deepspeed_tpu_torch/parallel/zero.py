"""ZeRO-3 sharding rules and the staged block schedule.

Ports the stage-3 parts of ``deepspeed_tpu/parallel/zero.py``:
``shard_leaf_spec`` and ``ZeroShardingRules`` for the single ``data``
axis, the ``MatmulBlockSpec`` / ``FusedBlockOps`` / ``BlockProgram`` seam,
``Zero3BlockSchedule`` (overlapped and serial issue) and
``SequentialBlockModel``.

In the JAX package a spec places a leaf for GSPMD; here it tells each rank
which slice of a leaf it keeps (:func:`shard_of`): along the sharded
dimension, rank r of the ``data`` group keeps the r-th of ``world`` equal
pieces, the layout of a tiled ``all_gather``.

The schedule runs the block program eagerly, with autograd in place of
``jax.vjp``: the forward keeps only the block inputs (no autograd graph),
the backward re-gathers each block and recomputes its forward under
autograd (activation checkpointing at block boundaries), so at most one
block's full parameters are live at a time, as the JAX schedule's memory
contract says. Overlapped issue prefetches block i+1's gather before
block i's compute and defers a block's gradient reduce behind the next
block's backward; serial issue runs each collective at its consumer. Both
run the same arithmetic in the same order per value, so their results are
bitwise equal.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..config import ZeroConfig
from ..utils.device import resolve_device
from .mesh import PartitionSpec, Topology


def shard_leaf_spec(shape: Tuple[int, ...], zero_axes: Tuple[str, ...] = (
        "data",), threshold: int = 0, axes_size: int = 1) -> PartitionSpec:
    """The spec of one leaf: the ZeRO axis on the largest dimension that
    the axis size divides (ties to the lower index), or replicated when
    the leaf is 0-D, the axis has size 1, the leaf has fewer than
    ``threshold`` elements, or no dimension divides."""
    ndim = len(shape)
    spec: List[Any] = [None] * ndim
    if ndim == 0 or axes_size == 1 or int(np.prod(shape)) < threshold:
        return PartitionSpec(*spec)
    cands = [i for i in range(ndim)
             if shape[i] % axes_size == 0 and shape[i] >= axes_size]
    if not cands:
        return PartitionSpec(*spec)
    dim = max(cands, key=lambda i: shape[i])
    spec[dim] = zero_axes if len(zero_axes) > 1 else zero_axes[0]
    return PartitionSpec(*spec)


class ZeroShardingRules:
    """Per-leaf specs of ZeRO stage 3 over the ``data`` axis: parameters
    (kept whole below ``stage3_param_persistence_threshold``) and
    optimizer state / gradient shards."""

    def __init__(self, topo: Topology, zero_config: Optional[ZeroConfig] = None):
        self.topo = topo
        self.config = zero_config or ZeroConfig()
        self.zero_axes = ("data",)
        self.zero_size = topo.axis_size("data")

    def param_spec(self, shape: Tuple[int, ...]) -> PartitionSpec:
        if self.config.stage < 3:
            return PartitionSpec(*([None] * len(shape)))
        return shard_leaf_spec(
            shape, self.zero_axes,
            threshold=self.config.stage3_param_persistence_threshold,
            axes_size=self.zero_size)

    def state_spec(self, shape: Tuple[int, ...]) -> PartitionSpec:
        if self.config.stage < 1:
            return PartitionSpec(*([None] * len(shape)))
        return shard_leaf_spec(shape, self.zero_axes, threshold=0,
                               axes_size=self.zero_size)


def sharded_dim(spec: PartitionSpec) -> Optional[int]:
    """The dimension a single-axis spec shards, or None."""
    dims = [d for d, e in enumerate(spec) if e is not None]
    return dims[0] if dims else None


def shard_of(full: torch.Tensor, spec: PartitionSpec, rank: int,
             world: int) -> torch.Tensor:
    """Rank ``rank``'s piece of ``full`` under ``spec`` (a view)."""
    d = sharded_dim(spec)
    if d is None or world == 1:
        return full
    n = full.shape[d] // world
    return full.narrow(d, rank * n, n)


# ======================================================================
# the staged block schedule

@dataclass
class MatmulBlockSpec:
    """Fusion hint of one block: its forward is ``epilogue(h @
    p[weight], rest_of_p_gathered, h)``, with ``weight`` the key of the
    2-D matmul weight in the block's dict. The epilogue must be a pure
    function of its three arguments (the engine differentiates it)."""

    weight: str
    epilogue: Callable[[Any, Any, Any], Any]


@dataclass
class FusedBlockOps:
    """Backend-fused forward/backward of one block: ``forward(block_shard,
    h) -> h'`` gathers inside; ``backward(block_shard, h_in, g_out) ->
    (reduced_grads, g_h)`` returns grads already reduced over the ZeRO
    group, so the schedule issues no gather or reduce for the block."""

    forward: Callable[[Any, Any], Any]
    backward: Callable[[Any, Any, Any], Tuple[Any, Any]]


@dataclass
class BlockProgram:
    """A model as sequential blocks: ``block_fns[i](p_i, h) -> h'`` takes
    block i's FULL parameters (a dict); ``h0`` is the first input;
    ``loss_tail(h) -> loss``; ``merge(per_block_dicts) -> {name: leaf}``
    puts per-block trees back under the model's parameter names.
    ``matmul_blocks`` (optional, parallel to ``block_fns``) holds
    :class:`MatmulBlockSpec` hints, entries may be None. A model exposes
    ``zero3_blocks(params, batch, rng) -> BlockProgram`` and must handle
    ``params`` structurally (the engine also passes specs)."""

    block_fns: List[Callable[[Any, Any], Any]]
    blocks: List[Any]
    h0: Any
    loss_tail: Callable[[Any], Any]
    merge: Callable[[List[Any]], Any]
    matmul_blocks: Optional[List[Optional[MatmulBlockSpec]]] = None


def block_vjp(fn: Callable, params: Dict[str, torch.Tensor],
              h: torch.Tensor, g_out: torch.Tensor):
    """(grads of ``params``, grad of ``h``) of ``fn(params, h)`` against
    the cotangent ``g_out``, by recomputing ``fn`` under autograd; an
    unused input gets zeros, as ``jax.vjp`` gives."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    h_in = h.detach().requires_grad_(True)
    with torch.enable_grad():
        out = fn(leaves, h_in)
        grads = torch.autograd.grad(out, [*leaves.values(), h_in], g_out,
                                    allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, [*leaves.values(), h_in])]
    return dict(zip(leaves, grads[:-1])), grads[-1]


class Zero3BlockSchedule:
    """Per-block forward and backward with pluggable collectives:
    ``gather(i, block_shard) -> block_full`` and ``reduce(i,
    block_grads) -> reduced`` come from the facade; ``fused`` maps block
    indices to :class:`FusedBlockOps`; ``overlapped`` picks the issue
    order (prefetch / defer, or serial). See the module docstring."""

    def __init__(self, gather: Callable[[int, Any], Any],
                 reduce: Callable[[int, Any], Any], overlapped: bool = True,
                 fused: Optional[dict] = None):
        self.gather = gather
        self.reduce = reduce
        self.overlapped = overlapped
        self.fused = fused or {}

    def loss_and_grads(self, prog: BlockProgram, scale: float
                       ) -> Tuple[torch.Tensor, List[Any]]:
        """(loss, per-block grad dicts): grads of ``scale * loss`` with
        respect to the full block parameters, reduced over the ZeRO group;
        the loss is this rank's, unreduced."""
        L = len(prog.block_fns)
        assert L == len(prog.blocks) and L > 0
        fused = self.fused

        def gather(i):
            return None if i in fused else self.gather(i, prog.blocks[i])

        hs: List[Any] = [prog.h0]
        h = prog.h0
        with torch.no_grad():
            full = gather(0)
            for i in range(L):
                nxt = gather(i + 1) if self.overlapped and i + 1 < L else None
                if i in fused:
                    h = fused[i].forward(prog.blocks[i], h)
                else:
                    h = prog.block_fns[i](full, h)
                hs.append(h)
                if i + 1 < L:
                    full = nxt if self.overlapped else gather(i + 1)
        h_last = h.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = prog.loss_tail(h_last)
            (g_h,) = torch.autograd.grad(loss, h_last,
                                         torch.full_like(loss, scale))
        loss = loss.detach()
        grads: List[Any] = [None] * L
        pending, pending_i = None, -1
        full = gather(L - 1)
        for i in reversed(range(L)):
            nxt = gather(i - 1) if self.overlapped and i > 0 else None
            if i in fused:
                grads[i], g_h = fused[i].backward(prog.blocks[i], hs[i], g_h)
            else:
                g_full, g_h = block_vjp(prog.block_fns[i], full, hs[i], g_h)
                if self.overlapped:
                    if pending is not None:
                        grads[pending_i] = self.reduce(pending_i, pending)
                    pending, pending_i = g_full, i
                else:
                    grads[i] = self.reduce(i, g_full)
            if i > 0:
                full = nxt if self.overlapped else gather(i - 1)
        if pending is not None:
            grads[pending_i] = self.reduce(pending_i, pending)
        return loss, grads


class _Block(nn.Module):
    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


class SequentialBlockModel(nn.Module):
    """The reference ``zero3_blocks`` model: dense layers ``h @ w + b``
    with tanh between them and a mean-squared-error tail. Parameters are
    ``block_{i}.w [dims[i], dims[i+1]]`` (normal * 0.05 from ``seed``) and
    ``block_{i}.b`` (zeros), made on the CPU from a ``torch.Generator``
    and moved to ``device`` (default the card), so every device gets the
    same weights. Each block carries a :class:`MatmulBlockSpec` hint."""

    def __init__(self, dims: Sequence[int], seed: int = 0, device=None):
        super().__init__()
        if len(dims) < 3:
            raise ValueError("SequentialBlockModel needs >= 2 layers")
        self.dims = tuple(int(d) for d in dims)
        self.seed = seed
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        for i in range(self.n_blocks):
            w = torch.randn((self.dims[i], self.dims[i + 1]),
                            generator=gen) * 0.05
            b = torch.zeros(self.dims[i + 1])
            self.add_module(f"block_{i}", _Block(w.to(dev), b.to(dev)))

    @property
    def n_blocks(self) -> int:
        return len(self.dims) - 1

    @staticmethod
    def _apply_block(p: Dict[str, torch.Tensor], h: torch.Tensor,
                     last: bool) -> torch.Tensor:
        y = h @ p["w"] + p["b"]
        return y if last else torch.tanh(y)

    def _params(self, params) -> Dict[str, Any]:
        return dict(self.named_parameters()) if params is None else params

    def loss(self, batch: Dict[str, torch.Tensor], params=None,
             generator=None) -> torch.Tensor:
        """The composed (unstaged) loss, ``mean((f(x) - y)^2)``;
        ``generator`` (the trainer's random stream) is not drawn from."""
        p = self._params(params)
        h = batch["x"]
        for i in range(self.n_blocks):
            h = self._apply_block({"w": p[f"block_{i}.w"],
                                   "b": p[f"block_{i}.b"]}, h,
                                  last=i == self.n_blocks - 1)
        return torch.mean((h - batch["y"]) ** 2)

    def zero3_blocks(self, params, batch, rng=None) -> BlockProgram:
        L = self.n_blocks
        blocks = [{"w": params[f"block_{i}.w"], "b": params[f"block_{i}.b"]}
                  for i in range(L)]

        def block_fn(i):
            last = i == L - 1
            return lambda p, h: self._apply_block(p, h, last)

        def loss_tail(h):
            return torch.mean((h - batch["y"]) ** 2)

        def merge(trees: List[Any]) -> Dict[str, Any]:
            return {f"block_{i}.{k}": v for i, t in enumerate(trees)
                    for k, v in t.items()}

        def epilogue(i):
            # mirrors _apply_block with y = h @ p["w"] computed outside
            last = i == L - 1
            return lambda y, rest, h: (y + rest["b"] if last
                                       else torch.tanh(y + rest["b"]))

        h0 = batch["x"] if isinstance(batch, dict) else batch
        return BlockProgram(block_fns=[block_fn(i) for i in range(L)],
                            blocks=blocks, h0=h0, loss_tail=loss_tail,
                            merge=merge,
                            matmul_blocks=[MatmulBlockSpec("w", epilogue(i))
                                           for i in range(L)])
