"""ZeRO's sharding rules, the stage-3 gather of a model's layers and the
staged block schedule.

Ports ``deepspeed_tpu/parallel/zero.py`` for the single ``data`` axis:
``shard_leaf_spec`` and ``ZeroShardingRules`` (parameters, optimizer
state and gradients at stages 0-3: ``param_spec``, ``state_spec``,
``grad_spec`` / ``grad_specs`` for ``grad_shardings``,
``opt_state_specs`` for ``opt_state_shardings``), the
``MatmulBlockSpec`` / ``FusedBlockOps`` / ``BlockProgram`` seam,
``Zero3BlockSchedule`` (overlapped and serial issue) and
``SequentialBlockModel``.

In the JAX package a spec places a leaf for GSPMD; here it tells each rank
which slice of a leaf it keeps (:func:`shard_of`): along the sharded
dimension, rank r of the ``data`` group keeps the r-th of ``world`` equal
pieces, the layout of a tiled ``all_gather``. The collectives GSPMD
inserts around that placement are explicit: :func:`reduce_to_shards`
(the gradients' reduce-scatter), :func:`gather_slices` (the updated
slices of a replicated master) and, for ZeRO-3 on a model without
``zero3_blocks``, :class:`Zero3Params`, whose per-layer gather is
differentiable (its backward pass reduce-scatters the gradients).

The schedule runs the block program eagerly, with autograd in place of
``jax.vjp``: the forward keeps only the block inputs (no autograd graph),
the backward re-gathers each block and recomputes its forward under
autograd (activation checkpointing at block boundaries), so at most one
block's full parameters are live at a time, as the JAX schedule's memory
contract says. Overlapped issue prefetches block i+1's gather before
block i's compute and defers a block's gradient reduce behind the next
block's backward; serial issue runs each collective at its consumer. Both
run the same arithmetic in the same order per value, so their results are
bitwise equal. :class:`Zero3Params` keeps the same contract through the
model's own remat: a layer's leaves are gathered inside its checkpointed
function, so the backward pass's replay gathers them again.

The JAX package stacks a model's layer leaves ``[n_layers, ...]``; the
port keeps one leaf a layer. Its size rules (the persistence threshold,
qgZ's dense floor) count the stacked leaf here too (:func:`stack_counts`),
so the same leaves are kept whole and quantized; the sharded dimension is
the per-layer leaf's largest, JAX's wherever ``n_layers`` is not a
leaf's largest divisible dimension (no configuration of the port).
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..comm import comm
from ..comm import compressed as ccomm
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
    """Per-leaf specs of ZeRO stages 0-3 over the ``data`` axis, the JAX
    package's placement: parameters replicated below stage 3 and sharded
    from it (kept whole below ``stage3_param_persistence_threshold``);
    optimizer state sharded from stage 1; gradients sharded like the
    state from stage 2, like the parameters below it."""

    def __init__(self, topo: Topology, zero_config: Optional[ZeroConfig] = None):
        self.topo = topo
        self.config = zero_config or ZeroConfig()
        self.zero_axes = ("data",)
        self.zero_size = topo.axis_size("data")

    def param_spec(self, shape: Tuple[int, ...], stack: int = 1
                   ) -> PartitionSpec:
        """``stack``: the leaves the JAX package stacks this one with
        (:func:`stack_counts`); the persistence threshold counts them
        all."""
        if self.config.stage < 3:
            return PartitionSpec(*([None] * len(shape)))
        spec = shard_leaf_spec(shape, self.zero_axes, threshold=0,
                               axes_size=self.zero_size)
        if int(np.prod(shape)) * stack < \
                self.config.stage3_param_persistence_threshold:
            return PartitionSpec(*([None] * len(shape)))
        return spec

    def state_spec(self, shape: Tuple[int, ...]) -> PartitionSpec:
        """Optimizer-state / gradient-shard spec: sharded from stage 1
        up."""
        if self.config.stage < 1:
            return PartitionSpec(*([None] * len(shape)))
        return shard_leaf_spec(shape, self.zero_axes, threshold=0,
                               axes_size=self.zero_size)

    def grad_spec(self, shape: Tuple[int, ...]) -> PartitionSpec:
        """Gradient placement (JAX ``grad_shardings``): like the state
        from stage 2 up (reduce-scatter), like the parameters below."""
        if self.config.stage >= 2:
            return self.state_spec(shape)
        return self.param_spec(shape)

    def grad_specs(self, shapes: Dict[str, Tuple[int, ...]]
                   ) -> Dict[str, PartitionSpec]:
        """:meth:`grad_spec` of every leaf of ``{name: full shape}``."""
        return {n: self.grad_spec(tuple(s)) for n, s in shapes.items()}

    def opt_state_specs(self, shapes: Dict[str, Tuple[int, ...]]
                        ) -> Dict[str, Dict[str, PartitionSpec]]:
        """The specs of AdamW's moments (JAX ``opt_state_shardings``: any
        leaf that can host the axis is sharded), ``{"mu": {name: spec},
        "nu": {...}}`` over ``{name: full shape}`` of the parameters; the
        step count is a host int."""
        specs = {n: self.state_spec(tuple(s)) for n, s in shapes.items()}
        return {"mu": dict(specs), "nu": dict(specs)}


_LAYER_KEY = re.compile(r"^(.*?layers\.)(\d+)\.(.+)$")


def stack_counts(names: Sequence[str]) -> Dict[str, int]:
    """For each leaf name, the number of leaves the JAX package stacks
    it with: a layer leaf ``<prefix>layers.{i}.<leaf>`` counts the layers
    that hold ``<prefix>...<leaf>``, any other leaf 1. The JAX package's
    size rules (the persistence threshold, qgZ's dense floor) see its
    stacked ``[n_layers, ...]`` leaves, so the port's count them too."""
    groups: Dict[Any, List[str]] = {}
    for n in names:
        m = _LAYER_KEY.match(n)
        groups.setdefault((m.group(1), m.group(3)) if m else n, []).append(n)
    return {n: len(g) for g in groups.values() for n in g}


def qgz_mean(g: torch.Tensor, world: int, qspec, stack: int = 1,
             stats: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """One leaf of JAX's ``tree_hierarchical_pmean`` over ``data``: its
    fp32 mean over the ranks, quantized where the stacked leaf (``stack``
    leaves) reaches the floor of ``4 * world * block`` elements and the
    leaf divides into ``world`` chunks of whole blocks. The quantization
    blocks of a layer's leaf are those of its rows of the stacked leaf,
    so it is quantized element for element as JAX's stacked one."""
    floor = 4 * world * qspec.block
    return ccomm.hierarchical_pmean(
        g.reshape(-1).float(), outer_axis="data", outer_world=world,
        qspec=qspec, min_quant_size=-(-floor // stack),
        stats=stats).reshape(g.shape)


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


def full_shape(shape: Tuple[int, ...], spec: PartitionSpec,
               world: int) -> Tuple[int, ...]:
    """The shape of the leaf whose shard under ``spec`` has ``shape``."""
    d = sharded_dim(spec)
    shape = tuple(shape)
    if d is None or world == 1:
        return shape
    return shape[:d] + (shape[d] * world,) + shape[d + 1:]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ======================================================================
# ZeRO-3 for a model without zero3_blocks: each layer gathered where it runs

_LAYER = re.compile(r"(?:^|\.)layers\.\d+\.")


class _Zero3State:
    """What the views of one micro-batch share: this rank's fp32 master
    shards (leaves that record their gradients), their specs, the data
    group (two or more ranks), the facade's quant specs and error stats,
    and the top-level leaves once gathered."""

    def __init__(self, shards, specs, topo: Topology, dtype, wq, gq, stats,
                 data_local: bool):
        self.shards, self.specs, self.dtype = shards, specs, dtype
        self.stack = stack_counts(list(shards))
        self.dp = topo.data_parallel_size
        self.rank = topo.rank("data")
        self.group = topo.group("data")
        self.wq, self.gq, self.stats = wq, gq, stats
        self.data_local = data_local
        self.top: Optional[Dict[str, torch.Tensor]] = None

    def gather(self, names: Sequence[str], shards: Sequence[torch.Tensor]
               ) -> List[torch.Tensor]:
        """The full leaves of ``names`` in the compute dtype: the cut
        leaves' shards in one all-gather over the data group (booked as
        ``zero3_param_gather``), or each through the facade's quantized
        gather under qwZ; whole leaves cast."""
        xs = [s.detach().to(self.dtype) for s in shards]
        cut = [i for i, n in enumerate(names)
               if sharded_dim(self.specs[n]) is not None]
        if self.wq is not None:
            for i in cut:
                xs[i] = ccomm.gather_param_leaf(
                    xs[i], self.specs[names[i]], outer_axes=("data",),
                    qspec=self.wq, stats=self.stats)
        elif cut:
            flat = torch.cat([xs[i].reshape(-1) for i in cut])
            comm.record_collective("zero3_param_gather", _nbytes(flat),
                                   _nbytes(flat), "data", self.dp)
            parts = comm.all_gather(flat, self.group)
            off = 0
            for i in cut:
                k, shape = xs[i].numel(), xs[i].shape
                xs[i] = torch.cat([p[off:off + k].view(shape) for p in parts],
                                  dim=sharded_dim(self.specs[names[i]]))
                off += k
        return xs

    def reduce(self, names: Sequence[str], shapes, grads) -> List[torch.Tensor]:
        """The gradients of the gathered leaves, upcast to fp32, reduced
        over the data group and cut to this rank's shards
        (:func:`reduce_to_shards`: the cut leaves' summed by a
        reduce-scatter, ``zero3_grad_reduce_scatter``, the whole leaves'
        by an all-reduce, ``zero3_grad_all_reduce``); under qgZ each
        leaf's facade mean (JAX ``tree_hierarchical_pmean``) and then its
        shard. An unused leaf's gradient is zeros."""
        specs = [self.specs[n] for n in names]
        gs = [torch.zeros(full_shape(s, sp, self.dp), dtype=torch.float32,
                          device=self.shards[n].device) if g is None
              else g.float() for n, s, sp, g in zip(names, shapes, specs,
                                                    grads)]
        if self.gq is not None:
            return [shard_of(qgz_mean(g, self.dp, self.gq, self.stack[n],
                                      self.stats), sp, self.rank,
                             self.dp).contiguous()
                    for n, g, sp in zip(names, gs, specs)]
        return reduce_to_shards(gs, specs, self.group, self.rank, self.dp,
                                "zero3_grad")


# a reduce-scatter or all-gather of more elements runs in pieces of about
# this many (256 MiB of fp32), so its staging buffers stay that small
BUCKET_NUMEL = 1 << 26


def buckets(sizes: Sequence[int], limit: int = BUCKET_NUMEL
            ) -> List[List[int]]:
    """Consecutive runs of the indices of ``sizes`` whose sizes add up to
    at most ``limit`` (a larger one alone)."""
    out: List[List[int]] = []
    total = limit
    for i, k in enumerate(sizes):
        if total + k > limit:
            out.append([])
            total = 0
        out[-1].append(i)
        total += k
    return out


def reduce_to_shards(grads: Sequence[torch.Tensor],
                     specs: Sequence[PartitionSpec], group, rank: int,
                     world: int, op: str) -> List[torch.Tensor]:
    """The data group's sum of each of ``grads`` (whole fp32 leaves),
    each rank keeping its piece under its spec: the cut leaves through
    reduce-scatters of their pieces laid out rank by rank (booked as
    ``{op}_reduce_scatter``), the whole ones through all-reduces
    (``{op}_all_reduce``), in buckets of :data:`BUCKET_NUMEL`."""
    out: List[Any] = [None] * len(grads)
    cut = [i for i, sp in enumerate(specs) if sharded_dim(sp) is not None]
    whole = [i for i in range(len(grads)) if i not in cut]
    for run in buckets([grads[i].numel() for i in cut]):
        idx = [cut[j] for j in run]
        pieces = [[shard_of(grads[i], specs[i], r, world) for i in idx]
                  for r in range(world)]
        flat = torch.cat([p.reshape(-1) for row in pieces for p in row])
        comm.record_collective(f"{op}_reduce_scatter", _nbytes(flat),
                               _nbytes(flat), "data", world)
        mine = comm.reduce_scatter(flat, group)
        del flat
        _split_into(out, idx, mine, [p.shape for p in pieces[rank]])
    for run in buckets([grads[i].numel() for i in whole]):
        idx = [whole[j] for j in run]
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        comm.record_collective(f"{op}_all_reduce", _nbytes(flat),
                               _nbytes(flat), "data", world)
        _split_into(out, idx, comm.all_reduce(flat, group=group),
                    [grads[i].shape for i in idx])
    return out


def gather_slices(tensors: Sequence[torch.Tensor],
                  specs: Sequence[PartitionSpec], group, rank: int,
                  world: int, op: str) -> None:
    """In place: every rank's slice of each of ``tensors`` (whole leaves,
    replicated, each rank having written its own slice under its spec)
    into every rank's copy, through all-gathers of the slices (booked as
    ``op``), in buckets of :data:`BUCKET_NUMEL` whole elements."""
    for run in buckets([t.numel() for t in tensors]):
        mine = [shard_of(tensors[i], specs[i], rank, world) for i in run]
        flat = torch.cat([m.reshape(-1) for m in mine])
        comm.record_collective(op, _nbytes(flat), _nbytes(flat), "data",
                               world)
        parts = comm.all_gather(flat, group)
        del flat
        for r, part in enumerate(parts):
            if r == rank:
                continue
            off = 0
            for i, m in zip(run, mine):
                k = m.numel()
                shard_of(tensors[i], specs[i], r, world).copy_(
                    part[off:off + k].view(m.shape))
                off += k


def _split_into(out: list, idx: Sequence[int], flat: torch.Tensor,
                shapes) -> None:
    off = 0
    for i, shape in zip(idx, shapes):
        k = int(np.prod(shape))
        out[i] = flat[off:off + k].view(shape)
        off += k


class _GatherLeaves(torch.autograd.Function):
    """The ZeRO-3 gather as autograd sees it: fp32 master shards in, full
    compute-dtype leaves out; the backward pass reduces the full
    gradients to the shards (what GSPMD inserts around JAX's sharded
    parameters, by hand)."""

    @staticmethod
    def forward(ctx, state, names, *shards):
        ctx.state, ctx.names = state, names
        ctx.shapes = [tuple(s.shape) for s in shards]
        return tuple(state.gather(names, shards))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None,
                *ctx.state.reduce(ctx.names, ctx.shapes, grads))


class Zero3Params(Mapping):
    """The compute view that a model without ``zero3_blocks`` reads under
    ZeRO-3 (the JAX package's GSPMD and qgZ facade paths, the gathers
    placed by hand): keyed like the masters, over this rank's fp32 master
    shards. A layer's leaves (``...layers.{i}.*``) are read as shards
    (:meth:`shard`) and gathered together by :meth:`gather_layer` inside
    the layer's remat region, so only the shards are kept for the backward
    pass and the replay gathers again: one layer's full leaves live at a
    time, besides the top-level leaves (embeddings, head, norms,
    projections), which the first read of any of them gathers for the
    micro-batch. A layer leaf read by name is gathered alone. Every
    gather is :class:`_GatherLeaves`, so the gradients come back reduced
    to the shards. ``compute_dtype`` is what the gathers cast to;
    ``data_local`` asks a model for the loss over this rank's rows alone
    (the qgZ facade's shard_map loss). :meth:`subtree` is the view of a
    ``prefix`` (CLIP's towers)."""

    def __init__(self, state: _Zero3State, prefix: str = ""):
        self._state, self._prefix = state, prefix
        self.compute_dtype = state.dtype
        self.data_local = state.data_local

    def __len__(self) -> int:
        return sum(1 for _ in self)

    def __iter__(self):
        cut = len(self._prefix)
        return (n[cut:] for n in self._state.shards
                if n.startswith(self._prefix))

    def __getitem__(self, name: str) -> torch.Tensor:
        st, full = self._state, self._prefix + name
        if full not in st.shards:
            raise KeyError(name)
        if _LAYER.search(full):
            return self.gather_layer([name], [st.shards[full]])[0]
        if st.top is None:
            names = tuple(n for n in st.shards if not _LAYER.search(n))
            st.top = dict(zip(names, _GatherLeaves.apply(
                st, names, *(st.shards[n] for n in names))))
        return st.top[full]

    def shard(self, name: str) -> torch.Tensor:
        """This rank's fp32 master shard of ``name``."""
        return self._state.shards[self._prefix + name]

    def gather_layer(self, names: Sequence[str],
                     shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The full compute-dtype leaves of ``names`` from their
        ``shards`` (as :meth:`shard` gave them), in one gather."""
        return list(_GatherLeaves.apply(
            self._state, tuple(self._prefix + n for n in names), *shards))

    def subtree(self, prefix: str) -> "Zero3Params":
        return Zero3Params(self._state, self._prefix + prefix)


def zero3_params(shards: Dict[str, torch.Tensor],
                 specs: Dict[str, PartitionSpec], topo: Topology, dtype, *,
                 wq=None, gq=None, stats=None,
                 data_local: bool = False) -> Zero3Params:
    """A :class:`Zero3Params` over ``shards`` for one micro-batch."""
    return Zero3Params(_Zero3State(shards, specs, topo, dtype, wq, gq, stats,
                                   data_local))


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
