"""Process groups, the transport helper and the comms ledger.

Ports the host-level half of ``deepspeed_tpu/comm/comm.py``:
``init_distributed``, ``get_rank``, ``get_world_size``, ``get_local_rank``,
``barrier``, and the ``CommsLogger`` with ``record_collective``,
``configure_comms_logger`` and ``get_comms_logger``. The JAX package's
in-program collectives are ``jax.lax`` primitives inside ``shard_map``;
here each rank is a process and a collective is a ``torch.distributed``
call on the process group of a mesh axis (``parallel/mesh.py``). The
facade (``comm/compressed.py``), ZeRO's placement
(``parallel/zero.py``, ``runtime/engine.py``) and the tensor-parallel
model group's helpers at the end of this file (:func:`broadcast_record`, and the
differentiable :func:`tp_sum`, :func:`tp_copy` and :func:`tp_gather`
that the model's forward and backward passes run through, serving and
training alike) are the callers of the raw collectives below, and each
books its calls in the ledger.

Backends: ``"nccl"`` for CUDA tensors (the default), ``"gloo"`` when asked.
Nothing switches backend on failure. NCCL refuses two ranks on one
device, so :func:`init_distributed` raises :class:`SharedDeviceError`
before it tries; gloo takes them, which is how one card runs several
ranks. gloo moves host memory only: :func:`to_transport` copies a device
tensor to page-locked host memory (PyTorch's caching host allocator
keeps the buffers) before a gloo call and :func:`from_transport` copies
the result back, explicitly, and nowhere else.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from ..telemetry.registry import get_registry
from ..utils.logging import logger

BACKENDS = ("nccl", "gloo")


class SharedDeviceError(RuntimeError):
    """NCCL was asked for more ranks than this host has devices."""


# ----------------------------------------------------------------------
# comms ledger (reference utils/comms_logging.py)

@dataclass
class CommsLogger:
    """Per-op counts and sizes of the facade's collectives, with the
    bytes-on-wire ledger: for each (op, logical size) the cumulative
    physical bytes, which differ from the logical payload only for
    compressed collectives (quantized ints + scales). Off unless
    :func:`configure_comms_logger` turns it on."""

    enabled: bool = False
    verbose: bool = False
    records: Dict[str, Dict[int, int]] = field(default_factory=dict)
    wire: Dict[tuple, float] = field(default_factory=dict)

    def append(self, op_name: str, size_bytes: int, world: int,
               axis_name: Optional[str] = None,
               wire_bytes: Optional[int] = None) -> None:
        if not self.enabled:
            return
        per_op = self.records.setdefault(op_name, {})
        per_op[size_bytes] = per_op.get(size_bytes, 0) + 1
        wire = size_bytes if wire_bytes is None else int(wire_bytes)
        key = (op_name, size_bytes)
        self.wire[key] = self.wire.get(key, 0.0) + wire
        reg = get_registry()
        reg.counter(f"comm/{op_name}/calls").inc()
        reg.counter(f"comm/{op_name}/bytes").inc(size_bytes)
        reg.counter(f"comm/{op_name}/wire_bytes").inc(wire)
        if self.verbose:
            logger.info(f"comm op: {op_name} | msg size: {size_bytes} B | "
                        f"wire: {wire} B | axis: {axis_name} | world: "
                        f"{world}")

    def snapshot_totals(self) -> Dict[str, Dict[str, float]]:
        """{op: {count, bytes, wire_bytes}} over everything recorded."""
        out: Dict[str, Dict[str, float]] = {}
        for op, sizes in self.records.items():
            count = sum(sizes.values())
            nbytes = sum(s * c for s, c in sizes.items())
            wire = sum(self.wire.get((op, s), s * c) for s, c in sizes.items())
            out[op] = {"count": float(count), "bytes": float(nbytes),
                       "wire_bytes": float(wire)}
        return out

    def reset(self) -> None:
        self.records.clear()
        self.wire.clear()


_COMMS_LOGGER = CommsLogger()


def get_comms_logger() -> CommsLogger:
    return _COMMS_LOGGER


def configure_comms_logger(enabled: bool, verbose: bool = False) -> None:
    _COMMS_LOGGER.enabled = enabled
    _COMMS_LOGGER.verbose = verbose


# chaos hook: resilience.chaos.install_fault_injector points this at the
# installed FaultInjector's on_collective (delay / fail injection, as
# ``deepspeed_tpu/comm/comm.py``'s hook). None = no overhead on a call.
_CHAOS_HOOK = None


def _chaos(op: str) -> None:
    if _CHAOS_HOOK is not None:
        _CHAOS_HOOK(op)


def record_collective(op: str, logical_bytes: int, wire_bytes: int,
                      axis_name: Optional[str] = None, world: int = 0) -> None:
    """Ledger entry for a facade-issued collective: ``logical_bytes`` is
    what the uncompressed path would move per rank, ``wire_bytes`` the
    payload actually sent (quantized values + scales).

    Fires the chaos hook under ``op`` first, as the JAX package does, so a
    ``FaultInjector(collective_fail_op=op)`` fails the caller before the
    row is booked (the hand-off's ``export_kv`` books ``kv_handoff``, a
    prefix export ``kv_adopt``). A facade call whose transport goes
    through the raw wrappers below also fires the primitive's name there
    (``all_gather``, ``all_reduce``, ...), on every call. The JAX
    package's facade calls ``jax.lax`` directly: it fires its op name
    only, once per traced program, so a fault aimed at a primitive's
    name reaches facade traffic in the port and not in the JAX package."""
    _chaos(op)
    _COMMS_LOGGER.append(op, int(logical_bytes), world, axis_name,
                         wire_bytes=int(wire_bytes))


# ----------------------------------------------------------------------
# process management

def init_distributed(dist_backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     local_rank: Optional[int] = None,
                     timeout_s: float = 600.0) -> None:
    """Join the process group (idempotent). ``dist_backend`` is ``"nccl"``
    (default) or ``"gloo"``; ``init_method`` (default ``env://``),
    ``world_size`` and ``rank`` default to ``WORLD_SIZE`` / ``RANK`` from
    the environment. With CUDA, each rank takes device ``local_rank %
    device_count`` (``local_rank`` defaults to ``LOCAL_RANK``, else the
    rank). NCCL with more ranks on this host than devices raises
    :class:`SharedDeviceError`: pass ``dist_backend="gloo"``."""
    if dist.is_initialized():
        return
    backend = dist_backend or "nccl"
    if backend not in BACKENDS:
        raise ValueError(f"dist_backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    world_size = int(world_size if world_size is not None
                     else os.environ.get("WORLD_SIZE", "1"))
    rank = int(rank if rank is not None else os.environ.get("RANK", "0"))
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("dist_backend='nccl' needs CUDA; pass "
                               "dist_backend='gloo' to run on the CPU")
        if local_world > torch.cuda.device_count():
            raise SharedDeviceError(
                f"{local_world} ranks on a host with "
                f"{torch.cuda.device_count()} CUDA device(s): NCCL refuses "
                f"two ranks on one device; pass dist_backend='gloo', whose "
                f"payloads go through host memory")
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    logger.info(f"torch.distributed initialized: rank {rank}/{world_size} "
                f"over {backend}")


def is_initialized() -> bool:
    return dist.is_initialized()


def get_rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def get_world_size(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def get_local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", get_rank()))


def barrier(group=None) -> None:
    _chaos("barrier")
    if dist.is_initialized():
        dist.barrier(group)


def destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


# ----------------------------------------------------------------------
# transport: the raw collectives the facade composes

def uses_host_transport(group=None) -> bool:
    """Whether ``group`` moves host memory (gloo)."""
    return dist.get_backend(group) == "gloo"


def to_transport(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` as the group's backend takes it: contiguous, and copied to
    page-locked host memory under gloo (the one place a device payload is
    staged; the copy waits for it)."""
    t = t.contiguous()
    if uses_host_transport(group) and t.device.type != "cpu":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t)
    return t


def from_transport(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A received buffer back on ``device`` (a copy only under gloo)."""
    return t if t.device == device else t.to(device)


def _empty_like_on(t: torch.Tensor, shape=None) -> torch.Tensor:
    """A buffer like ``t`` (page-locked where ``t`` is: a staged payload's
    receive buffers copy back to the device from it)."""
    pinned = t.device.type == "cpu" and t.is_pinned()
    return torch.empty(t.shape if shape is None else shape, dtype=t.dtype,
                       device=t.device, pin_memory=pinned)


def all_gather(x: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's ``x``, in group-rank order, on ``x``'s device."""
    _chaos("all_gather")
    w = to_transport(x, group)
    parts = [_empty_like_on(w) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, w, group=group)
    return [from_transport(p, x.device) for p in parts]


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x [world, ...]``: row r goes to group rank r; row r of the result
    came from group rank r."""
    _chaos("all_to_all")
    w = to_transport(x, group)
    out = _empty_like_on(w)
    dist.all_to_all_single(out, w, group=group)
    return from_transport(out, x.device)


def all_reduce(x: torch.Tensor, op=dist.ReduceOp.SUM,
               group=None) -> torch.Tensor:
    """A new tensor: ``op`` over the group's ``x`` (order up to the
    backend)."""
    _chaos("all_reduce")
    w = to_transport(x, group)
    if w is x:
        w = x.clone()
    dist.all_reduce(w, op=op, group=group)
    return from_transport(w, x.device)


def reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x [world * n]`` summed over the group (order up to the backend);
    group rank r gets elements ``[r * n, (r + 1) * n)`` of the sum, on
    ``x``'s device. ``dist.reduce_scatter_single`` where this torch has
    it (it replaces ``reduce_scatter_tensor``, which newer releases
    deprecate); the two are one call."""
    _chaos("reduce_scatter")
    world = dist.get_world_size(group)
    if x.dim() != 1 or x.numel() % world:
        raise ValueError(f"reduce_scatter takes a flat tensor of a multiple "
                         f"of {world} elements, got {tuple(x.shape)}")
    w = to_transport(x, group)
    out = _empty_like_on(w, (x.numel() // world,))
    call = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    call(out, w, group=group)
    return from_transport(out, x.device)


class PendingRecv:
    """An issued ring hop: :meth:`wait` returns what the predecessor sent,
    on the sender's device."""

    def __init__(self, works, buf: torch.Tensor, sent: torch.Tensor,
                 device: torch.device):
        self._works, self._buf, self._sent = works, buf, sent
        self._device = device

    def wait(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        self._sent = None
        return from_transport(self._buf, self._device)


def ring_send_recv(x: torch.Tensor, group=None) -> PendingRecv:
    """Send ``x`` to the group's next rank and receive the previous
    rank's, asynchronously (``isend`` / ``irecv``): the call returns once
    both are issued."""
    _chaos("ppermute")
    world = dist.get_world_size(group)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % world) if group else \
        (me + 1) % world
    prv = dist.get_global_rank(group, (me - 1) % world) if group else \
        (me - 1) % world
    w = to_transport(x, group)
    buf = _empty_like_on(w)
    works = [dist.isend(w, nxt, group=group), dist.irecv(buf, prv, group=group)]
    return PendingRecv(works, buf, w, x.device)


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Group rank ``src``'s ``t`` on every rank of the group; the other
    ranks pass a buffer of the same shape and dtype. On ``t``'s device."""
    _chaos("broadcast")
    w = to_transport(t, group)
    root = dist.get_global_rank(group, src) if group is not None else src
    dist.broadcast(w, root, group=group)
    return from_transport(w, t.device)


def gather(x: torch.Tensor, group=None, dst: int = 0
           ) -> Optional[List[torch.Tensor]]:
    """Every rank's ``x`` on group rank ``dst``, in group-rank order, on
    ``x``'s device; None on the other ranks."""
    _chaos("gather")
    w = to_transport(x, group)
    mine = get_rank(group) == dst
    parts = [_empty_like_on(w) for _ in range(dist.get_world_size(group))] \
        if mine else None
    root = dist.get_global_rank(group, dst) if group is not None else dst
    dist.gather(w, parts, dst=root, group=group)
    return [from_transport(p, x.device) for p in parts] if mine else None


def scatter(parts: Optional[List[torch.Tensor]], out: torch.Tensor,
            group=None, src: int = 0) -> torch.Tensor:
    """Group rank ``src``'s ``parts[r]`` on group rank ``r``: every rank
    passes ``out``, a buffer of its part's shape and dtype, and gets its
    part on ``out``'s device; only ``src`` passes ``parts``."""
    _chaos("scatter")
    w = to_transport(out, group)
    sent = None if parts is None else [to_transport(p, group) for p in parts]
    root = dist.get_global_rank(group, src) if group is not None else src
    dist.scatter(w, sent, src=root, group=group)
    return from_transport(w, out.device)


# ----------------------------------------------------------------------
# the model group's collectives that the facade does not carry: tensor
# parallelism sends the controller's host step records (inference/ragged.py)

def broadcast_record(record: Optional[Dict[str, Any]], group=None,
                     axis_name: Optional[str] = None,
                     src: int = 0, op: str = "step_record"
                     ) -> Dict[str, Any]:
    """A host step record (a dict of plain ints and strings and integer
    numpy arrays) from group rank ``src`` to every rank of the group; the
    other ranks pass None and get the record. Two broadcasts: the
    payload's length, then the pickled payload. Booked as ``op`` with
    the payload's bytes."""
    me = get_rank(group)
    if me == src:
        payload = torch.frombuffer(bytearray(pickle.dumps(record)),
                                   dtype=torch.uint8)
        size = torch.tensor([payload.numel()], dtype=torch.int64)
    else:
        size = torch.zeros(1, dtype=torch.int64)
    size = broadcast(size, src, group)
    n = int(size[0])
    if me != src:
        payload = torch.empty(n, dtype=torch.uint8)
    payload = broadcast(payload, src, group)
    record_collective(op, n + 8, n + 8, axis_name,
                      get_world_size(group))
    return record if me == src else pickle.loads(payload.numpy().tobytes())


# ----------------------------------------------------------------------
# the tensor-parallel model's collectives, differentiable: what GSPMD
# inserts in the JAX package's forward and backward passes, explicit.
# Without autograd recording (serving) each is its forward alone. Each
# books itself in the ledger where it moves data (the forward of tp_sum
# and tp_gather, the backward of tp_copy and of a summed tp_gather), so a
# remat replay's collectives are counted too.

def _book(op: str, x: torch.Tensor, group, axis_name) -> None:
    """A ledger row: ``op`` of ``x``'s bytes on the group."""
    nbytes = x.numel() * x.element_size()
    record_collective(op, nbytes, nbytes, axis_name, get_world_size(group))


def group_sum(x: torch.Tensor, group, axis_name: Optional[str] = None
              ) -> torch.Tensor:
    """The group's sum of ``x`` (no gradient), booked as an
    ``all_reduce``."""
    _book("all_reduce", x, group, axis_name)
    return all_reduce(x, group=group)


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis_name):
        return group_sum(x, group, axis_name)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis_name):
        ctx.group, ctx.axis_name = group, axis_name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return group_sum(g, ctx.group, ctx.axis_name), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis_name, dim, sum_grad):
        ctx.group, ctx.axis_name, ctx.sum_grad = group, axis_name, sum_grad
        ctx.dim, ctx.n = dim, x.shape[dim]
        _book("all_gather", x, group, axis_name)
        return torch.cat(all_gather(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grad:
            g = group_sum(g, ctx.group, ctx.axis_name)
        mine = g.narrow(ctx.dim, get_rank(ctx.group) * ctx.n, ctx.n)
        return mine.contiguous(), None, None, None, None


def tp_sum(x: torch.Tensor, group, axis_name: str = "model"
           ) -> torch.Tensor:
    """The group's sum of ``x`` (a row-parallel partial product, the
    vocab-parallel embedding's rows); the backward pass hands the
    gradient through unchanged: every rank's partial fed the same sum."""
    return _Sum.apply(x, group, axis_name)


def tp_copy(x: torch.Tensor, group, axis_name: str = "model"
            ) -> torch.Tensor:
    """``x`` itself (a replicated activation entering a column-parallel
    weight); the backward pass sums the ranks' input gradients over the
    group, each rank's being its columns' part."""
    return _Copy.apply(x, group, axis_name)


def tp_gather(x: torch.Tensor, group, dim: int = -1,
              axis_name: str = "model", sum_grad: bool = False
              ) -> torch.Tensor:
    """Every rank's ``x`` joined along ``dim`` in group-rank order; the
    backward pass takes this rank's part of the gradient. Every rank of
    the group must compute the same function of the joined tensor (the
    head's logits under the same loss): then that part is the whole
    gradient. With ``sum_grad`` (each rank's loss is its share of a sum,
    as the data-parallel CLIP loss is), the gradient is summed over the
    group before the part is taken."""
    return _Gather.apply(x, group, axis_name, dim % x.dim(), sum_grad)
