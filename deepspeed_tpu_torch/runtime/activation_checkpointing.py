"""Activation checkpointing (rematerialization).

Ports ``deepspeed_tpu/runtime/activation_checkpointing.py``:
``checkpoint_wrapper``, ``checkpoint``, ``configure`` / ``is_configured``
(the process-wide default that ``checkpoint_wrapper(policy=None)`` reads),
``model_parallel_cuda_manual_seed`` and ``get_rng_state_tracker``. The
JAX package maps its policies onto ``jax.checkpoint`` policies; here each
maps onto ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``
with a selective-checkpoint policy (``create_selective_checkpoint_
contexts``): an op the policy saves keeps its output from the forward
pass, every other op of the region runs again in the backward pass.

==========================  =============================================
policy                      saved (everything else recomputed)
==========================  =============================================
``"full"``                  nothing but the region's inputs
``"selective"``             the dots (JAX ``checkpoint_dots``)
``"selective_flash"``       the dots and the flash-attention op's
                            (out, lse) (JAX: dots + the names
                            ``flash_out`` / ``flash_lse``)
``"dots_with_no_batch_dims"``  the dots without batch dimensions
``"nothing"``               everything: the function runs without remat
                            (JAX ``everything_saveable``)
``None`` / ``"none"``       the function unchanged
==========================  =============================================

Which aten ops are "dots", ruled from the ops JAX's policies test
(``dot_general`` and ``conv_general_dilated`` for ``checkpoint_dots``,
``dot_general`` without batch dimensions for the other):

* ``aten.mm`` (``torch.matmul`` of an activation ``[..., d]`` and a 2-D
  weight folds to it: JAX's ``h @ w`` is a ``dot_general`` with no batch
  dimensions), its ``out_dtype`` overload ``aten.mm.dtype`` (the
  tensor-parallel ``_MatmulFp32``: JAX's ``preferred_element_type``
  product is the same ``dot_general``) and ``aten.addmm``: dots without
  batch dimensions;
* ``aten.bmm`` / ``aten.baddbmm`` (an einsum with batch dimensions, the
  plain attention's ``bqhd,bkhd->bhqk``): dots with batch dimensions,
  saved by ``selective`` and not by ``dots_with_no_batch_dims``;
* ``aten.convolution``: saved by ``selective`` (JAX's
  ``conv_general_dilated``), not a dot without batch dimensions;
* ``aten._grouped_mm`` (the MoE expert banks on the card): JAX's
  ``jax.lax.ragged_dot`` is its own primitive, which neither policy
  names, so it is recomputed. The MoE loop route the CPU takes runs a
  ``torch.matmul`` a group, which these rules save as dots: a difference
  of memory only, the values are the same.
* the flash-attention op (``ops/flash_attention.py``, a dispatcher op so
  that a policy sees it): saved only by ``selective_flash``.

Offloaded residuals (``offload=True``, the config's
``cpu_checkpointing``) follow JAX's ``offload_dot_products``: the dots'
outputs are copied to pinned host memory in the forward pass and copied
back where the backward pass's recomputation reaches them; everything
else is recomputed. (The JAX package's own ``jax.checkpoint_policies``
has no ``offload_dot_products`` in the version its tests run, and falls
back to full remat there; the values are the same either way.)

The random state needs no tracker: the port's random ops draw from
generators their callers seed (``TrainEngine`` a generator a
micro-batch, an MoE gate's from it), so a replay draws the same numbers.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)
from torch.utils.checkpoint import checkpoint as _torch_checkpoint

from ..config import ActivationCheckpointingConfig
from ..utils.logging import log_dist

aten = torch.ops.aten

# dots without batch dimensions (JAX dot_general with empty batch dims)
_DOTS_NO_BATCH = frozenset({aten.mm.default, aten.mm.dtype,
                            aten.addmm.default})
# every dot and convolution (JAX checkpoint_dots)
_DOTS = _DOTS_NO_BATCH | {aten.bmm.default, aten.baddbmm.default,
                          aten.convolution.default}


def _flash_ops() -> frozenset:
    from ..ops import flash_attention  # noqa: F401 (registers the op)

    return frozenset({torch.ops.dst.flash_attention.default})


def _saving(ops: Callable[[], frozenset]) -> Callable:
    """A selective-checkpoint policy that saves the outputs of ``ops()``
    and recomputes every other op."""
    saved = []

    def policy(ctx, op, *args, **kwargs):
        if not saved:
            saved.append(ops())
        return (CheckpointPolicy.MUST_SAVE if op in saved[0]
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return policy


# the policies that run under selective checkpointing: name -> the ops
# whose outputs are saved
_SELECTIVE = {
    "selective": lambda: _DOTS,
    "selective_flash": lambda: _DOTS | _flash_ops(),
    "dots_with_no_batch_dims": lambda: _DOTS_NO_BATCH,
}
POLICIES = ("full", "nothing", *_SELECTIVE)

_config = ActivationCheckpointingConfig()
_configured = False


def configure(config: Optional[ActivationCheckpointingConfig] = None,
              **kwargs) -> None:
    """Set the process-wide default (the reference's ``configure()``):
    a config block and / or its fields as keywords."""
    global _config, _configured
    if config is not None:
        _config = config
    for k, v in kwargs.items():
        if hasattr(_config, k):
            setattr(_config, k, v)
    _configured = True
    log_dist(f"activation checkpointing configured: {_config}")


def is_configured() -> bool:
    return _configured


class _OffloadSave(TorchDispatchMode):
    """The forward pass of an offloaded region: each dot's output is
    copied to (pinned) host memory as it is made."""

    def __init__(self, storage):
        super().__init__()
        self.storage = storage

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _DOTS:
            held = out.detach()
            if held.device.type == "cuda":
                host = torch.empty(held.shape, dtype=held.dtype,
                                   pin_memory=True)
                host.copy_(held, non_blocking=True)
                held = (host, out.device)
            else:
                held = (held, None)
            self.storage[func].append(held)
        return out


class _OffloadRestore(TorchDispatchMode):
    """The recomputation of an offloaded region: a dot is not run again;
    its output comes back from host memory, in the forward's order."""

    def __init__(self, storage):
        super().__init__()
        self.storage = storage

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _DOTS and self.storage[func]:
            held, device = self.storage[func].pop(0)
            return held if device is None else held.to(device,
                                                       non_blocking=True)
        return func(*args, **(kwargs or {}))


def _offload_contexts():
    storage = defaultdict(list)
    return _OffloadSave(storage), _OffloadRestore(storage)


def checkpoint_wrapper(fn: Callable, policy: Optional[str] = None,
                       offload: Optional[bool] = None) -> Callable:
    """``fn`` under remat with ``policy`` (None: the configured default,
    ``"full"`` unless :func:`configure` set another); ``offload`` (None:
    the configured ``cpu_checkpointing``) keeps the dots' outputs in host
    memory and recomputes the rest, whatever the policy."""
    policy = policy if policy is not None else _config.policy
    if policy in (None, "none"):
        return fn
    offload = offload if offload is not None else _config.cpu_checkpointing
    if policy not in POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; have "
                         f"{sorted(POLICIES)}")
    if offload:
        context_fn = _offload_contexts
    elif policy == "nothing":
        return fn
    elif policy == "full":
        context_fn = None
    else:
        ops = _SELECTIVE[policy]

        def context_fn():
            return create_selective_checkpoint_contexts(_saving(ops))

    def wrapped(*args):
        if context_fn is None:
            return _torch_checkpoint(fn, *args, use_reentrant=False)
        return _torch_checkpoint(fn, *args, use_reentrant=False,
                                 context_fn=context_fn)

    return wrapped


def checkpoint(fn: Callable, *args, policy: Optional[str] = None,
               offload: Optional[bool] = None) -> Any:
    """``checkpoint(function, *args)``: run ``fn`` under remat now when
    called with args (Megatron style), else return the wrapped function."""
    wrapped = checkpoint_wrapper(fn, policy=policy, offload=offload)
    return wrapped(*args) if args else wrapped


def model_parallel_cuda_manual_seed(seed: int) -> None:
    """The Megatron name, kept for callers: the port's random ops draw
    from generators their callers seed, so there is no per-rank CUDA
    state to seed."""
    log_dist(f"model_parallel_cuda_manual_seed({seed}): seeded generators "
             f"- no-op")


def get_rng_state_tracker():
    return None
