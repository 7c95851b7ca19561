"""Activation checkpointing (rematerialization).

Ports ``checkpoint_wrapper`` and ``checkpoint`` of
``deepspeed_tpu/runtime/activation_checkpointing.py``. The JAX package maps
its policies onto ``jax.checkpoint``; here ``"full"`` (save nothing inside
the wrapped function, recompute it all in the backward pass) maps onto
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, and
``None``/``"none"`` returns the function unchanged.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from torch.utils.checkpoint import checkpoint as _torch_checkpoint

# policies of the JAX package that a later slice ports
_LATER = ("selective", "selective_flash", "dots_with_no_batch_dims",
          "nothing")


def checkpoint_wrapper(fn: Callable, policy: Optional[str] = "full",
                       offload: bool = False) -> Callable:
    """``fn`` under remat with ``policy``. Only ``"full"`` and ``None`` /
    ``"none"`` are ported; the selective policies and offloaded residuals
    raise ``NotImplementedError``."""
    if policy in (None, "none"):
        return fn
    if offload or policy in _LATER:
        what = "offloaded residuals" if offload else f"remat policy {policy!r}"
        raise NotImplementedError(
            f"{what} comes with a later slice of deepspeed_tpu_torch "
            f"(ROADMAP.md, Queue A); use 'full' or 'none'")
    if policy != "full":
        raise ValueError(f"unknown remat policy {policy!r}; have "
                         f"{sorted(('full', 'none') + _LATER)}")

    def wrapped(*args):
        return _torch_checkpoint(fn, *args, use_reentrant=False)

    return wrapped


def checkpoint(fn: Callable, *args, policy: Optional[str] = "full",
               offload: bool = False) -> Any:
    """``checkpoint(function, *args)``: run ``fn`` under remat now when
    called with args (Megatron style), else return the wrapped function."""
    wrapped = checkpoint_wrapper(fn, policy=policy, offload=offload)
    return wrapped(*args) if args else wrapped
