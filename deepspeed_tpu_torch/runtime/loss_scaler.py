"""Dynamic loss scaling for fp16.

Ports ``deepspeed_tpu/runtime/loss_scaler.py`` (scale-up window,
hysteresis backoff, min scale). The JAX package keeps the state on the
device and selects with ``jnp.where`` inside its jitted step; here the
state is host scalars and :func:`update` takes the step's finite flag as a
Python bool, with the same transitions.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

import torch


class LossScaleState(NamedTuple):
    scale: float          # current loss scale
    good_steps: int       # consecutive overflow-free steps
    hysteresis: int       # remaining tolerated overflows before backoff


def make_state(initial_scale_power: int = 16, hysteresis: int = 2) -> LossScaleState:
    return LossScaleState(scale=float(2.0 ** initial_scale_power),
                          good_steps=0, hysteresis=int(hysteresis))


def static_state(loss_scale: float) -> LossScaleState:
    return LossScaleState(scale=float(loss_scale), good_steps=0,
                          hysteresis=1 << 30)


def grads_finite(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """0-dim bool tensor: every element of every gradient is finite."""
    flags = [torch.isfinite(g).all() for g in grads]
    if not flags:
        return torch.tensor(True)
    return torch.stack(flags).all()


def finite_everywhere(finite: bool, device) -> bool:
    """``finite`` and every other rank's (a MIN all-reduce over the
    world): one rank's overflow in its shard skips the step on every
    rank, as the JAX package's flag over the global gradient tree
    does."""
    import torch.distributed as dist

    from ..comm import comm

    flag = torch.tensor(float(finite), device=device)
    comm.record_collective("all_reduce", 4, 4, None, comm.get_world_size())
    return bool(comm.all_reduce(flag, op=dist.ReduceOp.MIN) > 0)


def update(state: LossScaleState, finite: bool, *, dynamic: bool = True,
           scale_window: int = 1000, scale_factor: float = 2.0,
           min_scale: float = 1.0, max_scale: float = 2.0 ** 24,
           consecutive_hysteresis: bool = False,
           init_hysteresis: int = 2) -> LossScaleState:
    """One scaler step: on overflow consume hysteresis, then halve (not
    below ``min_scale``) and reset the hysteresis; after ``scale_window``
    clean steps double (not above ``max_scale``). A clean step restores
    the hysteresis only with ``consecutive_hysteresis``."""
    if not dynamic:
        return state
    if finite:
        good = state.good_steps + 1
        grow = good >= scale_window
        return LossScaleState(
            scale=min(state.scale * scale_factor, max_scale) if grow
            else state.scale,
            good_steps=0 if grow else good,
            hysteresis=init_hysteresis if consecutive_hysteresis
            else state.hysteresis)
    hys = state.hysteresis - 1
    backoff = hys <= 0
    return LossScaleState(
        scale=max(state.scale / scale_factor, min_scale) if backoff
        else state.scale,
        good_steps=0,
        hysteresis=init_hysteresis if backoff else hys)
