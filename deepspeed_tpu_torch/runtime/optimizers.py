"""Optimizers: Adam / AdamW with the JAX package's arithmetic.

Ports ``adam``, ``adamw``, ``AdamState`` and ``build_optimizer`` of
``deepspeed_tpu/runtime/optimizers.py`` for the two Adam rules, and
``global_norm`` of ``deepspeed_tpu/runtime/engine.py`` (and
:func:`sharded_global_norm`, the same norm over a tensor-parallel rank's
shards). The interface is
the JAX package's optax-style ``Transform(init, update)`` over dicts of
tensors, except that ``update`` steps the parameters and the state IN
PLACE (JAX returns new arrays; on the card that would hold a second copy
of the fp32 master weights and both moments) and returns the new state.

The arithmetic is copied from the JAX rule, not taken from
``torch.optim.AdamW``, so the rounding is the reference's:
``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``,
``step = (m / c1) / (sqrt(v / c2) + eps) + wd p`` and ``p += -lr step``,
with ``c1 = 1 - b1^count`` and ``c2 = 1 - b2^count`` in fp32 and the
learning rate read at ``count`` after the increment.

Under ZeRO stages 1-3 the trainer passes ``init`` and ``update`` this
rank's slices of each leaf (views into the whole masters, with the
gradients' matching slices), so the moments are the rank's shards and
the update writes through the views; Adam is elementwise, so a slice's
update is the whole leaf's on those elements.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..utils.logging import logger

Params = Dict[str, torch.Tensor]


class Transform(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Params], Any]   # (grads, state, params) -> state


class AdamState(NamedTuple):
    count: int
    mu: Params
    nu: Params


def _lr_at(lr, count: int) -> float:
    return float(lr(count)) if callable(lr) else float(lr)


def adam(lr=1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
         weight_decay: float = 0.0, adam_w_mode: bool = True,
         bias_correction: bool = True) -> Transform:
    """Adam / AdamW (decoupled weight decay when ``adam_w_mode``). ``lr`` is
    a float or a schedule ``count -> lr``."""
    b1, b2 = (float(b) for b in betas)

    def init(params: Params) -> AdamState:
        return AdamState(
            count=0,
            mu={n: torch.zeros_like(p, dtype=torch.float32)
                for n, p in params.items()},
            nu={n: torch.zeros_like(p, dtype=torch.float32)
                for n, p in params.items()})

    @torch.no_grad()
    def update(grads: Params, state: AdamState, params: Params) -> AdamState:
        count = state.count + 1
        lr_t = _lr_at(lr, count)
        if bias_correction:
            c1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
            c2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        else:
            c1 = c2 = 1.0
        for n, p in params.items():
            g = grads[n].float()
            if weight_decay and not adam_w_mode:
                g = g + p.float() * weight_decay      # classic L2 mode
            m, v = state.mu[n], state.nu[n]
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g.square().mul_(1 - b2))
            step = (m / c1).div_((v / c2).sqrt_().add_(eps))
            if weight_decay and adam_w_mode:
                step.add_(p.float() * weight_decay)
            p.add_(step.mul_(-lr_t).to(p.dtype))
        return AdamState(count, state.mu, state.nu)

    return Transform(init, update)


def adamw(lr=1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
          weight_decay: float = 0.01) -> Transform:
    return adam(lr, betas, eps, weight_decay, adam_w_mode=True)


OPTIMIZER_REGISTRY = {"adam": adam, "adamw": adamw, "fusedadam": adam}
# the JAX package's other rules; each comes with a later slice
_LATER = ("sgd", "lamb", "fusedlamb", "lion", "fusedlion", "adagrad",
          "cpuadam", "deepspeedcpuadam", "cpulion", "cpuadagrad",
          "onebitadam", "zerooneadam", "onebitlamb")


def build_optimizer(name: str, params_dict: Optional[dict] = None,
                    lr_schedule: Optional[Callable] = None) -> Transform:
    """Build from config ``{"type": ..., "params": {...}}`` with the
    reference's spellings (lr, betas, eps, weight_decay, bias_correction,
    adam_w_mode / adamw_mode); a schedule, when given, replaces ``lr``."""
    key = name.lower().replace("_", "").replace("-", "")
    if key in _LATER:
        raise NotImplementedError(
            f"optimizer '{name}' comes with a later slice of "
            f"deepspeed_tpu_torch (ROADMAP.md, Queue A); use adam or adamw")
    if key not in OPTIMIZER_REGISTRY:
        raise ValueError(f"Unknown optimizer '{name}'. Known: "
                         f"{sorted(OPTIMIZER_REGISTRY)}")
    factory = OPTIMIZER_REGISTRY[key]
    kwargs = dict(params_dict or {})
    kwargs.pop("torch_adam", None)
    if "adamw_mode" in kwargs:
        kwargs["adam_w_mode"] = bool(kwargs.pop("adamw_mode"))
    if lr_schedule is not None:
        kwargs["lr"] = lr_schedule
    sig = inspect.signature(factory)
    accepted = {k: v for k, v in kwargs.items() if k in sig.parameters}
    dropped = set(kwargs) - set(accepted)
    if dropped:
        logger.warning(f"Optimizer '{name}': ignoring unsupported params "
                       f"{sorted(dropped)}")
    if "betas" in accepted:
        accepted["betas"] = tuple(accepted["betas"])
    return factory(**accepted)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over tensors of sum(g^2) in fp32 (0-dim tensor)."""
    grads = list(grads)
    if not grads:
        return torch.zeros([])
    return torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()


def sharded_global_norm(sharded, replicated, group) -> torch.Tensor:
    """The global norm of a tree cut over a model group, as JAX's
    ``global_norm`` over the global arrays: the square root of the group's
    sum of this rank's ``sharded`` leaves' squared sums, plus the
    ``replicated`` leaves' (each the same on every rank of the group, so
    counted once, not once a rank)."""
    from ..comm import comm

    sharded, replicated = list(sharded), list(replicated)
    dev = (sharded or replicated)[0].device
    zero = torch.zeros((), device=dev)
    sq = torch.stack([g.float().square().sum() for g in sharded]).sum() \
        if sharded else zero
    sq = comm.group_sum(sq, group, "model")
    if replicated:
        sq = sq + torch.stack([g.float().square().sum()
                               for g in replicated]).sum()
    return sq.sqrt()
