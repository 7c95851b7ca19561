"""Optimizers with the JAX package's arithmetic.

Ports every rule of ``deepspeed_tpu/runtime/optimizers.py`` (``adam``,
``adamw``, ``sgd``, ``lamb``, ``lion``, ``adagrad`` and their states), its
registry with the reference's aliases, ``build_optimizer`` and
``as_transform``, and
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
the update writes through the views; Adam, SGD, Lion and Adagrad are
elementwise, so a slice's update is the whole leaf's on those elements.
LAMB's trust ratio reads each leaf's norms, where a leaf is the JAX
tree's (a stacked per-layer leaf is all its layers): the engine gives its
update the group's sums of the slices' squares (``leaf_sq_sums``).
"""

from __future__ import annotations

import inspect
import re
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..utils.logging import logger

Params = Dict[str, torch.Tensor]


class Transform(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[..., Any]     # (grads, state, params) -> state
    #: the update takes ``leaf_sq_sums`` (LAMB's whole-leaf norms)
    leaf_norms: bool = False
    #: the update of a sub-dict of leaves (with the same ``count``) is the
    #: whole update's on those leaves: ZeRO offload then streams the state
    #: a few leaves at a time (``runtime/swap_tensor.py`` ``LeafStream``)
    separable: bool = False


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

    return Transform(init, update, separable=True)


def adamw(lr=1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
          weight_decay: float = 0.01) -> Transform:
    return adam(lr, betas, eps, weight_decay, adam_w_mode=True)


class SgdState(NamedTuple):
    count: int
    momentum: Optional[Params]


def sgd(lr=1e-3, momentum: float = 0.0, weight_decay: float = 0.0,
        nesterov: bool = False) -> Transform:
    """SGD with optional momentum (heavy-ball ``m = momentum m + g``, or
    Nesterov's ``g + momentum m``) and L2 weight decay folded into the
    gradient."""

    def init(params: Params) -> SgdState:
        mom = {n: torch.zeros_like(p, dtype=torch.float32)
               for n, p in params.items()} if momentum else None
        return SgdState(count=0, momentum=mom)

    @torch.no_grad()
    def update(grads: Params, state: SgdState, params: Params) -> SgdState:
        count = state.count + 1
        lr_t = _lr_at(lr, count)
        for n, p in params.items():
            g = grads[n]
            if weight_decay:
                g = g + p.to(g.dtype) * weight_decay
            if momentum:
                m = state.momentum[n]
                m.mul_(momentum).add_(g.float())
                eff = g.float() + m * momentum if nesterov else m
            else:
                eff = g
            p.add_((eff * -lr_t).to(p.dtype))
        return SgdState(count, state.momentum)

    return Transform(init, update, separable=True)


class LambState(NamedTuple):
    count: int
    mu: Params
    nu: Params


_LAYER_INDEX = re.compile(r"(^|\.)layers\.\d+\.")


def stack_key(name: str) -> str:
    """The JAX tree's leaf that holds ``name``: a per-layer leaf
    ``layers.<i>.<leaf>`` is one layer of the stacked ``layers.<leaf>``."""
    return _LAYER_INDEX.sub(r"\1layers.", name)


def lamb(lr=1e-3, betas=(0.9, 0.999), eps: float = 1e-6,
         weight_decay: float = 0.0, min_trust: float = 0.01,
         max_trust: float = 10.0) -> Transform:
    """LAMB: Adam's step ``u`` scaled by each leaf's trust ratio
    ``clip(|w| / |u|, min_trust, max_trust)`` (1 where either norm is 0).

    A leaf is the JAX tree's: the per-layer leaves ``layers.<i>.<leaf>``
    of a stacked leaf share one trust ratio, from the norms over all
    their layers (:func:`stack_key`). The norms are the WHOLE leaf's:
    ``update`` takes ``leaf_sq_sums``, a function from ``{name: [sum(w^2),
    sum(u^2)] of this rank's slice}`` to the same sums over the group
    that holds the leaf; the engine passes one under ZeRO stages 1-3 and
    tensor parallelism (the transform's ``leaf_norms`` asks for it).
    Without it the slices are the leaves. Two passes: the sums first,
    then the update, with ``u`` computed again rather than held for
    every leaf at once."""
    b1, b2 = (float(b) for b in betas)

    def init(params: Params) -> LambState:
        return LambState(
            count=0,
            mu={n: torch.zeros_like(p, dtype=torch.float32)
                for n, p in params.items()},
            nu={n: torch.zeros_like(p, dtype=torch.float32)
                for n, p in params.items()})

    def step_of(m, v, p, c1, c2):
        u = (m / c1).div_((v / c2).sqrt_().add_(eps))
        if weight_decay:
            u.add_(p.float() * weight_decay)
        return u

    @torch.no_grad()
    def update(grads: Params, state: LambState, params: Params,
               leaf_sq_sums: Optional[Callable] = None) -> LambState:
        count = state.count + 1
        lr_t = _lr_at(lr, count)
        c1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        c2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        for n in params:
            g = grads[n].float()
            state.mu[n].mul_(b1).add_(g * (1 - b1))
            state.nu[n].mul_(b2).add_(g.square().mul_(1 - b2))
        sums = {n: torch.stack([
            p.float().square().sum(),
            step_of(state.mu[n], state.nu[n], p, c1, c2).square().sum()])
            for n, p in params.items()}
        if leaf_sq_sums is not None:
            sums = leaf_sq_sums(sums)
        stacked: Params = {}
        for n, t in sums.items():
            k = stack_key(n)
            stacked[k] = t if k not in stacked else stacked[k] + t
        for n, p in params.items():
            u = step_of(state.mu[n], state.nu[n], p, c1, c2)
            w_norm, u_norm = stacked[stack_key(n)].sqrt().unbind(0)
            trust = torch.where((w_norm > 0) & (u_norm > 0),
                                (w_norm / u_norm).clamp(min_trust,
                                                        max_trust),
                                torch.ones_like(w_norm))
            p.add_(((-lr_t) * trust * u).to(p.dtype))
        return LambState(count, state.mu, state.nu)

    return Transform(init, update, leaf_norms=True)


class LionState(NamedTuple):
    count: int
    mu: Params


def lion(lr=1e-4, betas=(0.9, 0.99), weight_decay: float = 0.0
         ) -> Transform:
    """Lion: ``p -= lr (sign(b1 m + (1 - b1) g) + wd p)``, then
    ``m = b2 m + (1 - b2) g``."""
    b1, b2 = (float(b) for b in betas)

    def init(params: Params) -> LionState:
        return LionState(count=0, mu={n: torch.zeros_like(
            p, dtype=torch.float32) for n, p in params.items()})

    @torch.no_grad()
    def update(grads: Params, state: LionState, params: Params) -> LionState:
        count = state.count + 1
        lr_t = _lr_at(lr, count)
        for n, p in params.items():
            g = grads[n].float()
            m = state.mu[n]
            direction = torch.sign(m * b1 + g * (1 - b1))
            if weight_decay:
                direction.add_(p.float() * weight_decay)
            p.add_((direction * -lr_t).to(p.dtype))
            m.mul_(b2).add_(g * (1 - b2))
        return LionState(count, state.mu)

    return Transform(init, update, separable=True)


class AdagradState(NamedTuple):
    count: int
    accum: Params


def adagrad(lr=1e-2, eps: float = 1e-10, weight_decay: float = 0.0,
            initial_accumulator_value: float = 0.0) -> Transform:
    """Adagrad: ``a += g^2``, ``p -= lr g / (sqrt(a) + eps)``, with L2
    weight decay folded into the gradient."""

    def init(params: Params) -> AdagradState:
        return AdagradState(count=0, accum={n: torch.full_like(
            p, initial_accumulator_value, dtype=torch.float32)
            for n, p in params.items()})

    @torch.no_grad()
    def update(grads: Params, state: AdagradState, params: Params
               ) -> AdagradState:
        count = state.count + 1
        lr_t = _lr_at(lr, count)
        for n, p in params.items():
            g = grads[n]
            if weight_decay:
                g = g + p.to(g.dtype) * weight_decay
            g = g.float()
            a = state.accum[n]
            a.add_(g.square())
            p.add_(((g * -lr_t) / (a.sqrt() + eps)).to(p.dtype))
        return AdagradState(count, state.accum)

    return Transform(init, update, separable=True)


# the JAX package's registry, name for name: the fused and cpu variants
# are the same rules (placement is the offload's, ROADMAP Queue A item
# 12), and the 1-bit optimizers are their plain rules (their compressed
# collectives are the comm layer's)
OPTIMIZER_REGISTRY = {
    "adam": adam, "adamw": adamw, "fusedadam": adam,
    "cpuadam": adam, "deepspeedcpuadam": adam,
    "sgd": sgd,
    "lamb": lamb, "fusedlamb": lamb,
    "lion": lion, "fusedlion": lion, "cpulion": lion,
    "adagrad": adagrad, "cpuadagrad": adagrad,
    "onebitadam": adam, "zerooneadam": adam, "onebitlamb": lamb,
}

# the reference's knobs of the 1-bit optimizers and its CUDA builds,
# accepted and dropped
_DROPPED = ("freeze_step", "cuda_aware", "comm_backend_name", "coeff_beta",
            "factor_max", "factor_min", "factor_threshold")


def build_optimizer(name: str, params_dict: Optional[dict] = None,
                    lr_schedule: Optional[Callable] = None) -> Transform:
    """Build from config ``{"type": ..., "params": {...}}`` with the
    reference's spellings (lr, betas, eps, weight_decay, momentum,
    bias_correction, adam_w_mode / adamw_mode); a schedule, when given,
    replaces ``lr``."""
    key = name.lower().replace("_", "").replace("-", "")
    if key not in OPTIMIZER_REGISTRY:
        raise ValueError(f"Unknown optimizer '{name}'. Known: "
                         f"{sorted(OPTIMIZER_REGISTRY)}")
    factory = OPTIMIZER_REGISTRY[key]
    kwargs = dict(params_dict or {})
    kwargs.pop("torch_adam", None)
    if "adamw_mode" in kwargs:
        kwargs["adam_w_mode"] = bool(kwargs.pop("adamw_mode"))
    for k in _DROPPED:
        kwargs.pop(k, None)
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


def as_transform(opt: Any) -> Transform:
    """A client optimizer as a :class:`Transform`: a Transform as it is,
    or any object with ``init(params) -> state`` and ``update(grads,
    state, params) -> state`` (this package's in-place protocol)."""
    if isinstance(opt, Transform):
        return opt
    if callable(getattr(opt, "init", None)) and callable(
            getattr(opt, "update", None)):
        return Transform(init=opt.init,
                         update=lambda g, s, p: opt.update(g, s, p))
    raise TypeError(f"Cannot interpret {opt!r} as an optimizer")


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
