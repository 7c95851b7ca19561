"""Learning-rate schedules.

Ports ``deepspeed_tpu/runtime/lr_schedules.py`` (WarmupLR, WarmupDecayLR,
WarmupCosineLR, OneCycle, LRRangeTest): pure functions ``step -> lr`` of
host-side arithmetic. The JAX package evaluates them in fp32 inside its
jitted step; here they run in Python on the host, and the optimizer
applies the value to fp32 tensors.
"""

from __future__ import annotations

import inspect
import math
from typing import Callable, Dict, Optional

from ..utils.logging import logger

Schedule = Callable[[int], float]  # step -> lr


def _clip(x: float, lo: float, hi: float) -> float:
    return min(max(x, lo), hi)


def constant_lr(lr: float) -> Schedule:
    return lambda step: float(lr)


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 1e-3,
              warmup_num_steps: int = 1000, warmup_type: str = "log") -> Schedule:
    """WarmupLR: ramp then hold. gamma = log(step+1) / log(warmup_num_steps)
    for the default "log" type (warmup_num_steps floored at 2), step/steps
    for "linear"; gamma is 1 once warmup completes."""
    steps = max(2, warmup_num_steps)
    inverse_log_warm_up = 1.0 / math.log(steps)

    def sched(step):
        step = float(step)
        if step >= steps:
            ramp = 1.0
        elif warmup_type == "log":
            ramp = inverse_log_warm_up * math.log(step + 1.0)
        else:
            ramp = step / steps
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * ramp

    return sched


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 1e-3, warmup_num_steps: int = 1000,
                    warmup_type: str = "linear") -> Schedule:
    """WarmupDecayLR: linear warmup then linear decay to 0 at total steps."""

    def sched(step):
        step = float(step)
        if step < warmup_num_steps:
            warm = _clip(step / max(warmup_num_steps, 1), 0.0, 1.0)
            return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * warm
        denom = max(total_num_steps - warmup_num_steps, 1)
        return warmup_max_lr * _clip((total_num_steps - step) / denom, 0.0, 1.0)

    return sched


def warmup_cosine_lr(total_num_steps: int, warmup_min_ratio: float = 0.0,
                     warmup_num_steps: int = 1000, cos_min_ratio: float = 1e-4,
                     warmup_max_lr: float = 1e-3) -> Schedule:
    """WarmupCosineLR."""

    def sched(step):
        step = float(step)
        if step < warmup_num_steps:
            warm = _clip(step / max(warmup_num_steps, 1), 0.0, 1.0)
            ratio = warmup_min_ratio + (1 - warmup_min_ratio) * warm
        else:
            denom = max(total_num_steps - warmup_num_steps, 1)
            prog = _clip((step - warmup_num_steps) / denom, 0.0, 1.0)
            ratio = cos_min_ratio + (1 - cos_min_ratio) * 0.5 * (
                1 + math.cos(math.pi * prog))
        return warmup_max_lr * ratio

    return sched


def one_cycle(cycle_min_lr: float, cycle_max_lr: float,
              cycle_first_step_size: int = 2000,
              cycle_second_step_size: Optional[int] = None,
              decay_step_size: int = 0, decay_lr_rate: float = 0.0,
              **_ignored) -> Schedule:
    """OneCycle (the lr leg; momentum cycling is not modelled)."""
    second = (cycle_second_step_size if cycle_second_step_size is not None
              else cycle_first_step_size)
    cycle_len = cycle_first_step_size + second

    def sched(step):
        step = float(step)
        if step <= cycle_first_step_size:
            up = _clip(step / max(cycle_first_step_size, 1), 0.0, 1.0)
            return cycle_min_lr + (cycle_max_lr - cycle_min_lr) * up
        if step <= cycle_len:
            down = _clip((step - cycle_first_step_size) / max(second, 1),
                         0.0, 1.0)
            return cycle_max_lr - (cycle_max_lr - cycle_min_lr) * down
        if decay_step_size > 0:
            decay_steps = max(step - cycle_len, 0.0) / decay_step_size
            return cycle_min_lr / (1.0 + decay_steps * decay_lr_rate)
        return float(cycle_min_lr)

    return sched


def lr_range_test(lr_range_test_min_lr: float = 1e-3,
                  lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0,
                  lr_range_test_staircase: bool = False) -> Schedule:
    """LRRangeTest."""

    def sched(step):
        interval = float(step) / max(lr_range_test_step_size, 1)
        if lr_range_test_staircase:
            interval = math.floor(interval)
        return lr_range_test_min_lr * (1.0 + interval * lr_range_test_step_rate)

    return sched


SCHEDULE_REGISTRY: Dict[str, Callable[..., Schedule]] = {
    "warmuplr": warmup_lr,
    "warmupdecaylr": warmup_decay_lr,
    "warmupcosinelr": warmup_cosine_lr,
    "onecycle": one_cycle,
    "lrrangetest": lr_range_test,
    "constant": lambda lr=1e-3, **_: constant_lr(lr),
}


def build_schedule(name: Optional[str], params: Optional[dict] = None,
                   fallback_lr: float = 1e-3) -> Schedule:
    """Build from config ``{"type": ..., "params": {...}}``; unknown params
    are dropped with a warning, an unknown type raises."""
    if not name:
        return constant_lr(fallback_lr)
    key = name.lower().replace("_", "").replace("-", "")
    if key not in SCHEDULE_REGISTRY:
        raise ValueError(f"Unknown scheduler '{name}'. Known: "
                         f"{sorted(SCHEDULE_REGISTRY)}")
    factory = SCHEDULE_REGISTRY[key]
    params = dict(params or {})
    sig = inspect.signature(factory)
    accepted = {k: v for k, v in params.items() if k in sig.parameters}
    dropped = set(params) - set(accepted)
    if dropped:
        logger.warning(f"Scheduler '{name}': ignoring params {sorted(dropped)}")
    return factory(**accepted)
