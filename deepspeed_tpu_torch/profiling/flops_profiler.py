"""FLOPs profiler.

Ports ``deepspeed_tpu/profiling/flops_profiler.py`` (the reference's
``FlopsProfiler``: ``start_profile`` / ``stop_profile`` /
``get_total_*``, ``print_model_profile``, ``get_model_profile``). The JAX
package reads XLA's cost analysis of the compiled program; here
``torch.utils.flop_counter.FlopCounterMode`` counts the operations of
one real call: every matrix product, convolution and attention the
dispatcher runs, the remat replay included. The flash-attention op of
``ops/flash_attention.py`` registers its forward and backward formulas
(4d and 14d operations a visible query-key pair), so the counter sees
the kernels too.

``_peak_flops_per_device`` names the H100's dense peaks by device name:
989e12 operations/s for bf16 and fp16 (tensor cores), 67e12 for fp32.
Any other device gives 0, which makes MFU 0, as the JAX package does for
a device it does not know.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from ..utils.logging import log_dist, logger

H100_PEAK = {torch.bfloat16: 989e12, torch.float16: 989e12,
             torch.float32: 67e12}


def count_params(params: Any) -> int:
    """Elements of a ``{name: tensor}`` dict, a module's parameters or any
    iterable of tensors."""
    if hasattr(params, "parameters"):
        params = params.parameters()
    elif isinstance(params, dict):
        params = params.values()
    return int(sum(p.numel() for p in params if hasattr(p, "numel")))


def flops_of(fn: Callable, *args, **kwargs) -> Optional[float]:
    """Operations of one call of ``fn`` (a backward inside it counts
    too), or None when none were counted. Runs ``fn`` once."""
    from torch.utils.flop_counter import FlopCounterMode

    try:
        counter = FlopCounterMode(display=False)
        with counter:
            fn(*args, **kwargs)
        f = counter.get_total_flops()
        return float(f) if f > 0 else None
    except Exception as e:
        logger.debug(f"flop count unavailable: {e}")
        return None


@dataclass
class ProfileResult:
    flops: float                 # per step
    macs: float
    params: int
    duration_s: float = 0.0
    tflops_per_s: float = 0.0
    mfu: float = 0.0

    def __repr__(self):
        return (f"ProfileResult(flops={self.flops:.3e}, "
                f"params={self.params:,}, "
                f"tflops/s={self.tflops_per_s:.1f}, mfu={self.mfu:.1%})")


def _sync(device=None) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize(device)


class FlopsProfiler:
    """Step profiler around a train or eval function (the reference's
    ``start_profile`` / ``stop_profile`` / ``get_total_*`` surface)."""

    def __init__(self, peak_flops: Optional[float] = None,
                 dtype: torch.dtype = torch.bfloat16):
        self.peak_flops = peak_flops or _peak_flops_per_device(dtype)
        self._flops: Optional[float] = None
        self._params: int = 0
        self._t0: Optional[float] = None
        self._steps = 0
        self._elapsed = 0.0

    def start_profile(self) -> None:
        self._t0 = time.perf_counter()

    def stop_profile(self) -> None:
        if self._t0 is not None:
            _sync()
            self._elapsed += time.perf_counter() - self._t0
            self._steps += 1
            self._t0 = None

    def reset_profile(self) -> None:
        self._steps = 0
        self._elapsed = 0.0

    def get_total_flops(self, as_string: bool = False):
        total = (self._flops or 0.0) * max(self._steps, 1)
        return _num_to_string(total, "FLOPs") if as_string else total

    def get_total_params(self, as_string: bool = False):
        return _num_to_string(self._params, "params") if as_string \
            else self._params

    def get_total_duration(self, as_string: bool = False):
        return f"{self._elapsed:.3f} s" if as_string else self._elapsed

    def measure(self, fn: Callable, *args,
                analytic_flops: Optional[float] = None, params: Any = None,
                iters: int = 5, warmup: int = 2, **kwargs) -> ProfileResult:
        """Count one call's operations, then time ``iters`` calls after
        ``warmup`` (the counted call is the first warm-up); per-call
        numbers."""
        if params is not None:
            self._params = count_params(params)
        flops = flops_of(fn, *args, **kwargs) or analytic_flops or 0.0
        self._flops = flops
        for _ in range(max(warmup - 1, 0)):
            fn(*args, **kwargs)
        _sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args, **kwargs)
        _sync()
        dt = (time.perf_counter() - t0) / iters
        return ProfileResult(
            flops=flops, macs=flops / 2, params=self._params, duration_s=dt,
            tflops_per_s=flops / dt / 1e12 if dt > 0 else 0.0,
            mfu=(flops / dt / self.peak_flops)
            if dt > 0 and self.peak_flops else 0.0)

    def print_model_profile(self, result: ProfileResult,
                            detailed: bool = True) -> str:
        rule = "-" * 26
        lines = [
            f"{rule} DeepSpeed-TPU Flops Profiler {rule}",
            f"params:                 {_num_to_string(result.params, '')}",
            f"FLOPs per step:         "
            f"{_num_to_string(result.flops, 'FLOPs')}",
            f"MACs per step:          {_num_to_string(result.macs, 'MACs')}",
            f"step latency:           {result.duration_s * 1e3:.2f} ms",
            f"achieved:               {result.tflops_per_s:.2f} TFLOPS "
            f"({result.mfu:.1%} MFU)",
            "-" * 82,
        ]
        text = "\n".join(lines)
        log_dist(text)
        return text


def get_model_profile(model, batch, params=None,
                      peak_flops: Optional[float] = None, iters: int = 5,
                      warmup: int = 2) -> ProfileResult:
    """Profile one loss call (forward only, no gradient) of a model of
    this package on ``batch`` (``{"input_ids": [b, s]}`` or the ids);
    the analytic fallback is a third of ``flops_per_token``'s 6N."""
    params = params if params is not None else dict(model.named_parameters())
    tokens = batch["input_ids"] if isinstance(batch, dict) else batch
    dtype = next(iter(params.values())).dtype
    prof = FlopsProfiler(peak_flops=peak_flops, dtype=dtype)
    analytic = None
    if hasattr(model, "config") and hasattr(model.config, "flops_per_token"):
        b, s = tokens.shape
        analytic = model.config.flops_per_token(s) / 3.0 * b * s

    @torch.no_grad()
    def loss(t):
        return model.loss({"input_ids": t}, params=params)

    return prof.measure(loss, tokens, analytic_flops=analytic, params=params,
                        iters=iters, warmup=warmup)


def _peak_flops_per_device(dtype: torch.dtype = torch.bfloat16,
                           device=None) -> float:
    """The card's dense peak operations/s for ``dtype``, by device name
    (the H100's; 0 for any other device)."""
    try:
        if not torch.cuda.is_available():
            return 0.0
        name = torch.cuda.get_device_name(device)
    except Exception:
        return 0.0
    if "H100" in name:
        return H100_PEAK.get(dtype, 0.0)
    return 0.0


def _num_to_string(num: float, unit: str) -> str:
    for scale, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "K")):
        if abs(num) >= scale:
            return f"{num / scale:.2f} {suffix}{unit}"
    return f"{num:.2f} {unit}"
