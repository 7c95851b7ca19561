"""Wall-clock and throughput timers.

Ports ``deepspeed_tpu/utils/timer.py`` (``SynchronizedWallClockTimer`` and
``ThroughputTimer``, the reference's ``deepspeed/utils/timer.py``). The JAX
package's fence is a host fetch of a sync object; here it waits for the
work queued so far on the sync tensor's device stream (a CUDA event
recorded on the current stream, then waited on by the host), and is a
no-op for a CPU tensor, whose work is done when the call returns.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import torch

from .logging import log_dist


def _fence(obj: Any) -> None:
    """Host-side completion fence on ``obj``'s device stream."""
    if isinstance(obj, torch.Tensor) and obj.device.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(obj.device))
        done.synchronize()


class _Timer:
    def __init__(self, name: str):
        self.name = name
        self._start: Optional[float] = None
        self.elapsed_total = 0.0
        self.count = 0

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self, sync_obj: Any = None) -> float:
        if sync_obj is not None:
            _fence(sync_obj)
        assert self._start is not None, \
            f"timer {self.name} stopped before start"
        dt = time.perf_counter() - self._start
        self.elapsed_total += dt
        self.count += 1
        self._start = None
        return dt

    def mean_ms(self) -> float:
        return (self.elapsed_total / self.count * 1e3) if self.count else 0.0

    def reset(self) -> None:
        self.elapsed_total = 0.0
        self.count = 0
        self._start = None


class SynchronizedWallClockTimer:
    """Named-timer registry (the reference's same-named class)."""

    def __init__(self):
        self.timers: Dict[str, _Timer] = {}

    def __call__(self, name: str) -> _Timer:
        if name not in self.timers:
            self.timers[name] = _Timer(name)
        return self.timers[name]

    def log(self, names: Optional[List[str]] = None, reset: bool = True
            ) -> str:
        names = names or list(self.timers)
        parts = [f"{n}: {self.timers[n].mean_ms():.2f}ms" for n in names
                 if n in self.timers]
        msg = " | ".join(parts)
        if msg:
            log_dist(f"time (ms) | {msg}")
        if reset:
            for n in names:
                if n in self.timers:
                    self.timers[n].reset()
        return msg


class ThroughputTimer:
    """Samples/s over windows of ``steps_per_output`` steps (the
    reference's ``ThroughputTimer``)."""

    def __init__(self, batch_size: int, steps_per_output: int = 50,
                 monitor_memory: bool = False):
        self.batch_size = batch_size
        self.steps_per_output = max(int(steps_per_output), 1)
        self.monitor_memory = monitor_memory
        self.total_samples = 0
        self.total_time = 0.0
        self._start = None
        self.step_count = 0
        self._window_time = 0.0
        self._window_steps = 0
        self.last_step_s: Optional[float] = None
        # the device-memory sample of the last report boundary (sampled
        # only there, so a steady-state step never reads allocator stats)
        self.last_memory: Dict[str, float] = {}

    def start(self) -> None:
        self._start = time.perf_counter()

    def will_report_next(self) -> bool:
        """True if the next :meth:`stop` logs the throughput line: the
        engine then passes a sync object, so the line's time is the
        window's."""
        return (self.step_count + 1) % self.steps_per_output == 0

    def stop(self, sync_obj: Any = None, report_speed: bool = True
             ) -> Optional[float]:
        if self._start is None:
            return None
        if sync_obj is not None:
            _fence(sync_obj)
        dt = time.perf_counter() - self._start
        self._start = None
        self.step_count += 1
        self.total_samples += self.batch_size
        self.total_time += dt
        self._window_time += dt
        self._window_steps += 1
        self.last_step_s = dt
        if report_speed and self.step_count % self.steps_per_output == 0:
            # the window's mean: unsynced steps return at dispatch, the
            # boundary's synced one drains the window
            ms = self._window_time / self._window_steps * 1e3
            mem = ""
            if self.monitor_memory:
                from .memory import device_memory_stats

                self.last_memory = device_memory_stats()
                if self.last_memory:
                    mem = ", " + ", ".join(
                        f"{k}={v}" for k, v in self.last_memory.items())
            log_dist(f"step {self.step_count}: "
                     f"{self.avg_samples_per_sec():.2f} samples/s, "
                     f"{ms:.1f} ms/step (avg over {self._window_steps})"
                     f"{mem}")
            self._window_time = 0.0
            self._window_steps = 0
        return dt

    def avg_samples_per_sec(self) -> float:
        return self.total_samples / self.total_time if self.total_time \
            else 0.0
