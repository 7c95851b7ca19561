"""Heartbeat + stall detection.

Ports ``deepspeed_tpu/telemetry/heartbeat.py`` (host Python; the port keeps its own
copy and imports nothing of the JAX package).

A hung collective or a wedged host thread shows up as a step that takes a
large multiple of the typical step time — or as no step at all. Two
complementary mechanisms:

* :class:`StallDetector` — flags any step exceeding ``factor`` x the
  rolling median of recent step wall times. Median (not mean) so one slow
  step doesn't poison the baseline it is judged against; compile steps at
  the front are absorbed by ``warmup_steps``.
* :class:`Heartbeat` — writes a tiny ``{step, time}`` JSON file (atomic
  rename) each step, so an external watchdog can detect "no heartbeat for
  N seconds" even when the process is too wedged to report a slow step.
"""

from __future__ import annotations

import os
import statistics
from collections import deque
from typing import Callable, Deque, Optional

from ..utils.logging import logger


class StallDetector:
    """Flag steps exceeding ``factor`` x the rolling median step time.

    ``observe(step, wall_time_s)`` returns True when the step is judged
    stalled. The stalled step's own time is still added to the window
    afterwards — a genuine regime change (e.g. sequence-length jump)
    flags once, then the median adapts instead of flagging forever.
    """

    def __init__(self, window: int = 20, factor: float = 3.0,
                 warmup_steps: int = 2,
                 on_stall: Optional[Callable[[int, float, float], None]] = None):
        if factor <= 1.0:
            raise ValueError(f"stall factor must exceed 1.0, got {factor}")
        self.window: Deque[float] = deque(maxlen=max(2, int(window)))
        self.factor = float(factor)
        self.warmup_steps = int(warmup_steps)
        self.on_stall = on_stall
        self.stall_count = 0
        self._seen = 0

    def rolling_median(self) -> Optional[float]:
        return statistics.median(self.window) if self.window else None

    def observe(self, step: int, wall_time_s: float) -> bool:
        self._seen += 1
        stalled = False
        median = self.rolling_median()
        # need a settled baseline: past warmup AND at least 2 samples
        if (self._seen > self.warmup_steps and median is not None
                and len(self.window) >= 2
                and wall_time_s > self.factor * median):
            stalled = True
            self.stall_count += 1
            logger.warning(
                f"stall detected: step {step} took {wall_time_s * 1e3:.1f} ms "
                f"(> {self.factor:g}x rolling median {median * 1e3:.1f} ms)")
            if self.on_stall is not None:
                self.on_stall(step, wall_time_s, median)
        if self._seen > self.warmup_steps:
            self.window.append(wall_time_s)
        return stalled


class Heartbeat:
    """Atomic per-step liveness file for external watchdogs.

    Carries a ``state`` field so watchers can distinguish a live trainer
    (``"running"``) from the supervising ElasticAgent's relaunch window
    (``"restarting"`` — launcher/agent.py overwrites the same file with
    restart count + reason while the worker is down) instead of treating
    every restart gap as a hang.
    """

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)

    def beat(self, step: int) -> None:
        from ..resilience.clock import get_clock  # lazy: import-order cycle
        from ..utils.fileio import write_json_atomic
        from .tracing import get_tracer

        # flight-recorder health rides the heartbeat so an external
        # watcher sees recorder depth / drops / the last auto-dump path
        # without attaching to the process (docs/observability.md).
        # With tracing off these are static zeros — same file shape.
        flight = get_tracer().flight
        write_json_atomic(self.path, {"step": int(step),
                                      "time": get_clock().time(),
                                      "state": "running",
                                      "flight_depth": flight.depth,
                                      "flight_dropped": flight.dropped,
                                      "flight_dumps": flight.dumps,
                                      "flight_last_dump":
                                          flight.last_dump_path})
