"""Divergence guards: NaN/Inf and loss-spike detection for the step path.

Ports ``deepspeed_tpu/resilience/divergence.py`` (host Python; the port
keeps its own copy and imports nothing of the JAX package).

A production run that NaNs at 3am must not burn its remaining budget
streaming NaNs into the optimizer state. Two detectors, per config
(``resilience.divergence`` — config.py):

* **NaN/Inf guard** — ``nan_action``:
  - ``"skip"`` runs inside the train step: the non-finite check reuses
    the fp16 overflow path of ``TrainEngine._update`` (grads checked, the
    update kept out), so a NaN step is dropped with no host
    synchronization of its own;
  - ``"rollback"`` / ``"halt"`` run host-side: the engine fetches the loss
    each step (one host sync — the guard's documented cost) and either
    reloads the newest valid checkpoint or raises :class:`DivergenceError`.
* **Loss-spike guard** — ``spike_action`` ``"warn" | "rollback" | "halt"``:
  flags any finite loss exceeding ``spike_factor`` x the rolling median of
  recent losses (the telemetry stall-detector shape — median, not mean, so
  one spike can't poison the baseline it is judged against; compile/warmup
  noise absorbed by ``warmup_steps``). Spikes cannot be "skipped": the
  update is already applied by the time the host sees the loss, so the
  honest recovery is a rollback to the last checkpoint.

With every action ``"off"`` the engine constructs no guard and the step
path is byte-identical to the unguarded one.
"""

from __future__ import annotations

import math
import statistics
from collections import deque
from typing import Deque, Optional, Tuple

from ..utils.logging import logger

NAN_ACTIONS = ("off", "skip", "rollback", "halt")
SPIKE_ACTIONS = ("off", "warn", "rollback", "halt")


class DivergenceError(RuntimeError):
    """Raised when a guard's action is 'halt' (or a rollback is impossible)."""


class DivergenceGuard:
    """Host-side detector: feed it each step's loss; it returns the
    triggered ``(kind, action)`` or None.

    ``observe`` appends finite losses to the window *after* judging them
    (a genuine regime change flags once, then the median adapts); non-
    finite losses never enter the window, so a NaN burst can't drag the
    spike baseline to NaN.
    """

    def __init__(self, nan_action: str = "halt", spike_action: str = "off",
                 spike_factor: float = 10.0, window: int = 20,
                 warmup_steps: int = 5):
        if nan_action not in NAN_ACTIONS:
            raise ValueError(f"nan_action must be one of {NAN_ACTIONS}, "
                             f"got {nan_action!r}")
        if spike_action not in SPIKE_ACTIONS:
            raise ValueError(f"spike_action must be one of {SPIKE_ACTIONS}, "
                             f"got {spike_action!r}")
        if spike_action != "off" and spike_factor <= 1.0:
            raise ValueError(
                f"spike_factor must exceed 1.0, got {spike_factor}")
        self.nan_action = nan_action
        self.spike_action = spike_action
        self.spike_factor = float(spike_factor)
        self.warmup_steps = int(warmup_steps)
        self._window: Deque[float] = deque(maxlen=max(2, int(window)))
        self._seen = 0
        self.nan_count = 0
        self.spike_count = 0

    def reset(self) -> None:
        """Clear the baseline (after a rollback: the pre-divergence window
        no longer describes the restored trajectory's neighborhood)."""
        self._window.clear()
        self._seen = 0

    def observe(self, step: int, loss: float) -> Optional[Tuple[str, str]]:
        if not math.isfinite(loss):
            self.nan_count += 1
            logger.warning(f"divergence: non-finite loss {loss} at step {step}")
            # 'skip' is handled inside the step (the engine's finite
            # check already kept the old params); 'off' means
            # the user accepted NaNs — neither needs host action
            if self.nan_action in ("rollback", "halt"):
                return ("nan", self.nan_action)
            return None
        verdict: Optional[Tuple[str, str]] = None
        self._seen += 1
        if (self.spike_action != "off" and self._seen > self.warmup_steps
                and len(self._window) >= 2):
            median = statistics.median(self._window)
            if loss > self.spike_factor * median:
                self.spike_count += 1
                logger.warning(
                    f"divergence: loss spike at step {step}: {loss:.4g} > "
                    f"{self.spike_factor:g}x rolling median {median:.4g}")
                verdict = ("spike", self.spike_action)
        self._window.append(loss)
        return verdict
