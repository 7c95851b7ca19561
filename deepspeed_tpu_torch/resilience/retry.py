"""Bounded retry with jittered exponential backoff, instrumented.

Ports ``deepspeed_tpu/resilience/retry.py`` (host Python; the port keeps
its own copy and imports nothing of the JAX package):

* :class:`RetryPolicy` and :func:`retry_call` — retry transient host-side
  failures (checkpoint writes, reconnects) with jittered backoff through
  the injectable clock's ``sleep``;
* :class:`RetryBudget` — a shared, thread-safe cap on total retries; the
  fleet draws each request's route retries from one
  (``serving/fleet.py`` ``route_budget_for``).

Every attempt, retry and final failure is counted under
``resilience/{attempts,retries,failures}/<op>`` in the shared registry.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple, Type

from ..utils.logging import logger
from .clock import get_clock
from .counters import record_attempt, record_failure, record_retry


class RetryError(RuntimeError):
    """All attempts exhausted; ``__cause__`` is the last failure."""


@dataclass(frozen=True)
class RetryPolicy:
    max_attempts: int = 3
    backoff_s: float = 0.5
    backoff_multiplier: float = 2.0
    max_backoff_s: float = 30.0
    jitter: float = 0.0  # uniform extra delay, as a fraction of the backoff
    retry_on: Tuple[Type[BaseException], ...] = (OSError, RuntimeError)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.jitter < 0:
            raise ValueError(f"jitter must be >= 0, got {self.jitter}")


class RetryBudget:
    """A shared, thread-safe cap on total retries across many call sites.

    Checkpoint save/load wraps several filesystem ops; each gets its own
    per-call ``RetryPolicy``, but they can all draw from one budget so a
    persistently failing backend exhausts quickly. ``take()`` consumes one
    retry and returns False when nothing is left.
    """

    def __init__(self, max_retries: int):
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        self.max_retries = int(max_retries)
        self._remaining = int(max_retries)
        self._lock = threading.Lock()

    @property
    def remaining(self) -> int:
        with self._lock:
            return self._remaining

    def take(self, op: str = "default") -> bool:
        with self._lock:
            if self._remaining <= 0:
                return False
            self._remaining -= 1
        return True


_JITTER_RNG = random.Random()


def retry_call(fn: Callable[..., Any], *args,
               policy: RetryPolicy = RetryPolicy(),
               op: str = "default",
               sleep: Optional[Callable[[float], None]] = None,
               budget: Optional[RetryBudget] = None,
               rng: Optional[random.Random] = None,
               **kwargs) -> Any:
    """Call ``fn(*args, **kwargs)``; on a ``policy.retry_on`` exception,
    back off (with up to ``policy.jitter`` fractional random extra) and
    retry up to ``policy.max_attempts`` total attempts, or until ``budget``
    is exhausted. Every attempt is counted under
    ``resilience/attempts/{op}``; retries/failures under
    ``resilience/{retries,failures}/{op}``. ``sleep`` defaults to the
    injectable clock's sleep (:mod:`.clock`), so simulated backoff
    advances virtual time instead of stalling the host.
    """
    if sleep is None:
        sleep = get_clock().sleep
    delay = policy.backoff_s
    last: BaseException
    for attempt in range(1, policy.max_attempts + 1):
        record_attempt(op)
        try:
            return fn(*args, **kwargs)
        except policy.retry_on as e:
            last = e
            exhausted = attempt == policy.max_attempts
            if not exhausted and budget is not None and not budget.take(op):
                exhausted = True
                logger.warning(f"resilience: {op} retry budget exhausted")
            if exhausted:
                record_failure(op)
                raise RetryError(
                    f"{op}: {attempt} attempts failed; last: {e!r}") from e
            record_retry(op)
            d = delay
            if policy.jitter > 0:
                d *= 1.0 + (rng or _JITTER_RNG).uniform(0.0, policy.jitter)
            logger.warning(
                f"resilience: {op} attempt {attempt}/{policy.max_attempts} "
                f"failed ({e!r}); retrying in {d:.2f}s")
            sleep(d)
            delay = min(delay * policy.backoff_multiplier,
                        policy.max_backoff_s)
    raise AssertionError("unreachable")  # loop always returns or raises
