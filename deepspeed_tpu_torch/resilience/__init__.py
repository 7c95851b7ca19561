"""Resilience seams of the port: the clock, counters, bounded retry with
a shared budget, the lock-order sanitizer, the preemption guard, the
divergence guards and seeded chaos injection."""

from .divergence import DivergenceError, DivergenceGuard  # noqa: F401
from .preemption import PreemptionGuard  # noqa: F401
from .retry import RetryBudget, RetryError, RetryPolicy, retry_call  # noqa: F401
