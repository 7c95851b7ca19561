"""Resilience seams of the port: the clock, counters, bounded retry with
a shared budget, the lock-order sanitizer, the preemption guard and
seeded chaos injection."""

from .retry import RetryBudget, RetryError, RetryPolicy, retry_call  # noqa: F401
