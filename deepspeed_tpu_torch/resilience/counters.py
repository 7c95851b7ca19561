"""Restart/retry/failure counters in the shared telemetry registry.

Ports ``deepspeed_tpu/resilience/counters.py`` (host Python; the port keeps its own
copy and imports nothing of the JAX package).
"""

from __future__ import annotations

import os

from ..telemetry.registry import get_registry


def record_restart(n: int = 1) -> None:
    """Count a worker restart (ElasticAgent calls this per relaunch)."""
    get_registry().counter("resilience/restarts").inc(n)


def record_retry(op: str = "default") -> None:
    get_registry().counter(f"resilience/retries/{op}").inc()


def record_attempt(op: str = "default") -> None:
    """Count every retry_call attempt (first tries included), so attempt
    volume and retry volume can be ratioed into a flakiness rate."""
    get_registry().counter(f"resilience/attempts/{op}").inc()


def record_rollback() -> None:
    """Count a divergence-triggered rollback to the last checkpoint."""
    get_registry().counter("resilience/rollbacks").inc()


def record_emergency_save() -> None:
    """Count a preemption-triggered emergency checkpoint."""
    get_registry().counter("resilience/emergency_saves").inc()


def record_failure(op: str = "default") -> None:
    get_registry().counter(f"resilience/failures/{op}").inc()


def restart_count_from_env() -> int:
    """The restart generation this process is running as, from the
    ``DST_ELASTIC_RESTART`` env the ElasticAgent exports. A trainee calls
    this once at startup to seed its restart gauge — the agent's own
    counter lives in the agent process, not here."""
    try:
        n = int(os.environ.get("DST_ELASTIC_RESTART", "0"))
    except ValueError:
        return 0
    if n > 0:
        get_registry().gauge("resilience/restart_generation").set(n)
    return n
