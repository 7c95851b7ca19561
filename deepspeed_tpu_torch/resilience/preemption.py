"""Preemption signal capture: drain at the next step boundary.

Ports ``deepspeed_tpu/resilience/preemption.py`` (host Python; the port keeps its own
copy and imports nothing of the JAX package).

Cloud TPU preemptions deliver SIGTERM with a grace window. The guard
latches the signal into a flag the training loop polls between steps
(``should_stop``) — checkpoint, flush telemetry, exit cleanly — instead
of dying mid-step with an unflushed monitor and a torn checkpoint.
"""

from __future__ import annotations

import signal
import threading
from typing import Callable, Iterable, Optional

from ..telemetry.registry import get_registry
from ..utils.logging import logger


class PreemptionGuard:
    """Latch SIGTERM/SIGINT (configurable) into a poll-able stop flag.

    Use as a context manager around the training loop; previous handlers
    are restored on exit. Only valid from the main thread (signal module
    restriction); elsewhere it degrades to a manually-set flag.
    """

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,),
                 on_preempt: Optional[Callable[[int], None]] = None):
        self.signals = tuple(signals)
        self.on_preempt = on_preempt
        self.last_signal: Optional[int] = None  # which signal latched us
        self._stop = threading.Event()
        self._pending: list = []  # signums not yet counted (see below)
        self._previous = {}

    @property
    def should_stop(self) -> bool:
        # registry counting is deferred from the handler to this poll: the
        # registry/Counter locks are plain (non-reentrant) threading.Locks,
        # and a handler firing while the step path holds one would deadlock
        # the main thread. List append is GIL-atomic; draining here runs in
        # normal (interruptible-but-lock-safe) context.
        while self._pending:
            signum = self._pending.pop(0)
            get_registry().counter("resilience/preemptions").inc()
            try:
                name = signal.Signals(signum).name
            except ValueError:
                name = str(signum)
            get_registry().counter(f"resilience/preemptions/{name}").inc()
        return self._stop.is_set()

    def request_stop(self) -> None:
        """Manual trigger (tests; non-signal preemption notices)."""
        self._stop.set()

    def _handler(self, signum, frame) -> None:
        logger.warning(f"preemption signal {signum} received; draining at "
                       f"the next step boundary")
        self.last_signal = signum
        self._pending.append(signum)
        self._stop.set()
        if self.on_preempt is not None:
            self.on_preempt(signum)

    def __enter__(self) -> "PreemptionGuard":
        try:
            for s in self.signals:
                self._previous[s] = signal.signal(s, self._handler)
        except ValueError:  # not the main thread
            logger.warning("PreemptionGuard: not on the main thread; "
                           "signals not hooked (flag-only mode)")
            self._previous.clear()
        return self

    def __exit__(self, *exc) -> None:
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        self._previous.clear()
