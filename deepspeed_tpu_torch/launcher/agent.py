"""Elastic agent: supervise a training process, restart on failure.

Ports ``deepspeed_tpu/launcher/agent.py`` (host Python; the port keeps its
own copy and imports nothing of the JAX package).

Reference surface: ``deepspeed/elasticity/elastic_agent.py:28``
(``DSElasticAgent._invoke_run`` :118 — monitor the worker group, restart
within ``max_restarts`` on failure/membership change, torchrun rendezvous
handling node join/leave).

As in the JAX package, the agent is a process supervisor rather than a
torch-elastic rendezvous: the job restarts as a unit. It launches the
training command, watches for failure, and restarts it up to
``max_restarts`` times with
``DST_ELASTIC_RESTART=<n>`` exported so the trainee knows to resume from
its latest checkpoint (resume-from-latest is the recovery mechanism —
SURVEY §5.3; cross-mesh resume is already checkpoint-native). Restarts
back off exponentially with jitter (bounded by ``max_backoff_s``); a
worker that ran "healthily" (longer than ``healthy_after_s``) resets the
backoff, so a restart storm after a long stable run starts gentle again.

Every restart is classified (``exit:<rc>`` / ``signal:<name>``) and
surfaced two ways (docs/fault_tolerance.md):
 * the telemetry registry (``resilience/restarts`` plus
   ``resilience/restart_reasons/<reason>``), and
 * the worker's heartbeat file, overwritten with
   ``{"state": "restarting", "restarts": n, "reason": ...}`` while the
   worker is down — an external watchdog watching the heartbeat can tell
   "restarting" from "hung" instead of paging on every relaunch window.
"""

from __future__ import annotations

import os
import random
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

from ..utils.fileio import write_json_atomic
from ..utils.logging import logger


#: exit code a worker uses to request a PLANNED restart: a zero-downtime
#: rollout (serving/rollout.py) that cannot hot-swap in place re-execs
#: the worker to load the new weights. Restarts so classified consume no
#: restart budget and skip the backoff ladder — a flip is an intentional
#: reload, not an incident, and must not look like a crash loop to the
#: agent or like a hang to the stall watchdog reading the heartbeat.
PLANNED_ROLLOUT_EXIT = 86


def classify_exit(returncode: int,
                  planned_codes: Sequence[int] = (PLANNED_ROLLOUT_EXIT,)
                  ) -> str:
    """Human-readable restart reason from a worker's return code.
    Three families: ``signal:<name>`` (killed), ``planned:rollout``
    (worker-requested reload — see :data:`PLANNED_ROLLOUT_EXIT`), and
    ``exit:<rc>`` (everything else)."""
    if returncode < 0:
        try:
            name = signal.Signals(-returncode).name
        except ValueError:
            name = str(-returncode)
        return f"signal:{name}"
    if returncode in planned_codes:
        return "planned:rollout"
    return f"exit:{returncode}"


@dataclass
class AgentReport:
    restarts: int
    returncode: int
    history: List[int] = field(default_factory=list)
    reasons: List[str] = field(default_factory=list)
    #: rollout-triggered reloads (``planned:*`` reasons) — relaunches
    #: that consumed NO restart budget and slept no backoff
    planned_restarts: int = 0

    @property
    def succeeded(self) -> bool:
        return self.returncode == 0


class ElasticAgent:
    """Supervise ``cmd`` with restart-on-failure semantics
    (DSElasticAgent parity)."""

    def __init__(self, cmd: Sequence[str], max_restarts: int = 3,
                 backoff_s: float = 1.0,
                 backoff_multiplier: float = 2.0,
                 max_backoff_s: float = 60.0,
                 jitter: float = 0.25,
                 healthy_after_s: Optional[float] = None,
                 heartbeat_path: Optional[str] = None,
                 env: Optional[dict] = None,
                 on_restart: Optional[Callable[[int], None]] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 rng: Optional[random.Random] = None,
                 planned_exit_codes: Sequence[int] = (
                     PLANNED_ROLLOUT_EXIT,),
                 max_planned_restarts: int = 64):
        self.cmd = list(cmd)
        self.max_restarts = max_restarts
        # planned-reload taxonomy (serving/rollout.py flips): these exit
        # codes relaunch immediately — no budget, no backoff. The
        # separate generous cap is the runaway valve: a worker stuck
        # exiting "planned" forever is a bug, not a rollout.
        self.planned_exit_codes = tuple(planned_exit_codes)
        self.max_planned_restarts = max_planned_restarts
        self.backoff_s = backoff_s
        self.backoff_multiplier = backoff_multiplier
        self.max_backoff_s = max_backoff_s
        self.jitter = jitter
        self.healthy_after_s = healthy_after_s
        self.heartbeat_path = heartbeat_path
        self.env = dict(env if env is not None else os.environ)
        self.on_restart = on_restart
        self._sleep = sleep
        self._rng = rng or random.Random()

    # ------------------------------------------------------------------
    def _write_status(self, state: str, restarts: int,
                      reason: Optional[str] = None,
                      next_delay_s: Optional[float] = None) -> None:
        """Overwrite the worker's heartbeat file with the agent's view —
        same atomic-rename discipline as telemetry.heartbeat.Heartbeat."""
        if not self.heartbeat_path:
            return
        d = os.path.dirname(self.heartbeat_path)
        if d:
            os.makedirs(d, exist_ok=True)
        rec = {"state": state, "restarts": int(restarts),
               "time": time.time()}
        if reason is not None:
            rec["reason"] = reason
            # rollout-triggered reload: an external stall/crash-loop
            # watchdog must read this window as ROUTINE (the flip IS the
            # restart), not page on it
            if reason.startswith("planned:"):
                rec["planned"] = True
        if next_delay_s is not None:
            rec["next_delay_s"] = round(float(next_delay_s), 3)
        try:
            write_json_atomic(self.heartbeat_path, rec)
        except OSError as e:  # status is best-effort, never fatal
            logger.warning(f"elastic agent: heartbeat write failed: {e}")

    def run(self) -> AgentReport:
        history: List[int] = []
        reasons: List[str] = []
        delay = self.backoff_s
        attempt = 0          # FAILURE restarts consumed (budgeted)
        planned = 0          # rollout reloads (free, capped separately)
        launches = 0
        while attempt <= self.max_restarts:
            env = dict(self.env, DST_ELASTIC_RESTART=str(launches))
            launches += 1
            self._write_status("running", attempt)
            t0 = time.monotonic()
            proc = subprocess.run(self.cmd, env=env)
            elapsed = time.monotonic() - t0
            history.append(proc.returncode)
            if proc.returncode == 0:
                self._write_status("done", attempt)
                return AgentReport(restarts=attempt, returncode=0,
                                   history=history, reasons=reasons,
                                   planned_restarts=planned)
            reason = classify_exit(proc.returncode,
                                   self.planned_exit_codes)
            reasons.append(reason)
            from ..telemetry.registry import get_registry
            if (reason.startswith("planned:")
                    and planned < self.max_planned_restarts):
                # rollout-triggered reload: relaunch NOW — no restart
                # budget consumed, no backoff slept, and the failure
                # backoff ladder is untouched (a flip mid-incident must
                # not reset a crash loop's climbing delay). Beyond the
                # planned cap the exit falls through to the failure path
                # — a worker stuck "planning" forever is a crash loop
                # wearing a flag.
                planned += 1
                get_registry().counter(
                    f"resilience/restart_reasons/{reason}").inc()
                logger.info(
                    f"elastic agent: planned worker reload ({reason}, "
                    f"#{planned}) — restarting without backoff")
                self._write_status("restarting", attempt, reason=reason,
                                   next_delay_s=0.0)
                continue
            logger.warning(
                f"elastic agent: worker failed ({reason}) "
                f"(attempt {attempt + 1}/{self.max_restarts + 1})")
            if attempt < self.max_restarts:
                from ..resilience.counters import record_restart

                record_restart()
                get_registry().counter(
                    f"resilience/restart_reasons/{reason}").inc()
                if self.on_restart is not None:
                    self.on_restart(attempt)
                if (self.healthy_after_s is not None
                        and elapsed >= self.healthy_after_s):
                    # a long stable run before this failure: fresh incident,
                    # restart the backoff schedule from the bottom
                    delay = self.backoff_s
                d = delay * (1.0 + self._rng.uniform(0.0, self.jitter))
                self._write_status("restarting", attempt + 1, reason=reason,
                                   next_delay_s=d)
                self._sleep(d)
                delay = min(delay * self.backoff_multiplier,
                            self.max_backoff_s)
            attempt += 1
        self._write_status("failed", self.max_restarts,
                           reason=reasons[-1] if reasons else None)
        return AgentReport(restarts=self.max_restarts,
                           returncode=history[-1], history=history,
                           reasons=reasons, planned_restarts=planned)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI: ``python -m deepspeed_tpu_torch.launcher.agent [--max-restarts N]
    [--backoff S] [--max-backoff S] [--jitter F] [--heartbeat PATH]
    -- cmd args...``"""
    import argparse

    p = argparse.ArgumentParser(prog="deepspeed_tpu_torch.launcher.agent")
    p.add_argument("--max-restarts", type=int, default=3)
    p.add_argument("--backoff", type=float, default=1.0)
    p.add_argument("--backoff-multiplier", type=float, default=2.0)
    p.add_argument("--max-backoff", type=float, default=60.0)
    p.add_argument("--jitter", type=float, default=0.25)
    p.add_argument("--healthy-after", type=float, default=None,
                   help="runs longer than this reset the backoff (seconds)")
    p.add_argument("--heartbeat", type=str, default=None,
                   help="status file overwritten while the worker is down")
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="training command (prefix with --)")
    args = p.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    if not cmd:
        p.error("no command given")
    report = ElasticAgent(cmd, max_restarts=args.max_restarts,
                          backoff_s=args.backoff,
                          backoff_multiplier=args.backoff_multiplier,
                          max_backoff_s=args.max_backoff,
                          jitter=args.jitter,
                          healthy_after_s=args.healthy_after,
                          heartbeat_path=args.heartbeat).run()
    logger.info(f"elastic agent: done restarts={report.restarts} "
                f"rc={report.returncode} reasons={report.reasons}")
    return report.returncode


if __name__ == "__main__":
    sys.exit(main())
