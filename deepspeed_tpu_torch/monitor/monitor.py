"""Experiment monitoring.

Ports ``deepspeed_tpu/monitor/monitor.py``: ``MonitorMaster`` fanning
step events out to CSV, TensorBoard and W&B writers (the reference's
``deepspeed/monitor``). The trainer's telemetry posts them as one of its
sinks (``telemetry.sinks.MonitorSink``). TensorBoard and W&B are imported
when their writer is built; where a package is missing the writer logs a
warning once and drops its events, as the JAX package's does.
"""

from __future__ import annotations

import csv
import os
from typing import Any, List, Optional, Tuple

from ..utils.logging import logger

Event = Tuple[str, float, int]  # (name, value, step)


class CsvMonitor:
    """One CSV file per event name under ``output_path/job_name``, each
    opened once a run."""

    def __init__(self, output_path: str, job_name: str):
        self.dir = os.path.join(output_path or "csv_monitor", job_name)
        os.makedirs(self.dir, exist_ok=True)
        self._files = {}

    def _writer(self, name: str):
        entry = self._files.get(name)
        if entry is None:
            fname = os.path.join(self.dir, name.replace("/", "_") + ".csv")
            new = not os.path.exists(fname) or os.path.getsize(fname) == 0
            f = open(fname, "a", newline="")
            w = csv.writer(f)
            if new:
                w.writerow(["step", name])
            entry = (f, w)
            self._files[name] = entry
        return entry

    def write_events(self, events: List[Event]) -> None:
        touched = set()
        for name, value, step in events:
            _, w = self._writer(name)
            w.writerow([step, value])
            touched.add(name)
        for name in touched:
            self._files[name][0].flush()

    def close(self) -> None:
        for f, _ in self._files.values():
            if not f.closed:
                f.flush()
                f.close()
        self._files.clear()


class TensorBoardMonitor:
    def __init__(self, output_path: str, job_name: str):
        self.writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.writer = SummaryWriter(log_dir=os.path.join(
                output_path or "tensorboard", job_name))
        except Exception as e:
            logger.warning(f"tensorboard writer unavailable ({e}); events "
                           f"dropped")

    def write_events(self, events: List[Event]) -> None:
        if self.writer is None:
            return
        for name, value, step in events:
            self.writer.add_scalar(name, value, step)
        self.writer.flush()

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
            self.writer = None


class WandbMonitor:
    def __init__(self, project: Optional[str], team: Optional[str],
                 group: Optional[str]):
        self.run = None
        try:
            import wandb

            self.run = wandb.init(project=project, entity=team, group=group)
        except Exception as e:
            logger.warning(f"wandb unavailable ({e}); events dropped")

    def write_events(self, events: List[Event]) -> None:
        if self.run is None:
            return
        for name, value, step in events:
            self.run.log({name: value}, step=step)

    def close(self) -> None:
        if self.run is not None:
            self.run.finish()
            self.run = None


class MonitorMaster:
    """Fan-out monitor over the writers the config enables."""

    def __init__(self, config: Any):
        self.writers: List[Any] = []
        if config.csv_enabled:
            self.writers.append(CsvMonitor(config.csv_output_path,
                                           config.csv_job_name))
        if config.tensorboard_enabled:
            self.writers.append(TensorBoardMonitor(
                config.tensorboard_output_path, config.tensorboard_job_name))
        if config.wandb_enabled:
            self.writers.append(WandbMonitor(config.wandb_project,
                                             config.wandb_team,
                                             config.wandb_group))

    def write_events(self, events: List[Event]) -> None:
        for w in self.writers:
            w.write_events(events)

    def close(self) -> None:
        """Flush and close every writer (idempotent)."""
        for w in self.writers:
            try:
                w.close()
            except Exception as e:
                logger.warning(f"monitor writer close failed: {e}")
        self.writers = []
