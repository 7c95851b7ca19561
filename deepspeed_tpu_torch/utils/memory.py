"""Memory introspection: the ``memory_breakdown`` config's read-out.

Ports ``deepspeed_tpu/utils/memory.py`` (the reference's
``see_memory_usage``): the device's allocator statistics from
``torch.cuda.memory_stats`` in GB, and the host's resident set from
``/proc``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from .logging import log_dist

# torch.cuda.memory_stats key -> the JAX package's record key
_STATS = (("allocated_bytes.all.current", "hbm_in_use_gb"),
          ("allocated_bytes.all.peak", "hbm_peak_gb"),
          ("reserved_bytes.all.current", "hbm_reserved_gb"))


def device_memory_stats(device=None) -> Dict[str, float]:
    """The card's allocator statistics in GB (in use, peak, reserved and
    the card's total as ``hbm_limit_gb``); empty for the CPU or without
    a card."""
    dev = torch.device(device) if device is not None else None
    if (dev is not None and dev.type != "cuda") or \
            not torch.cuda.is_available():
        return {}
    try:
        raw = torch.cuda.memory_stats(dev)
        total = torch.cuda.get_device_properties(
            dev if dev is not None else torch.cuda.current_device()
        ).total_memory
    except Exception:
        return {}
    stats = {out: round(raw[key] / 1e9, 3) for key, out in _STATS
             if key in raw}
    stats["hbm_limit_gb"] = round(total / 1e9, 3)
    return stats


def host_rss_gb() -> Optional[float]:
    try:
        with open(f"/proc/{os.getpid()}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return round(int(line.split()[1]) / 1e6, 3)  # kB -> GB
    except OSError:
        pass
    return None


def see_memory_usage(tag: str, force: bool = False, ranks=(0,)
                     ) -> Dict[str, float]:
    """Log (and return) the device and host memory. ``force`` is the
    reference's argument: callers gate on their config themselves."""
    stats = device_memory_stats()
    rss = host_rss_gb()
    if rss is not None:
        stats["host_rss_gb"] = rss
    pretty = ", ".join(f"{k}={v}" for k, v in stats.items()) \
        or "no allocator stats"
    log_dist(f"MEM {tag}: {pretty}", ranks=list(ranks))
    return stats
