"""Pin the CPU arithmetic of a process that computes a CPU reference.

An fp32 result on the CPU depends on more than its inputs: ATen picks its
vectorized kernels by the host's ISA (``ATEN_CPU_CAPABILITY``: default,
avx2, avx512), MKL picks its code path by the CPU (``MKL_CBWR``), and a
reduction split over intra-op threads sums in another order for another
thread count. Two hosts (or two launches under another environment) then
read another reference for the same step. A process pinned here uses one
value of each, available on every x86-64 host that can run the card:

* :func:`pinned_env` — the environment a child process must start with
  (ATen reads its capability when ``torch`` loads, so the variables have
  to be in place before the child imports it: set them in the parent
  before it spawns, e.g. with :func:`pinned_spawn_env`);
* :func:`pin_threads` — the child's intra- and inter-op thread counts;
* :func:`check_pinned` — what the child actually runs under, raising when
  the capability is not the pinned one (a host without AVX2 would fall
  back silently otherwise).
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterator, Mapping, Optional

PINNED_CAPABILITY = "avx2"
PINNED_THREADS = 2
# the ISA flags the pin relies on (/proc/cpuinfo names)
PIN_FLAGS = ("avx2", "fma", "avx512f")


def pinned_env(base: Optional[Mapping[str, str]] = None,
               threads: int = PINNED_THREADS) -> Dict[str, str]:
    """``base`` (default: this process's environment) with the pinned
    capability, MKL code path and thread counts."""
    env = dict(os.environ if base is None else base)
    env.update({"ATEN_CPU_CAPABILITY": PINNED_CAPABILITY,
                "MKL_CBWR": "COMPATIBLE",
                "OMP_NUM_THREADS": str(int(threads)),
                "MKL_NUM_THREADS": str(int(threads))})
    return env


@contextlib.contextmanager
def pinned_spawn_env(threads: int = PINNED_THREADS) -> Iterator[None]:
    """Set :func:`pinned_env` in ``os.environ`` for the block (processes
    started inside it inherit it), then restore the old values."""
    new = pinned_env({}, threads)
    old = {k: os.environ.get(k) for k in new}
    os.environ.update(new)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def pin_threads(threads: int = PINNED_THREADS) -> None:
    """Fix the intra- and inter-op thread counts (the inter-op count can
    be set only before the process runs parallel work; a later call keeps
    the first setting)."""
    import torch

    torch.set_num_threads(int(threads))
    try:
        torch.set_num_interop_threads(int(threads))
    except RuntimeError:
        pass


def check_pinned(threads: int = PINNED_THREADS) -> Dict[str, object]:
    """The capability, MKL path and thread count this process runs
    under; raises RuntimeError when they are not the pinned ones."""
    import torch

    got = {"capability": torch.backends.cpu.get_cpu_capability(),
           "mkl_cbwr": os.environ.get("MKL_CBWR"),
           "threads": torch.get_num_threads()}
    want = {"capability": PINNED_CAPABILITY.upper(),
            "mkl_cbwr": "COMPATIBLE", "threads": int(threads)}
    if got != want:
        raise RuntimeError(f"CPU arithmetic not pinned: running under {got}, "
                           f"pinned {want}")
    return got


def cpu_report() -> str:
    """The host CPU's model and which of :data:`PIN_FLAGS` it has, from
    ``/proc/cpuinfo`` ("unknown" where that file is missing)."""
    model, flags = "unknown", set()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, val = line.partition(":")
                key = key.strip()
                if key == "model name" and model == "unknown":
                    model = val.strip()
                elif key == "flags" and not flags:
                    flags = set(val.split())
    except OSError:
        pass
    have = " ".join(f"{fl}={'yes' if fl in flags else 'no'}"
                    for fl in PIN_FLAGS)
    return f"{model}; {have}"
