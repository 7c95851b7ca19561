"""Build the port's CUDA kernels from the sources in the checkout.

A kernel ``name`` is the file ``deepspeed_tpu_torch/csrc/<name>.cu`` with a
plain C interface. ``nvcc`` compiles it for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library that
:func:`load` opens with ``ctypes`` — no PyTorch headers, so a build takes
seconds. Libraries land in ``build/kernels/`` at the repo root (listed in
``.gitignore``), named by a hash of the flags, the source and every header
``csrc/*.cuh`` (:func:`source_digest`), and are built at first use in a
process. A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Mapping, Optional

REPO_ROOT = Path(__file__).resolve().parents[2]
CSRC = REPO_ROOT / "deepspeed_tpu_torch" / "csrc"
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FALLBACK = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's output per library: the -Xptxas -v register / shared-memory report
build_logs: Dict[str, str] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``. Raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(NVCC_FALLBACK)
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin): the CUDA "
        "kernels of deepspeed_tpu_torch are built from source at first use")


def source_digest(name: str, flags=(), csrc: Path = CSRC) -> str:
    """Hex digest that names the library of ``csrc/<name>.cu``: nvcc's
    flags, the source, and every ``*.cuh`` header beside it (by name and
    content), so that an edited header never reuses a stale build."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(flags)).encode())
    h.update((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    return h.hexdigest()


def load(name: str,
         defines: Optional[Mapping[str, int]] = None) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, compiled at first use.
    ``defines`` (``-D`` macros) build a separate library, a scratch variant
    for a measurement; its log is ``build_logs["<name> -DKEY=VALUE"]``."""
    flags = tuple(f"-D{k}={v}" for k, v in sorted((defines or {}).items()))
    key = " ".join((name,) + flags)
    if key in _libs:
        return _libs[key]
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}-{source_digest(name, flags)[:16]}.so"
    if out.exists():
        build_logs[key] = "(cached build)"
    else:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        build_logs[key] = proc.stdout
        if proc.returncode != 0:
            raise RuntimeError(f"CUDA kernel build failed: {' '.join(cmd)}\n"
                               f"{proc.stdout}")
        os.replace(tmp, out)     # atomic: a concurrent builder sees all or nothing
    _libs[key] = ctypes.CDLL(str(out))
    return _libs[key]
