"""Build the port's CUDA kernels and host libraries from the sources in
the checkout.

A kernel ``name`` is the file ``deepspeed_tpu_torch/csrc/<name>.cu`` with a
plain C interface. ``nvcc`` compiles it for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library that
:func:`load` opens with ``ctypes`` — no PyTorch headers, so a build takes
seconds. Libraries land in ``build/kernels/`` at the repo root (listed in
``.gitignore``), named by a hash of the flags, the source and every header
``csrc/*.cuh`` (:func:`source_digest`), and are built at first use in a
process. A missing ``nvcc`` or a failed build raises.

A host library ``name`` is ``csrc/<name>.cpp`` with a plain C interface
(the ragged batch construction, the aio engine): :func:`load_host`
compiles it with the host C++ compiler (``c++ -O3 -shared -fPIC``, plus
the library's own flags in ``HOST_EXTRA_FLAGS``: ``-pthread`` for
``ds_aio``) into the same directory, named by a digest of its flags and
source, and opens it with ``ctypes``. A missing compiler or a failed build
raises.
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

HOST_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")
# flags of one host library beside HOST_FLAGS (the aio engine's threads)
HOST_EXTRA_FLAGS: Dict[str, tuple] = {"ds_aio": ("-pthread",)}

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


def _open(key: str, out: Path, compile_cmd, what: str) -> ctypes.CDLL:
    """Open the library ``out``, first building it with
    ``compile_cmd(tmp_path)`` (a command list) when it does not exist;
    the compiler's output lands in ``build_logs[key]``."""
    if key in _libs:
        return _libs[key]
    if out.exists():
        build_logs[key] = "(cached build)"
    else:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = compile_cmd(tmp)
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        build_logs[key] = proc.stdout
        if proc.returncode != 0:
            raise RuntimeError(f"{what} build failed: {' '.join(cmd)}\n"
                               f"{proc.stdout}")
        os.replace(tmp, out)     # atomic: a concurrent build sees all or nothing
    _libs[key] = ctypes.CDLL(str(out))
    return _libs[key]


def load(name: str,
         defines: Optional[Mapping[str, int]] = None) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, compiled at first use.
    ``defines`` (``-D`` macros) build a separate library, a scratch variant
    for a measurement; its log is ``build_logs["<name> -DKEY=VALUE"]``."""
    flags = tuple(f"-D{k}={v}" for k, v in sorted((defines or {}).items()))
    key = " ".join((name,) + flags)
    if key in _libs:
        return _libs[key]
    out = BUILD_DIR / f"lib{name}-{source_digest(name, flags)[:16]}.so"
    return _open(key, out, lambda tmp: [
        find_nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp),
        str(CSRC / f"{name}.cu")], "CUDA kernel")


def find_cxx() -> str:
    """Path of the host C++ compiler: ``$CXX``, then ``c++`` / ``g++`` on
    ``PATH``. Raises when there is none."""
    for c in (os.environ.get("CXX"), "c++", "g++"):
        found = shutil.which(c) if c else None
        if found:
            return found
    raise RuntimeError(
        "no host C++ compiler (CXX, c++, g++): the host libraries of "
        "deepspeed_tpu_torch are built from source at first use")


def _host_flags(name: str) -> tuple:
    return HOST_FLAGS + HOST_EXTRA_FLAGS.get(name, ())


def host_digest(name: str, csrc: Path = CSRC) -> str:
    """Hex digest that names the library of ``csrc/<name>.cpp``: the
    compiler flags (the library's own too) and the source."""
    h = hashlib.sha256(" ".join(_host_flags(name)).encode())
    h.update((csrc / f"{name}.cpp").read_bytes())
    return h.hexdigest()


def load_host(name: str) -> ctypes.CDLL:
    """The host library built from ``csrc/<name>.cpp``, compiled at first
    use; its compiler output is ``build_logs["host:<name>"]``."""
    key = f"host:{name}"
    if key in _libs:
        return _libs[key]
    out = BUILD_DIR / f"lib{name}-{host_digest(name, CSRC)[:16]}.so"
    return _open(key, out, lambda tmp: [
        find_cxx(), *_host_flags(name), "-o", str(tmp),
        str(CSRC / f"{name}.cpp")], "host library")
