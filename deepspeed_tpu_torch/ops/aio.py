"""Python surface of the native async-IO engine.

Ports ``deepspeed_tpu/ops/aio.py`` (the reference ``aio_handle``:
``async_pread`` / ``async_pwrite`` / ``sync_pread`` / ``sync_pwrite`` /
``wait``) over ``csrc/ds_aio.cpp``, a POSIX thread pool of ``pread`` /
``pwrite`` built at first use by ``op_builder.load_host("ds_aio")`` into
``build/kernels/`` (a failed build raises). Buffers are contiguous CPU
``torch.Tensor``s, pinned or pageable, passed by ``data_ptr()``, or numpy
arrays; each is kept alive until its request completes.
"""

from __future__ import annotations

import ctypes
import os
from typing import Any, Dict, List, Tuple

import torch

_configured: Dict[int, bool] = {}


def _library() -> ctypes.CDLL:
    from .op_builder import load_host

    lib = load_host("ds_aio")
    if not _configured.get(id(lib)):
        i64, p = ctypes.c_int64, ctypes.c_void_p
        lib.ds_aio_create.restype = p
        lib.ds_aio_create.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.ds_aio_destroy.argtypes = [p]
        for fn in (lib.ds_aio_pread, lib.ds_aio_pwrite,
                   lib.ds_aio_pwrite_trunc):
            fn.restype = i64
            fn.argtypes = [p, ctypes.c_char_p, ctypes.c_void_p, i64, i64]
        lib.ds_aio_wait.restype = i64
        lib.ds_aio_wait.argtypes = [p, i64, ctypes.POINTER(i64),
                                    ctypes.POINTER(i64)]
        for fn in (lib.ds_aio_poll, lib.ds_aio_inflight):
            fn.restype = i64
            fn.argtypes = [p]
        _configured[id(lib)] = True
    return lib


def _pointer(buffer: Any) -> Tuple[int, int]:
    """(address, bytes) of a contiguous host buffer."""
    if isinstance(buffer, torch.Tensor):
        if buffer.device.type != "cpu":
            raise ValueError(f"aio buffers live in host memory; got a "
                             f"tensor on {buffer.device}")
        if not buffer.is_contiguous():
            raise ValueError("aio buffers must be contiguous")
        return buffer.data_ptr(), buffer.numel() * buffer.element_size()
    if not buffer.flags["C_CONTIGUOUS"]:
        raise ValueError("aio buffers must be contiguous")
    return buffer.ctypes.data, buffer.nbytes


class AsyncIOHandle:
    """Thread-pool async file IO (the reference ``aio_handle``)."""

    def __init__(self, n_threads: int = 4, queue_depth: int = 128):
        self._lib = _library()
        self._h = self._lib.ds_aio_create(n_threads, queue_depth)
        if not self._h:
            raise RuntimeError("ds_aio_create failed")
        self._buffers: Dict[int, Any] = {}   # kept alive while in flight

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._h = None
            self._lib.ds_aio_destroy(h)

    def _submit(self, fn, buffer, path: str, offset: int) -> int:
        ptr, nbytes = _pointer(buffer)
        req = fn(self._h, os.fsencode(path), ptr, nbytes, offset)
        if req < 0:
            raise RuntimeError("aio queue full")
        self._buffers[req] = buffer
        return req

    # -- async ----------------------------------------------------------
    def async_pread(self, buffer, path: str, offset: int = 0) -> int:
        return self._submit(self._lib.ds_aio_pread, buffer, path, offset)

    def async_pwrite(self, buffer, path: str, offset: int = 0,
                     truncate: bool = False) -> int:
        """``truncate=True`` drops any stale file tail beyond this write:
        for whole-file rewrites (explicit, so chunked writers at other
        offsets of the same file are never clobbered)."""
        fn = self._lib.ds_aio_pwrite_trunc if truncate \
            else self._lib.ds_aio_pwrite
        return self._submit(fn, buffer, path, offset)

    def wait(self, count: int = 1) -> List[Tuple[int, int]]:
        """Block for ``count`` completions; returns ``[(request id,
        bytes)]``. Every completion is drained (its buffer released)
        before an error is raised: an ``OSError`` carrying ``.completed``
        (the successful pairs) and ``.failed`` (``(request id, errno)``)."""
        ids = (ctypes.c_int64 * count)()
        res = (ctypes.c_int64 * count)()
        got = self._lib.ds_aio_wait(self._h, count, ids, res)
        out, errors = [], []
        for i in range(got):
            rid, r = int(ids[i]), int(res[i])
            self._buffers.pop(rid, None)
            if r < 0:
                errors.append((rid, -r))
            else:
                out.append((rid, r))
        if errors:
            rid, err = errors[0]
            exc = OSError(err, f"aio request {rid} (+{len(errors) - 1} "
                               f"more): " + os.strerror(err))
            exc.completed = out
            exc.failed = errors
            raise exc
        return out

    def poll(self) -> int:
        """Completions ready to be taken by :meth:`wait`."""
        return int(self._lib.ds_aio_poll(self._h))

    def inflight(self) -> int:
        """Requests submitted and not yet completed."""
        return int(self._lib.ds_aio_inflight(self._h))

    # -- sync ------------------------------------------------------------
    def sync_pwrite(self, buffer, path: str, offset: int = 0) -> int:
        self.async_pwrite(buffer, path, offset)
        return self.wait(1)[0][1]

    def sync_pread(self, buffer, path: str, offset: int = 0) -> int:
        self.async_pread(buffer, path, offset)
        return self.wait(1)[0][1]

