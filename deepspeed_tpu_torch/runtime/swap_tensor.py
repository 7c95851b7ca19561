"""Tensor swapping and ZeRO offload's parked state.

Ports ``deepspeed_tpu/runtime/swap_tensor.py`` (the reference's
``AsyncTensorSwapper`` and ``OptimizerSwapper``) over the aio engine of
``ops/aio.py``, and adds what the port's trainer parks its state in:

* :class:`AsyncTensorSwapper`: host tensors to and from one file per key
  (``<key>.bin``) through the aio thread pool; a whole-file rewrite
  truncates, so a smaller tensor never leaves a stale tail; a read that
  finds a file of another length, or reads short, raises.
* :class:`OptimizerSwapper`: a state tree to disk and back, a ``Params``
  dict (the masters) or an optimizer's NamedTuple (``count`` and the other
  non-tensor fields stay on the host; each tree of tensors goes to disk).
  Each file is named by the leaf's key in the JAX package's tree
  (``jax.tree_util.keystr``, sanitized as JAX's ``_sanitize`` does:
  ``.mu__layers____wq__.bin``), so both packages write the same names; the
  per-layer leaves ``layers.<i>.<leaf>`` of a stacked JAX leaf are chunks
  of one file at layer ``i``'s offset, as the stacked array lies.
* :class:`OffloadStore`: one engine's parked trees, in host memory
  (``"cpu"``: pinned, by ``cudaHostRegister``, on a CUDA engine; on a CPU
  engine the caller asked for the CPU and there is nothing to pin) or on
  disk (``"nvme"``, staged through host memory around the step).
* :class:`LeafStream`: each leaf's parked tensors through the device a
  window of leaves at a time: uploads on a side CUDA stream ahead of the
  update, the update on the caller's stream, the write-back on a second
  side stream, ordered by events. Counters: the most leaves and bytes
  the window held, and the bytes and seconds of the copies.
"""

from __future__ import annotations

import os
import time
import weakref
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch

from ..utils.logging import log_dist

Params = Dict[str, torch.Tensor]


class SwapFileError(OSError):
    """A swap file that is missing, of the wrong length, or read short."""


def _sanitize(keystr: str) -> str:
    return "".join(c if c.isalnum() or c in "._-" else "_" for c in keystr)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def host_zeros(shape, dtype: torch.dtype, pin: bool) -> torch.Tensor:
    """A host tensor (zeros: its pages are touched here, by the fill's
    threads, rather than one by one by the first copy into it),
    page-locked when ``pin`` (a CUDA engine): ``cudaHostRegister`` on an
    exact-size allocation (the caching host allocator rounds every block
    up to a power of two). A failed registration raises: offload never
    runs from pageable memory in its place."""
    t = torch.zeros(shape, dtype=dtype)
    if pin and t.numel():
        ptr, n = t.data_ptr(), _nbytes(t)
        cudart = torch.cuda.cudart()
        err = int(cudart.cudaHostRegister(ptr, n, 0))
        if err != 0:
            raise RuntimeError(f"pinning {n} B of host memory for ZeRO "
                               f"offload failed (cudaError {err})")
        weakref.finalize(t, cudart.cudaHostUnregister, ptr)
    return t


def host_zeros_many(specs: List[Tuple[Any, torch.dtype]], pin: bool
                 ) -> List[torch.Tensor]:
    """:func:`host_zeros` of each ``(shape, dtype)``, several at once (a
    host touches and page-locks fresh memory at a few GB/s a thread)."""
    if len(specs) < 2:
        return [host_zeros(shape, dtype, pin) for shape, dtype in specs]
    with ThreadPoolExecutor(min(len(specs), os.cpu_count() or 1)) as pool:
        return list(pool.map(lambda sd: host_zeros(sd[0], sd[1], pin),
                             specs))


class AsyncTensorSwapper:
    """Host tensors to and from files through the aio thread pool (the
    reference's ``AsyncTensorSwapper``). A swap submits and returns;
    :meth:`wait_all` fences. A missing aio library is built at first use,
    and a failed build raises."""

    def __init__(self, swap_dir: str, n_threads: int = 4):
        from ..ops.aio import AsyncIOHandle

        self.swap_dir = Path(swap_dir)
        self.swap_dir.mkdir(parents=True, exist_ok=True)
        self.handle = AsyncIOHandle(n_threads=n_threads)
        self._pending: Dict[int, Tuple[str, int]] = {}   # request -> (path, bytes)

    def path(self, key: str) -> str:
        return str(self.swap_dir / f"{key}.bin")

    def swap_out(self, key: str, tensor: torch.Tensor, offset: int = 0,
                 truncate: bool = True) -> None:
        """Write ``tensor`` (a contiguous host tensor, kept alive until
        :meth:`wait_all`) at ``offset`` of ``key``'s file; ``truncate``
        ends the file there (a whole-file rewrite, or a stack's last
        chunk)."""
        path = self.path(key)
        req = self.handle.async_pwrite(tensor, path, offset,
                                       truncate=truncate)
        self._pending[req] = (path, _nbytes(tensor))

    def swap_in(self, key: str, buffer: torch.Tensor, offset: int = 0,
                file_bytes: Optional[int] = None) -> torch.Tensor:
        """Read ``buffer``'s bytes from ``offset`` of ``key``'s file into
        it; :meth:`wait_all` before use. ``file_bytes`` (default: the
        buffer's) is the file's length, checked now."""
        path = self.path(key)
        want = _nbytes(buffer) if file_bytes is None else file_bytes
        try:
            have = os.path.getsize(path)
        except OSError as e:
            raise SwapFileError(e.errno, f"swap file {path}: {e.strerror}")
        if have != want:
            raise SwapFileError(0, f"swap file {path} holds {have} B; the "
                                   f"parked state has {want} B")
        req = self.handle.async_pread(buffer, path, offset)
        self._pending[req] = (path, _nbytes(buffer))
        return buffer

    def wait_all(self) -> None:
        """Wait for every request; a failed or short one raises (after
        all are drained)."""
        bad = []
        while self._pending:
            try:
                done = self.handle.wait(1)
            except OSError as e:
                for rid, _ in e.completed + e.failed:
                    self._pending.pop(rid, None)
                bad.append(str(e))
                continue
            for rid, n in done:
                path, want = self._pending.pop(rid)
                if n != want:
                    bad.append(f"{path}: {n} of {want} B")
        if bad:
            raise SwapFileError(0, "swap I/O failed: " + "; ".join(bad))

    def bytes_on_disk(self) -> int:
        return sum(f.stat().st_size for f in self.swap_dir.glob("*.bin"))


class _Leaf:
    __slots__ = ("key", "offset", "shape", "dtype", "nbytes", "last")

    def __init__(self, key, offset, shape, dtype, nbytes):
        self.key, self.offset, self.shape = key, offset, tuple(shape)
        self.dtype, self.nbytes, self.last = dtype, nbytes, False


class OptimizerSwapper:
    """A state tree on disk between uses (the reference's
    ``OptimizerSwapper``): a ``{name: tensor}`` dict, or an optimizer's
    NamedTuple whose dict fields are trees of tensors (other fields stay
    in memory). ``swap_out(tree)`` writes every leaf (device tensors are
    copied to the host first); ``swap_in(device=None)`` reads them back
    into fresh host tensors (moved to ``device`` when given). File names
    are the leaves' JAX keys (the module docstring). ``last`` sums the
    bytes and seconds of the swaps each way since it was last cleared."""

    def __init__(self, swap_dir: str, n_threads: int = 4):
        self.swapper = AsyncTensorSwapper(swap_dir, n_threads=n_threads)
        self._spec: Dict[str, Dict[str, _Leaf]] = {}
        self._skeleton: Any = None     # None: a dict; else the NamedTuple
        self.last: Dict[str, float] = {}

    # -- layout ----------------------------------------------------------
    def _layout(self, field: str, tensors: Mapping[str, torch.Tensor]
                ) -> Dict[str, _Leaf]:
        from .engine import jax_leaf_key

        prefix = f".{field}" if field else ""
        stacks: Dict[str, List[Tuple[int, str]]] = {}
        for name in tensors:
            key, layer = jax_leaf_key(name)
            stacks.setdefault(_sanitize(prefix + key), []).append(
                (-1 if layer is None else layer, name))
        spec = {}
        for key, members in stacks.items():
            off = 0
            for _, name in sorted(members):
                t = tensors[name]
                spec[name] = _Leaf(key, off, t.shape, t.dtype, _nbytes(t))
                off += spec[name].nbytes
            spec[sorted(members)[-1][1]].last = True
        return {n: spec[n] for n in tensors}     # the tree's own order

    def _file_bytes(self, field: str) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for leaf in self._spec[field].values():
            out[leaf.key] = out.get(leaf.key, 0) + leaf.nbytes
        return out

    # -- per field -------------------------------------------------------
    def write(self, field: str, tensors: Mapping[str, torch.Tensor]) -> None:
        """Write one tree (``field`` "" for a dict of masters)."""
        t0 = time.perf_counter()
        spec = self._layout(field, tensors)
        self._spec[field] = spec
        nbytes = 0
        for name, t in tensors.items():
            leaf = spec[name]
            host = t.detach().to("cpu").contiguous()
            self.swapper.swap_out(leaf.key, host, leaf.offset,
                                  truncate=leaf.last)
            nbytes += leaf.nbytes
        self.swapper.wait_all()
        self._account("swap_out", nbytes, t0)

    def read(self, field: str) -> Params:
        """One tree read back into fresh host tensors."""
        t0 = time.perf_counter()
        files = self._file_bytes(field)
        spec = self._spec[field]
        out = dict(zip(spec, host_zeros_many(
            [(leaf.shape, leaf.dtype) for leaf in spec.values()], False)))
        for name, leaf in spec.items():
            self.swapper.swap_in(leaf.key, out[name], leaf.offset,
                                 files[leaf.key])
        self.swapper.wait_all()
        self._account("swap_in", sum(leaf.nbytes for leaf in
                                     self._spec[field].values()), t0)
        return out

    def read_leaf(self, field: str, name: str) -> torch.Tensor:
        """One leaf read back into a fresh host tensor."""
        leaf = self._spec[field][name]
        buf = self.swapper.swap_in(leaf.key, torch.empty(leaf.shape,
                                                         dtype=leaf.dtype),
                                   leaf.offset,
                                   self._file_bytes(field)[leaf.key])
        self.swapper.wait_all()
        return buf

    def template(self, field: str) -> Params:
        """One tree's leaves as meta tensors (shapes and dtypes)."""
        return {n: torch.empty(leaf.shape, dtype=leaf.dtype, device="meta")
                for n, leaf in self._spec[field].items()}

    def _account(self, what: str, nbytes: int, t0: float) -> None:
        """Add to ``last`` (set to ``{}`` to start a new count)."""
        for k, v in ((f"{what}_bytes", float(nbytes)),
                     (f"{what}_s", time.perf_counter() - t0)):
            self.last[k] = self.last.get(k, 0.0) + v

    # -- whole trees -----------------------------------------------------
    def swap_out(self, tree: Any) -> None:
        fields = getattr(tree, "_asdict", None)
        if fields is None:
            self._skeleton = None
            self.write("", tree)
        else:
            self._skeleton = tree._replace(**{
                k: None for k, v in fields().items() if isinstance(v, dict)})
            for k, v in fields().items():
                if isinstance(v, dict):
                    self.write(k, v)
        log_dist(f"state swapped out: "
                 f"{self.swapper.bytes_on_disk() / 1e6:.1f} MB on disk")

    def swap_in(self, device=None) -> Any:
        if not self._spec:
            raise RuntimeError("nothing swapped out")

        def back(field):
            t = self.read(field)
            return t if device is None else {n: v.to(device)
                                             for n, v in t.items()}

        if self._skeleton is None:
            return back("")
        return self._skeleton._replace(**{k: back(k) for k in self._spec})


class OffloadStore:
    """One engine's parked trees (``field`` "" for the masters, an
    optimizer field such as ``"mu"`` for its trees). ``"cpu"``: a host
    tensor per leaf, page-locked on a CUDA engine, updated in place by
    the stream's write-back. ``"nvme"``: files under ``swap_dir``
    (:class:`OptimizerSwapper`); :meth:`stage` reads them into host
    memory for a step and :meth:`unstage` writes them back and frees it.
    """

    def __init__(self, mode: str, device: torch.device,
                 swap_dir: Optional[str] = None):
        if mode not in ("cpu", "nvme"):
            raise ValueError(f"offload device must be 'cpu' or 'nvme', got "
                             f"{mode!r}")
        self.mode = mode
        self.pin = device.type == "cuda"
        self.trees: Dict[str, Params] = {}      # parked (cpu) / staged (nvme)
        self.swapper = OptimizerSwapper(swap_dir) if mode == "nvme" else None

    def park(self, field: str, tensors: Mapping[str, torch.Tensor]) -> None:
        """Copies of ``tensors`` become the parked tree ``field``."""
        if self.swapper is not None:
            self.swapper.write(field, tensors)
            return
        host = self.trees.setdefault(field, {})
        new = [n for n in tensors if n not in host]
        host.update(zip(new, host_zeros_many(
            [(tensors[n].shape, tensors[n].dtype) for n in new], self.pin)))
        for n, t in tensors.items():
            host[n].copy_(t)

    def stage(self, fields) -> None:
        """Under ``"nvme"``, read the trees into host memory for a step
        (the swapper's ``last`` counts this step's swaps from here)."""
        if self.swapper is not None:
            self.swapper.last = {}
            for f in fields:
                if f not in self.trees:
                    self.trees[f] = self.swapper.read(f)

    def unstage(self) -> None:
        """Under ``"nvme"``, write the staged trees back and free them."""
        if self.swapper is not None:
            for f, tree in self.trees.items():
                self.swapper.write(f, tree)
            self.trees = {}

    def host(self, field: str) -> Params:
        """The tree's host tensors (parked, or staged for the step)."""
        return self.trees[field]

    def read(self, field: str) -> Params:
        """The tree for reading, without unparking it."""
        if field in self.trees:
            return self.trees[field]
        return self.swapper.read(field)

    def read_leaf(self, field: str, name: str) -> torch.Tensor:
        if field in self.trees:
            return self.trees[field][name]
        return self.swapper.read_leaf(field, name)

    def template(self, field: str) -> Params:
        if field in self.trees:
            return self.trees[field]
        return self.swapper.template(field)

    def bytes_on_disk(self) -> int:
        return self.swapper.swapper.bytes_on_disk() if self.swapper else 0


class LeafStream:
    """Parked leaves through the device, ``window`` leaves at a time
    (the module docstring). On a CPU engine the copies are plain host
    copies in order, counted the same way."""

    def __init__(self, device: torch.device, window: int):
        self.device = device
        self.window = max(1, int(window))
        cuda = device.type == "cuda"
        self.h2d = torch.cuda.Stream(device) if cuda else None
        self.d2h = torch.cuda.Stream(device) if cuda else None
        self._done: Optional[torch.cuda.Event] = None
        self.live = self.live_bytes = 0
        self.peak_live = self.peak_bytes = 0
        self._spans: List[Tuple[str, int, Any, Any]] = []

    def reset_stats(self) -> None:
        self.peak_live = self.peak_bytes = 0
        self._spans = []

    def _mark(self, stream):
        if stream is None:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def run(self, names: List[str],
            hosts: Mapping[str, Mapping[str, torch.Tensor]],
            fn: Callable[[str, Dict[str, torch.Tensor]],
                         Dict[str, torch.Tensor]]) -> None:
        """For each name in order: its host tensors ``hosts[name]``
        (``{field: tensor}``) uploaded, ``fn(name, device tensors)`` on
        the caller's stream, and what it returns (``{field: device
        tensor}``) written back into ``hosts[name][field]``. A leaf holds
        its device memory from its upload until its write-back is done:
        before the next upload the host waits for the oldest write-back
        once ``window`` leaves hold theirs (the caching allocator frees a
        block only when the copies that read it have finished)."""
        main = torch.cuda.current_stream(self.device) \
            if self.h2d is not None else None
        ahead: deque = deque()      # uploaded, not yet updated
        behind: deque = deque()     # written back: (done event, bytes)

        def retire():
            done, nbytes = behind.popleft()
            if done is not None:
                done.synchronize()
            self.live -= 1
            self.live_bytes -= nbytes

        def upload(n):
            while self.live >= self.window and behind:
                retire()
            host = hosts[n]
            bufs = {f: torch.empty(t.shape, dtype=t.dtype, device=self.device)
                    for f, t in host.items()}
            nbytes = sum(_nbytes(t) for t in host.values())
            self.live += 1
            self.live_bytes += nbytes
            self.peak_live = max(self.peak_live, self.live)
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            if main is None:
                t0 = time.perf_counter()
                for f, t in host.items():
                    bufs[f].copy_(t)
                self._spans.append(("h2d", nbytes, t0, time.perf_counter()))
                return n, bufs, nbytes, None
            # the buffers' blocks may be ones main's queued work frees
            self.h2d.wait_stream(main)
            with torch.cuda.stream(self.h2d):
                t0 = self._mark(self.h2d)
                for f, t in host.items():
                    bufs[f].copy_(t, non_blocking=True)
                t1 = self._mark(self.h2d)
            self._spans.append(("h2d", nbytes, t0, t1))
            return n, bufs, nbytes, t1

        order = iter(names)
        for n in order:
            ahead.append(upload(n))
            if len(ahead) == self.window:
                break
        while ahead:
            n, bufs, nbytes, ready = ahead.popleft()
            if ready is not None:
                main.wait_event(ready)
            out = fn(n, bufs)
            host = hosts[n]
            back = sum(_nbytes(t) for t in out.values())
            if main is None:
                t0 = time.perf_counter()
                for f, t in out.items():
                    host[f].copy_(t)
                self._spans.append(("d2h", back, t0, time.perf_counter()))
                behind.append((None, nbytes))
            else:
                self.d2h.wait_stream(main)
                with torch.cuda.stream(self.d2h):
                    t0 = self._mark(self.d2h)
                    for f, t in out.items():
                        host[f].copy_(t, non_blocking=True)
                    t1 = self._mark(self.d2h)
                self._spans.append(("d2h", back, t0, t1))
                for t in list(out.values()) + list(bufs.values()):
                    t.record_stream(self.d2h)
                behind.append((t1, nbytes))
            del out, bufs
            nxt = next(order, None)
            if nxt is not None:
                ahead.append(upload(nxt))
        if main is not None:
            main.wait_stream(self.d2h)
            self._done = torch.cuda.Event()
            self._done.record(self.d2h)
        self.live = self.live_bytes = 0

    def fence(self) -> None:
        """Wait for the last write-back: the host copies are then whole."""
        if self._done is not None:
            self._done.synchronize()

    def copy_stats(self) -> Dict[str, float]:
        """Bytes and seconds of the copies since :meth:`reset_stats` each
        way (device-event time on a CUDA engine), the window's peaks."""
        self.fence()
        out = {"h2d_bytes": 0.0, "h2d_s": 0.0, "d2h_bytes": 0.0,
               "d2h_s": 0.0}
        for kind, nbytes, t0, t1 in self._spans:
            out[f"{kind}_bytes"] += nbytes
            out[f"{kind}_s"] += (t1 - t0 if isinstance(t0, float)
                                 else t0.elapsed_time(t1) / 1e3)
        out["window_leaves"] = float(self.peak_live)
        out["window_bytes"] = float(self.peak_bytes)
        return out
