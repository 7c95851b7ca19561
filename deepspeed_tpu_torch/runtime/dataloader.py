"""Data loading.

Ports ``deepspeed_tpu/runtime/dataloader.py``: :class:`DataLoader` yields
GLOBAL batches of ``batch_size`` samples, shuffled per epoch from
``np.random.default_rng(seed + epoch)``, collated on the host and placed
on the loader's device as tensors (the engine takes the global batch and
slices its micro-batches and ranks itself, so the JAX package's sharded
placement, ``shard_batch``, has no counterpart here).

With ``prefetch_depth > 0`` a producer thread runs collate + curriculum +
upload into a bounded queue, so batch N+1 is on the card while the step
on batch N runs. On a CUDA device the producer copies each batch into
pinned host memory and uploads it on a stream of its own; the consumer
makes its current stream wait for that upload and marks each tensor as
used on it (``record_stream``), so the caching allocator does not hand
the memory to another tensor while the step still reads it. The
checkpointable position (``state_dict``) is always the CONSUMER's,
never the producer's read-ahead.

:meth:`DataLoader.batch_struct` describes the next batch (shape and
dtype of each leaf, :class:`TensorSpec`) for ``TrainEngine.warmup``;
:func:`prefetch` keeps batches of any iterator in flight. Not ported:
``shard_batch`` (the engine slices its ranks' rows itself).
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
import weakref
from typing import Any, Callable, Iterable, Iterator, NamedTuple, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.logging import logger


class TensorSpec(NamedTuple):
    """A batch leaf's description: what ``jax.ShapeDtypeStruct`` is to
    the JAX package's loader."""

    shape: tuple
    dtype: torch.dtype


def _tree_map(fn: Callable, x: Any) -> Any:
    """``fn`` over the leaves of nested dicts, lists and tuples."""
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_map(fn, v) for v in x)
    return fn(x)


def _tree_leaves(x: Any) -> list:
    out: list = []
    _tree_map(out.append, x)
    return out


def _host_tensor(x: Any) -> torch.Tensor:
    """A leaf as a CPU tensor, numpy's dtype kept."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


class DataLoader:
    """Iterates a dataset in global batches on ``device`` (default
    ``"cuda"``, which raises without a card; ``"cpu"`` asks for the CPU).

    ``dataset`` may be any sequence of samples, a numpy array with a
    leading sample dim, or a dict of such arrays. Each batch is
    ``collate_fn`` of its samples (default: numpy stacks, keeping tuple
    and dict samples' structure), then ``curriculum_fn(global batch
    index, batch)``, with its leaves as tensors on ``device``.

    ``prefetch_depth > 0`` keeps that many batches in flight on a producer
    thread; ``collate_fn`` / ``curriculum_fn`` then run on that thread.
    ``data_wait_s`` accumulates the host time the consumer spent waiting
    for (sync: producing) each batch."""

    def __init__(self, dataset: Any, batch_size: int, device=None, *,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 collate_fn: Optional[Callable[[list], Any]] = None,
                 curriculum_fn: Optional[Callable[[int, Any], Any]] = None,
                 prefetch_depth: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.collate_fn = collate_fn or _default_collate
        self.curriculum_fn = curriculum_fn
        self.prefetch_depth = int(prefetch_depth)
        self.epoch = 0
        self._batch_index = 0  # batches consumed in the current epoch
        self._n = _dataset_len(dataset)
        # bumped whenever the position is rewound out from under a live
        # iterator; the prefetch consumer restarts its producer then
        self._position_gen = 0
        # weakly held, so an abandoned iterator can still be collected
        self._active_prefetch: Optional[weakref.ref] = None
        self._upload_stream = None   # the producer's CUDA stream, made lazily
        self.data_wait_s = 0.0
        if batch_size > self._n and drop_last:
            raise ValueError(f"batch_size {batch_size} exceeds dataset size "
                             f"{self._n}")

    def __len__(self) -> int:
        if self.drop_last:
            return self._n // self.batch_size
        return (self._n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self._batch_index = 0
        self._position_gen += 1

    # -- checkpointable position: the shuffle is a pure function of seed +
    # epoch, so (epoch, batch_index) is the pipeline position
    def state_dict(self) -> dict:
        """Position of the NEXT batch the consumer receives; the end of an
        epoch reads as (epoch + 1, 0). Batches the producer read ahead
        are not counted."""
        epoch, b = int(self.epoch), int(self._batch_index)
        nb = len(self)
        if nb > 0 and b >= nb:
            epoch, b = epoch + 1, 0
        return {"epoch": epoch, "batch_index": b, "seed": int(self.seed)}

    def load_state_dict(self, sd: dict) -> None:
        """Restore a position; it takes effect on the next ``iter()`` and
        on a live iterator (the prefetch iterator drains its queue and
        restarts its producer there)."""
        if int(sd.get("seed", self.seed)) != self.seed:
            logger.warning(
                f"dataloader resume: checkpoint seed {sd.get('seed')} != "
                f"configured seed {self.seed}; batch order will diverge")
        self.epoch = int(sd.get("epoch", 0))
        self._batch_index = int(sd.get("batch_index", 0))
        self._position_gen += 1

    def _epoch_order(self, epoch: int) -> np.ndarray:
        order = np.arange(self._n)
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        return order

    def _assemble(self, epoch: int, b: int, order: np.ndarray,
                  nb: int) -> Optional[Any]:
        """Index-slice + collate + curriculum of batch ``b`` on the host. A
        trailing partial batch is None under ``drop_last``, else padded
        by wrapping to the epoch's head."""
        idx = order[b * self.batch_size:(b + 1) * self.batch_size]
        if len(idx) < self.batch_size:
            if self.drop_last:
                return None
            idx = np.concatenate([idx, order[: self.batch_size - len(idx)]])
        batch = self.collate_fn([_dataset_get(self.dataset, int(i))
                                 for i in idx])
        if self.curriculum_fn is not None:
            batch = self.curriculum_fn(epoch * nb + b, batch)
        return batch

    def _produce(self, epoch: int, b: int, order: np.ndarray, nb: int,
                 ahead: bool = False):
        """(batch on the device, its upload's CUDA event or None), or None
        for a dropped partial batch. ``ahead``: the producer thread's
        upload, on the loader's own stream. Mutates no position."""
        batch = self._assemble(epoch, b, order, nb)
        if batch is None:
            return None
        host = _tree_map(_host_tensor, batch)
        if self.device.type != "cuda" or not ahead:
            return _tree_map(lambda t: t.to(self.device), host), None
        with torch.cuda.device(self.device):
            if self._upload_stream is None:
                self._upload_stream = torch.cuda.Stream(self.device)
            stream = self._upload_stream
            with torch.cuda.stream(stream):
                dev = _tree_map(lambda t: t.pin_memory().to(
                    self.device, non_blocking=True), host)
                done = torch.cuda.Event()
                done.record(stream)
        return dev, done

    def _receive(self, batch: Any, done) -> Any:
        """The consumer's side of an upload made ahead: its current stream
        waits for the upload, and every tensor is marked as used on that
        stream."""
        if done is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(done)
            for t in _tree_leaves(batch):
                t.record_stream(cur)
        return batch

    def __iter__(self) -> Iterator[Any]:
        if self._active_prefetch is not None:
            active = self._active_prefetch()
            if active is not None:
                active.close()
            self._active_prefetch = None
        # a consumed epoch (or a fresh loader) starts from 0; a mid-epoch
        # position restored by load_state_dict resumes there
        if self._batch_index >= len(self):
            self._batch_index = 0
        if self.prefetch_depth > 0:
            it = _PrefetchIterator(self, self.prefetch_depth)
            self._active_prefetch = weakref.ref(it)
            return it
        return self._sync_iter()

    def batch_struct(self) -> Optional[Any]:
        """The next batch as :class:`TensorSpec` leaves (one collate on
        the host, nothing uploaded, the position unchanged), or None for
        an empty loader."""
        nb = len(self)
        if nb == 0 or self._n == 0:
            return None
        b = self._batch_index if self._batch_index < nb else 0
        batch = self._assemble(self.epoch, b, self._epoch_order(self.epoch),
                               nb)
        if batch is None:
            return None
        return _tree_map(lambda x: TensorSpec(
            tuple(_host_tensor(x).shape), _host_tensor(x).dtype), batch)

    def _sync_iter(self) -> Iterator[Any]:
        nb = len(self)
        epoch = self.epoch
        order = self._epoch_order(epoch)
        while self._batch_index < nb:
            if self.epoch != epoch:  # position rewound across epochs
                epoch = self.epoch
                order = self._epoch_order(epoch)
            b = self._batch_index
            t0 = time.perf_counter()
            item = self._produce(epoch, b, order, nb)
            self.data_wait_s += time.perf_counter() - t0
            if item is None:
                break
            self._batch_index = b + 1
            yield item[0]


_END_OF_EPOCH = "__end_of_epoch__"
_PRODUCER_ERROR = "__error__"


def _queue_put(q: queue_mod.Queue, stop: threading.Event, item) -> bool:
    """Bounded put that stays responsive to ``stop`` (a blocking put on a
    full queue would deadlock ``close()``)."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue_mod.Full:
            continue
    return False


def _producer_loop(loader: DataLoader, q: queue_mod.Queue,
                   stop: threading.Event, gen: int, epoch: int, b: int,
                   nb: int) -> None:
    """Producer body: walk the epoch order from (epoch, b), enqueuing
    produced batches until the epoch ends or ``stop`` is set.
    Module-level, so the thread holds the loader and not the iterator."""
    try:
        order = loader._epoch_order(epoch)
        while b < nb and not stop.is_set():
            item = loader._produce(epoch, b, order, nb, ahead=True)
            if item is None:  # dropped trailing partial batch
                break
            if not _queue_put(q, stop, (gen, epoch, b + 1, item)):
                return
            b += 1
        _queue_put(q, stop, (gen, _END_OF_EPOCH, 0, None))
    except Exception as e:  # surface producer crashes to the consumer
        _queue_put(q, stop, (gen, _PRODUCER_ERROR, 0, e))


class _PrefetchIterator:
    """Consumer half of the background pipeline: a producer thread walks
    the epoch order from the loader's position and enqueues ``(generation,
    epoch, next_index, (batch, upload event))`` into a queue of ``depth``
    slots. The consumer commits the loader position only when it dequeues
    a batch; a position rewound under it (the loader bumps
    ``_position_gen``) drains the queue and restarts the producer."""

    def __init__(self, loader: DataLoader, depth: int):
        self.loader = loader
        self.depth = max(1, int(depth))
        self._closed = False
        self._queue: queue_mod.Queue = None  # type: ignore[assignment]
        self._stop: threading.Event = None   # type: ignore[assignment]
        self._thread: Optional[threading.Thread] = None
        self._finalizer: Optional[weakref.finalize] = None
        self._gen = -1
        self._start_producer()

    def _start_producer(self) -> None:
        loader = self.loader
        self._gen = loader._position_gen
        self._queue = queue_mod.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        nb = len(loader)
        b = loader._batch_index
        if b >= nb:  # restart at a consumed-epoch position
            b = 0
        self._thread = threading.Thread(
            target=_producer_loop,
            args=(loader, self._queue, self._stop, self._gen, loader.epoch,
                  b, nb),
            name="dst-prefetch", daemon=True)
        # an abandoned iterator still stops its producer, on GC and at exit
        if self._finalizer is not None:
            self._finalizer.detach()
        self._finalizer = weakref.finalize(
            self, _shutdown_producer, self._stop, self._queue, self._thread)
        self._thread.start()

    def __iter__(self) -> "_PrefetchIterator":
        return self

    def __next__(self) -> Any:
        if self._closed:
            raise StopIteration
        loader = self.loader
        while True:
            if self._gen != loader._position_gen:
                self._restart()
            t0 = time.perf_counter()
            gen, epoch, next_b, item = self._queue.get()
            loader.data_wait_s += time.perf_counter() - t0
            if gen != self._gen:  # stale leftover from before a restart
                continue
            if epoch == _PRODUCER_ERROR:
                self.close()
                raise item
            if epoch == _END_OF_EPOCH:
                if self._gen != loader._position_gen:
                    continue  # rewound during the final get: restart
                self.close()
                raise StopIteration
            loader.epoch = epoch
            loader._batch_index = next_b
            return loader._receive(*item)

    def _restart(self) -> None:
        self._stop_and_drain()
        self._start_producer()

    def _stop_and_drain(self) -> None:
        if self._finalizer is not None:
            self._finalizer.detach()
            self._finalizer = None
        _shutdown_producer(self._stop, self._queue, self._thread)
        self._thread = None

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._stop_and_drain()
        ref = self.loader._active_prefetch
        if ref is not None and ref() is self:
            self.loader._active_prefetch = None


def _shutdown_producer(stop: threading.Event, q: queue_mod.Queue,
                       thread: Optional[threading.Thread]) -> None:
    """Stop a producer thread and wait for it to exit (module-level so
    ``weakref.finalize`` holds no reference back to the iterator)."""
    stop.set()
    while True:  # unblock a producer stuck on a full queue
        try:
            q.get_nowait()
        except queue_mod.Empty:
            break
    if thread is not None and thread.is_alive():
        thread.join(timeout=30.0)


def _dataset_len(ds: Any) -> int:
    if isinstance(ds, dict) or not hasattr(ds, "__len__"):
        return int(np.shape(_tree_leaves(ds)[0])[0])
    return len(ds)


def _dataset_get(ds: Any, i: int) -> Any:
    if hasattr(ds, "__getitem__") and not isinstance(ds, dict):
        return ds[i]
    return _tree_map(lambda a: a[i], ds)


def _default_collate(samples: list) -> Any:
    first = samples[0]
    if isinstance(first, (tuple, list)):
        return type(first)(np.stack([s[j] for s in samples])
                           for j in range(len(first)))
    if isinstance(first, dict):
        return {k: np.stack([s[k] for s in samples]) for k in first}
    return np.stack(samples)


class RepeatingLoader:
    """Cycles a loader forever, advancing its epoch at each wrap."""

    def __init__(self, loader: Iterable):
        self.loader = loader
        self._it = iter(loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._it)
        except StopIteration:
            if hasattr(self.loader, "set_epoch"):
                self.loader.set_epoch(getattr(self.loader, "epoch", 0) + 1)
            self._it = iter(self.loader)
            return next(self._it)


def prefetch(iterator: Iterable, size: int = 2, device=None
             ) -> Iterator[Any]:
    """Keep ``size`` batches of ``iterator`` in flight: the next batches'
    host work (collate, tokenize) runs before the current one is handed
    out, and with ``device`` given each batch's tensors are copied there
    as it is queued (``non_blocking``), so the training loop finds them
    uploaded. For a :class:`DataLoader` its ``prefetch_depth`` is the
    better tool: a producer thread, and a checkpointable position that
    counts only what was consumed."""
    import collections

    queue: collections.deque = collections.deque()
    it = iter(iterator)
    dev = None if device is None else torch.device(device)

    def place(item):
        if dev is None:
            return item
        return _tree_map(lambda t: t.to(dev, non_blocking=True)
                         if isinstance(t, torch.Tensor) else t, item)

    def enqueue(n):
        for _ in range(n):
            try:
                queue.append(place(next(it)))
            except StopIteration:
                return

    enqueue(size)
    while queue:
        yield queue.popleft()
        enqueue(1)
