"""The port's ``runtime/dataloader.py`` against the JAX package's, on the
CPU: the same dataset, batch size and seed give the same batches in the
same order, batch for batch.

* shuffle on and off, ``drop_last`` on and off, two epochs through
  ``set_epoch``; list-of-tuple, dict and array datasets; a
  ``curriculum_fn`` that sees the global batch index;
* ``state_dict`` after two batches of an epoch and a fresh loader that
  ``load_state_dict``\\ s it yields the rest, as JAX's does; the position
  counts consumed batches, never the producer's read-ahead; a position
  loaded under a live prefetch iterator restarts its producer there;
* ``prefetch_depth`` 2 yields what depth 0 yields; ``RepeatingLoader``
  wraps into the next epoch; ``close()`` (and a finished epoch) leaves no
  producer thread alive; a producer's exception reaches the consumer;
* ``initialize(training_data=...)`` returns the loader bound to the
  engine, with the config's ``seed`` and ``dataloader.prefetch_depth``,
  and its batches are tensors on the engine's device that ``train_batch``
  takes.
"""

import threading

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.parallel.mesh import Topology
from deepspeed_tpu.runtime import dataloader as jax_dl
from deepspeed_tpu_torch.models import GPT2
from deepspeed_tpu_torch.runtime import dataloader as dl


def _topo():
    return Topology.build_virtual({"data": 1})


def _np(batch):
    """A batch (tensors or jax arrays, nested) as nested numpy."""
    if isinstance(batch, dict):
        return {k: _np(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_np(v) for v in batch)
    if isinstance(batch, torch.Tensor):
        return batch.numpy()
    return np.asarray(batch)


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(
            _equal(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _datasets():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 100, (22, 5)).astype(np.int32)
    y = rng.standard_normal((22, 3)).astype(np.float32)
    return {"array": x,
            "dict": {"input_ids": x, "labels": y},
            "tuples": [(x[i], y[i]) for i in range(22)]}


def _loaders(ds, batch_size=4, **kw):
    return (dl.DataLoader(ds, batch_size, "cpu", **kw),
            jax_dl.DataLoader(ds, batch_size, _topo(), **kw))


def _epochs(loader, n=2):
    out = []
    for e in range(n):
        loader.set_epoch(e)
        out.append([_np(b) for b in loader])
    return out


@pytest.mark.parametrize("kind", ["array", "dict", "tuples"])
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_last", [True, False])
def test_batches_match_jax(kind, shuffle, drop_last):
    ds = _datasets()[kind]
    ours, ref = _loaders(ds, shuffle=shuffle, seed=3, drop_last=drop_last)
    assert len(ours) == len(ref) == (5 if drop_last else 6)
    got, want = _epochs(ours), _epochs(ref)
    assert [len(e) for e in got] == [len(e) for e in want]
    assert all(_equal(a, b) for ea, eb in zip(got, want)
               for a, b in zip(ea, eb))
    assert not _equal(got[0][0], got[1][0]) if shuffle else \
        _equal(got[0][0], got[1][0])


def test_curriculum_fn_sees_the_global_batch_index():
    def curriculum(i, batch):
        return {k: v[:, : 2 + i % 3] if v.ndim > 1 else v
                for k, v in batch.items()}

    ds = _datasets()["dict"]
    ours, ref = _loaders(ds, seed=1, curriculum_fn=curriculum)
    got, want = _epochs(ours), _epochs(ref)
    assert all(_equal(a, b) for ea, eb in zip(got, want)
               for a, b in zip(ea, eb))
    assert [b["input_ids"].shape[1] for b in got[1]] == \
        [2 + i % 3 for i in range(5, 10)]


@pytest.mark.parametrize("depth", [0, 2])
def test_state_dict_round_trip_mid_epoch(depth):
    ds = _datasets()["dict"]
    ours, ref = _loaders(ds, seed=5, prefetch_depth=depth)
    ours.set_epoch(1)
    ref.set_epoch(1)
    it, jit = iter(ours), iter(ref)
    for _ in range(2):
        assert _equal(_np(next(it)), _np(next(jit)))
    # two consumed: the producer's read-ahead is not counted
    sd = ours.state_dict()
    assert sd == ref.state_dict() == {"epoch": 1, "batch_index": 2,
                                      "seed": 5}
    rest = [_np(b) for b in jit]
    fresh = dl.DataLoader(ds, 4, "cpu", seed=5, prefetch_depth=depth)
    fresh.load_state_dict(sd)
    got = [_np(b) for b in fresh]
    assert len(got) == len(rest) == 3
    assert all(_equal(a, b) for a, b in zip(got, rest))
    # the end of an epoch reads as the next epoch's start
    assert fresh.state_dict() == {"epoch": 2, "batch_index": 0, "seed": 5}
    if depth:
        it.close()


def test_load_state_dict_rewinds_a_live_prefetch_iterator():
    ds = _datasets()["array"]
    loader = dl.DataLoader(ds, 4, "cpu", seed=2, prefetch_depth=2)
    ref = [_np(b) for b in dl.DataLoader(ds, 4, "cpu", seed=2)]
    it = iter(loader)
    first = [_np(next(it)) for _ in range(3)]
    loader.load_state_dict({"epoch": 0, "batch_index": 1, "seed": 2})
    again = [_np(b) for b in it]
    assert all(_equal(a, b) for a, b in zip(first, ref[:3]))
    assert len(again) == 4 and all(_equal(a, b)
                                   for a, b in zip(again, ref[1:]))


@pytest.fixture
def producers():
    """The producer threads started during the test: the JAX package's
    loader names its threads alike, and an abandoned JAX iterator in
    this process may keep one alive."""
    before = set(threading.enumerate())
    return lambda: [t for t in threading.enumerate()
                    if t.name == "dst-prefetch" and t not in before]


def test_prefetch_equals_sync_and_close_stops_the_producer(producers):
    ds = _datasets()["tuples"]
    sync = [_np(b) for b in dl.DataLoader(ds, 4, "cpu", seed=9)]
    pre = dl.DataLoader(ds, 4, "cpu", seed=9, prefetch_depth=2)
    got = [_np(b) for b in pre]
    assert len(got) == len(sync) == 5
    assert all(_equal(a, b) for a, b in zip(got, sync))
    assert pre.data_wait_s > 0
    it = iter(pre)
    next(it)
    assert producers()
    it.close()
    assert not producers() and pre._active_prefetch is None
    with pytest.raises(StopIteration):
        next(it)
    # a new iter() closes the one before it
    a = iter(pre)
    next(a)
    b = iter(pre)
    assert a._closed and len(producers()) == 1
    b.close()
    assert not producers()


def test_producer_error_reaches_the_consumer(producers):
    def bad(samples):
        raise RuntimeError("collate failed")

    loader = dl.DataLoader(_datasets()["array"], 4, "cpu", prefetch_depth=2,
                           collate_fn=bad)
    with pytest.raises(RuntimeError, match="collate failed"):
        next(iter(loader))
    assert not producers()


def test_repeating_loader_wraps_into_the_next_epoch():
    ds = _datasets()["array"]
    ours = dl.RepeatingLoader(dl.DataLoader(ds, 4, "cpu", seed=4,
                                            prefetch_depth=2))
    ref = jax_dl.RepeatingLoader(jax_dl.DataLoader(ds, 4, _topo(), seed=4))
    got = [_np(next(ours)) for _ in range(12)]
    want = [_np(next(ref)) for _ in range(12)]
    assert all(_equal(a, b) for a, b in zip(got, want))
    assert ours.loader.epoch == 2
    ours.loader._active_prefetch().close()


def test_initialize_builds_and_binds_the_loader(producers):
    model = GPT2("tiny", device="cpu", n_layers=2, d_model=64, n_heads=4,
                 vocab_size=97, max_seq_len=32)
    toks = np.random.default_rng(1).integers(0, 97, (12, 16)).astype(
        np.int32)
    cfg = {"train_batch_size": 4, "seed": 11,
           "dataloader": {"prefetch_depth": 1},
           "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}
    engine, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=model, config=cfg, training_data={"input_ids": toks},
        device="cpu")
    assert isinstance(loader, dl.DataLoader)
    assert engine._dataloader is loader
    assert (loader.seed, loader.prefetch_depth, loader.batch_size) == \
        (11, 1, 4)
    ref = jax_dl.DataLoader({"input_ids": toks}, 4, _topo(), seed=11)
    for batch, want in zip(loader, ref):
        assert batch["input_ids"].device == engine.device
        assert _equal(_np(batch), _np(want))
        m = engine.train_batch(batch)
        assert torch.isfinite(m["loss"])
    assert engine.global_steps == 3
    assert not producers()
    if not torch.cuda.is_available():     # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dl.DataLoader(toks, 4)
