"""The trainer's step telemetry and its modules against the JAX package's,
on the CPU.

* ``utils/timer.py``: the named timers and the throughput timer's
  windows and report boundary, step for step as JAX's; the fence is a
  no-op on CPU tensors.
* ``utils/memory.py``: no allocator statistics without a card (JAX's CPU
  devices report none either), the host's resident set.
* ``profiling/flops_profiler.py``: ``count_params`` as JAX's,
  ``flops_of`` a matrix product as JAX's cost analysis counts it, the
  flash op's formula (4d a visible pair forward, 14d backward), a Llama
  forward counted as its products and attention, no peak (MFU 0) on a
  device that is not an H100.
* ``monitor/monitor.py``: the CSV monitor's cached handles and rows,
  ``MonitorMaster.close`` idempotent, the monitor as a telemetry sink,
  a missing W&B warned about and its events dropped (JAX's
  ``tests/test_observability.py`` cases).
* The engine's StepStats records (``tests/test_observability.py:304-
  400``): every record of a 3-step run passes ``validate_step_record``
  and has JAX's keys, the compat path's phase times, a ``train_steps``
  block as one record of ``n_steps`` k, the MFU numerator counted by
  ``FlopCounterMode``, the CSV monitor's rows, and with telemetry and
  monitors off the engine keeps no sink and reads nothing back from the
  card a step.
* On the card (``gpu``): a record's memory and MFU.

Enabling telemetry turns the process-wide comms logger on (as the JAX
engine does); the fixture here restores it, the process-wide telemetry
and the metrics registry (each test gets a fresh one) after each test.
"""

import json
import os

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as tdst
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.config import MonitorConfig
from deepspeed_tpu_torch.models.llama import Llama
from deepspeed_tpu_torch.monitor.monitor import (CsvMonitor, MonitorMaster,
                                                 WandbMonitor)
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.profiling import flops_profiler as fp
from deepspeed_tpu_torch.telemetry import (MetricsRegistry, StepStats,
                                           Telemetry, get_registry,
                                           get_telemetry, set_registry,
                                           set_telemetry,
                                           validate_step_record)
from deepspeed_tpu_torch.utils import memory, timer

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, vocab_size=128,
            max_seq_len=64, remat=True, use_flash=True)


@pytest.fixture(autouse=True)
def restore_globals():
    log = comm.get_comms_logger()
    saved = (log.enabled, log.verbose, get_registry())
    set_registry(MetricsRegistry())
    yield
    comm.configure_comms_logger(*saved[:2])
    set_registry(saved[2])
    set_telemetry(None)


def _cfg(tmp_path=None, **extra):
    cfg = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
           "steps_per_print": 1000,
           "optimizer": {"type": "adamw", "params": {"lr": 1e-2}}}
    if tmp_path is not None:
        out = str(tmp_path / "tel")
        cfg["telemetry"] = {"enabled": True, "output_dir": out,
                            "prometheus_path": os.path.join(
                                out, "metrics.prom"), "export_every": 1}
    cfg.update(extra)
    return cfg


def _engine(cfg):
    return tdst.initialize(model=Llama("tiny", device="cpu", seed=2, **TINY),
                           config=cfg, device="cpu")[0]


def _batch(seed=0, rows=4):
    return {"input_ids": torch.from_numpy(np.random.default_rng(seed)
                                          .integers(0, 128, (rows, 16)))}


def _records(tmp_path):
    path = tmp_path / "tel" / "steps.jsonl"
    return [json.loads(ln) for ln in path.read_text().splitlines()]


# ------------------------------------------------------------------ units
def test_timers_follow_jax(monkeypatch):
    from deepspeed_tpu.utils import timer as jtimer

    fences = []
    monkeypatch.setattr(jtimer, "_fence", fences.append)
    ours = timer.ThroughputTimer(batch_size=8, steps_per_output=3)
    theirs = jtimer.ThroughputTimer(batch_size=8, steps_per_output=3)
    for _ in range(7):
        assert ours.will_report_next() == theirs.will_report_next()
        for t in (ours, theirs):
            t.start()
            t.stop(sync_obj=torch.zeros(()) if t is ours else None)
        assert ours.step_count == theirs.step_count
        assert ours.total_samples == theirs.total_samples
        assert (ours._window_steps, ours._start) == (
            theirs._window_steps, theirs._start)
    assert ours.avg_samples_per_sec() > 0
    named = timer.SynchronizedWallClockTimer()
    named("a").start()
    assert named("a").stop(sync_obj=torch.ones(2)) >= 0
    assert named("a").count == 1 and "a:" in named.log()
    assert named("a").count == 0               # log(reset=True)


def test_memory_stats_without_a_card():
    from deepspeed_tpu.utils import memory as jmemory

    assert memory.device_memory_stats("cpu") == {}
    assert memory.device_memory_stats() == jmemory.device_memory_stats() \
        == {}
    assert memory.host_rss_gb() > 0
    assert set(memory.see_memory_usage("t")) == {"host_rss_gb"}


def test_flops_profiler_counts():
    import jax.numpy as jnp

    from deepspeed_tpu.profiling import flops_profiler as jfp

    tree = {"a": np.zeros((3, 4)), "b": {"c": np.zeros(5)}}
    assert fp.count_params({"a": torch.zeros(3, 4), "c": torch.zeros(5)}) \
        == jfp.count_params(tree) == 17
    a, b = np.ones((16, 32), np.float32), np.ones((32, 8), np.float32)
    assert fp.flops_of(torch.matmul, torch.from_numpy(a),
                       torch.from_numpy(b)) \
        == jfp.flops_of(jnp.matmul, a, b) == 2 * 16 * 32 * 8
    q = torch.randn(2, 16, 4, 16, requires_grad=True)
    k = torch.randn(2, 16, 2, 16, requires_grad=True)
    pairs = fa.visible_pairs(2, 16, 16, 4, True, 0)
    assert pairs == 2 * 4 * 16 * 17 // 2
    assert fp.flops_of(lambda: fa.flash_attention_op(
        q, k, k, True, None, 0)[0].sum().backward()) == 18 * 16 * pairs
    # a Llama forward: its products and its attention
    c = Llama("tiny", device="cpu", seed=1, **TINY).config
    b_, s = 2, 16
    d, kvd, f = c.d_model, c.n_kv_heads * c.head_dim, c.d_ff
    mm = b_ * s * 2 * c.n_layers * (2 * d * d + 2 * d * kvd + 3 * d * f) \
        + b_ * s * 2 * d * c.vocab_size
    attn = 4 * c.head_dim * fa.visible_pairs(b_, s, s, c.n_heads, True, 0) \
        * c.n_layers
    model = Llama("tiny", device="cpu", seed=1, **TINY)
    prof = fp.get_model_profile(model, {"input_ids": _batch(rows=2)[
        "input_ids"]}, iters=1, warmup=1)
    assert prof.flops == mm + attn
    assert prof.mfu == 0.0 and fp._peak_flops_per_device() == 0.0
    assert prof.params == fp.count_params(model)


def test_monitors_follow_jax(tmp_path, monkeypatch):
    mon = CsvMonitor(str(tmp_path), "job")
    mon.write_events([("Train/loss", 1.0, 1), ("Train/loss", 0.5, 2)])
    mon.write_events([("Train/loss", 0.25, 3)])
    assert len(mon._files) == 1
    mon.close()
    assert mon._files == {}
    lines = (tmp_path / "job" / "Train_loss.csv").read_text().splitlines()
    assert lines[0].startswith("step") and len(lines) == 4
    cfg = MonitorConfig(csv_enabled=True, csv_output_path=str(tmp_path),
                        csv_job_name="m")
    m = MonitorMaster(cfg)
    t = Telemetry(config=None, monitor=m)
    assert t.wants_step_records
    t.record_step(StepStats(step=1, wall_time_s=0.1, loss=2.0))
    t.close()
    t.close()
    assert m.writers == []
    rows = (tmp_path / "m" / "Train_loss.csv").read_text().splitlines()
    assert rows[1].split(",") == ["1", "2.0"]
    warned = []
    from deepspeed_tpu_torch.monitor import monitor as monitor_mod

    monkeypatch.setattr(monitor_mod.logger, "warning", warned.append)
    w = WandbMonitor("p", None, None)        # no wandb here: dropped
    w.write_events([("Train/loss", 1.0, 1)])
    w.close()
    assert w.run is None and any("wandb" in x for x in warned)


# ----------------------------------------------------------------- engine
def test_step_records_schema_and_monitor(tmp_path):
    from deepspeed_tpu.telemetry.spans import StepStats as JStepStats

    cfg = _cfg(tmp_path, csv_monitor={"enabled": True,
                                      "output_path": str(tmp_path),
                                      "job_name": "job"})
    eng = _engine(cfg)
    assert get_telemetry() is eng.telemetry
    assert comm.get_comms_logger().enabled
    for i in range(3):
        eng.train_batch(_batch(i))
    eng.close()
    recs = _records(tmp_path)
    assert len(recs) == 3
    keys = set(JStepStats(step=0, wall_time_s=0.0).to_record())
    for i, rec in enumerate(recs):
        assert validate_step_record(rec) == [], validate_step_record(rec)
        assert set(rec) == keys
        assert rec["step"] == i + 1 and rec["n_steps"] == 1
        assert rec["wall_time_s"] > 0 and rec["tokens_per_s"] > 0
        assert rec["loss"] is not None and rec["grad_norm"] is not None
        assert rec["memory"]["host_rss_gb"] > 0
    prom = (tmp_path / "tel" / "metrics.prom").read_text()
    assert "dst_train_steps 3.0" in prom
    rows = (tmp_path / "job" / "Train_loss.csv").read_text().splitlines()
    assert len(rows) == 4
    assert get_telemetry().enabled is False     # close() released it


def test_mfu_numerator_counts_the_step(tmp_path):
    from torch.utils.flop_counter import FlopCounterMode

    eng = _engine(_cfg(tmp_path))
    b = _batch(0)
    eng.train_batch(b)
    ref = _engine(_cfg())
    counter = FlopCounterMode(display=False)
    with counter:
        ref.train_batch(b)
    assert eng._step_flops == counter.get_total_flops() > 0
    eng.train_batch(b)
    eng.close()
    assert [r["mfu"] for r in _records(tmp_path)] == [0.0, 0.0]  # no H100


def test_compat_phase_times_and_train_steps_block(tmp_path):
    eng = _engine(_cfg(tmp_path))
    for i in range(2):
        eng.backward({"input_ids": _batch(i, rows=2)["input_ids"]})
        eng.step()
    eng.train_steps([_batch(5), _batch(6), _batch(7)])
    eng.close()
    recs = _records(tmp_path)
    assert [r["n_steps"] for r in recs] == [1, 3]
    assert all(validate_step_record(r) == [] for r in recs)
    assert recs[0]["backward_s"] > 0 and recs[0]["optimizer_s"] > 0
    assert recs[0]["forward_s"] is None
    assert recs[1]["step"] == 4 and recs[1]["tokens_per_s"] > 0


def test_telemetry_off_keeps_the_engine_lean(monkeypatch):
    fences = []
    monkeypatch.setattr(timer, "_fence", fences.append)
    eng = _engine(_cfg())
    assert eng.telemetry.wants_step_records is False
    assert eng.telemetry.sinks == [] and eng.monitor is None
    for i in range(3):
        eng.train_batch(_batch(i))
    eng.train_steps([_batch(3), _batch(4)])
    assert fences == [] and eng._step_flops is None
    eng.close()


def test_report_boundary_reads_once(monkeypatch):
    fences = []
    monkeypatch.setattr(timer, "_fence", fences.append)
    eng = _engine(_cfg(steps_per_print=2, memory_breakdown=True,
                       wall_clock_breakdown=False))
    for i in range(4):
        eng.train_batch(_batch(i))
    assert len(fences) == 2                  # steps 2 and 4 only


@pytest.mark.gpu
def test_cuda_step_record_memory_and_mfu(tmp_path):
    """A 2-layer Llama at head dim 64 in bf16 with telemetry on: each
    record valid, with the card's allocator statistics, and an MFU above
    0 on an H100."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    cfg = _cfg(tmp_path, bf16={"enabled": True})
    eng = tdst.initialize(model=Llama("tiny", seed=2, **{
        **TINY, "d_model": 256, "vocab_size": 512, "max_seq_len": 256}),
        config=cfg)[0]
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 512, (4, 256))).cuda()
    for _ in range(2):
        eng.train_batch({"input_ids": toks})
    eng.close()
    recs = _records(tmp_path)
    assert all(validate_step_record(r) == [] for r in recs)
    assert recs[-1]["memory"]["hbm_peak_gb"] > 0
    if "H100" in torch.cuda.get_device_name():
        assert recs[-1]["mfu"] > 0
