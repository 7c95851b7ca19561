"""The port's telemetry held to the JAX package's, on the same inputs.

Each test feeds the same numpy-seeded observations, records or span
programs through ``deepspeed_tpu.telemetry`` and
``deepspeed_tpu_torch.telemetry`` and requires identical results: the
registry's histograms and sketches (summaries, percentiles, bucket bounds,
serialized form, merges), the span records and their validators, the
Prometheus text, the JSON-lines sinks, heartbeat and stall detection, the
tracer (canonical span rows, Chrome JSON, tree checks, the flight
recorder), the digest and the v1 engine's request telemetry. Both
packages' clocks are one ``SimClock`` schedule, so timestamps agree too. Tolerance: none — every comparison is
exact equality (the modules are host Python over the same float64
arithmetic).
"""

import json

import numpy as np
import pytest

import deepspeed_tpu.resilience.clock as jclock
import deepspeed_tpu.telemetry as jt
import deepspeed_tpu.telemetry.tracing as jtr
import deepspeed_tpu_torch.resilience.clock as tclock
import deepspeed_tpu_torch.telemetry as tt
import deepspeed_tpu_torch.telemetry.tracing as ttr
from deepspeed_tpu.config import TelemetryConfig as JaxTelemetryConfig
from deepspeed_tpu_torch.config import TelemetryConfig

SEEDS = (0, 1, 2)
BOTH = ((jt, jclock, jtr), (tt, tclock, ttr))


def _values(seed, n=300):
    rng = np.random.default_rng(seed)
    v = rng.lognormal(-3.0, 1.5, n)
    v[::17] = 0.0                       # the zero bucket
    v[::23] *= -1.0                     # the negative mirror
    return [float(x) for x in v]


@pytest.mark.parametrize("seed", SEEDS)
def test_histogram_summaries_and_percentiles_match(seed):
    vals = _values(seed)
    out = []
    for mod, _, _ in BOTH:
        h = mod.Histogram("x", window=64)
        for v in vals:
            h.observe(v)
        out.append((h.summary(), h.percentiles([0.0, 10, 50, 90, 99, 100]),
                    h.mean))
    assert out[0] == out[1]


@pytest.mark.parametrize("seed", SEEDS)
def test_sketch_buckets_serialize_and_merge_match(seed):
    a_vals, b_vals = _values(seed), _values(seed + 100, 120)
    out = []
    for mod, _, _ in BOTH:
        a = mod.SketchHistogram("a", alpha=0.02)
        b = mod.SketchHistogram("b", alpha=0.02)
        for v in a_vals:
            a.observe(v)
        for v in b_vals:
            b.observe(v)
        ser = a.serialize()
        back = mod.SketchHistogram.deserialize("a2", json.loads(
            json.dumps(ser)))
        merged = a.merge(b)
        out.append((ser, a.bucket_bounds(), back.summary(),
                    merged.summary(), merged.serialize(),
                    [merged.percentile(p) for p in (1, 25, 50, 75, 99.9)]))
    assert out[0] == out[1]


def _fill_registry(mod, seed):
    r = mod.MetricsRegistry()
    rng = np.random.default_rng(seed)
    for i, v in enumerate(rng.exponential(0.05, 50)):
        r.counter(f"serving/a/ticks").inc()
        r.counter("comm/all_reduce/bytes").inc(int(v * 1e6))
        r.gauge("serving/a/kv_occupancy").set(float(i) / 50)
        r.histogram("train/step_time_s", window=32).observe(float(v))
        r.sketch("serving/ttft_s").observe(float(v))
    return r


@pytest.mark.parametrize("seed", SEEDS)
def test_registry_snapshot_and_prometheus_text_match(seed):
    regs = [_fill_registry(mod, seed) for mod, _, _ in BOTH]
    assert regs[0].snapshot() == regs[1].snapshot()
    assert (jt.render_prometheus(regs[0]) == tt.render_prometheus(regs[1]))
    with pytest.raises(TypeError):
        regs[1].gauge("serving/a/ticks")   # one kind per name


def _request_stats(mod, seed):
    rng = np.random.default_rng(seed)
    return [mod.RequestStats(
        uid=i, state=("finished", "cancelled", "rejected")[i % 3],
        client_request_id=f"req-{i}", priority=int(rng.integers(0, 3)),
        prompt_tokens=int(rng.integers(1, 90)), new_tokens=int(i),
        queue_wait_s=float(rng.random()), ttft_s=float(rng.random()),
        latency_s=float(rng.random()) if i % 3 == 0 else None,
        tokens_per_s=float(rng.random() * 100) or None,
        model_version=i % 2, in_slo=bool(i % 2) if i % 3 == 0 else None,
        trace_id=f"t{i}", span_id=f"s{i}", timestamp=1000.0 + i)
        for i in range(12)]


@pytest.mark.parametrize("seed", SEEDS)
def test_request_and_step_records_validate_alike(seed):
    recs = [[s.to_record() for s in _request_stats(mod, seed)]
            for mod, _, _ in BOTH]
    assert recs[0] == recs[1]
    bad = [dict(recs[1][0], state="exploded"),
           dict(recs[1][1], new_tokens="many"),
           {k: v for k, v in recs[1][2].items() if k != "uid"}]
    for r in recs[1] + bad:
        assert jt.validate_request_record(r) == tt.validate_request_record(r)
    assert all(not tt.validate_request_record(r) for r in recs[1])
    assert all(tt.validate_request_record(r) for r in bad)
    steps = [mod.StepStats(step=3, wall_time_s=0.5, tokens_per_s=100.0,
                           samples_per_s=2.0, mfu=0.3, loss=1.5,
                           timestamp=5.0).to_record() for mod, _, _ in BOTH]
    assert steps[0] == steps[1]
    for r in (steps[1], dict(steps[1], mfu=None), {"step": 1}):
        assert jt.validate_step_record(r) == tt.validate_step_record(r)


def test_telemetry_pipeline_writes_the_same_files(tmp_path):
    out = []
    for (mod, clk, _), cfg_cls in zip(BOTH, (JaxTelemetryConfig,
                                             TelemetryConfig)):
        d = tmp_path / mod.__name__
        cfg = cfg_cls(enabled=True, output_dir=str(d),
                      prometheus_path=str(d / "metrics.prom"),
                      export_every=1, stall_detection=False)
        with clk.use_clock(clk.SimClock()):
            t = mod.Telemetry(cfg, registry=mod.MetricsRegistry())
            for s in _request_stats(mod, 7):
                t.record_request_span(s)
            t.record_request(latency_s=0.25, ttft_s=0.125, new_tokens=9,
                             decode_tokens_per_s=40.0)
            t.close()
        out.append(((d / "requests.jsonl").read_text(),
                    t.registry.snapshot()))
    assert out[0] == out[1]
    assert len(out[1][0].splitlines()) == 12


def test_jsonl_sink_and_monitor_sink_match(tmp_path):
    recs = [{"step": i, "loss": 1.0 / (i + 1), "wall_time_s": 0.1 * i,
             "memory": {"peak": float(i)}, "arr": np.float32(0.5)}
            for i in range(5)]
    texts, events = [], []
    for mod, _, _ in BOTH:
        path = tmp_path / f"{mod.__name__}.jsonl"
        sink = mod.JsonlSink(str(path), flush_every=2)
        got = []

        class Monitor:
            def write_events(self, ev):
                got.extend(ev)

        mon = mod.MonitorSink(Monitor())
        for r in recs:
            sink.write(r)
            mon.write(r)
        sink.close()
        texts.append(path.read_text())
        events.append(got)
    assert texts[0] == texts[1] and events[0] == events[1]


@pytest.mark.parametrize("seed", SEEDS)
def test_stall_detection_and_heartbeat_match(seed, tmp_path):
    rng = np.random.default_rng(seed)
    times = rng.normal(0.1, 0.01, 60)
    times[[10, 30, 31, 45]] *= 5.0
    out = []
    for mod, clk, _ in BOTH:
        det = mod.StallDetector(window=8, factor=3.0, warmup_steps=2)
        flags = [det.observe(i, float(t)) for i, t in enumerate(times)]
        path = tmp_path / mod.__name__ / "hb.json"
        with clk.use_clock(clk.SimClock(start=123.0)):
            hb = mod.Heartbeat(str(path))
            hb.beat(7)
        out.append((flags, det.stall_count, det.rolling_median(),
                    json.loads(path.read_text())))
    assert out[0] == out[1]
    assert out[1][1] >= 3


def _span_program(mod, clk, tr_mod, seed):
    """The same span program on both tracers: roots, nested scoped spans,
    explicit segments on tracks, events, a request lifecycle and the
    flight recorder."""
    rng = np.random.default_rng(seed)
    sim = clk.SimClock()
    tracer = mod.Tracer(enabled=True, ring_size=64, flight_capacity=8)

    class Req:
        pass

    with clk.use_clock(sim), tr_mod.use_tracer(tracer):
        for i in range(3):
            root = tracer.new_trace("request", track=f"r{i}", prompt=i)
            seg = tracer.begin_span("queue", root, track=f"r{i}")
            sim.advance(float(rng.random()))
            tracer.event(root, "preempt", tokens_in=i)
            tracer.finish_span(seg, outcome="admitted")
            with tracer.span("tick", tick=i):
                sim.advance(0.01)
                with tracer.span("put"):
                    sim.advance(float(rng.random()) * 0.1)
            tracer.finish_span(root, state="finished")
            tracer.flight.note("tick", n=i)
        req = Req()
        tr_mod.ensure_request_root(req, prompt_tokens=5, priority=1)
        tr_mod.begin_request_segment(req, "queue", track="a")
        sim.advance(0.5)
        tr_mod.begin_request_segment(req, "prefill", track="a")
        tr_mod.request_event(req, "tick_fault", retry=0)
        sim.advance(0.25)
        tr_mod.finish_request_trace(req, state="finished", new_tokens=3)
        tracer.span_complete("gc", 1.0, 1.5, track="host")
    return tracer


@pytest.mark.parametrize("seed", SEEDS)
def test_tracer_trees_and_chrome_json_match(seed, tmp_path):
    tracers = [_span_program(mod, clk, tr, seed) for mod, clk, tr in BOTH]
    assert tracers[0].canonical_rows() == tracers[1].canonical_rows()
    assert tracers[0].canonical_hash() == tracers[1].canonical_hash()
    docs = [t.export_chrome_trace(str(tmp_path / f"{i}.json"))
            for i, t in enumerate(tracers)]
    assert docs[0] == docs[1]
    assert tt.validate_chrome_trace(docs[1]) == [] == \
        jt.validate_chrome_trace(docs[0])
    broken = {"traceEvents": [{"ph": "X", "name": "x"}]}
    assert tt.validate_chrome_trace(broken) == \
        jt.validate_chrome_trace(broken) != []
    for t, mod in zip(tracers, (jt, tt)):
        tids = sorted({s.trace_id for s in t.spans()})
        # 3 request roots, 3 root "tick" spans, the request, the "gc" span
        assert len(tids) == 8
        for tid in tids:
            assert mod.trace_tree_problems(t.spans_for_trace(tid)) == []
    # the whole ring has 8 roots, and dropping the roots orphans the rest
    probs = [mod.trace_tree_problems(t.spans())
             + mod.trace_tree_problems(
                 [s for s in t.spans() if s.parent_id is not None])
             for t, mod in zip(tracers, (jt, tt))]
    assert probs[0] == probs[1] and len(probs[1]) > 2
    assert [t.flight.snapshot() for t in tracers][0] == \
        tracers[1].flight.snapshot()
    dumps = []
    for i, (t, (_, clk, _)) in enumerate(zip(tracers, BOTH)):
        with clk.use_clock(clk.SimClock(start=50.0)):
            dumps.append(t.flight.dump("test",
                                       str(tmp_path / f"flight{i}.json")))
    assert json.loads((tmp_path / "flight0.json").read_text()) == \
        json.loads((tmp_path / "flight1.json").read_text())
    assert dumps[1].endswith("flight1.json")


def test_configure_tracing_installs_and_clears():
    for mod, _, tr in BOTH:
        cfg = (JaxTelemetryConfig if mod is jt else TelemetryConfig)(
            enabled=True, tracing=True, trace_ring=16, jsonl_path="",
            requests_jsonl_path="", stall_detection=False)
        try:
            t = mod.configure_tracing(cfg)
            assert tr.get_tracer() is t and t.enabled and t.ring_size == 16
        finally:
            mod.configure_tracing(None)
        assert not tr.get_tracer().enabled


@pytest.mark.parametrize("seed", SEEDS)
def test_digest_publish_and_accumulate_match(seed):
    vals = _values(seed, 80)
    out = []
    for mod, _, _ in BOTH:
        acc = mod.DigestAccumulator()
        rows = []
        for k in range(3):
            src = mod.DigestSource(f"replica{k}")
            for i, v in enumerate(vals[k::3]):
                src.count("requests")
                src.observe("ttft_s", abs(v))
                src.observe("none", None)
                src.slo_verdict(f"tenant{i % 2}", i % 3, v > 0)
            d = src.publish(float(k))
            rows.append((d.rows, d.to_dict()))
            rows.append(src.publish(9.0).is_empty())   # reset by publish
            acc.absorb(d)
        out.append((rows, acc.snapshot(), acc.tenant_totals(),
                    acc.version_totals(), acc.percentile("ttft_s", 50)))
    assert out[0] == out[1]


def test_v1_engine_request_telemetry_matches_jax(tmp_path):
    """``generate`` of the v1 engines records one request each call:
    the same counters and histogram counts on both packages (the values
    of the TTFT / latency / rate histograms are wall times of each
    package's own run, so only their counts are compared)."""
    import jax

    import deepspeed_tpu
    import deepspeed_tpu_torch
    from deepspeed_tpu.models import Llama as JaxLlama
    from deepspeed_tpu_torch.checkpoint.jax_params import load_jax_params
    from deepspeed_tpu_torch.models.llama import Llama

    tiny = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                vocab_size=128, max_seq_len=64)
    jm = JaxLlama("tiny", use_flash=False, remat=False, **tiny)
    params = jm.init(jax.random.PRNGKey(4))
    cfg = {"dtype": "float32", "temperature": 0.0}
    engines = (deepspeed_tpu.init_inference((jm, params), config=dict(cfg)),
               deepspeed_tpu_torch.init_inference(load_jax_params(
                   Llama("tiny", device="cpu", **tiny),
                   jax.tree_util.tree_map(np.asarray, params)),
                   config=dict(cfg), device="cpu"))
    ids = np.random.default_rng(2).integers(1, 128, (2, 7)).astype(np.int32)
    out = []
    for (mod, _, _), eng, cfg_cls in zip(BOTH, engines, (JaxTelemetryConfig,
                                                         TelemetryConfig)):
        t = mod.set_telemetry(mod.Telemetry(cfg_cls(
            enabled=True, output_dir=str(tmp_path), jsonl_path="",
            stall_detection=False), registry=mod.MetricsRegistry()))
        try:
            toks = [np.asarray(eng.generate(ids, max_new_tokens=n))
                    for n in (5, 1)]
        finally:
            mod.set_telemetry(None)
        snap = {k: (v["count"] if isinstance(v, dict) else v)
                for k, v in t.registry.snapshot().items()}
        out.append((snap, [x.tolist() for x in toks]))
    assert out[0] == out[1]
    assert out[1][0]["inference/requests"] == 2
    assert out[1][0]["inference/generated_tokens"] == 2 * 5 + 2 * 1
