"""The region: the port's SLO plane, ``region`` / ``rollout`` config blocks,
``ServingCell``, ``RolloutController`` and ``Region`` held to the JAX
package's on the CPU.

Unit parity: one script runs against each package's module and the two
records must be equal (SLO windows, burn-rate alert transitions, digest
algebra, config values and ``ConfigError`` messages, typed partition
errors, cell digests).

Region scenarios: both packages build a ``Region`` over their own
``SimEngine`` (the deterministic simulator's host-only engine) or over a
tiny fp32 Llama (2 layers, d 64, the same weights on both sides),
``start=False`` with manual ``step()``, each under its own ``SimClock``
advanced by the same schedule, its own telemetry (request records, tracing
on), both comms loggers pinned on, its own ``FaultInjector``, and request
uids counted from 1. The observations must be equal: streams, states,
errors, served versions, the registry (wall-timed engine histograms by
count only), the request records minus ``uid`` / ``client_request_id``,
the trace trees, the flight recorder's dumps and whatever the scenario
reads (placements, cell states, version logs, alert logs).

Last, the port's region with its driver and monitor threads runs under
``use_locksan`` with zero violations, and ``Region(device=None)`` asks for
the card.
Tolerance: none — every comparison is exact equality.
"""

import contextlib
import dataclasses
import itertools
import json
import threading
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu.comm.comm as jcomm
import deepspeed_tpu.config as jconfig
import deepspeed_tpu.resilience.chaos as jchaos
import deepspeed_tpu.resilience.clock as jclock
import deepspeed_tpu.resilience.dst as jdst
import deepspeed_tpu.serving as jserving
import deepspeed_tpu.serving.cell as jcell
import deepspeed_tpu.serving.request as jrequest
import deepspeed_tpu.telemetry as jtel
import deepspeed_tpu.telemetry.slo as jslo
import deepspeed_tpu.telemetry.tracing as jtracing
import deepspeed_tpu_torch.comm.comm as tcomm
import deepspeed_tpu_torch.config as tconfig
import deepspeed_tpu_torch.resilience.chaos as tchaos
import deepspeed_tpu_torch.resilience.clock as tclock
import deepspeed_tpu_torch.resilience.dst as tdst
import deepspeed_tpu_torch.resilience.locksan as tlocksan
import deepspeed_tpu_torch.serving as tserving
import deepspeed_tpu_torch.serving.cell as tcell
import deepspeed_tpu_torch.serving.request as trequest
import deepspeed_tpu_torch.telemetry as ttel
import deepspeed_tpu_torch.telemetry.slo as tslo
import deepspeed_tpu_torch.telemetry.tracing as ttracing
from deepspeed_tpu.inference.ragged import (
    RaggedConfig as JaxRaggedConfig,
    RaggedInferenceEngine as JaxRaggedEngine)
from deepspeed_tpu.models import Llama as JaxLlama
from deepspeed_tpu_torch.checkpoint.jax_params import load_jax_params
from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                  RaggedInferenceEngine)
from deepspeed_tpu_torch.models.llama import Llama

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, vocab_size=128,
            max_seq_len=256)
LLAMA_CFG = dict(token_budget=32, max_seqs=4, kv_block_size=8,
                 n_kv_blocks=64, max_context=128, enable_prefix_cache=True)
# wall-timed engine histograms (time.perf_counter in both packages)
WALL_TIMED = ("inference/ttft_s", "inference/request_latency_s",
              "inference/decode_tokens_per_s")
FAST_ROLLOUT = {"canary_fraction": 0.5, "canary_observe_ticks": 3,
                "slo_regression_threshold": 0.2, "min_canary_samples": 2,
                "warmup_ticks": 1, "swap_retry_limit": 2,
                "max_flip_attempts": 4}

J = types.SimpleNamespace(slo=jslo, tel=jtel, config=jconfig, cell=jcell,
                          chaos=jchaos)
T = types.SimpleNamespace(slo=tslo, tel=ttel, config=tconfig, cell=tcell,
                          chaos=tchaos)


def _both(script):
    """``script(mods)`` on both packages' modules; the records must be
    equal. Returns the port's."""
    out = {name: script(mods) for name, mods in (("jax", J), ("torch", T))}
    assert out["torch"] == out["jax"]
    return out["torch"]


def _raises(fn, exc_name):
    """The message of the named exception ``fn()`` raises (None if none)."""
    try:
        fn()
    except Exception as e:     # both packages' own classes, by name
        assert type(e).__name__ == exc_name, repr(e)
        return str(e)
    return None


@pytest.fixture(autouse=True)
def _clean_slate():
    for m in (jchaos, tchaos):
        m.install_fault_injector(None)
    yield
    for m in (jchaos, tchaos):
        m.install_fault_injector(None)


# --------------------------------------------------------------- SLO plane
def _feed(tr, t, tenant, ok, judged):
    tr.record(t, {tenant: [ok, judged]}, {}, ok=ok, judged=judged)


def test_slo_objective_validation_and_burn_math():
    def script(m):
        obj = m.slo.SLOObjective(target=0.95)
        rec = [obj.error_budget, obj.burn_rate(0.95), obj.burn_rate(0.0),
               obj.burn_rate(1.0), dataclasses.asdict(m.slo.SLOObjective())]
        for kw in ({"target": 1.0}, {"target": 0.0}, {"fast_window_s": 0.0},
                   {"fast_burn_threshold": -1.0}, {"clear_ratio": 0.0},
                   {"min_samples": 0}):
            rec.append(_raises(lambda kw=kw: m.slo.SLOObjective(**kw),
                               "ValueError"))
        return rec

    rec = _both(script)
    assert all(isinstance(x, str) for x in rec[5:])


def test_slo_windows_and_version_attainment():
    def script(m):
        tr = m.slo.TenantSLOTracker(m.slo.SLOObjective(
            target=0.9, window_s=10.0, slow_window_s=10.0))
        rec = [tr.attainment(0.0)]
        _feed(tr, 1.0, "a", 4, 4)
        _feed(tr, 2.0, "a", 0, 4)
        rec += [tr.attainment(2.0), tr.tenant_attainment("a", 2.0),
                tr.attainment(11.5), tr.tenant_attainment("ghost", 2.0),
                tr.version_attainment(7, 2.0), tr.tenants()]
        tv = m.slo.TenantSLOTracker(m.slo.SLOObjective(target=0.9,
                                                       window_s=100.0))
        tv.record(1.0, {}, {1: [5, 5], 2: [1, 4]}, ok=6, judged=9)
        rec += [tv.version_attainment(1, 1.0), tv.version_attainment(2, 1.0)]
        return rec

    rec = _both(script)
    assert rec[1] == 0.5 and rec[2] == (8, 0.5) and rec[-1] == (4, 0.25)


def test_slo_burn_alerts_fire_clear_and_auto_clear():
    def script(m):
        obj = m.slo.SLOObjective(target=0.5, window_s=20.0,
                                 fast_window_s=10.0, slow_window_s=20.0,
                                 fast_burn_threshold=1.5,
                                 slow_burn_threshold=1.2, clear_ratio=0.5,
                                 min_samples=4)
        tr = m.slo.TenantSLOTracker(obj)
        _feed(tr, 1.0, "a", 0, 3)
        rec = [tr.check_alerts(1.0)]
        _feed(tr, 2.0, "a", 0, 5)
        rec += [tr.check_alerts(2.0), tr.has_fast_burn(),
                tr.active_alerts(), tr.check_alerts(3.0)]
        _feed(tr, 4.0, "a", 40, 40)
        rec += [tr.check_alerts(4.0), tr.has_fast_burn()]
        # a quiet tenant's alert ages out of its window
        _feed(tr, 5.0, "b", 0, 8)
        rec.append(tr.check_alerts(5.0))
        tr.record(40.0, {}, {}, ok=0, judged=0)
        rec += [tr.check_alerts(40.0), tr.has_fast_burn(),
                list(tr.alert_log)]
        return rec

    rec = _both(script)
    assert [(f["window"], f["state"]) for f in rec[1]] == \
        [("fast", "firing"), ("slow", "firing")]
    assert [f["state"] for f in rec[5]] == ["clear", "clear"]
    assert [(f["tenant"], f["state"]) for f in rec[8]] == \
        [("b", "clear"), ("b", "clear")] and rec[9] is False


def test_slo_alert_stream_and_digest_algebra():
    def script(m):
        obj = m.slo.SLOObjective(target=0.8, window_s=30.0,
                                 fast_window_s=15.0, slow_window_s=30.0,
                                 fast_burn_threshold=2.0,
                                 slow_burn_threshold=1.5, min_samples=2)
        tr = m.slo.TenantSLOTracker(obj)
        for i in range(40):
            _feed(tr, float(i), f"tenant-{i % 3}", 0 if (i // 10) % 2 else 1,
                  1)
            tr.check_alerts(float(i))
        rec = [json.dumps(list(tr.alert_log), sort_keys=True)]
        src = m.tel.DigestSource("r", alpha=0.01)
        acc = m.tel.DigestAccumulator(alpha=0.01)
        for i in range(50):
            src.count("requests")
            src.observe("ttft_s", 0.01 * (i + 1))
            src.slo_verdict("t", 1, i % 3 != 0)
            if i % 7 == 0:
                acc.absorb(src.publish(float(i)))
        acc.absorb(src.publish(99.0))
        rec += [acc.snapshot(), acc.tenant_totals(), acc.version_totals(),
                acc.percentile("ttft_s", 50), acc.percentile("ttft_s", 99),
                src.publish(100.0).is_empty()]
        return rec

    rec = _both(script)
    assert rec[2] == {"t": (33, 50)}


# ------------------------------------------------------------------- config
REGION_OK = [{}, {"cells": 3, "cell_spill_load": 6},
             {"brownout_queue_per_replica": 2.0, "brownout_exit_ratio": 0.0,
              "rebalance_threshold": 0.0, "slo_target": 0.5,
              "telemetry_rollup_every": 3, "unknown_key": 1}]
REGION_BAD = [{"cells": 0}, {"cell_ring_vnodes": 0},
              {"brownout_queue_per_replica": 0.0},
              {"brownout_exit_ratio": 1.5}, {"rebalance_threshold": -1.0},
              {"telemetry_rollup_every": 0}]
ROLLOUT_OK = [{}, FAST_ROLLOUT, {"canary_fraction": 1.0, "warmup_ticks": 0,
                                 "swap_retry_limit": 0, "extra": True}]
ROLLOUT_BAD = [{"canary_fraction": 0.0}, {"canary_fraction": 1.5},
               {"canary_observe_ticks": 0},
               {"slo_regression_threshold": 1.5},
               {"min_canary_samples": 0}, {"warmup_ticks": -1},
               {"swap_retry_limit": -1}, {"max_flip_attempts": 0}]


def test_region_and_rollout_config_values_and_messages():
    def script(m):
        c = m.config
        rec = [dataclasses.asdict(c.RegionConfig.from_dict(d))
               for d in REGION_OK]
        rec += [dataclasses.asdict(c.RolloutConfig.from_dict(d))
                for d in ROLLOUT_OK]
        rec += [_raises(lambda d=d: c.RegionConfig.from_dict(d),
                        "ConfigError") for d in REGION_BAD]
        rec += [_raises(lambda d=d: c.RolloutConfig.from_dict(d),
                        "ConfigError") for d in ROLLOUT_BAD]
        sc = c.ServingConfig.from_dict({"region": {"cells": 4},
                                        "rollout": {"warmup_ticks": 5}})
        rec += [dataclasses.asdict(sc.region), dataclasses.asdict(sc.rollout),
                dataclasses.asdict(c.ServingConfig().region),
                dataclasses.asdict(c.ServingConfig().rollout)]
        return rec

    rec = _both(script)
    bad = rec[len(REGION_OK) + len(ROLLOUT_OK):-4]
    assert len(bad) == len(REGION_BAD) + len(ROLLOUT_BAD)
    assert all(isinstance(x, str) for x in bad)
    assert rec[-4]["cells"] == 4 and rec[-3]["warmup_ticks"] == 5
    assert not hasattr(tconfig, "DEFAULT_WARMUP_TICKS")


# --------------------------------------------------------------------- cell
def test_cell_unreachable_is_typed_and_digest_math():
    def script(m):
        inj = m.chaos.install_fault_injector(m.chaos.FaultInjector())
        try:
            inj.sever({"cell-0"}, {"cell-1"})
            rec = [m.chaos.is_reachable("cell-0", "cell-1"),
                   m.chaos.is_reachable("cell-0", "cell-2")]
            try:
                m.cell.check_reachable("cell-0", "cell-1", op="kv_adoption")
            except m.cell.CellUnreachable as e:
                rec.append((str(e), e.src, e.dst, e.op,
                            isinstance(e, RuntimeError)))
            inj.heal_partitions()
            rec.append(m.cell.check_reachable("cell-0", "cell-1"))
        finally:
            m.chaos.install_fault_injector(None)
        d = m.cell.CellDigest(t=1.0, queue_depth=6, live=2, pending_work=3,
                              healthy_replicas=4, kv_demand=0.5, in_sla=None,
                              accepting=True)
        empty = dataclasses.replace(d, healthy_replicas=0)
        rec += [d.load_per_replica, empty.load_per_replica,
                dataclasses.asdict(d), m.cell.CellState.UP,
                m.cell.CellState.DEAD]
        return rec

    rec = _both(script)
    assert rec[:2] == [False, True] and rec[2][3] == "kv_adoption"


# --------------------------------------------------------- region scenarios
@pytest.fixture(scope="module")
def weights():
    jm = JaxLlama("tiny", use_flash=False, remat=False, **TINY)
    return jm, [jax.tree_util.tree_map(np.asarray,
                                       jm.init(jax.random.PRNGKey(s)))
                for s in (5, 6)]


@contextlib.contextmanager
def comms_loggers_on():
    """Both packages' comms loggers enabled and reset for the block; each
    logger's previous ``enabled`` / ``verbose`` restored after it."""
    saved = [(m, m.get_comms_logger().enabled, m.get_comms_logger().verbose)
             for m in (jcomm, tcomm)]
    for m, _, _ in saved:
        m.configure_comms_logger(True)
        m.get_comms_logger().reset()
    try:
        yield
    finally:
        for m, enabled, verbose in saved:
            m.configure_comms_logger(enabled, verbose)


class Side:
    """One package's region stack behind one interface."""

    def __init__(self, name, weights=None):
        self.name = name
        jx = name == "jax"
        self.weights = weights
        self.chaos = jchaos if jx else tchaos
        self.clock = jclock if jx else tclock
        self.tel = jtel if jx else ttel
        self.tracing = jtracing if jx else ttracing
        self.config = jconfig if jx else tconfig
        self.dst = jdst if jx else tdst
        self.serving = jserving if jx else tserving
        self.request = jrequest if jx else trequest

    def engine(self, **kw):
        """A tiny fp32 Llama ragged engine (the same weights both sides)."""
        jm, params = self.weights
        cfg = {**LLAMA_CFG, **kw}
        if self.name == "jax":
            return JaxRaggedEngine(jm, JaxRaggedConfig(
                dtype=jnp.float32, **cfg), params=params[0])
        model = load_jax_params(Llama("tiny", device="cpu", **TINY),
                                params[0])
        return RaggedInferenceEngine(model, RaggedConfig(
            dtype=torch.float32, **cfg), device="cpu")

    def region(self, cells=2, replicas=1, *, region_cfg=None, fleet_cfg=None,
               serving_cfg=None, engine_cfg=None, llama=False,
               router="prefix_affinity"):
        rc = {"cells": cells, "cell_ring_vnodes": 16, **(region_cfg or {})}
        fc = {"replicas": replicas, "router": router, "respawn": False,
              **(fleet_cfg or {})}
        sc = {"policy": "slo", "stuck_tick_timeout_s": 0.0,
              "drain_timeout_s": 600.0, "poll_interval_s": 0.25,
              **(serving_cfg or {})}
        if llama:
            factory = self.engine
        else:
            sim = self.dst.SimConfig(**(engine_cfg or {}))
            factory = (lambda: self.dst.SimEngine(sim))
        kw = {} if self.name == "jax" else {"device": "cpu"}
        return self.serving.Region(factory, rc, fc, sc, start=False,
                                   clock=self.sim, **kw)

    @contextlib.contextmanager
    def instrumented(self, tmp_path):
        """SimClock, telemetry (records + tracing), both comms loggers on,
        a fresh fault injector and request uids from 1 for the block;
        cleared after it."""
        out = tmp_path / self.name
        out.mkdir(parents=True, exist_ok=True)
        self.records_path = out / "requests.jsonl"
        self.sim = self.clock.SimClock()
        cfg = self.config.TelemetryConfig(
            enabled=True, output_dir=str(out), jsonl_path="",
            requests_jsonl_path=str(self.records_path),
            stall_detection=False, tracing=True, flight_capacity=256)
        self.request._uid_counter = itertools.count(1)
        with self.clock.use_clock(self.sim), comms_loggers_on():
            t = self.tel.set_telemetry(self.tel.Telemetry(
                cfg, registry=self.tel.MetricsRegistry()))
            self.telemetry = t
            self.tracer = self.tracing.get_tracer()
            self.injector = self.chaos.install_fault_injector(
                self.chaos.FaultInjector(seed=0))
            try:
                yield self
            finally:
                t.close()
                self.tel.set_telemetry(None)
                self.tracing.set_tracer(None)
                self.chaos.install_fault_injector(None)

    def drive(self, region, reqs, max_ticks=400):
        for _ in range(max_ticks):
            if all(r.is_terminal for r in reqs):
                return
            region.step()
            self.sim.advance(1.0)
        raise AssertionError(
            f"requests not terminal after {max_ticks} ticks: "
            f"{[r.state.name for r in reqs if not r.is_terminal]}")

    def drive_until(self, region, pred, max_ticks=600):
        for _ in range(max_ticks):
            if pred():
                return
            region.step()
            self.sim.advance(1.0)
        raise AssertionError(f"condition not reached in {max_ticks} ticks "
                             f"(phase {region.rollout.phase})")

    def close(self, region):
        self.sim.pump = region.step
        region.close(timeout=30.0)
        self.sim.pump = None

    def observe(self, reqs, **extra):
        """Everything the two packages must agree on."""
        snap = {}
        for k, v in self.telemetry.registry.snapshot().items():
            snap[k] = {"count": v["count"]} if k in WALL_TIMED else v
        records = []
        if self.records_path.exists():
            for line in self.records_path.read_text().splitlines():
                r = json.loads(line)
                r.pop("uid")
                r.pop("client_request_id")
                records.append(r)
        dump = self.tracer.flight.last_dump
        return {"streams": [list(r.tokens) for r in reqs],
                "states": [r.state.value for r in reqs],
                "errors": [r.error for r in reqs],
                "versions": [list(r.served_versions) for r in reqs],
                "registry": snap, "records": records,
                "trace": self.tracer.canonical_rows(),
                "flight": None if dump is None else
                (dump["reason"], [r.get("kind") for r in dump["records"]]),
                **extra}


def _run(tmp_path, scenario, weights=None):
    """``scenario(side)`` on both packages; their observations must be
    equal. Returns the port's."""
    obs = {}
    for name in ("jax", "torch"):
        side = Side(name, weights)
        with side.instrumented(tmp_path):
            obs[name] = scenario(side)
    for key in obs["jax"]:
        assert obs["torch"][key] == obs["jax"][key], key
    return obs["torch"]


def _owner(region, req):
    return region._requests.get(req.uid, (None, None))[1]


def _finish(side, region, reqs, **extra):
    """Drive to the end, audit leaks, close and observe; a callable in
    ``extra`` is read after the drive."""
    side.drive(region, reqs)
    extra = {k: v() if callable(v) else v for k, v in extra.items()}
    leaks = region.block_leaks()
    side.close(region)
    return side.observe(reqs, leaks=leaks, **extra)


def test_digest_published_on_poll_and_route_work_flat(tmp_path):
    """The route path reads published digests only (no replica scan);
    per-route work does not grow with the replica count."""
    prompts = [[i, i + 1, i + 2, 7] for i in range(1, 9)]

    def scenario(side):
        region = side.region(cells=2, replicas=2)
        d = region.cells[0].digest
        first = dataclasses.asdict(d)
        fleet_cls = type(region.cells[0].fleet)
        calls = []
        orig = fleet_cls.digest_fields

        def counting(self):
            calls.append(self.name)
            return orig(self)

        fleet_cls.digest_fields = counting
        try:
            req = region.submit([1, 2, 3], max_new_tokens=1)
            on_route = list(calls)
            region.poll()
            on_poll = list(calls)
        finally:
            fleet_cls.digest_fields = orig
        works = {}
        for replicas in (1, 4):
            r2 = side.region(cells=3, replicas=replicas)
            reqs = []
            works[replicas] = []
            for p in prompts:
                reqs.append(r2.submit(list(p), max_new_tokens=1))
                works[replicas].append(r2.route_work_last)
            side.drive(r2, reqs)
            side.close(r2)
        return _finish(side, region, [req], first=first, on_route=on_route,
                       on_poll=on_poll, works=works)

    obs = _run(tmp_path, scenario)
    assert obs["first"]["healthy_replicas"] == 2
    assert obs["on_route"] == [] and len(obs["on_poll"]) == 2
    assert obs["works"][1] == obs["works"][4]


def test_same_prefix_routes_to_one_cell(tmp_path):
    def scenario(side):
        region = side.region(cells=3, replicas=1)
        prefix = list(range(1, 9))
        reqs = [region.submit(prefix + [40 + i], max_new_tokens=3)
                for i in range(4)]
        placed = [_owner(region, r) for r in reqs]
        return _finish(side, region, reqs, placed=placed)

    obs = _run(tmp_path, scenario)
    assert len(set(obs["placed"])) == 1 and obs["leaks"] == []


def test_cell_outage_loses_nothing_and_streams_stay_exact(tmp_path):
    prompts = [[9, 8, 7, i] for i in range(1, 7)]

    def scenario(side):
        ref_region = side.region()
        ref = [ref_region.submit(list(p), max_new_tokens=6)
               for p in prompts]
        side.drive(ref_region, ref)
        side.close(ref_region)
        region = side.region()
        reqs = [region.submit(list(p), max_new_tokens=6) for p in prompts]
        region.step()
        side.sim.advance(1.0)
        orphans = [reqs.index(r) for r in reqs
                   if _owner(region, r) == "cell-0"]
        killed = region.kill_cell("cell-0", reason="test outage")
        return _finish(side, region, reqs, killed=killed, orphans=orphans,
                       cells=lambda: [c.state for c in region.cells],
                       same=lambda: ([r.tokens for r in reqs]
                                     == [r.tokens for r in ref]))

    obs = _run(tmp_path, scenario)
    assert obs["killed"] and obs["orphans"] and obs["same"]
    assert obs["cells"] == ["dead", "up"] and obs["leaks"] == []
    assert obs["states"] == ["finished"] * 6
    assert obs["registry"]["serving/region/cell_failovers"] == \
        len(obs["orphans"])


def test_dead_cell_detected_through_its_digest(tmp_path):
    def scenario(side):
        region = side.region()
        reqs = [region.submit([5, 6, 7, i], max_new_tokens=4)
                for i in range(4)]
        cell = region._cells["cell-1"]
        for rep in list(cell.fleet.replicas):
            cell.fleet.kill_replica(rep.name, reason="test")
        return _finish(side, region, reqs,
                       alive=lambda: [c.alive for c in region.cells])

    obs = _run(tmp_path, scenario)
    assert obs["alive"] == [True, False]
    assert obs["states"] == ["finished"] * 4


def test_partitioned_cell_keeps_serving_admitted_work(tmp_path):
    def scenario(side):
        region = side.region()
        reqs = [region.submit([3, 1, 4, i], max_new_tokens=5)
                for i in range(1, 5)]
        owners = sorted({_owner(region, r) for r in reqs})
        side.injector.sever({region.name}, set(owners))
        region.poll()
        shed = None
        if owners == ["cell-0", "cell-1"]:
            shed = region.submit([2, 2, 2], max_new_tokens=1)
        side.drive(region, reqs)
        side.injector.heal_partitions()
        region.poll()
        extra = [] if shed is None else [shed]
        return _finish(side, region, reqs + extra, owners=owners)

    obs = _run(tmp_path, scenario)
    assert obs["states"][:4] == ["finished"] * 4
    assert obs["registry"]["serving/region/partitions_detected"] == 1
    assert obs["registry"]["serving/region/partitions_healed"] == 1


DISAGG = {"disaggregated": True, "prefill_replicas": 1, "replicas": 1}


@pytest.mark.parametrize("how", ["adopt", "severed", "isolated"])
def test_cross_cell_handoff_adoption_and_degrade(tmp_path, how):
    """Cell-0 loses its decode pool. ``adopt``: its prefilled hand-offs
    are adopted across cells. ``severed``: the inter-cell link is cut, the
    adoption raises ``CellUnreachable`` and degrades. ``isolated``: both
    links are cut, and the local prefill replica decodes them itself."""
    def scenario(side):
        region = side.region(fleet_cfg=DISAGG)
        cell0 = region._cells["cell-0"]
        decode = [r for r in cell0.fleet.replicas if r.role == "decode"]
        cell0.fleet.kill_replica(decode[0].name, reason="test")
        if how == "severed":
            side.injector.sever({"cell-0"}, {"cell-1"})
        elif how == "isolated":
            side.injector.sever({"cell-0", region.name}, {"cell-1"})
        region.poll()
        subs = [region.submit([11, 12, 13, i], max_new_tokens=4)
                for i in range(1, 6)]
        reqs = [r for r in subs if _owner(region, r) == "cell-0"]
        assert reqs, "no request routed to the degraded cell"
        obs = _finish(side, region, reqs, placed=[_owner(region, r)
                                                  for r in subs],
                      stale=lambda: [r.uid in c.fleet._requests
                                     for c in region.cells for r in reqs])
        obs["all_states"] = [r.state.value for r in subs]
        return obs

    obs = _run(tmp_path, scenario)
    reg = obs["registry"]
    assert set(obs["states"]) == {"finished"} and obs["leaks"] == []
    assert not any(obs["stale"])
    if how == "adopt":
        assert reg["serving/region/handoff_escalations"] >= 1
    elif how == "severed":
        assert reg["serving/region/partition_blocked_handoffs"] >= 1
    else:
        assert reg["serving/region/handoff_degrades"] >= 1


def test_heal_rebalances_queued_work(tmp_path):
    def scenario(side):
        region = side.region(region_cfg={"rebalance_threshold": 1.0,
                                         "brownout_queue_per_replica": 1e9})
        side.injector.sever({region.name}, {"cell-1"})
        region.poll()
        reqs = [region.submit([6, 6, 6, i], max_new_tokens=2)
                for i in range(1, 13)]
        before = [_owner(region, r) for r in reqs]
        side.injector.heal_partitions()
        region.poll()
        after = [_owner(region, r) for r in reqs]
        return _finish(side, region, reqs, before=before, after=after)

    obs = _run(tmp_path, scenario)
    assert set(obs["before"]) <= {"cell-0", None}
    assert "cell-1" in obs["after"]
    assert obs["registry"]["serving/region/rebalanced"] >= 1
    assert obs["states"] == ["finished"] * 12


def test_partition_epoch_handled_exactly_once(tmp_path):
    def scenario(side):
        region = side.region()
        rebalances = []
        region._rebalance = lambda: rebalances.append(1)
        side.injector.sever({region.name}, {"cell-1"})
        region.poll()
        active = region._partition_active
        side.injector.heal_partitions()
        threads = [threading.Thread(target=region._check_partitions)
                   for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        once = len(rebalances)
        region._check_partitions()
        return _finish(side, region, [], active=active, once=once,
                       again=len(rebalances))

    obs = _run(tmp_path, scenario)
    assert obs["active"] and obs["once"] == 1 and obs["again"] == 1


def test_brownout_ladder_sheds_by_priority_with_spans(tmp_path):
    def scenario(side):
        region = side.region(region_cfg={"brownout_queue_per_replica": 2.0,
                                         "rebalance_threshold": 0.0})
        flood = [region.submit([7, 7, 7, i], max_new_tokens=1, priority=2)
                 for i in range(1, 13)]
        region.poll()
        floor = region.brownout_floor
        entered = side.tracer.flight.last_dump["reason"]
        low = region.submit([1, 2, 3], max_new_tokens=1, priority=0)
        high = region.submit([1, 2, 4], max_new_tokens=1, priority=floor)
        log = list(region.brownout_log)
        side.drive(region, flood + [high])
        region.poll()
        return _finish(side, region, flood + [low, high], floor=floor,
                       entered=entered, log=log,
                       after=region.brownout_floor)

    obs = _run(tmp_path, scenario)
    assert obs["floor"] >= 1 and obs["after"] == 0
    assert obs["entered"] == "brownout-entered"
    assert obs["states"][-2:] == ["rejected", "finished"]
    assert "brownout" in obs["errors"][-2]
    assert all((e["priority"] < e["floor"]) == (e["kind"] == "shed")
               for e in obs["log"])
    assert [r["state"] for r in obs["records"]].count("rejected") == 1
    assert obs["flight"][0] == "brownout-exited"


def test_brownout_exits_at_zero_exit_ratio_when_drained(tmp_path):
    def scenario(side):
        region = side.region(region_cfg={"brownout_exit_ratio": 0.0})
        with region._lock:
            region._brownout_floor = 2
        region.poll()
        return _finish(side, region, [], floor=region.brownout_floor)

    assert _run(tmp_path, scenario)["floor"] == 0


def test_route_retry_budget_shared_across_tiers(tmp_path):
    def scenario(side):
        region = side.region(fleet_cfg={"route_retry_budget": 3,
                                        "route_backoff_s": 0.01})
        req = region.submit([1, 2, 3, 4], max_new_tokens=4)
        region.step()
        side.sim.advance(1.0)
        for cell in region.cells:
            for rep in cell.fleet.replicas:
                rep.serving._stop_evt.set()
        orphan_cell = region._cells[_owner(region, req)]
        orphans = orphan_cell.fleet.replicas[0].serving.evacuate()
        assert req in orphans
        orphan_cell.fleet._failover_orphans(orphans, source="test")
        remaining = req._route_budget.remaining
        tables = [req.uid in region._requests] + [
            req.uid in c.fleet._requests for c in region.cells]
        for cell in region.cells:
            for rep in cell.fleet.replicas:
                rep.serving._stop_evt.clear()
        req2 = region.submit([1, 2, 3, 4], max_new_tokens=4)
        fresh = getattr(req2, "_route_budget", None) is not req._route_budget
        return _finish(side, region, [req, req2], remaining=remaining,
                       tables=tables, fresh=fresh)

    obs = _run(tmp_path, scenario)
    assert obs["states"] == ["rejected", "finished"]
    assert "budget" in obs["errors"][0] and obs["remaining"] == 0
    assert not any(obs["tables"]) and obs["fresh"]


def test_autoscaler_lag_defers_decisions(tmp_path):
    def scenario(side):
        fleet_cls = side.serving.ServingFleet
        kw = {} if side.name == "jax" else {"device": "cpu"}
        fleet = fleet_cls(
            lambda: side.dst.SimEngine(side.dst.SimConfig()),
            {"replicas": 1, "autoscale": True, "autoscale_interval_s": 1.0,
             "respawn": False},
            {"policy": "slo", "stuck_tick_timeout_s": 0.0},
            start=False, clock=side.sim, **kw)
        decisions = []
        fleet.autoscale_once = lambda: decisions.append(side.sim.now()) or 1
        rec = []
        for lag, dt in ((None, 2.0), (10.0, 2.0), (None, 10.0)):
            if lag is not None:
                side.injector.set_autoscaler_lag(lag)
            side.sim.advance(dt)
            fleet.poll()
            rec.append(list(decisions))
        fleet.close(timeout=1.0)
        return side.observe([], rec=rec)

    obs = _run(tmp_path, scenario)
    assert [len(r) for r in obs["rec"]] == [1, 1, 2]


@pytest.mark.parametrize("event", ["cell_outage", "partition"])
def test_flight_dump_on_region_events(tmp_path, event):
    def scenario(side):
        region = side.region()
        region.submit([1, 2, 3], max_new_tokens=1)
        if event == "cell_outage":
            region.kill_cell("cell-0", reason="test")
        else:
            side.injector.sever({region.name}, {"cell-1"})
            region.poll()
        dump = side.tracer.flight.last_dump
        first = (dump["reason"], [r.get("kind") for r in dump["records"]])
        if event == "partition":
            side.injector.heal_partitions()
            region.poll()
        kinds = [r.get("kind") for r in side.tracer.flight.snapshot()]
        side.close(region)
        return side.observe([], first=first, kinds=kinds)

    obs = _run(tmp_path, scenario)
    reason, kind = {"cell_outage": ("cell-outage", "cell_outage"),
                    "partition": ("partition-detected",
                                  "partition_detected")}[event]
    assert obs["first"][0] == reason and kind in obs["first"][1]
    if event == "partition":
        assert "partition_healed" in obs["kinds"]


# -------------------------------------------------------- SLO in the region
def test_slo_rollup_in_region(tmp_path):
    """Rollup work independent of replica count, ``in_sla_ratio`` and
    tenant attainment from the plane, the merged region telemetry."""
    prompts = [[i, i + 1, 7] for i in range(1, 9)]

    def scenario(side):
        works = {}
        for replicas in (1, 4):
            region = side.region(cells=3, replicas=replicas)
            reqs = [region.submit(list(p), max_new_tokens=2,
                                  deadline_s=300.0, tenant="t0")
                    for p in prompts]
            seen = []
            for _ in range(400):
                region.step()
                seen.append(region.rollup_work_last)
                side.sim.advance(1.0)
                if all(r.is_terminal for r in reqs):
                    break
            works[replicas] = (max(seen), region.rollup_count)
            side.close(region)
        region = side.region()
        reqs = [region.submit([i, 2, 3], max_new_tokens=2, deadline_s=500.0,
                              tenant="gold") for i in range(1, 5)]
        side.drive(region, reqs)
        region.poll()
        snap = region.telemetry_snapshot()
        return _finish(side, region, reqs, works=works,
                       ratio=region.in_sla_ratio(),
                       gold=region.slo.tenant_attainment("gold",
                                                         side.sim.now()),
                       rollup_hash=region.rollup_hash, snap=snap,
                       p50=region.telemetry_percentile("ttft_s", 50))

    obs = _run(tmp_path, scenario)
    assert 0 < obs["works"][1][0] <= 60 and 0 < obs["works"][4][0] <= 60
    assert obs["ratio"] == 1.0 and obs["gold"] == (4, 1.0)
    assert obs["snap"]["slo_judged"] == 4.0 and obs["p50"] is not None
    assert len(obs["rollup_hash"]) == 64


@pytest.mark.parametrize("how", ["shed", "burn"])
def test_slo_misses_and_burn_alerts_in_region(tmp_path, how):
    def scenario(side):
        if how == "shed":
            region = side.region()
            for cell in region.cells:
                region.kill_cell(cell.name, reason="test outage")
            reqs = [region.submit([1, 2, 3], max_new_tokens=1,
                                  deadline_s=5.0, tenant="shed-tenant")]
            region.poll()
            region.poll()
            tenant = "shed-tenant"
        else:
            region = side.region(region_cfg={
                "slo_target": 0.5, "slo_window_s": 50.0,
                "slo_fast_window_s": 50.0, "slo_slow_window_s": 100.0,
                "slo_fast_burn": 1.5, "slo_slow_burn": 1.2,
                "slo_min_samples": 2})
            reqs = [region.submit([i, 2, 3], max_new_tokens=3,
                                  deadline_s=0.001, tenant="burny")
                    for i in range(1, 7)]
            side.drive(region, reqs)
            region.poll()
            tenant = "burny"
        att = region.slo.tenant_attainment(tenant, side.sim.now())
        return _finish(side, region, reqs, att=att,
                       alerts=list(region.slo_alert_log),
                       active=region.slo.active_alerts())

    obs = _run(tmp_path, scenario)
    if how == "shed":
        assert obs["att"] == (1, 0.0) and obs["states"] == ["rejected"]
    else:
        assert [(r["window"], r["state"]) for r in obs["alerts"][:2]] == \
            [("fast", "firing"), ("slow", "firing")]
        assert ("burny", "fast") in obs["active"]


# ------------------------------------------------------------------ rollout
def _replicas(region):
    return [r for c in region.live_cells for r in c.fleet.replicas]


def _rollout_region(side, cells=2, replicas=2, **kw):
    return side.region(cells=cells, replicas=replicas, router="least_loaded",
                       serving_cfg={"rollout": dict(FAST_ROLLOUT, **kw)})


def test_rollout_promotes_every_replica_with_nothing_lost(tmp_path):
    def scenario(side):
        region = _rollout_region(side)
        reqs = [region.submit([1, 2, 3 + i], max_new_tokens=6,
                              tenant=f"tenant-{i % 3}") for i in range(6)]
        started = region.start_rollout(1, fraction=0.5)
        side.drive_until(region, lambda: region.rollout.phase == "done")
        side.drive(region, reqs)
        cell = region.live_cells[0]
        cell.fleet.scale_to(3)
        return _finish(side, region, reqs, started=started,
                       log=list(region.version_log),
                       replica_versions=[r.version for r in
                                         _replicas(region)])

    obs = _run(tmp_path, scenario)
    kinds = [row["kind"] for row in obs["log"]]
    assert obs["started"] and kinds == ["start", "canary_live", "promote",
                                        "done"]
    assert set(obs["replica_versions"]) == {1}
    assert obs["states"] == ["finished"] * 6
    assert all(len(set(v)) <= 1 for v in obs["versions"])


def test_rollout_refusals_rearm_and_hot_swap_contract(tmp_path):
    def scenario(side):
        region = _rollout_region(side, cells=1, replicas=1)
        rec = [region.start_rollout(0), region.start_rollout(1),
               region.start_rollout(2)]
        side.drive_until(region, lambda: region.rollout.phase
                         in side.serving.TERMINAL_PHASES)
        rec += [region.rollout.phase, region.start_rollout(2)]
        side.drive_until(region, lambda: region.rollout.phase == "done")
        rec.append([r.version for r in _replicas(region)])
        serving = _replicas(region)[0].serving
        rec.append(_raises(lambda: serving.hot_swap(3), "RuntimeError"))
        serving.stop_admission()
        rec += [serving.hot_swap(3), serving.model_version,
                serving.warmup_remaining, serving._accepting]
        for _ in range(3):
            region.step()
            side.sim.advance(1.0)
        rec.append(serving._accepting)
        serving.stop_admission()

        def bad_load():
            raise OSError("checkpoint shard missing")

        rec += [serving.hot_swap(4, load_fn=bad_load), serving.model_version,
                serving._accepting]
        return _finish(side, region, [], rec=rec)

    rec = _run(tmp_path, scenario)["rec"]
    assert rec[:3] == [False, True, False] and rec[3] == "done"
    assert rec[5] == [2] and rec[6] is not None
    # the default warm-up is the rollout block's (warmup_ticks 1)
    assert rec[7:11] == [True, 3, 1, False] and rec[11] is True
    assert rec[12:] == [False, 3, True]


@pytest.mark.parametrize("fault", ["corrupt_swap", "flip_death",
                                   "canary_regress"])
def test_rollout_fault_paths(tmp_path, fault):
    """Corrupt swaps fall back and roll back; a death at the flip is
    re-targeted; an injected canary SLO regression rolls back. Every
    replica ends on the version the controller's terminal phase names."""
    def scenario(side):
        inj = side.injector
        if fault == "corrupt_swap":
            inj.arm_corrupt_swap(99)
            region = _rollout_region(side, cells=1, replicas=2)
        elif fault == "flip_death":
            inj.arm_flip_death(1)
            region = _rollout_region(side, cells=1, replicas=3)
        else:
            region = _rollout_region(side, canary_observe_ticks=40)
        reqs = [region.submit([1, 2, 3 + i], max_new_tokens=4,
                              deadline_s=30.0, tenant=f"tenant-{i % 4}")
                for i in range(8)]
        region.start_rollout(1, fraction=0.5)
        if fault == "canary_regress":
            inj.degrade_model_version(1)
            more = []
            for i in range(40):
                more.append(region.submit([4, 5, 6 + i], max_new_tokens=4,
                                          deadline_s=3.0,
                                          tenant=f"tenant-{i % 4}"))
                region.step()
                side.sim.advance(1.0)
            reqs += more
        side.drive_until(region, lambda: region.rollout.phase
                         in side.serving.TERMINAL_PHASES)
        side.drive(region, reqs)
        return _finish(side, region, reqs, phase=region.rollout.phase,
                       log=[row["kind"] for row in region.version_log],
                       reps=[(r.name, r.state, r.version, r.accepting)
                             for r in _replicas(region)])

    obs = _run(tmp_path, scenario)
    live = [r for r in obs["reps"] if r[1] != "dead"]
    if fault == "flip_death":
        assert obs["phase"] == "done" and "flip_death" in obs["log"]
        assert {r[2] for r in live} == {1}
        assert len(obs["reps"]) - len(live) == 1
    else:
        assert obs["phase"] == "rolled_back"
        assert {r[2] for r in live} == {0} and all(r[3] for r in live)
        assert "rollback" in obs["log"] and "rolled_back" in obs["log"]
    assert all(len(set(v)) <= 1 for v in obs["versions"])


def test_migrate_replica_under_traffic(tmp_path):
    def scenario(side):
        region = _rollout_region(side, cells=1, replicas=2)
        refused = [region.migrate_replica("cell-0", "no-such-replica"),
                   region.migrate_replica("no-such-cell", "replica-0")]
        reqs = [region.submit([1, 2, 3 + i], max_new_tokens=8)
                for i in range(4)]
        for _ in range(3):
            region.step()
            side.sim.advance(1.0)
        cell = region.live_cells[0]
        victim = cell.fleet.replicas[0].name
        moved = region.migrate_replica(cell.name, victim)
        return _finish(side, region, reqs, refused=refused, moved=moved,
                       reps=lambda: [(r.name, r.state)
                                     for r in cell.fleet.replicas])

    obs = _run(tmp_path, scenario)
    assert obs["refused"] == [False, False] and obs["moved"]
    assert obs["states"] == ["finished"] * 4
    assert obs["reps"][0][1] == "dead"
    assert sum(s == "healthy" for _, s in obs["reps"]) == 2


# ---------------------------------------------------- over a tiny fp32 Llama
def _llama_prompts(seed, n, length=10):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 128, length).tolist() for _ in range(n)]


@pytest.mark.parametrize("outage", [False, True])
def test_llama_region_routes_and_survives_a_cell_outage(weights, tmp_path,
                                                        outage):
    """Two cells of one tiny Llama replica each: shared prefixes land on
    one cell, every stream equals an uninterrupted single-engine run, and
    with ``outage`` the cell holding the most requests dies mid-decode and
    its orphans finish on the other cell by re-prefill."""
    shared = _llama_prompts(40, 2, length=16)
    prompts = [shared[i % 2] + _llama_prompts(41 + i, 1, length=3)[0]
               for i in range(4)]

    def scenario(side):
        region = side.region(llama=True)
        reqs = [region.submit(p, max_new_tokens=8) for p in prompts]
        placed = [_owner(region, r) for r in reqs]
        victims = []
        if outage:
            for _ in range(3):
                region.step()
                side.sim.advance(1.0)
            busiest = max(sorted(set(placed)), key=placed.count)
            victims = [i for i, c in enumerate(placed) if c == busiest]
            assert region.kill_cell(busiest, reason="test outage")
        obs = _finish(side, region, reqs, placed=placed, victims=victims)
        eng = side.engine(max_seqs=8)
        out = eng.generate({i: p for i, p in enumerate(prompts)},
                           max_new_tokens=8)
        obs["same"] = obs["streams"] == [list(out[i])
                                         for i in range(len(prompts))]
        return obs

    obs = _run(tmp_path, scenario, weights)
    assert obs["same"] and obs["leaks"] == []
    assert obs["states"] == ["finished"] * 4
    assert obs["placed"][0] == obs["placed"][2]
    assert obs["placed"][1] == obs["placed"][3]
    if outage:
        assert obs["victims"]
        assert obs["registry"]["serving/region/cell_failovers"] == \
            len(obs["victims"])


# ------------------------------------------------------------------ threads
def test_region_threads_under_locksan_have_no_violations():
    with tlocksan.use_locksan() as san:
        region = tserving.Region(
            lambda: tdst.SimEngine(tdst.SimConfig()),
            {"cells": 2, "cell_ring_vnodes": 8},
            {"replicas": 1, "respawn": False, "router": "prefix_affinity"},
            {"policy": "slo", "stuck_tick_timeout_s": 0.0,
             "poll_interval_s": 0.002},
            start=True, device="cpu")
        try:
            toks = list(region.stream([4, 5, 6, 7], max_new_tokens=5))
            req = region.submit([4, 5, 6, 8], max_new_tokens=8)
            result = req.result(timeout=10.0)
        finally:
            region.close(timeout=10.0)
    assert len(toks) == 5 and result == req.tokens and len(result) == 8
    assert region.block_leaks() == []
    assert region._monitor is None
    assert san.violations == []
    assert san.acquires["Region._lock"] > 0
    assert san.acquires["ServingCell._lock"] > 0
    # the same streams as the JAX package's simulated engines give
    ref = jdst.SimEngine(jdst.SimConfig())
    assert toks == _sim_stream(ref, [4, 5, 6, 7], 5)


def _sim_stream(eng, prompt, n):
    out, ctx = [], list(prompt)
    for _ in range(n):
        t = jdst._next_token(ctx, eng.config.vocab)
        out.append(t)
        ctx.append(t)
    return out


def test_region_defaults_to_the_card():
    factory = (lambda: tdst.SimEngine(tdst.SimConfig()))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserving.Region(factory, {"cells": 1}, {"replicas": 1},
                            start=False)
    region = tserving.Region(factory, {"cells": 2}, {"replicas": 1},
                             start=False, device="cpu")
    assert region.device == torch.device("cpu")
    assert all(c.fleet.device == torch.device("cpu") for c in region.cells)
    region.close(timeout=5.0)
