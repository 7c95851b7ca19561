"""The replica a fleet drives: the port's ``ServingEngine`` held to the JAX
package's on the CPU.

Both servers run a tiny fp32 Llama (2 layers, d 64) from the same weights,
``start=False`` with manual ``step()``, each package under its own
``SimClock`` advanced by the same schedule, each with its own telemetry
pipeline (request records to JSON lines, tracing on) and, where a
scenario needs one, its own ``FaultInjector``. Every scenario runs the
same script on both sides and requires identical observations:

* streams, request states and errors, served model versions;
* the registry: every counter and gauge, and every sketch summary
  (``serving/...`` values come from the ``SimClock``). Excluded: the
  ragged engine's ``inference/ttft_s``, ``request_latency_s`` and
  ``decode_tokens_per_s`` histograms, which both packages time with
  ``time.perf_counter`` (wall time); only their counts are compared;
* the request records, field by field, except ``uid`` and
  ``client_request_id`` (drawn from each package's own process-global
  request counter);
* the trace trees (``Tracer.canonical_rows``: ids as first-seen
  ordinals, virtual timestamps) and the flight recorder's notes.

Scenarios: telemetry on, the stuck-tick watchdog, the preemption latch,
hot swap (success, a raising ``load_fn``, an injected corrupt load),
migrate_out -> adopt (with and without flaky imports), kill -> evacuate ->
resubmit, a migration whose first ``kv_handoff`` export fails under
chaos (falling back to evacuate), ``steal_queued``, ``gray_drain`` under degraded ticks, the
disaggregated hand-off callback, KV-tier prefix adoption (clean and
corrupted) and chaos tick faults. A last test runs the port's driver
and watchdog threads under ``use_locksan`` with zero violations.
Tolerance: none — every comparison is exact equality.

Both packages' process-global comms loggers are pinned on (and reset) for
each scenario: each package books ``comm/...`` registry rows only while
its own logger is enabled, and other test files in the same process may
leave the JAX one on.
"""

import contextlib
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu.comm.comm as jcomm
import deepspeed_tpu.resilience.chaos as jchaos
import deepspeed_tpu.resilience.clock as jclock
import deepspeed_tpu.resilience.locksan as jlocksan
import deepspeed_tpu.resilience.preemption as jpre
import deepspeed_tpu.serving.kvtier as jkvtier
import deepspeed_tpu.telemetry as jtel
import deepspeed_tpu.telemetry.tracing as jtracing
import deepspeed_tpu_torch.comm.comm as tcomm
import deepspeed_tpu_torch.resilience.chaos as tchaos
import deepspeed_tpu_torch.resilience.clock as tclock
import deepspeed_tpu_torch.resilience.locksan as tlocksan
import deepspeed_tpu_torch.resilience.preemption as tpre
import deepspeed_tpu_torch.serving.kvtier as tkvtier
import deepspeed_tpu_torch.telemetry as ttel
import deepspeed_tpu_torch.telemetry.tracing as ttracing
from deepspeed_tpu.config import KVTierConfig as JaxKVTierConfig
from deepspeed_tpu.config import TelemetryConfig as JaxTelemetryConfig
from deepspeed_tpu.inference.ragged import (
    RaggedConfig as JaxRaggedConfig,
    RaggedInferenceEngine as JaxRaggedEngine)
from deepspeed_tpu.models import Llama as JaxLlama
from deepspeed_tpu.serving import ServingEngine as JaxServingEngine
from deepspeed_tpu_torch.checkpoint.jax_params import load_jax_params
from deepspeed_tpu_torch.config import KVTierConfig, TelemetryConfig
from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                  RaggedInferenceEngine)
from deepspeed_tpu_torch.models.llama import Llama
from deepspeed_tpu_torch.serving.request import RequestState
from deepspeed_tpu_torch.serving.server import ServingEngine

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, vocab_size=128,
            max_seq_len=256)
CFG = dict(token_budget=32, max_seqs=4, kv_block_size=8, n_kv_blocks=64,
           max_context=128, enable_prefix_cache=True)
DT = 0.01                      # virtual seconds per driver tick
# wall-timed engine histograms (time.perf_counter in both packages)
WALL_TIMED = ("inference/ttft_s", "inference/request_latency_s",
              "inference/decode_tokens_per_s")


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
    """One package's serving stack behind one interface."""

    def __init__(self, name, weights):
        self.name = name
        self.jm, self.params = weights
        jx = name == "jax"
        self.chaos = jchaos if jx else tchaos
        self.clock = jclock if jx else tclock
        self.tel = jtel if jx else ttel
        self.tracing = jtracing if jx else ttracing
        self.kvtier = jkvtier if jx else tkvtier
        self.pre = jpre if jx else tpre
        self.locksan = jlocksan if jx else tlocksan
        self.TelemetryConfig = JaxTelemetryConfig if jx else TelemetryConfig
        self.KVTierConfig = JaxKVTierConfig if jx else KVTierConfig

    def engine(self, params=0, **kw):
        cfg = {**CFG, **kw}
        if self.name == "jax":
            return JaxRaggedEngine(self.jm, JaxRaggedConfig(
                dtype=jnp.float32, **cfg), params=self.params[params])
        model = load_jax_params(Llama("tiny", device="cpu", **TINY),
                                self.params[params])
        return RaggedInferenceEngine(model, RaggedConfig(
            dtype=torch.float32, **cfg), device="cpu")

    def load_weights(self, eng, params):
        """A hot swap's load_fn body: the second weight set, in place."""
        if self.name == "jax":
            eng.params = jax.tree_util.tree_map(jnp.asarray,
                                                self.params[params])
        else:
            with torch.no_grad():
                load_jax_params(eng.model, self.params[params])

    def server(self, eng, cfg=None, **kw):
        cfg = {"stuck_tick_timeout_s": 0, **(cfg or {})}
        if self.name == "jax":
            return JaxServingEngine(eng, cfg, start=False, clock=self.sim,
                                    **kw)
        return ServingEngine(eng, cfg, start=False, clock=self.sim,
                             device="cpu", **kw)

    @contextlib.contextmanager
    def instrumented(self, tmp_path, injector=None):
        """SimClock, telemetry (records + tracing), both comms loggers on
        (:func:`comms_loggers_on`) and an optional fault injector
        installed for the block; cleared after it."""
        out = tmp_path / self.name
        out.mkdir(parents=True, exist_ok=True)
        self.records_path = out / "requests.jsonl"
        self.sim = self.clock.SimClock(start=100.0)
        cfg = self.TelemetryConfig(
            enabled=True, output_dir=str(out), jsonl_path="",
            requests_jsonl_path=str(self.records_path),
            stall_detection=False, tracing=True, flight_capacity=64)
        with self.clock.use_clock(self.sim), comms_loggers_on():
            t = self.tel.set_telemetry(self.tel.Telemetry(
                cfg, registry=self.tel.MetricsRegistry()))
            self.telemetry = t
            self.tracer = self.tracing.get_tracer()
            self.injector = self.chaos.install_fault_injector(injector)
            try:
                yield self
            finally:
                t.close()
                self.tel.set_telemetry(None)
                self.tracing.set_tracer(None)
                self.chaos.install_fault_injector(None)

    def drive(self, servers, done, limit=400):
        for _ in range(limit):
            if done():
                return
            for s in servers:
                s.step()
            self.sim.advance(DT)
        raise AssertionError(f"no progress after {limit} ticks")

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
        return {"streams": [list(r.tokens) for r in reqs],
                "states": [r.state.value for r in reqs],
                "errors": [r.error for r in reqs],
                "versions": [list(r.served_versions) for r in reqs],
                "registry": snap, "records": records,
                "trace": self.tracer.canonical_rows(),
                "flight": [{k: v for k, v in n.items() if k != "t"}
                           for n in self.tracer.flight.snapshot()],
                **extra}


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(1, 128, n).tolist()


PROMPTS = [_prompt(1, 9), _prompt(2, 21), _prompt(3, 14), _prompt(4, 5),
           _prompt(5, 17)]


def _reference(side, prompts, n, params=0):
    """Uninterrupted greedy streams of ``prompts`` on one engine."""
    eng = side.engine(params, max_seqs=8)
    out = eng.generate({i: p for i, p in enumerate(prompts)},
                       max_new_tokens=n)
    return [list(out[i]) for i in range(len(prompts))]


def _run(weights, tmp_path, scenario, injector=None):
    """``scenario(side)`` on both packages; their observations must be
    equal. Returns the port's."""
    obs = {}
    for name in ("jax", "torch"):
        side = Side(name, weights)
        inj = None if injector is None else side.chaos.FaultInjector(
            **injector)
        with side.instrumented(tmp_path, inj):
            obs[name] = scenario(side)
    for key in obs["jax"]:
        assert obs["torch"][key] == obs["jax"][key], key
    return obs["torch"]


# --------------------------------------------------------------- scenarios
def test_telemetry_records_counters_and_traces(weights, tmp_path):
    def scenario(side):
        srv = side.server(side.engine(), {"max_queue": 4},
                          replica_id="a")
        reqs = [srv.submit(p, max_new_tokens=6, priority=i % 2,
                           deadline_s=5.0 if i % 2 else None)
                for i, p in enumerate(PROMPTS)]           # the 5th: rejected
        srv.cancel(reqs[3])                               # queued cancel
        side.drive([srv], lambda: all(r.is_terminal for r in reqs))
        srv.step()                                        # idle tick
        assert srv.block_leaks() == []
        return side.observe(reqs, snapshot=srv.snapshot(),
                            pending=srv.pending_work)

    obs = _run(weights, tmp_path, scenario)
    assert obs["states"] == ["finished", "finished", "finished",
                             "cancelled", "rejected"]
    reg = obs["registry"]
    assert reg["serving/a/completed"] == 3 and reg["serving/a/rejected"] == 1
    assert reg["serving/a/ticks"] > 0 and reg["inference/ragged_steps"] > 0
    # (uid and client_request_id were left out of the comparison)
    assert all(not ttel.validate_request_record(
        {**r, "uid": 0, "client_request_id": "c"}) for r in obs["records"])
    assert len(obs["records"]) == 5
    # every request's tree is connected and closed
    roots = [row for row in obs["trace"] if row[2] == -1]
    assert len(roots) == 5 and all(row[6] is not None for row in obs["trace"])


def test_stuck_tick_watchdog_escalates(weights, tmp_path):
    def scenario(side):
        srv = side.server(side.engine(), {"stuck_tick_timeout_s": 1.0,
                                          "stuck_tick_escalate_polls": 2},
                          replica_id="a")
        seen = []
        srv._in_tick, srv._tick_started = True, side.sim.now()
        for _ in range(3):
            side.sim.advance(1.5)
            srv._watchdog_check()
            seen.append((srv._stuck_polls, srv.watchdog_unhealthy))
        srv._in_tick = False
        srv._watchdog_check()
        seen.append((srv._stuck_polls, srv.watchdog_unhealthy))
        return side.observe([], seen=seen)

    obs = _run(weights, tmp_path, scenario)
    assert obs["seen"] == [(1, False), (2, True), (3, True), (0, True)]
    assert obs["registry"]["serving/a/stuck_ticks"] == 1
    assert obs["registry"]["serving/a/watchdog_escalations"] == 1
    assert [n["kind"] for n in obs["flight"]
            if n["kind"] != "span"] == ["stuck_tick"]


def test_preemption_latch_drains_live_and_rejects_queue(weights, tmp_path):
    def scenario(side):
        guard = side.pre.PreemptionGuard()
        srv = side.server(side.engine(), preemption_guard=guard,
                          replica_id="a")
        reqs = [srv.submit(p, max_new_tokens=5) for p in PROMPTS]
        srv.step()
        side.sim.advance(DT)
        guard.request_stop()
        side.drive([srv], lambda: all(r.is_terminal for r in reqs))
        late = srv.submit(PROMPTS[0], max_new_tokens=3)
        return side.observe(reqs + [late])

    obs = _run(weights, tmp_path, scenario)
    assert obs["states"][:4] == ["finished"] * 4
    assert obs["states"][4:] == ["rejected", "rejected"]
    assert obs["errors"][4] == "preemption drain"
    assert [n["kind"] for n in obs["flight"]
            if n["kind"] != "span"] == ["preemption_latch"]


@pytest.mark.parametrize("outcome", ["success", "load_fails", "corrupt"])
def test_hot_swap(weights, tmp_path, outcome):
    def scenario(side):
        eng = side.engine()
        srv = side.server(eng, replica_id="a")
        first = [srv.submit(p, max_new_tokens=5) for p in PROMPTS[:2]]
        side.drive([srv], lambda: all(r.is_terminal for r in first))
        srv.stop_admission()

        def load_fn():
            if outcome == "load_fails":
                raise OSError("checkpoint shard missing")
            side.load_weights(eng, 1)

        if outcome == "corrupt":
            side.injector.arm_corrupt_swap(1)
        ok = srv.hot_swap(1, load_fn)
        warm = [srv.warmup_remaining]
        during = srv.submit(PROMPTS[2], max_new_tokens=3)
        for _ in range(2):
            srv.step()
            side.sim.advance(DT)
            warm.append(srv.warmup_remaining)
        if eng.prefix_cache is not None:
            # the new weights must not reuse KV the old ones computed
            eng.prefix_cache.drop_all(eng.allocator)
        after = [srv.submit(p, max_new_tokens=5) for p in PROMPTS[:2]]
        side.drive([srv], lambda: all(r.is_terminal for r in after))
        ref = _reference(side, PROMPTS[:2], 5, 1 if ok else 0)
        return side.observe(first + [during] + after, ok=ok, warm=warm,
                            version=srv.model_version,
                            matches_fresh=[r.tokens for r in after] == ref)

    inj = {} if outcome == "corrupt" else None
    obs = _run(weights, tmp_path, scenario, injector=inj)
    reg = obs["registry"]
    assert obs["matches_fresh"]
    if outcome == "success":
        assert obs["ok"] and obs["version"] == 1 and obs["warm"] == [2, 1, 0]
        assert obs["states"][2] == "rejected"         # warming up
        assert obs["versions"][3:] == [[1], [1]]
        assert reg["serving/a/swaps"] == 1 and reg["serving/a/warmup_done"] == 1
        assert obs["streams"][3:] != obs["streams"][:2]
    else:
        assert not obs["ok"] and obs["version"] == 0
        assert obs["warm"] == [0, 0, 0] and obs["states"][2] == "finished"
        assert obs["versions"][3:] == [[0], [0]]
        assert obs["streams"][3:] == obs["streams"][:2]
        assert reg["serving/a/swap_failed"] == 1


def _two(side, cfg=None, **kw):
    a = side.server(side.engine(), cfg, replica_id="a", **kw)
    b = side.server(side.engine(), cfg, replica_id="b")
    return a, b


@pytest.mark.parametrize("flaky", [0, 2])
def test_migrate_out_then_adopt(weights, tmp_path, flaky):
    def scenario(side):
        a, b = _two(side)
        reqs = [a.submit(p, max_new_tokens=8) for p in PROMPTS]
        side.drive([a], lambda: sum(len(r.tokens) >= 2 for r in reqs) >= 3)
        a.kill()
        queued, exports = a.migrate_out()
        shipped = [(len(e.tokens), e.n_pages) for _, e in exports]
        for req, exp in exports:
            assert b.adopt(req, exp)
        for req in queued:
            assert b.submit_request(req, requeue=True) is req
        assert not a.adopt(queued[0], None)        # a killed replica refuses
        side.drive([b], lambda: all(r.is_terminal for r in reqs))
        ref = _reference(side, PROMPTS, 8)
        return side.observe(reqs, shipped=shipped,
                            leaks=a.block_leaks() + b.block_leaks(),
                            same_as_uninterrupted=[r.tokens for r in reqs]
                            == ref)

    obs = _run(weights, tmp_path, scenario,
               injector={"flaky_import_every": flaky} if flaky else None)
    assert obs["leaks"] == [] and obs["same_as_uninterrupted"]
    assert obs["states"] == ["finished"] * 5 and obs["shipped"]
    reg = obs["registry"]
    adopted = reg.get("serving/b/adopted", 0)
    fallbacks = reg.get("serving/b/adopt_fallbacks", 0)
    assert adopted + fallbacks == len(obs["shipped"])
    assert (fallbacks > 0) == bool(flaky)
    assert reg["inference/kv_exports"] == len(obs["shipped"])


def test_migration_under_failed_kv_handoff_falls_back_to_evacuate(
        weights, tmp_path):
    """A ``kv_handoff`` collective fault (the chaos hook in
    ``record_collective``) fails the first export of ``migrate_out`` as a
    crash, before any request has left the replica: the caller falls back
    to ``evacuate`` and resubmits every request, which re-prefills
    elsewhere with unchanged streams."""
    def scenario(side):
        a, b = _two(side)
        reqs = [a.submit(p, max_new_tokens=8) for p in PROMPTS]
        side.drive([a], lambda: sum(len(r.tokens) >= 2 for r in reqs) >= 3)
        a.kill()
        try:
            a.migrate_out()
            failed = None
        except side.chaos.CollectiveFault as e:
            failed = str(e)
        orphans = a.evacuate()
        for r in orphans:
            assert b.submit_request(r, requeue=True) is r
        side.drive([b], lambda: all(r.is_terminal for r in reqs))
        ref = _reference(side, PROMPTS, 8)
        return side.observe(reqs, failed=failed,
                            orphans=sorted(reqs.index(r) for r in orphans),
                            leaks=a.block_leaks() + b.block_leaks(),
                            same=[r.tokens for r in reqs] == ref)

    obs = _run(weights, tmp_path, scenario,
               injector={"collective_fail_op": "kv_handoff",
                         "collective_fail_at_call": 1})
    assert obs["failed"] == "injected fault: collective_fail:kv_handoff"
    assert obs["orphans"] == [0, 1, 2, 3, 4]
    assert obs["leaks"] == [] and obs["same"]
    assert obs["states"] == ["finished"] * 5
    reg = obs["registry"]
    assert "comm/kv_handoff/calls" not in reg     # the failed one unbooked
    assert reg["inference/kv_exports"] == 1
    assert reg["resilience/chaos/collective_fail/kv_handoff"] == 1


def test_kill_evacuate_resubmit(weights, tmp_path):
    def scenario(side):
        a, b = _two(side)
        reqs = [a.submit(p, max_new_tokens=7) for p in PROMPTS]
        side.drive([a], lambda: any(len(r.tokens) >= 2 for r in reqs))
        before = [r.state.value for r in reqs]
        a.kill()
        orphans = a.evacuate()
        for r in orphans:
            assert b.submit_request(r, requeue=True) is r
        side.drive([b], lambda: all(r.is_terminal for r in reqs))
        ref = _reference(side, PROMPTS, 7)
        return side.observe(reqs, before=before, n_orphans=len(orphans),
                            leaks=a.block_leaks() + b.block_leaks(),
                            same=[r.tokens for r in reqs] == ref)

    obs = _run(weights, tmp_path, scenario)
    assert "queued" in obs["before"] and "decode" in obs["before"]
    assert obs["n_orphans"] == 5 and obs["leaks"] == [] and obs["same"]


def test_steal_queued(weights, tmp_path):
    def scenario(side):
        a, b = _two(side)
        reqs = [a.submit(p, max_new_tokens=4)
                for p in PROMPTS + PROMPTS[:2]]
        a.step()
        side.sim.advance(DT)
        a.cancel(reqs[5])                      # cancel one queued request
        stolen = a.steal_queued(5)
        for r in stolen:
            assert b.submit_request(r, requeue=True) is r
        side.drive([a, b], lambda: all(r.is_terminal for r in reqs))
        return side.observe(reqs, stolen=[reqs.index(r) for r in stolen],
                            snaps=(a.snapshot(), b.snapshot()))

    obs = _run(weights, tmp_path, scenario)
    assert obs["stolen"] == [6, 4]             # from the tail
    assert obs["states"].count("finished") == 6


def test_gray_drain_under_degraded_ticks(weights, tmp_path):
    def scenario(side):
        srv = side.server(side.engine(), replica_id="a")
        side.injector.degrade_replica("a", 2)
        reqs = [srv.submit(p, max_new_tokens=4) for p in PROMPTS[:3]]
        drains = []
        for _ in range(6):
            srv.step()
            side.sim.advance(DT)
            drains.append(srv.gray_drain())
        side.injector.degrade_replica("a", 0)
        side.injector.degrade_model_version(0)
        side.drive([srv], lambda: all(r.is_terminal for r in reqs))
        drains.append(srv.gray_drain())
        return side.observe(reqs, drains=drains)

    obs = _run(weights, tmp_path, scenario, injector={})
    assert obs["drains"][:6] == [(1, 1), (1, 0)] * 3
    busy, distress = obs["drains"][6]
    assert distress > 0 and busy > distress
    assert obs["states"] == ["finished"] * 3
    assert obs["registry"]["serving/a/degraded_ticks"] >= 3


def test_handoff_callback_ships_prefilled_requests(weights, tmp_path):
    def scenario(side):
        shipped = []
        b = side.server(side.engine(), replica_id="b")

        def on_handoff(req, export):
            shipped.append(export.n_pages)
            assert b.adopt(req, export)

        a = side.server(side.engine(), replica_id="a",
                        on_handoff=on_handoff)
        reqs = []
        for p in PROMPTS[:4]:
            r = a.submit(p, max_new_tokens=6)
            r._handoff_requested = True
            reqs.append(r)
        side.drive([a, b], lambda: all(r.is_terminal for r in reqs))
        ref = _reference(side, PROMPTS[:4], 6)
        return side.observe(reqs, shipped=shipped,
                            same=[r.tokens for r in reqs] == ref,
                            leaks=a.block_leaks() + b.block_leaks())

    obs = _run(weights, tmp_path, scenario)
    assert len(obs["shipped"]) == 4 and obs["same"] and obs["leaks"] == []
    reg = obs["registry"]
    assert reg["serving/a/handoffs_out"] == 4 and reg["serving/b/adopted"] == 4


@pytest.mark.parametrize("corrupt", [False, True])
def test_kv_tier_prefix_adoption(weights, tmp_path, corrupt):
    shared = _prompt(11, 24)                   # three full 8-token blocks

    def scenario(side):
        tier = side.kvtier.KVTier(side.KVTierConfig(
            enabled=True, publish_interval_s=0.05,
            directory_staleness_s=1.0, cold_capacity_pages=16))
        a, b = _two(side, {"kv_tier": {"enabled": True}})
        a.enable_kv_tier(tier, "a")
        b.enable_kv_tier(tier, "b")
        first = a.submit(shared + [3, 4], max_new_tokens=4)
        side.drive([a], lambda: first.is_terminal)
        for _ in range(6):                     # publish cadence
            a.step()
            side.sim.advance(DT)
        snap = a.residency_snapshot()
        if side.name == "torch":
            tier.publish_residency("a", snap)
        else:
            tier.directory.publish("a", snap[0], snap[1])
        got = []
        assert a.request_prefix_export(
            shared + [9], lambda e: got.append(e) or b.adopt_prefix(e))
        a.step()
        b.step()
        side.sim.advance(DT)
        second = b.submit(shared + [5, 6], max_new_tokens=4)
        side.drive([b], lambda: second.is_terminal)
        ref = _reference(side, [shared + [5, 6]], 4)
        return side.observe([first, second], pages=got[0].n_pages,
                            directory=tier.directory.snapshot(),
                            same=[second.tokens] == ref,
                            imports=b._engine.kvtier_adopt_imports)

    obs = _run(weights, tmp_path, scenario,
               injector={"corrupt_adopt_every": 1} if corrupt else None)
    reg = obs["registry"]
    assert obs["same"] and obs["pages"] == 3
    assert reg["serving/a/prefix_donated"] == 1
    if corrupt:
        assert reg["serving/b/prefix_adopt_corrupt"] == 1
        assert obs["imports"] == 0
    else:
        assert reg["serving/b/prefix_adopted"] == 1 and obs["imports"] == 1
        assert reg["inference/prefix_imports"] == 1


def test_chaos_tick_faults_retry_with_unchanged_streams(weights, tmp_path):
    def scenario(side):
        srv = side.server(side.engine(), {"tick_retry_limit": 3},
                          replica_id="a")
        reqs = [srv.submit(p, max_new_tokens=6) for p in PROMPTS[:4]]
        side.drive([srv], lambda: all(r.is_terminal for r in reqs))
        ref = _reference(side, PROMPTS[:4], 6)
        return side.observe(reqs, retries=[r.retries for r in reqs],
                            same=[r.tokens for r in reqs] == ref)

    obs = _run(weights, tmp_path, scenario,
               injector={"serving_tick_fail_at": 2,
                         "serving_tick_fail_every": 6})
    assert obs["same"] and obs["states"] == ["finished"] * 4
    assert obs["registry"]["serving/a/tick_faults"] >= 2
    assert min(obs["retries"]) >= 1
    assert all(r["retries"] >= 1 for r in obs["records"])


def test_driver_threads_under_locksan_have_no_violations(weights):
    side = Side("torch", weights)
    with tlocksan.use_locksan() as san:
        tier = tkvtier.KVTier(KVTierConfig(enabled=True))
        srv = ServingEngine(side.engine(), {"stuck_tick_timeout_s": 5.0},
                            replica_id="a", device="cpu")
        srv.enable_kv_tier(tier, "a")
        assert srv._watchdog is not None
        streams = [list(srv.stream(p, max_new_tokens=4)) for p in PROMPTS[:3]]
        reqs = [srv.submit(p, max_new_tokens=4) for p in PROMPTS[3:]]
        assert all(r.result(timeout=60) for r in reqs)
        srv.close(timeout=30)
    assert srv._driver is None and srv._watchdog is None
    assert srv.block_leaks() == []
    assert san.violations == []
    assert san.acquires["ServingEngine._lock"] > 0
    assert streams == _reference(side, PROMPTS[:3], 4)
    assert RequestState.FINISHED is reqs[0].state
