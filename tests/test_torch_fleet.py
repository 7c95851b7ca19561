"""The fleet: the port's ``ServingFleet``, routers, health plane, retry
budget, elasticity and ``FleetConfig`` held to the JAX package's on the CPU.

Unit parity: one event script runs against each package's module and the
two records must be equal (ring placement key for key, state-machine
transitions, sizing decisions, ``ValueError`` messages).

Fleet scenarios: both packages build a ``ServingFleet`` over a tiny fp32
Llama (2 layers, d 64) from the same weights, ``start=False`` with manual
``step()``, each under its own ``SimClock`` advanced by the same
schedule, its own telemetry (request records to JSON lines, tracing on),
both comms loggers pinned on, and, where a scenario needs one, its own
``FaultInjector``. The observations must be equal: streams, states,
errors, served versions, the registry (wall-timed engine histograms by
count only), the request records minus ``uid`` / ``client_request_id``
(kept where the scenario named them), and the trace trees.

A last test runs the port's fleet with its driver and monitor threads
under ``use_locksan`` with zero violations.
Tolerance: none — every comparison is exact equality.
"""

import contextlib
import dataclasses
import json
import random
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu.comm.comm as jcomm
import deepspeed_tpu.config as jconfig
import deepspeed_tpu.elasticity as jelastic
import deepspeed_tpu.resilience.chaos as jchaos
import deepspeed_tpu.resilience.clock as jclock
import deepspeed_tpu.resilience.retry as jretry
import deepspeed_tpu.serving.health as jhealth
import deepspeed_tpu.serving.kvtier as jkvtier
import deepspeed_tpu.serving.router as jrouter
import deepspeed_tpu.telemetry as jtel
import deepspeed_tpu.telemetry.tracing as jtracing
import deepspeed_tpu_torch.comm.comm as tcomm
import deepspeed_tpu_torch.config as tconfig
import deepspeed_tpu_torch.elasticity as telastic
import deepspeed_tpu_torch.resilience.chaos as tchaos
import deepspeed_tpu_torch.resilience.clock as tclock
import deepspeed_tpu_torch.resilience.locksan as tlocksan
import deepspeed_tpu_torch.resilience.retry as tretry
import deepspeed_tpu_torch.serving.health as thealth
import deepspeed_tpu_torch.serving.kvtier as tkvtier
import deepspeed_tpu_torch.serving.router as trouter
import deepspeed_tpu_torch.telemetry as ttel
import deepspeed_tpu_torch.telemetry.tracing as ttracing
from deepspeed_tpu.inference.ragged import (
    RaggedConfig as JaxRaggedConfig,
    RaggedInferenceEngine as JaxRaggedEngine)
from deepspeed_tpu.models import Llama as JaxLlama
from deepspeed_tpu.serving import ServingFleet as JaxServingFleet
from deepspeed_tpu_torch.checkpoint.jax_params import load_jax_params
from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                  RaggedInferenceEngine)
from deepspeed_tpu_torch.models.llama import Llama
from deepspeed_tpu_torch.serving import ReplicaState, ServingFleet

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, vocab_size=128,
            max_seq_len=256)
CFG = dict(token_budget=32, max_seqs=4, kv_block_size=8, n_kv_blocks=64,
           max_context=128, enable_prefix_cache=True)
DT = 0.01                      # virtual seconds per fleet step
# wall-timed engine histograms (time.perf_counter in both packages)
WALL_TIMED = ("inference/ttft_s", "inference/request_latency_s",
              "inference/decode_tokens_per_s")

J = types.SimpleNamespace(router=jrouter, health=jhealth, retry=jretry,
                          elastic=jelastic, config=jconfig, kvtier=jkvtier,
                          tel=jtel)
T = types.SimpleNamespace(router=trouter, health=thealth, retry=tretry,
                          elastic=telastic, config=tconfig, kvtier=tkvtier,
                          tel=ttel)


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


def _keys(n, seed=0, length=24):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 1000, length).tolist() for _ in range(n)]


# ------------------------------------------------------------------ router
def test_prefix_key_and_hash_match():
    def script(m):
        p = list(range(100, 120))
        return [m.router.prefix_key(p, 8), m.router.prefix_key(p[:16], 8),
                m.router.prefix_key([7, 8, 9], 8),
                [m.router._hash64(f"k{i}") for i in range(20)]]

    out = _both(script)
    assert out[0] == tuple(range(100, 116)) and out[2] == (7, 8, 9)
    assert tkvtier.prefix_hash([1, 2, 3]) == jkvtier.prefix_hash([1, 2, 3])


def test_ring_join_leave_walk_key_for_key():
    def script(m):
        r = m.router.PrefixAffinityRouter(block_size=8, vnodes=64)
        for i in range(4):
            r.on_join(f"rep{i}")
        keys = _keys(400)
        rec = {"base": [r.owner(k) for k in keys]}
        r.on_join("rep4")
        rec["joined"] = [r.owner(k) for k in keys]
        r.on_leave("rep2")
        rec["left"] = [r.owner(k) for k in keys]
        rec["walk"] = [r.owner(k, eligible=lambda n: n in ("rep1", "rep3"))
                       for k in keys[:50]]
        ring = m.router.ConsistentHashRing(vnodes=16)
        for n in ("a", "b", "c"):
            ring.join(n)
        rec["ring"] = [ring.walk(m.router._hash64(str(i))) for i in range(64)]
        rec["empty"] = m.router.ConsistentHashRing().walk(5)
        rec["bad_vnodes"] = _raises(lambda: m.router.ConsistentHashRing(0),
                                    "ValueError")
        return rec

    rec = _both(script)
    moved = [i for i, (a, b) in enumerate(zip(rec["base"], rec["joined"]))
             if a != b]
    assert 0 < len(moved) <= 160 and all(rec["joined"][i] == "rep4"
                                         for i in moved)
    for a, b in zip(rec["joined"], rec["left"]):
        assert b == a if a != "rep2" else b != "rep2"
    assert set(rec["walk"]) <= {"rep1", "rep3"} and rec["empty"] is None


def test_route_unhealthy_spill_and_factory():
    def script(m):
        rec = []
        r = m.router.PrefixAffinityRouter(block_size=8, vnodes=32,
                                          spill_load=4)
        for i in range(3):
            r.on_join(f"rep{i}")
        for seed in range(12):
            prompt = _keys(1, seed, length=10 + seed)[0]
            primary = r.owner(prompt)
            others = {f"rep{i}": i for i in range(3)
                      if f"rep{i}" != primary}
            rec.append((primary, r.route(others, prompt), r.route_info()))
            rec.append((r.route({primary: 4, **others}, prompt),
                        r.route_info()))
            rec.append((r.route({primary: 3, **others}, prompt),
                        r.route_info()))
        shared = list(range(1, 17))
        rec.append(sorted({r.route({f"rep{i}": 0 for i in range(3)},
                                   shared + [t]) for t in range(50, 60)}))
        rec.append(_raises(lambda: r.route({}, [1]), "NoHealthyReplica"))
        ll = m.router.make_router("least_loaded")
        rec.append((ll.name, ll.route({"a": 3, "b": 1, "c": 2}, [1, 2]),
                    ll.route({"a": 1, "b": 1}, [1]), ll.route_info()))
        for name in ("prefix_affinity", "residency"):
            x = m.router.make_router(name, block_size=4, vnodes=8,
                                     spill_load=2)
            rec.append((type(x).__name__, x.block_size, x.vnodes,
                        x.spill_load))
        rec.append(_raises(lambda: m.router.make_router("nope"),
                           "ValueError"))
        rec.append(_raises(lambda: m.router.PrefixAffinityRouter(0),
                           "ValueError"))
        rec.append(m.router.least_loaded_pick({"b": 1.0, "a": 1.0}))
        return rec

    rec = _both(script)
    assert len(rec[36]) == 1                    # one prefix, one replica


def test_residency_router_outcomes():
    def script(m):
        d = m.kvtier.PrefixDirectory(staleness_s=1.0)
        now = [0.0]
        r = m.router.ResidencyAwareRouter(block_size=8, vnodes=16,
                                          spill_load=3, directory=d,
                                          now_fn=lambda: now[0])
        for n in ("r0", "r1", "r2"):
            r.on_join(n)
        prompt = list(range(1, 20))
        h = m.router._hash64(",".join(map(str, m.router.prefix_key(prompt,
                                                                   8))))
        view = {"r0": 0, "r1": 1, "r2": 2}
        rec = [(r.route(view, prompt), r.route_info())]      # plain miss
        d.publish("r2", [h], 0.0)
        rec.append((r.route(view, prompt), r.route_info()))  # residency
        rec.append((r.route({"r0": 0, "r1": 1, "r2": 3}, prompt),
                    r.route_info()))                          # spilled
        now[0] = 5.0
        rec.append((r.route(view, prompt), r.route_info()))  # stale
        return rec

    rec = _both(script)
    assert [x[1]["outcome"] for x in rec] == [
        "affinity", "residency", "affinity", "directory_stale"]


# ------------------------------------------------------------------ health
def _health_script(m):
    rng = np.random.default_rng(3)
    h = m.health.ReplicaHealth("rep", threshold=0.5, breach_polls=2,
                               dwell_s=4.0, readmit_polls=2)
    rec = []
    t = 0.0
    for i in range(80):
        t += 1.0
        r = float(rng.random()) if i % 20 < 12 else 0.0
        if i % 7 == 6:
            h.idle_decay()
        else:
            h.observe(r, t, can_quarantine=(i % 11 != 0))
        if h.should_quarantine():
            h.quarantine(t)
        if i == 50:
            h.release(t)
        rec.append((h.state, round(h.score, 12), h.routable, h.since,
                    h.dwell_s))
    snap = h.snapshot()
    return rec, snap


def test_replica_health_state_machine():
    rec, snap = _both(_health_script)
    kinds = {to for _, _, to in snap["transitions"]}
    assert {"quarantined", "probation"} <= kinds


def test_circuit_breaker_and_hedge_pair():
    def script(m):
        b = m.health.CircuitBreaker("rep", failure_limit=2, cooldown_s=5.0)
        rec = []
        events = ["f", "s", "f", "f", "a3", "a5", "p", "a5.1", "f", "a9",
                  "a10", "p", "s", "a10.5", "f", "f"]
        t = 0.0
        for e in events:
            t += 0.5
            if e == "f":
                b.record_failure(t)
            elif e == "s":
                b.record_success(t)
            elif e == "p":
                b.claim_probe()
            else:
                rec.append(b.admits(float(e[1:])))
            rec.append(b.state)
        rec.append(b.snapshot())

        class Leg:
            def __init__(self, uid):
                self.uid, self.client_request_id = uid, "cr"

        p, s = Leg(1), Leg(2)
        pair = m.health.HedgePair(p, s)
        out = []
        pair.deliver(2, out.append, 7)
        pair.deliver(1, out.append, 9)
        pair.deliver(2, out.append, 8)
        rec += [out, pair.winner_uid, pair.loser.uid, pair.is_suppressed(1),
                pair.is_suppressed(2), pair.snapshot()]
        for who in (1, 2):
            q = m.health.HedgePair(Leg(3), Leg(4))
            q.settle(who + 2)
            rec += [q.winner.uid, q.is_suppressed(4)]
        return rec

    rec = _both(script)
    assert rec[-10] == [7, 8]                   # the loser's token gated


# ---------------------------------------------------- elasticity and retry
def test_elasticity_sizing_and_training_configs():
    def script(m):
        e = m.elastic
        rec = []
        cfgs = [e.ServingElasticityConfig(),
                e.ServingElasticityConfig(min_replicas=2, max_replicas=5,
                                          max_step=2,
                                          scale_up_queue_per_replica=4.0,
                                          scale_down_queue_per_replica=0.5)]
        for cfg in cfgs:
            rec.append(e.serving_replica_candidates(cfg))
            for cur in range(0, 7):
                for q in (0, 1, 2, 6, 9, 20, 500):
                    for kv, sla in ((0.0, None), (0.9, None), (0.0, 0.5),
                                    (0.2, 1.0)):
                        rec.append(e.compute_serving_replicas(
                            cur, queue_depth=q, kv_occupancy=kv,
                            in_sla_ratio=sla, config=cfg))
        for bad in ({"min_replicas": 0}, {"min_replicas": 4,
                                          "max_replicas": 2},
                    {"scale_up_queue_per_replica": 1.0,
                     "scale_down_queue_per_replica": 2.0},
                    {"max_step": 0}):
            rec.append(_raises(lambda: e.ServingElasticityConfig(**bad),
                               "ElasticityError"))
        rec.append(dataclasses.asdict(e.ServingElasticityConfig.from_dict(
            {"max_replicas": 3, "junk": 1})))
        for el in ({"enabled": True, "max_train_batch_size": 64,
                    "micro_batch_sizes": [2, 4], "min_gpus": 1,
                    "max_gpus": 8},
                   {"enabled": True, "max_train_batch_size": 100,
                    "micro_batch_sizes": [3, 5], "min_gpus": 2,
                    "max_gpus": 6, "prefer_larger_batch": False}):
            rec.append(e.compute_elastic_config({"elasticity": el}))
            rec.append(e.compute_elastic_config({"elasticity": el},
                                                world_size=2))
            rec.append(e.elasticity.elasticity_fingerprint(
                {"elasticity": el}))
        rec.append(_raises(lambda: e.compute_elastic_config({}),
                           "ElasticityError"))
        rec.append(_raises(lambda: e.compute_elastic_config(
            {"elasticity": {"enabled": False, "x": 1}}), "ElasticityError"))
        rec.append(_raises(lambda: e.compute_elastic_config(
            {"elasticity": {"enabled": True, "max_train_batch_size": 1,
                            "micro_batch_sizes": [2]}}), "ElasticityError"))
        rec.append(e.get_compatible_gpus(24, [2, 3], 1, 12))
        e.elasticity._frozen.clear()
        e.ensure_immutable_elastic_config({"max_train_batch_size": 8})
        e.ensure_immutable_elastic_config({"max_train_batch_size": 8})
        rec.append(_raises(lambda: e.ensure_immutable_elastic_config(
            {"max_train_batch_size": 9}), "ElasticityError"))
        e.elasticity._frozen.clear()
        return rec

    _both(script)


def test_retry_budget_and_retry_call():
    def script(m):
        b = m.retry.RetryBudget(3)
        rec = [b.take("x") for _ in range(5)] + [b.remaining]
        rec.append(_raises(lambda: m.retry.RetryBudget(-1), "ValueError"))
        rec.append(_raises(lambda: m.retry.RetryPolicy(max_attempts=0),
                           "ValueError"))
        reg = m.tel.get_registry()
        before = reg.snapshot()
        for fails, budget in ((2, None), (5, None), (5, 1)):
            calls, sleeps = [0], []

            def flaky():
                calls[0] += 1
                if calls[0] <= fails:
                    raise OSError(f"flake {calls[0]}")
                return calls[0]

            pol = m.retry.RetryPolicy(max_attempts=4, backoff_s=0.5,
                                      jitter=0.3)
            try:
                res = m.retry.retry_call(
                    flaky, policy=pol, op="fleet_test", sleep=sleeps.append,
                    budget=None if budget is None
                    else m.retry.RetryBudget(budget),
                    rng=random.Random(7))
            except m.retry.RetryError as e:
                res = str(e)
            rec.append((res, sleeps))
        after = reg.snapshot()
        rec.append({k: after[k] - before.get(k, 0) for k in after
                    if "fleet_test" in k})
        return rec

    rec = _both(script)
    assert rec[:6] == [True, True, True, False, False, 0]


# ------------------------------------------------------------------ config
FLEET_OK = [None, {}, {"replicas": 2},
            {"replicas": 3, "router": "prefix_affinity",
             "affinity_vnodes": 16, "affinity_spill_load": 4},
            {"disaggregated": True, "prefill_replicas": 2, "replicas": 1},
            {"autoscale": True, "min_replicas": 2, "max_replicas": 4,
             "scale_up_queue_per_replica": 4, "kv_high": 0.7},
            {"router": "residency", "quarantine": True, "breakers": True,
             "hedge": True, "hedge_ttft_fraction": 0.4,
             "route_retry_budget": 0, "unknown_key": 1}]
FLEET_BAD = [{"router": "random"}, {"replicas": 0},
             {"disaggregated": True, "prefill_replicas": 0},
             {"min_replicas": 3, "max_replicas": 2},
             {"scale_down_queue_per_replica": 10.0,
              "scale_up_queue_per_replica": 8.0},
             {"sla_window": 0}, {"quarantine_threshold": 0.0},
             {"quarantine_after": 0}, {"quarantine_dwell_s": 0},
             {"breaker_failures": 0}, {"hedge_ttft_fraction": 1.0},
             {"route_retry_budget": -1}, {"route_backoff_s": -0.1}]


def test_fleet_config_values_and_messages():
    def script(m):
        rec = [dataclasses.asdict(m.config.FleetConfig.from_dict(d))
               for d in FLEET_OK]
        rec += [_raises(lambda d=d: m.config.FleetConfig.from_dict(d),
                        "ConfigError") for d in FLEET_BAD]
        rec.append(dataclasses.asdict(m.config.ServingConfig.from_dict(
            {"fleet": {"replicas": 2}}).fleet))
        return rec

    rec = _both(script)
    assert all(isinstance(x, str) for x in rec[len(FLEET_OK):-1])
    assert rec[-1]["replicas"] == 2


# ------------------------------------------------------- fleet scenarios
@pytest.fixture(scope="module")
def weights():
    jm = JaxLlama("tiny", use_flash=False, remat=False, **TINY)
    return jm, [jax.tree_util.tree_map(np.asarray,
                                       jm.init(jax.random.PRNGKey(s)))
                for s in (5, 6)]


@contextlib.contextmanager
def comms_loggers_on():
    """Both packages' comms loggers enabled and reset for the block; each
    logger's previous ``enabled`` / ``verbose`` restored after it (each
    package books ``comm/...`` rows only while its own logger is on)."""
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
    """One package's fleet stack behind one interface."""

    def __init__(self, name, weights):
        self.name = name
        self.jm, self.params = weights
        jx = name == "jax"
        self.chaos = jchaos if jx else tchaos
        self.clock = jclock if jx else tclock
        self.tel = jtel if jx else ttel
        self.tracing = jtracing if jx else ttracing
        self.config = jconfig if jx else tconfig

    def engine(self, params=0, **kw):
        cfg = {**CFG, **kw}
        if self.name == "jax":
            return JaxRaggedEngine(self.jm, JaxRaggedConfig(
                dtype=jnp.float32, **cfg), params=self.params[params])
        model = load_jax_params(Llama("tiny", device="cpu", **TINY),
                                self.params[params])
        return RaggedInferenceEngine(model, RaggedConfig(
            dtype=torch.float32, **cfg), device="cpu")

    def fleet(self, fleet_cfg, serving_cfg=None, factory=None, **kw):
        scfg = {"policy": "slo", "stuck_tick_timeout_s": 0,
                **(serving_cfg or {})}
        factory = factory or (lambda: self.engine())
        if self.name == "jax":
            return JaxServingFleet(factory, fleet_cfg, scfg, start=False,
                                   clock=self.sim, **kw)
        return ServingFleet(factory, fleet_cfg, scfg, start=False,
                            clock=self.sim, device="cpu", **kw)

    @contextlib.contextmanager
    def instrumented(self, tmp_path, injector=None):
        """SimClock, telemetry (records + tracing), both comms loggers on
        and an optional fault injector installed for the block; cleared
        after it."""
        out = tmp_path / self.name
        out.mkdir(parents=True, exist_ok=True)
        self.records_path = out / "requests.jsonl"
        self.sim = self.clock.SimClock(start=100.0)
        cfg = (self.config.TelemetryConfig)(
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

    def drive(self, fleet, done, limit=400):
        for _ in range(limit):
            if done():
                return
            fleet.step()
            self.sim.advance(DT)
        raise AssertionError(f"no progress after {limit} steps")

    def observe(self, reqs, keep_crids=False, **extra):
        """Everything the two packages must agree on."""
        snap = {}
        for k, v in self.telemetry.registry.snapshot().items():
            snap[k] = {"count": v["count"]} if k in WALL_TIMED else v
        records = []
        if self.records_path.exists():
            for line in self.records_path.read_text().splitlines():
                r = json.loads(line)
                r.pop("uid")
                crid = r.pop("client_request_id")
                if keep_crids:
                    r["client_request_id"] = crid
                records.append(r)
        return {"streams": [list(r.tokens) for r in reqs],
                "states": [r.state.value for r in reqs],
                "errors": [r.error for r in reqs],
                "versions": [list(r.served_versions) for r in reqs],
                "registry": snap, "records": records,
                "trace": self.tracer.canonical_rows(), **extra}


def _prompts(seed, n, length=10):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 128, length).tolist() for _ in range(n)]


def _reference(side, prompts, n):
    """Uninterrupted greedy streams of ``prompts`` on one engine."""
    eng = side.engine(max_seqs=8)
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


def _placed(fleet, reqs):
    return [fleet._requests[r.uid][1] if r.uid in fleet._requests else None
            for r in reqs]


def _finish(side, fleet, reqs, ref=None, **extra):
    """Drive to the end, audit, close, and observe. ``ref=(prompts, n)``
    adds ``same``: the first requests' streams equal an uninterrupted
    single-engine run of ``prompts``. A callable in ``extra`` is read
    after the run."""
    side.drive(fleet, lambda: all(r.is_terminal for r in reqs))
    extra = {k: v() if callable(v) else v for k, v in extra.items()}
    drained = fleet.drain(timeout=5.0)
    leaks = fleet.block_leaks()
    fleet.close(timeout=5.0)
    if ref is not None:
        prompts, n = ref
        extra["same"] = ([list(r.tokens) for r in reqs[:len(prompts)]]
                         == _reference(side, prompts, n))
    return side.observe(reqs, drained=drained, leaks=leaks, **extra)


def test_routes_and_completes(weights, tmp_path):
    prompts = _prompts(10, 4)

    def scenario(side):
        fleet = side.fleet({"replicas": 2})
        reqs = [fleet.submit(p, max_new_tokens=6) for p in prompts]
        placed = _placed(fleet, reqs)
        return _finish(side, fleet, reqs, placed=placed,
                       ref=(prompts, 6))

    obs = _run(weights, tmp_path, scenario)
    assert set(obs["placed"]) == {"replica-0", "replica-1"}
    assert (obs["same"], obs["drained"], obs["leaks"]) == (True, True, [])
    assert obs["registry"]["serving/fleet/routed"] == 4


@pytest.mark.parametrize("how", ["kill", "chaos"])
def test_failover_keeps_streams(weights, tmp_path, how):
    prompts = _prompts(11, 4)

    def scenario(side):
        fleet = side.fleet({"replicas": 2})
        reqs = [fleet.submit(p, max_new_tokens=8) for p in prompts]
        victims = []
        if how == "kill":
            for _ in range(4):
                fleet.step()
                side.sim.advance(DT)
            victims = [reqs.index(r) for r in reqs
                       if fleet._requests[r.uid][1] == "replica-0"]
            assert fleet.kill_replica("replica-0")
        obs = _finish(side, fleet, reqs, victims=victims,
                      dead=lambda: [r.name for r in fleet.replicas
                                    if r.state == ReplicaState.DEAD],
                      ref=(prompts, 8))
        return obs

    inj = ({"replica_die_at_tick": 2, "replica_die_index": 0}
           if how == "chaos" else None)
    obs = _run(weights, tmp_path, scenario, injector=inj)
    assert obs["same"] and obs["leaks"] == [] and obs["dead"] == ["replica-0"]
    assert obs["states"] == ["finished"] * 4
    assert obs["registry"]["serving/fleet/failovers"] >= 1


def test_disaggregated_handoff(weights, tmp_path):
    prompts = _prompts(13, 4)

    def scenario(side):
        fleet = side.fleet({"disaggregated": True, "prefill_replicas": 1,
                            "replicas": 1})
        reqs = [fleet.submit(p, max_new_tokens=8) for p in prompts]
        return _finish(side, fleet, reqs, roles=[r.role for r in
                                                 fleet.replicas],
                       ref=(prompts, 8))

    obs = _run(weights, tmp_path, scenario)
    reg = obs["registry"]
    assert obs["same"] and obs["leaks"] == []
    assert obs["roles"] == ["prefill", "decode"]
    assert reg["serving/fleet/handoffs"] == 4
    assert reg["comm/kv_handoff/calls"] == 4


@pytest.mark.parametrize("disaggregated", [False, True])
def test_affinity_routes_repeat_prefixes_together(weights, tmp_path,
                                                  disaggregated):
    shared = [_prompts(30 + i, 1, length=16)[0] for i in range(2)]

    def scenario(side):
        cfg = {"router": "prefix_affinity", "replicas": 3}
        if disaggregated:
            cfg = {**cfg, "disaggregated": True, "prefill_replicas": 2,
                   "replicas": 1}
        fleet = side.fleet(cfg)
        reqs = [fleet.submit(shared[i] + [50 + i], max_new_tokens=3)
                for i in range(2)]
        placed = _placed(fleet, reqs)
        side.drive(fleet, lambda: all(r.is_terminal for r in reqs))
        more = [fleet.submit(shared[i % 2] + [50 + i], max_new_tokens=3)
                for i in range(2, 6)]
        placed += _placed(fleet, more)
        return _finish(side, fleet, reqs + more, placed=placed,
                       hits=lambda: [r.engine.prefix_cache.hits
                                     for r in fleet.replicas])

    obs = _run(weights, tmp_path, scenario)
    placed = obs["placed"]
    assert len({placed[0], placed[2], placed[4]}) == 1
    assert len({placed[1], placed[3], placed[5]}) == 1
    assert obs["states"] == ["finished"] * 6 and obs["leaks"] == []
    reg = obs["registry"]
    assert reg["serving/fleet/affinity_hits"] == 6
    assert sum(obs["hits"]) >= 4                   # repeats hit the cache


@pytest.mark.parametrize("how", ["geometry", "flaky"])
def test_handoff_failure_falls_back_to_reprefill(weights, tmp_path, how):
    """The decode replica cannot land the hand-off — mismatched page
    geometry, or an injected flaky import — and the request re-prefills
    there with an unchanged stream."""
    prompts = _prompts(14, 1, length=30)

    def scenario(side):
        calls = [0]

        def factory():
            calls[0] += 1
            if calls[0] == 1 or how == "flaky":
                return side.engine()
            return side.engine(kv_block_size=16, n_kv_blocks=32)

        fleet = side.fleet({"disaggregated": True, "prefill_replicas": 1,
                            "replicas": 1, "respawn": False},
                           factory=factory)
        req = fleet.submit(prompts[0], max_new_tokens=4)
        return _finish(side, fleet, [req], ref=(prompts, 4))

    inj = {"flaky_import_every": 1} if how == "flaky" else None
    obs = _run(weights, tmp_path, scenario, injector=inj)
    reg = obs["registry"]
    assert obs["same"] and obs["states"] == ["finished"]
    assert obs["leaks"] == []
    assert reg["serving/replica-1/adopt_fallbacks"] == 1
    assert reg["serving/fleet/handoffs"] == 1


def test_client_request_id_survives_failover(weights, tmp_path):
    prompts = _prompts(15, 2)

    def scenario(side):
        fleet = side.fleet({"replicas": 2})
        reqs = [fleet.submit(p, max_new_tokens=6,
                             client_request_id=f"logical-{i}")
                for i, p in enumerate(prompts)]
        for _ in range(3):
            fleet.step()
            side.sim.advance(DT)
        fleet.kill_replica("replica-0")
        side.drive(fleet, lambda: all(r.is_terminal for r in reqs))
        fleet.close(timeout=5.0)
        return side.observe(reqs, keep_crids=True)

    obs = _run(weights, tmp_path, scenario)
    finished = [r for r in obs["records"] if r["state"] == "finished"]
    assert sorted(r["client_request_id"] for r in finished) == \
        ["logical-0", "logical-1"]


def test_scale_up_and_graceful_scale_down_serves_backlog(weights, tmp_path):
    prompts = _prompts(16, 6, length=8)

    def scenario(side):
        fleet = side.fleet({"replicas": 1})
        fleet.scale_to(3)
        up = len(fleet.healthy_replicas)
        reqs = [fleet.submit(p, max_new_tokens=5) for p in prompts]
        fleet.step()
        side.sim.advance(DT)
        fleet.scale_to(1)                   # two replicas drain, serving out
        states = [r.state for r in fleet.replicas]
        side.drive(fleet, lambda: all(r.is_terminal for r in reqs))
        fleet.scale_to(1)                   # reaps the drained replicas
        return _finish(side, fleet, reqs, up=up, mid=states,
                       after=[r.state for r in fleet.replicas],
                       ref=(prompts, 5))

    obs = _run(weights, tmp_path, scenario)
    assert obs["up"] == 3 and obs["mid"].count("draining") == 2
    assert sorted(obs["after"]) == ["dead", "dead", "healthy"]
    assert obs["same"] and obs["states"] == ["finished"] * 6
    assert obs["registry"]["serving/fleet/scale_downs"] == 2


def test_autoscale_once_uses_shared_policy(weights, tmp_path):
    def scenario(side):
        fleet = side.fleet({"replicas": 1, "autoscale": True,
                            "max_replicas": 3,
                            "scale_up_queue_per_replica": 2.0,
                            "autoscale_interval_s": 1000.0})
        reqs = [fleet.submit(p, max_new_tokens=4)
                for p in _prompts(16, 6, length=8)]
        target = fleet.autoscale_once()
        n = len(fleet.healthy_replicas)
        return _finish(side, fleet, reqs, target=target, n=n)

    obs = _run(weights, tmp_path, scenario)
    assert obs["target"] == 2 and obs["n"] == 2 and obs["leaks"] == []


@pytest.mark.parametrize("pool", ["prefill", "serving"])
def test_respawn_restores_capacity(weights, tmp_path, pool):
    def scenario(side):
        if pool == "prefill":
            fleet = side.fleet({"disaggregated": True, "prefill_replicas": 1,
                                "replicas": 1, "min_replicas": 1})
        else:
            fleet = side.fleet({"replicas": 2, "min_replicas": 2})
        fleet._respawn_delay = 0.0
        fleet.kill_replica("replica-0")
        before = [(r.name, r.role, r.state) for r in fleet.replicas]
        fleet.poll()
        after = [(r.name, r.role, r.state) for r in fleet.replicas]
        req = fleet.submit(_prompts(17, 1)[0], max_new_tokens=3)
        return _finish(side, fleet, [req], before=before, after=after)

    obs = _run(weights, tmp_path, scenario)
    assert obs["registry"]["serving/fleet/respawns"] == 1
    new = obs["after"][-1]
    assert new[0] == "replica-2" and new[2] == "healthy"
    assert new[1] == ("prefill" if pool == "prefill" else "unified")


def test_block_leaks_names_the_replica(weights, tmp_path):
    def scenario(side):
        fleet = side.fleet({"replicas": 2})
        eng = fleet.replicas[1].engine
        page = eng.allocator._free.pop()
        problems = fleet.block_leaks()
        eng.allocator._free.append(page)
        fixed = fleet.block_leaks()
        fleet.close(timeout=5.0)
        return side.observe([], problems=problems, fixed=fixed)

    obs = _run(weights, tmp_path, scenario)
    assert obs["problems"] and all(p.startswith("replica-1:")
                                   for p in obs["problems"])
    assert obs["fixed"] == []


def test_rejects_with_no_healthy_replica(weights, tmp_path):
    def scenario(side):
        fleet = side.fleet({"replicas": 1, "respawn": False})
        fleet.kill_replica("replica-0")
        req = fleet.submit(_prompts(20, 1)[0], max_new_tokens=4,
                           deadline_s=1.0, client_request_id="shed-1")
        sla = fleet.in_sla_ratio()
        fleet.close(timeout=5.0)
        return side.observe([req], keep_crids=True, sla=sla)

    obs = _run(weights, tmp_path, scenario)
    assert obs["states"] == ["rejected"] and obs["sla"] == 0.0
    assert "no healthy replica" in obs["errors"][0]
    rec = obs["records"][0]
    assert rec["state"] == "rejected" and rec["in_slo"] is False


def test_drain_serves_inflight_handoffs(weights, tmp_path):
    prompts = _prompts(19, 1)

    def scenario(side):
        fleet = side.fleet({"disaggregated": True, "prefill_replicas": 1,
                            "replicas": 1})
        req = fleet.submit(prompts[0], max_new_tokens=6)
        early = fleet.drain(timeout=0.01)        # closes admission
        late = fleet.submit(prompts[0], max_new_tokens=2)
        return _finish(side, fleet, [req, late], early=early,
                       ref=(prompts, 6))

    obs = _run(weights, tmp_path, scenario)
    assert obs["early"] is False and obs["same"]
    assert obs["states"] == ["finished", "rejected"]
    assert obs["drained"] and obs["leaks"] == []


def test_cancel_in_the_adoption_pen(weights, tmp_path):
    prompts = _prompts(21, 2)

    def scenario(side):
        fleet = side.fleet({"disaggregated": True, "prefill_replicas": 1,
                            "replicas": 1})
        reqs = [fleet.submit(p, max_new_tokens=6) for p in prompts]
        prefill, decode = fleet.replicas
        for _ in range(10):                     # prefill ticks alone
            fleet.poll()
            prefill.serving._tick()
            side.sim.advance(DT)
            if decode.serving._adoptions:
                break
        penned = [reqs.index(r) for r, _ in decode.serving._adoptions]
        assert fleet.cancel(reqs[penned[0]])
        return _finish(side, fleet, reqs, penned=penned)

    obs = _run(weights, tmp_path, scenario)
    i = obs["penned"][0]
    assert obs["states"][i] == "cancelled"
    assert obs["states"][1 - i] == "finished" and obs["leaks"] == []


def test_hedge_loser_span_suppressed_and_kv_discarded(weights, tmp_path):
    """Replica-0 runs 1 of 3 busy ticks (chaos): the interactive request's
    primary there has prefilled 2 of its 3 chunks when the shadow on
    replica-1 delivers the first token. The primary is cancelled with its
    KV discarded unpublished (replica-0's prefix cache stays empty) and
    its span suppressed; the ledger holds one record per client request."""
    long, short = _prompts(22, 1, length=70)[0], _prompts(23, 1)[0]

    def scenario(side):
        fleet = side.fleet({"replicas": 2, "hedge": True,
                            "hedge_ttft_fraction": 0.5})
        side.injector.degrade_replica("replica-0", 3)
        got = []
        reqs = [fleet.submit(long, max_new_tokens=5, ttft_deadline_s=0.06,
                             client_request_id="c0", on_token=got.append),
                fleet.submit(short, max_new_tokens=5,
                             client_request_id="c1")]
        placed = _placed(fleet, reqs)
        seen = []
        primary = fleet.replicas[0].engine
        side.drive(fleet, lambda: (seen.append(
            primary.seqs[reqs[0].uid].seen if reqs[0].uid in primary.seqs
            else None) or True) and all(r.is_terminal for r in reqs)
            and not fleet._hedges)
        snap = fleet.gray_snapshot()
        side.injector.degrade_replica("replica-0", 0)
        cached = [len(r.engine.prefix_cache) for r in fleet.replicas]
        return _finish(side, fleet, reqs, keep_crids=True, placed=placed,
                       got=got, seen=max(x for x in seen if x is not None),
                       cached=cached,
                       winners=[p["winner_uid"] == p["shadow_uid"]
                                for p in snap["hedges"]],
                       total=snap["hedged_total"])

    obs = _run(weights, tmp_path, scenario, injector={})
    reg = obs["registry"]
    assert obs["placed"] == ["replica-0", "replica-1"]
    assert obs["total"] == 1 and obs["winners"] == [True]
    assert obs["seen"] == 64                    # 2 chunks of KV when cancelled
    assert obs["cached"][0] == 0                # ... discarded, unpublished
    assert reg["serving/fleet/hedges"] == 1
    assert reg["serving/fleet/hedge_losses"] == 1
    assert reg["serving/replica-0/hedge_suppressed_spans"] == 1
    assert obs["states"] == ["cancelled", "finished"]   # the primary leg
    assert obs["got"] == _reference(Side("torch", weights), [long], 5)[0]
    crids = [r["client_request_id"] for r in obs["records"]]
    assert sorted(crids) == ["c0", "c1"]         # one record per request
    assert obs["leaks"] == []


def test_watchdog_unhealthy_replica_evacuated(weights, tmp_path):
    prompts = _prompts(23, 3)

    def scenario(side):
        fleet = side.fleet({"replicas": 2, "respawn": False})
        reqs = [fleet.submit(p, max_new_tokens=5) for p in prompts]
        fleet.step()
        side.sim.advance(DT)
        victim = fleet.replicas[0]
        victim.serving._watchdog_unhealthy = True
        fleet.poll()
        healthy = [r.name for r in fleet.healthy_replicas]
        return _finish(side, fleet, reqs, healthy=healthy,
                       ref=(prompts, 5))

    obs = _run(weights, tmp_path, scenario)
    assert obs["healthy"] == ["replica-1"] and obs["same"]
    assert obs["registry"]["serving/fleet/watchdog_evacuations"] == 1


def test_canary_slice_and_spill(weights, tmp_path):
    prompts = _prompts(24, 8, length=6)

    def scenario(side):
        fleet = side.fleet({"replicas": 2})
        fleet.replicas[1].serving.model_version = 1
        fleet.set_canary(1, 0.5)
        reqs = [fleet.submit(p, max_new_tokens=3, tenant=f"t{i}",
                             deadline_s=10.0)
                for i, p in enumerate(prompts)]
        first = _placed(fleet, reqs)
        fleet.replicas[1].serving.stop_admission()   # canary side closes
        more = [fleet.submit(p, max_new_tokens=3, tenant=f"t{i}")
                for i, p in enumerate(prompts[:4])]
        spilled = [r._canary_spilled for r in reqs + more]
        side.drive(fleet, lambda: all(r.is_terminal for r in reqs + more))
        sla = [fleet.version_sla(v) for v in (0, 1)]
        counts = fleet.version_counts()
        fleet.clear_canary()
        fleet.close(timeout=5.0)
        return side.observe(reqs + more, first=first, spilled=spilled,
                            sla=sla, counts=counts)

    obs = _run(weights, tmp_path, scenario)
    assert set(obs["first"]) == {"replica-0", "replica-1"}
    assert any(obs["spilled"][8:]) and not any(obs["spilled"][:8])
    assert obs["registry"]["serving/fleet/canary_spills"] >= 1
    assert obs["counts"] == {0: 1, 1: 1}


def test_residency_router_over_kv_tier(weights, tmp_path):
    shared = _prompts(25, 1, length=24)[0]

    def scenario(side):
        fleet = side.fleet({"replicas": 2, "router": "prefix_affinity"},
                           {"kv_tier": {"enabled": True,
                                        "publish_interval_s": 0.02,
                                        "directory_staleness_s": 10.0}})
        first = fleet.submit(shared + [1, 2], max_new_tokens=3)
        side.drive(fleet, lambda: first.is_terminal)
        for _ in range(6):                  # residency publish cadence
            fleet.step()
            side.sim.advance(DT)
        reqs = [first] + [fleet.submit(shared + [3 + i], max_new_tokens=3)
                          for i in range(3)]
        placed = _placed(fleet, reqs[1:])
        return _finish(side, fleet, reqs, placed=placed,
                       router=type(fleet.router).__name__,
                       directory=fleet.kv_tier.directory.snapshot())

    obs = _run(weights, tmp_path, scenario)
    assert obs["router"] == "ResidencyAwareRouter"
    assert obs["registry"]["serving/route/residency_hit"] == 3
    assert len(set(obs["placed"])) == 1 and obs["leaks"] == []


def test_migrate_replica_moves_kv(weights, tmp_path):
    prompts = _prompts(26, 3)

    def scenario(side):
        fleet = side.fleet({"replicas": 1})
        reqs = [fleet.submit(p, max_new_tokens=8) for p in prompts]
        side.drive(fleet, lambda: all(len(r.tokens) >= 2 for r in reqs))
        ok = fleet.migrate_replica("replica-0")
        return _finish(side, fleet, reqs, ok=ok,
                       states_after=[r.state for r in fleet.replicas],
                       ref=(prompts, 8))

    obs = _run(weights, tmp_path, scenario)
    assert obs["ok"] and obs["same"]
    assert obs["states_after"] == ["dead", "healthy"]
    assert obs["registry"]["serving/fleet/migrated_kv"] == 3


# ------------------------------------------------------------------ threads
def test_fleet_threads_under_locksan_have_no_violations(weights):
    side = Side("torch", weights)
    prompts = _prompts(18, 4)
    with tlocksan.use_locksan() as san:
        fleet = ServingFleet(lambda: side.engine(),
                             {"replicas": 2, "router": "prefix_affinity",
                              "hedge": True},
                             {"stuck_tick_timeout_s": 5.0,
                              "kv_tier": {"enabled": True}},
                             start=True, device="cpu")
        try:
            streams = [list(fleet.stream(p, max_new_tokens=4))
                       for p in prompts[:2]]
            reqs = [fleet.submit(p, max_new_tokens=4) for p in prompts[2:]]
            assert all(r.result(timeout=60) for r in reqs)
            assert fleet.drain(timeout=30.0)
            leaks = fleet.block_leaks()
        finally:
            fleet.close(timeout=30.0)
    assert fleet._monitor is None and leaks == []
    assert all(r.serving._driver is None for r in fleet.replicas)
    assert san.violations == []
    assert san.acquires["ServingFleet._lock"] > 0
    assert streams + [r.tokens for r in reqs] == _reference(side, prompts, 4)


def test_fleet_defaults_to_the_card_and_checks_engine_devices(weights):
    side = Side("torch", weights)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingFleet(lambda: side.engine(), {"replicas": 1},
                         start=False)

    class OnCuda:
        device = torch.device("cuda", 0)

        class config:
            kv_block_size = 8

    with pytest.raises(ValueError, match="engine factory returned"):
        ServingFleet(lambda: OnCuda(), {"replicas": 1}, start=False,
                     device="cpu")
