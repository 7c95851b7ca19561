"""The deterministic simulator: the port's ``resilience/dst.py`` held to the
JAX package's on the CPU.

One seed expands to the same schedule (``to_dict()`` equal) in both
packages, and running it through each package's own fleet or region, with
its own ``SimEngine``, clock, telemetry, tracer and fault injector, gives
the same ``trace_hash`` (every event and tick: replica and cell states,
tick counts, queue and live sizes, request states, token counts, the
brownout floor, the final streams) and the same ``span_hash`` (the
canonical trace tree), with zero invariant violations on both sides. The
seeds are the JAX suite's regression corpora plus a few plain ones.

The auditors have teeth: the JAX suite's planted bugs (a leaking engine,
dropped orphans, diverging verify rows, a leaky flip, a rollback that
never converges, double ownership after a heal, a stranded request, a
stale fleet row, a silent shed) are planted in each package and must give
the same violations. The shrinker and the repro JSON round trip run on the
port, a JAX repro replays on it hash for hash.
Tolerance: none — every comparison is exact equality.
"""

import itertools
import json

import numpy as np
import pytest

import deepspeed_tpu.resilience.chaos as jchaos
import deepspeed_tpu.resilience.dst as jdst
import deepspeed_tpu.serving.fleet as jfleet
import deepspeed_tpu.serving.region as jregion
import deepspeed_tpu.serving.request as jrequest
import deepspeed_tpu.serving.rollout as jrollout
import deepspeed_tpu_torch.resilience.chaos as tchaos
import deepspeed_tpu_torch.resilience.dst as tdst
import deepspeed_tpu_torch.serving.fleet as tfleet
import deepspeed_tpu_torch.serving.region as tregion
import deepspeed_tpu_torch.serving.request as trequest
import deepspeed_tpu_torch.serving.rollout as trollout

# tests/test_dst.py REGRESSION_SEEDS plus the plain seeds
FLEET_SEEDS = [0, 1, 2, 3, 4, 5, 7, 10, 14, 17, 23, 38, 43, 46, 47, 55, 79]
# tests/test_dst_region.py REGION_REGRESSION_SEEDS plus the plain seeds
REGION_SEEDS = [0, 3, 5, 11, 20, 30, 32, 45, 50, 51]


@pytest.fixture(autouse=True)
def _clean_slate():
    """No injector on either side, and both packages' request uids
    counted from 1 (violation messages name uids)."""
    jchaos.install_fault_injector(None)
    tchaos.install_fault_injector(None)
    for m in (jrequest, trequest):
        m._uid_counter = itertools.count(1)
    yield
    jchaos.install_fault_injector(None)
    tchaos.install_fault_injector(None)


def _same_reports(j, t):
    """The two packages' reports of one schedule agree field for field."""
    assert t.trace_hash == j.trace_hash
    assert t.span_hash == j.span_hash
    assert t.violations == j.violations
    for key in ("n_ticks", "n_events", "submitted", "finished", "cancelled",
                "rejected", "tokens", "states", "n_spans", "ttfts",
                "brownout_log"):
        assert getattr(t, key) == getattr(j, key), key


# ------------------------------------------------------------- schedules
@pytest.mark.parametrize("seed", FLEET_SEEDS + [100, 101])
def test_generate_schedule_matches(seed):
    j, t = jdst.generate_schedule(seed), tdst.generate_schedule(seed)
    assert t.to_dict() == j.to_dict()
    assert json.dumps(t.to_dict(), sort_keys=True) == \
        json.dumps(j.to_dict(), sort_keys=True)


@pytest.mark.parametrize("seed", REGION_SEEDS + [200, 201])
def test_generate_region_schedule_matches(seed):
    j = jdst.generate_region_schedule(seed)
    t = tdst.generate_region_schedule(seed)
    assert isinstance(t, tdst.RegionSchedule)
    assert t.to_dict() == j.to_dict()
    assert t.to_dict() != tdst.generate_schedule(seed).to_dict()


# ------------------------------------------------------------ hash parity
@pytest.mark.parametrize("seed", FLEET_SEEDS)
def test_run_schedule_hashes_match(seed):
    j = jdst.run_schedule(jdst.generate_schedule(seed))
    t = tdst.run_schedule(tdst.generate_schedule(seed))
    assert t.ok and j.ok, (t.violations, j.violations)
    _same_reports(j, t)
    assert t.finished + t.cancelled + t.rejected == t.submitted > 0
    # a replay in the same process gives the same hashes again
    again = tdst.run_schedule(tdst.generate_schedule(seed))
    assert (again.trace_hash, again.span_hash) == (t.trace_hash, t.span_hash)


@pytest.mark.parametrize("seed", REGION_SEEDS)
def test_run_region_schedule_hashes_match(seed):
    j = jdst.run_region_schedule(jdst.generate_region_schedule(seed))
    t = tdst.run_region_schedule(tdst.generate_region_schedule(seed))
    assert t.ok and j.ok, (t.violations, j.violations)
    _same_reports(j, t)
    assert t.finished + t.cancelled + t.rejected == t.submitted > 0
    assert set(t.gray) == set(j.gray)


@pytest.mark.parametrize("seed", [4, 23, 38])
def test_spec_on_off_identity_matches(seed):
    """Speculation forced on and off: both runs audit clean, their
    streams agree (``spec_identity_problems``), and each run's hashes
    equal the JAX package's."""
    reps = {}
    for name, m in (("jax", jdst), ("torch", tdst)):
        on, off = m.generate_schedule(seed), m.generate_schedule(seed)
        on.serving_cfg.update(speculative=True, spec_ngram=2,
                              spec_lookahead=4)
        off.serving_cfg["speculative"] = False
        reps[name] = (m.run_schedule(on), m.run_schedule(off))
    for j, t in zip(reps["jax"], reps["torch"]):
        assert t.ok, t.violations
        _same_reports(j, t)
    assert tdst.spec_identity_problems(*reps["torch"]) == []


# --------------------------------------------------------------- SimEngine
def test_sim_engine_rows_and_exports_match():
    """``put`` / ``put_spec`` rows, ``export_kv`` fields and the capacity
    queries of the two SimEngines over one script."""
    def script(m):
        eng = m.SimEngine(m.SimConfig(n_kv_blocks=12))
        rec = [eng.can_schedule([1, 2], [9, 30])]
        out = eng.put([1, 2], [[5, 6, 7, 8, 9], [3, 1, 4, 1, 5, 9]])
        rec.append(out.tolist())
        tok = [int(np.argmax(r)) for r in out]
        out, ver = eng.put_spec([1, 2], [[tok[0]], [tok[1]]],
                                [[11, 12], []])
        rec.append((out.tolist(), {u: (c, r.tolist())
                                   for u, (c, r) in ver.items()}))
        ex = eng.export_kv(2)
        rec.append(dict(ex.__dict__))
        eng.trim(1, 4)
        rec.append((eng.kv_occupancy(), eng.kv_demand(),
                    eng.blocks_needed(17), sorted(eng.seqs)))
        eng.flush([1, 2])
        rec.append((eng.allocator.free_blocks, eng._free_slots))
        return rec

    assert script(tdst) == script(jdst)
    assert str(tdst.SimEngine.device) == "cpu"


# ------------------------------------------------------- the auditors' teeth
def _leaky_engine(m):
    class Leaky(m.SimEngine):
        """discard() drops the descriptor without releasing its pages."""

        def discard(self, uid):
            seq = self.seqs.pop(uid, None)
            if seq is None:
                return
            self._free_slots.append(seq.slot)
            self._resume_uids.add(uid)

    return Leaky


def _divergent_spec_engine(m):
    class Divergent(m.SimEngine):
        """Verify rows off by one token."""

        def put_spec(self, uids, tokens, drafts):
            out, verified = super().put_spec(uids, tokens, drafts)
            bad = {}
            for uid, (chain, rows) in verified.items():
                rows = rows.copy()
                for j in range(rows.shape[0]):
                    t = int(rows[j].argmax())
                    rows[j, t] = 0.0
                    rows[j, (t + 1) % rows.shape[1]] = 1.0
                bad[uid] = (chain, rows)
            return out, bad

    return Divergent


def _both_fleet(seed, make_engine=None, **cfg):
    """The fleet schedule of ``seed`` (serving config updated by ``cfg``)
    run through each package, optionally over a planted engine."""
    out = []
    for m in (jdst, tdst):
        sched = m.generate_schedule(seed)
        sched.serving_cfg.update(cfg)
        factory = None
        if make_engine is not None:
            factory = (lambda c=make_engine(m), s=sched, m=m:
                       c(m.SimConfig(**s.engine_cfg)))
        out.append(m.run_schedule(sched, engine_factory=factory))
    return out


def test_auditor_catches_block_leak():
    j, t = _both_fleet(3, make_engine=_leaky_engine)
    assert not t.ok
    assert any("block-balance" in v or "leak" in v for v in t.violations)
    _same_reports(j, t)


def test_auditor_catches_token_identity_violation():
    j, t = _both_fleet(4, make_engine=_divergent_spec_engine,
                       speculative=True, spec_ngram=2, spec_lookahead=4,
                       spec_accept_floor=0.0)
    assert any("token-identity" in v for v in t.violations), t.violations
    _same_reports(j, t)


def test_auditor_catches_lost_requests(monkeypatch):
    for fleet in (jfleet, tfleet):
        monkeypatch.setattr(fleet.ServingFleet, "_failover_orphans",
                            lambda self, orphans, source: None)
    j, t = _both_fleet(5)
    assert any("conservation" in v or "liveness" in v
               for v in t.violations), t.violations
    _same_reports(j, t)


def _planted_regions(region, rollout, request):
    """The JAX suite's planted region-layer bugs over one package."""
    Region = region.Region
    Controller, Phase = rollout.RolloutController, rollout.RolloutPhase

    class DoubleOwn(Region):
        def _rebalance(self):
            cells = [c for c in self.cells if c.alive]
            donor = None
            for cell in cells:
                for rep in cell.fleet.replicas:
                    with rep.serving._lock:
                        if rep.serving._queue:
                            donor = (cell, rep.serving._queue[0])
                            break
                if donor:
                    break
            if donor is None:
                return
            cell, req = donor
            for other in cells:
                if other.name != cell.name and other.fleet.replicas:
                    tgt = other.fleet.replicas[0].serving
                    with tgt._lock:
                        tgt._requests[req.uid] = req
                    return

    class Strand(Region):
        def _rebalance(self):
            for cell in self.cells:
                if not cell.alive:
                    continue
                stolen = cell.fleet.steal_queued(1)
                if stolen:
                    with self._lock:
                        for req in stolen:
                            self._requests.pop(req.uid, None)
                    return

    class StaleRow(Region):
        def _on_fleet_retire(self, req):
            super()._on_fleet_retire(req)
            for cell in self.cells:
                if cell.alive:
                    with cell.fleet._lock:
                        cell.fleet._requests[req.uid] = (req,
                                                         "replica-ghost")
                    return

    class SilentShed(Region):
        def _shed_brownout(self, req, floor):
            req.error = None
            req.transition(request.RequestState.REJECTED)

    class LeakyFlipController(Controller):
        def _step_flip(self, to_version):
            flipped = False
            for fleet in self._fleets():
                for rep in fleet.healthy_replicas:
                    if rep.version != to_version:
                        with rep.serving._lock:
                            rep.serving.model_version = int(to_version)
                        flipped = True
            return "flipped" if flipped else "clean"

    class NoConvergeController(Controller):
        def _step_observing(self):
            self._begin_rollback("planted: forced regression")

        def _step_rolling_back(self):
            with self._lock:
                self._phase = Phase.ROLLED_BACK
                self._log("rolled_back", self.target_version)
                self._flip = None

    def with_controller(cls):
        class Planted(Region):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self._rollout = cls(self, self._rollout.config,
                                    self._clock)

        return Planted

    return {"double_own": DoubleOwn, "strand": Strand,
            "stale_row": StaleRow, "silent_shed": SilentShed,
            "leaky_flip": with_controller(LeakyFlipController),
            "no_converge": with_controller(NoConvergeController)}


PLANTED = {"jax": _planted_regions(jregion, jrollout, jrequest),
           "torch": _planted_regions(tregion, trollout, trequest)}


@pytest.mark.parametrize("bug,seed,marks", [
    ("leaky_flip", 4, ("version-stream",)),
    ("no_converge", 4, ("rollback-convergence",)),
    ("double_own", 48, ("double ownership", "expected exactly one owner")),
    ("strand", 30, ("conservation", "liveness")),
    ("stale_row", 48, ("stale ownership row",)),
    ("silent_shed", 17, ("shed-span", "span-ledger")),
])
def test_region_auditor_catches_planted_bug(bug, seed, marks):
    j = jdst.run_region_schedule(jdst.generate_region_schedule(seed),
                                 region_factory=PLANTED["jax"][bug])
    t = tdst.run_region_schedule(tdst.generate_region_schedule(seed),
                                 region_factory=PLANTED["torch"][bug])
    assert any(mark in v for v in t.violations for mark in marks), \
        t.violations
    _same_reports(j, t)
    # the shipped region audits clean on the same seed
    clean = tdst.run_region_schedule(tdst.generate_region_schedule(seed))
    assert clean.ok, clean.violations


# --------------------------------------------------- shrinker and repros
def test_shrinker_minimizes_to_the_triggering_pair():
    sched = tdst.generate_schedule(0)
    target = next(e.payload["target"] for e in sched.events
                  if e.kind == "cancel")

    def fails(s):
        kinds = {(e.kind, e.payload.get("ix", e.payload.get("target")))
                 for e in s.events}
        return ("submit", target) in kinds and ("cancel", target) in kinds

    shrunk = tdst.shrink_schedule(sched, fails=fails)
    assert fails(shrunk) and len(shrunk.events) == 2
    for i in range(len(shrunk.events)):
        rest = shrunk.events[:i] + shrunk.events[i + 1:]
        assert not fails(shrunk.replace_events(rest))
    with pytest.raises(ValueError):
        tdst.shrink_schedule(sched, fails=lambda s: False)


def test_shrunk_planted_leak_reproduces_from_its_repro(tmp_path):
    leaky = _leaky_engine(tdst)
    sched = tdst.generate_schedule(3)

    def fails(s):
        return bool(tdst.run_schedule(
            s, engine_factory=lambda: leaky(
                tdst.SimConfig(**s.engine_cfg))).violations)

    shrunk = tdst.shrink_schedule(sched, fails=fails)
    assert len(shrunk.events) < len(sched.events)
    path = tdst.dump_repro(shrunk, ["planted leak"],
                           str(tmp_path / "r.json"))
    loaded, viol = tdst.load_repro(path)
    assert viol == ["planted leak"] and fails(loaded)


def test_shrink_planted_double_ownership_to_minimal_repro(tmp_path):
    bug = PLANTED["torch"]["double_own"]
    sched = tdst.generate_region_schedule(48)

    def fails(s):
        return bool(tdst.run_region_schedule(
            s, region_factory=bug).violations)

    shrunk = tdst.shrink_schedule(sched, fails=fails)
    assert isinstance(shrunk, tdst.RegionSchedule) and fails(shrunk)
    kinds = [e.kind for e in shrunk.events]
    assert "heal" in kinds and "partition" in kinds and "submit" in kinds
    for i in range(len(shrunk.events)):
        rest = shrunk.events[:i] + shrunk.events[i + 1:]
        assert not fails(shrunk.replace_events(rest))
    loaded, _ = tdst.load_repro(tdst.dump_repro(
        shrunk, ["planted double ownership"], str(tmp_path / "r.json")))
    assert fails(loaded)


@pytest.mark.parametrize("region", [False, True])
def test_repro_json_round_trip_across_packages(tmp_path, region):
    """A repro the JAX package dumps loads in the port as the same
    schedule and replays to the same hashes (and back)."""
    gen = "generate_region_schedule" if region else "generate_schedule"
    run = "run_region_schedule" if region else "run_schedule"
    sched = getattr(jdst, gen)(3)
    path = jdst.dump_repro(sched, ["demo"], str(tmp_path / "j.json"),
                           timeline=[{"span": 1}])
    loaded, viol = tdst.load_repro(path)
    assert viol == ["demo"]
    assert isinstance(loaded, tdst.RegionSchedule) == region
    assert loaded.to_dict() == sched.to_dict()
    t = getattr(tdst, run)(loaded)
    j = getattr(jdst, run)(sched)
    assert (t.trace_hash, t.span_hash) == (j.trace_hash, j.span_hash)
    back = tdst.dump_repro(loaded, ["demo"], str(tmp_path / "t.json"))
    assert jdst.load_repro(back)[0].to_dict() == sched.to_dict()
