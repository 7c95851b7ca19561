"""The port's resilience seams held to the JAX package's.

* ``FaultInjector``: the same ``ChaosConfig`` and seed give identical
  decisions (returned values, raised fault types, the injection ledger,
  straggler evidence, directory lies, partitions, corrupted bytes) over a
  numpy-seeded script of hook calls, on both packages.
* ``use_locksan`` catches a planted lock-order inversion, a same-tier
  nesting and a cycle exactly as the JAX sanitizer does.
* ``PreemptionGuard`` latches a real SIGTERM into its flag and counters,
  and the restart / retry counters land in the shared registry.
* ``install_fault_injector`` binds the comm facade's chaos hook.

Tolerance: none — every comparison is exact equality.
"""

import os
import signal
import threading

import numpy as np
import pytest

import deepspeed_tpu.comm.comm as jcomm
import deepspeed_tpu.resilience.chaos as jchaos
import deepspeed_tpu.resilience.clock as jclock
import deepspeed_tpu.resilience.counters as jcounters
import deepspeed_tpu.resilience.locksan as jlocksan
import deepspeed_tpu.resilience.preemption as jpre
import deepspeed_tpu.telemetry.registry as jreg
import deepspeed_tpu_torch.comm.comm as tcomm
import deepspeed_tpu_torch.resilience.chaos as tchaos
import deepspeed_tpu_torch.resilience.clock as tclock
import deepspeed_tpu_torch.resilience.counters as tcounters
import deepspeed_tpu_torch.resilience.locksan as tlocksan
import deepspeed_tpu_torch.resilience.preemption as tpre
import deepspeed_tpu_torch.telemetry.registry as treg
from deepspeed_tpu.config import ChaosConfig as JaxChaosConfig
from deepspeed_tpu_torch.config import ChaosConfig

CHAOS = dict(enabled=True, seed=11, serving_tick_fail_at=3,
             serving_tick_fail_every=7, collective_fail_op="all_reduce",
             collective_fail_at_call=4, collective_delay_s=0.5,
             collective_delay_every=3, replica_die_at_tick=5,
             replica_die_index=1, cell_die_at_tick=9, cell_die_index=0,
             corrupt_swap_count=2, die_at_flip=2, degrade_version=1,
             flaky_import_every=3, stale_directory_every=2,
             corrupt_adopt_every=3, cold_pressure_every=4, crash_at_step=6,
             corrupt_shard_at_save=2)
OPS = ("tick", "collective", "kill_replica", "kill_cell", "swap", "flip",
       "degrade_tick", "degrade_replica", "import", "publish", "export",
       "cold_put", "step", "sever", "heal", "reachable", "save")


def _call(inj, op, rng):
    """One hook call; the outcome is what the hook returned or the name
    of the fault it raised."""
    a = int(rng.integers(0, 10))
    try:
        if op == "tick":
            return inj.on_serving_tick(a)
        if op == "collective":
            return inj.on_collective(("all_reduce", "all_gather")[a % 2])
        if op == "kill_replica":
            return inj.should_kill_replica(a % 3, a)
        if op == "kill_cell":
            return inj.should_kill_cell(a % 2, a + 5)
        if op == "swap":
            return inj.should_corrupt_swap()
        if op == "flip":
            return inj.should_die_at_flip()
        if op == "degrade_tick":
            return inj.should_degrade_tick(a % 2)
        if op == "degrade_replica":
            if a == 0:
                inj.degrade_replica("r1", 3)
            elif a == 1:
                inj.arm_stall_burst("r2", 2)
            return inj.should_degrade_replica(f"r{a % 3}")
        if op == "import":
            return inj.on_import_kv()
        if op == "publish":
            return inj.on_directory_publish(f"r{a % 3}")
        if op == "export":
            return inj.on_prefix_export()
        if op == "cold_put":
            return inj.on_cold_put()
        if op == "step":
            return inj.on_step(a)
        if op == "sever":
            return inj.sever([f"c{a % 2}"], [f"c{2 + a % 2}"])
        if op == "heal":
            return inj.heal_partitions()
        if op == "reachable":
            return inj.reachable(f"c{a % 4}", f"c{(a + 1) % 4}")
        if op == "save":
            inj.on_save_phase("before_commit", "t")
            return inj.save_count
    except BaseException as e:     # InjectedFault is a BaseException
        return type(e).__name__
    raise AssertionError(op)


def _script(inj, seed, n=400):
    rng = np.random.default_rng(seed)
    out = [(op, _call(inj, op, rng))
           for op in rng.choice(OPS, n).tolist()]
    return out, {"injected": dict(inj.injected),
                 "evidence": inj.straggler_evidence_snapshot(),
                 "stale": sorted(inj.injected_stale_snapshot()),
                 "corrupted": inj.corrupted_exports,
                 "epoch": inj.partition_epoch,
                 "partitioned": inj.partitioned,
                 "rng": inj.rng.random()}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fault_injector_decisions_match_jax(seed):
    res = []
    for chaos, clock, cfg in ((jchaos, jclock, JaxChaosConfig),
                              (tchaos, tclock, ChaosConfig)):
        with clock.use_clock(clock.SimClock()) as sim:
            inj = chaos.FaultInjector(cfg.from_dict(dict(CHAOS)))
            script, state = _script(inj, seed)
            res.append((script, state, sim.now()))
    assert res[0] == res[1]
    outcomes = {o for _, o in res[1][0]}
    # the script reaches the recoverable and the fatal fault classes
    assert {"TickFault", "RuntimeError"} <= outcomes
    assert outcomes & {"InjectedFault", "CollectiveFault"}


def test_fault_injector_from_env_and_corrupt_tag_match(tmp_path):
    env = {"DST_CHAOS": '{"enabled": true, "seed": 5, '
                        '"serving_tick_fail_every": 2, "bogus": 1}'}
    for chaos in (jchaos, tchaos):
        inj = chaos.FaultInjector.from_env(env)
        assert (inj.seed, inj.serving_tick_fail_every) == (5, 2)
        assert chaos.FaultInjector.from_env({"DST_CHAOS": ""}) is None
    corrupted = []
    for chaos in (jchaos, tchaos):
        d = tmp_path / chaos.__name__
        for i in range(4):
            (d / f"shard{i}").mkdir(parents=True)
            (d / f"shard{i}" / "data.bin").write_bytes(bytes(range(200)))
        (d / "manifest.json").write_text("{}")
        path = chaos.corrupt_tag(str(d), rng=__import__("random").Random(3))
        corrupted.append((os.path.relpath(path, d),
                          open(path, "rb").read()))
    assert corrupted[0] == corrupted[1]


def test_install_binds_the_comm_chaos_hook():
    try:
        for chaos, comm in ((jchaos, jcomm), (tchaos, tcomm)):
            inj = chaos.install_fault_injector(chaos.FaultInjector(
                collective_fail_op="all_reduce", collective_fail_at_call=1))
            assert chaos.get_fault_injector() is inj
            assert comm._CHAOS_HOOK == inj.on_collective
            assert chaos.is_reachable("a", "b")
            inj.sever(["a"], ["b"])
            assert not chaos.is_reachable("a", "b")
        # the port's facade consults the hook on a real collective call
        import torch
        with pytest.raises(tchaos.CollectiveFault):
            tcomm.all_reduce(torch.ones(2))
    finally:
        jchaos.install_fault_injector(None)
        tchaos.install_fault_injector(None)
    assert tcomm._CHAOS_HOOK is None and jcomm._CHAOS_HOOK is None


def _planted(locksan, clock):
    """Three orderings on both sanitizers: the documented order, an
    inversion (replica lock held while taking the fleet's), and a cycle
    between two undocumented locks, plus a same-tier nesting."""
    with clock.use_clock(clock.SimClock()):
        with locksan.use_locksan() as san:
            fleet = locksan.named_rlock("ServingFleet._lock")
            rep_a = locksan.named_rlock("ServingEngine._lock")
            rep_b = locksan.named_rlock("ServingEngine._lock")
            x, y = locksan.named_lock("X._lock"), locksan.named_lock("Y._lock")
            with fleet:
                with rep_a:
                    pass
            assert not san.violations
            with rep_a:
                with fleet:           # inversion
                    pass
            with rep_a:
                with rep_b:           # same-tier nesting
                    pass

            def xy():
                with x:
                    with y:
                        pass

            t = threading.Thread(target=xy)
            t.start()
            t.join()
            with y:
                with x:               # closes the cycle x -> y -> x
                    pass
        assert locksan.named_lock("Z").__class__ is type(threading.Lock())
        return [(v["kind"], {k: v[k] for k in v
                             if k not in ("thread", "vt", "kind")})
                for v in san.violations], sorted(san.edges)


def test_locksan_catches_planted_inversions_like_jax():
    j, t = _planted(jlocksan, jclock), _planted(tlocksan, tclock)
    assert j == t
    kinds = [k for k, _ in t[0]]
    assert {"order-inversion", "same-tier-nesting", "lock-cycle"} <= \
        set(kinds)
    with pytest.raises(tlocksan.LockOrderViolation):
        with tlocksan.use_locksan(strict=True):
            lock = tlocksan.named_lock("Self._lock")
            with lock:
                lock.acquire()        # self-deadlock raises, never hangs


@pytest.mark.parametrize("pre, reg", [(jpre, jreg), (tpre, treg)])
def test_preemption_guard_latches_sigterm(pre, reg):
    prev = reg.set_registry(reg.MetricsRegistry())
    try:
        seen = []
        with pre.PreemptionGuard(on_preempt=seen.append) as g:
            assert not g.should_stop
            os.kill(os.getpid(), signal.SIGTERM)
            assert g.should_stop and g.last_signal == signal.SIGTERM
        assert seen == [signal.SIGTERM]
        snap = reg.get_registry().snapshot()
        assert snap["resilience/preemptions"] == 1.0
        assert snap["resilience/preemptions/SIGTERM"] == 1.0
        manual = pre.PreemptionGuard()
        manual.request_stop()
        assert manual.should_stop
    finally:
        reg.set_registry(prev)


def test_counters_match(monkeypatch):
    monkeypatch.setenv("DST_ELASTIC_RESTART", "3")
    snaps = []
    for counters, reg in ((jcounters, jreg), (tcounters, treg)):
        prev = reg.set_registry(reg.MetricsRegistry())
        try:
            counters.record_restart(2)
            counters.record_retry("ckpt")
            counters.record_attempt("ckpt")
            counters.record_attempt("ckpt")
            counters.record_rollback()
            counters.record_emergency_save()
            counters.record_failure("io")
            assert counters.restart_count_from_env() == 3
            snaps.append(reg.get_registry().snapshot())
        finally:
            reg.set_registry(prev)
    assert snaps[0] == snaps[1] and len(snaps[1]) == 7
