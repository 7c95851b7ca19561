"""Deterministic fault injection for exercising recovery paths.

Ports ``deepspeed_tpu/resilience/chaos.py`` (host Python; the port keeps its own
copy and imports nothing of the JAX package).

Production failure modes — a SIGTERM mid-save, a torn shard, a wedged
collective — are rare and unreproducible in the wild, which makes the
recovery code that handles them the least-tested code in the stack. The
:class:`FaultInjector` turns each of them into a seeded, deterministic
event so tests (tests/test_fault_tolerance.py) and the chaos smoke loop
(scripts/chaos_smoke.py) can prove every recovery path:

* ``crash_before_commit_at_save`` / ``crash_after_commit_at_save`` — die at
  the Nth checkpoint save, on the chosen side of the atomic-rename commit
  (runtime/checkpoint.py calls :meth:`on_save_phase` at both points);
* ``corrupt_shard_at_save`` — after the Nth commit, flip bytes in a
  seeded-random file inside the committed tag (manifest verification must
  catch it on load);
* ``sigterm_at_step`` / ``crash_at_step`` — raise SIGTERM (drains through
  PreemptionGuard) or die outright before training step K;
* ``collective_fail_op`` / ``collective_delay_s`` — fail or delay facade
  collectives through the comm-facade hook (``comm.comm._CHAOS_HOOK``,
  fired at trace time where the facade records the op);
* ``serving_tick_fail_at`` / ``serving_tick_fail_every`` — fail serving
  engine ticks (:class:`TickFault`, a *recoverable* RuntimeError: the
  ServingEngine's request-level retry-or-fail path is the code under
  test, so unlike the faults above it must be catchable);
* ``replica_die_at_tick`` / ``replica_die_index`` — kill one serving
  replica of a :class:`~deepspeed_tpu_torch.serving.ServingFleet` once it has
  run N engine ticks (polled by the fleet health monitor via
  :meth:`should_kill_replica`; the fleet's failover re-queues the dead
  replica's in-flight requests on the survivors);
* ``cell_die_at_tick`` / ``cell_die_index`` — kill a whole
  :class:`~deepspeed_tpu_torch.serving.ServingCell` (correlated replica death:
  the region's failure domain goes dark at once; polled by the region
  monitor via :meth:`should_kill_cell`);
* :meth:`sever` / :meth:`heal_partitions` — a network-partition model
  over named nodes (cells plus the region front-end): routing and
  cross-cell KV hand-off consult :meth:`reachable` and fail with typed
  errors across a severed pair instead of silently succeeding in one
  process (docs/serving.md "Region & cells");
* :meth:`set_autoscaler_lag` — delays every fleet autoscaler decision by
  a fixed virtual interval (controller lag: real autoscalers observe,
  deliberate and boot capacity minutes behind the demand curve);
* gray-failure faults (serving/health.py, docs/fault_tolerance.md "Gray
  failures"): :meth:`degrade_replica` arms a per-replica k x-slowdown
  (k-1 of every k busy ticks stall — a limping-but-alive straggler),
  :meth:`arm_stall_burst` stalls a replica's next N busy ticks
  (intermittent flapping), and ``flaky_import_every`` /
  :meth:`on_import_kv` fails every Nth serving KV import with a
  *recoverable* error (the adoption-fallback requeue is the code under
  test); every injected degraded tick is booked per replica in
  ``straggler_evidence`` — the DST quarantine-convergence invariant's
  ground truth;
* rollout-targeted faults (serving/rollout.py): ``corrupt_swap_count`` /
  :meth:`should_corrupt_swap` corrupts the next N hot-swap weight loads
  (the swap must fall back to the old version and the controller must
  retry or roll back — never strand the replica), ``die_at_flip`` /
  :meth:`should_die_at_flip` kills the replica being flipped on the Nth
  drained flip, and ``degrade_version`` / :meth:`should_degrade_tick`
  stalls every other engine tick of one model version (the injected
  canary SLO regression that auto-rollback is gated on).

Faults raise :class:`InjectedFault` (a ``BaseException``) so retry helpers
and broad ``except Exception`` recovery code never swallow an injected
crash, or — with ``exit_process`` on — call ``os._exit(exit_code)`` so a
supervising ElasticAgent sees a real worker death. Every injection is
counted under ``resilience/chaos/<kind>`` in the telemetry registry.
"""

from __future__ import annotations

import json
import os
import random
import signal
import threading
from typing import Any, Dict, Optional

from ..utils.logging import logger
from .clock import get_clock

CHAOS_ENV = "DST_CHAOS"


class InjectedFault(BaseException):
    """A deliberately injected fault. Derives from BaseException so the
    retry helper (which retries OSError/RuntimeError) and defensive
    ``except Exception`` blocks can never absorb it — an injected crash
    must behave like a real one."""

    def __init__(self, kind: str):
        super().__init__(f"injected fault: {kind}")
        self.kind = kind


class CollectiveFault(InjectedFault):
    """An injected collective failure (flaky fabric simulation)."""


class TickFault(RuntimeError):
    """An injected SERVING-TICK failure. Deliberately a plain
    ``RuntimeError`` — unlike :class:`InjectedFault` — because it
    simulates the *recoverable* class of device-step errors (transient
    XLA failure, allocator hiccup) that the serving driver is REQUIRED to
    absorb: the recovery path under test is the catcher, so the fault
    must be catchable. Process-killing faults stay BaseException."""


class FaultInjector:
    """Seeded fault schedule. All ``*_at_save`` indices are 1-based save
    counts; ``*_at_step`` match the engine's ``global_steps`` value at the
    start of a ``train_batch`` call. ``-1`` disables a fault."""

    def __init__(self, config: Any = None, *,
                 seed: int = 0,
                 crash_before_commit_at_save: int = -1,
                 crash_after_commit_at_save: int = -1,
                 corrupt_shard_at_save: int = -1,
                 sigterm_at_step: int = -1,
                 crash_at_step: int = -1,
                 exit_process: bool = False,
                 exit_code: int = 113,
                 collective_fail_op: str = "",
                 collective_fail_at_call: int = -1,
                 collective_delay_s: float = 0.0,
                 collective_delay_every: int = 0,
                 serving_tick_fail_at: int = -1,
                 serving_tick_fail_every: int = 0,
                 replica_die_at_tick: int = -1,
                 replica_die_index: int = 0,
                 cell_die_at_tick: int = -1,
                 cell_die_index: int = 0,
                 autoscaler_lag_s: float = 0.0,
                 corrupt_swap_count: int = 0,
                 die_at_flip: int = -1,
                 degrade_version: int = -1,
                 flaky_import_every: int = 0,
                 stale_directory_every: int = 0,
                 corrupt_adopt_every: int = 0,
                 cold_pressure_every: int = 0):
        fields = {
            "seed": seed,
            "crash_before_commit_at_save": crash_before_commit_at_save,
            "crash_after_commit_at_save": crash_after_commit_at_save,
            "corrupt_shard_at_save": corrupt_shard_at_save,
            "sigterm_at_step": sigterm_at_step,
            "crash_at_step": crash_at_step,
            "exit_process": exit_process,
            "exit_code": exit_code,
            "collective_fail_op": collective_fail_op,
            "collective_fail_at_call": collective_fail_at_call,
            "collective_delay_s": collective_delay_s,
            "collective_delay_every": collective_delay_every,
            "serving_tick_fail_at": serving_tick_fail_at,
            "serving_tick_fail_every": serving_tick_fail_every,
            "replica_die_at_tick": replica_die_at_tick,
            "replica_die_index": replica_die_index,
            "cell_die_at_tick": cell_die_at_tick,
            "cell_die_index": cell_die_index,
            "autoscaler_lag_s": autoscaler_lag_s,
            "corrupt_swap_count": corrupt_swap_count,
            "die_at_flip": die_at_flip,
            "degrade_version": degrade_version,
            "flaky_import_every": flaky_import_every,
            "stale_directory_every": stale_directory_every,
            "corrupt_adopt_every": corrupt_adopt_every,
            "cold_pressure_every": cold_pressure_every,
        }
        for name, default in fields.items():
            setattr(self, name,
                    getattr(config, name, default) if config is not None
                    else default)
        self.rng = random.Random(self.seed)
        self.save_count = 0
        self.injected: Dict[str, int] = {}
        self._collective_calls: Dict[str, int] = {}
        # rollout-fault state: drained-flip ordinal counter (1-based,
        # counted only while die_at_flip is armed) and the degraded
        # version's tick parity counter
        self._flip_calls = 0
        self._degrade_calls = 0
        # gray-failure state (docs/fault_tolerance.md "Gray failures"):
        # per-replica k x-slowdowns (name -> k, with a per-name busy-tick
        # counter: k-1 of every k busy ticks stall), finite stall bursts
        # (name -> remaining stalled ticks), the flaky-import call
        # counter, and the per-replica ledger of injected degraded ticks
        # — the DST quarantine-convergence invariant's evidence stream
        self._degrade_replicas: Dict[str, int] = {}
        self._degrade_replica_calls: Dict[str, int] = {}
        self._stall_bursts: Dict[str, int] = {}
        self._import_calls = 0
        self.straggler_evidence: Dict[str, int] = {}
        # global-KV-tier fault state (docs/serving.md "Global KV tier"):
        # publish/export/cold-put call counters for the every-Nth knobs,
        # plus the ground-truth ledgers the DST auditor reads — the set
        # of (member, hash) directory lies currently injected (so the
        # entries-never-outlive-pages invariant can exempt them) and the
        # count of corrupted exports produced (every one must be caught
        # by the importer's checksum — none may land)
        self._directory_publishes = 0
        self._prefix_exports = 0
        self._cold_puts = 0
        self.injected_stale: set = set()
        self.corrupted_exports = 0
        # active network partitions: (group_a, group_b) name sets. Nodes
        # in different groups of any active partition cannot reach each
        # other; nodes a partition does not mention are unaffected by it.
        self._partitions: List[Tuple[frozenset, frozenset]] = []
        # bumped on every sever/heal so observers (the region monitor)
        # can detect connectivity changes without diffing group sets
        self.partition_epoch = 0
        # the injector is polled from fleet/region monitor threads while
        # the driving thread arms faults and severs partitions: the
        # injection ledger and partition list are shared state — one
        # small mutex covers both
        self._mu = threading.Lock()

    # ------------------------------------------------------------------
    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None) -> Optional["FaultInjector"]:
        """Build from the ``DST_CHAOS`` env var (a JSON object of the
        constructor's keyword fields), or None when unset/empty. This is
        how a supervised worker process (scripts/chaos_smoke.py) receives
        its fault schedule."""
        raw = (env if env is not None else os.environ).get(CHAOS_ENV, "")
        if not raw.strip():
            return None
        try:
            spec = json.loads(raw)
        except json.JSONDecodeError as e:
            logger.warning(f"{CHAOS_ENV} is not valid JSON ({e}); chaos disabled")
            return None
        if not isinstance(spec, dict):
            logger.warning(f"{CHAOS_ENV} must be a JSON object; chaos disabled")
            return None
        # accept (and strip) the config block's master switch so a raw
        # ChaosConfig dict can be exported into DST_CHAOS verbatim
        if not spec.pop("enabled", True):
            return None
        # unknown keys degrade like every other malformed input — warn and
        # drop, never TypeError a supervised worker into a restart storm
        known = {"seed", "crash_before_commit_at_save",
                 "crash_after_commit_at_save", "corrupt_shard_at_save",
                 "sigterm_at_step", "crash_at_step", "exit_process",
                 "exit_code", "collective_fail_op",
                 "collective_fail_at_call", "collective_delay_s",
                 "collective_delay_every", "serving_tick_fail_at",
                 "serving_tick_fail_every", "replica_die_at_tick",
                 "replica_die_index", "cell_die_at_tick",
                 "cell_die_index", "autoscaler_lag_s",
                 "corrupt_swap_count", "die_at_flip", "degrade_version",
                 "flaky_import_every", "stale_directory_every",
                 "corrupt_adopt_every", "cold_pressure_every"}
        unknown = set(spec) - known
        if unknown:
            logger.warning(f"{CHAOS_ENV}: ignoring unknown keys {sorted(unknown)}")
        return cls(**{k: v for k, v in spec.items() if k in known})

    # ------------------------------------------------------------------
    def _count(self, kind: str) -> None:
        with self._mu:
            self.injected[kind] = self.injected.get(kind, 0) + 1
        self._record_injection(kind)

    def _record_injection(self, kind: str) -> None:
        """Telemetry/flight side effects of an injection — OUTSIDE
        ``_mu`` (the registry and recorder take their own locks)."""
        from ..telemetry.registry import get_registry

        get_registry().counter(f"resilience/chaos/{kind}").inc()
        # injected faults land in the flight recorder's black box too,
        # so a post-mortem dump shows the injection next to its fallout
        from ..telemetry.tracing import get_tracer

        tracer = get_tracer()
        if tracer.enabled:
            tracer.flight.note("injected_fault", fault=kind)

    def _crash(self, kind: str) -> None:
        self._count(kind)
        logger.warning(f"chaos: injecting crash '{kind}'")
        if self.exit_process:
            # flush logging before dying like a kill -9'd worker would
            os._exit(self.exit_code)
        raise InjectedFault(kind)

    # ------------------------------------------------------------------
    # hooks (called by checkpoint engine / train engine / comm facade)
    def on_save_phase(self, phase: str, tag: str) -> None:
        if phase == "before_commit":
            self.save_count += 1
            if self.save_count == self.crash_before_commit_at_save:
                self._crash("crash_before_commit")
        elif phase == "after_commit":
            if self.save_count == self.crash_after_commit_at_save:
                self._crash("crash_after_commit")

    def maybe_corrupt(self, tag_path: str) -> bool:
        """Flip bytes in one seeded-random file of a committed tag.
        Returns True when corruption was injected (the checkpoint engine
        must not mark such a tag as verified)."""
        if self.save_count != self.corrupt_shard_at_save:
            return False
        corrupt_tag(tag_path, rng=self.rng)
        self._count("corrupt_shard")
        return True

    def on_step(self, step: int) -> None:
        if step == self.sigterm_at_step:
            self._count("sigterm_at_step")
            logger.warning(f"chaos: raising SIGTERM at step {step}")
            signal.raise_signal(signal.SIGTERM)
        if step == self.crash_at_step:
            self._crash("crash_at_step")

    def on_serving_tick(self, tick: int) -> None:
        """Fail serving ticks: at exactly ``serving_tick_fail_at``
        (1-based tick count) and/or every ``serving_tick_fail_every``-th
        tick. Raises :class:`TickFault` — the recoverable class: the
        serving driver's retry-or-fail path is the code under test."""
        if (tick == self.serving_tick_fail_at
                or (self.serving_tick_fail_every > 0
                    and tick % self.serving_tick_fail_every == 0)):
            self._count("serving_tick_fail")
            logger.warning(f"chaos: failing serving tick {tick}")
            raise TickFault(f"injected serving tick fault at tick {tick}")

    def should_kill_replica(self, replica_index: int, ticks: int) -> bool:
        """Injected serving-replica death: True once, for the replica
        whose index matches ``replica_die_index``, as soon as it has run
        ``replica_die_at_tick`` engine ticks (>= 0 enables). The fleet's
        health monitor polls this and performs the actual kill+failover —
        death is a FLEET-level event (the whole replica process/host is
        gone), not a per-tick fault the ServingEngine could retry."""
        if self.replica_die_at_tick < 0:
            return False
        if replica_index != self.replica_die_index:
            return False
        if ticks < self.replica_die_at_tick:
            return False
        with self._mu:
            # one-shot check AND ledger flip in the same mutex section:
            # split, two monitor threads could both pass the check and
            # double-kill a single configured death
            if self.injected.get("replica_death"):
                return False
            self.injected["replica_death"] = 1
        self._record_injection("replica_death")
        logger.warning(
            f"chaos: killing serving replica {replica_index} at tick {ticks}")
        return True

    def should_kill_cell(self, cell_index: int, ticks: int) -> bool:
        """Injected whole-cell outage: True once, for the cell whose
        index matches ``cell_die_index``, as soon as any of its replicas
        has run ``cell_die_at_tick`` engine ticks (>= 0 enables). The
        region's monitor polls this and performs the kill + cross-cell
        failover — a cell outage is a REGION-level event (the entire
        failure domain went dark: power, ToR switch, pod), the one-tier-
        up analog of :meth:`should_kill_replica`."""
        if self.cell_die_at_tick < 0:
            return False
        if cell_index != self.cell_die_index:
            return False
        if ticks < self.cell_die_at_tick:
            return False
        with self._mu:
            # same atomic check-and-flip as should_kill_replica
            if self.injected.get("cell_outage"):
                return False
            self.injected["cell_outage"] = 1
        self._record_injection("cell_outage")
        logger.warning(
            f"chaos: killing serving cell {cell_index} at tick {ticks}")
        return True

    # -- network partitions ---------------------------------------------
    def sever(self, group_a, group_b) -> None:
        """Partition the network between two named node groups (cell
        names, plus ``\"region\"`` for the front-end itself). Active
        until :meth:`heal_partitions`. Groups must be disjoint."""
        a, b = frozenset(map(str, group_a)), frozenset(map(str, group_b))
        if not a or not b:
            raise ValueError("partition groups must be non-empty")
        if a & b:
            raise ValueError(f"partition groups overlap: {sorted(a & b)}")
        with self._mu:
            self._partitions = self._partitions + [(a, b)]
            self.partition_epoch += 1
        self._count("partition")
        logger.warning(f"chaos: partition {sorted(a)} | {sorted(b)}")

    def heal_partitions(self) -> None:
        """Heal every active partition (connectivity restored at once)."""
        with self._mu:
            if not self._partitions:
                return
            self._partitions = []
            self.partition_epoch += 1
        self._count("partition_heal")
        logger.warning("chaos: all partitions healed")

    @property
    def partitioned(self) -> bool:
        with self._mu:
            return bool(self._partitions)

    def reachable(self, a: str, b: str) -> bool:
        """False when any active partition separates ``a`` from ``b``."""
        with self._mu:
            parts = self._partitions    # rebound on sever/heal, never
        for ga, gb in parts:            # mutated: safe to scan unlocked
            if (a in ga and b in gb) or (a in gb and b in ga):
                return False
        return True

    def set_autoscaler_lag(self, lag_s: float) -> None:
        """Delay every autoscaler decision by ``lag_s`` (virtual)
        seconds — fleets add it to their decision interval, so demand
        runs ahead of capacity exactly like a real control loop lags."""
        if lag_s < 0:
            raise ValueError(f"autoscaler lag must be >= 0, got {lag_s}")
        self.autoscaler_lag_s = float(lag_s)
        self._count("autoscaler_lag")
        logger.warning(f"chaos: autoscaler decisions lagged by {lag_s}s")

    # -- rollout faults (serving/rollout.py) -----------------------------
    def arm_corrupt_swap(self, n: int = 1) -> None:
        """Arm corruption of the next ``n`` hot-swap weight loads."""
        with self._mu:
            self.corrupt_swap_count = max(0, int(n))
        logger.warning(f"chaos: next {n} hot-swap weight loads corrupt")

    def should_corrupt_swap(self) -> bool:
        """Injected corrupt new-version checkpoint, consumed one arm per
        call. The hot-swap path must fall back to the OLD weights and
        report failure — the replica keeps serving its current version,
        never stranded half-swapped."""
        with self._mu:
            if self.corrupt_swap_count <= 0:
                return False
            self.corrupt_swap_count -= 1
        self._count("corrupt_swap")
        logger.warning("chaos: corrupting hot-swap weight load")
        return True

    def arm_flip_death(self, ordinal: int = 1) -> None:
        """Kill the replica being flipped on the ``ordinal``-th (1-based)
        drained flip attempted from now on; -1 disarms."""
        with self._mu:
            self.die_at_flip = int(ordinal)
            self._flip_calls = 0
        logger.warning(f"chaos: armed replica death at flip #{ordinal}")

    def should_die_at_flip(self) -> bool:
        """Injected replica death mid-flip: True exactly once, when the
        rollout controller attempts its ``die_at_flip``-th drained flip.
        The controller must re-target the flip (or roll back), never
        wedge on the corpse."""
        with self._mu:
            if self.die_at_flip < 1:
                return False
            # ordinal equality is the one-shot: counted only while armed
            self._flip_calls += 1
            if self._flip_calls != self.die_at_flip:
                return False
        self._count("flip_death")
        logger.warning("chaos: killing replica mid-flip")
        return True

    def degrade_model_version(self, version: int) -> None:
        """Arm the injected canary SLO regression: every other engine
        tick of replicas serving ``version`` makes no scheduling progress
        (virtual time still advances), so the canary's in-SLA window
        regresses ORGANICALLY while its work still completes — the
        auto-rollback drain must be able to finish. -1 disarms."""
        with self._mu:
            self.degrade_version = int(version)
            self._degrade_calls = 0
        if int(version) >= 0:
            self._count("canary_degrade")
            logger.warning(f"chaos: degrading model version {version} "
                           f"(every other tick stalls)")

    def should_degrade_tick(self, version: int) -> bool:
        """Whether THIS engine tick of a replica serving ``version``
        should stall (see :meth:`degrade_model_version`)."""
        with self._mu:
            if self.degrade_version < 0 or version != self.degrade_version:
                return False
            self._degrade_calls += 1
            return self._degrade_calls % 2 == 0

    # -- gray-failure faults (serving/health.py) -------------------------
    def degrade_replica(self, name: str, k: int) -> None:
        """Arm a k x-slowdown of one named replica: k-1 of every k of its
        busy engine ticks stall (virtual time advances, no scheduling
        progress), so the replica limps at 1/k throughput while passing
        every binary health check — the canonical gray failure the
        quarantine plane must detect. ``k < 2`` disarms."""
        k = int(k)
        with self._mu:
            if k < 2:
                self._degrade_replicas.pop(str(name), None)
            else:
                self._degrade_replicas[str(name)] = k
                self._degrade_replica_calls.setdefault(str(name), 0)
        if k >= 2:
            self._count("degraded_tick_armed")
            logger.warning(f"chaos: replica {name} degraded {k}x "
                           f"({k - 1} of every {k} busy ticks stall)")

    def arm_stall_burst(self, name: str, n: int) -> None:
        """Arm an intermittent stall burst: the named replica's next
        ``n`` busy engine ticks stall outright, then it runs clean —
        the flapping-straggler pattern hysteresis is gated on."""
        with self._mu:
            self._stall_bursts[str(name)] = (
                self._stall_bursts.get(str(name), 0) + max(0, int(n)))
        self._count("stall_burst_armed")
        logger.warning(f"chaos: replica {name} stall burst of {n} ticks")

    def should_degrade_replica(self, name: Optional[str]) -> bool:
        """Whether THIS busy engine tick of replica ``name`` should
        stall (burst arms drain first, then the k x-slowdown parity).
        Every True is booked as straggler evidence against the replica —
        the DST quarantine-convergence invariant's ground truth."""
        if name is None:
            return False
        name = str(name)
        kind = None
        with self._mu:
            if self._stall_bursts.get(name, 0) > 0:
                self._stall_bursts[name] -= 1
                kind = "stall_burst"
            else:
                k = self._degrade_replicas.get(name)
                if k:
                    calls = self._degrade_replica_calls.get(name, 0) + 1
                    self._degrade_replica_calls[name] = calls
                    if calls % k != 0:
                        kind = "degraded_tick"
            if kind is not None:
                self.straggler_evidence[name] = (
                    self.straggler_evidence.get(name, 0) + 1)
        if kind is None:
            return False
        self._count(kind)
        return True

    def on_import_kv(self) -> None:
        """Flaky KV-import hook (serving adoption / disaggregated
        hand-off): every ``flaky_import_every``-th call raises a
        recoverable RuntimeError — the importer's fallback path (requeue
        and re-prefill) is the code under test, so the fault must be
        catchable, exactly like :class:`TickFault`."""
        if self.flaky_import_every <= 0:
            return
        with self._mu:
            self._import_calls += 1
            hit = self._import_calls % self.flaky_import_every == 0
        if hit:
            self._count("flaky_import")
            raise RuntimeError("chaos: injected flaky KV import")

    def on_directory_publish(self, member: str) -> Optional[int]:
        """Stale-directory-entry hook (global KV tier): every
        ``stale_directory_every``-th residency publish returns a bogus
        prefix hash for the publisher to ALSO claim — a directory lie
        (no pages back it). The (member, hash) pair is remembered in
        ``injected_stale`` as the DST auditor's exemption ground truth;
        routing must treat the lie as any other stale entry (fall back
        to the affinity ring / local prefill, never wedge)."""
        if self.stale_directory_every <= 0:
            return None
        with self._mu:
            self._directory_publishes += 1
            hit = (self._directory_publishes
                   % self.stale_directory_every == 0)
            if hit:
                # deterministic bogus hash: derived from the publish
                # ordinal so replays inject the identical lie
                bogus = (0xDEAD0000_00000000
                         | (self._directory_publishes & 0xFFFFFFFF))
                self.injected_stale.add((member, bogus))
        if not hit:
            return None
        self._count("stale_directory")
        return bogus

    def on_prefix_export(self) -> bool:
        """Adoption-wire-corruption hook (global KV tier): every
        ``corrupt_adopt_every``-th prefix export should have its wire
        content corrupted AFTER the checksum is stamped. Returns True
        when the caller must corrupt; ``corrupted_exports`` counts the
        ground truth for the none-may-land invariant (#19)."""
        if self.corrupt_adopt_every <= 0:
            return False
        with self._mu:
            self._prefix_exports += 1
            hit = self._prefix_exports % self.corrupt_adopt_every == 0
            if hit:
                self.corrupted_exports += 1
        if hit:
            self._count("corrupt_adopt")
        return hit

    def on_cold_put(self) -> bool:
        """Cold-tier-pressure hook (global KV tier): every
        ``cold_pressure_every``-th cold-tier admission is dropped —
        the evicted prefix is simply lost to the cold tier (host under
        memory pressure) and later demand re-prefills. Returns True
        when the put must be dropped."""
        if self.cold_pressure_every <= 0:
            return False
        with self._mu:
            self._cold_puts += 1
            hit = self._cold_puts % self.cold_pressure_every == 0
        if hit:
            self._count("cold_pressure")
        return hit

    def injected_stale_snapshot(self) -> set:
        """The (member, bogus-hash) directory lies currently injected."""
        with self._mu:
            return set(self.injected_stale)

    def straggler_evidence_snapshot(self) -> Dict[str, int]:
        """Per-replica count of injected degraded/stalled busy ticks."""
        with self._mu:
            return dict(self.straggler_evidence)

    def on_collective(self, op: str) -> None:
        n = self._collective_calls.get(op, 0) + 1
        self._collective_calls[op] = n
        if (self.collective_delay_s > 0 and self.collective_delay_every > 0
                and n % self.collective_delay_every == 0):
            self._count(f"collective_delay/{op}")
            # through the injectable clock: under a SimClock the delay
            # advances virtual time instead of stalling the soak host
            get_clock().sleep(self.collective_delay_s)
        if op == self.collective_fail_op and n == self.collective_fail_at_call:
            self._count(f"collective_fail/{op}")
            raise CollectiveFault(f"collective_fail:{op}")


def corrupt_tag(tag_path: str, rng: Optional[random.Random] = None) -> str:
    """XOR-flip 64 bytes in the middle of one (seeded-random) data file of
    a checkpoint tag. Returns the corrupted file's path. Standalone so
    tests can corrupt without a full injector."""
    rng = rng or random.Random(0)
    candidates = []
    for dirpath, _d, filenames in os.walk(tag_path):
        for name in filenames:
            full = os.path.join(dirpath, name)
            # corrupt payload, not the protocol files that detect it
            if name in ("COMMITTED", "manifest.json"):
                continue
            if os.path.getsize(full) > 0:
                candidates.append(full)
    if not candidates:
        raise ValueError(f"no corruptible files under {tag_path}")
    target = rng.choice(sorted(candidates))
    size = os.path.getsize(target)
    off = max(0, size // 2 - 32)
    with open(target, "r+b") as f:
        f.seek(off)
        chunk = f.read(min(64, size - off))
        f.seek(off)
        f.write(bytes(b ^ 0xFF for b in chunk))
    logger.warning(f"chaos: corrupted {target} at offset {off}")
    return target


# ----------------------------------------------------------------------
_INJECTOR: Optional[FaultInjector] = None


def get_fault_injector() -> Optional[FaultInjector]:
    return _INJECTOR


def is_reachable(a: str, b: str) -> bool:
    """Whether nodes ``a`` and ``b`` can reach each other under the
    installed injector's partition model (always True with no injector:
    chaos off means the network is whole). The region/cell layer's one
    connectivity oracle — routing, cross-cell hand-off and KV adoption
    all consult it so a severed pair fails TYPED, never silently."""
    inj = _INJECTOR
    return True if inj is None else inj.reachable(a, b)


def install_fault_injector(inj: Optional[FaultInjector]) -> Optional[FaultInjector]:
    """Install ``inj`` process-globally (None to clear) and point the comm
    facade's chaos hook at it."""
    global _INJECTOR
    _INJECTOR = inj
    from ..comm import comm as comm_mod

    comm_mod._CHAOS_HOOK = inj.on_collective if inj is not None else None
    return inj
