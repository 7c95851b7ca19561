"""Elastic capacity planning: training batch geometry and serving
replica counts.

Ports ``deepspeed_tpu/elasticity/elasticity.py`` (host arithmetic; the port
keeps its own copy). Two consumers share one candidate-enumeration rule:

* training — the global batch size (and per-count micro-batch) valid
  across every admissible accelerator count, so a job resumes at another
  world size without changing its effective batch
  (:func:`compute_elastic_config`);
* serving — the fleet autoscaler's replica count from queue depth, in-SLA
  ratio and KV demand (:func:`compute_serving_replicas`), with a
  hysteresis band and a bounded step per decision. The policy lives here,
  not in the fleet loop.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import hashlib
import json

from ..utils.logging import log_dist


class ElasticityError(Exception):
    pass


@dataclass
class ElasticityConfig:
    """Reference elasticity config schema (elasticity/config.py):
    max_train_batch_size, micro_batch_sizes, min/max_gpus,
    prefer_larger_batch, version, ignore_non_elastic_batch_info."""

    enabled: bool = False
    max_train_batch_size: int = 2048
    micro_batch_sizes: Sequence[int] = (2, 4, 6)
    min_gpus: int = 1
    max_gpus: int = 1024
    min_time: int = 0
    prefer_larger_batch: bool = True
    version: float = 0.2
    ignore_non_elastic_batch_info: bool = False

    @classmethod
    def from_dict(cls, d: Optional[Dict]) -> "ElasticityConfig":
        if not d:
            return cls()
        return cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})


def _candidate_batches(max_batch: int, micro_batches: Sequence[int]) -> List[int]:
    """All batch sizes of the form micro * k <= max_batch (reference
    _get_candidate_batch_sizes)."""
    out = set()
    for mb in micro_batches:
        b = mb
        while b <= max_batch:
            out.add(b)
            b += mb
    return sorted(out)


def get_compatible_gpus(batch: int, micro_batches: Sequence[int],
                        min_gpus: int, max_gpus: int) -> List[int]:
    """Accelerator counts that evenly fit ``batch`` with some micro-batch
    (reference _get_compatible_gpus_v01)."""
    ok = []
    for n in range(min_gpus, max_gpus + 1):
        if any(batch % (mb * n) == 0 for mb in micro_batches):
            ok.append(n)
    return ok


def compute_elastic_config(ds_config: Dict, target_deepspeed_version: str = "",
                           world_size: int = 0,
                           return_microbatch: bool = False):
    """Pick the final batch config (reference compute_elastic_config :233).

    Returns (final_batch_size, valid_gpus[, micro_batch]) — with
    ``world_size`` > 0 also resolves the micro-batch for that size.
    """
    econf = ElasticityConfig.from_dict(ds_config.get("elasticity"))
    if not ds_config.get("elasticity"):
        raise ElasticityError("'elasticity' section missing from config")
    if not econf.enabled:
        raise ElasticityError("elasticity.enabled is false")

    best_batch, best_gpus = 0, []
    for batch in _candidate_batches(econf.max_train_batch_size,
                                    econf.micro_batch_sizes):
        gpus = get_compatible_gpus(batch, econf.micro_batch_sizes,
                                   econf.min_gpus, econf.max_gpus)
        better = (len(gpus), batch) > (len(best_gpus), best_batch) \
            if econf.prefer_larger_batch else (len(gpus), -batch) > (len(best_gpus), -best_batch)
        if gpus and better:
            best_batch, best_gpus = batch, gpus

    if not best_gpus:
        raise ElasticityError(
            f"no batch size <= {econf.max_train_batch_size} is compatible with "
            f"gpu range [{econf.min_gpus}, {econf.max_gpus}] and micro-batches "
            f"{list(econf.micro_batch_sizes)}")
    log_dist(f"elastic config: batch={best_batch} valid_gpus={best_gpus[:8]}"
             + ("..." if len(best_gpus) > 8 else ""))

    if world_size > 0:
        if world_size not in best_gpus:
            raise ElasticityError(
                f"world size {world_size} not in valid elastic gpu counts")
        micro = max(mb for mb in econf.micro_batch_sizes
                    if best_batch % (mb * world_size) == 0)
        return best_batch, best_gpus, micro
    if return_microbatch:
        return best_batch, best_gpus, None
    return best_batch, best_gpus


# ----------------------------------------------------------------------
# serving-fleet sizing (consumed by serving/fleet.py's autoscaler)

@dataclass
class ServingElasticityConfig:
    """Replica-count policy for the serving fleet autoscaler.

    ``scale_up_queue_per_replica`` is the sustained queue depth one
    replica is allowed to carry before the policy asks for more;
    ``scale_down_queue_per_replica`` is the (strictly lower) depth below
    which a replica is considered idle — the gap between the two is the
    hysteresis band that keeps the fleet from flapping. ``kv_high`` and
    ``sla_low`` are pressure overrides: a fleet whose KV pools run hot or
    whose in-SLA ratio sags grows even when the queue looks shallow
    (queue depth lags both). ``max_step`` bounds replicas added/removed
    per decision so one noisy sample can never double or halve a fleet.
    """

    min_replicas: int = 1
    max_replicas: int = 8
    scale_up_queue_per_replica: float = 8.0
    scale_down_queue_per_replica: float = 1.0
    kv_high: float = 0.85
    sla_low: float = 0.90
    max_step: int = 1

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ElasticityError(
                f"min_replicas must be >= 1, got {self.min_replicas}")
        if self.max_replicas < self.min_replicas:
            raise ElasticityError(
                f"max_replicas {self.max_replicas} < min_replicas "
                f"{self.min_replicas}")
        if self.scale_down_queue_per_replica > self.scale_up_queue_per_replica:
            raise ElasticityError(
                "scale_down_queue_per_replica must not exceed "
                "scale_up_queue_per_replica (the gap is the hysteresis band)")
        if self.max_step < 1:
            raise ElasticityError(
                f"max_step must be >= 1, got {self.max_step}")

    @classmethod
    def from_dict(cls, d: Optional[Dict]) -> "ServingElasticityConfig":
        if not d:
            return cls()
        return cls(**{k: v for k, v in d.items()
                      if k in cls.__dataclass_fields__})


def serving_replica_candidates(config: ServingElasticityConfig) -> List[int]:
    """Admissible replica counts, smallest first — the serving analog of
    ``_candidate_batches``: the policy walks these for the first count
    that absorbs the offered load."""
    return list(range(config.min_replicas, config.max_replicas + 1))


def compute_serving_replicas(current: int, *,
                             queue_depth: float,
                             kv_occupancy: float = 0.0,
                             in_sla_ratio: Optional[float] = None,
                             config: Optional[ServingElasticityConfig] = None
                             ) -> int:
    """Target replica count from live pressure signals.

    Sizing: the smallest candidate count keeping per-replica queue depth
    at or under ``scale_up_queue_per_replica``; KV or SLA pressure at the
    current size bumps the target one above ``current`` even when the
    queue looks absorbed (both signals lead the queue under bursty
    arrivals). Shrinking additionally requires the queue to sit under the
    *down* threshold at the SMALLER size — the hysteresis that keeps a
    fleet at the load boundary from oscillating. Movement per call is
    clamped to ``max_step`` and the result always lands in
    ``[min_replicas, max_replicas]``. Pure and deterministic: the fleet
    autoscaler (and its tests) call it with measured signals.
    """
    cfg = config or ServingElasticityConfig()
    current = max(cfg.min_replicas, min(cfg.max_replicas, int(current)))
    candidates = serving_replica_candidates(cfg)
    target = next((n for n in candidates
                   if queue_depth <= n * cfg.scale_up_queue_per_replica),
                  cfg.max_replicas)
    pressured = (kv_occupancy >= cfg.kv_high
                 or (in_sla_ratio is not None
                     and in_sla_ratio < cfg.sla_low))
    if pressured:
        # the bump also pins target >= current, so pressure inherently
        # vetoes shrinking — the hysteresis check below only ever sees
        # unpressured fleets
        target = max(target, min(current + 1, cfg.max_replicas))
    if target > current:
        target = min(target, current + cfg.max_step)
    elif target < current:
        # hysteresis judged at the size actually stepped to: judged at
        # the unclamped target, a single queued request (> down * 1)
        # would freeze an arbitrarily oversized fleet forever instead of
        # letting it shrink stepwise
        stepped = max(target, current - cfg.max_step)
        target = (current
                  if queue_depth > stepped * cfg.scale_down_queue_per_replica
                  else stepped)
    return max(cfg.min_replicas, min(cfg.max_replicas, target))


def elasticity_fingerprint(ds_config: Dict) -> str:
    e = ds_config.get("elasticity", {})
    return hashlib.sha256(json.dumps(e, sort_keys=True).encode()).hexdigest()


_frozen: Dict[str, str] = {}


def ensure_immutable_elastic_config(runtime_elastic_config_dict: Dict) -> None:
    """Reference :208 — the elastic config may not change once scheduled
    (resources were provisioned against it)."""
    fp = elasticity_fingerprint({"elasticity": runtime_elastic_config_dict})
    prev = _frozen.get("fp")
    if prev is not None and prev != fp:
        raise ElasticityError("elastic config changed after scheduling — "
                              "the batch contract is immutable")
    _frozen["fp"] = fp
