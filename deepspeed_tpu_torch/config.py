"""Configuration of the port.

Ports the parts of ``deepspeed_tpu/config.py`` that the ported paths read:

* :class:`ServingConfig` (the ``serving`` block of the serving front-end,
  speculative serving and ``kv_quant`` included). Keys of features that
  later slices port (model versions, the stuck-tick watchdog, fleet /
  region / rollout / KV-tier blocks) raise ``NotImplementedError`` when
  set to anything but their "off" value, instead of being silently
  ignored.
* :class:`Config` for the trainer: the batch triple and its resolution
  over the data-parallel world, ``gradient_clipping``, ``steps_per_print``
  and the ``optimizer`` / ``scheduler`` / ``fp16`` / ``bf16`` blocks; the
  ``zero_optimization`` block for stages 0 and 3 (:class:`ZeroConfig`),
  ``comm_compression`` (:class:`CommCompressionConfig`) and ``mesh`` with
  the ``data`` axis, with the same keys, defaults and checks. ``seed`` is
  not read: the port's models hold their weights from their own seed
  (``Llama(..., seed=...)``), so the key gets the unknown-key warning.
  Settings of later slices (ZeRO stages 1-2, hpZ, MiCS, offload, mesh
  axes other than ``data``, pipelining, telemetry, checkpoint saving,
  resilience) raise :class:`ConfigError` naming that slice; other unknown
  keys warn.
"""

from __future__ import annotations

import copy
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Union

import torch

from .utils.logging import logger

AUTO = "auto"


class ConfigError(ValueError):
    pass


def _take(d: Dict[str, Any], key: str, default: Any) -> Any:
    v = d.pop(key, default)
    return default if v is None else v


def _warn_unknown(d: Dict[str, Any], section: str) -> None:
    for k in d:
        logger.warning(f"Unknown config key '{k}' in section '{section}' "
                       f"— ignored")


@dataclass
class OptimizerConfig:
    """The ``optimizer`` block."""

    type: str = "adamw"
    params: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "OptimizerConfig":
        if not d:
            return cls()
        d = dict(d)
        out = cls(type=str(_take(d, "type", "adamw")).lower(),
                  params=dict(_take(d, "params", {})))
        _warn_unknown(d, "optimizer")
        return out


@dataclass
class SchedulerConfig:
    """The ``scheduler`` block."""

    type: Optional[str] = None
    params: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "SchedulerConfig":
        if not d:
            return cls()
        d = dict(d)
        out = cls(type=_take(d, "type", None),
                  params=dict(_take(d, "params", {})))
        _warn_unknown(d, "scheduler")
        return out


@dataclass
class FP16Config:
    """The ``fp16`` block with its dynamic loss-scaling knobs
    (``loss_scale`` 0 means dynamic)."""

    enabled: bool = False
    loss_scale: float = 0.0
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    min_loss_scale: float = 1.0
    consecutive_hysteresis: bool = False

    @property
    def dynamic_loss_scale(self) -> bool:
        return self.loss_scale == 0

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "FP16Config":
        if not d:
            return cls()
        d = dict(d)
        out = cls(
            enabled=bool(_take(d, "enabled", False)),
            loss_scale=float(_take(d, "loss_scale", 0.0)),
            initial_scale_power=int(_take(d, "initial_scale_power", 16)),
            loss_scale_window=int(_take(d, "loss_scale_window", 1000)),
            hysteresis=int(_take(d, "hysteresis", 2)),
            min_loss_scale=float(_take(d, "min_loss_scale", 1.0)),
            consecutive_hysteresis=bool(_take(d, "consecutive_hysteresis",
                                              False)),
        )
        d.pop("auto_cast", None)
        d.pop("fp16_master_weights_and_grads", None)
        _warn_unknown(d, "fp16")
        return out


@dataclass
class BF16Config:
    enabled: bool = False

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "BF16Config":
        if not d:
            return cls()
        d = dict(d)
        out = cls(enabled=bool(_take(d, "enabled", False)))
        d.pop("immediate_grad_update", None)
        _warn_unknown(d, "bf16")
        return out


def _later_slice(key: str, value: Any, where: str = "ROADMAP.md, Queue A"
                 ) -> None:
    raise ConfigError(
        f"config '{key}' = {value!r} turns on a feature that comes with a "
        f"later slice of deepspeed_tpu_torch ({where})")


# reference zero_optimization knobs that do not change what the port runs
# (bucket sizes, prefetch and liveness limits of the hook machinery)
_INERT_ZERO_KEYS = (
    "allgather_partitions", "allgather_bucket_size", "overlap_comm",
    "reduce_scatter", "reduce_bucket_size", "contiguous_gradients",
    "sub_group_size", "stage3_max_live_parameters",
    "stage3_max_reuse_distance", "stage3_prefetch_bucket_size",
    "stage3_gather_16bit_weights_on_model_save", "round_robin_gradients",
    "ignore_unused_parameters", "cpu_offload", "cpu_offload_params",
    "load_from_fp32_weights", "elastic_checkpoint",
    "zero_quantized_nontrainable_weights", "memory_efficient_linear",
    "param_persistence_threshold", "model_persistence_threshold",
    "max_live_parameters", "max_reuse_distance", "prefetch_bucket_size",
    "gather_16bit_weights_on_model_save", "use_multi_rank_bucket_allreduce",
    "legacy_stage1", "mics_hierarchical_params_gather")


@dataclass
class ZeroConfig:
    """The ``zero_optimization`` block. Stage 0 (one device) and stage 3
    (parameters, gradients and optimizer state sharded over the ``data``
    axis, trained through the staged block schedule) are ported; stages 1
    and 2, hpZ (``zero_hpz_partition_size`` > 1), MiCS and offload raise
    :class:`ConfigError` naming their slice (ROADMAP.md, Queue A item 12)."""

    stage: int = 0
    stage3_param_persistence_threshold: int = 10_000
    zero_quantized_weights: bool = False
    zero_quantized_gradients: bool = False

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "ZeroConfig":
        if not d:
            return cls()
        d = dict(d)
        where = "ROADMAP.md, Queue A item 12"
        out = cls(
            stage=int(_take(d, "stage", 0)),
            stage3_param_persistence_threshold=int(float(_take(
                d, "stage3_param_persistence_threshold", 10_000))),
            zero_quantized_weights=bool(_take(d, "zero_quantized_weights",
                                              False)),
            zero_quantized_gradients=bool(_take(
                d, "zero_quantized_gradients", False)),
        )
        if out.stage not in (0, 1, 2, 3):
            raise ConfigError(f"zero_optimization.stage must be 0..3, got "
                              f"{out.stage}")
        if out.stage in (1, 2):
            _later_slice("zero_optimization.stage", out.stage, where)
        hpz = int(_take(d, "zero_hpz_partition_size", 1))
        if hpz > 1:
            _later_slice("zero_optimization.zero_hpz_partition_size", hpz,
                         where)
        mics = int(_take(d, "mics_shard_size", -1))
        if mics > 0:
            _later_slice("zero_optimization.mics_shard_size", mics, where)
        for key in ("offload_param", "offload_optimizer"):
            dev = (_take(d, key, None) or {}).get("device", "none")
            if dev not in (None, "none"):
                _later_slice(f"zero_optimization.{key}.device", dev, where)
        for k in _INERT_ZERO_KEYS:
            d.pop(k, None)
        _warn_unknown(d, "zero_optimization")
        return out


@dataclass
class CommCompressionConfig:
    """The ``comm_compression`` block of the compressed-collective facade
    (``comm/compressed.py``), with the JAX package's keys, defaults and
    checks: ``enabled`` is ``"auto"`` (on when the data-parallel group
    reaches ``mesh_size_threshold`` ranks), ``true`` or ``false``; the
    weight (qwZ) and gradient (qgZ) hops' bits and blocks; ``overlap``
    (``"staged"``, ``"serial"`` or ``"off"``) picks the block schedule's
    issue order; ``error_stats`` adds ``quant_rel_err`` to the step
    metrics; ``kernel_backend`` is ``"auto"``, ``"xla"`` (the unfused
    reference) or ``"pallas"`` (the fused CUDA kernels; see
    ``comm/backends.py``)."""

    enabled: Any = "auto"
    mesh_size_threshold: int = 16
    weight_bits: int = 8
    weight_block: int = 256
    grad_bits: int = 8
    grad_block: int = 256
    overlap: str = "staged"
    error_stats: bool = False
    kernel_backend: str = "auto"

    def resolve_enabled(self, dp_size: int) -> bool:
        if isinstance(self.enabled, bool):
            return self.enabled
        return dp_size >= self.mesh_size_threshold

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]
                  ) -> "CommCompressionConfig":
        if not d:
            return cls()
        d = dict(d)
        enabled = _take(d, "enabled", "auto")
        if not isinstance(enabled, bool):
            if str(enabled).lower() != "auto":
                raise ConfigError(
                    f"comm_compression.enabled must be true/false/'auto', "
                    f"got {enabled!r}")
            enabled = "auto"
        out = cls(
            enabled=enabled,
            mesh_size_threshold=int(_take(d, "mesh_size_threshold", 16)),
            weight_bits=int(_take(d, "weight_bits", 8)),
            weight_block=int(_take(d, "weight_block", 256)),
            grad_bits=int(_take(d, "grad_bits", 8)),
            grad_block=int(_take(d, "grad_block", 256)),
            overlap=str(_take(d, "overlap", "staged")),
            error_stats=bool(_take(d, "error_stats", False)),
            kernel_backend=str(_take(d, "kernel_backend", "auto")),
        )
        for name, bits in (("weight_bits", out.weight_bits),
                           ("grad_bits", out.grad_bits)):
            if bits not in (4, 8):
                raise ConfigError(
                    f"comm_compression.{name} must be 4 or 8, got {bits}")
        for name, block in (("weight_block", out.weight_block),
                            ("grad_block", out.grad_block)):
            if block <= 0 or block % 2:
                raise ConfigError(
                    f"comm_compression.{name} must be positive and even, "
                    f"got {block}")
        if out.overlap not in ("staged", "serial", "off"):
            raise ConfigError(
                f"comm_compression.overlap must be 'staged', 'serial' or "
                f"'off', got '{out.overlap}'")
        if out.mesh_size_threshold < 1:
            raise ConfigError(
                f"comm_compression.mesh_size_threshold must be >= 1, got "
                f"{out.mesh_size_threshold}")
        if out.kernel_backend not in ("auto", "xla", "pallas"):
            raise ConfigError(
                f"comm_compression.kernel_backend must be 'auto', 'xla' or "
                f"'pallas', got '{out.kernel_backend}'")
        _warn_unknown(d, "comm_compression")
        return out


def _mesh_from_dict(d: Optional[Dict[str, Any]]) -> Dict[str, int]:
    """The ``mesh`` block: axis sizes. ``data`` (-1: all ranks) is
    checked against the world size when the engine builds its topology
    (``parallel/mesh.py``); another axis above 1 raises here."""
    from .parallel.mesh import LATER_AXES, MESH_AXES

    sizes = {}
    for axis, n in (d or {}).items():
        if axis not in MESH_AXES:
            raise ConfigError(f"unknown mesh axis '{axis}'")
        n = int(n)
        if axis != "data" and n > 1:
            _later_slice(f"mesh.{axis}", n, LATER_AXES[axis])
        sizes[axis] = n
    return sizes


def _check_later_slice_blocks(d: Dict[str, Any]) -> None:
    """Pop the blocks of later slices; raise when one turns its feature on."""
    pipe = d.pop("pipeline", None) or {}
    if int(pipe.get("stages", 1) or 1) > 1:
        _later_slice("pipeline.stages", pipe["stages"])
    tel = d.pop("telemetry", None) or {}
    if tel.get("enabled"):
        _later_slice("telemetry.enabled", tel["enabled"])
    ckpt = d.pop("checkpoint", None) or {}
    if ckpt.get("save_dir"):
        _later_slice("checkpoint.save_dir", ckpt["save_dir"])
    res = d.pop("resilience", None)
    if res:
        _later_slice("resilience", res)


@dataclass
class Config:
    """Top-level typed config of the single-device trainer (the keys this
    slice reads; see the module docstring)."""

    train_batch_size: Optional[int] = None
    train_micro_batch_size_per_gpu: Optional[int] = None
    gradient_accumulation_steps: Optional[int] = None
    steps_per_print: int = 10
    gradient_clipping: float = 0.0
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    fp16: FP16Config = field(default_factory=FP16Config)
    bf16: BF16Config = field(default_factory=BF16Config)
    zero: ZeroConfig = field(default_factory=ZeroConfig)
    comm_compression: CommCompressionConfig = field(
        default_factory=CommCompressionConfig)
    mesh: Dict[str, int] = field(default_factory=dict)

    @classmethod
    def from_any(cls, config: Union[str, Dict[str, Any], "Config", None]
                 ) -> "Config":
        if config is None:
            return cls()
        if isinstance(config, Config):
            return config
        if isinstance(config, str):
            if not os.path.isfile(config):
                raise ConfigError(f"config file not found: {config}")
            with open(config) as f:
                config = json.load(f)
        if not isinstance(config, dict):
            raise ConfigError(f"config must be a dict or path, got "
                              f"{type(config)}")
        return cls.from_dict(config)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        d = copy.deepcopy(d)

        def intval(key):
            v = _take(d, key, None)
            if v is None or (isinstance(v, str) and v.lower() == AUTO):
                return None
            return int(v)

        _check_later_slice_blocks(d)
        cfg = cls(
            train_batch_size=intval("train_batch_size"),
            train_micro_batch_size_per_gpu=intval(
                "train_micro_batch_size_per_gpu"),
            gradient_accumulation_steps=intval("gradient_accumulation_steps"),
            steps_per_print=int(_take(d, "steps_per_print", 10)),
            gradient_clipping=float(_take(d, "gradient_clipping", 0.0)),
            optimizer=OptimizerConfig.from_dict(_take(d, "optimizer", None)),
            scheduler=SchedulerConfig.from_dict(_take(d, "scheduler", None)),
            fp16=FP16Config.from_dict(_take(d, "fp16", None)),
            bf16=BF16Config.from_dict(_take(d, "bf16", None)),
            zero=ZeroConfig.from_dict(_take(d, "zero_optimization", None)),
            comm_compression=CommCompressionConfig.from_dict(
                _take(d, "comm_compression", None)),
            mesh=_mesh_from_dict(_take(d, "mesh", None)),
        )
        if cfg.fp16.enabled and cfg.bf16.enabled:
            raise ConfigError("fp16 and bf16 cannot both be enabled")
        _warn_unknown(d, "<top-level>")
        return cfg

    def resolve_batch_config(self, dp_world_size: int = 1) -> None:
        """Resolve train_batch = micro_batch * GAS * dp_world: any two of
        the three determine the third, a single given value is completed
        with GAS 1, and all three given are validated."""
        tb, mb, gas = (self.train_batch_size,
                       self.train_micro_batch_size_per_gpu,
                       self.gradient_accumulation_steps)
        dp = dp_world_size
        if tb is not None and mb is not None and gas is not None:
            if tb != mb * gas * dp:
                raise ConfigError(f"train_batch_size ({tb}) != micro_batch "
                                  f"({mb}) * gas ({gas}) * dp_world ({dp})")
        elif tb is not None and mb is not None:
            if tb % (mb * dp) != 0:
                raise ConfigError(f"train_batch_size ({tb}) not divisible by "
                                  f"micro_batch ({mb}) * dp_world ({dp})")
            gas = tb // (mb * dp)
        elif tb is not None and gas is not None:
            if tb % (gas * dp) != 0:
                raise ConfigError(f"train_batch_size ({tb}) not divisible by "
                                  f"gas ({gas}) * dp_world ({dp})")
            mb = tb // (gas * dp)
        elif mb is not None and gas is not None:
            tb = mb * gas * dp
        elif tb is not None:
            if tb % dp != 0:
                raise ConfigError(f"train_batch_size ({tb}) not divisible by "
                                  f"dp world size ({dp})")
            gas, mb = 1, tb // dp
        elif mb is not None:
            gas, tb = 1, mb * dp
        else:
            raise ConfigError(
                "At least one of train_batch_size / "
                "train_micro_batch_size_per_gpu / gradient_accumulation_steps "
                "must be set")
        self.train_batch_size = tb
        self.train_micro_batch_size_per_gpu = mb
        self.gradient_accumulation_steps = gas

    @property
    def compute_dtype(self) -> torch.dtype:
        if self.bf16.enabled:
            return torch.bfloat16
        if self.fp16.enabled:
            return torch.float16
        return torch.float32


# serving keys of later slices -> the value that means "off"
_LATER_SLICE_KEYS = {
    "model_version": 0,
    "stuck_tick_timeout_s": 0, "fleet": {}, "region": {}, "rollout": {},
    "kv_tier": {},
}
# knobs that only act when one of the features above is on
_INERT_KEYS = ("stuck_tick_escalate_polls",)


@dataclass
class ServingConfig:
    """The ``serving`` block: knobs for the request front-end over the
    ragged engine.

    ``policy`` selects the admission/preemption policy (``"slo"`` —
    priority tiers + earliest-deadline-first + KV-pressure preemption —
    or ``"fcfs"``, the strict-arrival-order baseline). ``max_queue``
    bounds the admission queue: submissions beyond it are REJECTED
    immediately. ``reserve_output_blocks`` charges admission for the
    whole remaining output, so an admitted request cannot exhaust the KV
    pool mid-decode. ``tick_retry_limit`` is the per-request budget for
    re-queue-on-tick-fault before the request is failed. ``kv_quant``
    declares the engine's KV storage (``"none"``, ``"int8"``, ``"int4"``);
    the server refuses an engine that stores KV otherwise.

    ``speculative`` turns on prompt-lookup speculative decoding inside the
    serving tick: draft chains (``spec_ngram``-gram lookups, at most
    ``spec_lookahead`` tokens) verify in the tick's one ragged step, greedy
    output stays token-identical, and drafting spends only the tick's
    token-budget slack, sized by a per-priority-class acceptance EMA
    (smoothing ``spec_ema``). A request falls back to plain decode when
    its rolling acceptance EMA drops below ``spec_accept_floor`` after at
    least ``spec_floor_min_proposed`` proposed tokens."""

    max_queue: int = 256
    policy: str = "slo"
    kv_pressure: float = 0.90
    reject_expired: bool = True
    preemption: bool = True
    reserve_output_blocks: bool = True
    default_max_new_tokens: int = 128
    poll_interval_s: float = 0.002
    drain_timeout_s: float = 120.0
    tick_retry_limit: int = 1
    speculative: bool = False
    spec_lookahead: int = 4
    spec_ngram: int = 3
    spec_accept_floor: float = 0.25
    spec_floor_min_proposed: int = 16
    spec_ema: float = 0.25
    kv_quant: str = "none"

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "ServingConfig":
        if not d:
            return cls()
        d = dict(d)
        for key in _INERT_KEYS:
            d.pop(key, None)
        for key, off in _LATER_SLICE_KEYS.items():
            if key in d:
                v = d.pop(key)
                if v is not None and v != off:
                    raise NotImplementedError(
                        f"serving.{key}={v!r}: not ported yet — it comes "
                        f"with a later slice of deepspeed_tpu_torch "
                        f"(ROADMAP.md, Queue A)")
        out = cls(
            max_queue=int(_take(d, "max_queue", 256)),
            policy=str(_take(d, "policy", "slo")),
            kv_pressure=float(_take(d, "kv_pressure", 0.90)),
            reject_expired=bool(_take(d, "reject_expired", True)),
            preemption=bool(_take(d, "preemption", True)),
            reserve_output_blocks=bool(_take(d, "reserve_output_blocks", True)),
            default_max_new_tokens=int(_take(d, "default_max_new_tokens", 128)),
            poll_interval_s=float(_take(d, "poll_interval_s", 0.002)),
            drain_timeout_s=float(_take(d, "drain_timeout_s", 120.0)),
            tick_retry_limit=int(_take(d, "tick_retry_limit", 1)),
            speculative=bool(_take(d, "speculative", False)),
            spec_lookahead=int(_take(d, "spec_lookahead", 4)),
            spec_ngram=int(_take(d, "spec_ngram", 3)),
            spec_accept_floor=float(_take(d, "spec_accept_floor", 0.25)),
            spec_floor_min_proposed=int(
                _take(d, "spec_floor_min_proposed", 16)),
            spec_ema=float(_take(d, "spec_ema", 0.25)),
            kv_quant=str(_take(d, "kv_quant", "none")),
        )
        if out.policy not in ("slo", "fcfs"):
            raise ConfigError(
                f"serving.policy must be 'slo' or 'fcfs', got '{out.policy}'")
        if out.max_queue < 1:
            raise ConfigError(
                f"serving.max_queue must be >= 1, got {out.max_queue}")
        if not 0.0 <= out.kv_pressure <= 1.0:
            raise ConfigError(
                f"serving.kv_pressure must be in [0, 1], got {out.kv_pressure}")
        if out.tick_retry_limit < 0:
            raise ConfigError(
                f"serving.tick_retry_limit must be >= 0, got "
                f"{out.tick_retry_limit}")
        if out.default_max_new_tokens < 1:
            raise ConfigError(
                f"serving.default_max_new_tokens must be >= 1, got "
                f"{out.default_max_new_tokens}")
        if out.spec_lookahead < 1 or out.spec_ngram < 1:
            raise ConfigError(
                f"serving.spec_lookahead/spec_ngram must be >= 1, got "
                f"{out.spec_lookahead}/{out.spec_ngram}")
        if not 0.0 <= out.spec_accept_floor <= 1.0:
            raise ConfigError(
                f"serving.spec_accept_floor must be in [0, 1], got "
                f"{out.spec_accept_floor}")
        if not 0.0 < out.spec_ema <= 1.0:
            raise ConfigError(
                f"serving.spec_ema must be in (0, 1], got {out.spec_ema}")
        if out.kv_quant not in ("none", "int8", "int4"):
            raise ConfigError(
                f"serving.kv_quant must be 'none', 'int8' or 'int4', got "
                f"'{out.kv_quant}'")
        for k in d:
            logger.warning(f"Unknown config key '{k}' in section 'serving' "
                           f"— ignored")
        return out
