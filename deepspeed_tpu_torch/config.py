"""Configuration of the port.

Ports the parts of ``deepspeed_tpu/config.py`` that the ported paths read:

* :class:`ServingConfig` (the ``serving`` block of the serving front-end:
  speculative serving, ``kv_quant``, the stuck-tick watchdog, model
  versions, the ``kv_tier`` block, :class:`KVTierConfig`, and the
  ``fleet`` block, :class:`FleetConfig`, and the region's ``region`` and
  ``rollout`` blocks, :class:`RegionConfig` and :class:`RolloutConfig`).
* :class:`TelemetryConfig` (the ``telemetry`` block of the serving path)
  and :class:`ChaosConfig` (seeded fault injection).
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
            # the model axis serves (inference/); training over it is later
            _later_slice(f"mesh.{axis}", n, LATER_AXES.get(
                axis, "tensor-parallel training: ROADMAP.md, Queue A "
                "item 6b"))
        sizes[axis] = n
    return sizes


def _check_later_slice_blocks(d: Dict[str, Any]) -> None:
    """Pop the blocks of later slices; raise when one turns its feature on."""
    pipe = d.pop("pipeline", None) or {}
    if int(pipe.get("stages", 1) or 1) > 1:
        _later_slice("pipeline.stages", pipe["stages"])
    tel = d.pop("telemetry", None) or {}
    if tel.get("enabled"):
        # serving telemetry is ported (TelemetryConfig); the trainer's
        # per-step StepStats records are not yet
        _later_slice("telemetry.enabled", tel["enabled"],
                     "TrainEngine step telemetry: ROADMAP.md, Queue A "
                     "item 9")
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


@dataclass
class TelemetryConfig:
    """The ``telemetry`` block (docs/observability.md): the pipeline that
    :func:`~deepspeed_tpu_torch.telemetry.configure_telemetry` installs.

    The serving path and the engines feed it request records, counters,
    gauges and (with ``tracing``) request span trees. The trainer's
    per-step StepStats records come with a later slice (ROADMAP.md,
    Queue A item 9), so the training config still refuses
    ``telemetry.enabled``."""

    enabled: bool = False
    output_dir: str = "telemetry"
    jsonl_path: Optional[str] = None       # default: <output_dir>/steps.jsonl
    prometheus_path: Optional[str] = None  # e.g. <output_dir>/metrics.prom
    flush_every: int = 1
    export_every: int = 10
    stall_detection: bool = True
    stall_factor: float = 3.0
    stall_window: int = 20
    stall_warmup_steps: int = 2
    heartbeat_path: Optional[str] = None
    # serving-request span records (docs/serving.md); None defaults to
    # <output_dir>/requests.jsonl, "" disables the sink
    requests_jsonl_path: Optional[str] = None
    # request-scoped distributed tracing + flight recorder
    # (telemetry/tracing.py, docs/observability.md). Off by default:
    # zero extra host syncs / clock reads on every hot path.
    tracing: bool = False
    trace_ring: int = 4096          # finished-span ring buffer size
    flight_capacity: int = 512      # flight-recorder ring size
    flight_dump_dir: Optional[str] = None  # auto-dump dir; None = in-memory

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "TelemetryConfig":
        if not d:
            return cls()
        d = dict(d)
        out = cls(
            enabled=bool(_take(d, "enabled", False)),
            output_dir=str(_take(d, "output_dir", "telemetry")),
            jsonl_path=_take(d, "jsonl_path", None),
            prometheus_path=_take(d, "prometheus_path", None),
            flush_every=int(_take(d, "flush_every", 1)),
            export_every=int(_take(d, "export_every", 10)),
            stall_detection=bool(_take(d, "stall_detection", True)),
            stall_factor=float(_take(d, "stall_factor", 3.0)),
            stall_window=int(_take(d, "stall_window", 20)),
            stall_warmup_steps=int(_take(d, "stall_warmup_steps", 2)),
            heartbeat_path=_take(d, "heartbeat_path", None),
            requests_jsonl_path=_take(d, "requests_jsonl_path", None),
            tracing=bool(_take(d, "tracing", False)),
            trace_ring=int(_take(d, "trace_ring", 4096)),
            flight_capacity=int(_take(d, "flight_capacity", 512)),
            flight_dump_dir=_take(d, "flight_dump_dir", None),
        )
        if out.trace_ring < 1 or out.flight_capacity < 1:
            raise ConfigError(
                "telemetry.trace_ring and telemetry.flight_capacity must "
                f"be >= 1, got {out.trace_ring}/{out.flight_capacity}")
        if out.stall_factor <= 1.0:
            raise ConfigError(
                f"telemetry.stall_factor must exceed 1.0, got {out.stall_factor}")
        _warn_unknown(d, "telemetry")
        return out


@dataclass
class ChaosConfig:
    """Seeded fault injection (``resilience/chaos.py`` FaultInjector). All
    ``*_at_save`` are 1-based save counts, ``*_at_step`` match the engine's
    ``global_steps`` at the start of a train_batch; -1 disables."""

    enabled: bool = False
    seed: int = 0
    crash_before_commit_at_save: int = -1
    crash_after_commit_at_save: int = -1
    corrupt_shard_at_save: int = -1
    sigterm_at_step: int = -1
    crash_at_step: int = -1
    exit_process: bool = False  # os._exit instead of raising InjectedFault
    exit_code: int = 113
    collective_fail_op: str = ""
    collective_fail_at_call: int = -1
    collective_delay_s: float = 0.0
    collective_delay_every: int = 0
    serving_tick_fail_at: int = -1
    serving_tick_fail_every: int = 0
    # kill serving replica #replica_die_index once its engine has run
    # replica_die_at_tick ticks (-1 disables; one-shot)
    replica_die_at_tick: int = -1
    replica_die_index: int = 0
    # kill serving cell #cell_die_index (whole failure domain) once any
    # of its replicas has run cell_die_at_tick ticks (-1 disables)
    cell_die_at_tick: int = -1
    cell_die_index: int = 0
    # delay every fleet autoscaler decision by this many (virtual)
    # seconds — models real controller observe/decide/boot lag
    autoscaler_lag_s: float = 0.0
    # rollout-targeted faults (serving/rollout.py): corrupt the next N
    # hot-swap weight loads (the swap must fall back to the old version,
    # the controller must retry/rollback — never strand the replica);
    # kill the replica being flipped on the Nth flip (1-based, one-shot,
    # -1 disables); stall every other engine tick of one model version
    # (the injected canary SLO regression auto-rollback is gated on)
    corrupt_swap_count: int = 0
    die_at_flip: int = -1
    degrade_version: int = -1
    # gray-failure faults (docs/fault_tolerance.md "Gray failures"):
    # every Nth serving KV import raises a recoverable fault (the
    # adoption falls back to a requeue; 0 disables). The per-replica
    # k x-slowdowns and stall bursts are runtime-armed on the injector
    # (degrade_replica / arm_stall_burst), not config keys — they name
    # replicas that only exist once the fleet is up.
    flaky_import_every: int = 0
    # global-KV-tier faults (docs/serving.md "Global KV tier"): every
    # Nth directory publish also injects one bogus residency entry (a
    # directory lie — routing must detect the miss and fall back);
    # every Nth prefix export corrupts the wire payload while keeping
    # the stamped checksum (the importer's verify() must catch it);
    # every Nth cold-tier put is dropped (host memory pressure — the
    # prefix degrades to re-prefill, never double-frees). 0 disables.
    stale_directory_every: int = 0
    corrupt_adopt_every: int = 0
    cold_pressure_every: int = 0

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "ChaosConfig":
        if not d:
            return cls()
        d = dict(d)
        out = cls(
            enabled=bool(_take(d, "enabled", False)),
            seed=int(_take(d, "seed", 0)),
            crash_before_commit_at_save=int(_take(d, "crash_before_commit_at_save", -1)),
            crash_after_commit_at_save=int(_take(d, "crash_after_commit_at_save", -1)),
            corrupt_shard_at_save=int(_take(d, "corrupt_shard_at_save", -1)),
            sigterm_at_step=int(_take(d, "sigterm_at_step", -1)),
            crash_at_step=int(_take(d, "crash_at_step", -1)),
            exit_process=bool(_take(d, "exit_process", False)),
            exit_code=int(_take(d, "exit_code", 113)),
            collective_fail_op=str(_take(d, "collective_fail_op", "")),
            collective_fail_at_call=int(_take(d, "collective_fail_at_call", -1)),
            collective_delay_s=float(_take(d, "collective_delay_s", 0.0)),
            collective_delay_every=int(_take(d, "collective_delay_every", 0)),
            serving_tick_fail_at=int(_take(d, "serving_tick_fail_at", -1)),
            serving_tick_fail_every=int(_take(d, "serving_tick_fail_every", 0)),
            replica_die_at_tick=int(_take(d, "replica_die_at_tick", -1)),
            replica_die_index=int(_take(d, "replica_die_index", 0)),
            cell_die_at_tick=int(_take(d, "cell_die_at_tick", -1)),
            cell_die_index=int(_take(d, "cell_die_index", 0)),
            autoscaler_lag_s=float(_take(d, "autoscaler_lag_s", 0.0)),
            corrupt_swap_count=int(_take(d, "corrupt_swap_count", 0)),
            die_at_flip=int(_take(d, "die_at_flip", -1)),
            degrade_version=int(_take(d, "degrade_version", -1)),
            flaky_import_every=int(_take(d, "flaky_import_every", 0)),
            stale_directory_every=int(_take(d, "stale_directory_every", 0)),
            corrupt_adopt_every=int(_take(d, "corrupt_adopt_every", 0)),
            cold_pressure_every=int(_take(d, "cold_pressure_every", 0)),
        )
        if out.autoscaler_lag_s < 0:
            raise ConfigError(
                f"resilience.chaos.autoscaler_lag_s must be >= 0, got "
                f"{out.autoscaler_lag_s}")
        if out.corrupt_swap_count < 0:
            raise ConfigError(
                f"resilience.chaos.corrupt_swap_count must be >= 0, got "
                f"{out.corrupt_swap_count}")
        if out.flaky_import_every < 0:
            raise ConfigError(
                f"resilience.chaos.flaky_import_every must be >= 0, got "
                f"{out.flaky_import_every}")
        for knob in ("stale_directory_every", "corrupt_adopt_every",
                     "cold_pressure_every"):
            if getattr(out, knob) < 0:
                raise ConfigError(
                    f"resilience.chaos.{knob} must be >= 0, got "
                    f"{getattr(out, knob)}")
        _warn_unknown(d, "resilience.chaos")
        return out


@dataclass
class KVTierConfig:
    """The ``serving.kv_tier`` block: the global KV tier
    (docs/serving.md "Global KV tier"). Default OFF — with
    ``enabled=False`` no directory, adoption pen, or cold tier is
    constructed and old traces/seeds replay bit-identically.

    ``publish_interval_s`` is the residency-publication cadence (each
    replica's driver snapshots its prefix-cache keys at most this often,
    piggybacked on the fleet's poll); ``directory_staleness_s`` bounds
    how old a directory entry may be before routing stops trusting it —
    it must be at least the publish interval, or every entry would
    expire before its holder could refresh it. ``adoption`` gates
    cross-replica prefix adoption (directory hit on another replica ->
    quantized pages on the wire); ``cold_tier``/``cold_capacity_pages``
    gate the host-memory spill store for evicted prefixes."""

    enabled: bool = False
    publish_interval_s: float = 1.0
    directory_staleness_s: float = 5.0
    adoption: bool = True
    cold_tier: bool = True
    cold_capacity_pages: int = 256

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "KVTierConfig":
        if not d:
            return cls()
        d = dict(d)
        out = cls(
            enabled=bool(_take(d, "enabled", False)),
            publish_interval_s=float(_take(d, "publish_interval_s", 1.0)),
            directory_staleness_s=float(
                _take(d, "directory_staleness_s", 5.0)),
            adoption=bool(_take(d, "adoption", True)),
            cold_tier=bool(_take(d, "cold_tier", True)),
            cold_capacity_pages=int(_take(d, "cold_capacity_pages", 256)),
        )
        if out.publish_interval_s <= 0:
            raise ConfigError(
                f"serving.kv_tier.publish_interval_s must be > 0, got "
                f"{out.publish_interval_s}")
        if out.directory_staleness_s < out.publish_interval_s:
            raise ConfigError(
                f"serving.kv_tier.directory_staleness_s must be >= "
                f"publish_interval_s ({out.publish_interval_s}), got "
                f"{out.directory_staleness_s}")
        if out.cold_tier and out.cold_capacity_pages < 1:
            raise ConfigError(
                f"serving.kv_tier.cold_capacity_pages must be >= 1 when "
                f"the cold tier is enabled, got {out.cold_capacity_pages}")
        _warn_unknown(d, "serving.kv_tier")
        return out


@dataclass
class FleetConfig:
    """The ``serving.fleet`` block: the multi-replica front-end
    (:class:`~deepspeed_tpu_torch.serving.fleet.ServingFleet`).

    ``router`` picks the routing policy (``"least_loaded"`` or
    ``"prefix_affinity"`` — consistent hashing on the prompt's full-block
    prefix so repeat traffic lands on the replica holding its cached KV).
    ``disaggregated`` splits the fleet into ``prefill_replicas`` replicas
    that only compute prompt KV and hand pages off to the decode
    replicas. ``autoscale`` turns on the telemetry-driven controller; the
    sizing policy itself lives in
    :class:`deepspeed_tpu_torch.elasticity.ServingElasticityConfig` (the
    ``min_replicas``..``sla_low`` knobs here are forwarded to it, so
    training and serving elasticity share one policy surface).
    ``failover`` re-queues a dead replica's in-flight requests onto the
    survivors via the bit-exact resume path; ``respawn`` additionally
    replaces dead replicas while the healthy count sits below
    ``min_replicas``."""

    replicas: int = 1
    router: str = "least_loaded"
    affinity_vnodes: int = 64
    affinity_spill_load: int = 0
    disaggregated: bool = False
    prefill_replicas: int = 1
    health_interval_s: float = 0.05
    failover: bool = True
    respawn: bool = True
    autoscale: bool = False
    autoscale_interval_s: float = 1.0
    min_replicas: int = 1
    max_replicas: int = 8
    scale_up_queue_per_replica: float = 8.0
    scale_down_queue_per_replica: float = 1.0
    kv_high: float = 0.85
    sla_low: float = 0.90
    sla_window: int = 64
    # route-retry discipline (resilience/retry.py RetryBudget): each
    # refused replica pick past the first consumes one unit from a
    # budget shared fleet-wide (and region-wide when the fleet belongs
    # to a region's cell), with jittered exponential backoff between
    # attempts — a replica/cell that refuses forever is given up on
    # explicitly (REJECTED span) instead of being hammered in a tight
    # loop. 0 budget = first refusal already rejects.
    route_retry_budget: int = 256
    route_backoff_s: float = 0.02
    route_backoff_jitter: float = 0.5
    # gray-failure plane (serving/health.py) — all default OFF.
    # ``quarantine`` drains a replica whose continuous health score
    # breaches ``quarantine_threshold`` for ``quarantine_after``
    # consecutive monitor polls out of the NEW-work routing view (never
    # below ``min_replicas`` — the capacity floor), dwells
    # ``quarantine_dwell_s``, then probes it with live traffic and
    # re-admits after ``quarantine_readmit_polls`` clean polls (a
    # probation breach doubles the dwell — hysteresis against flap).
    # ``breakers`` arms per-replica routing circuit breakers
    # (closed -> open after ``breaker_failures`` consecutive failures,
    # half-open single probe after ``breaker_cooldown_s``).  ``hedge``
    # dispatches a backup leg for an interactive request once
    # ``hedge_ttft_fraction`` of its TTFT deadline has elapsed with no
    # first token — first token wins, the loser is cancelled with its
    # KV discarded, and the SLO ledger judges the request once.
    quarantine: bool = False
    quarantine_threshold: float = 0.5
    quarantine_after: int = 3
    quarantine_dwell_s: float = 8.0
    quarantine_readmit_polls: int = 3
    breakers: bool = False
    breaker_failures: int = 4
    breaker_cooldown_s: float = 5.0
    hedge: bool = False
    hedge_ttft_fraction: float = 0.6

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "FleetConfig":
        if not d:
            return cls()
        d = dict(d)
        out = cls(
            replicas=int(_take(d, "replicas", 1)),
            router=str(_take(d, "router", "least_loaded")),
            affinity_vnodes=int(_take(d, "affinity_vnodes", 64)),
            affinity_spill_load=int(_take(d, "affinity_spill_load", 0)),
            disaggregated=bool(_take(d, "disaggregated", False)),
            prefill_replicas=int(_take(d, "prefill_replicas", 1)),
            health_interval_s=float(_take(d, "health_interval_s", 0.05)),
            failover=bool(_take(d, "failover", True)),
            respawn=bool(_take(d, "respawn", True)),
            autoscale=bool(_take(d, "autoscale", False)),
            autoscale_interval_s=float(_take(d, "autoscale_interval_s", 1.0)),
            min_replicas=int(_take(d, "min_replicas", 1)),
            max_replicas=int(_take(d, "max_replicas", 8)),
            scale_up_queue_per_replica=float(
                _take(d, "scale_up_queue_per_replica", 8.0)),
            scale_down_queue_per_replica=float(
                _take(d, "scale_down_queue_per_replica", 1.0)),
            kv_high=float(_take(d, "kv_high", 0.85)),
            sla_low=float(_take(d, "sla_low", 0.90)),
            sla_window=int(_take(d, "sla_window", 64)),
            route_retry_budget=int(_take(d, "route_retry_budget", 256)),
            route_backoff_s=float(_take(d, "route_backoff_s", 0.02)),
            route_backoff_jitter=float(
                _take(d, "route_backoff_jitter", 0.5)),
            quarantine=bool(_take(d, "quarantine", False)),
            quarantine_threshold=float(
                _take(d, "quarantine_threshold", 0.5)),
            quarantine_after=int(_take(d, "quarantine_after", 3)),
            quarantine_dwell_s=float(
                _take(d, "quarantine_dwell_s", 8.0)),
            quarantine_readmit_polls=int(
                _take(d, "quarantine_readmit_polls", 3)),
            breakers=bool(_take(d, "breakers", False)),
            breaker_failures=int(_take(d, "breaker_failures", 4)),
            breaker_cooldown_s=float(
                _take(d, "breaker_cooldown_s", 5.0)),
            hedge=bool(_take(d, "hedge", False)),
            hedge_ttft_fraction=float(
                _take(d, "hedge_ttft_fraction", 0.6)),
        )
        if out.route_retry_budget < 0:
            raise ConfigError(
                f"serving.fleet.route_retry_budget must be >= 0, got "
                f"{out.route_retry_budget}")
        if out.route_backoff_s < 0 or out.route_backoff_jitter < 0:
            raise ConfigError(
                "serving.fleet route_backoff_s and route_backoff_jitter "
                "must be >= 0")
        if out.router not in ("least_loaded", "prefix_affinity",
                              "residency"):
            raise ConfigError(
                f"serving.fleet.router must be 'least_loaded', "
                f"'prefix_affinity' or 'residency', got '{out.router}'")
        if out.replicas < 1:
            raise ConfigError(
                f"serving.fleet.replicas must be >= 1, got {out.replicas}")
        if out.disaggregated and out.prefill_replicas < 1:
            raise ConfigError(
                f"serving.fleet.prefill_replicas must be >= 1 in "
                f"disaggregated mode, got {out.prefill_replicas}")
        if not 1 <= out.min_replicas <= out.max_replicas:
            raise ConfigError(
                f"serving.fleet needs 1 <= min_replicas <= max_replicas, "
                f"got [{out.min_replicas}, {out.max_replicas}]")
        if out.scale_down_queue_per_replica > out.scale_up_queue_per_replica:
            # fail at parse, not as an ElasticityError inside every
            # monitor poll (the hysteresis band must be non-negative)
            raise ConfigError(
                "serving.fleet.scale_down_queue_per_replica must not "
                "exceed scale_up_queue_per_replica "
                f"({out.scale_down_queue_per_replica} > "
                f"{out.scale_up_queue_per_replica})")
        if out.sla_window < 1:
            raise ConfigError(
                f"serving.fleet.sla_window must be >= 1, got "
                f"{out.sla_window}")
        if not 0.0 < out.quarantine_threshold <= 1.0:
            raise ConfigError(
                f"serving.fleet.quarantine_threshold must be in (0, 1], "
                f"got {out.quarantine_threshold}")
        if out.quarantine_after < 1 or out.quarantine_readmit_polls < 1:
            raise ConfigError(
                "serving.fleet quarantine_after and "
                "quarantine_readmit_polls must be >= 1")
        if out.quarantine_dwell_s <= 0:
            raise ConfigError(
                f"serving.fleet.quarantine_dwell_s must be > 0, got "
                f"{out.quarantine_dwell_s}")
        if out.breaker_failures < 1 or out.breaker_cooldown_s <= 0:
            raise ConfigError(
                "serving.fleet breaker_failures must be >= 1 and "
                "breaker_cooldown_s > 0")
        if not 0.0 < out.hedge_ttft_fraction < 1.0:
            # 0 would hedge EVERY interactive request on submit; 1
            # would hedge only after the deadline is already blown
            raise ConfigError(
                f"serving.fleet.hedge_ttft_fraction must be in (0, 1), "
                f"got {out.hedge_ttft_fraction}")
        _warn_unknown(d, "serving.fleet")
        return out


@dataclass
class RegionConfig:
    """The ``serving.region`` block: the cell-based fleet-of-fleets
    front-end (:class:`~deepspeed_tpu_torch.serving.region.Region`).

    ``cells`` fleets (each a :class:`FleetConfig`-shaped failure domain)
    sit behind one :class:`~deepspeed_tpu_torch.serving.Region` that routes by
    a two-tier consistent hash: a ``cell_ring_vnodes``-point cell ring
    picks the failure domain from each cell's PUBLISHED load/health
    digest (queue depth, KV demand, in-SLA window — refreshed on the
    monitor cadence, never scanned per route), then the cell's own
    router picks the replica. ``cell_spill_load`` (0 = off) spills a
    request off an overloaded primary cell to the least-loaded
    reachable one (digest queue depth per healthy replica >= the
    threshold), mirroring the replica ring's spill valve one tier up.

    Brownout: when reachable demand exceeds ``brownout_queue_per_replica``
    queued requests per healthy reachable replica, the region sheds NEW
    work below a priority floor that climbs one tier per additional
    multiple of the threshold (the brownout ladder), always with a
    REJECTED span — explicit degradation, never silent drops.
    ``brownout_exit_ratio`` is the hysteresis: a floor level is left
    only once pressure falls below ``ratio`` x its entry threshold.

    ``rebalance_threshold`` (queued requests per replica above the
    reachable mean, 0 = off) lets a heal re-spread QUEUED work from
    cells that bore the partition onto the rejoined capacity.

    Telemetry plane (the region's rollups): every
    ``telemetry_rollup_every``-th digest refresh the region pulls each
    cell's telemetry digest delta (sketch merges + counter deltas +
    SLO verdicts) into its accumulator and SLO tracker. The ``slo_*``
    knobs parameterize the per-tenant SLO objective
    (:class:`~deepspeed_tpu_torch.telemetry.slo.SLOObjective`): target in-SLA
    ratio over ``slo_window_s`` of virtual time, with fast/slow
    burn-rate alert windows and thresholds."""

    cells: int = 2
    cell_ring_vnodes: int = 32
    cell_spill_load: int = 0
    brownout_queue_per_replica: float = 8.0
    brownout_exit_ratio: float = 0.5
    rebalance_threshold: float = 4.0
    health_interval_s: float = 0.05
    telemetry_rollup_every: int = 1
    slo_target: float = 0.95
    slo_window_s: float = 240.0
    slo_fast_window_s: float = 300.0
    slo_slow_window_s: float = 3600.0
    slo_fast_burn: float = 14.4
    slo_slow_burn: float = 6.0
    slo_min_samples: int = 4

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "RegionConfig":
        if not d:
            return cls()
        d = dict(d)
        out = cls(
            cells=int(_take(d, "cells", 2)),
            cell_ring_vnodes=int(_take(d, "cell_ring_vnodes", 32)),
            cell_spill_load=int(_take(d, "cell_spill_load", 0)),
            brownout_queue_per_replica=float(
                _take(d, "brownout_queue_per_replica", 8.0)),
            brownout_exit_ratio=float(
                _take(d, "brownout_exit_ratio", 0.5)),
            rebalance_threshold=float(
                _take(d, "rebalance_threshold", 4.0)),
            health_interval_s=float(_take(d, "health_interval_s", 0.05)),
            telemetry_rollup_every=int(
                _take(d, "telemetry_rollup_every", 1)),
            slo_target=float(_take(d, "slo_target", 0.95)),
            slo_window_s=float(_take(d, "slo_window_s", 240.0)),
            slo_fast_window_s=float(_take(d, "slo_fast_window_s", 300.0)),
            slo_slow_window_s=float(
                _take(d, "slo_slow_window_s", 3600.0)),
            slo_fast_burn=float(_take(d, "slo_fast_burn", 14.4)),
            slo_slow_burn=float(_take(d, "slo_slow_burn", 6.0)),
            slo_min_samples=int(_take(d, "slo_min_samples", 4)),
        )
        if out.cells < 1:
            raise ConfigError(
                f"serving.region.cells must be >= 1, got {out.cells}")
        if out.cell_ring_vnodes < 1:
            raise ConfigError(
                f"serving.region.cell_ring_vnodes must be >= 1, got "
                f"{out.cell_ring_vnodes}")
        if out.brownout_queue_per_replica <= 0:
            raise ConfigError(
                f"serving.region.brownout_queue_per_replica must be > 0, "
                f"got {out.brownout_queue_per_replica}")
        if not 0.0 <= out.brownout_exit_ratio <= 1.0:
            # exit above entry would re-enter the level it just left on
            # the very next poll (oscillation, not hysteresis)
            raise ConfigError(
                f"serving.region.brownout_exit_ratio must be in [0, 1], "
                f"got {out.brownout_exit_ratio}")
        if out.rebalance_threshold < 0:
            raise ConfigError(
                f"serving.region.rebalance_threshold must be >= 0, got "
                f"{out.rebalance_threshold}")
        if out.telemetry_rollup_every < 1:
            # 0 would divide-by-zero the poll's cadence modulo; a named
            # error at parse beats a ZeroDivisionError mid-rollup
            raise ConfigError(
                f"serving.region.telemetry_rollup_every must be >= 1, "
                f"got {out.telemetry_rollup_every}")
        _warn_unknown(d, "serving.region")
        return out


@dataclass
class RolloutConfig:
    """The ``serving.rollout`` block: zero-downtime model rollout
    (:class:`~deepspeed_tpu_torch.serving.rollout.RolloutController`).

    ``canary_fraction`` is the tenant-sticky traffic slice routed to the
    canary version while the controller observes it.  The canary is
    judged after ``canary_observe_ticks`` controller steps: if the
    canary's in-SLA ratio sits more than ``slo_regression_threshold``
    below the stable version's over at least ``min_canary_samples``
    retired requests, the rollout rolls back automatically; otherwise it
    promotes.  ``warmup_ticks`` is the post-swap AOT warmup countdown a
    flipped replica serves through before re-opening admission.
    ``swap_retry_limit`` bounds hot-swap retries per replica (a corrupt
    new-version checkpoint falls back to the old weights each time);
    ``max_flip_attempts`` bounds how often the controller re-targets a
    flip after the victim dies mid-flip — past either bound the rollout
    rolls back instead of wedging."""

    canary_fraction: float = 0.10
    canary_observe_ticks: int = 40
    slo_regression_threshold: float = 0.20
    min_canary_samples: int = 8
    warmup_ticks: int = 2
    swap_retry_limit: int = 2
    max_flip_attempts: int = 4

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "RolloutConfig":
        if not d:
            return cls()
        d = dict(d)
        out = cls(
            canary_fraction=float(_take(d, "canary_fraction", 0.10)),
            canary_observe_ticks=int(_take(d, "canary_observe_ticks", 40)),
            slo_regression_threshold=float(
                _take(d, "slo_regression_threshold", 0.20)),
            min_canary_samples=int(_take(d, "min_canary_samples", 8)),
            warmup_ticks=int(_take(d, "warmup_ticks", 2)),
            swap_retry_limit=int(_take(d, "swap_retry_limit", 2)),
            max_flip_attempts=int(_take(d, "max_flip_attempts", 4)),
        )
        if not 0.0 < out.canary_fraction <= 1.0:
            raise ConfigError(
                f"serving.rollout.canary_fraction must be in (0, 1], got "
                f"{out.canary_fraction}")
        if out.canary_observe_ticks < 1:
            raise ConfigError(
                f"serving.rollout.canary_observe_ticks must be >= 1, got "
                f"{out.canary_observe_ticks}")
        if not 0.0 <= out.slo_regression_threshold <= 1.0:
            raise ConfigError(
                f"serving.rollout.slo_regression_threshold must be in "
                f"[0, 1], got {out.slo_regression_threshold}")
        if out.min_canary_samples < 1:
            raise ConfigError(
                f"serving.rollout.min_canary_samples must be >= 1, got "
                f"{out.min_canary_samples}")
        if out.warmup_ticks < 0:
            raise ConfigError(
                f"serving.rollout.warmup_ticks must be >= 0, got "
                f"{out.warmup_ticks}")
        if out.swap_retry_limit < 0:
            raise ConfigError(
                f"serving.rollout.swap_retry_limit must be >= 0, got "
                f"{out.swap_retry_limit}")
        if out.max_flip_attempts < 1:
            raise ConfigError(
                f"serving.rollout.max_flip_attempts must be >= 1, got "
                f"{out.max_flip_attempts}")
        _warn_unknown(d, "serving.rollout")
        return out


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

    ``stuck_tick_timeout_s`` arms the stuck-tick watchdog (0 disables
    it); after ``stuck_tick_escalate_polls`` consecutive stuck polls the
    replica marks itself watchdog-unhealthy (0: log only).
    ``model_version`` is the weights' version a replica starts serving
    (bumped by ``hot_swap``); ``kv_tier`` is the global KV tier's block
    (:class:`KVTierConfig`); ``fleet`` is the multi-replica front-end's
    block (:class:`FleetConfig`); ``region`` is the cell-based region's
    block (:class:`RegionConfig`) and ``rollout`` the rollout
    controller's (:class:`RolloutConfig`).

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
    stuck_tick_timeout_s: float = 30.0
    stuck_tick_escalate_polls: int = 3
    tick_retry_limit: int = 1
    speculative: bool = False
    spec_lookahead: int = 4
    spec_ngram: int = 3
    spec_accept_floor: float = 0.25
    spec_floor_min_proposed: int = 16
    spec_ema: float = 0.25
    kv_quant: str = "none"
    model_version: int = 0
    fleet: FleetConfig = field(default_factory=FleetConfig)
    region: RegionConfig = field(default_factory=RegionConfig)
    rollout: RolloutConfig = field(default_factory=RolloutConfig)
    kv_tier: KVTierConfig = field(default_factory=KVTierConfig)

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "ServingConfig":
        if not d:
            return cls()
        d = dict(d)
        out = cls(
            fleet=FleetConfig.from_dict(_take(d, "fleet", None)),
            region=RegionConfig.from_dict(_take(d, "region", None)),
            rollout=RolloutConfig.from_dict(_take(d, "rollout", None)),
            kv_tier=KVTierConfig.from_dict(_take(d, "kv_tier", None)),
            max_queue=int(_take(d, "max_queue", 256)),
            policy=str(_take(d, "policy", "slo")),
            kv_pressure=float(_take(d, "kv_pressure", 0.90)),
            reject_expired=bool(_take(d, "reject_expired", True)),
            preemption=bool(_take(d, "preemption", True)),
            reserve_output_blocks=bool(_take(d, "reserve_output_blocks", True)),
            default_max_new_tokens=int(_take(d, "default_max_new_tokens", 128)),
            poll_interval_s=float(_take(d, "poll_interval_s", 0.002)),
            drain_timeout_s=float(_take(d, "drain_timeout_s", 120.0)),
            stuck_tick_timeout_s=float(_take(d, "stuck_tick_timeout_s", 30.0)),
            stuck_tick_escalate_polls=int(
                _take(d, "stuck_tick_escalate_polls", 3)),
            tick_retry_limit=int(_take(d, "tick_retry_limit", 1)),
            speculative=bool(_take(d, "speculative", False)),
            spec_lookahead=int(_take(d, "spec_lookahead", 4)),
            spec_ngram=int(_take(d, "spec_ngram", 3)),
            spec_accept_floor=float(_take(d, "spec_accept_floor", 0.25)),
            spec_floor_min_proposed=int(
                _take(d, "spec_floor_min_proposed", 16)),
            spec_ema=float(_take(d, "spec_ema", 0.25)),
            kv_quant=str(_take(d, "kv_quant", "none")),
            model_version=int(_take(d, "model_version", 0)),
        )
        if out.model_version < 0:
            raise ConfigError(
                f"serving.model_version must be >= 0, got "
                f"{out.model_version}")
        if out.stuck_tick_escalate_polls < 0:
            raise ConfigError(
                f"serving.stuck_tick_escalate_polls must be >= 0, got "
                f"{out.stuck_tick_escalate_polls}")
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
