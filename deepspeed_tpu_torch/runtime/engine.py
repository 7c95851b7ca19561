"""The training engine: one device, a ``data`` x ``model`` mesh at ZeRO
stage 0, or ZeRO stages 1-3 over the ``data`` ranks.

Ports these paths of ``deepspeed_tpu/runtime/engine.py``'s ``TrainEngine``:

* one device: fp32 master weights, a compute-dtype copy for the forward and
  backward passes (bf16/fp16 mixed precision), gradient accumulation over
  ``gradient_accumulation_steps`` micro-batches, global-norm clipping, fp16
  dynamic loss scaling with skipped steps, and the optimizer step;
* stage 0 over a ``data`` x ``model`` mesh (the JAX engine with
  ``tp_specs``, GSPMD's placement made explicit): under ``model`` > 1 the
  model is cut by its ``partition_specs`` (``initialize`` does it), so the
  fp32 masters and the AdamW moments are this rank's shards and AdamW,
  elementwise, runs on them; the forward and backward collectives are the
  model's differentiable ones (``comm.tp_copy`` / ``tp_sum`` /
  ``tp_gather``). Under ``data`` > 1 each rank takes its rows of every
  micro-batch; a topology-aware model (every model of the port) returns
  its share of the global batch's loss, so one all-reduce of the
  gradients and the loss over the data group gives the global batch's, as
  JAX's GSPMD gradient sum does (a custom ``loss_fn`` or another model's
  loss is a mean over the rank's rows, divided by the data ranks: the
  shares then average). The global norm sums the sharded leaves' squares
  over the model group and counts the replicated leaves once; the fp16
  overflow flag is reduced over every rank;
* ZeRO stages 1 and 2 over ``data`` (JAX's placement,
  ``ZeroShardingRules``): the masters stay whole on every rank and the
  AdamW moments are this rank's ``state_spec`` shards. Stage 1 sums the
  full gradients over the data group as stage 0 does; stage 2
  reduce-scatters each micro-batch's gradients, so the accumulator is the
  rank's shard. Each rank then updates its slice of every master (Adam is
  elementwise: a slice's update is stage 0's on those elements) and the
  updated fp32 slices are all-gathered back into the whole masters, what
  XLA emits for JAX's replicated ``param_shardings`` after the sharded
  update;
* ZeRO stage 3 with the staged block schedule (``_loss_and_grads_staged``)
  for a model with ``zero3_blocks`` trained on its own loss: every rank of
  the ``data`` group keeps the fp32 master shards of
  ``ZeroShardingRules.param_spec``, takes its rows of the global batch,
  and runs the model's ``zero3_blocks`` program through
  ``Zero3BlockSchedule`` with the compressed-collective facade: per block a
  (quantized, qwZ) weight all-gather and a (quantized, qgZ) gradient mean,
  or, on the fused backend for blocks whose weight is sharded on its
  output dim, the gather inside the matmul kernel and the quantization in
  the weight-gradient kernel's epilogue (``_fused_block_ops``). The reduced
  gradients are sliced to the rank's shard;
* ZeRO stage 3 for every other model, a custom ``loss_fn`` or
  ``comm_compression.overlap = "off"`` (JAX's GSPMD and qgZ facade paths,
  ``_loss_and_grads_gather``): the model reads
  :class:`~deepspeed_tpu_torch.parallel.zero.Zero3Params` over the master
  shards, which gathers each layer's leaves inside its remat region
  (quantized under qwZ) and reduce-scatters their gradients to the shards
  in the backward pass (each leaf's facade mean under qgZ).

At stages 1-3 the global norm is the square root of an all-reduce of the
shards' squared sums (a leaf kept whole on every rank is counted on rank 0
only; stage 1 takes it over its whole gradients, as stage 0), the fp16
overflow flag is every rank's, and clipping and AdamW run on the shard.
With qgZ (``zero_quantized_gradients``, or ``comm_compression`` on at
stage 2 or 3) a micro-batch's gradients are the facade's mean
(JAX's ``tree_hierarchical_pmean``, leaf by leaf: ``qgz_mean``) of each
rank's gradients of the loss
over its own rows (JAX ``_loss_and_grads_qgz``, whose shard_map loss is a
rank's rows'): the compute copy then carries ``data_local``, and the
port's models take the loss over the rank's rows alone.

The JAX package jits the whole step (``_build_train_step``) and returns new
arrays; here the step runs eagerly and updates the master weights and the
optimizer moments IN PLACE (a second copy of 1.1e9 fp32 weights and two
moments would not fit beside the first on one card). When the model's own
parameters are fp32 on the engine's device they ARE the master weights, so
the model trains in place.

Loss protocol: ``loss_fn(params, batch) -> loss | (loss, aux)``, where
``params`` is the ``{name: tensor}`` compute copy (the names of the model's
``named_parameters()``) and ``batch`` a dict of tensors on the engine's
device; ``aux`` is dropped from the metrics, as the JAX engine drops it.
``initialize(model=...)`` uses ``model.loss(batch, params=...)``: any of
the port's models (every decoder and encoder flag set, CLIP, an MoE
model). A model's ``loss`` also gets ``generator=``, a fresh one for
every micro-batch, seeded from the engine's random stream
(``train_seed``, the JAX engine's ``self.rng`` split per micro-batch; a
noisy MoE gate draws its noise from it, other models ignore it). The
stream is a host generator, so drawing from it never waits for the card;
the draws differ from JAX's. A custom ``loss_fn`` gets no generator.

Checkpoints and fault tolerance (JAX ``save_checkpoint`` /
``load_checkpoint`` and the guards of ``_after_step``):
:meth:`TrainEngine.save_checkpoint` writes the state ``{params,
opt_state, scaler, step, rng}`` through
:class:`~deepspeed_tpu_torch.runtime.checkpoint.CheckpointEngine`'s
commit protocol, each leaf gathered to its full logical array (every rank
of the data and model groups takes part in each gather, in one order;
rank 0 writes), with ``micro_steps``, ``skipped_steps`` and the bound
loader's position in the client state. :meth:`load_checkpoint` reads the
newest valid tag (or ``tag``) and cuts each rank's slices again by this
engine's layout, so a tag saved at one stage, rank count or TP degree
loads at another. The config's ``checkpoint.save_dir`` turns on the
auto-save every ``save_interval`` steps, the rollback of the divergence
guard and the emergency save of an attached preemption guard; with every
guard off :meth:`_after_step` never runs (no extra host sync).

The rest of the JAX trainer's API: any optimizer rule of
``runtime/optimizers.py`` or a client one (``as_transform``); the compat
micro-step path (:meth:`TrainEngine.forward`, :meth:`~TrainEngine.
backward`, :meth:`~TrainEngine.step`) over the same micro-batch and
update code as :meth:`~TrainEngine.train_batch`; :meth:`~TrainEngine.
train_steps` (k steps with no host read between them, bitwise k
``train_batch`` calls, or per-step calls for JAX's reasons); warmup
(:meth:`~TrainEngine.warmup`: PyTorch compiles nothing ahead, so it
builds and loads the kernel libraries the step will launch and reads the
batch's description); ``register_param_transform`` (compression's QAT
and masks at the cast boundary); and step telemetry: the timers, the
throughput timer, the monitors and one StepStats record a step through
``telemetry.Telemetry``, with MFU from ``FlopCounterMode``'s count of
the first recorded step. With telemetry and every monitor off the step
reads nothing more back from the card than before (one read at the
``steps_per_print`` boundary).

ZeRO offload (JAX ``TrainEngine``'s ``offload_optimizer`` at every stage
and ``offload_param`` at stage 3): the optimizer state, and at stage 3
the fp32 master shards, are parked between steps in host memory
(``"cpu"``, pinned on a CUDA engine) or in files through the aio engine
(``"nvme"``, staged through host memory around the step), in
``runtime/swap_tensor.py``'s :class:`OffloadStore`. Where JAX uploads the
whole state around the step, the update here streams it (``_offload_update``):
each leaf's parked moments (and master) go to the device a window of
``buffer_count`` leaves ahead of the update on a side CUDA stream, the
leaf is updated by the same ``optimizer.update`` on a one-leaf sub-dict
(``count`` stepped once a step), and the result goes back to its host
tensor on a second side stream; so the state is on the card only for its
own update, and the trajectory is bitwise the resident engine's. A
transform that cannot be split (LAMB's whole-leaf norms, a client
optimizer) takes the whole state up around its update, as JAX does; the
step's metrics say which ran (``offload_streamed``). Parked masters feed
the compute copy leaf by leaf (cast onto the device), and checkpoints
read parked state without unparking it. Offload never falls back: a
failed pin, a failed aio build or a short swap file raises.

The JAX package's other ZeRO paths (ZeRO over a ``model`` axis, hpZ,
MiCS) come with later slices and raise (ROADMAP.md, Queue A).
"""

from __future__ import annotations

import contextlib
import math
import os
import re
import threading
import time
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import torch

from ..checkpoint import safetensors_io as sio
from ..comm import comm
from ..comm import compressed as ccomm
from ..comm.backends import dot_fp32, resolve_backend
from ..config import Config
from ..parallel.mesh import PartitionSpec, Topology, set_topology
from ..parallel.zero import (FusedBlockOps, ZeroShardingRules,
                             Zero3BlockSchedule, block_vjp, gather_slices,
                             qgz_mean, reduce_to_shards, shard_of,
                             sharded_dim, stack_counts, zero3_params)
from ..utils.device import resolve_device
from ..utils.logging import log_dist, logger
from ..utils.timer import SynchronizedWallClockTimer, ThroughputTimer
from . import loss_scaler as ls
from .checkpoint import (CheckpointEngine, Leaves, consolidate_full_state,
                         validate_tag_consistency)
from .lr_schedules import Schedule, build_schedule, constant_lr
from .optimizers import (Transform, as_transform, build_optimizer,
                         global_norm, sharded_global_norm)
from .swap_tensor import LeafStream, OffloadStore

Params = Dict[str, torch.Tensor]
LossFn = Callable[[Params, Dict[str, torch.Tensor]], Any]
# leaves of optimizer state made on the card before they are parked
_PARK_LEAVES = os.cpu_count() or 1


class _RowParams(dict):
    """A compute copy whose loss a model of the port takes over this
    rank's rows alone (``data_local``; the module docstring)."""

    data_local = True


class TrainEngine:
    """Trainer on one device, over a ``data`` x ``model`` mesh at stage 0,
    or ZeRO stages 1-3 over the ``data`` ranks (see the module docstring).
    ``device`` defaults to ``"cuda"`` and raises without a CUDA device
    unless ``device="cpu"`` is asked for. ``loss_fn`` None means the
    model's own ``loss``. ``topology`` (default: built from the config's
    ``mesh``) is the mesh; under ``model`` > 1 the model and ``params``
    must be this rank's shards (``initialize`` cuts them). At stage 3 the
    masters are copies of this rank's shards on ``device`` and the
    model's own weights are left as they are: a model built on the host
    keeps only the shards on the card."""

    def __init__(self, *, loss_fn: Optional[LossFn] = None,
                 params: Mapping[str, torch.Tensor], config: Config,
                 model: Optional[Any] = None,
                 optimizer: Optional[Transform] = None,
                 lr_scheduler: Optional[Schedule] = None, device=None,
                 topology: Optional[Topology] = None):
        self.config = config
        self.model = model
        self.device = resolve_device(device)
        if loss_fn is None:
            if model is None or not hasattr(model, "loss"):
                raise ValueError("TrainEngine needs a loss_fn or a model "
                                 "exposing .loss()")
            custom_loss = False

            def loss_fn(p, batch):
                return model.loss(batch, params=p,
                                  generator=self._next_generator())
        else:
            custom_loss = True
        self.loss_fn = loss_fn
        # the random stream: one generator a micro-batch is drawn from it
        self.rng = torch.Generator().manual_seed(config.train_seed)
        self._dataloader = None
        self.topo = topology if topology is not None else \
            Topology.build(config.mesh)
        set_topology(self.topo)
        dp = self.topo.data_parallel_size
        tp = self.topo.model_parallel_size
        self._stage = config.zero.stage
        self._route = self._zero_route(model, custom_loss)
        # the model's loss is its share of the global batch's when the
        # model reads the topology; another loss is a mean over the rank's
        # rows, divided by the data ranks here. Under qgZ (and the staged
        # schedule) the gradients are meaned over the ranks, so the loss
        # is each rank's rows' own
        shares = not custom_loss and hasattr(model, "bind_topology")
        if shares and tp == 1 and getattr(model, "_topo", None) is None:
            model.bind_topology(self.topo)
        self._data_local = dp > 1 and (self._qgz or self._route == "staged")
        self._shares = shares
        self._loss_div = dp if (dp > 1 and not self._data_local
                                and not shares) else 1
        if tp > 1:
            self._check_tensor_parallel(model, custom_loss)
        config.resolve_batch_config(dp)
        logger.info(f"batch config: train_batch={config.train_batch_size} "
                    f"micro_batch={config.train_micro_batch_size_per_gpu} "
                    f"gas={config.gradient_accumulation_steps} dp={dp}")

        # master params: fp32 on the device (no copy when already so); at
        # stage 3 each rank owns a copy of its shard of every leaf. The
        # optimizer state is laid out by state_spec (_state_layout)
        self.zero_rules = ZeroShardingRules(self.topo, config.zero)
        self.full_shapes = {n: tuple(p.shape) for n, p in params.items()}
        self._stack = stack_counts(list(params))
        self.param_specs: Dict[str, PartitionSpec] = {
            n: self.zero_rules.param_spec(s, self._stack[n])
            for n, s in self.full_shapes.items()}
        self.state_specs: Dict[str, PartitionSpec] = {
            n: self.zero_rules.state_spec(s)
            for n, s in self.full_shapes.items()}
        self.grad_specs = self.zero_rules.grad_specs(self.full_shapes)
        rank = self.topo.rank("data")
        self._offload_device = config.zero.offload_optimizer.device
        self._param_offload_device = (config.zero.offload_param.device
                                      if self._stage >= 3 else "none")
        # parked masters are built on the host, never whole on the card
        home = torch.device("cpu") if self._param_offload_device != "none" \
            else self.device
        masters: Params = {
            n: shard_of(p.detach(), self.param_specs[n], rank, dp).to(
                device=home, dtype=torch.float32,
                copy=(self._stage == 3 and dp > 1) or home != self.device)
            for n, p in params.items()}
        self.params: Optional[Params] = masters
        # leaves kept whole but updated as this rank's slice: all-gathered
        # after every update (stages 1-2; a stage-3 leaf kept whole below
        # the persistence threshold)
        self._regather = [n for n in params if dp > 1
                          and sharded_dim(self.param_specs[n]) is None
                          and sharded_dim(self.state_specs[n]) is not None]
        # tensor parallelism: the leaves cut over the model axis
        self.tp_sharded = frozenset(
            n for n in params if tp > 1 and "model" in model.leaf_spec(n))

        base_lr = float(config.optimizer.params.get("lr", 1e-3))
        if lr_scheduler is not None and callable(lr_scheduler):
            self.lr_schedule: Schedule = lr_scheduler
        elif config.scheduler.type:
            self.lr_schedule = build_schedule(config.scheduler.type,
                                              config.scheduler.params, base_lr)
        else:
            self.lr_schedule = constant_lr(base_lr)
        if optimizer is None:
            self.optimizer = build_optimizer(config.optimizer.type,
                                             config.optimizer.params,
                                             lr_schedule=self.lr_schedule)
        else:
            self.optimizer = as_transform(optimizer)
        layout = self._state_layout(masters)
        # the leaves the optimizer sees as a slice of the data group's
        # leaf (ZeRO): LAMB's norms sum them over the group
        self._sliced = frozenset(
            n for n, t in layout.items()
            if t.numel() < math.prod(self.full_shapes[n]))
        self._init_offload(config, masters, layout)
        del masters, layout

        fp16 = config.fp16
        if fp16.enabled and fp16.dynamic_loss_scale:
            self.scaler_state = ls.make_state(fp16.initial_scale_power,
                                              fp16.hysteresis)
        elif fp16.enabled:
            self.scaler_state = ls.static_state(fp16.loss_scale)
        else:
            self.scaler_state = ls.static_state(1.0)

        self.compute_dtype = config.compute_dtype
        self.global_steps = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        self._init_fault_tolerance(config)
        self._init_observability(config)
        # the compat path's accumulator: (grads, loss sum, errors)
        self._acc = None
        self._last_loss = None
        # a transform of the compute copy (compression: QAT, masks)
        self._param_transform: Optional[Callable[[Params], Params]] = None
        self._warmup_thread: Optional[threading.Thread] = None
        #: the last warmup's result (None before one ran)
        self.warmed_up: Optional[bool] = None
        self._loader_iter = None          # train_steps(k)'s pulls
        self._loader_iter_src = None
        self._steps_fallback_logged: set = set()

    def _init_observability(self, config: Config) -> None:
        """Timers, the throughput timer, the monitors and telemetry (JAX
        ``TrainEngine.__init__``'s bookkeeping block). With telemetry and
        every monitor off, ``telemetry.wants_step_records`` is False and
        the step keeps its reads of the card as they were."""
        from ..telemetry import Telemetry

        self.timers = SynchronizedWallClockTimer()
        self.tput = ThroughputTimer(batch_size=config.train_batch_size,
                                    steps_per_output=config.steps_per_print,
                                    monitor_memory=config.memory_breakdown)
        self.monitor = None
        if config.monitor.enabled:
            from ..monitor.monitor import MonitorMaster

            self.monitor = MonitorMaster(config.monitor)
        self.telemetry = Telemetry(config.telemetry, monitor=self.monitor)
        if config.telemetry.enabled:
            from ..resilience.counters import restart_count_from_env
            from ..telemetry import set_telemetry

            set_telemetry(self.telemetry)
            restart_count_from_env()
        if config.comms_logger.enabled or config.telemetry.enabled:
            # switched on for the whole process and never off, as the JAX
            # engine does: the records' comm breakdown reads the ledger
            comm.configure_comms_logger(enabled=True,
                                        verbose=config.comms_logger.verbose)
        self._step_flops: Optional[float] = None
        self._peak_flops: Optional[float] = None
        self._tokens_per_batch: Optional[int] = None
        self._comm_totals_prev: Dict[str, Dict[str, float]] = {}
        self._last_call_end_t: Optional[float] = None
        self._data_wait_prev_s = 0.0
        self._closed = False

    def _init_fault_tolerance(self, config: Config) -> None:
        """The checkpoint engine and the guards (JAX ``TrainEngine``'s
        fault-tolerance block). With every knob off ``_ft_active`` stays
        False and the step path reads nothing back from the device."""
        ck = config.checkpoint
        self.ckpt_engine = CheckpointEngine(
            async_save=ck.async_save, keep_last_n=ck.keep_last_n,
            verify_checksums=ck.verify_checksums)
        self.last_load: Dict[str, Any] = {}
        rcfg = config.resilience
        self._step_hooks: List[Callable[["TrainEngine", int], None]] = []
        self._nan_skip = rcfg.divergence.nan_action == "skip"
        self._divergence = None
        if rcfg.divergence.wants_host_check:
            from ..resilience.divergence import DivergenceGuard

            dv = rcfg.divergence
            self._divergence = DivergenceGuard(
                nan_action=dv.nan_action, spike_action=dv.spike_action,
                spike_factor=dv.spike_factor, window=dv.window,
                warmup_steps=dv.warmup_steps)
        self.preemption_guard = None
        self._stop_reason: Optional[str] = None
        self._rollback_streak = 0   # rollbacks without progress past...
        self._ft_high_step = 0      # ...this high-water step
        self._ckpt_save_dir = ck.save_dir
        self._ft_active = (self._divergence is not None
                           or bool(self._ckpt_save_dir
                                   and ck.save_interval > 0))
        if rcfg.chaos.enabled:
            from ..resilience.chaos import (FaultInjector,
                                            install_fault_injector)

            inj = install_fault_injector(FaultInjector(rcfg.chaos))
            self.register_step_hook(lambda _eng, step: inj.on_step(step))

    # ------------------------------------------------------------------
    # ZeRO offload (JAX TrainEngine's offload block; the module docstring)
    def _init_offload(self, config: Config, masters: Params,
                      layout: Params) -> None:
        """The optimizer state, and the stores offload parks it and the
        masters in. A separable transform's state is made on the device a
        leaf at a time and each leaf parked at once; another's is made
        whole on the device, then parked."""
        import tempfile

        self._opt_store: Optional[OffloadStore] = None
        self._param_store: Optional[OffloadStore] = None
        self._stream: Optional[LeafStream] = None
        self._opt_skeleton = None      # "nvme": the state, trees as templates
        self._opt_tree_fields: List[str] = []
        self._offload_streamed: Optional[bool] = None
        opt_off, param_off = self._offload_device, self._param_offload_device
        if opt_off == "none" and param_off == "none":
            self.opt_state = self.optimizer.init(layout)
            return
        zero = config.zero

        def store(mode: str, block) -> OffloadStore:
            path = block.nvme_path or os.path.join(tempfile.gettempdir(),
                                                   "dst_torch_swap")
            if comm.get_world_size() > 1:
                path = os.path.join(path, f"rank{comm.get_rank()}")
            return OffloadStore(mode, self.device, path)

        if param_off != "none":
            self._param_store = store(param_off, zero.offload_param)
            self._param_store.park("", masters)
            self.params = self._param_store.trees.get("")
        if opt_off != "none":
            self._opt_store = store(opt_off, zero.offload_optimizer)
        block = zero.offload_optimizer if opt_off != "none" \
            else zero.offload_param
        self._stream = LeafStream(self.device, block.buffer_count)
        parked = self._opt_store
        trees: Dict[str, Params] = {}
        if self.optimizer.separable:
            state = None
            for i, (n, t) in enumerate(layout.items()):
                state = self.optimizer.init({n: t.to(self.device)})
                for f, v in self._state_fields(state).items():
                    if isinstance(v, dict):
                        trees.setdefault(f, {})[n] = \
                            v[n].to("cpu") if opt_off == "nvme" else v[n]
                # "cpu": parked a few leaves at a time (their host memory
                # made side by side), so the card holds only those
                if opt_off == "cpu" and ((i + 1) % _PARK_LEAVES == 0
                                         or i + 1 == len(layout)):
                    for f, tree in trees.items():
                        parked.park(f, tree)
                    trees = {}
        else:
            state = self.optimizer.init({n: t.to(self.device)
                                         for n, t in layout.items()})
            if parked is None:         # the masters alone are parked
                self.opt_state = state
                return
            trees = {f: v for f, v in self._state_fields(state).items()
                     if isinstance(v, dict)}
            if opt_off == "cpu":
                for f, tree in trees.items():
                    parked.park(f, tree)
        self._opt_tree_fields = [f for f, v in self._state_fields(
            state).items() if isinstance(v, dict)]
        if opt_off == "nvme":
            for f, tree in trees.items():
                parked.park(f, tree)
            self._opt_skeleton = state._replace(**{
                f: parked.template(f) for f in self._opt_tree_fields})
            self.opt_state = None
        elif opt_off == "cpu":
            self.opt_state = state._replace(**{
                f: parked.host(f) for f in self._opt_tree_fields})
        else:
            self.opt_state = state._replace(**trees)

    def _state_fields(self, state) -> Dict[str, Any]:
        as_dict = getattr(state, "_asdict", None)
        if as_dict is None:
            raise NotImplementedError(
                f"ZeRO offload parks an optimizer state that is a "
                f"NamedTuple of trees (the port's rules); this optimizer's "
                f"state is a {type(state).__name__}")
        return as_dict()

    @property
    def _offloaded(self) -> bool:
        return self._stream is not None

    def _params_to_device(self) -> None:
        """The masters where the step reads them (JAX
        ``_params_to_device``): under ``"nvme"`` read from their files into
        host memory; under ``"cpu"`` they are read where they lie (the
        compute copy casts each onto the device)."""
        if self._param_offload_device == "nvme" and self.params is None:
            self._param_store.stage([""])
            self.params = self._param_store.host("")

    def _params_to_offload(self) -> None:
        """Under ``"nvme"``, the step's masters back to their files."""
        if self._param_offload_device == "nvme" and self.params is not None:
            self._fence()
            self._param_store.unstage()
            self.params = None

    def _fence(self) -> None:
        """Wait for the stream's last write-back before the host reads a
        parked tensor."""
        if self._stream is not None:
            self._stream.fence()

    def _materialized_params(self) -> Params:
        """The masters for reading (JAX ``_materialized_params``): read
        from their files under ``"nvme"`` between steps, without
        unparking them."""
        if self.params is not None:
            return self.params
        return self._param_store.read("")

    def _opt_view(self):
        """The optimizer state as a NamedTuple (under ``"nvme"`` its trees
        are templates: shapes and dtypes)."""
        return self._opt_skeleton if self._offload_device == "nvme" \
            else self.opt_state

    def offload_stats(self) -> Dict[str, float]:
        """The last step's offload copies (bytes and seconds each way:
        device-event time on a CUDA engine), the window's peaks (leaves
        and bytes), and under ``"nvme"`` each store's last swap-out and
        swap-in (bytes, host seconds) and bytes on disk. Waits for the
        copies."""
        out = self._stream.copy_stats() if self._stream else {}
        for what, st in (("opt", self._opt_store),
                         ("param", self._param_store)):
            if st is not None and st.swapper is not None:
                out.update({f"{what}_{k}": v
                            for k, v in st.swapper.last.items()})
                out[f"{what}_bytes_on_disk"] = float(st.bytes_on_disk())
        return out

    def _offload_update(self, grads: Params, kw: Dict[str, Any]) -> None:
        """The optimizer step over parked state (the module docstring): a
        separable transform streams it leaf by leaf (``LeafStream``), any
        other takes the whole state up around one update. ``grads`` is
        emptied."""
        fields = self._opt_tree_fields
        ostore, pstore = self._opt_store, self._param_store
        if ostore is not None:
            ostore.stage(fields)
        state = self._opt_view()
        regather = set(self._regather)
        if self.optimizer.separable:
            hosts = {}
            for n in self.full_shapes:
                h = {f: ostore.host(f)[n] for f in fields} \
                    if ostore is not None else {}
                if pstore is not None:
                    h[""] = self.params[n]
                hosts[n] = h
            last = []

            def leaf(n: str, dev: Params) -> Params:
                p = dev[""] if "" in dev else self.params[n]
                sub = state._replace(**{f: {n: dev[f] if f in dev
                                            else getattr(state, f)[n]}
                                        for f in fields})
                new = self.optimizer.update(
                    self._state_layout({n: grads.pop(n)}), sub,
                    self._state_layout({n: p}), **kw)
                if n in regather:
                    self._gather_masters({n: p})
                last[:] = [new]
                out = {f: getattr(new, f)[n] for f in fields if f in dev}
                if "" in dev:
                    out[""] = p
                return out

            self._stream.reset_stats()
            self._stream.run(list(self.full_shapes), hosts, leaf)
            new = last[0]
        else:
            dev = {f: {n: t.to(self.device) for n, t in
                       ostore.host(f).items()} for f in fields}
            masters = {n: t.to(self.device) for n, t in self.params.items()}
            new = self.optimizer.update(
                self._state_layout(grads),
                state._replace(**dev) if dev else state,
                self._state_layout(masters), **kw)
            grads.clear()
            self._gather_masters(masters)
            if ostore is not None:
                for f in fields:
                    for n, t in ostore.host(f).items():
                        t.copy_(getattr(new, f)[n])
            if pstore is not None:
                for n, t in self.params.items():
                    t.copy_(masters[n])
        self._offload_streamed = bool(self.optimizer.separable)
        if ostore is None and not self.optimizer.separable:
            self.opt_state = new       # resident, any kind of state
            return
        rest = {f: v for f, v in new._asdict().items() if f not in fields}
        if self._offload_device == "nvme":
            self._fence()
            ostore.unstage()
            self._opt_skeleton = state._replace(**rest)
        else:
            self.opt_state = state._replace(**rest)

    def _zero_route(self, model, custom_loss: bool) -> str:
        """The facade's qwZ / qgZ legs, the kernel backend and the step's
        route (JAX ``TrainEngine.__init__``): ``"staged"`` (stage 3, a
        model with ``zero3_blocks`` on its own loss, overlap on),
        ``"gather"`` (stage 3 otherwise, over two or more data ranks: the
        facade path, :meth:`_loss_and_grads_gather`) or ``"whole"``
        (stages 0-2, and stage 3 on one rank: whole parameters in the
        forward and backward passes)."""
        cfg = self.config
        cc = cfg.comm_compression
        dp = self.topo.data_parallel_size
        stage = cfg.zero.stage
        cc_on = cc.resolve_enabled(dp)
        self._qwz = (bool(cfg.zero.zero_quantized_weights) or cc_on) \
            and stage >= 3
        self._qgz = bool(cfg.zero.zero_quantized_gradients) or (
            cc_on and stage >= 2)
        self._overlapped = cc.overlap == "staged"
        self._comm_backend = resolve_backend(cc.kernel_backend, self.device)
        self._wants_quant_err = bool(cc.error_stats)
        if stage < 3:
            return "whole"
        blocks = model is not None and hasattr(model, "zero3_blocks")
        if blocks and not custom_loss and cc.overlap != "off":
            return "staged"
        if blocks:
            logger.warning(
                "staged ZeRO-3 schedule off: "
                + ("a custom loss_fn was given, and the model's zero3_blocks"
                   " defines its own loss_tail" if custom_loss else
                   "comm_compression.overlap is 'off'")
                + "; training proceeds on the facade path")
        return "gather" if dp > 1 else "whole"

    def _check_tensor_parallel(self, model, custom_loss: bool) -> None:
        """``model`` > 1 trains a model of the port cut over the model
        axis, on its own loss."""
        tp = self.topo.model_parallel_size
        if custom_loss or not hasattr(model, "leaf_spec"):
            raise ValueError(
                f"mesh.model = {tp} trains a model of deepspeed_tpu_torch "
                f"(one with partition_specs) on its own loss; a custom "
                f"loss_fn over sharded leaves is not supported")
        if self._qgz:
            raise NotImplementedError(
                f"quantized gradients (qgZ) beside mesh.model = {tp} come "
                f"with a later slice of deepspeed_tpu_torch (ROADMAP.md, "
                f"Queue A item 12)")
        if getattr(model, "_topo", None) is None:
            raise ValueError(
                f"mesh.model = {tp}: the model is not cut to this rank's "
                f"shards; build the engine through initialize(), or call "
                f"model.shard_(topology) first")

    # ------------------------------------------------------------------
    @property
    def train_batch_size(self) -> int:
        return self.config.train_batch_size

    @property
    def train_micro_batch_size_per_gpu(self) -> int:
        return self.config.train_micro_batch_size_per_gpu

    @property
    def gradient_accumulation_steps(self) -> int:
        return self.config.gradient_accumulation_steps

    @property
    def gradient_clipping(self) -> float:
        return self.config.gradient_clipping

    def get_lr(self) -> float:
        return float(self.lr_schedule(self.global_steps))

    def get_loss_scale(self) -> float:
        return float(self.scaler_state.scale)

    # ------------------------------------------------------------------
    def _compute_copy(self, data_local: Optional[bool] = None) -> Params:
        """Every floating master leaf cast to the compute dtype on the
        engine's device, as a leaf that records its gradient (for fp32
        compute, a view of a resident master, a device copy of a parked
        one; nothing writes it before the gradient is taken);
        ``data_local`` (by default under qgZ)."""
        if data_local is None:
            data_local = self._data_local
        kind = _RowParams if data_local else dict
        return kind((n, p.to(device=self.device, dtype=self.compute_dtype,
                              non_blocking=True).detach().requires_grad_(True)
                     if p.is_floating_point() else p)
                    for n, p in self._materialized_params().items())

    def _transformed(self, pc: Params) -> Params:
        """The compute copy through the registered params transform (the
        same mapping type: ``data_local`` rides along)."""
        if self._param_transform is None:
            return pc
        return type(pc)(self._param_transform(pc))

    def _next_generator(self) -> torch.Generator:
        """A fresh host generator for one micro-batch, seeded from the
        stream (the JAX ``rng, sub = split(rng)``). A noisy MoE model
        seeds each layer's device generator from it, so the remat replay
        redraws the same noise."""
        seed = int(torch.randint(0, 2 ** 62, (), generator=self.rng))
        return torch.Generator().manual_seed(seed)

    def _loss(self, params: Params, batch) -> torch.Tensor:
        out = self.loss_fn(params, batch)
        loss = out[0] if isinstance(out, tuple) else out
        return loss / self._loss_div if self._loss_div > 1 else loss

    def _my_rows(self, batch: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """This rank's rows of a (micro-)batch: ``P("data")``."""
        dp = self.topo.data_parallel_size
        if dp == 1:
            return batch
        rank = self.topo.rank("data")
        n = next(iter(batch.values())).shape[0] // dp
        return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}

    def _data_sum(self, grads: Params, loss: torch.Tensor):
        """The data group's sum of every gradient and of the loss, in one
        flat all-reduce (the shares add up to the global batch's)."""
        names = list(grads)
        flat = torch.cat([grads[n].reshape(-1) for n in names]
                         + [loss.reshape(1)])
        flat = comm.group_sum(flat, self.topo.group("data"), "data")
        off = 0
        for n in names:
            k = grads[n].numel()
            grads[n] = flat[off:off + k].view_as(grads[n])
            off += k
        return grads, flat[-1]

    def bind_dataloader(self, loader: Any) -> None:
        """Bind the loader that feeds this engine (``initialize`` binds the
        one it builds from ``training_data``): checkpoints carry its
        position (the consumer's: the batch it hands out next) in the
        client state, and :meth:`load_checkpoint` restores it, so a
        resumed run replays the exact remaining batch order;
        ``train_steps(k)`` pulls its batches from it."""
        self._dataloader = loader
        self._loader_iter = None
        self._loader_iter_src = None
        self._data_wait_prev_s = float(getattr(loader, "data_wait_s", 0.0)
                                       or 0.0)

    def _loss_and_grads(self, batch, scale: float):
        """One micro-batch: (fp32 gradients of ``scale * loss`` with respect
        to the masters, unscaled loss). The gradient with respect to an
        fp32 master is its compute copy's gradient upcast to fp32 — what
        ``jax.grad`` through the cast gives."""
        pc = self._compute_copy()
        names = [n for n, p in pc.items() if p.requires_grad]
        with torch.enable_grad():
            loss = self._loss(self._transformed(pc), batch)
            grads = torch.autograd.grad(loss.float() * scale,
                                        [pc[n] for n in names],
                                        allow_unused=True)
        out = {n: (self._zero_grad(n) if g is None else g.float())
               for n, g in zip(names, grads)}
        return out, loss.detach().float()

    def _zero_grad(self, name: str) -> torch.Tensor:
        """The fp32 gradient of a master the loss did not use."""
        return torch.zeros(self.params[name].shape, dtype=torch.float32,
                           device=self.device)

    def _micro_batch(self, mb, scale: float):
        """One micro-batch of the global batch on the step's route:
        (gradients, loss, aux). On the ``"whole"`` route the gradients of
        this rank's rows, then over two or more data ranks under qgZ the
        facade's mean (and the loss's), cut to the rank's shards at stage
        2; at stage 2 without qgZ, reduce-scattered to them. Stages 0-1
        without qgZ sum over the data group once a step
        (:meth:`_data_sum`)."""
        if self._route == "staged":
            return self._loss_and_grads_zero3(mb, scale)
        if self._route == "gather":
            return self._loss_and_grads_gather(self._my_rows(mb), scale)
        grads, loss = self._loss_and_grads(self._my_rows(mb), scale)
        dp = self.topo.data_parallel_size
        if dp == 1:
            return grads, loss, {}
        rank = self.topo.rank("data")
        aux = {}
        if self._qgz:
            _, gq = self._facade_qspecs()
            stats = [] if self._wants_quant_err else None
            grads = {n: qgz_mean(g, dp, gq, self._stack[n], stats)
                     for n, g in grads.items()}
            loss = ccomm.pmean(loss, "data")
            if self._stage >= 2:
                grads = {n: shard_of(g, self.grad_specs[n], rank, dp).clone()
                         for n, g in grads.items()}
            if stats is not None:
                aux["quant_rel_err"] = self._quant_err(stats)
        elif self._stage >= 2:
            names = list(grads)
            shards = reduce_to_shards(
                [grads.pop(n) for n in names],
                [self.grad_specs[n] for n in names], self.topo.group("data"),
                rank, dp, "zero_grad")
            grads = dict(zip(names, shards))
        return grads, loss, aux

    def _quant_err(self, stats) -> torch.Tensor:
        """The largest quantization error of this micro-batch's facade
        collectives over the data ranks."""
        local = (torch.stack(stats).max() if stats else
                 torch.zeros((), device=self.device))
        return ccomm.pmax(local, "data")

    def _zero3_view(self, stats=None, data_local: bool = False):
        """:class:`Zero3Params` over this rank's master shards, each a leaf
        that records its gradient (a view: nothing writes the masters
        before the gradient is taken)."""
        wq, gq = self._facade_qspecs()
        shards = {n: p.to(self.device).detach().requires_grad_(True)
                  for n, p in self.params.items()}
        return zero3_params(shards, self.param_specs, self.topo,
                            self.compute_dtype, wq=wq, gq=gq, stats=stats,
                            data_local=data_local)

    def _loss_and_grads_gather(self, batch, scale: float):
        """One micro-batch of ZeRO-3 for a model without ``zero3_blocks``
        (JAX's GSPMD path, or ``_loss_and_grads_qgz`` under qgZ): the loss
        over :class:`Zero3Params`, whose gathers and reduce-scatters run
        inside the forward and backward passes. Returns (this rank's fp32
        gradient shards, the leaves kept whole reduced whole; its loss
        share, or under qgZ the loss meaned over the ranks; aux)."""
        stats = [] if self._wants_quant_err and (self._qwz or self._qgz) \
            else None
        view = self._zero3_view(stats, self._data_local)
        names = list(self.params)
        with torch.enable_grad():
            loss = self._loss(view, batch)
            grads = torch.autograd.grad(loss.float() * scale,
                                        [view.shard(n) for n in names],
                                        allow_unused=True)
        out = {n: (self._zero_grad(n) if g is None else g)
               for n, g in zip(names, grads)}
        loss = loss.detach().float()
        if self._data_local:
            loss = ccomm.pmean(loss, "data")
        aux = {} if stats is None else {"quant_rel_err":
                                        self._quant_err(stats)}
        return out, loss, aux

    def _state_layout(self, tree: Params) -> Params:
        """A tree keyed like the masters (the masters, their gradients)
        as the optimizer sees it: each leaf that is whole here cut to this
        rank's ``state_spec`` slice (a view); a stage-3 shard as it is."""
        dp = self.topo.data_parallel_size
        if dp == 1:
            return tree
        rank = self.topo.rank("data")
        return {n: shard_of(t, self.state_specs[n], rank, dp)
                if tuple(t.shape) == self.full_shapes[n] else t
                for n, t in tree.items()}

    # ------------------------------------------------------------------
    # ZeRO-3: the staged block schedule over the facade
    def _facade_qspecs(self):
        cc = self.config.comm_compression
        wq = ccomm.QuantSpec(cc.weight_bits, cc.weight_block) \
            if self._qwz else None
        gq = ccomm.QuantSpec(cc.grad_bits, cc.grad_block) \
            if self._qgz else None
        return wq, gq

    def _facade_axes(self):
        """(outer, outer_world): the axis the facade's quantized hops cross,
        None on one rank (every facade op then does nothing). The JAX
        engine's inner (``zshard``, hpZ) hop comes with a later slice."""
        dp = self.topo.data_parallel_size
        return ("data" if dp > 1 else None), dp

    def _facade_prelude(self):
        """What the staged step shares with the JAX facade paths' setup:
        the axes, the quant specs, the compute copy of this rank's shards,
        and the per-block spec dicts (``zero3_blocks`` is structural in
        params, so it is called on the specs)."""
        outer, outer_world = self._facade_axes()
        wq, gq = self._facade_qspecs()
        structure = self.model.zero3_blocks(self.param_specs, None)
        pc = {n: p.to(self.device, self.compute_dtype)
              for n, p in self.params.items()}
        return dict(outer=outer, outer_world=outer_world, wq=wq, gq=gq,
                    pc=pc, specs=structure.blocks,
                    mm_specs=structure.matmul_blocks)

    def _loss_and_grads_zero3(self, batch, scale: float):
        """One micro-batch of the global batch under ZeRO-3: this rank's
        rows (``P("data")``) through the staged step; the reduced gradients
        sliced to this rank's shards. Returns (shard grads, loss meaned
        over the ranks, aux)."""
        dp = self.topo.data_parallel_size
        rank = self.topo.rank("data")
        grads, loss, aux = self._loss_and_grads_staged(self._my_rows(batch),
                                                       scale)
        shards = {}
        for name, g in grads.items():
            g = shard_of(g.float(), self.param_specs[name], rank, dp)
            shards[name] = g.clone() if dp > 1 else g
        return shards, loss, aux

    def _loss_and_grads_staged(self, batch, scale: float):
        """The staged ZeRO-3 step (JAX ``_loss_and_grads_staged``): the
        model's blocks run with per-block facade collectives, the next
        block's gather issued before this block's compute and a block's
        gradient reduce deferred behind the next block's backward
        (``overlap="staged"``), or each at its consumer (``"serial"``).
        Blocks whose matmul weight is sharded on its output dim over
        ``data`` take the fused backend's ops (``_fused_block_ops``).
        Returns (full reduced fp32 grads, loss meaned over the ranks,
        aux)."""
        env = self._facade_prelude()
        outer, dp = env["outer"], env["outer_world"]
        wq, gq, specs = env["wq"], env["gq"], env["specs"]
        stats = [] if self._wants_quant_err else None
        fusable = {}
        if self._comm_backend.name == "pallas" and env["mm_specs"] and outer:
            for i, ms in enumerate(env["mm_specs"]):
                wspec = specs[i].get(ms.weight) if ms is not None else None
                if wspec is not None and [
                        (d, e) for d, e in enumerate(wspec)
                        if e is not None] == [(1, outer)]:
                    fusable[i] = ms
        prog = self.model.zero3_blocks(env["pc"], batch)
        outer_axes = (outer,) if outer else ()

        def gather(i, blk):
            return {k: ccomm.gather_param_leaf(x, specs[i][k],
                                               outer_axes=outer_axes,
                                               qspec=wq, stats=stats)
                    for k, x in blk.items()}

        def reduce(i, g):
            return ccomm.tree_hierarchical_pmean(
                g, outer_axis=outer, outer_world=dp, qspec=gq, stats=stats)

        fused = {i: self._fused_block_ops(ms, specs[i], outer, stats)
                 for i, ms in fusable.items()}
        sched = Zero3BlockSchedule(gather, reduce,
                                   overlapped=self._overlapped, fused=fused)
        loss, block_grads = sched.loss_and_grads(prog, scale)
        grads = prog.merge(block_grads)
        loss = ccomm.pmean(loss.float(), "data")
        aux = {}
        if stats is not None:
            local = (torch.stack(stats).max() if stats else
                     torch.zeros((), device=self.device))
            aux["quant_rel_err"] = ccomm.pmax(local, "data")
        return grads, loss, aux

    def _fused_block_ops(self, ms, spec_tree, outer: str, stats):
        """FusedBlockOps of one matmul block (JAX ``_fused_block_ops``):
        the forward gathers the weight inside the matmul (ring), the
        backward re-gathers it through the facade for the data path,
        recomputes y for the epilogue's vjp, and reduces the weight
        gradient through the backend (quantized in the kernel's
        epilogue); the other leaves (the bias) take the facade's generic
        gather and reduce."""
        backend = self._comm_backend
        wkey = ms.weight
        wq, gq = self._facade_qspecs()
        dp = self._facade_axes()[1]
        min_size = 4 * dp * (gq.block if gq else 1)

        def gather_rest(blk):
            return {k: ccomm.gather_param_leaf(v, spec_tree[k],
                                               outer_axes=(outer,), qspec=wq,
                                               stats=stats)
                    for k, v in blk.items() if k != wkey}

        def forward(blk, h):
            rest = gather_rest(blk)
            y = backend.all_gather_matmul(h, blk[wkey], outer, dim=1,
                                          qspec=wq, stats=stats)
            return ms.epilogue(y, rest, h)

        def backward(blk, h_in, g_out):
            w_full = ccomm.gather_param_leaf(blk[wkey], spec_tree[wkey],
                                             outer_axes=(outer,), qspec=wq,
                                             stats=stats)
            rest = gather_rest(blk)
            y = dot_fp32(h_in, w_full).to(h_in.dtype)
            (g_y, g_rest), g_h_epi = _epilogue_vjp(ms.epilogue, y, rest,
                                                   h_in, g_out)
            g_w = backend.matmul_reduce_scatter(
                h_in, g_y, outer_axis=outer, outer_world=dp, qspec=gq,
                min_quant_size=min_size, stats=stats)
            grads = ccomm.tree_hierarchical_pmean(
                g_rest, outer_axis=outer, outer_world=dp, qspec=gq,
                stats=stats)
            g_h = g_h_epi + dot_fp32(g_y, w_full.t()).to(h_in.dtype)
            grads[wkey] = g_w.float()
            return grads, g_h

        return FusedBlockOps(forward=forward, backward=backward)

    def full_params(self) -> Params:
        """The full fp32 master weights on every rank: a dense gather of
        the shards at stage 3; under ``model`` > 1 each cut leaf's
        shards joined over the model group along its ``model`` dimension
        in rank order (``checkpoint.jax_params.gather_params``' layout);
        else the masters themselves."""
        if self.tp_sharded:
            return self.full_width(self.params)
        return {n: ccomm.gather_param_leaf(p.to(self.device),
                                           self.param_specs[n])
                for n, p in self._materialized_params().items()}

    def full_state(self, tree: Params) -> Params:
        """A tree laid out as the optimizer sees it (its moments, the
        gradients it was given: this rank's ``state_spec`` slices) with
        each leaf gathered whole over the data group. Every rank of the
        group must call it."""
        return {n: ccomm.gather_param_leaf(t, self.state_specs[n])
                if tuple(t.shape) != self.full_shapes[n] else t
                for n, t in tree.items()}

    def full_width(self, tree: Params) -> Params:
        """A tree keyed like the masters (their gradients, moments) with
        each leaf cut over the model axis joined to full width: the
        model group's shards along its ``model`` dimension, in rank
        order. Every rank of the group must call it."""
        group = self.topo.group("model") if self.tp_sharded else None
        out = {}
        for n, t in tree.items():
            if n in self.tp_sharded:
                dim = list(self.model.leaf_spec(n)).index("model")
                t = torch.cat(comm.all_gather(t.contiguous(), group), dim=dim)
            out[n] = t
        return out

    # ------------------------------------------------------------------
    def _to_device(self, batch: Mapping[str, Any],
                   rows: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """``batch`` as tensors on the engine's device, checked to have
        ``rows`` rows (default: ``train_batch_size``)."""
        rows = self.train_batch_size if rows is None else rows
        out = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
        got = {v.shape[0] for v in out.values()}
        if got != {rows}:
            what = ("train_batch_size" if rows == self.train_batch_size
                    else "a micro-batch (train_batch_size / gas)")
            raise ValueError(f"batch leaves have {sorted(got)} rows; "
                             f"{what} is {rows}")
        return out

    def _scale(self) -> float:
        return self.scaler_state.scale if self.config.fp16.enabled else 1.0

    def _accumulate(self, acc, mb, scale: float):
        """One micro-batch of the global batch (:meth:`_micro_batch`)
        added to the step's accumulator ``acc`` = (fp32 gradients, loss
        sum, quantization errors), None before the first. Returns (the
        accumulator, the micro-batch's loss)."""
        g, l, aux = self._micro_batch(mb, scale)
        if acc is None:
            acc = (g, l, [])
        else:
            grads, loss, errs = acc
            for n in grads:
                grads[n].add_(g[n])
            acc = (grads, loss + l, errs)
        del g
        if "quant_rel_err" in aux:
            acc[2].append(aux["quant_rel_err"])
        return acc, l

    def _apply(self, acc, scale: float) -> Dict[str, Any]:
        """The step boundary of an accumulated global batch: the data
        group's sums (stages 0-1), the mean over GAS, the update
        (:meth:`_update`). Returns the step's metrics."""
        grads, loss, errs = acc
        gas = self.gradient_accumulation_steps
        if self.topo.data_parallel_size > 1 and not self._data_local:
            if self._route == "whole" and self._stage < 2:
                grads, loss = self._data_sum(grads, loss)
            else:       # the gradients came reduced; the loss shares
                loss = comm.group_sum(loss, self.topo.group("data"), "data")
        if gas > 1:
            inv = 1.0 / gas
            for g in grads.values():
                g.mul_(inv)
            loss = loss * inv
        self._offload_streamed = None
        gnorm, skipped = self._update(grads, scale)
        out = {"loss": loss, "grad_norm": gnorm,
               "loss_scale": self.get_loss_scale(), "skipped": skipped}
        if self._offload_streamed is not None:
            # which offload path updated the state: streamed or whole
            out["offload_streamed"] = self._offload_streamed
        if errs:
            out["quant_rel_err"] = torch.stack(errs).max()
        return out

    def _step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """One optimizer step over a global batch on the device: GAS
        micro-batches ``x.reshape(gas, B / gas, ...)[i]``, accumulated and
        applied. Reads nothing back from the card (but fp16's and the
        ``nan_action="skip"`` finiteness flag)."""
        gas = self.gradient_accumulation_steps
        scale = self._scale()
        acc = None
        for i in range(gas):
            mb = batch if gas == 1 else {
                k: v.reshape((gas, v.shape[0] // gas) + v.shape[1:])[i]
                for k, v in batch.items()}
            acc, _ = self._accumulate(acc, mb, scale)
        return self._apply(acc, scale)

    def _counted(self) -> contextlib.AbstractContextManager:
        """A ``FlopCounterMode`` around the first step that telemetry
        records (the MFU numerator: the operations that run, the remat
        replay included), else nothing."""
        if self._step_flops is not None \
                or not self.telemetry.wants_step_records:
            return contextlib.nullcontext()
        from torch.utils.flop_counter import FlopCounterMode

        return FlopCounterMode(display=False)

    def _note_flops(self, counter, n_steps: int = 1) -> None:
        if counter is not None and hasattr(counter, "get_total_flops"):
            self._step_flops = float(counter.get_total_flops()) / n_steps

    def train_batch(self, batch: Mapping[str, Any]) -> Dict[str, Any]:
        """One optimizer step over a global batch of ``train_batch_size``
        rows (every rank passes the same global batch): GAS micro-batches
        are ``x.reshape(gas, B / gas, ...)[i]``, and over data ranks each
        rank takes its rows of each (:meth:`_micro_batch`); their fp32
        gradients are summed and scaled by ``1 / gas``, and so are their
        losses. Returns ``{"loss", "grad_norm"}`` (0-dim fp32 tensors on
        the device), ``"loss_scale"`` and ``"skipped"``, and
        ``"quant_rel_err"`` under ``comm_compression.error_stats``.
        The step hooks (chaos, compression) run first; a pending warmup
        is joined; the guards, emergency save and auto-save after the
        step (:meth:`_after_step`); a step record when telemetry or a
        monitor is on."""
        t_entry = time.perf_counter()
        for hook in self._step_hooks:
            hook(self, self.global_steps)
        self._join_warmup()
        batch = self._to_device(batch)
        self._note_batch_shape(batch)
        want = self.telemetry.wants_step_records
        self.tput.start()
        self._params_to_device()
        with self._counted() as counter:
            out = self._step(batch)
        self._params_to_offload()
        self._note_flops(counter)
        t_dispatched = time.perf_counter()
        self.global_steps += 1
        self.micro_steps += self.gradient_accumulation_steps
        self.skipped_steps += int(out["skipped"])
        # a read of the card only where asked for: the timing breakdown,
        # a step record, or the report boundary's log line
        report = self.tput.will_report_next()
        sync = out["loss"] if (self.config.wall_clock_breakdown or want
                               or report) else None
        step_dt = self.tput.stop(sync_obj=sync, report_speed=True)
        host = self._host_ledger(t_entry, t_dispatched) if want else None
        self._emit_step(out, wall_time_s=step_dt, log_step=report, host=host)
        self._last_call_end_t = time.perf_counter()
        self._last_loss = out["loss"]
        if self._ft_active or self.preemption_guard is not None:
            self._after_step(out)
        if self.config.memory_breakdown and report:
            from ..utils.memory import see_memory_usage

            see_memory_usage(f"step {self.global_steps}")
        return out

    def _host_ledger(self, t_entry: float, t_dispatched: float) -> dict:
        return {"host_ms": (t_dispatched - t_entry) * 1e3,
                "data_wait_ms": self._consume_data_wait_ms(),
                "dispatch_gap_ms": ((t_entry - self._last_call_end_t) * 1e3
                                    if self._last_call_end_t is not None
                                    else None)}

    # ------------------------------------------------------------------
    # k steps without a host read between them (JAX train_steps)
    def train_steps_eligible(self) -> Tuple[bool, Optional[str]]:
        """Whether :meth:`train_steps` may run k steps back to back, with
        the reason when it may not: anything that does host work between
        optimizer steps forces the per-step path. (Pipelining, JAX's
        other reason, is not ported.)"""
        if self._offloaded:
            return False, "zero-offload swaps state around every step"
        if self._step_hooks:
            return False, "per-step hooks registered"
        if self.preemption_guard is not None:
            return False, "preemption-latch polling needs per-step boundaries"
        if self._divergence is not None:
            return False, ("host-side divergence guard fetches the loss "
                           "each step")
        return True, None

    def train_steps(self, batches: Union[int, Sequence[Any]]
                    ) -> Dict[str, Any]:
        """k optimizer steps with no host read between them, bitwise k
        :meth:`train_batch` calls (each step is the same code). ``batches``
        is k global batches, or an int k to pull them from the bound
        loader (cycling epochs like ``RepeatingLoader``; its position
        advances by k). Returns the last step's metrics plus ``losses``
        and ``grad_norms`` ([k] tensors on the device). An ineligible
        engine (:meth:`train_steps_eligible`) runs k ``train_batch``
        calls, the reason logged once."""
        if isinstance(batches, int):
            k, batches = int(batches), None
        else:
            batches = list(batches)
            k = len(batches)
        if k <= 0:
            raise ValueError("train_steps: no batches")
        eligible, reason = self.train_steps_eligible()
        if not eligible or k == 1:
            if not eligible and reason not in self._steps_fallback_logged:
                self._steps_fallback_logged.add(reason)
                log_dist(f"train_steps: the multi-step path is ineligible "
                         f"({reason}); running {k} per-step train_batch "
                         f"calls")
            # one batch pulled a step: the reasons are exactly the ones
            # that checkpoint or roll back between steps, where the
            # loader's position must be what was consumed
            steps = []
            for i in range(k):
                if batches is not None:
                    b = batches[i]
                else:
                    pulled = self._pull_batches(1)
                    if not pulled:
                        break
                    b = pulled[0]
                steps.append(self.train_batch(b))
            if not steps:
                raise ValueError("train_steps: no batches")
            return self._steps_out(steps)
        if batches is None:
            batches = self._pull_batches(k)
            k = len(batches)
            if k == 0:
                raise ValueError("train_steps: no batches")
            if k == 1:
                return self._steps_out([self.train_batch(batches[0])])
        t_entry = time.perf_counter()
        self._join_warmup()
        batches = [self._to_device(b) for b in batches]
        self._note_batch_shape(batches[0])
        want = self.telemetry.wants_step_records
        prev_steps = self.global_steps
        gas = self.gradient_accumulation_steps
        self.tput.start()
        steps = []
        with self._counted() as counter:
            for b in batches:
                steps.append(self._step(b))
                self.global_steps += 1
                self.micro_steps += gas
        self._note_flops(counter, k)
        t_dispatched = time.perf_counter()
        out = self._steps_out(steps)
        sync = out["loss"] if (self.config.wall_clock_breakdown
                               or want) else None
        block_dt = self.tput.stop(sync_obj=sync, report_speed=False)
        # stop() booked one step of batch_size; this block ran k
        self.tput.step_count = self.global_steps
        self.tput.total_samples += self.train_batch_size * (k - 1)
        self.skipped_steps += sum(int(m["skipped"]) for m in steps)
        host = self._host_ledger(t_entry, t_dispatched) if want else None
        self._emit_step(out, wall_time_s=block_dt, log_step=False, host=host,
                        n_steps=k)
        self._last_call_end_t = time.perf_counter()
        self._last_loss = out["loss"]
        # the auto-save: a block can cross or land on a save boundary
        # (preemption and divergence guards never reach here)
        iv = self.config.checkpoint.save_interval
        if (self._ckpt_save_dir and iv > 0
                and self.global_steps // iv != prev_steps // iv):
            self.save_checkpoint(self._ckpt_save_dir)
        return out

    @staticmethod
    def _steps_out(steps: List[Dict[str, Any]]) -> Dict[str, Any]:
        out = dict(steps[-1])
        out["losses"] = torch.stack([m["loss"] for m in steps])
        out["grad_norms"] = torch.stack([m["grad_norm"] for m in steps])
        return out

    def _pull_batches(self, k: int) -> List[Any]:
        """k batches from the bound loader through one iterator kept
        across calls, starting a new epoch like ``RepeatingLoader`` where
        one ends."""
        src = self._dataloader
        if src is None:
            raise ValueError(
                "train_steps(k) needs a bound dataloader (bind_dataloader) "
                "or a sequence of batches")
        if self._loader_iter is None or self._loader_iter_src is not src:
            self._loader_iter = iter(src)
            self._loader_iter_src = src
        out: List[Any] = []
        restarts = 0
        while len(out) < k:
            try:
                out.append(next(self._loader_iter))
                restarts = 0
            except StopIteration:
                if restarts:            # an empty loader
                    break
                restarts += 1
                if hasattr(src, "set_epoch"):
                    src.set_epoch(getattr(src, "epoch", 0) + 1)
                self._loader_iter = iter(src)
        return out

    def _consume_data_wait_ms(self) -> Optional[float]:
        """The bound loader's data-wait time since the last record."""
        dl = self._dataloader
        cur = getattr(dl, "data_wait_s", None) if dl is not None else None
        if cur is None:
            return None
        d = float(cur) - self._data_wait_prev_s
        self._data_wait_prev_s = float(cur)
        return d * 1e3 if d >= 0 else None

    # ------------------------------------------------------------------
    # warmup: what can be made ready before the first step
    def _step_libraries(self) -> List[str]:
        """The kernel libraries the step launches on this engine's
        device: the flash kernels when a tower of the model attends with
        them, the quantize kernels under qwZ / qgZ, the fused collectives
        on the staged ZeRO-3 schedule's fused backend."""
        if self.device.type != "cuda":
            return []
        m = self.model
        configs = [getattr(m, "config", None)] + [
            getattr(v, "config", None) for v in vars(m).values()] \
            if m is not None else []
        libs = []
        if any(getattr(c, "use_flash", False) for c in configs):
            libs.append("flash_attention")
        if self._qgz or self._qwz:
            libs.append("quant")
        if self._route == "staged" and self._comm_backend.name == "pallas":
            libs.append("fused_collectives")
        return libs

    def warmup(self, batch: Any) -> bool:
        """Make ready what the first step would build: every kernel
        library the step will launch is built (``nvcc``, once per
        checkout) and loaded, and the batch's description is read (the
        tokens a step for the step records). ``batch`` is a batch or its
        description (:meth:`DataLoader.batch_struct`: leaves with
        ``shape`` and ``dtype``); nothing of the engine's state is
        touched. Returns False, with a warning, on any failure: the step
        then builds what it launches at its first call, and launches the
        same kernels."""
        try:
            leaves = list(batch.values())
            rows = {int(x.shape[0]) for x in leaves}
            if rows != {self.train_batch_size}:
                raise ValueError(f"the batch has {sorted(rows)} rows; "
                                 f"train_batch_size is "
                                 f"{self.train_batch_size}")
            self._note_batch_shape(batch)
            from ..ops import op_builder

            for lib in self._step_libraries():
                op_builder.load(lib)
            self.warmed_up = True
        except Exception as e:  # noqa: BLE001 - warmup never fails the engine
            logger.warning(f"warmup failed (the first step builds what it "
                           f"launches): {e}")
            self.warmed_up = False
        return self.warmed_up

    def warmup_async(self, batch: Any) -> threading.Thread:
        """:meth:`warmup` on a thread (``nvcc`` runs outside the
        interpreter), beside the caller's own start-up work; the first
        ``train_batch``, ``train_steps``, ``backward`` or
        ``register_param_transform`` joins it."""
        t = threading.Thread(target=self.warmup, args=(batch,),
                             name="dst-warmup", daemon=True)
        self._warmup_thread = t
        t.start()
        return t

    def _join_warmup(self) -> None:
        if self._warmup_thread is not None:
            self._warmup_thread.join()
            self._warmup_thread = None

    # ------------------------------------------------------------------
    # the compat micro-step path (the reference's forward/backward/step)
    def forward(self, batch: Mapping[str, Any]) -> torch.Tensor:
        """The loss of a micro-batch with no gradient (an evaluation, as
        the JAX engine's: :meth:`backward` computes its own forward)."""
        loss = self.eval_batch(batch)
        self._last_loss = loss
        return loss

    def backward(self, batch: Mapping[str, Any]) -> torch.Tensor:
        """Accumulate one micro-batch's gradients (``train_batch_size /
        gas`` rows, the same global micro-batch on every rank) with the
        code :meth:`train_batch` runs a micro-batch with; returns its
        loss, the whole micro-batch's (over data ranks the shares are
        summed for it, in another order than the step's sum)."""
        self._join_warmup()
        gas = self.gradient_accumulation_steps
        batch = self._to_device(batch, self.train_batch_size // gas)
        self._note_batch_shape(batch, scale=gas)
        want = self.telemetry.wants_step_records
        if want:
            self.timers("compat/backward").start()
        self._params_to_device()
        self._acc, loss = self._accumulate(self._acc, batch, self._scale())
        if self.topo.data_parallel_size > 1 and not self._data_local:
            loss = comm.group_sum(loss, self.topo.group("data"), "data")
        if want:
            self.timers("compat/backward").stop(sync_obj=loss)
        self.micro_steps += 1
        self._last_loss = loss
        return loss

    def is_gradient_accumulation_boundary(self) -> bool:
        return (self.micro_steps + 1) % self.gradient_accumulation_steps == 0

    def step(self) -> None:
        """Apply the update at a gradient-accumulation boundary with the
        code :meth:`train_batch` steps with; off the boundary it does
        nothing. The step-boundary duties follow: the step record, the
        guards and the auto-save."""
        if self.micro_steps % self.gradient_accumulation_steps != 0:
            return
        if self._acc is None:
            logger.warning("step() called with no accumulated gradients")
            return
        want = self.telemetry.wants_step_records
        if want:
            self.timers("compat/optimizer").start()
        self._params_to_device()
        out = self._apply(self._acc, self._scale())
        self._params_to_offload()
        self._acc = None
        if want:
            self.timers("compat/optimizer").stop(sync_obj=out["grad_norm"])
        self.global_steps += 1
        # global_steps moved without the throughput timer: keep the two
        # aligned so a later train_batch reports on steps_per_print
        self.tput.step_count = self.global_steps
        self.skipped_steps += int(out["skipped"])
        phase_times = wall = None
        if want:
            # forward() is an evaluation, outside the step's phases
            phase_times = {}
            for phase in ("backward", "optimizer"):
                t = self.timers.timers.get(f"compat/{phase}")
                if t is not None and t.count:
                    phase_times[phase] = t.elapsed_total
                    t.reset()
            wall = sum(phase_times.values()) or None
        metrics = dict(out, loss=self._last_loss)
        self._emit_step(metrics, wall_time_s=wall, phase_times=phase_times)
        if self._ft_active or self.preemption_guard is not None:
            self._after_step(metrics)

    # ------------------------------------------------------------------
    # step telemetry (JAX _emit_step / _build_step_stats)
    def _emit_step(self, metrics: Dict[str, Any],
                   wall_time_s: Optional[float] = None,
                   log_step: Optional[bool] = None,
                   phase_times: Optional[Dict[str, float]] = None,
                   host: Optional[Dict[str, Optional[float]]] = None,
                   n_steps: int = 1) -> None:
        """The log line at the report boundary, and one StepStats record
        through the telemetry pipeline when a sink wants it."""
        if log_step is None:
            log_step = self.global_steps % max(
                self.config.steps_per_print, 1) == 0
        if log_step:
            log_dist(
                f"step={self.global_steps} loss={float(metrics['loss']):.4f}"
                f" lr={self.get_lr():.3e} "
                f"grad_norm={float(metrics['grad_norm']):.3f}"
                + (f" loss_scale={float(metrics['loss_scale']):.0f}"
                   if self.config.fp16.enabled else ""))
        if not self.telemetry.wants_step_records:
            return
        self.telemetry.record_step(self._build_step_stats(
            metrics, wall_time_s, phase_times, host=host, n_steps=n_steps))

    def _build_step_stats(self, metrics: Dict[str, Any],
                          wall_time_s: Optional[float],
                          phase_times: Optional[Dict[str, float]] = None,
                          host: Optional[Dict[str, Optional[float]]] = None,
                          n_steps: int = 1):
        from ..telemetry import StepStats
        from ..telemetry.tracing import get_tracer

        dt = float(wall_time_s) if wall_time_s else 0.0
        tokens = self._count_batch_tokens() * n_steps
        comm_delta, comm_s = self._comm_step_delta()
        if self.telemetry.enabled:
            from ..utils.memory import device_memory_stats, host_rss_gb

            memory = device_memory_stats(self.device)
            rss = host_rss_gb()
            if rss is not None:
                memory["host_rss_gb"] = rss
        else:       # a monitor alone: the report boundary's sample
            memory = dict(self.tput.last_memory)
        mfu = 0.0
        peak = self._get_peak_flops()
        if dt > 0 and self._step_flops and peak:
            mfu = self._step_flops * n_steps / dt / peak
        host = host or {}
        trace_id = span_id = None
        tracer = get_tracer()
        if tracer.enabled:
            from ..resilience.clock import get_clock

            t_end = get_clock().time()
            sp = tracer.span_complete(
                "train/step", t_end - dt, t_end, track="train",
                step=self.global_steps, n_steps=n_steps)
            trace_id, span_id = sp.trace_id, sp.span_id
        quant_err = None
        if metrics.get("quant_rel_err") is not None:
            quant_err = float(metrics["quant_rel_err"])
            from ..telemetry.registry import get_registry

            get_registry().histogram("comm/quant_rel_err").observe(quant_err)

        def num(key):
            v = metrics.get(key)
            return float(v) if v is not None else None

        return StepStats(
            step=self.global_steps, n_steps=n_steps, wall_time_s=dt,
            tokens_per_s=tokens / dt if dt > 0 else 0.0,
            samples_per_s=(self.train_batch_size * n_steps / dt
                           if dt > 0 else 0.0),
            host_ms=host.get("host_ms"),
            data_wait_ms=host.get("data_wait_ms"),
            dispatch_gap_ms=host.get("dispatch_gap_ms"),
            mfu=mfu, loss=num("loss"), grad_norm=num("grad_norm"),
            loss_scale=(num("loss_scale") if self.config.fp16.enabled
                        else None),
            lr=self.get_lr(),
            skipped=(bool(metrics["skipped"])
                     if metrics.get("skipped") is not None else None),
            forward_s=(phase_times or {}).get("forward"),
            backward_s=(phase_times or {}).get("backward"),
            optimizer_s=(phase_times or {}).get("optimizer"),
            comm_s=comm_s, comm=comm_delta, quant_rel_err=quant_err,
            memory=memory, trace_id=trace_id, span_id=span_id)

    def _count_batch_tokens(self) -> int:
        """Tokens a step: a sequence batch's ``input_ids`` elements, else
        its samples."""
        return (self._tokens_per_batch if self._tokens_per_batch is not None
                else self.config.train_batch_size)

    def _note_batch_shape(self, batch: Any, scale: int = 1) -> None:
        """Latch the tokens a step from the first batch seen (``scale``
        lifts a compat micro-batch to the step)."""
        if self._tokens_per_batch is not None:
            return
        if isinstance(batch, Mapping) and "input_ids" in batch:
            self._tokens_per_batch = int(
                math.prod(batch["input_ids"].shape)) * scale
        else:
            self._tokens_per_batch = self.config.train_batch_size

    def _comm_step_delta(self):
        """The comms ledger's totals since the last record, by op (the
        port's collectives book themselves: no booking is implied).
        The ledger carries no durations: each entry's ``time_s`` is 0 and
        ``comm_s`` None."""
        totals = comm.get_comms_logger().snapshot_totals()
        delta: Dict[str, Dict[str, float]] = {}
        for op, cur in totals.items():
            prev = self._comm_totals_prev.get(op, {})
            d = {k: cur[k] - prev.get(k, 0.0) for k in cur}
            if any(d.values()):
                delta[op] = {**d, "time_s": 0.0}
        self._comm_totals_prev = totals
        return delta, None

    def _get_peak_flops(self) -> float:
        if self._peak_flops is None:
            from ..profiling.flops_profiler import _peak_flops_per_device

            self._peak_flops = (_peak_flops_per_device(self.compute_dtype,
                                                       self.device)
                                if self.device.type == "cuda" else 0.0)
        return self._peak_flops

    def register_param_transform(self, fn: Optional[Callable[[Params],
                                                             Params]]
                                 ) -> None:
        """Install (or, with None, remove) a transform of the compute copy
        applied at the cast boundary, inside autograd: the gradients reach
        the masters through it (compression's QAT and pruning masks). A
        pending warmup is joined first. At ZeRO stage 3 over data ranks
        (the facade's gathered leaves) it raises: that comes with a later
        slice."""
        self._join_warmup()
        if fn is not None and self._route != "whole":
            raise NotImplementedError(
                "a params transform at ZeRO stage 3 over data ranks comes "
                "with a later slice of deepspeed_tpu_torch (ROADMAP.md, "
                "Queue A item 12)")
        self._param_transform = fn

    def _global_norm(self, grads: Params) -> torch.Tensor:
        """sqrt of the sum of squares of every gradient element. Whole
        gradients (one device, stages 0-1) are summed here; a tree with
        shards (stages 2-3) by an all_reduce of the ranks' squared sums,
        a leaf kept whole on every rank counted on rank 0 only; under
        ``model`` > 1 the model group's sum of the cut leaves' squares
        plus the replicated leaves' once (:func:`sharded_global_norm`)."""
        if self.tp_sharded:
            return sharded_global_norm(
                [g for n, g in grads.items() if n in self.tp_sharded],
                [g for n, g in grads.items() if n not in self.tp_sharded],
                self.topo.group("model"))
        whole = [tuple(g.shape) == self.full_shapes[n]
                 for n, g in grads.items()]
        if self.topo.data_parallel_size == 1 or all(whole):
            return global_norm(grads.values()).to(self.device)
        first = self.topo.rank("data") == 0
        parts = [g.float().square().sum()
                 for g, w in zip(grads.values(), whole) if first or not w]
        sq = torch.stack(parts).sum() if parts else torch.zeros(
            (), device=self.device)
        return ccomm.psum(sq, "data").sqrt()

    @torch.no_grad()
    def _update(self, grads: Params, scale: float):
        """Unscale (fp16), check finiteness (fp16, every rank's), global
        norm, clip by ``min(1, clip / (gnorm + 1e-6))``, optimizer step in
        place on this rank's slices (:meth:`_state_layout`) — kept out on
        overflow — the updated slices of the leaves kept whole gathered
        back (:meth:`_gather_masters`), and the loss scaler's step.
        ``grads`` is emptied. Returns (gnorm, skipped). Under the
        divergence guard's ``nan_action="skip"`` a full-precision step
        takes the same finiteness check and keeps a non-finite update
        out (JAX's ``nan_skip``; here it reads one flag back)."""
        cfg = self.config
        fp16 = cfg.fp16.enabled
        finite = True
        if fp16:
            for g in grads.values():
                g.div_(scale)
        if fp16 or self._nan_skip:
            finite = bool(ls.grads_finite(grads.values()))
            if comm.get_world_size() > 1:
                finite = ls.finite_everywhere(finite, self.device)
        gnorm = self._global_norm(grads)
        if cfg.gradient_clipping > 0:
            factor = torch.clamp(cfg.gradient_clipping / (gnorm + 1e-6),
                                 max=1.0)
            for g in grads.values():
                g.mul_(factor)
        if finite:
            kw = {"leaf_sq_sums": self._leaf_sq_sums} \
                if getattr(self.optimizer, "leaf_norms", False) else {}
            if self._offloaded:
                self._offload_update(grads, kw)
            else:
                self.opt_state = self.optimizer.update(
                    self._state_layout(grads), self.opt_state,
                    self._state_layout(self.params), **kw)
                grads.clear()
                self._gather_masters(self.params)
        self.scaler_state = ls.update(
            self.scaler_state, finite,
            dynamic=fp16 and cfg.fp16.dynamic_loss_scale,
            scale_window=cfg.fp16.loss_scale_window,
            min_scale=cfg.fp16.min_loss_scale,
            consecutive_hysteresis=cfg.fp16.consecutive_hysteresis,
            init_hysteresis=cfg.fp16.hysteresis)
        return gnorm, not finite

    def _leaf_sq_sums(self, local: Params) -> Params:
        """Each leaf's sums (LAMB's ``[sum(w^2), sum(u^2)]``) over the
        group that holds the leaf: the data group's for a slice the
        optimizer sees under ZeRO, the model group's for a leaf cut over
        the model axis; one all-reduce a group, in name order on every
        rank."""
        out = dict(local)
        for names, axis in ((self._sliced, "data"),
                            (self.tp_sharded, "model")):
            names = sorted(set(names) & set(local))
            if not names:
                continue
            flat = comm.group_sum(torch.stack([local[n] for n in names]),
                                  self.topo.group(axis), axis)
            out.update(zip(names, flat.unbind(0)))
        return out

    def _gather_masters(self, params: Params) -> None:
        """Every rank's updated slice of each master of ``params`` kept
        whole but updated as a slice (stages 1-2, and a stage-3 leaf kept
        whole below the persistence threshold) all-gathered into the whole
        masters (``zero_master_all_gather``): what XLA emits for JAX's
        replicated ``param_shardings`` after the sharded update. Each
        element has one writer, so every rank's masters are bitwise
        equal."""
        names = [n for n in self._regather if n in params]
        if not names:
            return
        gather_slices([params[n] for n in names],
                      [self.state_specs[n] for n in names],
                      self.topo.group("data"), self.topo.rank("data"),
                      self.topo.data_parallel_size, "zero_master_all_gather")

    @torch.no_grad()
    def eval_batch(self, batch: Mapping[str, Any]) -> torch.Tensor:
        """The loss of ``batch`` on the compute copy, with no gradient,
        over the whole batch as JAX's ``eval_batch`` takes it on every
        route (qgZ's and the staged schedule's training losses are each
        rank's own, meaned): each rank's rows, their loss shares (a loss
        that is no share divided by the data ranks) summed over the data
        ranks; at stage 3 the model reads the masters gathered unquantized
        (the staged schedule's model every leaf at once, another model a
        layer's leaves at a time)."""
        batch = {k: torch.as_tensor(v).to(self.device)
                 for k, v in batch.items()}
        rows = self._my_rows(batch)
        if self._route == "staged":
            pc = {k: v.to(self.compute_dtype)
                  for k, v in self.full_params().items()}
        elif self._route == "gather":
            pc = zero3_params({n: p.to(self.device) for n, p in
                               self._materialized_params().items()},
                              self.param_specs, self.topo, self.compute_dtype)
        else:
            pc = self._transformed(self._compute_copy(data_local=False))
        out = self.loss_fn(pc, rows)
        loss = (out[0] if isinstance(out, tuple) else out).float()
        dp = self.topo.data_parallel_size
        if dp == 1:
            return loss
        if not self._shares:
            loss = loss / dp
        return comm.group_sum(loss, self.topo.group("data"), "data")

    # ------------------------------------------------------------------
    # fault tolerance (JAX TrainEngine's, step-boundary guards)
    @property
    def should_stop(self) -> bool:
        """True once a preemption was handled (emergency checkpoint saved)
        or a guard halted the run: the training loop's drain signal."""
        return self._stop_reason is not None

    @property
    def stop_reason(self) -> Optional[str]:
        return self._stop_reason

    def register_step_hook(self, fn: Callable[["TrainEngine", int], None]
                           ) -> None:
        """``fn(engine, global_steps)`` at the start of every step."""
        self._step_hooks.append(fn)

    def attach_preemption_guard(self, guard: Optional[Any] = None):
        """Wire a PreemptionGuard into the step path: when its signal
        latches, the NEXT step boundary saves an emergency checkpoint
        (into ``checkpoint.save_dir``) and sets :attr:`should_stop`. Pass
        an entered guard, or None to construct one (the caller still
        manages its context)."""
        if guard is None:
            from ..resilience.preemption import PreemptionGuard

            guard = PreemptionGuard()
        self.preemption_guard = guard
        return guard

    def _after_step(self, metrics: Dict[str, Any]) -> None:
        """Step-boundary checks; never called when every knob is off."""
        step = self.global_steps
        if step > self._ft_high_step:
            # progress past the previous high-water step: an earlier
            # divergence was transient, the rollback did its job
            self._ft_high_step = step
            self._rollback_streak = 0
        if self._divergence is not None:
            # the one host read the divergence guard costs
            verdict = self._divergence.observe(step, float(metrics["loss"]))
            if verdict is not None:
                kind, action = verdict
                from ..resilience.divergence import DivergenceError
                from ..telemetry.registry import get_registry

                get_registry().counter(f"resilience/divergence/{kind}").inc()
                if action == "halt":
                    self._stop_reason = f"divergence:{kind}"
                    raise DivergenceError(
                        f"{kind} divergence at step {step} (action=halt)")
                if action == "rollback":
                    self._rollback_streak += 1
                    limit = self.config.resilience.divergence.max_rollbacks
                    if self._rollback_streak > limit:
                        # a bit-exact resume replays a deterministic fault
                        # identically: rolling back again would loop
                        self._stop_reason = f"divergence:{kind}:rollback-loop"
                        raise DivergenceError(
                            f"{kind} divergence at step {step} persisted "
                            f"through {limit} rollbacks (deterministic "
                            f"fault?) — halting")
                    self._rollback(kind)
                    return  # don't checkpoint the rolled-back state twice
        if (self.preemption_guard is not None
                and self._stop_reason is None and self._preempted()):
            self._emergency_checkpoint()
            self._stop_reason = "preempted"
            return
        if (self._ckpt_save_dir and self.config.checkpoint.save_interval > 0
                and step % self.config.checkpoint.save_interval == 0):
            self.save_checkpoint(self._ckpt_save_dir)

    def _preempted(self) -> bool:
        """The attached guard's latch, agreed over every rank (max): a
        signal that reaches one rank before this boundary and another
        after it must not send the first into the save's collectives
        while the second starts the next step's."""
        stop = bool(self.preemption_guard.should_stop)
        if comm.get_world_size() > 1:
            flag = torch.tensor([int(stop)], dtype=torch.int32,
                                device=self.device)
            stop = bool(comm.all_reduce(
                flag, op=torch.distributed.ReduceOp.MAX).item())
        return stop

    def _rollback(self, kind: str) -> None:
        from ..resilience.counters import record_rollback
        from ..resilience.divergence import DivergenceError

        if not self._ckpt_save_dir:
            raise DivergenceError(
                f"{kind} divergence: rollback requested but "
                f"checkpoint.save_dir is not configured")
        bad_step = self.global_steps
        if self.load_checkpoint(self._ckpt_save_dir, auto=True) is None:
            raise DivergenceError(
                f"{kind} divergence at step {bad_step}: no valid "
                f"checkpoint to roll back to")
        self._divergence.reset()
        record_rollback()
        logger.warning(f"divergence ({kind}) at step {bad_step}: rolled "
                       f"back to step {self.global_steps}")

    def _emergency_checkpoint(self) -> None:
        """Preemption drain: checkpoint into ``checkpoint.save_dir``."""
        from ..resilience.counters import record_emergency_save

        if self._ckpt_save_dir:
            self.save_checkpoint(self._ckpt_save_dir)
            self.ckpt_engine.wait()
            record_emergency_save()
            log_dist(f"emergency checkpoint at step {self.global_steps} "
                     f"(preemption drain)")
        else:
            logger.warning("preempted with no checkpoint.save_dir — "
                           "draining without an emergency checkpoint")

    def close(self) -> None:
        """Engine shutdown: join a pending warmup, flush and close every
        telemetry sink (the monitors' too), release the process-wide
        telemetry if it is this engine's, and wait for an async
        checkpoint's writer (raising its failure). Idempotent."""
        if not self._closed:
            self._closed = True
            self._join_warmup()
            self.telemetry.close()
            from ..telemetry import get_telemetry, set_telemetry

            if get_telemetry() is self.telemetry:
                set_telemetry(None)
        self.ckpt_engine.wait()

    # ------------------------------------------------------------------
    # checkpoints: every leaf as its full logical array
    def _logical_shape(self, name: str) -> Tuple[int, ...]:
        """The full shape of a master leaf (joined over the model axis)."""
        shape = list(self.full_shapes[name])
        if name in self.tp_sharded:
            dim = list(self.model.leaf_spec(name)).index("model")
            shape[dim] *= self.topo.model_parallel_size
        return tuple(shape)

    def _full_leaf(self, name: str, t: torch.Tensor, spec) -> torch.Tensor:
        """``t`` (this rank's piece of leaf ``name``: a data shard by
        ``spec`` or whole, a model-axis shard or whole) gathered to its
        full logical array. Every rank of the groups must call it."""
        if tuple(t.shape) != self.full_shapes[name]:
            t = ccomm.gather_param_leaf(t.to(self.device), spec)
        if name in self.tp_sharded:
            dim = list(self.model.leaf_spec(name)).index("model")
            t = torch.cat(comm.all_gather(t.contiguous(),
                                          self.topo.group("model")), dim=dim)
        return t

    def _local_piece(self, name: str, full: torch.Tensor, spec,
                     target: torch.Tensor) -> torch.Tensor:
        """This rank's piece of the full array ``full`` of leaf ``name``,
        laid out as ``target`` (the inverse of :meth:`_full_leaf`)."""
        if tuple(full.shape) != self._logical_shape(name):
            raise ValueError(f"checkpoint leaf {name} has shape "
                             f"{tuple(full.shape)}; the model's is "
                             f"{self._logical_shape(name)}")
        if name in self.tp_sharded:
            full = self.model.local_shard(name, full)
        if tuple(target.shape) != tuple(full.shape):
            full = shard_of(full, spec, self.topo.rank("data"),
                            self.topo.data_parallel_size)
        return full

    def _opt_fields(self) -> Dict[str, Any]:
        """The optimizer state's fields (a NamedTuple's; a client
        optimizer's state of another kind is not checkpointed). Under
        ``"nvme"`` offload its trees are templates."""
        as_dict = getattr(self._opt_view(), "_asdict", None)
        return as_dict() if as_dict is not None else {}

    def _opt_trees(self) -> Dict[str, Params]:
        """The optimizer state's per-leaf trees (AdamW's ``mu``, ``nu``;
        SGD's ``momentum``, Adagrad's ``accum``, ...)."""
        return {k: v for k, v in self._opt_fields().items()
                if isinstance(v, dict)}

    @staticmethod
    def _leaf_reader(store: Optional[OffloadStore], field: str,
                     tree: Optional[Params]) -> Callable[[str], torch.Tensor]:
        """One leaf of a tree for reading: of ``tree`` (resident, or
        parked in host memory), else read from its file a leaf at a time
        (``"nvme"``), never unparked."""
        if tree is not None:
            return tree.__getitem__
        return lambda n: store.read_leaf(field, n)

    def _state_dict(self) -> Dict[str, Any]:
        """The checkpoint engine's files: ``params`` (the masters) and
        ``opt_state.<tree>`` (each of the optimizer's trees: AdamW's
        ``mu``, ``nu``) as :class:`Leaves` gathered leaf by leaf, one file
        each so a load checks them in parallel; the scaler, step, the
        optimizer's scalars and the random stream in ``engine``. Parked
        state is read where it lies (a file a leaf at a time)."""
        self._fence()
        nvme = self._offload_device == "nvme"
        fp32 = torch.float32
        specs = [(n, fp32, self._logical_shape(n)) for n in self.full_shapes]

        def leaves(read, spec_of):
            return Leaves(specs, lambda n: self._full_leaf(n, read(n),
                                                           spec_of[n]))

        state: Dict[str, Any] = {
            "params": leaves(self._leaf_reader(self._param_store, "",
                                               self.params),
                             self.param_specs),
            **{f"opt_state.{k}": leaves(self._leaf_reader(
                self._opt_store, k, None if nvme else tree),
                self.state_specs) for k, tree in self._opt_trees().items()}}
        state["engine"] = {
            "rng": self.rng.get_state(), "step": int(self.global_steps),
            **{f"opt/{k}": v for k, v in self._opt_fields().items()
               if v is not None and not isinstance(v, dict)},
            **{f"scaler/{k}": v
               for k, v in self.scaler_state._asdict().items()}}
        return state

    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[Dict[str, Any]] = None,
                        model_version: Optional[int] = None) -> str:
        """Save a committed checkpoint tag (default ``global_step<N>``) of
        the whole training state; every rank calls it. Returns the tag's
        path."""
        tag = tag if tag is not None else f"global_step{self.global_steps}"
        validate_tag_consistency(str(tag),
                                 self.config.checkpoint.tag_validation)
        client = {**(client_state or {}),
                  "global_steps": self.global_steps,
                  "micro_steps": self.micro_steps,
                  "skipped_steps": self.skipped_steps}
        if self._dataloader is not None and hasattr(self._dataloader,
                                                    "state_dict"):
            client["dataloader"] = self._dataloader.state_dict()
        return self.ckpt_engine.save(
            save_dir, str(tag), self._state_dict(), client_state=client,
            config_snapshot=self.config.raw, model_version=model_version)

    @torch.no_grad()
    def _load_params(self, tree: Mapping[str, torch.Tensor]) -> None:
        """The masters from full arrays; parked ones are parked again
        (under ``"nvme"`` their files rewritten)."""
        missing = set(self.full_shapes) - set(tree)
        if missing:
            raise ValueError(f"checkpoint has no leaves {sorted(missing)}")
        self._fence()
        if self.params is None:         # "nvme", between steps
            tmpl = self._param_store.template("")
            self._param_store.park("", {
                n: self._local_piece(n, tree[n], self.param_specs[n], t)
                for n, t in tmpl.items()})
            return
        for n, p in self.params.items():
            p.copy_(self._local_piece(n, tree[n], self.param_specs[n], p))

    @torch.no_grad()
    def _load_opt(self, state: Mapping[str, Any]) -> None:
        """The optimizer state from full arrays, parked again where
        offload parks it."""
        if not self._opt_fields():
            return
        self._fence()
        nvme = self._offload_device == "nvme"
        fields = {}
        for k, v in self._opt_fields().items():
            if v is None:
                fields[k] = None
            elif isinstance(v, dict):
                tree = state[f"opt_state.{k}"]
                pieces = {n: self._local_piece(n, tree[n],
                                               self.state_specs[n], t)
                          for n, t in v.items()}
                if nvme:
                    self._opt_store.park(k, pieces)
                else:
                    for n, t in v.items():
                        t.copy_(pieces[n])
                fields[k] = v
            else:
                fields[k] = type(v)(state["engine"][f"opt/{k}"])
        if nvme:
            self._opt_skeleton = self._opt_skeleton._replace(**fields)
        else:
            self.opt_state = type(self.opt_state)(**fields)

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None,
                        load_optimizer_states: bool = True,
                        auto: bool = False) -> Optional[Dict[str, Any]]:
        """Restore the engine's state from the newest VALID tag (torn,
        uncommitted or corrupt tags are skipped), or from ``tag``; returns
        the client state, or None when there is nothing to load. Each
        rank cuts its own slices from the full arrays (any stage, rank
        count or TP degree saved the tag). ``auto=True`` is the
        resume-after-restart entry point: a missing directory is a quiet
        no-op."""
        t0 = time.perf_counter()
        groups = ["params", "engine"] + (
            [f"opt_state.{k}" for k in self._opt_trees()]
            if load_optimizer_states else [])
        result = self.ckpt_engine.load(load_dir, tag, groups=groups,
                                       quiet=auto)
        if result is None:
            return None
        #: the last load's tag, its seconds (manifest check included, the
        #: copies onto the device finished) and its manifest check's
        self.last_load = {"tag": result["tag"],
                          "verify_s": self.ckpt_engine.last_verify_s}
        state = result["state"]
        self._load_params(state["params"])
        eng = state["engine"]
        if load_optimizer_states:
            self._load_opt(state)
            self.scaler_state = type(self.scaler_state)(
                **{k: type(v)(eng[f"scaler/{k}"])
                   for k, v in self.scaler_state._asdict().items()})
        self.global_steps = int(eng["step"])
        self.tput.step_count = self.global_steps
        self.rng.set_state(eng["rng"].clone())
        client = result["meta"].get("client_state", {})
        self.micro_steps = int(client.get(
            "micro_steps",
            self.global_steps * self.gradient_accumulation_steps))
        self.skipped_steps = int(client.get("skipped_steps", 0))
        if (self._dataloader is not None and "dataloader" in client
                and hasattr(self._dataloader, "load_state_dict")):
            self._dataloader.load_state_dict(client["dataloader"])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_load["s"] = time.perf_counter() - t0
        return client

    def hot_swap_checkpoint(self, load_dir: str,
                            tag: Optional[str] = None) -> Optional[int]:
        """Weight-only swap (zero-downtime rollout): ONLY the master
        weights are loaded — the optimizer state, scaler, step counters,
        random stream and loader position stay. The tag is verified as
        :meth:`load_checkpoint` verifies it; a torn or corrupt tag raises
        instead of half-swapping. Returns the tag's ``model_version``
        (None when it has none)."""
        result = self.ckpt_engine.load(load_dir, tag, groups=["params"])
        if result is None:
            raise ValueError(
                f"hot_swap_checkpoint: no valid checkpoint under "
                f"{load_dir!r} (tag={tag!r}) — refusing to swap")
        self._load_params(result["state"]["params"])
        version = result["meta"].get("model_version")
        return int(version) if version is not None else None

    def _consolidated(self, dtype) -> Dict[str, torch.Tensor]:
        """The masters gathered whole, as host copies in ``dtype`` (one
        gathered leaf on the device at a time)."""
        self._fence()
        read = self._leaf_reader(self._param_store, "", self.params)
        return consolidate_full_state(
            ((n, self._full_leaf(n, read(n), self.param_specs[n]))
             for n in self.full_shapes), dtype)

    def save_16bit_model(self, save_dir: str,
                         filename: str = "model_16bit.safetensors") -> str:
        """Consolidated 16-bit export (the reference's
        ``save_16bit_model``): the masters gathered whole (never the
        model's own buffers, which ZeRO-3 replaced by shards) and cast to
        bf16, keyed as the JAX package's ``save_16bit_model`` keys its
        tree (``['layers']['wq']``, layer leaves stacked ``[n_layers,
        ...]``), in a safetensors file. Every rank calls it; rank 0
        writes. Returns the file's path."""
        full = self._consolidated(torch.bfloat16)
        path = os.path.join(save_dir, filename)
        if comm.get_rank() == 0:
            os.makedirs(save_dir, exist_ok=True)
            sio.save_file(jax_tree_keys(full), path, fsync=True)
        return path

    def get_fp32_state_dict(self) -> Dict[str, torch.Tensor]:
        """The fp32 masters gathered whole, ``{name: CPU tensor}`` (the
        reference's ``zero_to_fp32`` read-out). Every rank calls it."""
        return self._consolidated(torch.float32)


_LAYER = re.compile(r"(^|\.)layers\.(\d+)\.")


def jax_tree_keys(params: Mapping[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """A ``{name: tensor}`` tree of the port keyed as the JAX package's
    ``jax.tree_util.keystr`` keys the same leaves: names nest on their
    dots (``text.final_norm_w`` -> ``['text']['final_norm_w']``) and the
    per-layer leaves ``layers.<i>.<leaf>`` are stacked ``[n_layers, ...]``
    under ``['layers']['<leaf>']``."""
    stacks: Dict[str, Dict[int, torch.Tensor]] = {}
    out: Dict[str, torch.Tensor] = {}
    for name, t in params.items():
        key, layer = jax_leaf_key(name)
        if layer is None:
            out[key] = t
        else:
            stacks.setdefault(key, {})[layer] = t
    for key, layers in stacks.items():
        out[key] = torch.stack([layers[i] for i in range(len(layers))])
    return out


def jax_leaf_key(name: str) -> Tuple[str, Optional[int]]:
    """(``jax.tree_util.keystr`` of the JAX leaf that holds ``name``, the
    layer index within it): ``layers.<i>.<leaf>`` is layer ``i`` of
    ``['layers']['<leaf>']``, another name its own leaf (layer None)."""
    m = _LAYER.search(name)
    if m is None:
        return _keystr(name), None
    key = name[:m.start()] + m.group(1) + "layers." + name[m.end():]
    return _keystr(key), int(m.group(2))


def _keystr(name: str) -> str:
    """``jax.tree_util.keystr`` of a dotted path (list indices bare)."""
    return "".join(f"[{p}]" if p.isdigit() else f"['{p}']"
                   for p in name.split("."))


def _epilogue_vjp(epilogue, y, rest, h_in, g_out):
    """((grad of y, grads of rest), grad of h_in) of ``epilogue(y, rest,
    h_in)`` against ``g_out``; unused inputs get zeros (``jax.vjp``)."""
    leaves = {"y": y, **{f"rest.{k}": v for k, v in rest.items()}}
    grads, g_h = block_vjp(
        lambda p, h: epilogue(p["y"], {k: p[f"rest.{k}"] for k in rest}, h),
        leaves, h_in, g_out)
    return (grads["y"], {k: grads[f"rest.{k}"] for k in rest}), g_h
