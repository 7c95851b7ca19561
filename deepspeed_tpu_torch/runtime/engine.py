"""The training engine: one device, a ``data`` x ``model`` mesh at ZeRO
stage 0, or ZeRO-3 over the ``data`` ranks.

Ports three paths of ``deepspeed_tpu/runtime/engine.py``'s ``TrainEngine``:

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
* ZeRO stage 3 with the staged block schedule (``_loss_and_grads_staged``):
  every rank of the ``data`` group keeps the fp32 master shards and AdamW
  moment shards of ``ZeroShardingRules.param_spec``, takes its rows of the
  global batch, and runs the model's ``zero3_blocks`` program through
  ``Zero3BlockSchedule`` with the compressed-collective facade: per block a
  (quantized, qwZ) weight all-gather and a (quantized, qgZ) gradient mean,
  or, on the fused backend for blocks whose weight is sharded on its
  output dim, the gather inside the matmul kernel and the quantization in
  the weight-gradient kernel's epilogue (``_fused_block_ops``). The reduced
  gradients are sliced to the rank's shard; the global norm is the square
  root of an all_reduce of the shards' squared sums; clipping and AdamW
  run on the shard.

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

Stage 3 needs a model with ``zero3_blocks`` trained on its own loss; the
JAX package's other ZeRO paths (stages 1-2, ZeRO over a ``model`` axis,
the GSPMD and qgZ facade paths for models without ``zero3_blocks``, hpZ,
MiCS, offload) come with later slices and raise. So do ``train_steps``,
AOT warmup, telemetry, fault tolerance, checkpoints (which would carry a
bound loader's position) and the compat ``forward``/``backward``/``step``
(ROADMAP.md, Queue A).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import torch

from ..comm import comm
from ..comm import compressed as ccomm
from ..comm.backends import dot_fp32, resolve_backend
from ..config import Config
from ..parallel.mesh import PartitionSpec, Topology, set_topology
from ..parallel.zero import (FusedBlockOps, ZeroShardingRules,
                             Zero3BlockSchedule, block_vjp, shard_of,
                             sharded_dim)
from ..utils.device import resolve_device
from ..utils.logging import logger
from . import loss_scaler as ls
from .lr_schedules import Schedule, build_schedule, constant_lr
from .optimizers import (Transform, build_optimizer, global_norm,
                         sharded_global_norm)

Params = Dict[str, torch.Tensor]
LossFn = Callable[[Params, Dict[str, torch.Tensor]], Any]


class TrainEngine:
    """Trainer on one device, over a ``data`` x ``model`` mesh at stage 0,
    or ZeRO-3 over the ``data`` ranks (see the module docstring).
    ``device`` defaults to ``"cuda"`` and raises without a CUDA device
    unless ``device="cpu"`` is asked for. ``loss_fn`` None means the
    model's own ``loss``. ``topology`` (default: built from the config's
    ``mesh``) is the mesh; under ``model`` > 1 the model and ``params``
    must be this rank's shards (``initialize`` cuts them)."""

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
        self._zero3 = config.zero.stage == 3
        if self._zero3:
            self._check_staged(model, custom_loss)
        # the model's loss is its share of the global batch's when the
        # model reads the topology; another loss is a mean over the rank's
        # rows, divided by the data ranks here
        shares = not custom_loss and hasattr(model, "bind_topology")
        if shares and tp == 1 and getattr(model, "_topo", None) is None:
            model.bind_topology(self.topo)
        self._loss_div = dp if dp > 1 and not self._zero3 and not shares \
            else 1
        if tp > 1:
            self._check_tensor_parallel(model, custom_loss)
        config.resolve_batch_config(dp)
        logger.info(f"batch config: train_batch={config.train_batch_size} "
                    f"micro_batch={config.train_micro_batch_size_per_gpu} "
                    f"gas={config.gradient_accumulation_steps} dp={dp}")

        # master params: fp32 on the device (no copy when already so); under
        # ZeRO-3 each rank owns a copy of its shard of every leaf
        self.zero_rules = ZeroShardingRules(self.topo, config.zero)
        self.param_specs: Dict[str, PartitionSpec] = {
            n: self.zero_rules.param_spec(tuple(p.shape))
            for n, p in params.items()}
        rank = self.topo.rank("data")
        self.params: Params = {
            n: shard_of(p.detach(), self.param_specs[n], rank, dp).to(
                device=self.device, dtype=torch.float32,
                copy=self._zero3 and dp > 1)
            for n, p in params.items()}
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
        elif isinstance(optimizer, Transform):
            self.optimizer = optimizer
        else:
            raise NotImplementedError(
                f"a client optimizer ({type(optimizer)}) comes with a later "
                f"slice of deepspeed_tpu_torch (ROADMAP.md, Queue A)")
        self.opt_state = self.optimizer.init(self.params)

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

    def _check_staged(self, model, custom_loss: bool) -> None:
        """Stage 3 runs the staged block schedule: the facade's qwZ/qgZ legs
        and the kernel backend (JAX ``TrainEngine.__init__``)."""
        cfg = self.config
        later = ("comes with a later slice of deepspeed_tpu_torch "
                 "(ROADMAP.md, Queue A item 12)")
        if model is None or not hasattr(model, "zero3_blocks"):
            raise NotImplementedError(
                f"ZeRO stage 3 for a model without zero3_blocks (the GSPMD "
                f"and qgZ facade paths, e.g. Llama) {later}")
        if custom_loss:
            raise NotImplementedError(
                f"ZeRO stage 3 with a custom loss_fn: the staged schedule "
                f"trains the model's own loss (zero3_blocks' loss_tail); "
                f"the unstaged facade path {later}")
        cc = cfg.comm_compression
        if cc.overlap == "off":
            raise NotImplementedError(
                f"comm_compression.overlap='off' (the unstaged facade path) "
                f"{later}")
        cc_on = cc.resolve_enabled(self.topo.data_parallel_size)
        self._qwz = bool(cfg.zero.zero_quantized_weights) or cc_on
        self._qgz = bool(cfg.zero.zero_quantized_gradients) or cc_on
        self._overlapped = cc.overlap == "staged"
        self._comm_backend = resolve_backend(cc.kernel_backend, self.device)
        self._wants_quant_err = bool(cc.error_stats)

    def _check_tensor_parallel(self, model, custom_loss: bool) -> None:
        """``model`` > 1 trains a model of the port cut over the model
        axis, on its own loss."""
        tp = self.topo.model_parallel_size
        if custom_loss or not hasattr(model, "leaf_spec"):
            raise ValueError(
                f"mesh.model = {tp} trains a model of deepspeed_tpu_torch "
                f"(one with partition_specs) on its own loss; a custom "
                f"loss_fn over sharded leaves is not supported")
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
    def _compute_copy(self) -> Params:
        """Every floating master leaf cast to the compute dtype, as a leaf
        that records its gradient (for fp32 compute, a view of the master;
        nothing writes it before the gradient is taken)."""
        return {n: p.to(self.compute_dtype).detach().requires_grad_(True)
                if p.is_floating_point() else p
                for n, p in self.params.items()}

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
        one it builds from ``training_data``); a checkpoint would carry
        its position (checkpoints come with ROADMAP.md Queue A item
        10)."""
        self._dataloader = loader

    def _loss_and_grads(self, batch, scale: float):
        """One micro-batch: (fp32 gradients of ``scale * loss`` with respect
        to the masters, unscaled loss). The gradient with respect to an
        fp32 master is its compute copy's gradient upcast to fp32 — what
        ``jax.grad`` through the cast gives."""
        pc = self._compute_copy()
        names = [n for n, p in pc.items() if p.requires_grad]
        with torch.enable_grad():
            loss = self._loss(pc, batch)
            grads = torch.autograd.grad(loss.float() * scale,
                                        [pc[n] for n in names],
                                        allow_unused=True)
        out = {n: (torch.zeros_like(self.params[n]) if g is None
                   else g.float())
               for n, g in zip(names, grads)}
        return out, loss.detach().float()

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
        pc = {n: p.to(self.compute_dtype) for n, p in self.params.items()}
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
        the shards under ZeRO-3; under ``model`` > 1 each cut leaf's
        shards joined over the model group along its ``model`` dimension
        in rank order (``checkpoint.jax_params.gather_params``' layout);
        else the masters themselves."""
        if self.tp_sharded:
            return self.full_width(self.params)
        return {n: ccomm.gather_param_leaf(p, self.param_specs[n])
                for n, p in self.params.items()}

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
    def _to_device(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        out = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
        rows = {v.shape[0] for v in out.values()}
        if rows != {self.train_batch_size}:
            raise ValueError(f"batch leaves have {sorted(rows)} rows; "
                             f"train_batch_size is {self.train_batch_size}")
        return out

    def train_batch(self, batch: Mapping[str, Any]) -> Dict[str, Any]:
        """One optimizer step over a global batch of ``train_batch_size``
        rows (every rank passes the same global batch): GAS micro-batches
        are ``x.reshape(gas, B / gas, ...)[i]``, and under ZeRO-3 each rank
        takes its rows of each; their fp32 gradients are summed and scaled
        by ``1 / gas``, and so are their losses. Returns ``{"loss",
        "grad_norm"}`` (0-dim fp32 tensors on the device), ``"loss_scale"``
        and ``"skipped"``, and ``"quant_rel_err"`` under
        ``comm_compression.error_stats``."""
        batch = self._to_device(batch)
        gas = self.gradient_accumulation_steps
        fp16 = self.config.fp16.enabled
        scale = self.scaler_state.scale if fp16 else 1.0
        grads, loss, errs = None, None, []
        for i in range(gas):
            mb = batch if gas == 1 else {
                k: v.reshape((gas, v.shape[0] // gas) + v.shape[1:])[i]
                for k, v in batch.items()}
            if self._zero3:
                g, l, aux = self._loss_and_grads_zero3(mb, scale)
                if "quant_rel_err" in aux:
                    errs.append(aux["quant_rel_err"])
            else:
                g, l = self._loss_and_grads(self._my_rows(mb), scale)
            if grads is None:
                grads, loss = g, l
            else:
                for n in grads:
                    grads[n].add_(g[n])
                loss = loss + l
            del g
        if not self._zero3 and self.topo.data_parallel_size > 1:
            grads, loss = self._data_sum(grads, loss)
        if gas > 1:
            inv = 1.0 / gas
            for g in grads.values():
                g.mul_(inv)
            loss = loss * inv
        gnorm, skipped = self._update(grads, scale)
        self.global_steps += 1
        self.micro_steps += gas
        self.skipped_steps += int(skipped)
        if self.global_steps % max(self.config.steps_per_print, 1) == 0:
            logger.info(f"step {self.global_steps}: loss {loss.item():.6f} "
                        f"grad_norm {gnorm.item():.6f} lr {self.get_lr():.3e}")
        out = {"loss": loss, "grad_norm": gnorm,
               "loss_scale": self.get_loss_scale(), "skipped": skipped}
        if errs:
            out["quant_rel_err"] = torch.stack(errs).max()
        return out

    def _global_norm(self, grads: Params) -> torch.Tensor:
        """sqrt of the sum of squares of every gradient element: under
        ZeRO-3 an all_reduce of the shards' squared sums (a leaf kept whole
        on every rank is counted on rank 0 only); under ``model`` > 1 the
        model group's sum of the cut leaves' squares plus the replicated
        leaves' once (:func:`sharded_global_norm`)."""
        if self.tp_sharded:
            return sharded_global_norm(
                [g for n, g in grads.items() if n in self.tp_sharded],
                [g for n, g in grads.items() if n not in self.tp_sharded],
                self.topo.group("model"))
        if not self._zero3 or self.topo.data_parallel_size == 1:
            return global_norm(grads.values()).to(self.device)
        first = self.topo.rank("data") == 0
        parts = [g.float().square().sum() for n, g in grads.items()
                 if first or sharded_dim(self.param_specs[n]) is not None]
        sq = torch.stack(parts).sum() if parts else torch.zeros(
            (), device=self.device)
        return ccomm.psum(sq, "data").sqrt()

    @torch.no_grad()
    def _update(self, grads: Params, scale: float):
        """Unscale (fp16), check finiteness (fp16, on every rank's shards),
        global norm, clip by ``min(1, clip / (gnorm + 1e-6))``, optimizer
        step in place — kept out on overflow — and the loss scaler's step.
        Returns (gnorm, skipped)."""
        cfg = self.config
        fp16 = cfg.fp16.enabled
        finite = True
        if fp16:
            for g in grads.values():
                g.div_(scale)
            finite = bool(ls.grads_finite(grads.values()))
            if self._zero3:
                flag = torch.tensor(float(finite), device=self.device)
                finite = bool(ccomm.pmin(flag, "data") > 0)
            elif comm.get_world_size() > 1:
                finite = ls.finite_everywhere(finite, self.device)
        gnorm = self._global_norm(grads)
        if cfg.gradient_clipping > 0:
            factor = torch.clamp(cfg.gradient_clipping / (gnorm + 1e-6),
                                 max=1.0)
            for g in grads.values():
                g.mul_(factor)
        if finite:
            self.opt_state = self.optimizer.update(grads, self.opt_state,
                                                   self.params)
        self.scaler_state = ls.update(
            self.scaler_state, finite,
            dynamic=fp16 and cfg.fp16.dynamic_loss_scale,
            scale_window=cfg.fp16.loss_scale_window,
            min_scale=cfg.fp16.min_loss_scale,
            consecutive_hysteresis=cfg.fp16.consecutive_hysteresis,
            init_hysteresis=cfg.fp16.hysteresis)
        return gnorm, not finite

    @torch.no_grad()
    def eval_batch(self, batch: Mapping[str, Any]) -> torch.Tensor:
        """The loss of ``batch`` on the compute copy, with no gradient
        (under ZeRO-3: the full weights, each rank's rows, meaned; at
        stage 0 over ``data`` ranks: each rank's share, summed)."""
        batch = {k: torch.as_tensor(v).to(self.device)
                 for k, v in batch.items()}
        if not self._zero3:
            loss = self._loss(self._compute_copy(), self._my_rows(batch))
            if self.topo.data_parallel_size > 1:
                loss = comm.group_sum(loss.float(), self.topo.group("data"),
                                      "data")
            return loss
        dp = self.topo.data_parallel_size
        rank = self.topo.rank("data")
        n = next(iter(batch.values())).shape[0] // dp
        mine = {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}
        pc = {k: v.to(self.compute_dtype)
              for k, v in self.full_params().items()}
        return ccomm.pmean(self._loss(pc, mine).float(), "data")


def _epilogue_vjp(epilogue, y, rest, h_in, g_out):
    """((grad of y, grads of rest), grad of h_in) of ``epilogue(y, rest,
    h_in)`` against ``g_out``; unused inputs get zeros (``jax.vjp``)."""
    leaves = {"y": y, **{f"rest.{k}": v for k, v in rest.items()}}
    grads, g_h = block_vjp(
        lambda p, h: epilogue(p["y"], {k: p[f"rest.{k}"] for k in rest}, h),
        leaves, h_in, g_out)
    return (grads["y"], {k: grads[f"rest.{k}"] for k in rest}), g_h
