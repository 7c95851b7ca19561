"""The training engine on one device.

Ports the single-device path of ``deepspeed_tpu/runtime/engine.py``'s
``TrainEngine``: fp32 master weights, a compute-dtype copy for the forward
and backward passes (bf16/fp16 mixed precision), gradient accumulation over
``gradient_accumulation_steps`` micro-batches, global-norm clipping, fp16
dynamic loss scaling with skipped steps, and the optimizer step.

The JAX package jits the whole step (``_build_train_step``) and returns new
arrays; here the step runs eagerly and updates the master weights and the
optimizer moments IN PLACE (a second copy of 1.1e9 fp32 weights and two
moments would not fit beside the first on one card). When the model's own
parameters are fp32 on the engine's device they ARE the master weights, so
the model trains in place.

Loss protocol: ``loss_fn(params, batch) -> loss | (loss, aux)``, where
``params`` is the ``{name: tensor}`` compute copy (the names of the model's
``named_parameters()``) and ``batch`` a dict of tensors on the engine's
device. ``initialize(model=...)`` uses ``model.loss(batch, params=...)``.

Later slices (ROADMAP.md, Queue A): ``train_steps``, AOT warmup, offload,
ZeRO, telemetry, fault tolerance, checkpoints and the compat
``forward``/``backward``/``step``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import torch

from ..config import Config
from ..utils.device import resolve_device
from ..utils.logging import logger
from . import loss_scaler as ls
from .lr_schedules import Schedule, build_schedule, constant_lr
from .optimizers import Transform, build_optimizer, global_norm

Params = Dict[str, torch.Tensor]
LossFn = Callable[[Params, Dict[str, torch.Tensor]], Any]


class TrainEngine:
    """Single-device trainer. ``device`` defaults to ``"cuda"`` and raises
    without a CUDA device unless ``device="cpu"`` is asked for."""

    def __init__(self, *, loss_fn: LossFn, params: Mapping[str, torch.Tensor],
                 config: Config, model: Optional[Any] = None,
                 optimizer: Optional[Transform] = None,
                 lr_scheduler: Optional[Schedule] = None, device=None):
        self.config = config
        self.model = model
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        config.resolve_batch_config()
        logger.info(f"batch config: train_batch={config.train_batch_size} "
                    f"micro_batch={config.train_micro_batch_size_per_gpu} "
                    f"gas={config.gradient_accumulation_steps}")

        # master params: fp32 on the device (no copy when already so)
        self.params: Params = {
            n: p.detach().to(device=self.device, dtype=torch.float32)
            for n, p in params.items()}

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

    def _loss(self, params: Params, batch) -> torch.Tensor:
        out = self.loss_fn(params, batch)
        return out[0] if isinstance(out, tuple) else out

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

    def _to_device(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        out = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
        rows = {v.shape[0] for v in out.values()}
        if rows != {self.train_batch_size}:
            raise ValueError(f"batch leaves have {sorted(rows)} rows; "
                             f"train_batch_size is {self.train_batch_size}")
        return out

    def train_batch(self, batch: Mapping[str, Any]) -> Dict[str, Any]:
        """One optimizer step over a global batch of ``train_batch_size``
        rows: GAS micro-batches are ``x.reshape(gas, B / gas, ...)[i]``;
        their fp32 gradients are summed and scaled by ``1 / gas``, and so
        are their losses. Returns ``{"loss", "grad_norm"}`` (0-dim fp32
        tensors on the device), ``"loss_scale"`` and ``"skipped"``."""
        batch = self._to_device(batch)
        gas = self.gradient_accumulation_steps
        fp16 = self.config.fp16.enabled
        scale = self.scaler_state.scale if fp16 else 1.0
        if gas > 1:
            grads, loss = None, None
            for i in range(gas):
                mb = {k: v.reshape((gas, v.shape[0] // gas) + v.shape[1:])[i]
                      for k, v in batch.items()}
                g, l = self._loss_and_grads(mb, scale)
                if grads is None:
                    grads, loss = g, l
                else:
                    for n in grads:
                        grads[n].add_(g[n])
                    loss = loss + l
                del g
            inv = 1.0 / gas
            for g in grads.values():
                g.mul_(inv)
            loss = loss * inv
        else:
            grads, loss = self._loss_and_grads(batch, scale)
        gnorm, skipped = self._update(grads, scale)
        self.global_steps += 1
        self.micro_steps += gas
        self.skipped_steps += int(skipped)
        if self.global_steps % max(self.config.steps_per_print, 1) == 0:
            logger.info(f"step {self.global_steps}: loss {loss.item():.6f} "
                        f"grad_norm {gnorm.item():.6f} lr {self.get_lr():.3e}")
        return {"loss": loss, "grad_norm": gnorm,
                "loss_scale": self.get_loss_scale(), "skipped": skipped}

    @torch.no_grad()
    def _update(self, grads: Params, scale: float):
        """Unscale (fp16), check finiteness (fp16), global norm, clip by
        ``min(1, clip / (gnorm + 1e-6))``, optimizer step in place — kept
        out on overflow — and the loss scaler's step. Returns (gnorm,
        skipped)."""
        cfg = self.config
        fp16 = cfg.fp16.enabled
        finite = True
        if fp16:
            for g in grads.values():
                g.div_(scale)
            finite = bool(ls.grads_finite(grads.values()))
        gnorm = global_norm(grads.values()).to(self.device)
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
        """The loss of ``batch`` on the compute copy, with no gradient."""
        return self._loss(self._compute_copy(),
                          {k: torch.as_tensor(v).to(self.device)
                           for k, v in batch.items()})
