"""Stable Diffusion sampling: the DDIM denoise loop over the port's UNet,
VAE and CLIP text tower.

Ports ``deepspeed_tpu/inference/diffusion.py``. The scheduler math is DDIM
(Song et al.) with the scaled-linear beta schedule Stable Diffusion trains
with, eta 0 (deterministic), as diffusers' ``DDIMScheduler(beta_schedule=
"scaled_linear")`` defaults have it. Classifier-free guidance is one
batched UNet call on ``cat([uncond, cond])`` a step, and the update runs in
fp32 tensors on the device.

The JAX package compiles the whole trajectory into one ``jax.jit``
(``lax.fori_loop``); the port's loop is eager Python over the steps
(:meth:`StableDiffusionPipeline.denoise`), so a step's UNet call is about a
thousand kernel launches. The initial draw comes from an explicit
``torch.Generator``; it differs from ``jax.random.normal``'s, so
:meth:`StableDiffusionPipeline.denoise` also starts from given latents.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..models.diffusion import Params


@dataclass
class DDIMSchedule:
    """Precomputed alphas for a truncated DDIM trajectory."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    num_inference_steps: int = 50
    # diffusers' SD defaults: timesteps start at 1, and the final step's
    # alpha_prev is alphas_cumprod[0] rather than 1.0 (set_alpha_to_one
    # is False in the SD scheduler config)
    steps_offset: int = 1
    set_alpha_to_one: bool = False

    def __post_init__(self):
        # scaled-linear: betas are squares of a linear sqrt-space ramp, in
        # fp64 on the host
        betas = np.linspace(self.beta_start ** 0.5, self.beta_end ** 0.5,
                            self.num_train_timesteps, dtype=np.float64) ** 2
        self.alphas_cumprod = np.cumprod(1.0 - betas)
        step = self.num_train_timesteps // self.num_inference_steps
        # diffusers "leading" spacing: t = i*step + offset, descending
        self.timesteps = np.clip(
            np.arange(0, self.num_inference_steps)[::-1] * step
            + self.steps_offset, 0, self.num_train_timesteps - 1)

    def arrays(self, device=None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(timesteps int32, alpha_t fp32, alpha_prev fp32), one entry a
        step, on ``device``: the fp64 table rounded to fp32 once, then
        indexed, as the JAX ``arrays()`` does."""
        ts = torch.as_tensor(self.timesteps, dtype=torch.int64)
        acp = torch.as_tensor(self.alphas_cumprod, dtype=torch.float32)
        step = self.num_train_timesteps // self.num_inference_steps
        prev = ts - step
        final_alpha = 1.0 if self.set_alpha_to_one else float(
            self.alphas_cumprod[0])
        alpha_t = acp[ts]
        alpha_prev = torch.where(prev >= 0, acp[prev.clamp(min=0)],
                                 torch.tensor(final_alpha,
                                              dtype=torch.float32))
        return (ts.to(device=device, dtype=torch.int32),
                alpha_t.to(device), alpha_prev.to(device))


class StableDiffusionPipeline:
    """Latent-space text-to-image sampling over the port's UNet and VAE.

    The conditioning is the CLIP text tower's final-LN hidden states
    (:meth:`~deepspeed_tpu_torch.models.clip.CLIP.text_states`) or any
    caller-supplied [b, seq, dim] embedding. ``unet`` is a
    :class:`~deepspeed_tpu_torch.models.diffusion.UNet2DCondition` (or
    anything with its ``apply`` and ``config.in_channels``), ``vae`` an
    :class:`~deepspeed_tpu_torch.models.diffusion.AutoencoderKL`."""

    def __init__(self, unet, vae=None, schedule: Optional[DDIMSchedule] = None,
                 guidance_scale: float = 7.5):
        self.unet = unet
        self.vae = vae
        self.schedule = schedule or DDIMSchedule()
        self.guidance_scale = guidance_scale

    def step(self, lat: torch.Tensor, t: torch.Tensor, at: torch.Tensor,
             ap: torch.Tensor, ctx: torch.Tensor,
             unet_params: Params = None) -> torch.Tensor:
        """One denoise step from fp32 latents ``lat`` at timestep ``t``
        (0-dim tensors ``t``, ``at`` = alpha_t, ``ap`` = alpha_prev), with
        ``ctx`` = ``cat([uncond, cond])``."""
        # classifier-free guidance: one batched UNet call
        lat2 = torch.cat([lat, lat], dim=0)
        eps = self.unet.apply(lat2, t.expand(lat2.shape[0]), ctx,
                              params=unet_params)
        eps_u, eps_c = eps.chunk(2, dim=0)
        # JAX's fp32 guidance scale promotes the difference to fp32
        eps = eps_u.float() + self.guidance_scale * (eps_c - eps_u).float()
        # DDIM (eta 0): x0-pred then the deterministic step
        x0 = (lat - torch.sqrt(1.0 - at) * eps) / torch.sqrt(at)
        return torch.sqrt(ap) * x0 + torch.sqrt(1.0 - ap) * eps

    @torch.no_grad()
    def denoise(self, latents: torch.Tensor, cond_ctx: torch.Tensor,
                uncond_ctx: torch.Tensor,
                unet_params: Params = None) -> torch.Tensor:
        """The whole trajectory from given fp32 latents [b, h, w, c] (what
        the JAX ``_sample_impl`` runs after its draw)."""
        ts, alpha_t, alpha_prev = self.schedule.arrays(latents.device)
        ctx = torch.cat([uncond_ctx, cond_ctx], dim=0)
        lat = latents
        for i in range(len(self.schedule.timesteps)):
            lat = self.step(lat, ts[i], alpha_t[i], alpha_prev[i], ctx,
                            unet_params)
        return lat

    def latent_shape(self, batch: int, height: int, width: int
                     ) -> Tuple[int, int, int, int]:
        lc = self.vae.config.latent_channels if self.vae is not None \
            else self.unet.config.in_channels
        return (batch, height, width, lc)

    @torch.no_grad()
    def sample_latents(self, cond_ctx: torch.Tensor, uncond_ctx: torch.Tensor,
                       generator: torch.Generator, height: int = 64,
                       width: int = 64,
                       unet_params: Params = None) -> torch.Tensor:
        """fp32 N(0, 1) latents drawn with ``generator`` (on the device of
        ``cond_ctx``), then :meth:`denoise`."""
        shape = self.latent_shape(cond_ctx.shape[0], height, width)
        latents = torch.randn(shape, generator=generator,
                              device=cond_ctx.device, dtype=torch.float32)
        return self.denoise(latents, cond_ctx, uncond_ctx, unet_params)

    @torch.no_grad()
    def __call__(self, cond_ctx: torch.Tensor, uncond_ctx: torch.Tensor,
                 generator: torch.Generator, height: int = 64,
                 width: int = 64, unet_params: Params = None,
                 vae_params: Params = None) -> torch.Tensor:
        """Images [b, 8h, 8w, 3] in about [-1, 1] through the VAE's decode
        (with a VAE), else the raw latents [b, h, w, c]."""
        lat = self.sample_latents(cond_ctx, uncond_ctx, generator, height,
                                  width, unet_params)
        if self.vae is None:
            return lat
        return self.vae.decode(lat, vae_params)
