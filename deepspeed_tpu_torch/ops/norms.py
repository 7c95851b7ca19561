"""Normalization ops.

Ports ``rms_norm``, ``layer_norm`` and ``group_norm`` from
``deepspeed_tpu/ops/norms.py``. The JAX package leaves them to XLA's
fusion (no Pallas kernel), and the port leaves them to PyTorch's eager
ops, with the JAX arithmetic step for step: fp32 statistics,
``reciprocal(sqrt(var + eps))``, weight (and bias) applied in fp32, then
the cast back to the input's dtype.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm (pre-norm Llama style). fp32 accumulation regardless of
    input dtype; the result has x's dtype."""
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.reciprocal(torch.sqrt(var + eps))
    return (y * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim (GPT-2 / OPT / GPT-Neo, Bloom's
    embedding norm): the fp32 mean, then the mean of squares of the
    centred values; the result has x's dtype."""
    x32 = x.float()
    mean = torch.mean(x32, dim=-1, keepdim=True)
    xc = x32 - mean
    var = torch.mean(torch.square(xc), dim=-1, keepdim=True)
    y = xc * torch.reciprocal(torch.sqrt(var + eps))
    return (y * weight.float() + bias.float()).to(x.dtype)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over NHWC feature maps (the diffusion UNet / VAE blocks):
    each channel group is normalized over (H, W, C / groups) with fp32
    statistics; the result has x's dtype. Not ``F.group_norm``, which
    wants NCHW-contiguous input (a copy of an NHWC map) and rounds
    otherwise."""
    assert x.dim() == 4, (
        f"group_norm expects NHWC rank-4 input, got shape {tuple(x.shape)} "
        "- a lower rank would silently mix statistics across the batch dim")
    b, h, w, c = x.shape
    assert c % groups == 0, (c, groups)
    x32 = x.float().reshape(b, h * w, groups, c // groups)
    # reduce over all spatial positions and the within-group channels
    mean = torch.mean(x32, dim=(1, 3), keepdim=True)
    xc = x32 - mean
    var = torch.mean(torch.square(xc), dim=(1, 3), keepdim=True)
    y = (xc * torch.reciprocal(torch.sqrt(var + eps))).reshape(x.shape)
    return (y * weight.float() + bias.float()).to(x.dtype)
