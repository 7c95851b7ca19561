"""Diffusers checkpoint names: UNet2DConditionModel / AutoencoderKL.

The port's own copy of ``deepspeed_tpu/checkpoint/diffusers.py``'s map
(pure numpy). A diffusers state dict (``diffusion_pytorch_model.*``, as
numpy arrays) becomes the JAX package's NHWC parameter tree of
``UNet2DCondition`` / ``AutoencoderKL``, which
:func:`~deepspeed_tpu_torch.checkpoint.jax_params.load_jax_params` then
carries into the port's modules (transposing each conv kernel once more,
to the port's OIHW).

Layout rules (torch -> the JAX tree):
  Conv2d   OIHW  -> HWIO   (transpose 2,3,1,0)
  Linear   [o,i] -> [i,o]  (transpose)
  Norm     weight -> scale
plus naming reconciliation: ``transformer_blocks``->``blocks``,
``to_out.0``->``to_out``, GEGLU ``ff.net.0.proj``/``ff.net.2``->
``ff.proj``/``ff.out``, and the pre-0.13 VAE attention names
(``query/key/value/proj_attn``)->(``to_q/to_k/to_v/to_out``). Linear
proj_in/proj_out (SD2 ``use_linear_projection``) are reshaped to 1x1
convs so one forward serves both variants.

Reading the files (``read_diffusers_state``, ``load_unet``, ``load_vae``)
goes through the safetensors / ``.bin`` readers of ``checkpoint/hf.py``
(torch tensors in the file's dtype); ``load_unet`` / ``load_vae`` take
each tensor to float32 numpy for the map above and carry the tree into
the port's module with ``load_jax_params``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

__all__ = ["map_diffusers_unet", "map_diffusers_vae", "unet_config",
           "vae_config", "read_diffusers_state", "load_unet", "load_vae"]


def read_diffusers_state(model_dir: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a diffusers component directory
    (``diffusion_pytorch_model.safetensors`` / ``.bin``, or the HF
    names), as CPU tensors in the file's dtype."""
    from .hf import read_hf_state, read_one

    d = str(model_dir)
    for name in ("diffusion_pytorch_model.safetensors",
                 "diffusion_pytorch_model.bin"):
        path = os.path.join(d, name)
        if os.path.exists(path):
            return read_one(path)
    return read_hf_state(d)


def _numpy_state(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.float().numpy() for k, v in state.items()}


# -- name/layout normalization -----------------------------------------

_RENAME = {"transformer_blocks": "blocks", "query": "to_q", "key": "to_k",
           "value": "to_v", "proj_attn": "to_out"}


def _tokens(key: str):
    toks = key.split(".")
    out = []
    i = 0
    while i < len(toks):
        t = toks[i]
        if t == "to_out" and i + 1 < len(toks) and toks[i + 1] == "0":
            out.append("to_out")
            i += 2
            continue
        if t == "ff" and i + 2 < len(toks) and toks[i + 1] == "net":
            # ff.net.0.proj.* -> ff.proj.*   ff.net.2.* -> ff.out.*
            out.append("ff")
            if toks[i + 2] == "0":
                out.append("proj")
                i += 4
            else:
                out.append("out")
                i += 3
            continue
        out.append(_RENAME.get(t, t))
        i += 1
    return out


def _leaf(name: str, t: np.ndarray, conv_ctx: bool) -> Tuple[str, np.ndarray]:
    if name == "weight":
        if t.ndim == 4:                       # Conv2d OIHW -> HWIO
            return "kernel", np.transpose(t, (2, 3, 1, 0))
        if t.ndim == 2:
            if conv_ctx:                      # linear proj_in/out -> 1x1 conv
                return "kernel", np.transpose(t)[None, None, :, :]
            return "kernel", np.transpose(t)
        return "scale", t                     # norm weight
    return name, t


def _insert(tree: Dict[str, Any], toks, value):
    node = tree
    for i, t in enumerate(toks[:-1]):
        nxt_is_idx = toks[i + 1].isdigit() if i + 1 < len(toks) else False
        if t.isdigit():
            idx = int(t)
            while len(node) <= idx:
                node.append({})
            node = node[idx]
        else:
            if t not in node:
                node[t] = [] if nxt_is_idx else {}
            node = node[t]
    last = toks[-1]
    if last.isdigit():
        raise ValueError(f"unexpected trailing index in {toks}")
    node[last] = value


def _map_state(state: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, t in state.items():
        toks = _tokens(key)
        conv_ctx = any(x in ("proj_in", "proj_out") for x in toks)
        name, val = _leaf(toks[-1], np.asarray(t), conv_ctx)
        _insert(tree, toks[:-1] + [name], val)
    return tree


def _ensure_attn_lists(tree: Dict[str, Any]) -> None:
    """Blocks without attentions need the empty list the forward checks."""
    for blocks in ("down_blocks", "up_blocks"):
        for blk in tree.get(blocks, []):
            blk.setdefault("attentions", [])
            blk.setdefault("resnets", [])


def map_diffusers_unet(state: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree = _map_state(state)
    _ensure_attn_lists(tree)
    return tree


def map_diffusers_vae(state: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree = _map_state(state)
    for side in ("encoder", "decoder"):
        sub = tree.get(side, {})
        for blk in sub.get("down_blocks", []) + sub.get("up_blocks", []):
            blk.setdefault("resnets", [])
    return tree


# -- config --------------------------------------------------------------

def unet_config(model_dir: str):
    """The port's ``UNetConfig`` of a diffusers ``unet/config.json``."""
    from ..models.diffusion import UNetConfig

    with open(os.path.join(str(model_dir), "config.json")) as f:
        hc = json.load(f)
    ahd = hc.get("attention_head_dim", 8)
    return UNetConfig(
        sample_size=hc.get("sample_size", 64),
        in_channels=hc.get("in_channels", 4),
        out_channels=hc.get("out_channels", 4),
        block_out_channels=tuple(hc.get("block_out_channels", (320, 640, 1280, 1280))),
        layers_per_block=hc.get("layers_per_block", 2),
        cross_attention_dim=hc.get("cross_attention_dim", 768),
        attention_head_dim=tuple(ahd) if isinstance(ahd, list) else ahd,
        down_block_types=tuple(hc.get("down_block_types", ())) or
            ("CrossAttnDownBlock2D",) * 3 + ("DownBlock2D",),
        up_block_types=tuple(hc.get("up_block_types", ())) or
            ("UpBlock2D",) + ("CrossAttnUpBlock2D",) * 3,
        norm_num_groups=hc.get("norm_num_groups", 32),
    )


def vae_config(model_dir: str):
    """The port's ``VAEConfig`` of a diffusers ``vae/config.json``."""
    from ..models.diffusion import VAEConfig

    with open(os.path.join(str(model_dir), "config.json")) as f:
        hc = json.load(f)
    return VAEConfig(
        in_channels=hc.get("in_channels", 3),
        out_channels=hc.get("out_channels", 3),
        latent_channels=hc.get("latent_channels", 4),
        block_out_channels=tuple(hc.get("block_out_channels", (128, 256, 512, 512))),
        layers_per_block=hc.get("layers_per_block", 2),
        norm_num_groups=hc.get("norm_num_groups", 32),
        scaling_factor=hc.get("scaling_factor", 0.18215),
    )


def load_unet(model_dir: str, dtype: torch.dtype = torch.float32,
              device=None):
    """(UNet2DCondition, params) from a diffusers unet/ directory: the
    port's module on ``device`` (default ``"cuda"``) in ``dtype`` with the
    checkpoint's weights, and its ``{name: tensor}``."""
    from ..models.diffusion import UNet2DCondition
    from .jax_params import load_jax_params

    tree = map_diffusers_unet(_numpy_state(read_diffusers_state(model_dir)))
    model = UNet2DCondition(unet_config(model_dir), device=device,
                            dtype=dtype)
    load_jax_params(model, tree)
    return model, dict(model.named_parameters())


def load_vae(model_dir: str, dtype: torch.dtype = torch.float32,
             device=None):
    """(AutoencoderKL, params) from a diffusers vae/ directory, as
    :func:`load_unet`."""
    from ..models.diffusion import AutoencoderKL
    from .jax_params import load_jax_params

    tree = map_diffusers_vae(_numpy_state(read_diffusers_state(model_dir)))
    model = AutoencoderKL(vae_config(model_dir), device=device, dtype=dtype)
    load_jax_params(model, tree)
    return model, dict(model.named_parameters())
