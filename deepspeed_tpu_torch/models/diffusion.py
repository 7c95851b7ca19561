"""Stable Diffusion's models: UNet2DCondition and AutoencoderKL.

Ports ``deepspeed_tpu/models/diffusion.py`` (diffusers' UNet2DConditionModel
and AutoencoderKL as Stable Diffusion 1.x / 2.x use them: ResnetBlock2D,
Transformer2DModel with self-attention, cross-attention and a GEGLU
feed-forward, the sinusoidal timestep embedding, stride-2 conv
downsampling and nearest-2x + conv upsampling). No Pallas kernel is
reached: the JAX convolutions are ``lax.conv_general_dilated`` and the
attention a plain einsum, so the port runs them as PyTorch ops
(``F.conv2d``, ``torch.matmul``), with the JAX arithmetic step for step.

Layout. Activations are NHWC at every function here, as in JAX (sample
``[b, h, w, c]``, images ``[b, H, W, 3]``). A contiguous NHWC tensor
permuted to ``(0, 3, 1, 2)`` is an NCHW tensor in ``channels_last``
memory, which cuDNN convolves without a copy; conv kernels are stored
OIHW in ``channels_last`` (the weight carry transposes JAX's HWIO once,
``checkpoint/jax_params.py``). Linear kernels keep JAX's ``[in, out]``.

Types. JAX's implicit promotion is written out: ``conv2d`` / ``linear``
cast the weight to the activation's dtype (fp32 latents run the UNet in
fp32 whatever its weights' dtype), ``temb`` is cast to the sample's
dtype, and the attention promotes q against a bf16 text encoder's k and
v to fp32, as ``jnp.einsum`` does.

Both models are ``nn.Module`` s that own their weights, made from ``seed``
on ``device`` (default ``"cuda"``). Their parameter names are the JAX
tree's paths (``down_blocks.0.resnets.1.conv1.kernel``), and every method
takes an optional ``params`` mapping of those names to tensors (default:
the model's own), as :class:`~deepspeed_tpu_torch.models.clip.CLIP` does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.norms import group_norm
from ..utils.device import resolve_device

Tree = Dict[str, Any]
Params = Optional[Mapping[str, torch.Tensor]]

# ----------------------------------------------------------------------
# primitives (NHWC activations, OIHW channels_last conv kernels)


def conv2d(x: torch.Tensor, p: Tree, stride: int = 1,
           padding: int = 1) -> torch.Tensor:
    """x [b, h, w, cin] -> [b, h', w', cout], the kernel and bias cast to
    x's dtype."""
    y = F.conv2d(x.contiguous().permute(0, 3, 1, 2), p["kernel"].to(x.dtype),
                 p["bias"].to(x.dtype), stride, padding)
    return y.permute(0, 2, 3, 1)


def linear(x: torch.Tensor, p: Tree) -> torch.Tensor:
    y = x @ p["kernel"].to(x.dtype)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """diffusers ``Timesteps`` with flip_sin_to_cos=True,
    downscale_freq_shift=0 (the SD configuration): [cos | sin] halves in
    fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


# ----------------------------------------------------------------------
# blocks


def resnet_block(x: torch.Tensor, temb: Optional[torch.Tensor], p: Tree,
                 groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """diffusers ResnetBlock2D: pre-GN+SiLU convs with the time embedding
    added between them; 1x1 shortcut when channels change."""
    h = _silu(group_norm(x, p["norm1"]["scale"], p["norm1"]["bias"],
                         groups=groups, eps=eps))
    h = conv2d(h, p["conv1"])
    if temb is not None and "time_emb_proj" in p:
        h = h + linear(_silu(temb), p["time_emb_proj"])[:, None, None, :] \
            .to(h.dtype)
    h = _silu(group_norm(h, p["norm2"]["scale"], p["norm2"]["bias"],
                         groups=groups, eps=eps))
    h = conv2d(h, p["conv2"])
    if "conv_shortcut" in p:
        x = conv2d(x, p["conv_shortcut"], padding=0)
    return x + h


def _attention(q_in: torch.Tensor, kv_in: torch.Tensor, p: Tree,
               heads: int) -> torch.Tensor:
    """diffusers Attention: to_q/k/v (no bias in SD's UNet), per-head
    softmax of fp32 logits, P cast to q's dtype, to_out with bias. Shapes
    [b, n, c] / [b, m, c_kv]. Mixed dtypes are promoted as ``jnp.einsum``
    promotes them; this is the plain softmax JAX computes, not SDPA."""
    b, n, _ = q_in.shape
    q = linear(q_in, p["to_q"])
    k = linear(kv_in, p["to_k"])
    v = linear(kv_in, p["to_v"])
    d = q.shape[-1] // heads
    q = q.reshape(b, n, heads, d).transpose(1, 2)
    k = k.reshape(b, -1, heads, d).transpose(1, 2)
    v = v.reshape(b, -1, heads, d).transpose(1, 2)
    qk = torch.promote_types(q.dtype, k.dtype)
    logits = (q.to(qk) @ k.to(qk).transpose(-1, -2)).float() / math.sqrt(d)
    attn = torch.softmax(logits, dim=-1).to(q.dtype)
    pv = torch.promote_types(attn.dtype, v.dtype)
    out = attn.to(pv) @ v.to(pv)
    out = out.transpose(1, 2).reshape(b, n, heads * d)
    return linear(out, p["to_out"])


def _geglu_ff(x: torch.Tensor, p: Tree) -> torch.Tensor:
    """diffusers FeedForward with GEGLU: the projection to twice the inner
    width, exact (erf) GELU of the fp32 gate half, the output linear."""
    h, gate = linear(x, p["proj"]).chunk(2, dim=-1)
    h = h * F.gelu(gate.float()).to(h.dtype)
    return linear(h, p["out"])


def _layer_norm(x: torch.Tensor, p: Tree, eps: float = 1e-5) -> torch.Tensor:
    """The transformer block's LayerNorm. It divides by ``sqrt(var +
    eps)``, as the JAX block does; ``ops.norms.layer_norm`` multiplies by
    the reciprocal."""
    x32 = x.float()
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mean), dim=-1, keepdim=True)
    y = (x32 - mean) / torch.sqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def transformer_2d(x: torch.Tensor, ctx: torch.Tensor, p: Tree, heads: int,
                   groups: int = 32) -> torch.Tensor:
    """diffusers Transformer2DModel (SD: one BasicTransformerBlock):
    GN -> 1x1 proj_in -> [self-attn, cross-attn, GEGLU ff with LN-pre
    residuals] -> 1x1 proj_out -> + residual."""
    b, h, w, c = x.shape
    residual = x
    y = group_norm(x, p["norm"]["scale"], p["norm"]["bias"], groups=groups,
                   eps=1e-6)
    y = conv2d(y, p["proj_in"], padding=0)
    y = y.reshape(b, h * w, c)
    for blk in p["blocks"]:
        n1 = _layer_norm(y, blk["norm1"])
        y = y + _attention(n1, n1, blk["attn1"], heads)
        y = y + _attention(_layer_norm(y, blk["norm2"]), ctx, blk["attn2"],
                           heads)
        y = y + _geglu_ff(_layer_norm(y, blk["norm3"]), blk["ff"])
    y = y.reshape(b, h, w, c)
    y = conv2d(y, p["proj_out"], padding=0)
    return y + residual


def downsample(x: torch.Tensor, p: Tree) -> torch.Tensor:
    """UNet Downsample2D: symmetric padding=1 stride-2 conv."""
    return conv2d(x, p["conv"], stride=2, padding=1)


def downsample_asym(x: torch.Tensor, p: Tree) -> torch.Tensor:
    """VAE-encoder Downsample2D: a right / bottom pad of one (diffusers'
    ``F.pad(x, (0, 1, 0, 1))``) before a padding=0 stride-2 conv, NOT the
    UNet's symmetric padding."""
    return conv2d(F.pad(x, (0, 0, 0, 1, 0, 1)), p["conv"], stride=2,
                  padding=0)


def upsample(x: torch.Tensor, p: Tree) -> torch.Tensor:
    """Nearest 2x (``jax.image.resize(..., "nearest")``: output pixel i
    reads input pixel i // 2) then a 3x3 conv."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c) \
        .reshape(b, 2 * h, 2 * w, c)
    return conv2d(x, p["conv"])


# ----------------------------------------------------------------------
# parameter trees


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _count(tree) -> int:
    return sum(int(np.prod(x.shape)) for x in _leaves(tree))


def nest_tree(flat: Mapping[str, Any]) -> Tree:
    """``{"a.0.b": t}`` -> ``{"a": [{"b": t}]}``: dotted names as the
    nested tree, a node whose keys are all indices as a list. The inverse
    of :func:`flat_tree`."""
    root: Tree = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = root
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t

    def lists(node):
        if not isinstance(node, dict):
            return node
        out = {k: lists(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out
    return lists(root)


def flat_tree(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """A nested tree of dicts and lists as ``{dotted path: leaf}``."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out: Dict[str, Any] = {}
    for k, v in items:
        name = f"{prefix}{k}"
        if isinstance(v, (dict, list)):
            out.update(flat_tree(v, name + "."))
        else:
            out[name] = v
    return out


class _Node(nn.Module):
    """A tree node as a module that also reads as the node's dict:
    ``p["conv"]``, ``"bias" in p``, ``p.get("attentions", [])``."""

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def get(self, key: str, default=None):
        return self[key] if key in self else default


def _module(tree) -> nn.Module:
    """A parameter tree as modules: lists as ``ModuleList``, dicts as
    modules that hold their tensors as (frozen) parameters."""
    if isinstance(tree, list):
        return nn.ModuleList([_module(t) for t in tree])
    node = _Node()
    for k, v in tree.items():
        if isinstance(v, torch.Tensor):
            node.register_parameter(k, nn.Parameter(v, requires_grad=False))
        else:
            node.add_module(k, _module(v))
    return node


def _drawer(device: torch.device, dtype: torch.dtype,
            seed: int) -> Callable[[str, Tuple[int, ...]], torch.Tensor]:
    """The leaf maker of a seeded init: conv kernels (OIHW, channels_last)
    and linear kernels ([in, out]) U(-1/sqrt(fan_in), 1/sqrt(fan_in)) as
    the JAX init draws them, biases and norm biases 0, norm scales 1."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def leaf(kind: str, shape: Tuple[int, ...]) -> torch.Tensor:
        if kind in ("zeros", "ones"):
            return (torch.zeros if kind == "zeros" else torch.ones)(
                shape, device=device, dtype=dtype)
        fan_in = int(np.prod(shape[1:])) if kind == "conv" else shape[0]
        u = torch.rand(shape, generator=gen, device=device,
                       dtype=torch.float32)
        w = ((2.0 * u - 1.0) / math.sqrt(fan_in)).to(dtype)
        return w.contiguous(memory_format=torch.channels_last) \
            if kind == "conv" else w
    return leaf


def _makers(leaf):
    def conv(cin, cout, k=3):
        return {"kernel": leaf("conv", (cout, cin, k, k)),
                "bias": leaf("zeros", (cout,))}

    def lin(cin, cout, bias=True):
        p = {"kernel": leaf("lin", (cin, cout))}
        if bias:
            p["bias"] = leaf("zeros", (cout,))
        return p

    def norm(ch):
        return {"scale": leaf("ones", (ch,)), "bias": leaf("zeros", (ch,))}
    return conv, lin, norm


class _TreeModel(_Node):
    """A model whose parameters are one tree (see :func:`_module`); the
    model itself is that tree's root node."""

    def __init__(self, tree: Tree):
        super().__init__()
        for k, v in tree.items():
            self.add_module(k, _module(v))

    def _tree(self, params: Params):
        """The tree the methods read: the model's own modules, or
        ``params`` (keyed by ``named_parameters()`` names) nested."""
        return self if params is None else nest_tree(params)


# ----------------------------------------------------------------------
# UNet2DCondition


@dataclass
class UNetConfig:
    """Subset of diffusers UNet2DConditionModel config that SD uses; the
    defaults are Stable Diffusion 1.x's UNet (859,520,964 parameters)."""

    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    # diffusers bug-compat: UNet2DConditionModel's attention_head_dim is
    # actually the NUMBER of heads (num_attention_heads defaults to it);
    # int or per-down-block tuple (SD2: (5, 10, 20, 20))
    attention_head_dim: Any = 8
    down_block_types: Tuple[str, ...] = ("CrossAttnDownBlock2D",) * 3 + ("DownBlock2D",)
    up_block_types: Tuple[str, ...] = ("UpBlock2D",) + ("CrossAttnUpBlock2D",) * 3
    norm_num_groups: int = 32

    def param_count(self, params=None) -> int:
        """The leaves' element count of ``params`` (a flat mapping or a
        nested tree of tensors or arrays), or of this config's tree."""
        if params is None:
            params = _unet_tree(self, lambda kind, shape: torch.empty(
                shape, device="meta"))
        return _count(params)


def _unet_tree(c: UNetConfig, leaf) -> Tree:
    """The UNet's parameter tree (the JAX ``UNet2DCondition.init``'s,
    with OIHW conv kernels), each leaf ``leaf(kind, shape)``."""
    conv, lin, norm = _makers(leaf)

    def resnet(cin, cout, temb):
        p = {"norm1": norm(cin), "conv1": conv(cin, cout),
             "time_emb_proj": lin(temb, cout),
             "norm2": norm(cout), "conv2": conv(cout, cout)}
        if cin != cout:
            p["conv_shortcut"] = conv(cin, cout, k=1)
        return p

    def attn(ch, kv_dim):
        return {"to_q": lin(ch, ch, bias=False),
                "to_k": lin(kv_dim, ch, bias=False),
                "to_v": lin(kv_dim, ch, bias=False),
                "to_out": lin(ch, ch)}

    def tblock(ch):
        inner = 4 * ch
        return {"norm1": norm(ch), "attn1": attn(ch, ch),
                "norm2": norm(ch), "attn2": attn(ch, c.cross_attention_dim),
                "norm3": norm(ch),
                "ff": {"proj": lin(ch, 2 * inner), "out": lin(inner, ch)}}

    def t2d(ch):
        return {"norm": norm(ch), "proj_in": conv(ch, ch, k=1),
                "blocks": [tblock(ch)], "proj_out": conv(ch, ch, k=1)}

    temb_dim = 4 * c.block_out_channels[0]
    params: Tree = {
        "conv_in": conv(c.in_channels, c.block_out_channels[0]),
        "time_embedding": {
            "linear_1": lin(c.block_out_channels[0], temb_dim),
            "linear_2": lin(temb_dim, temb_dim)},
    }
    down = []
    ch = c.block_out_channels[0]
    for i, btype in enumerate(c.down_block_types):
        cout = c.block_out_channels[i]
        blk: Tree = {"resnets": [resnet(ch if j == 0 else cout, cout,
                                        temb_dim)
                                 for j in range(c.layers_per_block)],
                     "attentions": []}
        if btype == "CrossAttnDownBlock2D":
            blk["attentions"] = [t2d(cout) for _ in range(c.layers_per_block)]
        if i < len(c.down_block_types) - 1:
            blk["downsamplers"] = [{"conv": conv(cout, cout)}]
        down.append(blk)
        ch = cout
    params["down_blocks"] = down

    mid_ch = c.block_out_channels[-1]
    params["mid_block"] = {
        "resnets": [resnet(mid_ch, mid_ch, temb_dim),
                    resnet(mid_ch, mid_ch, temb_dim)],
        "attentions": [t2d(mid_ch)]}

    up = []
    rev = list(reversed(c.block_out_channels))
    ch = rev[0]
    for i, btype in enumerate(c.up_block_types):
        cout = rev[i]
        cskip_end = rev[min(i + 1, len(rev) - 1)]
        blk = {"resnets": [], "attentions": []}
        for j in range(c.layers_per_block + 1):
            skip = cskip_end if j == c.layers_per_block else cout
            cin = (ch if j == 0 else cout) + skip
            blk["resnets"].append(resnet(cin, cout, temb_dim))
        if btype == "CrossAttnUpBlock2D":
            blk["attentions"] = [t2d(cout)
                                 for _ in range(c.layers_per_block + 1)]
        if i < len(c.up_block_types) - 1:
            blk["upsamplers"] = [{"conv": conv(cout, cout)}]
        up.append(blk)
        ch = cout
    params["up_blocks"] = up

    params["conv_norm_out"] = norm(c.block_out_channels[0])
    params["conv_out"] = conv(c.block_out_channels[0], c.out_channels)
    return params


class UNet2DCondition(_TreeModel):
    """The conditional UNet: ``apply(sample, t, ctx)`` with sample [b, h,
    w, c_in] (NHWC), t [b] (or a scalar), ctx [b, seq, cross_dim]."""

    def __init__(self, config: Optional[UNetConfig] = None, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        dev = resolve_device(device)
        self.config = config or UNetConfig()
        super().__init__(_unet_tree(self.config, _drawer(dev, dtype, seed)))

    def forward(self, sample, timesteps, encoder_hidden_states,
                params: Params = None) -> torch.Tensor:
        return self.apply(sample, timesteps, encoder_hidden_states, params)

    def apply(self, sample: torch.Tensor, timesteps, encoder_hidden_states:
              torch.Tensor, params: Params = None) -> torch.Tensor:
        """The predicted noise [b, h, w, c_out] in the sample's dtype."""
        c = self.config
        g = c.norm_num_groups
        p = self._tree(params)
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        temb = timestep_embedding(timesteps, c.block_out_channels[0])
        temb = linear(temb, p["time_embedding"]["linear_1"])
        temb = linear(_silu(temb), p["time_embedding"]["linear_2"])
        temb = temb.to(sample.dtype)
        ctx = encoder_hidden_states

        hd = c.attention_head_dim
        n_down = len(c.block_out_channels)
        heads_per_block = (tuple(hd) if isinstance(hd, (tuple, list))
                           else (hd,) * n_down)

        x = conv2d(sample, p["conv_in"])
        skips = [x]
        for i, blk in enumerate(p["down_blocks"]):
            attns = blk.get("attentions", [])
            for j, rp in enumerate(blk["resnets"]):
                x = resnet_block(x, temb, rp, groups=g)
                if attns:
                    x = transformer_2d(x, ctx, attns[j], heads_per_block[i],
                                       groups=g)
                skips.append(x)
            if "downsamplers" in blk:
                x = downsample(x, blk["downsamplers"][0])
                skips.append(x)

        mid = p["mid_block"]
        x = resnet_block(x, temb, mid["resnets"][0], groups=g)
        x = transformer_2d(x, ctx, mid["attentions"][0], heads_per_block[-1],
                           groups=g)
        x = resnet_block(x, temb, mid["resnets"][1], groups=g)

        for i, blk in enumerate(p["up_blocks"]):
            attns = blk.get("attentions", [])
            for j, rp in enumerate(blk["resnets"]):
                x = torch.cat([x, skips.pop()], dim=-1)
                x = resnet_block(x, temb, rp, groups=g)
                if attns:
                    x = transformer_2d(x, ctx, attns[j],
                                       heads_per_block[n_down - 1 - i],
                                       groups=g)
            if "upsamplers" in blk:
                x = upsample(x, blk["upsamplers"][0])

        x = _silu(group_norm(x, p["conv_norm_out"]["scale"],
                             p["conv_norm_out"]["bias"], groups=g))
        return conv2d(x, p["conv_out"])


# ----------------------------------------------------------------------
# AutoencoderKL


@dataclass
class VAEConfig:
    """Stable Diffusion's AutoencoderKL (83,653,863 parameters)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215


def _vae_attn(x: torch.Tensor, p: Tree, groups: int) -> torch.Tensor:
    """VAE mid-block attention (diffusers Attention over spatial tokens,
    single head, GN pre-norm, residual)."""
    b, h, w, c = x.shape
    y = group_norm(x, p["group_norm"]["scale"], p["group_norm"]["bias"],
                   groups=groups, eps=1e-6)
    y = y.reshape(b, h * w, c)
    y = _attention(y, y, p, heads=1)
    return x + y.reshape(b, h, w, c)


def _vae_tree(c: VAEConfig, leaf) -> Tree:
    """The VAE's parameter tree (the JAX ``AutoencoderKL.init``'s, with
    OIHW conv kernels), each leaf ``leaf(kind, shape)``."""
    conv, lin, norm = _makers(leaf)

    def resnet(cin, cout):
        p = {"norm1": norm(cin), "conv1": conv(cin, cout),
             "norm2": norm(cout), "conv2": conv(cout, cout)}
        if cin != cout:
            p["conv_shortcut"] = conv(cin, cout, k=1)
        return p

    def attn(ch):
        return {"group_norm": norm(ch), "to_q": lin(ch, ch),
                "to_k": lin(ch, ch), "to_v": lin(ch, ch),
                "to_out": lin(ch, ch)}

    enc_blocks = []
    ch = c.block_out_channels[0]
    for i, cout in enumerate(c.block_out_channels):
        blk = {"resnets": [resnet(ch if j == 0 else cout, cout)
                           for j in range(c.layers_per_block)]}
        if i < len(c.block_out_channels) - 1:
            blk["downsamplers"] = [{"conv": conv(cout, cout)}]
        enc_blocks.append(blk)
        ch = cout
    mid_ch = c.block_out_channels[-1]
    encoder = {
        "conv_in": conv(c.in_channels, c.block_out_channels[0]),
        "down_blocks": enc_blocks,
        "mid_block": {"resnets": [resnet(mid_ch, mid_ch),
                                  resnet(mid_ch, mid_ch)],
                      "attentions": [attn(mid_ch)]},
        "conv_norm_out": norm(mid_ch),
        "conv_out": conv(mid_ch, 2 * c.latent_channels),
    }

    dec_blocks = []
    rev = list(reversed(c.block_out_channels))
    ch = rev[0]
    for i, cout in enumerate(rev):
        blk = {"resnets": [resnet(ch if j == 0 else cout, cout)
                           for j in range(c.layers_per_block + 1)]}
        if i < len(rev) - 1:
            blk["upsamplers"] = [{"conv": conv(cout, cout)}]
        dec_blocks.append(blk)
        ch = cout
    decoder = {
        "conv_in": conv(c.latent_channels, rev[0]),
        "mid_block": {"resnets": [resnet(rev[0], rev[0]),
                                  resnet(rev[0], rev[0])],
                      "attentions": [attn(rev[0])]},
        "up_blocks": dec_blocks,
        "conv_norm_out": norm(c.block_out_channels[0]),
        "conv_out": conv(c.block_out_channels[0], c.out_channels),
    }
    return {"encoder": encoder,
            "quant_conv": conv(2 * c.latent_channels, 2 * c.latent_channels,
                               k=1),
            "post_quant_conv": conv(c.latent_channels, c.latent_channels,
                                    k=1),
            "decoder": decoder}


class AutoencoderKL(_TreeModel):
    """``encode(x) -> (mean, logvar)``; ``decode(latents) -> image``.
    NHWC."""

    def __init__(self, config: Optional[VAEConfig] = None, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        dev = resolve_device(device)
        self.config = config or VAEConfig()
        super().__init__(_vae_tree(self.config, _drawer(dev, dtype, seed)))

    def encode(self, x: torch.Tensor, params: Params = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """image [b, h, w, 3] -> (mean, logvar), each [b, h/8, w/8,
        latent]."""
        c = self.config
        g = c.norm_num_groups
        p = self._tree(params)
        e = p["encoder"]
        h = conv2d(x, e["conv_in"])
        for blk in e["down_blocks"]:
            for rp in blk["resnets"]:
                h = resnet_block(h, None, rp, groups=g, eps=1e-6)
            if "downsamplers" in blk:
                h = downsample_asym(h, blk["downsamplers"][0])
        m = e["mid_block"]
        h = resnet_block(h, None, m["resnets"][0], groups=g, eps=1e-6)
        h = _vae_attn(h, m["attentions"][0], groups=g)
        h = resnet_block(h, None, m["resnets"][1], groups=g, eps=1e-6)
        h = _silu(group_norm(h, e["conv_norm_out"]["scale"],
                             e["conv_norm_out"]["bias"], groups=g, eps=1e-6))
        h = conv2d(h, e["conv_out"])
        h = conv2d(h, p["quant_conv"], padding=0)
        mean, logvar = h.chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def sample_latents(self, x: torch.Tensor, generator: torch.Generator,
                       params: Params = None) -> torch.Tensor:
        """Scaled latents of ``x`` drawn from the posterior with
        ``generator`` (on x's device)."""
        mean, logvar = self.encode(x, params)
        eps = torch.randn(mean.shape, generator=generator, device=mean.device,
                          dtype=mean.dtype)
        return (mean + torch.exp(0.5 * logvar) * eps) \
            * self.config.scaling_factor

    def decode(self, z: torch.Tensor, params: Params = None) -> torch.Tensor:
        """latents [b, h, w, latent] -> image [b, 8h, 8w, 3]."""
        c = self.config
        g = c.norm_num_groups
        p = self._tree(params)
        d = p["decoder"]
        z = z / c.scaling_factor
        h = conv2d(z, p["post_quant_conv"], padding=0)
        h = conv2d(h, d["conv_in"])
        m = d["mid_block"]
        h = resnet_block(h, None, m["resnets"][0], groups=g, eps=1e-6)
        h = _vae_attn(h, m["attentions"][0], groups=g)
        h = resnet_block(h, None, m["resnets"][1], groups=g, eps=1e-6)
        for blk in d["up_blocks"]:
            for rp in blk["resnets"]:
                h = resnet_block(h, None, rp, groups=g, eps=1e-6)
            if "upsamplers" in blk:
                h = upsample(h, blk["upsamplers"][0])
        h = _silu(group_norm(h, d["conv_norm_out"]["scale"],
                             d["conv_norm_out"]["bias"], groups=g, eps=1e-6))
        return conv2d(h, d["conv_out"])
