"""GPT-2 / OPT / GPT-Neo family configs.

Ports ``deepspeed_tpu/models/gpt2.py``: the same presets, key for key, on
the shared :class:`~deepspeed_tpu_torch.models.transformer.Transformer`
core (LayerNorm + learned positions + GELU MLP + biases + tied
embeddings; GPT-Neo adds alternating global / local attention, unscaled
attention logits and no qkv biases).
"""

from __future__ import annotations

import torch

from .transformer import Transformer, TransformerConfig


def gpt2_config(size: str = "small", **overrides) -> TransformerConfig:
    presets = {
        "tiny": dict(vocab_size=50257, d_model=256, n_layers=4, n_heads=8, max_seq_len=512),
        "small": dict(vocab_size=50257, d_model=768, n_layers=12, n_heads=12, max_seq_len=1024),
        "medium": dict(vocab_size=50257, d_model=1024, n_layers=24, n_heads=16, max_seq_len=1024),
        "large": dict(vocab_size=50257, d_model=1280, n_layers=36, n_heads=20, max_seq_len=1024),
        "xl": dict(vocab_size=50257, d_model=1600, n_layers=48, n_heads=25, max_seq_len=1024),
    }
    if size not in presets:
        raise ValueError(f"unknown gpt2 size '{size}'; have {sorted(presets)}")
    kw = dict(presets[size])
    kw.update(norm="layer", activation="gelu", position="learned",
              tie_embeddings=True, use_bias=True, norm_eps=1e-5)
    kw.update(overrides)
    return TransformerConfig(**kw)


def opt_config(size: str = "1.3b", **overrides) -> TransformerConfig:
    presets = {
        "125m": dict(vocab_size=50272, d_model=768, n_layers=12, n_heads=12),
        "1.3b": dict(vocab_size=50272, d_model=2048, n_layers=24, n_heads=32),
        "6.7b": dict(vocab_size=50272, d_model=4096, n_layers=32, n_heads=32),
        "13b": dict(vocab_size=50272, d_model=5120, n_layers=40, n_heads=40),
        "30b": dict(vocab_size=50272, d_model=7168, n_layers=48, n_heads=56),
    }
    if size not in presets:
        raise ValueError(f"unknown opt size '{size}'; have {sorted(presets)}")
    kw = dict(presets[size])
    kw.update(max_seq_len=2048, norm="layer", activation="gelu", position="learned",
              tie_embeddings=True, use_bias=True, norm_eps=1e-5)
    kw.update(overrides)
    return TransformerConfig(**kw)


def gpt_neo_config(size: str = "125m", **overrides) -> TransformerConfig:
    """GPT-Neo: alternating global/local causal attention (window 256),
    unscaled attention logits, qkv projections without bias."""
    presets = {
        "tiny": dict(vocab_size=50257, d_model=256, n_layers=4, n_heads=8,
                     max_seq_len=512),
        "125m": dict(vocab_size=50257, d_model=768, n_layers=12, n_heads=12,
                     max_seq_len=2048),
        "1.3b": dict(vocab_size=50257, d_model=2048, n_layers=24, n_heads=16,
                     max_seq_len=2048),
        "2.7b": dict(vocab_size=50257, d_model=2560, n_layers=32, n_heads=20,
                     max_seq_len=2048),
    }
    if size not in presets:
        raise ValueError(f"unknown gpt_neo size '{size}'; have {sorted(presets)}")
    kw = dict(presets[size])
    n = kw["n_layers"]
    kw.update(norm="layer", activation="gelu", position="learned",
              tie_embeddings=True, use_bias=True, qkv_bias=False,
              attn_scale=1.0,
              attn_windows=tuple(0 if i % 2 == 0 else 256 for i in range(n)),
              use_flash=False,  # varying windows take the plain attention
              norm_eps=1e-5)
    kw.update(overrides)
    return TransformerConfig(**kw)


def GPT2(size: str = "small", device=None, dtype: torch.dtype = torch.float32,
         seed: int = 0, **overrides) -> Transformer:
    """A GPT-2 of the preset ``size``, weights made from ``seed`` on
    ``device`` (default ``"cuda"``)."""
    return Transformer(gpt2_config(size, **overrides), device=device,
                       dtype=dtype, seed=seed)


def GPTNeo(size: str = "125m", device=None,
           dtype: torch.dtype = torch.float32, seed: int = 0,
           **overrides) -> Transformer:
    """A GPT-Neo of the preset ``size``, as :func:`GPT2`."""
    return Transformer(gpt_neo_config(size, **overrides), device=device,
                       dtype=dtype, seed=seed)


def OPT(size: str = "1.3b", device=None, dtype: torch.dtype = torch.float32,
        seed: int = 0, **overrides) -> Transformer:
    """An OPT of the preset ``size``, as :func:`GPT2`."""
    return Transformer(opt_config(size, **overrides), device=device,
                       dtype=dtype, seed=seed)
