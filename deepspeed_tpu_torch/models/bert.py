"""BERT / DistilBERT encoder family configs.

Ports ``deepspeed_tpu/models/bert.py``: the same presets, key for key, on
the shared :class:`~deepspeed_tpu_torch.models.transformer.Transformer`
core with post-LN (``prenorm=False``) bidirectional (``causal=False``)
blocks: learned positions and segment (token-type) embeddings normalized
together (``embed_norm``), exact (erf) GELU, the MLM head (dense + GELU +
LayerNorm + tied decoder + vocab bias) and the ``[CLS]`` tanh pooler.
DistilBERT drops the token types and the pooler.
"""

from __future__ import annotations

import torch

from .transformer import Transformer, TransformerConfig


def bert_config(size: str = "base", **overrides) -> TransformerConfig:
    presets = {
        "tiny": dict(d_model=128, n_layers=2, n_heads=2),
        "mini": dict(d_model=256, n_layers=4, n_heads=4),
        "base": dict(d_model=768, n_layers=12, n_heads=12),
        "large": dict(d_model=1024, n_layers=24, n_heads=16),
    }
    if size not in presets:
        raise ValueError(f"unknown bert size '{size}'; have {sorted(presets)}")
    kw = dict(presets[size])
    kw.update(vocab_size=30522, max_seq_len=512, norm="layer",
              activation="gelu_exact", position="learned",
              causal=False, prenorm=False, embed_norm=True,
              type_vocab_size=2, mlm_head=True, pooler=True,
              tie_embeddings=True, use_bias=True, norm_eps=1e-12)
    kw.update(overrides)
    return TransformerConfig(**kw)


def distilbert_config(size: str = "base", **overrides) -> TransformerConfig:
    presets = {
        "tiny": dict(d_model=128, n_layers=2, n_heads=2),
        "base": dict(d_model=768, n_layers=6, n_heads=12),
    }
    if size not in presets:
        raise ValueError(f"unknown distilbert size '{size}'; have {sorted(presets)}")
    kw = dict(presets[size])
    kw.update(vocab_size=30522, max_seq_len=512, norm="layer",
              activation="gelu_exact", position="learned",
              causal=False, prenorm=False, embed_norm=True,
              type_vocab_size=0, mlm_head=True, pooler=False,
              tie_embeddings=True, use_bias=True, norm_eps=1e-12)
    kw.update(overrides)
    return TransformerConfig(**kw)


def Bert(size: str = "base", device=None, dtype: torch.dtype = torch.float32,
         seed: int = 0, **overrides) -> Transformer:
    """A BERT of the preset ``size``, weights made from ``seed`` on
    ``device`` (default ``"cuda"``)."""
    return Transformer(bert_config(size, **overrides), device=device,
                       dtype=dtype, seed=seed)


def DistilBert(size: str = "base", device=None,
               dtype: torch.dtype = torch.float32, seed: int = 0,
               **overrides) -> Transformer:
    """A DistilBERT of the preset ``size``, as :func:`Bert`."""
    return Transformer(distilbert_config(size, **overrides), device=device,
                       dtype=dtype, seed=seed)
