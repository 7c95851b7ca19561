"""Mixture-of-Experts transformer family (DeepSpeed-MoE's GPT-MoE).

Ports ``deepspeed_tpu/models/moe.py``: every layer's FFN is an expert bank
routed by top-k gating (:class:`~deepspeed_tpu_torch.parallel.moe.MoELayer`).
A layer holds ``wg [d, E]``, ``w_up [E, d, f]``, ``w_down [E, f, d]`` and,
by the config, ``w_gate [E, d, f]`` (gated SiLU) and ``b_up [E, f]`` /
``b_down [E, d]`` (``use_bias``) in place of the dense FFN's leaves; the
JAX package stacks them ``[n_layers, E, ...]``.

The model serves through the ragged engine (its ``_core`` runs the
model's own ``_mlp``, as the JAX engine runs "the MoE override") and the
v1 engine (``init_inference``, bf16 or int8 / int4 weights), on the
no-drop route. :meth:`Transformer.loss` takes the training route
(capacity and drops, a noisy gate's noise from the ``generator`` that
the trainer draws a micro-batch) and adds the aux loss times
``aux_loss_weight``; ``initialize`` trains it on one device or over a
``data`` x ``model`` mesh. Over the ``model`` axis (serving, both
engines, and training) each rank holds ``d_ff / tp`` of every expert
(:meth:`MoETransformer.partition_specs`, JAX's) and sums the bank's
``w_down`` rows over the group; expert parallelism comes with ROADMAP.md
Queue A item 13.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ..parallel.moe import GateConfig, MoELayer
from .transformer import Transformer, TransformerConfig

_DENSE_FFN = ("w_gate", "w_up", "w_down", "b_up", "b_down")


@dataclass
class MoETransformerConfig(TransformerConfig):
    """Copy of the JAX package's MoE config (same fields and defaults)."""

    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    min_capacity: int = 4
    aux_loss_weight: float = 0.01
    noisy_gate_policy: Optional[str] = None

    def gate_config(self) -> GateConfig:
        return GateConfig(
            n_experts=self.n_experts, top_k=self.top_k,
            capacity_factor=self.capacity_factor,
            min_capacity=self.min_capacity,
            aux_loss_weight=self.aux_loss_weight,
            noisy_gate_policy=self.noisy_gate_policy)

    def moe_layer(self) -> MoELayer:
        return MoELayer(self.d_model, self.d_ff, self.gate_config(),
                        activation=self.activation, use_bias=self.use_bias)

    def layer_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """The dense leaf set with the FFN's leaves replaced by the expert
        bank's, appended in the JAX MoE ``init``'s order."""
        shapes = super().layer_shapes()
        for name in _DENSE_FFN:
            shapes.pop(name, None)
        shapes.update(self.moe_layer().shapes())
        return shapes

    def param_count(self) -> int:
        d, f, n = self.d_model, self.d_ff, self.n_layers
        n_mats = 3 if self.activation == "silu_glu" else 2
        moe = self.n_experts * n_mats * d * f + d * self.n_experts
        return self._shared_param_count() + n * moe

    def active_param_count(self) -> int:
        """Parameters a single token exercises (its top_k experts)."""
        d, f, n = self.d_model, self.d_ff, self.n_layers
        n_mats = 3 if self.activation == "silu_glu" else 2
        active_moe = self.top_k * n_mats * d * f + d * self.n_experts
        return self._shared_param_count() + n * active_moe

    def flops_per_token(self, seq_len: int) -> float:
        """Only the experts a token routes through count, plus the
        window-aware attention term."""
        return 6.0 * self.active_param_count() \
            + 12.0 * self.d_model * self._attn_flop_len(seq_len)


class MoETransformer(Transformer):
    """A :class:`Transformer` with an expert bank as every block's FFN."""

    def __init__(self, config: MoETransformerConfig, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        self.moe = config.moe_layer()
        super().__init__(config, device=device, dtype=dtype, seed=seed)

    def _leaf_std(self, name: str, w: torch.Tensor) -> float:
        """The bank's leaves ~ N(0, 1/fan_in), fan_in their ``in`` width
        (the JAX ``MoELayer.init``); the rest as the dense model."""
        if name in ("wg", "w_up", "w_gate", "w_down"):
            return 1.0 / math.sqrt(w.shape[-2])
        return super()._leaf_std(name, w)

    def _mlp(self, h: torch.Tensor, lp, generator=None,
             training: bool = False):
        """The expert bank over ``h`` ``[b, s, d]`` -> (out, aux loss x
        ``aux_loss_weight``); under tensor parallelism the bank's
        ``w_down`` rows are summed over the model group, and in training
        the bank's input goes through the differentiable copy."""
        params = {k: lp[k] for k in self.moe.shapes()}
        tp = self._tp_size > 1
        out, aux = self.moe.apply(
            params, h, generator=generator, training=training,
            reduce=self._all_reduce if tp else None,
            copy=self._tp_copy if tp else None)
        return out, aux * self.config.aux_loss_weight

    def partition_specs(self, params=None, topo=None):
        """The JAX package's specs: the dense model's without its FFN
        leaves, and the bank's (:meth:`MoELayer.partition_specs`)."""
        specs = super().partition_specs(params, topo)
        layers = {k: v for k, v in specs["layers"].items()
                  if k not in _DENSE_FFN}
        layers.update(self.moe.partition_specs(n_layers=self.config.n_layers))
        specs["layers"] = layers
        return specs


def gpt_moe_config(size: str = "350m", n_experts: int = 8,
                   **overrides) -> MoETransformerConfig:
    """GPT-MoE presets (DeepSpeed-MoE's GPT family): ``"350m"`` with 128
    experts is DeepSpeed-MoE's "350M+MoE-128"."""
    presets = {
        "tiny": dict(d_model=128, n_layers=2, n_heads=4, max_seq_len=256,
                     vocab_size=1024),
        "350m": dict(d_model=1024, n_layers=24, n_heads=16, max_seq_len=2048,
                     vocab_size=50257),
        "1.3b": dict(d_model=2048, n_layers=24, n_heads=32, max_seq_len=2048,
                     vocab_size=50257),
    }
    if size not in presets:
        raise ValueError(f"unknown gpt-moe size '{size}'; have "
                         f"{sorted(presets)}")
    kw = dict(presets[size])
    kw.update(norm="layer", activation="gelu", position="learned",
              use_bias=False, tie_embeddings=True, n_experts=n_experts,
              norm_eps=1e-5)
    kw.update(overrides)
    return MoETransformerConfig(**kw)


def GPTMoE(size: str = "350m", n_experts: int = 8, device=None,
           dtype: torch.dtype = torch.float32, seed: int = 0,
           **overrides) -> MoETransformer:
    """A GPT-MoE of the preset ``size`` with ``n_experts`` experts a layer,
    weights made from ``seed`` on ``device`` (default ``"cuda"``)."""
    return MoETransformer(gpt_moe_config(size, n_experts, **overrides),
                          device=device, dtype=dtype, seed=seed)
