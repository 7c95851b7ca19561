"""Export the port's models back to Hugging Face format.

Ports ``deepspeed_tpu/checkpoint/export.py``: the inverse of
:mod:`.hf`'s maps for the llama layout (Llama / Mistral / InternLM /
Qwen2), Mixtral and GPT-2 — per-layer leaves under HF names, ``[in,
out]`` transposed back to torch's ``[out, in]`` — written with the
port's own safetensors codec (:mod:`.safetensors_io`) beside a
``config.json`` that ``transformers`` loads. Leaves keep their dtype
(bf16 stays bf16; the JAX package writes fp32 because numpy has no
bfloat16 bridge). ``max_shard_bytes`` writes a sharded directory
(``model.safetensors.index.json`` + ``model-0000i-of-0000n``) instead of
one ``model.safetensors``.

``params`` is a ``{name: tensor}`` dict with the names of the model's
``named_parameters()`` (a trainer's ``full_params()`` or
``get_fp32_state_dict()``), or None for the model's own weights; a
model cut over a model axis must be exported from full-width params.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional

import torch

from . import safetensors_io as sio

__all__ = ["export_hf_llama", "export_hf_gpt2", "export_hf_mixtral"]

Params = Mapping[str, torch.Tensor]


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.detach().cpu().contiguous()


def _tT(x: torch.Tensor) -> torch.Tensor:
    """Transposed to torch's [out, in], CONTIGUOUS: the file holds the
    raw buffer, so a strided view would write the untransposed bytes."""
    return x.detach().cpu().t().contiguous()


def _params(model, params: Optional[Params]) -> Params:
    if params is None:
        if getattr(model, "_tp_size", 1) > 1:
            raise ValueError("the model is cut over a model axis: export "
                             "full-width params (a trainer's full_params())")
        params = dict(model.named_parameters())
    return params


def _write(state: Dict[str, torch.Tensor], out_dir: str,
           max_shard_bytes: Optional[int]) -> None:
    if max_shard_bytes:
        sio.save_sharded(state, out_dir, max_shard_bytes)
    else:
        sio.save_file(state, os.path.join(out_dir, "model.safetensors"),
                      {"format": "pt"})


def _dtype_name(params: Params) -> str:
    dt = next(iter(params.values())).dtype
    return {torch.bfloat16: "bfloat16", torch.float16: "float16"}.get(
        dt, "float32")


def _llama_trunk_state(c, p: Params) -> Dict[str, torch.Tensor]:
    """Embeddings + final norm + (untied) head + per-layer llama-style
    attention / norm keys: what every rms + rope exporter shares."""
    state = {"model.embed_tokens.weight": _t(p["tok_embed"]),
             "model.norm.weight": _t(p["final_norm_w"])}
    if not c.tie_embeddings:
        state["lm_head.weight"] = _tT(p["lm_head"])
    for i in range(c.n_layers):
        L, P = f"model.layers.{i}.", f"layers.{i}."
        state.update({
            L + "input_layernorm.weight": _t(p[P + "attn_norm_w"]),
            L + "post_attention_layernorm.weight": _t(p[P + "mlp_norm_w"]),
            L + "self_attn.q_proj.weight": _tT(p[P + "wq"]),
            L + "self_attn.k_proj.weight": _tT(p[P + "wk"]),
            L + "self_attn.v_proj.weight": _tT(p[P + "wv"]),
            L + "self_attn.o_proj.weight": _tT(p[P + "wo"]),
        })
    return state


def _base_causal_config(c, model_type: str, arch: str, dtype: str
                        ) -> Dict[str, Any]:
    hf_config: Dict[str, Any] = {
        "architectures": [arch], "model_type": model_type,
        "vocab_size": c.vocab_size, "hidden_size": c.d_model,
        "intermediate_size": c.d_ff, "num_hidden_layers": c.n_layers,
        "num_attention_heads": c.n_heads,
        "num_key_value_heads": c.n_kv_heads,
        "max_position_embeddings": c.max_seq_len,
        "rms_norm_eps": c.norm_eps, "rope_theta": c.rope_theta,
        "tie_word_embeddings": bool(c.tie_embeddings),
        "hidden_act": "silu", "torch_dtype": dtype,
    }
    if getattr(c, "attn_windows", None):
        w = c.attn_windows[0]
        if w and all(x == w for x in c.attn_windows):
            hf_config["sliding_window"] = int(w)
    return hf_config


def _check_llama_layout(c, what: str) -> None:
    if c.norm != "rms" or c.activation != "silu_glu" or c.position != "rope":
        raise NotImplementedError(
            f"{what} handles the llama layout (rms + silu_glu + rope); got "
            f"norm={c.norm} activation={c.activation} position={c.position}")


def export_hf_llama(model, params: Optional[Params], out_dir: str,
                    model_type: str = "llama",
                    max_shard_bytes: Optional[int] = None) -> str:
    """Write HF llama naming (``model.safetensors`` or shards +
    ``config.json``) from a llama-layout model. Inverse of
    ``hf._map_llama``."""
    c = model.config
    _check_llama_layout(c, "export_hf_llama")
    # bias layouts must match what the TARGET class builds, or HF leaves
    # unmatched biases randomly initialized (silently wrong logits)
    o_bias = bool(getattr(c, "attn_o_bias", False))
    if model_type in ("llama", "mistral", "internlm"):
        if bool(c.qkv_bias) != o_bias:
            raise NotImplementedError(
                f"{model_type} export needs qkv_bias == attn_o_bias "
                f"(attention_bias covers all four projections); got "
                f"qkv_bias={c.qkv_bias} attn_o_bias={o_bias} — export as "
                "model_type='qwen2' for qkv-only biases")
    elif model_type == "qwen2":
        if not c.qkv_bias or o_bias:
            raise NotImplementedError(
                "qwen2 export is the qkv-only-bias layout; got "
                f"qkv_bias={c.qkv_bias} attn_o_bias={o_bias}")
    else:
        raise ValueError(f"unknown export model_type '{model_type}'")
    p = _params(model, params)
    os.makedirs(out_dir, exist_ok=True)
    state = _llama_trunk_state(c, p)
    for i in range(c.n_layers):
        L, P = f"model.layers.{i}.", f"layers.{i}."
        state.update({
            L + "mlp.gate_proj.weight": _tT(p[P + "w_gate"]),
            L + "mlp.up_proj.weight": _tT(p[P + "w_up"]),
            L + "mlp.down_proj.weight": _tT(p[P + "w_down"]),
        })
        if P + "bq" in p:
            state[L + "self_attn.q_proj.bias"] = _t(p[P + "bq"])
            state[L + "self_attn.k_proj.bias"] = _t(p[P + "bk"])
            state[L + "self_attn.v_proj.bias"] = _t(p[P + "bv"])
        if P + "bo" in p:
            state[L + "self_attn.o_proj.bias"] = _t(p[P + "bo"])
    _write(state, out_dir, max_shard_bytes)
    arch = {"llama": "LlamaForCausalLM", "mistral": "MistralForCausalLM",
            "qwen2": "Qwen2ForCausalLM",
            "internlm": "InternLMForCausalLM"}[model_type]
    hf_config = _base_causal_config(c, model_type, arch, _dtype_name(p))
    if model_type in ("llama", "mistral", "internlm"):
        hf_config["attention_bias"] = bool(c.qkv_bias)
    if model_type == "internlm":
        hf_config["bias"] = bool(c.qkv_bias)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf_config, f, indent=2)
    return out_dir


def export_hf_mixtral(model, params: Optional[Params], out_dir: str,
                      max_shard_bytes: Optional[int] = None) -> str:
    """Write HF Mixtral format from an MoE model: llama-style attention
    plus per-layer routed experts (``block_sparse_moe.experts.{e}.w1 /
    w2 / w3``). Inverse of ``hf._map_mixtral``."""
    c = model.config
    _check_llama_layout(c, "export_hf_mixtral")
    E = getattr(c, "n_experts", 0)
    if not E:
        raise ValueError("model has no experts — use export_hf_llama")
    if getattr(c, "n_shared_experts", 0):
        raise NotImplementedError(
            "MixtralForCausalLM has no shared-expert branch")
    if bool(c.qkv_bias) or bool(getattr(c, "attn_o_bias", False)):
        raise NotImplementedError(
            "MixtralForCausalLM constructs bias-free attention; got "
            f"qkv_bias={c.qkv_bias} attn_o_bias={c.attn_o_bias}")
    p = _params(model, params)
    os.makedirs(out_dir, exist_ok=True)
    state = _llama_trunk_state(c, p)
    for i in range(c.n_layers):
        L, P = f"model.layers.{i}.", f"layers.{i}."
        # router: wg [d, E] -> HF gate [E, d]
        state[L + "block_sparse_moe.gate.weight"] = _tT(p[P + "wg"])
        for e in range(E):
            X = L + f"block_sparse_moe.experts.{e}."
            # banks [E, d, f] (gate / up) and [E, f, d] (down) -> HF w1 /
            # w3 [f, d], w2 [d, f]
            state[X + "w1.weight"] = _tT(p[P + "w_gate"][e])
            state[X + "w3.weight"] = _tT(p[P + "w_up"][e])
            state[X + "w2.weight"] = _tT(p[P + "w_down"][e])
    _write(state, out_dir, max_shard_bytes)
    hf_config = _base_causal_config(c, "mixtral", "MixtralForCausalLM",
                                    _dtype_name(p))
    hf_config.update({"num_local_experts": int(E),
                      "num_experts_per_tok": int(c.top_k),
                      "output_router_logits": False})
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf_config, f, indent=2)
    return out_dir


def export_hf_gpt2(model, params: Optional[Params], out_dir: str,
                   max_shard_bytes: Optional[int] = None) -> str:
    """Write HF GPT-2 format (Conv1D [in, out], the port's orientation,
    fused c_attn) from a GPT-2-layout model. Inverse of
    ``hf._map_gpt2``."""
    c = model.config
    if c.norm != "layer" or c.position != "learned" or not c.use_bias:
        raise NotImplementedError(
            "export_hf_gpt2 handles the GPT-2 layout (layer norm + learned "
            f"positions + biases); got norm={c.norm} position={c.position} "
            f"use_bias={c.use_bias}")
    if c.n_kv_heads != c.n_heads:
        raise NotImplementedError("GPT-2 layout has no GQA")
    if not c.tie_embeddings:
        # GPT2LMHeadModel ties wte to the head: an untied lm_head would
        # be dropped silently
        raise NotImplementedError(
            "GPT-2 export requires tie_embeddings=True (GPT2LMHeadModel "
            "ties the head to wte)")
    p = _params(model, params)
    os.makedirs(out_dir, exist_ok=True)
    state = {"wte.weight": _t(p["tok_embed"]),
             "wpe.weight": _t(p["pos_embed"]),
             "ln_f.weight": _t(p["final_norm_w"]),
             "ln_f.bias": _t(p["final_norm_b"])}
    for i in range(c.n_layers):
        L, P = f"h.{i}.", f"layers.{i}."
        state.update({
            L + "ln_1.weight": _t(p[P + "attn_norm_w"]),
            L + "ln_1.bias": _t(p[P + "attn_norm_b"]),
            L + "attn.c_attn.weight": torch.cat(
                [_t(p[P + "wq"]), _t(p[P + "wk"]), _t(p[P + "wv"])], dim=1),
            L + "attn.c_attn.bias": torch.cat(
                [_t(p[P + "bq"]), _t(p[P + "bk"]), _t(p[P + "bv"])]),
            L + "attn.c_proj.weight": _t(p[P + "wo"]),
            L + "attn.c_proj.bias": _t(p[P + "bo"]),
            L + "ln_2.weight": _t(p[P + "mlp_norm_w"]),
            L + "ln_2.bias": _t(p[P + "mlp_norm_b"]),
            L + "mlp.c_fc.weight": _t(p[P + "w_up"]),
            L + "mlp.c_fc.bias": _t(p[P + "b_up"]),
            L + "mlp.c_proj.weight": _t(p[P + "w_down"]),
            L + "mlp.c_proj.bias": _t(p[P + "b_down"]),
        })
    _write(state, out_dir, max_shard_bytes)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump({
            "architectures": ["GPT2LMHeadModel"], "model_type": "gpt2",
            "vocab_size": c.vocab_size, "n_embd": c.d_model,
            "n_layer": c.n_layers, "n_head": c.n_heads,
            "n_positions": c.max_seq_len, "n_inner": c.d_ff,
            "layer_norm_epsilon": c.norm_eps,
            "activation_function": "gelu_new",
            "tie_word_embeddings": True, "torch_dtype": _dtype_name(p),
        }, f, indent=2)
    return out_dir
