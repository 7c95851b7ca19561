"""Hugging Face checkpoints into the port's models.

Ports ``deepspeed_tpu/checkpoint/hf.py``: the same config translation
(:func:`hf_config`, every family: Llama / Mistral / InternLM / Qwen2,
GPT-2, OPT, Mixtral, Bloom, GPT-J, GPT-NeoX, Falcon, GPT-Neo, BERT,
DistilBERT, CLIP) and the same weight maps (:func:`map_hf_params`, to the
JAX package's stacked ``[n_layers, ...]`` tree, key for key), on
``torch`` tensors instead of numpy: the file's tensors are read in their
own dtype (:mod:`.safetensors_io` for ``*.safetensors``,
``torch.load(weights_only=True)`` for ``pytorch_model.bin``, single or
index-sharded) and reach the model without a float32 copy (numpy has no
bfloat16 on the machine that runs the port, and a 7B bf16 checkpoint
through fp32 would need twice its size in host memory).

:func:`from_pretrained` builds the port's model (``Transformer``,
``MoETransformer`` or ``CLIP``) on the device and copies each leaf in,
cast to ``dtype``. Under a ``model`` axis the model is cut to this rank's
shards first (``Transformer.shard_``, as ``initialize`` cuts it) and each
leaf is sliced before it is copied. A GPT-J checkpoint's LM-head bias
becomes the model's ``lm_head_b`` (``Transformer.add_head_bias``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from . import safetensors_io as sio

__all__ = ["read_hf_state", "hf_config", "map_hf_params", "from_pretrained",
           "load_tree"]

State = Dict[str, torch.Tensor]


# ----------------------------------------------------------------------
# raw tensor reading
def read_hf_state(model_dir: str) -> State:
    """Every tensor of an HF checkpoint directory, as CPU tensors in the
    file's dtypes (safetensors files are mapped, not read)."""
    d = str(model_dir)
    st_index = os.path.join(d, sio.INDEX_FILE)
    pt_index = os.path.join(d, "pytorch_model.bin.index.json")
    if os.path.exists(st_index) or os.path.exists(pt_index):
        index = st_index if os.path.exists(st_index) else pt_index
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        state: State = {}
        for shard in sorted(set(weight_map.values())):
            state.update(read_one(os.path.join(d, shard)))
        return state
    for name in ("model.safetensors", "pytorch_model.bin"):
        path = os.path.join(d, name)
        if os.path.exists(path):
            return read_one(path)
    raise FileNotFoundError(
        f"no model.safetensors / pytorch_model.bin (or index) under {d}")


def read_one(path: str) -> State:
    """One ``.safetensors`` or torch-pickle weight file."""
    if path.endswith(".safetensors"):
        return sio.load_file(path)
    return dict(torch.load(path, map_location="cpu", weights_only=True))


# ----------------------------------------------------------------------
# config translation
def _uniform_windows(window, max_seq: int, n_layers: int):
    """Per-layer attn_windows for a uniform sliding window (Mistral /
    Mixtral); None when no window is configured or it never binds."""
    if window is None or window >= max_seq:
        return None
    return tuple([int(window)] * n_layers)


def hf_config(model_dir: str):
    """Parse HF config.json -> (family, the port's config)."""
    from ..models.transformer import TransformerConfig

    with open(os.path.join(str(model_dir), "config.json")) as f:
        hc = json.load(f)
    family = hc.get("model_type", "")
    if family in ("llama", "mistral"):
        if hc.get("rope_scaling"):
            raise NotImplementedError(
                f"rope_scaling={hc['rope_scaling']} not supported "
                "(plain RoPE only)")
        if hc.get("attention_bias"):
            raise NotImplementedError("llama attention_bias=true not supported")
        max_seq = hc.get("max_position_embeddings", 2048)
        n_layers = hc["num_hidden_layers"]
        cfg = TransformerConfig(
            vocab_size=hc["vocab_size"], d_model=hc["hidden_size"],
            n_layers=n_layers, n_heads=hc["num_attention_heads"],
            n_kv_heads=hc.get("num_key_value_heads", hc["num_attention_heads"]),
            d_ff=hc["intermediate_size"], max_seq_len=max_seq,
            attn_windows=_uniform_windows(hc.get("sliding_window"), max_seq,
                                          n_layers),
            norm="rms", activation="silu_glu", position="rope",
            rope_theta=hc.get("rope_theta", 10000.0),
            tie_embeddings=hc.get("tie_word_embeddings", False),
            use_bias=False, norm_eps=hc.get("rms_norm_eps", 1e-6))
    elif family == "internlm":
        if hc.get("rope_scaling"):
            raise NotImplementedError("internlm rope_scaling not supported")
        bias = bool(hc.get("bias", True))
        cfg = TransformerConfig(
            vocab_size=hc["vocab_size"], d_model=hc["hidden_size"],
            n_layers=hc["num_hidden_layers"],
            n_heads=hc["num_attention_heads"],
            n_kv_heads=hc.get("num_key_value_heads",
                              hc["num_attention_heads"]),
            d_ff=hc["intermediate_size"],
            max_seq_len=hc.get("max_position_embeddings", 2048),
            norm="rms", activation="silu_glu", position="rope",
            rope_theta=hc.get("rope_theta", 10000.0),
            tie_embeddings=hc.get("tie_word_embeddings", False),
            use_bias=False, qkv_bias=bias, attn_o_bias=bias,
            norm_eps=hc.get("rms_norm_eps", 1e-6))
    elif family == "qwen2":
        if hc.get("rope_scaling"):
            raise NotImplementedError("qwen2 rope_scaling not supported")
        n_layers = hc["num_hidden_layers"]
        max_seq = hc.get("max_position_embeddings", 32768)
        windows = None
        if hc.get("use_sliding_window", False) and hc.get("sliding_window") \
                and hc["sliding_window"] < max_seq:
            w = int(hc["sliding_window"])
            if "layer_types" in hc:
                if len(hc["layer_types"]) != n_layers:
                    raise ValueError(
                        f"qwen2 layer_types has {len(hc['layer_types'])} "
                        f"entries for {n_layers} layers")
                windows = tuple(w if t == "sliding_attention" else 0
                                for t in hc["layer_types"])
            else:
                mwl = hc.get("max_window_layers", n_layers)
                windows = tuple(0 if i < mwl else w for i in range(n_layers))
            if not any(windows):
                windows = None
        cfg = TransformerConfig(
            vocab_size=hc["vocab_size"], d_model=hc["hidden_size"],
            n_layers=n_layers, n_heads=hc["num_attention_heads"],
            n_kv_heads=hc.get("num_key_value_heads", hc["num_attention_heads"]),
            d_ff=hc["intermediate_size"], max_seq_len=max_seq,
            attn_windows=windows,
            norm="rms", activation="silu_glu", position="rope",
            rope_theta=hc.get("rope_theta", 10000.0),
            tie_embeddings=hc.get("tie_word_embeddings", False),
            use_bias=False, qkv_bias=True,
            norm_eps=hc.get("rms_norm_eps", 1e-6))
    elif family == "gpt2":
        cfg = TransformerConfig(
            vocab_size=hc["vocab_size"], d_model=hc["n_embd"],
            n_layers=hc["n_layer"], n_heads=hc["n_head"],
            d_ff=hc.get("n_inner") or 4 * hc["n_embd"],
            max_seq_len=hc.get("n_positions", 1024),
            norm="layer", activation="gelu", position="learned",
            tie_embeddings=True, use_bias=True,
            norm_eps=hc.get("layer_norm_epsilon", 1e-5))
    elif family == "opt":
        if not hc.get("do_layer_norm_before", True):
            raise NotImplementedError(
                "post-norm OPT (do_layer_norm_before=false, the 350m variant) "
                "not supported")
        act = hc.get("activation_function", "relu")
        cfg = TransformerConfig(
            vocab_size=hc["vocab_size"], d_model=hc["hidden_size"],
            n_layers=hc["num_hidden_layers"], n_heads=hc["num_attention_heads"],
            d_ff=hc.get("ffn_dim", 4 * hc["hidden_size"]),
            max_seq_len=hc.get("max_position_embeddings", 2048),
            norm="layer", activation="relu" if act == "relu" else "gelu",
            position="learned",
            tie_embeddings=hc.get("tie_word_embeddings", True),
            use_bias=hc.get("enable_bias", True), norm_eps=1e-5)
        if hc["hidden_size"] != hc.get("word_embed_proj_dim",
                                       hc["hidden_size"]):
            raise NotImplementedError("OPT word_embed_proj_dim != hidden_size")
    elif family == "mixtral":
        from ..models.moe import MoETransformerConfig

        if hc.get("rope_scaling"):
            raise NotImplementedError("mixtral rope_scaling not supported")
        max_seq = hc.get("max_position_embeddings", 4096)
        n_layers = hc["num_hidden_layers"]
        cfg = MoETransformerConfig(
            vocab_size=hc["vocab_size"], d_model=hc["hidden_size"],
            n_layers=n_layers, n_heads=hc["num_attention_heads"],
            n_kv_heads=hc.get("num_key_value_heads", hc["num_attention_heads"]),
            d_ff=hc["intermediate_size"], max_seq_len=max_seq,
            attn_windows=_uniform_windows(hc.get("sliding_window"), max_seq,
                                          n_layers),
            norm="rms", activation="silu_glu", position="rope",
            rope_theta=hc.get("rope_theta", 1e6),
            tie_embeddings=hc.get("tie_word_embeddings", False),
            use_bias=False, norm_eps=hc.get("rms_norm_eps", 1e-5),
            n_experts=hc["num_local_experts"],
            top_k=hc["num_experts_per_tok"])
    elif family == "bloom":
        cfg = TransformerConfig(
            vocab_size=hc["vocab_size"], d_model=hc["hidden_size"],
            n_layers=hc["n_layer"], n_heads=hc["n_head"],
            d_ff=4 * hc["hidden_size"],
            # ALiBi extrapolates: the bound only sizes KV checks
            max_seq_len=hc.get("seq_length", 131072),
            norm="layer", activation="gelu", position="alibi",
            embed_norm=True, tie_embeddings=True, use_bias=True,
            norm_eps=hc.get("layer_norm_epsilon", 1e-5))
    elif family == "gptj":
        hd = hc["n_embd"] // hc["n_head"]
        cfg = TransformerConfig(
            vocab_size=hc["vocab_size"], d_model=hc["n_embd"],
            n_layers=hc["n_layer"], n_heads=hc["n_head"],
            d_ff=hc.get("n_inner") or 4 * hc["n_embd"],
            max_seq_len=hc.get("n_positions", 2048),
            norm="layer", activation="gelu", position="rope",
            rope_pct=hc.get("rotary_dim", hd) / hd, rope_interleaved=True,
            parallel_residual=True, tie_embeddings=False, use_bias=True,
            norm_eps=hc.get("layer_norm_epsilon", 1e-5))
    elif family == "gpt_neox":
        act = hc.get("hidden_act", "gelu")
        act_map = {"gelu": "gelu_exact", "gelu_new": "gelu",
                   "gelu_fast": "gelu", "gelu_pytorch_tanh": "gelu",
                   "relu": "relu"}
        if act not in act_map:
            raise NotImplementedError(
                f"gpt_neox hidden_act '{act}' not supported")
        cfg = TransformerConfig(
            vocab_size=hc["vocab_size"], d_model=hc["hidden_size"],
            n_layers=hc["num_hidden_layers"],
            n_heads=hc["num_attention_heads"],
            d_ff=hc.get("intermediate_size", 4 * hc["hidden_size"]),
            max_seq_len=hc.get("max_position_embeddings", 2048),
            norm="layer", activation=act_map[act], position="rope",
            rope_pct=hc.get("rotary_pct", 1.0),
            rope_theta=hc.get("rotary_emb_base", 10000.0),
            parallel_residual=hc.get("use_parallel_residual", True),
            tie_embeddings=hc.get("tie_word_embeddings", False),
            use_bias=True, norm_eps=hc.get("layer_norm_eps", 1e-5))
        if not cfg.parallel_residual:
            raise NotImplementedError(
                "gpt_neox with use_parallel_residual=false not supported")
    elif family == "falcon":
        if hc.get("new_decoder_architecture", False):
            raise NotImplementedError(
                "falcon new_decoder_architecture (40B+) not supported yet")
        if hc.get("alibi", False):
            raise NotImplementedError("falcon alibi variant not supported")
        if not hc.get("parallel_attn", True):
            raise NotImplementedError(
                "falcon parallel_attn=false not supported")
        nh = hc["num_attention_heads"]
        cfg = TransformerConfig(
            vocab_size=hc["vocab_size"], d_model=hc["hidden_size"],
            n_layers=hc["num_hidden_layers"], n_heads=nh,
            n_kv_heads=1 if hc.get("multi_query", True) else nh,
            d_ff=4 * hc["hidden_size"],
            max_seq_len=hc.get("max_position_embeddings", 2048),
            norm="layer", activation="gelu", position="rope",
            rope_theta=hc.get("rope_theta", 10000.0),
            parallel_residual=True,
            tie_embeddings=hc.get("tie_word_embeddings", True),
            use_bias=bool(hc.get("bias", False)),
            norm_eps=hc.get("layer_norm_epsilon", 1e-5))
    elif family == "gpt_neo":
        layer_types = []
        for pattern, rep in hc["attention_types"]:
            layer_types += list(pattern) * rep
        if len(layer_types) != hc["num_layers"]:
            raise ValueError(
                f"gpt_neo attention_types expand to {len(layer_types)} "
                f"layers, config has {hc['num_layers']}")
        window = hc.get("window_size", 256)
        cfg = TransformerConfig(
            vocab_size=hc["vocab_size"], d_model=hc["hidden_size"],
            n_layers=hc["num_layers"], n_heads=hc["num_heads"],
            d_ff=hc.get("intermediate_size") or 4 * hc["hidden_size"],
            max_seq_len=hc.get("max_position_embeddings", 2048),
            norm="layer", activation="gelu", position="learned",
            tie_embeddings=True, use_bias=True, qkv_bias=False,
            attn_scale=1.0,  # GPT-Neo attention is unscaled
            attn_windows=tuple(window if t == "local" else 0
                               for t in layer_types),
            use_flash=False,
            norm_eps=hc.get("layer_norm_epsilon", 1e-5))
    elif family == "bert":
        if hc.get("position_embedding_type", "absolute") != "absolute":
            raise NotImplementedError(
                f"bert position_embedding_type="
                f"'{hc['position_embedding_type']}' not supported "
                "(absolute only — relative-key biases would be dropped)")
        act = hc.get("hidden_act", "gelu")
        act_map = {"gelu": "gelu_exact", "gelu_new": "gelu",
                   "gelu_pytorch_tanh": "gelu", "relu": "relu"}
        if act not in act_map:
            raise NotImplementedError(f"bert hidden_act '{act}' not supported")
        cfg = TransformerConfig(
            vocab_size=hc["vocab_size"], d_model=hc["hidden_size"],
            n_layers=hc["num_hidden_layers"],
            n_heads=hc["num_attention_heads"],
            d_ff=hc.get("intermediate_size", 4 * hc["hidden_size"]),
            max_seq_len=hc.get("max_position_embeddings", 512),
            norm="layer", activation=act_map[act], position="learned",
            causal=False, prenorm=False, embed_norm=True,
            type_vocab_size=hc.get("type_vocab_size", 2),
            mlm_head=True, pooler=False,  # from_pretrained reconciles
            tie_embeddings=True, use_bias=True,
            norm_eps=hc.get("layer_norm_eps", 1e-12))
    elif family == "distilbert":
        if hc.get("sinusoidal_pos_embds", False):
            raise NotImplementedError(
                "distilbert sinusoidal_pos_embds=true not supported")
        act = hc.get("activation", "gelu")
        act_map = {"gelu": "gelu_exact", "relu": "relu"}
        if act not in act_map:
            raise NotImplementedError(
                f"distilbert activation '{act}' not supported")
        cfg = TransformerConfig(
            vocab_size=hc["vocab_size"], d_model=hc["dim"],
            n_layers=hc["n_layers"], n_heads=hc["n_heads"],
            d_ff=hc.get("hidden_dim", 4 * hc["dim"]),
            max_seq_len=hc.get("max_position_embeddings", 512),
            norm="layer", activation=act_map[act], position="learned",
            causal=False, prenorm=False, embed_norm=True,
            mlm_head=True, tie_embeddings=True, use_bias=True,
            norm_eps=1e-12)
    elif family == "clip":
        from ..models.clip import CLIPConfig

        act_map = {"quick_gelu": "quick_gelu", "gelu": "gelu_exact"}

        def tower(tc, **kw):
            act = tc.get("hidden_act", "quick_gelu")
            if act not in act_map:
                raise NotImplementedError(
                    f"clip hidden_act '{act}' not supported")
            return TransformerConfig(
                d_model=tc["hidden_size"], n_layers=tc["num_hidden_layers"],
                n_heads=tc["num_attention_heads"],
                d_ff=tc["intermediate_size"], norm="layer",
                activation=act_map[act], tie_embeddings=True, use_bias=True,
                norm_eps=tc.get("layer_norm_eps", 1e-5), **kw)

        tc, vc = hc["text_config"], hc["vision_config"]
        eos = tc.get("eos_token_id", 2)
        cfg = CLIPConfig(
            text=tower(tc, vocab_size=tc["vocab_size"],
                       max_seq_len=tc.get("max_position_embeddings", 77),
                       position="learned", causal=True),
            vision=tower(vc, vocab_size=1, max_seq_len=1, position="none",
                         causal=False, embed_norm=True),
            proj_dim=hc.get("projection_dim", 512),
            image_size=vc.get("image_size", 224),
            patch_size=vc.get("patch_size", 32),
            n_channels=vc.get("num_channels", 3),
            # eos_token_id == 2 is the legacy config: argmax pooling
            eos_token_id=None if eos == 2 else eos)
    else:
        raise ValueError(f"unsupported HF model_type '{family}' "
                         f"(supported: llama, mistral, gpt2, opt, bloom, "
                         f"gptj, gpt_neo, gpt_neox, falcon, mixtral, bert, "
                         f"distilbert, clip, qwen2)")
    return family, cfg


# ----------------------------------------------------------------------
# weight mapping (per family), to the JAX package's stacked tree
def _stack(state: State, fmt: str, n: int, transpose: bool = False
           ) -> torch.Tensor:
    """Stack per-layer tensors into one [n, ...] tensor, POPPING the
    sources so host memory decays as the stacked layout is built."""
    arrs = [state.pop(fmt.format(i)) for i in range(n)]
    if transpose:
        arrs = [a.t() for a in arrs]
    return torch.stack(arrs)


def _map_llama(state, c) -> Dict[str, Any]:
    n = c.n_layers
    pre = "model." if "model.embed_tokens.weight" in state else ""
    L = pre + "layers.{}."
    layers = {
        "attn_norm_w": _stack(state, L + "input_layernorm.weight", n),
        # torch Linear stores [out, in]; the port's layout is [in, out]
        "wq": _stack(state, L + "self_attn.q_proj.weight", n, transpose=True),
        "wk": _stack(state, L + "self_attn.k_proj.weight", n, transpose=True),
        "wv": _stack(state, L + "self_attn.v_proj.weight", n, transpose=True),
        "wo": _stack(state, L + "self_attn.o_proj.weight", n, transpose=True),
        "mlp_norm_w": _stack(state, L + "post_attention_layernorm.weight", n),
        "w_gate": _stack(state, L + "mlp.gate_proj.weight", n, transpose=True),
        "w_up": _stack(state, L + "mlp.up_proj.weight", n, transpose=True),
        "w_down": _stack(state, L + "mlp.down_proj.weight", n, transpose=True),
    }
    if c.qkv_bias:  # Qwen2-style q/k/v-only biases
        layers["bq"] = _stack(state, L + "self_attn.q_proj.bias", n)
        layers["bk"] = _stack(state, L + "self_attn.k_proj.bias", n)
        layers["bv"] = _stack(state, L + "self_attn.v_proj.bias", n)
    if getattr(c, "attn_o_bias", False):  # InternLM: o_proj bias too
        layers["bo"] = _stack(state, L + "self_attn.o_proj.bias", n)
    params = {"tok_embed": state[pre + "embed_tokens.weight"],
              "layers": layers,
              "final_norm_w": state[pre + "norm.weight"]}
    if not c.tie_embeddings:
        params["lm_head"] = (state["lm_head.weight"]
                             if "lm_head.weight" in state
                             else state[pre + "embed_tokens.weight"]).t()
    return params


def _map_gpt2(state, c) -> Dict[str, Any]:
    n, d = c.n_layers, c.d_model
    pre = "transformer." if "transformer.wte.weight" in state else ""
    L = pre + "h.{}."
    # HF Conv1D stores [in, out]; fused c_attn splits [d, 3d] -> q, k, v
    qkv_w = [state.pop((L + "attn.c_attn.weight").format(i)) for i in range(n)]
    qkv_b = [state.pop((L + "attn.c_attn.bias").format(i)) for i in range(n)]
    layers = {
        "attn_norm_w": _stack(state, L + "ln_1.weight", n),
        "attn_norm_b": _stack(state, L + "ln_1.bias", n),
        "wq": torch.stack([w[:, :d] for w in qkv_w]),
        "wk": torch.stack([w[:, d:2 * d] for w in qkv_w]),
        "wv": torch.stack([w[:, 2 * d:] for w in qkv_w]),
        "bq": torch.stack([b[:d] for b in qkv_b]),
        "bk": torch.stack([b[d:2 * d] for b in qkv_b]),
        "bv": torch.stack([b[2 * d:] for b in qkv_b]),
        "wo": _stack(state, L + "attn.c_proj.weight", n),
        "bo": _stack(state, L + "attn.c_proj.bias", n),
        "mlp_norm_w": _stack(state, L + "ln_2.weight", n),
        "mlp_norm_b": _stack(state, L + "ln_2.bias", n),
        "w_up": _stack(state, L + "mlp.c_fc.weight", n),
        "b_up": _stack(state, L + "mlp.c_fc.bias", n),
        "w_down": _stack(state, L + "mlp.c_proj.weight", n),
        "b_down": _stack(state, L + "mlp.c_proj.bias", n),
    }
    return {"tok_embed": state[pre + "wte.weight"],
            "pos_embed": state[pre + "wpe.weight"],
            "layers": layers,
            "final_norm_w": state[pre + "ln_f.weight"],
            "final_norm_b": state[pre + "ln_f.bias"]}


def _map_opt(state, c) -> Dict[str, Any]:
    n = c.n_layers
    pre = "model." if "model.decoder.embed_tokens.weight" in state else ""
    D = pre + "decoder."
    L = D + "layers.{}."
    layers = {
        "attn_norm_w": _stack(state, L + "self_attn_layer_norm.weight", n),
        "attn_norm_b": _stack(state, L + "self_attn_layer_norm.bias", n),
        "wq": _stack(state, L + "self_attn.q_proj.weight", n, transpose=True),
        "wk": _stack(state, L + "self_attn.k_proj.weight", n, transpose=True),
        "wv": _stack(state, L + "self_attn.v_proj.weight", n, transpose=True),
        "bq": _stack(state, L + "self_attn.q_proj.bias", n),
        "bk": _stack(state, L + "self_attn.k_proj.bias", n),
        "bv": _stack(state, L + "self_attn.v_proj.bias", n),
        "wo": _stack(state, L + "self_attn.out_proj.weight", n,
                     transpose=True),
        "bo": _stack(state, L + "self_attn.out_proj.bias", n),
        "mlp_norm_w": _stack(state, L + "final_layer_norm.weight", n),
        "mlp_norm_b": _stack(state, L + "final_layer_norm.bias", n),
        "w_up": _stack(state, L + "fc1.weight", n, transpose=True),
        "b_up": _stack(state, L + "fc1.bias", n),
        "w_down": _stack(state, L + "fc2.weight", n, transpose=True),
        "b_down": _stack(state, L + "fc2.bias", n),
    }
    params = {
        "tok_embed": state[D + "embed_tokens.weight"],
        # OPTLearnedPositionalEmbedding carries a +2 offset: rows 0-1 unused
        "pos_embed": state[D + "embed_positions.weight"][2:],
        "layers": layers,
        "final_norm_w": state[D + "final_layer_norm.weight"],
        "final_norm_b": state[D + "final_layer_norm.bias"],
    }
    if not c.tie_embeddings:
        params["lm_head"] = (state["lm_head.weight"]
                             if "lm_head.weight" in state
                             else state[D + "embed_tokens.weight"]).t()
    return params


def _defuse_qkv(w, n_heads: int, hd: int):
    """Bloom / NeoX fused query_key_value weight [3*d, d] with HEADS-MAJOR
    rows [n_heads, 3, hd, d] -> (wq, wk, wv) in [in, out]."""
    d_in = w.shape[1]
    w4 = w.reshape(n_heads, 3, hd, d_in)
    return tuple(w4[:, j].reshape(n_heads * hd, d_in).t().contiguous()
                 for j in range(3))


def _defuse_qkv_bias(b, n_heads: int, hd: int):
    b3 = b.reshape(n_heads, 3, hd)
    return tuple(b3[:, j].reshape(-1).contiguous() for j in range(3))


def _defused_qkv_stacks(state, fmt: str, n: int, nh: int, hd: int):
    """Pop n layers of fused query_key_value weight + bias: the six
    stacked tensors {wq, wk, wv, bq, bk, bv}."""
    cols = {k: [] for k in ("wq", "wk", "wv", "bq", "bk", "bv")}
    for i in range(n):
        ws = _defuse_qkv(state.pop((fmt + ".weight").format(i)), nh, hd)
        bs = _defuse_qkv_bias(state.pop((fmt + ".bias").format(i)), nh, hd)
        for k, t in zip(("wq", "wk", "wv", "bq", "bk", "bv"), ws + bs):
            cols[k].append(t)
    return {k: torch.stack(v) for k, v in cols.items()}


def _experts(state, fmt: str, n: int, E: int) -> torch.Tensor:
    return torch.stack([torch.stack(
        [state.pop(fmt.format(i, e)).t() for e in range(E)])
        for i in range(n)])


def _map_mixtral(state, c) -> Dict[str, Any]:
    """Mixtral: Llama-style attention + routed expert FFNs."""
    n, E = c.n_layers, c.n_experts
    pre = "model." if "model.embed_tokens.weight" in state else ""
    L = pre + "layers.{}."
    X = L + "block_sparse_moe.experts.{}."
    layers = {
        "attn_norm_w": _stack(state, L + "input_layernorm.weight", n),
        "wq": _stack(state, L + "self_attn.q_proj.weight", n, transpose=True),
        "wk": _stack(state, L + "self_attn.k_proj.weight", n, transpose=True),
        "wv": _stack(state, L + "self_attn.v_proj.weight", n, transpose=True),
        "wo": _stack(state, L + "self_attn.o_proj.weight", n, transpose=True),
        "mlp_norm_w": _stack(state, L + "post_attention_layernorm.weight", n),
        # router: HF [E, d] -> wg [d, E]
        "wg": _stack(state, L + "block_sparse_moe.gate.weight", n,
                     transpose=True),
        # experts: HF w1 (gate) / w3 (up) [f, d], w2 (down) [d, f] ->
        # [n, E, d, f] / [n, E, f, d]
        "w_gate": _experts(state, X + "w1.weight", n, E),
        "w_up": _experts(state, X + "w3.weight", n, E),
        "w_down": _experts(state, X + "w2.weight", n, E),
    }
    params = {"tok_embed": state[pre + "embed_tokens.weight"],
              "layers": layers,
              "final_norm_w": state[pre + "norm.weight"]}
    if not c.tie_embeddings:
        params["lm_head"] = (state["lm_head.weight"]
                             if "lm_head.weight" in state
                             else state[pre + "embed_tokens.weight"]).t()
    return params


def _map_bloom(state, c) -> Dict[str, Any]:
    n, nh, hd = c.n_layers, c.n_heads, c.d_model // c.n_heads
    pre = "transformer." if "transformer.word_embeddings.weight" in state \
        else ""
    L = pre + "h.{}."
    layers = {
        "attn_norm_w": _stack(state, L + "input_layernorm.weight", n),
        "attn_norm_b": _stack(state, L + "input_layernorm.bias", n),
        **_defused_qkv_stacks(state, L + "self_attention.query_key_value",
                              n, nh, hd),
        "wo": _stack(state, L + "self_attention.dense.weight", n,
                     transpose=True),
        "bo": _stack(state, L + "self_attention.dense.bias", n),
        "mlp_norm_w": _stack(state, L + "post_attention_layernorm.weight", n),
        "mlp_norm_b": _stack(state, L + "post_attention_layernorm.bias", n),
        "w_up": _stack(state, L + "mlp.dense_h_to_4h.weight", n,
                       transpose=True),
        "b_up": _stack(state, L + "mlp.dense_h_to_4h.bias", n),
        "w_down": _stack(state, L + "mlp.dense_4h_to_h.weight", n,
                         transpose=True),
        "b_down": _stack(state, L + "mlp.dense_4h_to_h.bias", n),
    }
    return {"tok_embed": state[pre + "word_embeddings.weight"],
            "embed_norm_w": state[pre + "word_embeddings_layernorm.weight"],
            "embed_norm_b": state[pre + "word_embeddings_layernorm.bias"],
            "layers": layers,
            "final_norm_w": state[pre + "ln_f.weight"],
            "final_norm_b": state[pre + "ln_f.bias"]}


def _map_gptj(state, c) -> Dict[str, Any]:
    n = c.n_layers
    pre = "transformer." if "transformer.wte.weight" in state else ""
    L = pre + "h.{}."
    zeros_attn = torch.zeros((n, c.d_model), dtype=torch.float32)
    ln_w = _stack(state, L + "ln_1.weight", n)
    ln_b = _stack(state, L + "ln_1.bias", n)
    layers = {
        # one shared LN feeds both parallel branches: duplicate it
        "attn_norm_w": ln_w, "attn_norm_b": ln_b,
        "mlp_norm_w": ln_w.clone(), "mlp_norm_b": ln_b.clone(),
        "wq": _stack(state, L + "attn.q_proj.weight", n, transpose=True),
        "wk": _stack(state, L + "attn.k_proj.weight", n, transpose=True),
        "wv": _stack(state, L + "attn.v_proj.weight", n, transpose=True),
        "wo": _stack(state, L + "attn.out_proj.weight", n, transpose=True),
        # GPT-J attention has no biases; use_bias expects them: zeros
        "bq": zeros_attn.clone(), "bk": zeros_attn.clone(),
        "bv": zeros_attn.clone(), "bo": zeros_attn.clone(),
        "w_up": _stack(state, L + "mlp.fc_in.weight", n, transpose=True),
        "b_up": _stack(state, L + "mlp.fc_in.bias", n),
        "w_down": _stack(state, L + "mlp.fc_out.weight", n, transpose=True),
        "b_down": _stack(state, L + "mlp.fc_out.bias", n),
    }
    params = {"tok_embed": state[pre + "wte.weight"],
              "layers": layers,
              "final_norm_w": state[pre + "ln_f.weight"],
              "final_norm_b": state[pre + "ln_f.bias"],
              "lm_head": state["lm_head.weight"].t()}
    if "lm_head.bias" in state:
        params["lm_head_b"] = state["lm_head.bias"]
    return params


def _map_gpt_neox(state, c) -> Dict[str, Any]:
    n, nh, hd = c.n_layers, c.n_heads, c.d_model // c.n_heads
    pre = "gpt_neox." if "gpt_neox.embed_in.weight" in state else ""
    L = pre + "layers.{}."
    layers = {
        "attn_norm_w": _stack(state, L + "input_layernorm.weight", n),
        "attn_norm_b": _stack(state, L + "input_layernorm.bias", n),
        "mlp_norm_w": _stack(state, L + "post_attention_layernorm.weight", n),
        "mlp_norm_b": _stack(state, L + "post_attention_layernorm.bias", n),
        **_defused_qkv_stacks(state, L + "attention.query_key_value",
                              n, nh, hd),
        "wo": _stack(state, L + "attention.dense.weight", n, transpose=True),
        "bo": _stack(state, L + "attention.dense.bias", n),
        "w_up": _stack(state, L + "mlp.dense_h_to_4h.weight", n,
                       transpose=True),
        "b_up": _stack(state, L + "mlp.dense_h_to_4h.bias", n),
        "w_down": _stack(state, L + "mlp.dense_4h_to_h.weight", n,
                         transpose=True),
        "b_down": _stack(state, L + "mlp.dense_4h_to_h.bias", n),
    }
    params = {"tok_embed": state[pre + "embed_in.weight"],
              "layers": layers,
              "final_norm_w": state[pre + "final_layer_norm.weight"],
              "final_norm_b": state[pre + "final_layer_norm.bias"]}
    if not c.tie_embeddings:
        params["lm_head"] = state["embed_out.weight"].t()
    return params


def _map_falcon(state, c) -> Dict[str, Any]:
    """Falcon-7B-style (old decoder architecture, multi-query, parallel
    attention): fused qkv rows are [n_heads*hd | hd (k) | hd (v)]."""
    n, nh, hd = c.n_layers, c.n_heads, c.d_model // c.n_heads
    nkv = c.n_kv_heads
    pre = "transformer." if "transformer.word_embeddings.weight" in state \
        else ""
    L = pre + "h.{}."
    qs, ks, vs = [], [], []
    for i in range(n):
        w = state.pop((L + "self_attention.query_key_value.weight").format(i))
        q_rows = nh * hd
        qs.append(w[:q_rows].t().contiguous())
        ks.append(w[q_rows:q_rows + nkv * hd].t().contiguous())
        vs.append(w[q_rows + nkv * hd:].t().contiguous())
    ln_w = _stack(state, L + "input_layernorm.weight", n)
    ln_b = _stack(state, L + "input_layernorm.bias", n)
    layers = {
        "attn_norm_w": ln_w, "attn_norm_b": ln_b,
        "mlp_norm_w": ln_w.clone(), "mlp_norm_b": ln_b.clone(),
        "wq": torch.stack(qs), "wk": torch.stack(ks), "wv": torch.stack(vs),
        "wo": _stack(state, L + "self_attention.dense.weight", n,
                     transpose=True),
        "w_up": _stack(state, L + "mlp.dense_h_to_4h.weight", n,
                       transpose=True),
        "w_down": _stack(state, L + "mlp.dense_4h_to_h.weight", n,
                         transpose=True),
    }
    params = {"tok_embed": state[pre + "word_embeddings.weight"],
              "layers": layers,
              "final_norm_w": state[pre + "ln_f.weight"],
              "final_norm_b": state[pre + "ln_f.bias"]}
    if not c.tie_embeddings:
        params["lm_head"] = (state["lm_head.weight"]
                             if "lm_head.weight" in state
                             else state[pre + "word_embeddings.weight"]).t()
    return params


def _map_gpt_neo(state, c) -> Dict[str, Any]:
    n = c.n_layers
    pre = "transformer." if "transformer.wte.weight" in state else ""
    L = pre + "h.{}."
    A = L + "attn.attention."
    # GPT-Neo uses torch Linear ([out, in]), unlike GPT-2's Conv1D
    layers = {
        "attn_norm_w": _stack(state, L + "ln_1.weight", n),
        "attn_norm_b": _stack(state, L + "ln_1.bias", n),
        "wq": _stack(state, A + "q_proj.weight", n, transpose=True),
        "wk": _stack(state, A + "k_proj.weight", n, transpose=True),
        "wv": _stack(state, A + "v_proj.weight", n, transpose=True),
        "wo": _stack(state, A + "out_proj.weight", n, transpose=True),
        "bo": _stack(state, A + "out_proj.bias", n),
        "mlp_norm_w": _stack(state, L + "ln_2.weight", n),
        "mlp_norm_b": _stack(state, L + "ln_2.bias", n),
        "w_up": _stack(state, L + "mlp.c_fc.weight", n, transpose=True),
        "b_up": _stack(state, L + "mlp.c_fc.bias", n),
        "w_down": _stack(state, L + "mlp.c_proj.weight", n, transpose=True),
        "b_down": _stack(state, L + "mlp.c_proj.bias", n),
    }
    return {"tok_embed": state[pre + "wte.weight"],
            "pos_embed": state[pre + "wpe.weight"],
            "layers": layers,
            "final_norm_w": state[pre + "ln_f.weight"],
            "final_norm_b": state[pre + "ln_f.bias"]}


def _untied(dec, tok_embed) -> bool:
    return dec is not None and (dec.shape != tok_embed.shape
                                or not torch.equal(dec, tok_embed))


def _map_bert(state, c) -> Dict[str, Any]:
    n = c.n_layers
    pre = "bert." if "bert.embeddings.word_embeddings.weight" in state else ""
    L = pre + "encoder.layer.{}."
    layers = {
        # post-LN: attention.output.LayerNorm after the attention residual
        # -> attn_norm; output.LayerNorm after the FFN -> mlp_norm
        "wq": _stack(state, L + "attention.self.query.weight", n,
                     transpose=True),
        "bq": _stack(state, L + "attention.self.query.bias", n),
        "wk": _stack(state, L + "attention.self.key.weight", n,
                     transpose=True),
        "bk": _stack(state, L + "attention.self.key.bias", n),
        "wv": _stack(state, L + "attention.self.value.weight", n,
                     transpose=True),
        "bv": _stack(state, L + "attention.self.value.bias", n),
        "wo": _stack(state, L + "attention.output.dense.weight", n,
                     transpose=True),
        "bo": _stack(state, L + "attention.output.dense.bias", n),
        "attn_norm_w": _stack(state, L + "attention.output.LayerNorm.weight",
                              n),
        "attn_norm_b": _stack(state, L + "attention.output.LayerNorm.bias",
                              n),
        "w_up": _stack(state, L + "intermediate.dense.weight", n,
                       transpose=True),
        "b_up": _stack(state, L + "intermediate.dense.bias", n),
        "w_down": _stack(state, L + "output.dense.weight", n, transpose=True),
        "b_down": _stack(state, L + "output.dense.bias", n),
        "mlp_norm_w": _stack(state, L + "output.LayerNorm.weight", n),
        "mlp_norm_b": _stack(state, L + "output.LayerNorm.bias", n),
    }
    E = pre + "embeddings."
    params = {"tok_embed": state[E + "word_embeddings.weight"],
              "pos_embed": state[E + "position_embeddings.weight"],
              "type_embed": state[E + "token_type_embeddings.weight"],
              "embed_norm_w": state[E + "LayerNorm.weight"],
              "embed_norm_b": state[E + "LayerNorm.bias"],
              "layers": layers}
    # the heads follow the checkpoint class (BertModel: none,
    # ForMaskedLM: the MLM head, ForPreTraining: both);
    # from_pretrained reconciles the config to the mapped tree
    if "cls.predictions.transform.dense.weight" in state:
        T = "cls.predictions.transform."
        params["mlm_dense_w"] = state[T + "dense.weight"].t()
        params["mlm_dense_b"] = state[T + "dense.bias"]
        params["mlm_norm_w"] = state[T + "LayerNorm.weight"]
        params["mlm_norm_b"] = state[T + "LayerNorm.bias"]
        params["mlm_bias"] = state["cls.predictions.bias"]
        # an untied decoder (tie_word_embeddings=false) becomes lm_head
        dec = state.get("cls.predictions.decoder.weight")
        if _untied(dec, params["tok_embed"]):
            params["lm_head"] = dec.t()
    if pre + "pooler.dense.weight" in state:
        params["pooler_w"] = state[pre + "pooler.dense.weight"].t()
        params["pooler_b"] = state[pre + "pooler.dense.bias"]
    return params


def _map_distilbert(state, c) -> Dict[str, Any]:
    n = c.n_layers
    pre = "distilbert." \
        if "distilbert.embeddings.word_embeddings.weight" in state else ""
    L = pre + "transformer.layer.{}."
    layers = {
        "wq": _stack(state, L + "attention.q_lin.weight", n, transpose=True),
        "bq": _stack(state, L + "attention.q_lin.bias", n),
        "wk": _stack(state, L + "attention.k_lin.weight", n, transpose=True),
        "bk": _stack(state, L + "attention.k_lin.bias", n),
        "wv": _stack(state, L + "attention.v_lin.weight", n, transpose=True),
        "bv": _stack(state, L + "attention.v_lin.bias", n),
        "wo": _stack(state, L + "attention.out_lin.weight", n,
                     transpose=True),
        "bo": _stack(state, L + "attention.out_lin.bias", n),
        "attn_norm_w": _stack(state, L + "sa_layer_norm.weight", n),
        "attn_norm_b": _stack(state, L + "sa_layer_norm.bias", n),
        "w_up": _stack(state, L + "ffn.lin1.weight", n, transpose=True),
        "b_up": _stack(state, L + "ffn.lin1.bias", n),
        "w_down": _stack(state, L + "ffn.lin2.weight", n, transpose=True),
        "b_down": _stack(state, L + "ffn.lin2.bias", n),
        "mlp_norm_w": _stack(state, L + "output_layer_norm.weight", n),
        "mlp_norm_b": _stack(state, L + "output_layer_norm.bias", n),
    }
    E = pre + "embeddings."
    params = {"tok_embed": state[E + "word_embeddings.weight"],
              "pos_embed": state[E + "position_embeddings.weight"],
              "embed_norm_w": state[E + "LayerNorm.weight"],
              "embed_norm_b": state[E + "LayerNorm.bias"],
              "layers": layers}
    if "vocab_transform.weight" in state:
        params["mlm_dense_w"] = state["vocab_transform.weight"].t()
        params["mlm_dense_b"] = state["vocab_transform.bias"]
        params["mlm_norm_w"] = state["vocab_layer_norm.weight"]
        params["mlm_norm_b"] = state["vocab_layer_norm.bias"]
        params["mlm_bias"] = state["vocab_projector.bias"]
        proj = state.get("vocab_projector.weight")  # untied fine-tunes only
        if _untied(proj, params["tok_embed"]):
            params["lm_head"] = proj.t()
    return params


def _clip_tower_layers(state, prefix: str, n: int) -> Dict[str, Any]:
    """The pre-LN CLIP encoder layer stack (both towers' key names)."""
    L = prefix + "encoder.layers.{}."
    S = L + "self_attn."
    return {
        "attn_norm_w": _stack(state, L + "layer_norm1.weight", n),
        "attn_norm_b": _stack(state, L + "layer_norm1.bias", n),
        "wq": _stack(state, S + "q_proj.weight", n, transpose=True),
        "bq": _stack(state, S + "q_proj.bias", n),
        "wk": _stack(state, S + "k_proj.weight", n, transpose=True),
        "bk": _stack(state, S + "k_proj.bias", n),
        "wv": _stack(state, S + "v_proj.weight", n, transpose=True),
        "bv": _stack(state, S + "v_proj.bias", n),
        "wo": _stack(state, S + "out_proj.weight", n, transpose=True),
        "bo": _stack(state, S + "out_proj.bias", n),
        "mlp_norm_w": _stack(state, L + "layer_norm2.weight", n),
        "mlp_norm_b": _stack(state, L + "layer_norm2.bias", n),
        "w_up": _stack(state, L + "mlp.fc1.weight", n, transpose=True),
        "b_up": _stack(state, L + "mlp.fc1.bias", n),
        "w_down": _stack(state, L + "mlp.fc2.weight", n, transpose=True),
        "b_down": _stack(state, L + "mlp.fc2.bias", n),
    }


def _map_clip(state, c) -> Dict[str, Any]:
    T, V = "text_model.", "vision_model."
    text = {
        "tok_embed": state[T + "embeddings.token_embedding.weight"],
        "pos_embed": state[T + "embeddings.position_embedding.weight"],
        "layers": _clip_tower_layers(state, T, c.text.n_layers),
        "final_norm_w": state[T + "final_layer_norm.weight"],
        "final_norm_b": state[T + "final_layer_norm.bias"],
    }
    pw = state[V + "embeddings.patch_embedding.weight"]  # [d, 3, p, p]
    d = pw.shape[0]
    vision = {
        # the 1-row token table is unused on the pixel path
        "tok_embed": torch.zeros((1, d), dtype=pw.dtype),
        "patch_w": pw.reshape(d, -1).t(),  # (c, ph, pw)-ordered patches
        "cls_embed": state[V + "embeddings.class_embedding"],
        "pos_embed": state[V + "embeddings.position_embedding.weight"],
        "embed_norm_w": state[V + "pre_layrnorm.weight"],
        "embed_norm_b": state[V + "pre_layrnorm.bias"],
        "layers": _clip_tower_layers(state, V, c.vision.n_layers),
        "final_norm_w": state[V + "post_layernorm.weight"],
        "final_norm_b": state[V + "post_layernorm.bias"],
    }
    return {"text": text, "vision": vision,
            "text_proj": state["text_projection.weight"].t(),
            "vision_proj": state["visual_projection.weight"].t(),
            "logit_scale": state["logit_scale"]}


_MAPPERS: Dict[str, Callable] = {
    "llama": _map_llama, "mistral": _map_llama, "qwen2": _map_llama,
    "internlm": _map_llama,
    "gpt2": _map_gpt2, "opt": _map_opt,
    "bloom": _map_bloom, "gptj": _map_gptj, "gpt_neox": _map_gpt_neox,
    "gpt_neo": _map_gpt_neo,
    "falcon": _map_falcon, "mixtral": _map_mixtral,
    "bert": _map_bert, "distilbert": _map_distilbert,
    "clip": _map_clip,
}


def map_hf_params(state: State, family: str, config) -> Dict[str, Any]:
    """HF state dict -> the JAX package's stacked tree of torch tensors,
    in the source dtype. CONSUMES ``state``: per-layer entries are popped
    as they are stacked. Pass a copy to keep the flat dict."""
    if family not in _MAPPERS:
        raise ValueError(f"unsupported family '{family}'")
    return _MAPPERS[family](state, config)


# ----------------------------------------------------------------------
# into the port's models
_CLIP_TOP = ("text_proj", "vision_proj", "logit_scale")


def _put(dst: torch.Tensor, src: torch.Tensor, name: str) -> None:
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: checkpoint leaf has shape "
                         f"{tuple(src.shape)}, the model expects "
                         f"{tuple(dst.shape)}")
    dst.copy_(src)


@torch.no_grad()
def load_tree(model, tree: Dict[str, Any]):
    """Copy a JAX-layout tree of torch tensors (:func:`map_hf_params`'s)
    into ``model``'s weights in place, cast to the model's dtype on its
    device; a model cut over a model axis takes each leaf's slice. Missing
    or extra leaves and shape mismatches raise. Returns ``model``."""
    from ..models.clip import CLIP
    from ..models.transformer import layer_leaves

    if isinstance(model, CLIP):
        load_tree(model.text, tree["text"])
        load_tree(model.vision, tree["vision"])
        for name in _CLIP_TOP:
            _put(getattr(model, name), tree[name], name)
        return model
    layers = tree["layers"]
    tops = list(model.top_shapes())
    if "lm_head_b" in model._parameters:
        tops.append("lm_head_b")
    leaves = layer_leaves(model.config)
    extra = (set(tree) - set(tops) - {"layers"}) | (set(layers) - set(leaves))
    missing = (set(tops) - set(tree)) | (set(leaves) - set(layers))
    if extra or missing:
        raise ValueError(f"checkpoint does not match the model's flag set: "
                         f"missing {sorted(missing)}, unexpected "
                         f"{sorted(extra)}")
    local = model.local_shard if model._tp_size > 1 else (lambda _, t: t)
    for name in tops:
        _put(getattr(model, name), local(name, tree[name]), name)
    for name in leaves:
        stacked = layers[name]
        if stacked.shape[0] != len(model.layers):
            raise ValueError(f"layers/{name}: {stacked.shape[0]} layers, the "
                             f"model has {len(model.layers)}")
        for i, blk in enumerate(model.layers):
            _put(getattr(blk, name), local(f"layers.{i}.{name}", stacked[i]),
                 f"layers/{name}[{i}]")
    return model


def from_pretrained(model_dir: str, dtype: torch.dtype = torch.bfloat16,
                    topology=None, device=None
                    ) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """Load an HF checkpoint directory: ``(model, params)`` on ``device``
    (default ``"cuda"``) in ``dtype``, ``params`` being the model's
    ``{name: tensor}`` (``named_parameters()``). Under ``topology``'s
    ``model`` axis above 1 the model is cut to this rank's shards
    (``initialize``'s ``_place``) and each leaf is sliced as it is
    copied."""
    from ..models.clip import CLIP
    from ..models.moe import MoETransformer
    from ..models.transformer import Transformer

    family, cfg = hf_config(model_dir)
    state = read_hf_state(model_dir)
    tree = map_hf_params(state, family, cfg)
    del state
    if family in ("bert", "distilbert"):
        # the head surface follows the checkpoint class; align the config
        # to the mapped tree before the model is built
        cfg.mlm_head = "mlm_dense_w" in tree
        cfg.pooler = "pooler_w" in tree
        cfg.tie_embeddings = "lm_head" not in tree
    cls = {"mixtral": MoETransformer, "clip": CLIP}.get(family, Transformer)
    model = cls(cfg, device=device, dtype=dtype)
    if "lm_head_b" in tree:
        model.add_head_bias()
    if topology is not None and topology.model_parallel_size > 1:
        model.shard_(topology)
    elif topology is not None and hasattr(model, "bind_topology"):
        model.bind_topology(topology)
    load_tree(model, tree)
    return model, dict(model.named_parameters())
