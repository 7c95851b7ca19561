"""The encoder families of the PyTorch port against the JAX package, on the
CPU, at tiny sizes in fp32.

Every leaf of a JAX parameter tree is perturbed from a numpy seed before
it is carried across (the JAX ``init``'s zero biases and unit norm
weights would hide a missing bias or norm term). Held to the JAX package:

* the BERT / DistilBERT / CLIP presets, key for key, ``param_count``
  and the leaf names;
* ``Transformer.apply`` logits within 1e-5 for BERT-tiny and
  DistilBERT-tiny, with and without ``token_type_ids`` and a padding
  ``attn_mask``, the hidden states (``return_hidden``) and ``pooled``;
  a mask on a causal model and KV-cache decode on an encoder raise as in
  JAX;
* ``loss`` with ``labels`` / ``loss_mask`` / ``attention_mask`` /
  ``token_type_ids`` within 1e-5, and the refusal of a batch without
  labels;
* CLIP-tiny ``encode_text`` (argmax and ``eos_token_id`` pooling),
  ``encode_image``, ``similarity`` and ``loss`` within 1e-5;
* ``init_inference`` on BERT-tiny: the bf16 tree bitwise, int8 / int4
  trees (payloads equal where the scales are, scales within one ulp),
  ``forward`` logits equal to JAX's with keyword arguments dropped as
  JAX drops them, ``generate`` raising as JAX's does;
* ``load_jax_params`` / ``export_params`` round trips for BERT,
  DistilBERT and CLIP, and their missing / extra / misshapen leaves;
* the ragged engine's refusals of ``causal=False`` and ``prenorm=False``
  (C7 in ROADMAP.md: the JAX engine takes both and computes them
  causally and pre-normed).

A ``gpu`` case runs row 2 non-causal at CLIP's 257 tokens on the card
and skips here.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference.engine import _is_wq as jax_is_wq
from deepspeed_tpu.inference.ragged import (
    RaggedConfig as JaxRaggedConfig,
    RaggedInferenceEngine as JaxRaggedEngine)
from deepspeed_tpu.models import bert as jax_bert
from deepspeed_tpu.models import clip as jax_clip
from deepspeed_tpu.models.transformer import Transformer as JaxTransformer
from deepspeed_tpu_torch.checkpoint.jax_params import (export_params,
                                                       load_jax_params)
from deepspeed_tpu_torch.inference.engine import _is_wq
from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                  RaggedInferenceEngine)
from deepspeed_tpu_torch.models import bert, clip
from deepspeed_tpu_torch.models.gpt2 import gpt2_config
from deepspeed_tpu_torch.models.transformer import (Transformer,
                                                    layer_leaves, top_leaves)

SMALL = dict(vocab_size=97, max_seq_len=32, remat=False)
PRESETS = {"bert": (jax_bert.bert_config, bert.bert_config),
           "distilbert": (jax_bert.distilbert_config,
                          bert.distilbert_config)}
TOL = dict(rtol=1e-5, atol=1e-5)
TEXT = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, d_ff=128,
            max_seq_len=16, remat=False)
VISION = dict(d_model=64, n_layers=2, n_heads=4, d_ff=128, remat=False)
PIXELS = dict(proj_dim=32, image_size=32, patch_size=8)


def _perturbed(params, seed):
    """The JAX tree with N(0, 0.05^2) added to every leaf, as numpy."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a)))
        .astype(np.float32), params)


def _models(family, seed=0, **extra):
    """(JAX model, its perturbed params, numpy tree, the port's carried
    model) of a BERT-family tiny config."""
    jc, tc = PRESETS[family]
    kw = {**SMALL, **extra}
    jm = JaxTransformer(jc("tiny", **kw))
    pnp = _perturbed(jm.init(jax.random.PRNGKey(seed)), seed)
    params = jax.tree_util.tree_map(jnp.asarray, pnp)
    tm = load_jax_params(Transformer(tc("tiny", **kw), device="cpu"), pnp)
    return jm, params, pnp, tm


def _clip_configs(eos=None):
    jcfg = jax_clip.CLIPConfig(jax_clip.clip_text_config(**TEXT),
                               jax_clip.clip_vision_config(**VISION),
                               eos_token_id=eos, **PIXELS)
    tcfg = clip.CLIPConfig(clip.clip_text_config(**TEXT),
                           clip.clip_vision_config(**VISION),
                           eos_token_id=eos, **PIXELS)
    return jcfg, tcfg


def _clip_models(seed=0, eos=None):
    jcfg, tcfg = _clip_configs(eos)
    jm = jax_clip.CLIP(jcfg)
    pnp = _perturbed(jm.init(jax.random.PRNGKey(seed)), seed)
    params = jax.tree_util.tree_map(jnp.asarray, pnp)
    tm = load_jax_params(clip.CLIP(tcfg, device="cpu"), pnp)
    return jm, params, pnp, tm


def _batch(seed, b=3, s=11, vocab=97):
    """tokens, two-segment token types and a padding mask (row 0 full,
    the others padded after 7 and 4 tokens), as numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s))
    lens = [s, 7, 4][:b]
    mask = (np.arange(s)[None, :] < np.array(lens)[:, None]).astype(np.int32)
    types = (np.arange(s)[None, :] >= np.array(lens)[:, None] // 2) \
        .astype(np.int32) * mask
    return toks, types, mask


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- presets and leaves ------------------------------------------------------
@pytest.mark.parametrize("family,size", [
    ("bert", s) for s in ("tiny", "mini", "base", "large")] + [
    ("distilbert", s) for s in ("tiny", "base")])
def test_presets_match_jax(family, size):
    jc, tc = PRESETS[family]
    assert dataclasses.asdict(tc(size)) == dataclasses.asdict(jc(size))
    assert tc(size).param_count() == jc(size).param_count()
    with pytest.raises(ValueError, match="unknown"):
        tc("nope")


def test_clip_presets_match_jax():
    for jf, tf in ((jax_clip.clip_text_config, clip.clip_text_config),
                   (jax_clip.clip_vision_config, clip.clip_vision_config)):
        assert dataclasses.asdict(tf()) == dataclasses.asdict(jf())
        assert dataclasses.asdict(tf(d_model=1024, n_heads=16)) == \
            dataclasses.asdict(jf(d_model=1024, n_heads=16))
    jcfg, tcfg = _clip_configs(eos=5)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


def test_bert_large_shape():
    c = bert.bert_config("large")
    assert (c.n_layers, c.d_model, c.n_heads, c.head_dim, c.d_ff,
            c.vocab_size, c.max_seq_len, c.causal, c.prenorm) == \
        (24, 1024, 16, 64, 4096, 30522, 512, False, False)
    # 3.35e8 in the encoder and pooler, 1.08e6 more in the MLM transform
    assert c.param_count() == 336_224_058


@pytest.mark.parametrize("family", list(PRESETS))
def test_param_count_and_leaves_match_jax(family):
    jc, tc = PRESETS[family]
    tm = Transformer(tc("tiny", **SMALL), device="cpu")
    jp = JaxTransformer(jc("tiny", **SMALL)).init(jax.random.PRNGKey(0))
    assert sum(p.numel() for p in tm.parameters()) == \
        tm.config.param_count() == jc("tiny", **SMALL).param_count()
    assert list(top_leaves(tm.config)) == [k for k in jp if k != "layers"]
    assert set(layer_leaves(tm.config)) == set(jp["layers"])
    assert "final_norm_w" not in jp    # post-LN: no final norm


def test_clip_leaves_match_jax():
    jcfg, tcfg = _clip_configs()
    jp = jax_clip.CLIP(jcfg).init(jax.random.PRNGKey(0))
    tm = clip.CLIP(tcfg, device="cpu", seed=3)
    back = export_params(tm)
    assert set(back) == set(jp)
    for tower in ("text", "vision"):
        assert set(back[tower]) == set(jp[tower])
        assert set(back[tower]["layers"]) == set(jp[tower]["layers"])
        for k, v in jp[tower].items():
            if k != "layers":
                assert back[tower][k].shape == v.shape, (tower, k)
    assert back["logit_scale"].shape == () and \
        back["logit_scale"] == pytest.approx(np.log(1 / 0.07), rel=1e-6)
    v = tm.vision
    assert v.pos_embed.std().item() == pytest.approx(0.02, rel=0.2)
    assert v.patch_w.std().item() == pytest.approx(192 ** -0.5, rel=0.2)
    assert torch.all(v.embed_norm_w == 1) and torch.all(v.layers[0].bq == 0)


# -- the forward --------------------------------------------------------------
@pytest.mark.parametrize("family", list(PRESETS))
@pytest.mark.parametrize("inputs", ["plain", "types", "mask", "both"])
def test_apply_matches_jax(family, inputs):
    jm, params, _, tm = _models(family, seed=1)
    toks, types, mask = _batch(2)
    if family == "distilbert" and inputs in ("types", "both"):
        types = None        # no type_embed: the ids are ignored in both
    kw = {}
    if inputs in ("types", "both") and types is not None:
        kw["token_type_ids"] = types
    if inputs in ("mask", "both"):
        kw["attn_mask"] = mask
    ref = np.asarray(jm.apply(params, jnp.asarray(toks),
                              **{k: jnp.asarray(v) for k, v in kw.items()}))
    tkw = {k: _t(v) for k, v in kw.items()}
    with torch.no_grad():
        got = tm.apply(_t(toks), **tkw).numpy()
        hidden = tm.apply(_t(toks), return_hidden=True, **tkw)
    np.testing.assert_allclose(got, ref, **TOL)
    assert np.abs(ref).max() > 0.1
    jh = jm.apply(params, jnp.asarray(toks), return_hidden=True,
                  **{k: jnp.asarray(v) for k, v in kw.items()})
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jh), **TOL)
    if family == "bert":
        with torch.no_grad():
            pooled = tm.pooled(hidden).numpy()
        np.testing.assert_allclose(pooled, np.asarray(jm.pooled(params, jh)),
                                   **TOL)
    else:
        with pytest.raises(ValueError, match="pooler=False"):
            tm.pooled(hidden)


def test_padding_mask_hides_the_padded_keys():
    """A padded row's real positions equal the same row run alone."""
    _, _, _, tm = _models("bert", seed=5)
    toks, types, mask = _batch(6)
    with torch.no_grad():
        padded = tm.apply(_t(toks), return_hidden=True,
                          token_type_ids=_t(types), attn_mask=_t(mask))
        alone = tm.apply(_t(toks[1:2, :7]), return_hidden=True,
                         token_type_ids=_t(types[1:2, :7]))
    np.testing.assert_allclose(padded[1:2, :7].numpy(), alone.numpy(), **TOL)


def test_encoder_refusals_match_jax():
    jm, params, _, tm = _models("bert")
    toks = np.zeros((1, 4), np.int64)
    shape = (2, 1, 8, 2, 64)
    with pytest.raises(ValueError, match="requires a causal model") as jerr:
        jm.apply(params, jnp.asarray(toks),
                 kv_caches=(jnp.zeros(shape), jnp.zeros(shape)), cache_pos=0)
    with pytest.raises(ValueError, match="requires a causal model") as terr:
        tm.apply(_t(toks), kv_caches=(torch.zeros(shape),
                                      torch.zeros(shape)), cache_pos=0)
    assert str(terr.value) == str(jerr.value)
    dec = Transformer(gpt2_config("tiny", n_layers=2, d_model=64, n_heads=4,
                                  **SMALL), device="cpu")
    with pytest.raises(NotImplementedError, match="causal model is not"):
        dec.apply(_t(toks), attn_mask=torch.ones((1, 4)))


# -- the loss -----------------------------------------------------------------
@pytest.mark.parametrize("family", list(PRESETS))
def test_loss_matches_jax(family):
    jm, params, _, tm = _models(family, seed=3)
    toks, types, mask = _batch(4)
    rng = np.random.default_rng(9)
    labels = rng.integers(0, 97, toks.shape)
    loss_mask = (rng.random(toks.shape) < 0.3).astype(np.float32) * mask
    batches = [{"input_ids": toks, "labels": labels},
               {"input_ids": toks, "labels": labels, "loss_mask": loss_mask,
                "attention_mask": mask, "token_type_ids": types}]
    for batch in batches:
        ref = float(jm.loss(params, {k: jnp.asarray(v)
                                     for k, v in batch.items()}))
        with torch.no_grad():
            got = float(tm.loss({k: _t(v) for k, v in batch.items()}))
        assert got == pytest.approx(ref, rel=1e-5, abs=1e-5)
    with pytest.raises(ValueError, match="explicit 'labels'") as jerr:
        jm.loss(params, {"input_ids": jnp.asarray(toks)})
    with pytest.raises(ValueError, match="explicit 'labels'") as terr:
        tm.loss({"input_ids": _t(toks)})
    assert str(terr.value) == str(jerr.value)


# -- CLIP ---------------------------------------------------------------------
def _clip_inputs(seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, 90, (3, 16))
    toks[0, 9] = 96         # the highest id: argmax pooling's EOS
    toks[1, 15] = 96
    toks[2, 4] = 96
    toks[:, 12] = 7         # eos_token_id 7 pools at 12, or earlier
    toks[1, 3] = 7
    pixels = rng.standard_normal((3, 3, 32, 32)).astype(np.float32)
    return toks, pixels


@pytest.mark.parametrize("eos", [None, 7])
def test_clip_matches_jax(eos):
    jm, params, _, tm = _clip_models(seed=2, eos=eos)
    toks, pixels = _clip_inputs(3)
    jt, jp = jnp.asarray(toks), jnp.asarray(pixels)
    with torch.no_grad():
        et = tm.encode_text(_t(toks))
        ei = tm.encode_image(_t(pixels))
        lpt, lpi = tm.similarity(_t(toks), _t(pixels))
        loss = tm.loss({"input_ids": _t(toks), "pixel_values": _t(pixels)})
    np.testing.assert_allclose(et.numpy(), np.asarray(
        jm.encode_text(params, jt)), **TOL)
    np.testing.assert_allclose(ei.numpy(), np.asarray(
        jm.encode_image(params, jp)), **TOL)
    jlpt, jlpi = jm.similarity(params, jt, jp)
    np.testing.assert_allclose(lpt.numpy(), np.asarray(jlpt), **TOL)
    np.testing.assert_allclose(lpi.numpy(), np.asarray(jlpi), **TOL)
    ref = float(jm.loss(params, {"input_ids": jt, "pixel_values": jp}))
    assert float(loss) == pytest.approx(ref, rel=1e-5, abs=1e-5)
    h, pooled = tm.vision.apply_pixels(_t(pixels))
    assert h.shape == (3, 17, 64) and pooled.shape == (3, 64)
    with pytest.raises(ValueError, match="expected"):
        tm.encode_image(_t(pixels[:, :, :16, :16]))


def test_clip_eos_pooling_picks_the_first_eos():
    """eos_token_id pooling reads the first EOS (row 1: position 3),
    argmax pooling the first highest id."""
    _, _, _, tm = _clip_models(seed=4, eos=7)
    toks, _ = _clip_inputs(3)
    with torch.no_grad():
        h = tm.text.apply(_t(toks), return_hidden=True)
        h = torch.nn.functional.layer_norm(
            h, (64,), tm.text.final_norm_w, tm.text.final_norm_b, 1e-5)
        got = tm.encode_text(_t(toks))
    np.testing.assert_allclose(got[1].numpy(),
                               (h[1, 3] @ tm.text_proj).numpy(), **TOL)


# -- init_inference -----------------------------------------------------------
def _jax_leaves(je):
    return {jax.tree_util.keystr(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(je.params,
                                                 is_leaf=jax_is_wq)[0]}


def _bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jax_bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("quant", [None, 8, 4])
def test_init_inference_trees_match_jax(quant):
    """bf16 trees bitwise; quantized payloads equal where the scales are
    (the JAX scales are absmax * fp32(1 / qmax) under jit, the port's
    absmax / qmax or one ulp off). The encoder leaves ``type_embed``,
    ``mlm_dense_w`` and ``pooler_w`` are quantized, the 1-D top-level
    ones (``mlm_bias``, ``mlm_dense_b``, the norms) are not."""
    jm, params, _, tm = _models("bert", seed=7)
    cfg = {"dtype": "bfloat16", "temperature": 0.0}
    if quant:
        cfg["quant"] = {"enabled": True, "bits": quant, "group_size": 64}
    je = deepspeed_tpu.init_inference((jm, params), config=cfg)
    te = deepspeed_tpu_torch.init_inference(tm, config=cfg, device="cpu")
    jl = _jax_leaves(je)
    n = tm.config.n_layers
    per = 32 if quant == 4 else 64      # payload bytes a block
    quantized = set()
    for name, leaf in te.params.items():
        parts = name.split(".")
        layer = parts[0] == "layers"
        ref = jl[f"['layers']['{parts[2]}']" if layer else f"['{name}']"]
        assert _is_wq(leaf) == jax_is_wq(ref), name
        if not _is_wq(leaf):
            want = _jax_bits(ref)
            np.testing.assert_array_equal(
                _bits(leaf), want[int(parts[1])] if layer else want)
            continue
        quantized.add(parts[2] if layer else name)
        jq = np.asarray(ref["__wq__"]).reshape(-1)
        js = np.asarray(ref["s"])
        if layer:
            jq = np.split(jq, n)[int(parts[1])]
            js = np.split(js, n)[int(parts[1])]
        ts = leaf["s"].numpy()
        assert int(np.abs(js.view(np.int32) - ts.view(np.int32)).max()) <= 1
        same = np.repeat(js == ts, per)
        np.testing.assert_array_equal(
            leaf["__wq__"].numpy().reshape(-1)[same], jq[same])
    if quant:
        assert {"type_embed", "mlm_dense_w", "pooler_w", "pos_embed",
                "tok_embed", "attn_norm_b", "b_up"} <= quantized
        assert not {"mlm_bias", "mlm_dense_b", "mlm_norm_w",
                    "embed_norm_w"} & quantized
    assert te.param_bytes() == je.param_bytes()


@pytest.mark.parametrize("quant", [None, 8])
def test_init_inference_forward_matches_jax(quant):
    """MLM logits of ``forward`` equal JAX's. A keyword argument (a
    padding mask, segment ids) is dropped silently by JAX's ``forward``,
    which changes nothing there, and refused by the port's (ROADMAP.md
    Queue C, C8). ``generate`` raises in both: KV-cache decode needs a
    causal model."""
    jm, params, _, tm = _models("bert", seed=8)
    cfg = {"dtype": "float32", "temperature": 0.0}
    if quant:
        cfg["quant"] = {"enabled": True, "bits": quant, "group_size": 64}
    je = deepspeed_tpu.init_inference((jm, params), config=cfg)
    te = deepspeed_tpu_torch.init_inference(tm, config=cfg, device="cpu")
    toks, _, mask = _batch(11)
    ref = np.asarray(je.forward(toks))
    got = te.forward(toks).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    with pytest.raises(NotImplementedError, match="C8"):
        te.forward(toks, attn_mask=_t(mask))
    with pytest.raises(NotImplementedError, match="token_type_ids"):
        te.forward(toks, token_type_ids=_t(np.ones_like(toks)))
    np.testing.assert_array_equal(te.forward(toks, attn_mask=None).numpy(),
                                  got)
    np.testing.assert_array_equal(
        np.asarray(je.forward(toks, attn_mask=jnp.asarray(mask))), ref)
    with pytest.raises(ValueError, match="requires a causal model") as jerr:
        je.generate(toks.astype(np.int32), max_new_tokens=2)
    with pytest.raises(ValueError, match="requires a causal model") as terr:
        te.generate(toks, max_new_tokens=2)
    assert str(terr.value) == str(jerr.value)


# -- the weight carry ---------------------------------------------------------
def _assert_trees_equal(a, b):
    assert set(a) == set(b)
    for k, v in a.items():
        if isinstance(v, dict):
            _assert_trees_equal(v, b[k])
        else:
            np.testing.assert_array_equal(np.asarray(b[k]), v)


@pytest.mark.parametrize("family", ["bert", "distilbert", "clip"])
def test_weight_carry_round_trips(family):
    if family == "clip":
        _, _, pnp, tm = _clip_models(seed=4)
        fresh = clip.CLIP(tm.config, device="cpu")
    else:
        _, _, pnp, tm = _models(family, seed=4)
        fresh = Transformer(tm.config, device="cpu")
    back = export_params(tm)
    _assert_trees_equal(pnp, back)
    again = load_jax_params(fresh, back)
    for (n, a), (_, b) in zip(tm.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(a, b), n


def test_weight_carry_names_missing_extra_and_misshapen_leaves():
    _, _, pnp, tm = _models("bert")
    for drop in ("type_embed", "mlm_bias", "pooler_w"):
        with pytest.raises(ValueError, match=drop):
            load_jax_params(tm, {k: v for k, v in pnp.items() if k != drop})
    with pytest.raises(ValueError, match="final_norm_w"):
        load_jax_params(tm, {**pnp, "final_norm_w": np.ones(128, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(tm, {**pnp, "type_embed": np.zeros((3, 128),
                                                           np.float32)})
    _, _, cnp, cm = _clip_models()
    with pytest.raises(ValueError, match="vision_proj"):
        load_jax_params(cm, {k: v for k, v in cnp.items()
                             if k != "vision_proj"})
    with pytest.raises(ValueError, match="cls_embed"):
        load_jax_params(cm, {**cnp, "vision": {
            k: v for k, v in cnp["vision"].items() if k != "cls_embed"}})
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(cm, {**cnp, "vision": {
            **cnp["vision"], "patch_w": np.zeros((64, 64), np.float32)}})


# -- the ragged engine (C7) ---------------------------------------------------
RAGGED = dict(token_budget=32, max_seqs=4, kv_block_size=8, n_kv_blocks=64,
              max_context=32)


@pytest.mark.parametrize("flag", [dict(causal=False), dict(prenorm=False)])
def test_ragged_engine_refuses_encoders(flag):
    """The JAX engine takes an encoder config and serves it causally and
    pre-normed (C7); the port's refuses it, and a ServingEngine built on
    it with it."""
    cfg = dict(n_layers=2, d_model=64, n_heads=4, **SMALL, **flag)
    from deepspeed_tpu.models.gpt2 import gpt2_config as jax_gpt2_config

    JaxRaggedEngine(JaxTransformer(jax_gpt2_config("tiny", **cfg)),
                    JaxRaggedConfig(**RAGGED))
    with pytest.raises(NotImplementedError, match="C7"):
        RaggedInferenceEngine(Transformer(gpt2_config("tiny", **cfg),
                                          device="cpu"),
                              RaggedConfig(**RAGGED), device="cpu")


# -- on the card --------------------------------------------------------------
@pytest.mark.gpu
def test_cuda_non_causal_flash_at_clip_vision_length():
    """Row 2 non-causal at 257 tokens (1 + 16^2 patches: a ragged last
    key tile) and 16 heads of 64 in bf16, on the Hopper forward, against
    the plain version, twice bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from deepspeed_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 257, 16, 64), generator=gen).bfloat16()
               .cuda() for _ in range(3))
    before = fa.flash_forward.wgmma_launches
    out, lse = fa.flash_forward(q, k, v, causal=False)
    again, _ = fa.flash_forward(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert fa.flash_forward.wgmma_launches == before + 2
    ref, ref_lse = fa.flash_attention_forward_reference(q, k, v,
                                                        causal=False)
    err = (out.float() - ref.float()).abs()
    assert bool((err <= 4e-3 + 1e-2 * ref.float().abs()).all()), err.max()
    assert bool(((lse - ref_lse).abs() <= 1e-4 + 1e-5 * ref_lse.abs())
                .all())
    assert torch.equal(out, again)
