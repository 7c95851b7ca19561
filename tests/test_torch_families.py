"""The decoder families of the PyTorch port against the JAX package, on the
CPU, at tiny sizes in fp32.

Every leaf of a JAX parameter tree is perturbed from a numpy seed before
it is carried across (the JAX ``init``'s zero biases and unit norm
weights would hide a missing bias or norm term). Held to the JAX package:

* ``layer_norm`` and ``alibi_slopes`` (8, 12 and 25 heads) within 1e-6;
* the GPT-2 / OPT / GPT-Neo presets, key for key, and ``param_count``
  against the leaves the port makes;
* ``Transformer.apply`` logits within 1e-5, dense and KV-cache (prefill +
  3 decode steps), for GPT-2, OPT, GPT-Neo (alternating windows that
  bind), a GPT-J-style config (parallel residual, partial interleaved
  RoPE, untied), a Bloom-style config (ALiBi at 6 heads, embedding norm,
  tied), the ``gelu_exact`` / ``relu`` / ``quick_gelu`` MLPs,
  ``logits_softcap`` and a uniform window with an ``attn_scale`` override;
* the ragged engine on GPT-2 / OPT: ``put`` logits within 1e-4 across
  SplitFuse steps and identical greedy streams, also with ``max_context
  == max_seq_len`` run to the end of the context; the learned-position
  lookup clamps past the table as JAX's gather does; JAX's three ragged
  refusals (ALiBi, parallel residual, ``attn_scale``) raise the same
  error in the port;
* ``ServingEngine`` streams on GPT-2, tick for tick;
* ``init_inference`` on GPT-2 / OPT: bf16 trees bitwise, int8 trees as
  ``test_torch_inference.py`` holds them (biases and ``pos_embed``
  included), greedy streams identical; a bias whose group crosses layers
  raises;
* ``load_jax_params`` / ``export_params`` round trips for every flag set.

A ``gpu`` case runs GPT-2 XL's paged shape (25 heads of head_dim 64) on
the card and skips here.
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
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.models.llama import llama_config as jax_llama_config
from deepspeed_tpu.models.transformer import (
    Transformer as JaxTransformer, TransformerConfig as JaxConfig)
from deepspeed_tpu.ops.norms import layer_norm as jax_layer_norm
from deepspeed_tpu.ops.rotary import alibi_slopes as jax_alibi_slopes
from deepspeed_tpu.serving import ServingEngine as JaxServingEngine
from deepspeed_tpu_torch.checkpoint.jax_params import (export_params,
                                                       load_jax_params)
from deepspeed_tpu_torch.inference.engine import _is_wq
from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                  RaggedInferenceEngine,
                                                  assert_block_balance)
from deepspeed_tpu_torch.models import gpt2
from deepspeed_tpu_torch.models.llama import llama_config
from deepspeed_tpu_torch.models.transformer import (Transformer,
                                                    TransformerConfig,
                                                    layer_leaves, top_leaves)
from deepspeed_tpu_torch.ops.norms import layer_norm
from deepspeed_tpu_torch.ops.rotary import alibi_slopes
from deepspeed_tpu_torch.serving.request import RequestState
from deepspeed_tpu_torch.serving.server import ServingEngine

SMALL = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4,
             max_seq_len=32, remat=False)
RAW_GPTJ = dict(norm="layer", activation="gelu", position="rope",
                rope_pct=0.25, rope_interleaved=True, parallel_residual=True,
                tie_embeddings=False, use_bias=True, qkv_bias=False,
                attn_o_bias=False, norm_eps=1e-5)
RAW_BLOOM = dict(norm="layer", activation="gelu", position="alibi",
                 embed_norm=True, tie_embeddings=True, use_bias=True,
                 norm_eps=1e-5, d_model=48, n_heads=6)
# name -> (preset family, size, overrides of SMALL)
FLAGSETS = {
    "gpt2": ("gpt2", "tiny", {}),
    "opt": ("opt", "125m", {}),
    "gpt_neo": ("gpt_neo", "tiny", {"attn_windows": (0, 4)}),
    "gptj": ("raw", None, RAW_GPTJ),
    "bloom": ("raw", None, RAW_BLOOM),
    "gelu_exact": ("gpt2", "tiny", {"activation": "gelu_exact"}),
    "relu": ("opt", "125m", {"activation": "relu"}),
    "quick_gelu": ("gpt2", "tiny", {"activation": "quick_gelu"}),
    "softcap": ("llama", "tiny", {"logits_softcap": 3.0, "n_kv_heads": 2}),
    "window_scale": ("llama", "tiny", {"attn_windows": (4, 4),
                                       "attn_scale": 0.3, "n_kv_heads": 2}),
}
PRESETS = {"gpt2": (jax_gpt2.gpt2_config, gpt2.gpt2_config),
           "opt": (jax_gpt2.opt_config, gpt2.opt_config),
           "gpt_neo": (jax_gpt2.gpt_neo_config, gpt2.gpt_neo_config),
           "llama": (jax_llama_config, llama_config),
           "raw": (lambda _, **kw: JaxConfig(**kw),
                   lambda _, **kw: TransformerConfig(**kw))}
TOL = dict(rtol=1e-5, atol=1e-5)


def _configs(name, **extra):
    family, size, over = FLAGSETS[name]
    kw = {**SMALL, **over, **extra}
    jc, tc = PRESETS[family]
    return jc(size, **kw), tc(size, **kw)


def _perturbed(params, seed):
    """The JAX tree with N(0, 0.05^2) added to every leaf, as numpy."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape))
        .astype(np.float32), params)


def _models(name, seed=0, **extra):
    """(JAX model, its perturbed params, numpy tree, the port's carried
    model) of a flag set."""
    jc, tc = _configs(name, **extra)
    jm = JaxTransformer(jc)
    pnp = _perturbed(jm.init(jax.random.PRNGKey(seed)), seed)
    params = jax.tree_util.tree_map(jnp.asarray, pnp)
    tm = load_jax_params(Transformer(tc, device="cpu"), pnp)
    return jm, params, pnp, tm


def _tokens(seed, b, s, vocab=97):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


# -- ops ---------------------------------------------------------------
@pytest.mark.parametrize("width", [64, 1600])
def test_layer_norm_matches_jax(width):
    rng = np.random.default_rng(width)
    x = (rng.standard_normal((3, 5, width)) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(width).astype(np.float32)
    b = rng.standard_normal(width).astype(np.float32)
    got = layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(b), 1e-5)
    ref = jax_layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                         1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    half = layer_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
                      torch.from_numpy(b))
    assert half.dtype == torch.bfloat16


@pytest.mark.parametrize("heads", [8, 12, 25])
def test_alibi_slopes_match_jax(heads):
    got = alibi_slopes(heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jax_alibi_slopes(heads)), rtol=1e-6, atol=1e-6)
    assert got.shape == (heads,) and got.dtype == torch.float32


# -- presets and leaves --------------------------------------------------
@pytest.mark.parametrize("family,size", [
    ("gpt2", s) for s in ("tiny", "small", "medium", "large", "xl")] + [
    ("opt", s) for s in ("125m", "1.3b", "6.7b", "13b", "30b")] + [
    ("gpt_neo", s) for s in ("tiny", "125m", "1.3b", "2.7b")])
def test_presets_match_jax(family, size):
    jc, tc = PRESETS[family]
    assert dataclasses.asdict(tc(size)) == dataclasses.asdict(jc(size))
    assert tc(size).param_count() == jc(size).param_count()
    with pytest.raises(ValueError, match="unknown"):
        tc("nope")


def test_family_constructors_and_preset_shapes():
    c = gpt2.opt_config("6.7b")
    assert (c.n_layers, c.d_model, c.n_heads, c.head_dim, c.d_ff,
            c.vocab_size, c.max_seq_len) == (32, 4096, 32, 128, 16384,
                                             50272, 2048)
    assert round(c.param_count() / 1e9, 2) == 6.66
    x = gpt2.gpt2_config("xl")
    assert (x.n_layers, x.n_heads, x.head_dim, x.vocab_size) == \
        (48, 25, 64, 50257)
    for ctor, size, over in ((gpt2.GPT2, "tiny", {}),
                             (gpt2.OPT, "125m", {}),
                             (gpt2.GPTNeo, "tiny", {"attn_windows": (0, 4)})):
        m = ctor(size, device="cpu", seed=3, **SMALL, **over)
        assert not hasattr(m, "lm_head") and hasattr(m, "pos_embed")
        assert m.pos_embed.std().item() == pytest.approx(0.02, rel=0.2)
        assert torch.all(m.layers[0].attn_norm_b == 0)
        assert not hasattr(m.layers[0], "w_gate")


@pytest.mark.parametrize("name", list(FLAGSETS))
def test_param_count_and_leaves_match_jax(name):
    jc, tc = _configs(name)
    tm = Transformer(tc, device="cpu")
    jp = JaxTransformer(jc).init(jax.random.PRNGKey(0))
    assert sum(p.numel() for p in tm.parameters()) == tc.param_count() \
        == jc.param_count()
    assert set(top_leaves(tc)) | {"layers"} == set(jp)
    assert set(layer_leaves(tc)) == set(jp["layers"])


@pytest.mark.parametrize("name", list(FLAGSETS))
def test_weight_carry_round_trips(name):
    _, _, pnp, tm = _models(name, seed=4)
    back = export_params(tm)
    assert set(back) == set(pnp) and set(back["layers"]) == \
        set(pnp["layers"])
    for k, v in pnp.items():
        if k != "layers":
            np.testing.assert_array_equal(back[k], v)
    for k, v in pnp["layers"].items():
        np.testing.assert_array_equal(back["layers"][k], v)
    again = load_jax_params(Transformer(tm.config, device="cpu"), back)
    for (n, a), (_, b) in zip(tm.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(a, b), n


def test_weight_carry_names_missing_and_extra_leaves():
    _, _, pnp, tm = _models("gpt2")
    no_pos = {k: v for k, v in pnp.items() if k != "pos_embed"}
    with pytest.raises(ValueError, match="pos_embed"):
        load_jax_params(tm, no_pos)
    untied = {**pnp, "lm_head": np.zeros((64, 97), np.float32)}
    with pytest.raises(ValueError, match="lm_head"):
        load_jax_params(tm, untied)
    no_bias = {**pnp, "layers": {k: v for k, v in pnp["layers"].items()
                                 if k != "b_up"}}
    with pytest.raises(ValueError, match="b_up"):
        load_jax_params(tm, no_bias)


# -- the dense and KV-cache forwards --------------------------------------
@pytest.mark.parametrize("name", list(FLAGSETS))
def test_dense_logits_match_jax(name):
    jm, params, _, tm = _models(name, seed=1)
    toks = _tokens(2, 2, 11)
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(toks)))
    with torch.no_grad():
        got = tm.apply(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    assert np.abs(ref).max() > 0.1


@pytest.mark.parametrize("name", list(FLAGSETS))
def test_kv_cache_logits_match_jax(name):
    """Prefill 9 tokens, then 3 decode steps at absolute positions, the
    caches 16 slots long (windows of 4 bind)."""
    jm, params, _, tm = _models(name, seed=2)
    c = tm.config
    b, s, max_len = 2, 9, 16
    shape = (c.n_layers, b, max_len, c.n_kv_heads, c.head_dim)
    jcache = (jnp.zeros(shape), jnp.zeros(shape))
    tcache = (torch.zeros(shape), torch.zeros(shape))
    japply = jax.jit(jm.apply)
    toks = _tokens(3, b, s)
    pos = np.broadcast_to(np.arange(s), (b, s))
    for step in range(4):
        ref, jcache = japply(params, jnp.asarray(toks), jnp.asarray(pos),
                             kv_caches=jcache, cache_pos=int(pos[0, 0]))
        with torch.no_grad():
            got, tcache = tm.apply(torch.from_numpy(toks),
                                   torch.from_numpy(np.array(pos)),
                                   kv_caches=tcache,
                                   cache_pos=int(pos[0, 0]))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
        toks = np.asarray(ref)[:, -1:].argmax(-1)
        pos = np.full((b, 1), s + step)
    np.testing.assert_allclose(tcache[0].numpy(), np.asarray(jcache[0]),
                               **TOL)


def test_learned_positions_clamp_past_the_table_as_jax():
    jm, params, _, tm = _models("opt")
    toks = _tokens(5, 1, 4)
    pos = np.array([[0, 31, 32, 40]])       # max_seq_len 32
    ref = jm._embed(params, jnp.asarray(toks), positions=jnp.asarray(pos))
    got = tm._embed(torch.from_numpy(toks), positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    # positions 32 and 40 read the table's last row, as 31 does
    np.testing.assert_allclose((got[0, 2] - tm.tok_embed[toks[0, 2]]).numpy(),
                               tm.pos_embed[31].numpy(), rtol=1e-6, atol=1e-6)


# -- the ragged engine and the server --------------------------------------
RAGGED = dict(token_budget=32, max_seqs=4, kv_block_size=8, n_kv_blocks=64,
              max_context=32)


def _ragged_pair(name, **kw):
    jm, params, _, tm = _models(name, seed=6)
    cfg = {**RAGGED, **kw}
    je = JaxRaggedEngine(jm, JaxRaggedConfig(dtype=jnp.float32, **cfg),
                         params=params)
    te = RaggedInferenceEngine(tm, RaggedConfig(dtype=torch.float32, **cfg),
                               device="cpu")
    return je, te


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(1, 97, n).tolist()


@pytest.mark.parametrize("name", ["gpt2", "opt"])
def test_ragged_put_and_generate_match_jax(name):
    je, te = _ragged_pair(name, token_budget=16)
    prompts = {1: _prompt(1, 5), 2: _prompt(2, 21), 3: _prompt(3, 9)}
    uids, toks = list(prompts), list(prompts.values())
    ref, got = je.put(uids, toks), te.put(uids, toks)
    for _ in range(3):
        assert np.array_equal(np.isnan(got), np.isnan(ref))
        m = ~np.isnan(ref)
        np.testing.assert_allclose(got[m], ref[m], rtol=1e-4, atol=1e-4)
        feed = [[int(np.nanargmax(r))] if not np.isnan(r).any() else []
                for r in ref]
        ref, got = je.put(uids, feed), te.put(uids, feed)
    assert not np.isnan(got).any()
    je.flush(uids)
    te.flush(uids)
    more = {7: _prompt(7, 12), 8: _prompt(8, 3), 9: _prompt(9, 17)}
    assert te.generate(more, max_new_tokens=9, decode_chunk=4) == \
        je.generate(more, max_new_tokens=9, decode_chunk=4)
    assert_block_balance(te, expect_free=RAGGED["n_kv_blocks"])


@pytest.mark.parametrize("name", ["gpt2", "opt"])
def test_ragged_runs_to_the_end_of_the_table(name):
    """max_context == max_seq_len: generation stops at the last row of
    the position table, with streams equal to JAX's."""
    je, te = _ragged_pair(name)
    prompts = {1: _prompt(11, 20), 2: _prompt(12, 26)}
    ref = je.generate(prompts, max_new_tokens=20, decode_chunk=5)
    assert te.generate(prompts, max_new_tokens=20, decode_chunk=5) == ref
    # the last token comes from position max_context - 1 and is not fed
    assert len(ref[2]) == RAGGED["max_context"] - 26 + 1


@pytest.mark.parametrize("over", [{"position": "alibi"},
                                  {"parallel_residual": True},
                                  {"attn_scale": 1.0}])
def test_ragged_refusals_match_jax(over):
    jc, tc = _configs("gpt2", **over)
    with pytest.raises(NotImplementedError) as jerr:
        JaxRaggedEngine(JaxTransformer(jc), JaxRaggedConfig(**RAGGED),
                        params={})
    with pytest.raises(NotImplementedError) as terr:
        RaggedInferenceEngine(Transformer(tc, device="cpu"),
                              RaggedConfig(**RAGGED), device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_serving_streams_match_jax_server():
    je, te = _ragged_pair("gpt2", enable_prefix_cache=True)
    prompts = [_prompt(s, n) for s, n in ((1, 9), (2, 25), (3, 14),
                                          (4, 3), (5, 18))]
    jsrv = JaxServingEngine(je, {"policy": "fcfs"}, start=False)
    tsrv = ServingEngine(te, {"policy": "fcfs"}, start=False, device="cpu")
    jreqs = [jsrv.submit(p, max_new_tokens=6) for p in prompts]
    treqs = [tsrv.submit(p, max_new_tokens=6) for p in prompts]
    for _ in range(200):
        if all(r.is_terminal for r in treqs):
            break
        assert tsrv.step() and jsrv.step()
        assert [r.state.value for r in treqs] == \
            [r.state.value for r in jreqs]
        assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert all(r.state is RequestState.FINISHED and len(r.tokens) == 6
               for r in treqs)
    assert tsrv.block_leaks() == []


# -- the v1 engine ----------------------------------------------------------
def _v1_config(dtype, quant):
    cfg = {"dtype": dtype, "temperature": 0.0}
    if quant:
        cfg["quant"] = {"enabled": True, "bits": 8, "group_size": 64}
    return cfg


def _jax_leaves(je):
    return {jax.tree_util.keystr(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(je.params,
                                                 is_leaf=jax_is_wq)[0]}


def _bits(t):
    """A tensor's bytes as numpy (bf16 through an int16 view)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jax_bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("name", ["gpt2", "opt"])
@pytest.mark.parametrize("quant", [False, True])
def test_init_inference_trees_match_jax(name, quant):
    """bf16 trees bitwise; int8 payloads equal where the scales are (the
    JAX scales are absmax * fp32(1 / 127) under jit, the port's absmax /
    127 or one ulp off). Every new leaf of the flag set (biases, norm
    biases, pos_embed, the tied tok_embed) is quantized where JAX
    quantizes it."""
    jm, params, _, tm = _models(name, seed=7)
    cfg = _v1_config("bfloat16", quant)
    je = deepspeed_tpu.init_inference((jm, params), config=cfg)
    te = deepspeed_tpu_torch.init_inference(tm, config=cfg, device="cpu")
    jl = _jax_leaves(je)
    n = tm.config.n_layers
    quantized = set()
    for name_, leaf in te.params.items():
        parts = name_.split(".")
        layer = parts[0] == "layers"
        ref = jl[f"['layers']['{parts[2]}']" if layer else f"['{name_}']"]
        assert _is_wq(leaf) == jax_is_wq(ref), name_
        if not _is_wq(leaf):
            want = _jax_bits(ref)
            np.testing.assert_array_equal(
                _bits(leaf), want[int(parts[1])] if layer else want)
            continue
        quantized.add(parts[2] if layer else name_)
        jq = np.asarray(ref["__wq__"]).reshape(-1)
        js = np.asarray(ref["s"])
        if layer:
            jq = np.split(jq, n)[int(parts[1])]
            js = np.split(js, n)[int(parts[1])]
        ts = leaf["s"].numpy()
        assert int(np.abs(js.view(np.int32) - ts.view(np.int32)).max()) <= 1
        same = np.repeat(js == ts, 64)
        np.testing.assert_array_equal(
            leaf["__wq__"].numpy().reshape(-1)[same], jq[same])
    if quant:
        assert {"pos_embed", "tok_embed", "bq", "bo", "b_up", "b_down",
                "attn_norm_b", "mlp_norm_b"} <= quantized
        assert not _is_wq(te.params["final_norm_b"])
    assert te.param_bytes() == je.param_bytes()


@pytest.mark.parametrize("name", ["gpt2", "opt", "gpt_neo", "bloom"])
@pytest.mark.parametrize("quant", [False, True])
def test_init_inference_greedy_streams_match_jax(name, quant):
    jm, params, _, tm = _models(name, seed=8)
    cfg = _v1_config("float32", quant)
    je = deepspeed_tpu.init_inference((jm, params), config=cfg)
    te = deepspeed_tpu_torch.init_inference(tm, config=cfg, device="cpu")
    ids = _tokens(9, 2, 7).astype(np.int32)
    np.testing.assert_array_equal(te.generate(ids, max_new_tokens=6),
                                  np.asarray(je.generate(ids,
                                                         max_new_tokens=6)))


def test_quant_group_across_layers_raises():
    """d_model 96 at group 64: a layer's [96] bias is no whole number of
    groups, while JAX's stacked [2, 96] leaf is, so its groups cross the
    layer boundary (GPT-2 XL's [48, 1600] biases at group 256)."""
    tm = gpt2.GPT2("tiny", device="cpu", **{**SMALL, "d_model": 96})
    with pytest.raises(ValueError, match="cross layer"):
        deepspeed_tpu_torch.init_inference(
            tm, config=_v1_config("float32", True), device="cpu")


# -- on the card ------------------------------------------------------------
@pytest.mark.gpu
def test_cuda_gpt2_xl_paged_shape_matches_plain_and_repeats():
    """25 query / KV heads of head_dim 64, page 16: a prefill chunk on
    tile items and decode lanes on lane items, against the plain
    version, twice bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from deepspeed_tpu_torch.ops import paged_attention as pa

    gen = torch.Generator().manual_seed(0)
    contexts, block, hd, h = [40, 300, 700], 16, 64, 25
    pages = [-(-c // block) for c in contexts]
    tables = torch.zeros((3, 64), dtype=torch.int32)
    perm = torch.randperm(sum(pages) + 4, generator=gen)
    at = 0
    for i, n in enumerate(pages):
        tables[i, :n] = perm[at:at + n].to(torch.int32)
        at += n
    slots = [0, 1, 2] + [2] * 48
    pos = [c - 1 for c in contexts] + list(range(700 - 48, 700))
    q = torch.randn((len(slots), h, hd), generator=gen).bfloat16().cuda()
    kp = torch.randn((sum(pages) + 4, h, block, hd), generator=gen) \
        .bfloat16().cuda()
    vp = torch.randn_like(kp.float()).bfloat16()
    tab = tables.cuda()
    kw = dict(seq_slots=torch.tensor(slots, dtype=torch.int32).cuda(),
              live_pages=64)
    positions = torch.tensor(pos, dtype=torch.int32).cuda()
    tiles, lanes = (pa.paged_attention.tile_launches,
                    pa.paged_attention.split_launches)
    got = pa.paged_attention(q, kp, vp, tab, positions, **kw)
    again = pa.paged_attention(q, kp, vp, tab, positions, **kw)
    torch.cuda.synchronize()
    assert pa.paged_attention.tile_launches == tiles + 2
    assert pa.paged_attention.split_launches == lanes + 2
    ref = pa.paged_attention_reference(q, kp, vp, tab, positions, **kw)
    err = (got.float() - ref.float()).abs()
    assert bool((err <= 4e-3 + 1e-2 * ref.float().abs()).all()), err.max()
    assert torch.equal(got, again)
