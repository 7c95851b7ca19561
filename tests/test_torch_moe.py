"""Mixture-of-Experts in the PyTorch port against the JAX package, on the
CPU, at tiny sizes in fp32.

Every leaf of a JAX parameter tree is perturbed from a numpy seed before
it is carried across (the JAX ``init``'s zero expert biases and unit norm
weights would hide a dropped term). Held to the JAX package:

* ``capacity`` over a grid of group sizes, factors, experts and k;
* ``top_k_gating``'s combine weights, dispatch mask and aux loss, top-1
  and top-2, with and without drops, within 1e-6;
* ``no_drop_moe`` within 1e-5 for the tanh-GELU bank with biases and the
  gated-SiLU bank, with experts no token picks; the grouped GEMM's two
  routes (``torch._grouped_mm`` and the per-group loop) against each
  other, empty groups included;
* ``MoELayer.apply``, eval and train (no noise) within 1e-5; a noisy
  gate (``RSample``, ``Jitter``) repeats under one generator seed;
* the presets and ``param_count`` / ``active_param_count`` /
  ``flops_per_token`` of ``tiny`` / ``350m`` / ``1.3b`` at 8 / 64 / 128
  experts; the leaf set and the weight carry, round trip bitwise;
* ``apply`` and KV-cache logits within 1e-5, ``loss`` with the aux loss
  (the capacity route) within 1e-5;
* the ragged engine's greedy streams equal to JAX's ragged engine on the
  JAX suite's two MoE models (plain and windowed), a top-2 and a
  gated-SiLU MoE;
* ``init_inference``: bf16 and int8 trees (expert banks and ``wg``
  quantized where JAX quantizes them), greedy streams identical in fp32,
  int8 and int4;
* under a model axis of 2 and 4 in bf16, the no-drop route's ``w_down``
  partials reach the group's sum in fp32 and are rounded once (one
  device's output up to an ulp in under 1e-3 of the elements);
* the refusals: the capacity route over the model axis, the expert
  axis, a gate whose quantization groups cross layers.

A ``gpu`` case holds the grouped route against the loop on the card.
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
from deepspeed_tpu.models import moe as jax_moe_models
from deepspeed_tpu.parallel import moe as jax_moe
from deepspeed_tpu_torch.checkpoint.jax_params import (export_params,
                                                       load_jax_params,
                                                       shard_params)
from deepspeed_tpu_torch.inference.engine import _is_wq
from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                  RaggedInferenceEngine,
                                                  assert_block_balance)
from deepspeed_tpu_torch.models import moe as moe_models
from deepspeed_tpu_torch.config import ConfigError
from deepspeed_tpu_torch.models.transformer import layer_leaves, top_leaves
from deepspeed_tpu_torch.parallel import moe
from deepspeed_tpu_torch.parallel.mesh import Topology

TOL = dict(rtol=1e-5, atol=1e-5)
SMALL = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4,
             max_seq_len=32, remat=False, use_flash=False)
# name -> overrides of SMALL on gpt_moe_config("tiny", 4)
FLAGSETS = {
    "gelu": {},
    "gelu_bias": {"use_bias": True},
    "top1": {"top_k": 1},
    "silu_glu": {"norm": "rms", "activation": "silu_glu",
                 "position": "rope", "tie_embeddings": False},
}
# the JAX suite's ragged MoE models (tests/test_ragged_inference.py)
JAX_SUITE = dict(n_experts=4, top_k=1, n_layers=2, d_model=32, n_heads=4,
                 n_kv_heads=4, vocab_size=64, max_seq_len=64,
                 use_flash=False, remat=False)


def _configs(name, **extra):
    kw = {**SMALL, **FLAGSETS.get(name, {}), **extra}
    n = kw.pop("n_experts", 4)
    return (jax_moe_models.gpt_moe_config("tiny", n, **kw),
            moe_models.gpt_moe_config("tiny", n, **kw))


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape))
        .astype(np.float32), params)


def _models(name, seed=0, **extra):
    """(JAX model, its perturbed params, numpy tree, the port's carried
    model)."""
    jc, tc = _configs(name, **extra)
    jm = jax_moe_models.MoETransformer(jc)
    pnp = _perturbed(jm.init(jax.random.PRNGKey(seed)), seed)
    params = jax.tree_util.tree_map(jnp.asarray, pnp)
    tm = load_jax_params(moe_models.MoETransformer(tc, device="cpu"), pnp)
    return jm, params, pnp, tm


def _tokens(seed, b, s, vocab=97):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- gating and dispatch ------------------------------------------------
def test_capacity_matches_jax():
    for tokens in (1, 7, 64, 333):
        for e in (2, 8, 128):
            for k in (1, 2):
                for drop in (True, False):
                    for f in (1.0, 1.25):
                        kw = dict(n_experts=e, top_k=k, drop_tokens=drop,
                                  capacity_factor=f, min_capacity=4)
                        for training in (True, False):
                            assert moe.capacity(
                                tokens, moe.GateConfig(**kw), training) == \
                                jax_moe.capacity(
                                    tokens, jax_moe.GateConfig(**kw),
                                    training)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("drop", [True, False])
def test_top_k_gating_matches_jax(k, drop):
    """Cap 3 over 24 tokens and 4 experts drops tokens; without
    ``drop_tokens`` the cap is the group."""
    S, E = 24, 4
    logits = np.random.default_rng(k + 2 * drop).standard_normal(
        (S, E)).astype(np.float32) * 2
    cap = 3 if drop else S
    kw = dict(n_experts=E, top_k=k, drop_tokens=drop)
    got = moe.top_k_gating(_t(logits), moe.GateConfig(**kw), cap)
    ref = jax_moe.top_k_gating(jnp.asarray(logits), jax_moe.GateConfig(**kw),
                               cap)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7)
    kept = int(got[1].sum())
    assert (kept < S * k) == drop


def _bank(rng, E, d, f, glu, bias):
    p = {"w_up": rng.standard_normal((E, d, f)) / np.sqrt(d),
         "w_down": rng.standard_normal((E, f, d)) / np.sqrt(f)}
    if glu:
        p["w_gate"] = rng.standard_normal((E, d, f)) / np.sqrt(d)
    if bias:
        p["b_up"] = rng.standard_normal((E, f)) * 0.1
        p["b_down"] = rng.standard_normal((E, d)) * 0.1
    return {n: a.astype(np.float32) for n, a in p.items()}


@pytest.mark.parametrize("activation", ["gelu", "silu_glu"])
def test_no_drop_moe_matches_jax(activation):
    """8 experts, the tokens routed to 3 of them (5 groups empty)."""
    rng = np.random.default_rng(4)
    S, k, E, d, f = 13, 2, 8, 16, 32
    glu = activation == "silu_glu"
    p = _bank(rng, E, d, f, glu, not glu)
    x = rng.standard_normal((S, d)).astype(np.float32)
    idx = np.stack([rng.permutation([1, 4, 6])[:k] for _ in range(S)])
    probs = rng.uniform(0.1, 1, (S, k)).astype(np.float32)
    got = moe.no_drop_moe(_t(x), _t(probs), _t(idx), {n: _t(a) for n, a in
                                                      p.items()}, activation)
    ref = jax_moe.no_drop_moe(jnp.asarray(x), jnp.asarray(probs),
                              jnp.asarray(idx, jnp.int32),
                              {n: jnp.asarray(a) for n, a in p.items()},
                              activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert np.abs(np.asarray(ref)).max() > 0.1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_route_matches_loop(dtype):
    """``torch._grouped_mm`` against the per-group loop on the same rows,
    groups of 0, 5, 0, 11 and 1 rows (leading, inner and trailing empty
    groups), and an empty input; bitwise in fp32, within a bf16 ulp of
    the fp32 product in bf16."""
    gen = torch.Generator().manual_seed(0)
    sizes = torch.tensor([0, 5, 0, 11, 1, 0])
    a = torch.randn(int(sizes.sum()), 32, generator=gen).to(dtype)
    b = torch.randn(6, 32, 48, generator=gen).to(dtype)
    loop = moe.grouped_mm(a, b, sizes, route="loop")
    grouped = moe.grouped_mm(a, b, sizes, route="grouped")
    assert moe.grouped_route(a, b) == "loop"        # CPU tensors
    assert grouped.dtype == loop.dtype == dtype
    if dtype == torch.float32:
        assert torch.equal(grouped, loop)
    else:
        np.testing.assert_allclose(grouped.float().numpy(),
                                   loop.float().numpy(), rtol=1e-2,
                                   atol=1e-2)
    empty = moe.grouped_mm(a[:0], b, torch.zeros(6, dtype=torch.long),
                           route="grouped")
    assert empty.shape == (0, 48)
    with pytest.raises(ValueError, match="route"):
        moe.grouped_mm(a, b, sizes, route="einsum")



def _cut_bank(p, tp, r):
    """Rank ``r``'s bank of ``tp``: ``d_ff / tp`` of every expert."""
    c = p["w_up"].shape[-1] // tp
    cols = slice(r * c, (r + 1) * c)
    return {n: a[..., cols] if n in ("w_up", "w_gate", "b_up")
            else a[:, cols] if n == "w_down" else a for n, a in p.items()}


@pytest.mark.parametrize("activation", ["gelu", "silu_glu"])
@pytest.mark.parametrize("tp", [2, 4])
def test_no_drop_tp_partials_round_once(activation, tp):
    """The bank cut ``tp`` ways on d_ff in bf16, as a model axis serves it,
    the group's sum played in one process in rank order: each rank's
    ``w_down`` partial reaches ``reduce`` in fp32 and the summed rows are
    rounded once, so the output is one device's but where two fp32 sums
    of the same products round to neighbouring bf16 values (under 1e-3
    of the elements, by one ulp). The same partials rounded to bf16
    before the sum part in over a tenth of them."""
    rng = np.random.default_rng(11)
    S, k, E, d, f = 64, 2, 8, 64, 256
    glu = activation == "silu_glu"
    p = {n: _t(a).to(torch.bfloat16)
         for n, a in _bank(rng, E, d, f, glu, not glu).items()}
    x = _t(rng.standard_normal((S, d))).to(torch.bfloat16)
    idx = _t(np.stack([rng.permutation(E)[:k] for _ in range(S)]))
    probs = _t(rng.uniform(0.1, 1, (S, k)).astype(np.float32))
    one = moe.no_drop_moe(x, probs, idx, p, activation)
    parts = []

    def keep(y):
        parts.append(y)
        return y

    for r in range(tp):
        moe.no_drop_moe(x, probs, idx, _cut_bank(p, tp, r), activation,
                        reduce=keep)
    assert [y.dtype for y in parts] == [torch.float32] * tp

    def summed(rows):
        total = rows[0]
        for y in rows[1:]:
            total = total + y
        return lambda _: total

    got = moe.no_drop_moe(x, probs, idx, _cut_bank(p, tp, 0), activation,
                          reduce=summed(parts))
    assert got.dtype == torch.bfloat16
    ulp = one.float().abs() * 2.0 ** -7
    diff = (got.float() - one.float()).abs()
    assert bool((diff <= ulp).all())
    assert (got != one).float().mean().item() < 1e-3
    twice = moe.no_drop_moe(x, probs, idx, _cut_bank(p, tp, 0), activation,
                            reduce=summed([y.to(torch.bfloat16).float()
                                           for y in parts]))
    assert (twice != one).float().mean().item() > 0.1


def _layer(activation, seed, noisy=None, E=4, d=16, f=32):
    rng = np.random.default_rng(seed)
    glu = activation == "silu_glu"
    p = _bank(rng, E, d, f, glu, not glu)
    p["wg"] = (rng.standard_normal((d, E)) / np.sqrt(d)).astype(np.float32)
    x = rng.standard_normal((3, 10, d)).astype(np.float32)
    gate = dict(n_experts=E, top_k=2, noisy_gate_policy=noisy)
    return (moe.MoELayer(d, f, moe.GateConfig(**gate), activation,
                         use_bias=not glu),
            jax_moe.MoELayer(d, f, jax_moe.GateConfig(**gate), activation,
                             use_bias=not glu), p, x)


@pytest.mark.parametrize("activation", ["gelu", "silu_glu"])
@pytest.mark.parametrize("training", [False, True])
def test_moe_layer_apply_matches_jax(activation, training):
    tl, jl, p, x = _layer(activation, 5)
    out, aux = tl.apply({n: _t(a) for n, a in p.items()}, _t(x),
                        training=training)
    jout, jaux = jax.jit(jl.apply, static_argnames="training")(
        {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x),
        rng=jax.random.PRNGKey(0), training=training)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    assert aux.dtype == torch.float32 and aux.dim() == 0


@pytest.mark.parametrize("noisy", ["RSample", "Jitter"])
def test_noisy_gate_repeats_under_one_seed(noisy):
    tl, _, p, x = _layer("gelu", 6, noisy=noisy)
    p = {n: _t(a) for n, a in p.items()}

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return tl.apply(p, _t(x), generator=gen, training=True)

    (a, aux_a), (b, aux_b) = run(3), run(3)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    quiet, _ = tl.apply(p, _t(x), training=True)    # no generator: no noise
    assert any(not torch.equal(run(s)[0], quiet) for s in range(4))


# -- the model ------------------------------------------------------------
@pytest.mark.parametrize("size", ["tiny", "350m", "1.3b"])
def test_presets_and_counts_match_jax(size):
    for n in (8, 64, 128):
        jc = jax_moe_models.gpt_moe_config(size, n)
        tc = moe_models.gpt_moe_config(size, n)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
        assert tc.flops_per_token(2048) == jc.flops_per_token(2048)
    big = moe_models.gpt_moe_config("350m", 128)
    assert (big.param_count(), big.active_param_count()) == \
        (25_927_273_472, 560_122_880)
    with pytest.raises(ValueError, match="unknown"):
        moe_models.gpt_moe_config("nope")


@pytest.mark.parametrize("name", list(FLAGSETS))
def test_leaves_and_param_count_match_jax(name):
    jc, tc = _configs(name)
    tm = moe_models.MoETransformer(tc, device="cpu", seed=2)
    jp = jax_moe_models.MoETransformer(jc).init(jax.random.PRNGKey(0))
    assert set(top_leaves(tc)) | {"layers"} == set(jp)
    assert set(layer_leaves(tc)) == set(jp["layers"])
    for n in layer_leaves(tc):
        assert tuple(getattr(tm.layers[0], n).shape) == \
            tuple(jp["layers"][n].shape[1:]), n
    if not tc.use_bias:
        assert sum(p.numel() for p in tm.parameters()) == tc.param_count()
    fresh = tm.moe.init(torch.Generator().manual_seed(1), n_layers=2)
    assert {n: tuple(a.shape) for n, a in fresh.items()} == \
        {n: tuple(jp["layers"][n].shape) for n in tm.moe.shapes()}
    assert all(torch.all(a == 0) for n, a in fresh.items()
               if n.startswith("b_"))
    # the init's scheme: the bank ~ N(0, 1 / fan_in), no w_down shrink
    assert tm.layers[0].w_down.std().item() == pytest.approx(
        1 / np.sqrt(tc.d_ff), rel=0.1)


@pytest.mark.parametrize("name", ["gelu_bias", "silu_glu"])
def test_weight_carry_round_trips(name):
    _, _, pnp, tm = _models(name, seed=4)
    back = export_params(tm)
    assert set(back["layers"]) == set(pnp["layers"])
    for k, v in pnp["layers"].items():
        np.testing.assert_array_equal(back["layers"][k], v)
    fresh = load_jax_params(moe_models.MoETransformer(tm.config,
                                                      device="cpu"), back)
    for (n, a), (_, b) in zip(tm.named_parameters(),
                              fresh.named_parameters()):
        assert torch.equal(a, b), n
    for drop in ("wg", "w_down"):
        layers = {k: v for k, v in pnp["layers"].items() if k != drop}
        with pytest.raises(ValueError, match=f"missing.*{drop}"):
            load_jax_params(tm, {**pnp, "layers": layers})
    with pytest.raises(ValueError, match="unexpected.*w_bogus"):
        load_jax_params(tm, {**pnp, "layers": {
            **pnp["layers"], "w_bogus": pnp["layers"]["w_up"]}})
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(tm, {**pnp, "layers": {
            **pnp["layers"], "w_up": pnp["layers"]["w_up"][:, :2]}})


@pytest.mark.parametrize("name", list(FLAGSETS))
def test_dense_and_kv_cache_logits_match_jax(name):
    """The dense path, then prefill 9 tokens + 3 decode steps over
    16-slot caches."""
    jm, params, _, tm = _models(name, seed=1)
    toks = _tokens(2, 2, 11)
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(toks)))
    with torch.no_grad():
        got = tm.apply(_t(toks)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    c = tm.config
    b, s = 2, 9
    shape = (c.n_layers, b, 16, c.n_kv_heads, c.head_dim)
    jcache = (jnp.zeros(shape), jnp.zeros(shape))
    tcache = (torch.zeros(shape), torch.zeros(shape))
    japply = jax.jit(jm.apply)
    toks = _tokens(3, b, s)
    pos = np.broadcast_to(np.arange(s), (b, s))
    for step in range(4):
        ref, jcache = japply(params, jnp.asarray(toks), jnp.asarray(pos),
                             kv_caches=jcache, cache_pos=int(pos[0, 0]))
        with torch.no_grad():
            got, tcache = tm.apply(_t(toks), _t(np.array(pos)),
                                   kv_caches=tcache,
                                   cache_pos=int(pos[0, 0]))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
        toks = np.asarray(ref)[:, -1:].argmax(-1)
        pos = np.full((b, 1), s + step)


@pytest.mark.parametrize("name", ["gelu", "silu_glu"])
def test_loss_with_aux_matches_jax(name):
    """JAX's ``loss`` runs the training route (capacity 4 a row of 16
    tokens over 4 experts drops tokens) and adds the weighted aux loss;
    so does the port's."""
    jm, params, _, tm = _models(name, seed=3, min_capacity=2,
                                capacity_factor=0.5)
    batch = {"input_ids": _tokens(4, 2, 16)}
    ref = float(jax.jit(jm.loss)(params, {"input_ids": jnp.asarray(
        batch["input_ids"])}))
    with torch.no_grad():
        got = tm.loss({"input_ids": _t(batch["input_ids"])})
        logits, aux = tm.apply(_t(batch["input_ids"]), training=True,
                               return_aux=True)
    np.testing.assert_allclose(float(got), ref, **TOL)
    _, jaux = jm.apply(params, jnp.asarray(batch["input_ids"]),
                       training=True, return_aux=True)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    assert float(aux) > 0


# -- the engines ------------------------------------------------------------
RAGGED = dict(token_budget=64, max_seqs=4, kv_block_size=8, n_kv_blocks=64,
              max_context=64)


@pytest.mark.parametrize("name,over", [
    ("suite_plain", JAX_SUITE), ("suite_windowed",
                                 {**JAX_SUITE, "attn_windows": (8, 8)}),
    ("top2", {**JAX_SUITE, "top_k": 2, "max_seq_len": 64}),
    ("silu_glu", {**JAX_SUITE, **FLAGSETS["silu_glu"], "top_k": 2})])
def test_ragged_greedy_streams_match_jax(name, over):
    jm, params, _, tm = _models(name, seed=6, **over)
    je = JaxRaggedEngine(jm, JaxRaggedConfig(dtype=jnp.float32, **RAGGED),
                         params=params)
    te = RaggedInferenceEngine(tm, RaggedConfig(dtype=torch.float32,
                                                **RAGGED), device="cpu")
    prompts = {7: list(range(1, 9)), 9: list(range(20, 30)),
               3: list(range(1, 15)), 4: _tokens(5, 1, 21, 64)[0].tolist()}
    got = te.generate(prompts, max_new_tokens=8, decode_chunk=3)
    assert got == je.generate(prompts, max_new_tokens=8, decode_chunk=3)
    assert_block_balance(te, expect_free=RAGGED["n_kv_blocks"])


def _jax_leaves(je):
    return {jax.tree_util.keystr(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(je.params,
                                                 is_leaf=jax_is_wq)[0]}


def _v1_config(dtype, bits):
    cfg = {"dtype": dtype, "temperature": 0.0}
    if bits:
        cfg["quant"] = {"enabled": True, "bits": bits, "group_size": 64}
    return cfg


@pytest.mark.parametrize("name", ["gelu_bias", "silu_glu"])
@pytest.mark.parametrize("bits", [0, 8])
def test_init_inference_trees_match_jax(name, bits):
    """bf16 trees bitwise; int8 payloads equal where the scales are (one
    ulp apart at most: JAX multiplies by fp32(1 / 127) under jit). The
    expert banks and ``wg`` (d 64 x 4 experts = 4 groups a layer) are
    quantized where JAX quantizes them."""
    jm, params, _, tm = _models(name, seed=7)
    cfg = _v1_config("bfloat16", bits)
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
            want = np.asarray(ref)
            want = want[int(parts[1])] if layer else want
            np.testing.assert_array_equal(
                leaf.view(torch.int16).numpy(), want.view(np.int16))
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
    if bits:
        bank = set(moe_models.MoETransformer(tm.config, device="cpu")
                   .moe.shapes())
        assert bank <= quantized and "wg" in quantized
    assert te.param_bytes() == je.param_bytes()


@pytest.mark.parametrize("name,bits", [("gelu_bias", 0), ("gelu_bias", 8),
                                       ("gelu_bias", 4), ("silu_glu", 8)])
def test_init_inference_greedy_streams_match_jax(name, bits):
    jm, params, _, tm = _models(name, seed=8)
    cfg = _v1_config("float32", bits)
    je = deepspeed_tpu.init_inference((jm, params), config=cfg)
    te = deepspeed_tpu_torch.init_inference(tm, config=cfg, device="cpu")
    ids = _tokens(9, 2, 7).astype(np.int32)
    np.testing.assert_array_equal(te.generate(ids, max_new_tokens=6),
                                  np.asarray(je.generate(ids,
                                                         max_new_tokens=6)))


# -- refusals ------------------------------------------------------------
class _Axis2:
    """A stand-in topology with a model axis of 2 (a cut reads no process
    group)."""
    model_parallel_size = 2

    def rank(self, axis):
        return 0


def test_refusals_name_their_items():
    _, _, _, tm = _models("silu_glu")
    # training it is no longer refused: one step of the capacity route
    eng, *_ = deepspeed_tpu_torch.initialize(model=tm, config={
        "train_batch_size": 2}, device="cpu")
    m = eng.train_batch({"input_ids": _t(_tokens(1, 2, 8))})
    assert torch.isfinite(m["loss"]) and not m["skipped"]
    # the banks shard over the model axis now, on d_ff (JAX's specs;
    # tests/test_torch_tp_serving.py serves them): ``wg`` replicated
    assert tuple(tm.moe.partition_specs()["w_down"]) == ("expert", "model",
                                                         None)
    assert tuple(tm.partition_specs()["layers"]["w_up"]) == (
        None, "expert", None, "model")
    _, _, _, tm = _models("silu_glu", vocab_size=96)   # 97 cannot shard
    f = tm.config.d_ff
    w_up = tm.layers[0].w_up.clone()
    shard_params(tm, _Axis2())
    assert torch.equal(tm.layers[0].w_up, w_up[..., : f // 2])
    assert tm.layers[0].w_down.shape == (4, f // 2, 64)
    assert tm.layers[0].wg.shape == (64, 4)
    # the capacity route (training) runs over the model axis too (item
    # 6b's training half; tests/test_torch_tp_train.py trains it at TP 2):
    # with the group's sum and copy as identities (one rank) it is the
    # plain route, bitwise. What still raises: the expert axis, item 13
    lp = {n: getattr(tm.layers[0], n) for n in tm.moe.shapes()}
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 8, 64)).astype(np.float32))
    plain, aux = tm.moe.apply(lp, x, training=True)
    cut, cut_aux = tm.moe.apply(lp, x, training=True, reduce=lambda y: y,
                                copy=lambda y: y)
    assert torch.equal(cut, plain) and torch.equal(cut_aux, aux)
    with pytest.raises(ConfigError, match="item 13"):
        Topology.build({"expert": 2})


def test_quant_group_across_layers_raises():
    """d 32 x 4 experts: ``wg`` has 128 elements a layer, no whole group
    of 256, while JAX's stacked [2, 32, 4] leaf has one, so its group
    crosses the layer boundary."""
    tm = moe_models.GPTMoE("tiny", 4, device="cpu", **{**SMALL,
                                                       "d_model": 32})
    with pytest.raises(ValueError, match="wg.*cross layer"):
        deepspeed_tpu_torch.init_inference(tm, config={
            "dtype": "float32", "quant": {"enabled": True, "bits": 8,
                                          "group_size": 256}}, device="cpu")


# -- on the card ------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_grouped_route_matches_loop(dtype):
    """At 350M+MoE-128's widths (d 1024, f 4096, 128 experts), a decode
    put's 32 pairs and a prefill's 1024: the grouped route (picked on the
    card) against the loop on the same rows and routing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch._grouped_mm's route is the "
                    "card's")
    gen = torch.Generator(device="cuda").manual_seed(0)
    E, d, f = 128, 1024, 4096
    w = (torch.randn(E, d, f, generator=gen, device="cuda") * 0.03).to(dtype)
    for pairs in (32, 1024):
        ids = torch.randint(0, E, (pairs,), generator=gen, device="cuda")
        sizes = torch.bincount(ids, minlength=E)
        a = torch.randn(pairs, d, generator=gen, device="cuda").to(dtype)
        assert moe.grouped_route(a, w) == "grouped"
        got = moe.grouped_mm(a, w, sizes)
        ref = moe.grouped_mm(a, w, sizes, route="loop")
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        torch.testing.assert_close(got.float(), ref.float(), rtol=tol,
                                   atol=tol)
