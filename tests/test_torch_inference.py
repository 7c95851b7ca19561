"""The v1 inference engine of the PyTorch port against the JAX package.

``deepspeed_tpu_torch.init_inference`` and ``deepspeed_tpu.init_inference``
build from the same JAX parameters (carried across with
``load_jax_params``) on a tiny Llama, with ZeRO-Inference quantization off,
int8 and int4 (group 128). The quantized trees are equal byte for byte
(the JAX stacked ``[n_layers, ...]`` leaves sliced per layer), as are
``param_bytes``; ``forward`` logits agree within 1e-5 relative (fp32);
greedy streams (with per-row EOS) and beam search are identical; the
top-k / top-p masks of sampling are equal. The KV-cache branch of the
port's ``Transformer.apply`` is held to the JAX one directly. The CUDA
engine is held to the CPU engine by a ``gpu`` test that skips here.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference.engine import _is_wq as jax_is_wq
from deepspeed_tpu.inference.engine import _sample as jax_sample
from deepspeed_tpu.models import Llama as JaxLlama
from deepspeed_tpu_torch.checkpoint.jax_params import load_jax_params
from deepspeed_tpu_torch.inference.engine import (InferenceConfig,
                                                  _filter_logits, _is_wq)
from deepspeed_tpu_torch.models.llama import Llama

TINY = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, vocab_size=512,
            max_seq_len=64)
QUANT = {"off": None, "int8": (8, 128), "int4": (4, 128)}


@pytest.fixture(scope="module")
def models():
    jm = JaxLlama("tiny", use_flash=False, remat=False, **TINY)
    params = jm.init(jax.random.PRNGKey(3))
    return jm, params, jax.tree_util.tree_map(np.asarray, params)


def _config(quant, dtype="float32", **kw):
    cfg = {"dtype": dtype, "temperature": 0.0, **kw}
    if QUANT[quant] is not None:
        bits, group = QUANT[quant]
        cfg["quant"] = {"enabled": True, "bits": bits, "group_size": group}
    return cfg


def _pair(models, quant, dtype="float32", **kw):
    jm, params, pnp = models
    je = deepspeed_tpu.init_inference((jm, params),
                                      config=_config(quant, dtype, **kw))
    tm = load_jax_params(Llama("tiny", device="cpu", **TINY), pnp)
    te = deepspeed_tpu_torch.init_inference(
        tm, config=_config(quant, dtype, **kw), device="cpu")
    return je, te


@pytest.fixture(scope="module")
def greedy_pair(models):
    """``_pair`` for greedy engines, built once per (quant, dtype): the JAX
    engine jits its programs per instance, so sharing an engine across
    tests compiles each program once. Greedy engines hold no state
    between calls."""
    pairs = {}

    def get(quant, dtype="float32"):
        if (quant, dtype) not in pairs:
            pairs[quant, dtype] = _pair(models, quant, dtype)
        return pairs[quant, dtype]
    return get


def _ids(seed, b, s):
    return np.random.default_rng(seed).integers(1, 512, (b, s)).astype(
        np.int32)


def _jax_leaves(je):
    return {jax.tree_util.keystr(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(je.params,
                                                 is_leaf=jax_is_wq)[0]}


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _payload(blocks, scale, bits):
    """The engine's payload for fp32 ``blocks`` [rows, group] and
    ``scale`` [rows]: clamp(round(x / scale)), int4 packed offset-binary,
    element 2k in the low nibble."""
    qmax = 2 ** (bits - 1) - 1
    q = torch.clamp(torch.round(blocks / scale[:, None]), -qmax - 1, qmax)
    q = q.to(torch.int32).reshape(-1)
    if bits == 4:
        q4 = (q + 8).reshape(-1, 2)
        return (q4[:, 0] | (q4[:, 1] << 4)).to(torch.uint8)
    return q.to(torch.int8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_trees_and_param_bytes_match_jax(models, greedy_pair, quant,
                                                  dtype):
    """Leaf by leaf, the JAX stacked leaves sliced per layer. The JAX
    engine quantizes under ``jax.jit``, where XLA turns the division by
    the constant qmax into a multiply by its fp32 reciprocal, so its
    scales are absmax * fp32(1 / qmax): the port's IEEE absmax / qmax or
    one ulp off. Each payload is the quantization of the dtype-cast
    weights with its own scales, so the payloads are equal wherever the
    scales are."""
    je, te = greedy_pair(quant, dtype)
    _, _, pnp = models
    bits, group = QUANT[quant]
    qmax = 2.0 ** (bits - 1) - 1
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jl = _jax_leaves(je)
    n = TINY["n_layers"]
    quantized = 0
    for name, leaf in te.params.items():
        parts = name.split(".")
        layer = parts[0] == "layers"
        ref = jl[f"['layers']['{parts[2]}']" if layer else f"['{name}']"]
        x = pnp["layers"][parts[2]][int(parts[1])] if layer else pnp[name]
        assert _is_wq(leaf) == jax_is_wq(ref)
        if not _is_wq(leaf):
            np.testing.assert_array_equal(
                _np(leaf), np.asarray(ref, np.float32)[int(parts[1])]
                if layer else np.asarray(ref, np.float32))
            continue
        quantized += 1
        jq, js = np.asarray(ref["__wq__"]).reshape(-1), np.asarray(ref["s"])
        if layer:
            jq, js = np.split(jq, n)[int(parts[1])], np.split(js, n)[int(parts[1])]
        js = torch.from_numpy(js.copy())
        blocks = torch.from_numpy(np.array(x)).to(tdt).float() \
            .reshape(-1, group)
        amax = blocks.abs().amax(dim=1)
        one = torch.ones_like(amax)
        ieee = torch.where(amax == 0, one, amax / torch.tensor(qmax))
        recip = torch.where(amax == 0, one,
                            amax * torch.tensor(1.0 / qmax, dtype=torch.float32))
        assert torch.equal(leaf["s"], ieee) and torch.equal(js, recip)
        assert int((js.view(torch.int32) - leaf["s"].view(torch.int32))
                   .abs().max()) <= 1
        assert torch.equal(leaf["__wq__"].reshape(-1),
                           _payload(blocks, leaf["s"], bits))
        assert np.array_equal(jq, _payload(blocks, js, bits).numpy())
        same = np.repeat((js == leaf["s"]).numpy(),
                         group // 2 if bits == 4 else group)
        np.testing.assert_array_equal(leaf["__wq__"].numpy().reshape(-1)[same],
                                      jq[same])
    # every leaf but final_norm_w: JAX's stacked norm vectors are 2-D
    assert quantized == len(te.params) - 1
    assert not _is_wq(te.params["final_norm_w"])
    assert te.param_bytes() == je.param_bytes()


@pytest.mark.parametrize("quant", list(QUANT))
def test_forward_logits_match_jax(greedy_pair, quant):
    je, te = greedy_pair(quant)
    ids = _ids(1, 2, 12)
    ref = np.asarray(je.forward(ids))
    got = te.forward(ids).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("quant", list(QUANT))
def test_greedy_generate_identical_to_jax_with_per_row_eos(greedy_pair, quant):
    je, te = greedy_pair(quant)
    ids = _ids(2, 3, 9)
    ref = je.generate(ids, max_new_tokens=10)
    got = te.generate(ids, max_new_tokens=10)
    np.testing.assert_array_equal(got, ref)
    eos = int(ref[1, 9 + 3])            # row 1 stops after its 4th token
    ref = je.generate(ids, max_new_tokens=10, eos_token_id=eos)
    got = te.generate(ids, max_new_tokens=10, eos_token_id=eos)
    np.testing.assert_array_equal(got, ref)
    assert (got[1, 9 + 3:] == eos).all()


@pytest.mark.parametrize("quant", ["off", "int8"])
@pytest.mark.parametrize("use_eos", [False, True])
def test_beam_search_identical_to_jax(greedy_pair, quant, use_eos):
    je, te = greedy_pair(quant)
    ids = _ids(3, 2, 7)
    eos = None
    if use_eos:
        eos = int(je.generate(ids, max_new_tokens=6)[0, 7 + 2])
    ref = je.generate(ids, max_new_tokens=8, num_beams=3, eos_token_id=eos)
    got = te.generate(ids, max_new_tokens=8, num_beams=3, eos_token_id=eos)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.8), (7, 0.6)])
def test_sampling_filters_match_jax(top_k, top_p):
    """The frameworks' random streams differ; the filtered logits (the
    -inf masks of top-k and top-p) must not."""
    logits = np.random.default_rng(4).standard_normal((3, 50)).astype(
        np.float32) * 3
    got = _filter_logits(torch.from_numpy(logits), 0.7, top_k, top_p)
    # JAX's _sample draws from its filtered logits; recover them by
    # drawing many times and checking the support instead of the values
    keys = jax.random.split(jax.random.PRNGKey(0), 400)
    draws = np.stack([np.asarray(jax_sample(jnp.asarray(logits), k, 0.7,
                                            top_k, top_p)) for k in keys])
    kept = np.isfinite(got.numpy())
    for r in range(3):
        assert set(draws[:, r].tolist()) <= set(np.flatnonzero(kept[r]))
    # and the masks equal a numpy restatement of the JAX formula
    scaled = logits / 0.7
    ref = scaled.copy()
    if top_k > 0:
        kth = np.sort(ref, axis=-1)[:, -top_k][:, None]
        ref = np.where(ref < kth, -np.inf, ref)
    if top_p < 1.0:
        srt = np.sort(ref, axis=-1)[:, ::-1]
        probs = np.asarray(jax.nn.softmax(jnp.asarray(srt), axis=-1))
        cut_idx = np.sum(np.cumsum(probs, axis=-1) < top_p, axis=-1)
        cut = np.take_along_axis(srt, cut_idx[:, None], axis=-1)
        ref = np.where(ref < cut, -np.inf, ref)
    np.testing.assert_array_equal(kept, np.isfinite(ref))


def test_sampled_generate_is_seeded_and_in_range(models):
    _, te = _pair(models, "int8", temperature=0.8, top_k=20, seed=7)
    ids = _ids(5, 2, 6)
    a = te.generate(ids, max_new_tokens=6)
    _, te2 = _pair(models, "int8", temperature=0.8, top_k=20, seed=7)
    np.testing.assert_array_equal(a, te2.generate(ids, max_new_tokens=6))
    assert a.shape == (2, 12) and ((a >= 0) & (a < 512)).all()


def test_kv_cache_apply_matches_jax(models):
    """Prefill then one decode step through the KV-cache branch of both
    frameworks' apply: logits and caches agree."""
    jm, params, pnp = models
    tm = load_jax_params(Llama("tiny", device="cpu", **TINY), pnp)
    ids = _ids(6, 2, 10)
    shape = (2, 2, 16, 2, 64)                   # L, b, max_len, hkv, hd
    jc = (jnp.zeros(shape), jnp.zeros(shape))
    jl, jc = jm.apply(params, jnp.asarray(ids), kv_caches=jc, cache_pos=0,
                      last_token_only=True)
    tc = (torch.zeros(shape), torch.zeros(shape))
    tl, tc = tm.apply(torch.from_numpy(ids), kv_caches=tc, cache_pos=0,
                      last_token_only=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    nxt = np.argmax(np.asarray(jl)[:, 0], axis=-1).astype(np.int32)
    jl, jc = jm.apply(params, jnp.asarray(nxt)[:, None],
                      positions=jnp.asarray(10)[None, None], kv_caches=jc,
                      cache_pos=10)
    tl, tc = tm.apply(torch.from_numpy(nxt)[:, None].long(),
                      positions=torch.tensor([[10]]), kv_caches=tc,
                      cache_pos=10)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    # per-layer caches work as the stacked ones do
    per_layer = tuple([torch.zeros(shape[1:]) for _ in range(2)]
                      for _ in range(2))
    tl2, _ = tm.apply(torch.from_numpy(ids), kv_caches=per_layer,
                      cache_pos=0, last_token_only=True)
    _, full = tm.apply(torch.from_numpy(ids), kv_caches=(
        torch.zeros(shape), torch.zeros(shape)), cache_pos=0)
    assert torch.equal(per_layer[0][1], full[0][1])
    with pytest.raises(ValueError, match="does not fit"):
        tm.apply(torch.from_numpy(ids), kv_caches=tc, cache_pos=8)


def test_generation_past_max_seq_len_raises(greedy_pair):
    je, te = greedy_pair("off")
    ids = _ids(7, 1, 60)
    with pytest.raises(AssertionError, match="max_seq_len"):
        je.generate(ids, max_new_tokens=10)
    with pytest.raises(ValueError, match="max_seq_len"):
        te.generate(ids, max_new_tokens=10)
    with pytest.raises(ValueError, match="max_seq_len"):
        te.generate(ids, max_new_tokens=10, num_beams=2)


@pytest.mark.parametrize("kw,exc,match", [
    # tensor parallelism needs as many ranks as tensor_parallel (one
    # process here: world size 1); TP with quantized weights is item 6b
    (dict(tensor_parallel=2), ValueError, "world size"),
    (dict(mp_size=2), ValueError, "world size"),
    (dict(tensor_parallel=2, quant={"enabled": True}), NotImplementedError,
     "6b"),
    (dict(checkpoint="/nonexistent"), NotImplementedError, "checkpoint"),
    (dict(enable_cuda_graph=True), NotImplementedError, "CUDA graph"),
    (dict(kernel_backend="tpu"), ValueError, "kernel_backend"),
    (dict(quant={"enabled": True, "bits": 2}), ValueError, "bits"),
])
def test_unported_and_bad_options_raise(models, kw, exc, match):
    _, _, pnp = models
    tm = Llama("tiny", device="cpu", **TINY)
    with pytest.raises(exc, match=match):
        deepspeed_tpu_torch.init_inference(tm, config=kw, device="cpu")


def test_pallas_backend_at_tp1_binds_nothing(models):
    """As the JAX engine: kernel_backend='pallas' is accepted at tensor
    parallelism 1 and changes nothing (the backend binds only under TP)."""
    _, _, pnp = models
    ids = _ids(3, 2, 6)
    out = {}
    for kb in ("auto", "pallas"):
        tm = load_jax_params(Llama("tiny", device="cpu", **TINY), pnp)
        eng = deepspeed_tpu_torch.init_inference(
            tm, config={"dtype": "float32", "kernel_backend": kb},
            device="cpu")
        out[kb] = eng.generate(ids, max_new_tokens=4)
    np.testing.assert_array_equal(np.asarray(out["auto"]),
                                  np.asarray(out["pallas"]))


def test_config_aliases_match_jax():
    from deepspeed_tpu.inference.engine import InferenceConfig as JaxConfig

    d = {"mp_size": 1, "quantization": {"enabled": True, "bits": 4},
         "dtype": "fp16", "top_p": 0.9, "foo": 3}
    got, ref = InferenceConfig.from_any(d), JaxConfig.from_any(d)
    assert (got.tensor_parallel, got.quant, got.extras, got.top_p) == \
        (ref.tensor_parallel, ref.quant, ref.extras, ref.top_p)
    assert got.torch_dtype is torch.float16


def test_layer_leaf_not_a_multiple_of_the_group_raises(models):
    """At group 512 the stacked [2, 256] norm leaf is one JAX block that
    spans both layers; per-layer leaves cannot reproduce it."""
    tm = Llama("tiny", device="cpu", **TINY)
    with pytest.raises(ValueError, match="cross layer"):
        deepspeed_tpu_torch.init_inference(
            tm, config={"dtype": "float32",
                        "quant": {"enabled": True, "group_size": 512}},
            device="cpu")


def test_engine_takes_the_model_weights_and_params_pair(models):
    _, _, pnp = models
    tm = load_jax_params(Llama("tiny", device="cpu", **TINY), pnp)
    params = {n: p.clone() for n, p in tm.named_parameters()}
    te = deepspeed_tpu_torch.init_inference(tm, config=_config("int8"),
                                            device="cpu")
    # the model's own copies of the quantized leaves are released
    assert tm.layers[0].wq.numel() == 0 and tm.final_norm_w.numel() == 256
    ids = _ids(8, 2, 5)
    te2 = deepspeed_tpu_torch.init_inference(
        (Llama("tiny", device="cpu", **TINY), params),
        config=_config("int8"), device="cpu")
    np.testing.assert_array_equal(te.generate(ids, max_new_tokens=4),
                                  te2.generate(ids, max_new_tokens=4))


@pytest.mark.gpu
@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_cuda_engine_matches_cpu_engine(quant):
    """Quantize and dequantize kernels against their plain versions inside
    the engine: the same weights on cuda and cpu give bitwise-equal
    quantized trees and identical greedy tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from deepspeed_tpu_torch.ops import quant as qops

    torch.backends.cuda.matmul.allow_tf32 = False
    cpu_model = Llama("tiny", device="cpu", seed=3, **TINY)
    cuda_model = Llama("tiny", device="cuda", **TINY)
    cuda_model.load_state_dict(cpu_model.state_dict())
    engines = {}
    before = qops.quantize_blockwise.launches
    for dev, m in (("cuda", cuda_model), ("cpu", cpu_model)):
        engines[dev] = deepspeed_tpu_torch.init_inference(
            m, config=_config(quant, "bfloat16"), device=dev)
    # one engine on cuda: 9 leaves x 2 layers + embedding + head
    assert qops.quantize_blockwise.launches == before + 20
    for name, leaf in engines["cpu"].params.items():
        other = engines["cuda"].params[name]
        for key in (("__wq__", "s") if _is_wq(leaf) else (None,)):
            a = leaf if key is None else leaf[key]
            b = other if key is None else other[key]
            assert torch.equal(a, b.cpu()), name
    ids = _ids(9, 2, 11)
    before = qops.dequantize_blockwise.launches
    got = engines["cuda"].generate(ids, max_new_tokens=8)
    assert qops.dequantize_blockwise.launches == before + 8 * 20
    np.testing.assert_array_equal(got, engines["cpu"].generate(
        ids, max_new_tokens=8))
