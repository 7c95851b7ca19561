"""Speculative decoding of the PyTorch port against the JAX package, on the
CPU.

Both engines serve the same tiny Llama (JAX weights carried across) in
fp32. ``NgramIndex`` proposes exactly what ``_prompt_lookup`` and the JAX
index propose, through appends and trims; ``put_spec`` returns the same
chains and per-row logits within 1e-4; ``generate_speculative`` and a
``ServingEngine`` with ``serving.speculative`` emit greedy streams
identical to the JAX engine's and to the port's own plain streams, on fp
and int8 pools. ``put_spec``'s invalid-chain and ``PoolExhausted`` paths
leave no draft token behind, the drafting arithmetic
(``CapacityView.draft_budget`` / ``chain_len_for``) equals JAX's, the
fallback latch trips on the same request, and a failed trim of a
rejected tail takes the tick-fault path.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp

from deepspeed_tpu.config import ServingConfig as JaxServingConfig
from deepspeed_tpu.inference.ragged import (
    NgramIndex as JaxNgramIndex,
    RaggedConfig as JaxRaggedConfig,
    RaggedInferenceEngine as JaxRaggedEngine,
    _prompt_lookup as jax_prompt_lookup)
from deepspeed_tpu.models import Llama as JaxLlama
from deepspeed_tpu.serving import ServingEngine as JaxServingEngine
from deepspeed_tpu.serving.scheduler import CapacityView as JaxCapacityView
from deepspeed_tpu_torch.checkpoint.jax_params import load_jax_params
from deepspeed_tpu_torch.config import ConfigError, ServingConfig
from deepspeed_tpu_torch.inference.ragged import (
    NgramIndex, PoolExhausted, RaggedConfig, RaggedInferenceEngine,
    _prompt_lookup, assert_block_balance)
from deepspeed_tpu_torch.models.llama import Llama
from deepspeed_tpu_torch.serving.request import Request, RequestState
from deepspeed_tpu_torch.serving.scheduler import CapacityView
from deepspeed_tpu_torch.serving.server import ServingEngine

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, vocab_size=128,
            max_seq_len=256)
CFG = dict(token_budget=32, max_seqs=4, kv_block_size=8, n_kv_blocks=64,
           max_context=128, enable_prefix_cache=True)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    jm = JaxLlama("tiny", use_flash=False, remat=False, **TINY)
    params = jm.init(jax.random.PRNGKey(5))
    tm = load_jax_params(Llama("tiny", device="cpu", **TINY),
                         jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


def _engine(models, **kw):
    return RaggedInferenceEngine(
        models[2], RaggedConfig(dtype=torch.float32, **{**CFG, **kw}),
        device="cpu")


def _jax_engine(models, **kw):
    jm, params, _ = models
    return JaxRaggedEngine(jm, JaxRaggedConfig(dtype=jnp.float32,
                                               **{**CFG, **kw}),
                           params=params)


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(1, 128, n).tolist()


# ---------------------------------------------------------------- drafting
@settings(max_examples=40, deadline=None, database=None)
@given(stream=st.lists(st.integers(0, 5), min_size=1, max_size=48),
       ngram=st.integers(1, 3), k=st.integers(0, 6),
       cuts=st.lists(st.tuples(st.integers(0, 48), st.integers(0, 6)),
                     max_size=4),
       extra=st.lists(st.integers(0, 5), max_size=2))
def test_ngram_index_matches_prompt_lookup_and_jax(stream, ngram, k, cuts,
                                                   extra):
    """Grow, trim and regrow a stream; at every point the port's index,
    the JAX index and both rescans propose the same tokens."""
    mine, theirs = NgramIndex(ngram), JaxNgramIndex(ngram)
    toks = list(stream)
    for cut, grow in [(len(toks), 0)] + cuts:
        cut = min(cut, len(toks))
        mine.truncate(cut)
        theirs.truncate(cut)
        toks = toks[:cut] + [(cut + i) % 6 for i in range(grow)]
        mine.sync(toks)
        theirs.sync(toks)
        want = jax_prompt_lookup(toks + extra, ngram, k)
        assert _prompt_lookup(toks + extra, ngram, k) == want
        assert mine.lookup(extra, k) == want == theirs.lookup(extra, k)


def test_prompt_lookup_examples():
    ctx = [1, 2, 3, 9, 9, 1, 2, 3]
    assert _prompt_lookup(ctx, 3, 2) == [9, 9]
    assert _prompt_lookup(ctx, 3, 5) == [9, 9, 1, 2, 3]
    assert _prompt_lookup([7, 8, 9], 3, 2) == []
    assert _prompt_lookup([5, 5, 5, 5], 2, 2) == [5, 5]
    assert _prompt_lookup([1, 2], 3, 2) == []


@pytest.mark.parametrize("ema,lookahead", [(1.0, 4), (0.5, 4), (0.0, 4),
                                           (0.1, 4), (2.0, 4), (0.13, 8),
                                           (1.0, 0), (0.62, 7)])
def test_chain_len_for_matches_jax(ema, lookahead):
    assert CapacityView.chain_len_for(ema, lookahead) == \
        JaxCapacityView.chain_len_for(ema, lookahead)


def test_draft_budget_matches_jax(models):
    mine = CapacityView(_engine(models, token_budget=64),
                        reserve_output=False)
    theirs = JaxCapacityView(_jax_engine(models, token_budget=64),
                             reserve_output=False)
    for n_dec, pre in ((4, 0), (4, 40), (4, 1000), (64, 0), (0, 3), (-1, -5)):
        assert mine.draft_budget(n_dec, pre) == \
            theirs.draft_budget(n_dec, pre)
    assert mine.draft_budget(4, 40) == 20


# ------------------------------------------------------------ the engine
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_generate_speculative_identical_to_jax_and_plain(models, kv_quant):
    """A repetitive prompt (drafts accepted) and a random one (drafts
    mostly rejected), two sequences with an EOS that fires mid-stream."""
    rep, rnd = [5, 6, 7, 8] * 6, _prompt(51, 17)
    prompts = {1: rep, 2: rnd}
    kw = dict(kv_quant=kv_quant, enable_prefix_cache=False)
    plain = _engine(models, **kw).generate(prompts, max_new_tokens=12)
    je, te = _jax_engine(models, **kw), _engine(models, **kw)
    got = te.generate_speculative(prompts, max_new_tokens=12)
    assert got == plain == je.generate_speculative(prompts,
                                                   max_new_tokens=12)
    assert te.spec_stats == je.spec_stats and te.spec_stats["accepted"] > 0
    eos = plain[1][3]
    want = _engine(models, **kw).generate(prompts, max_new_tokens=12,
                                          eos_token_id=eos)
    assert te.generate_speculative(prompts, max_new_tokens=12,
                                   eos_token_id=eos) == want
    assert_block_balance(te, expect_free=CFG["n_kv_blocks"])


def test_oracle_drafts_are_all_accepted(models, monkeypatch):
    """Drafts that are the true continuation: every proposal accepted,
    ceil(11 / 5) rounds for 12 tokens at lookahead 4."""
    p = _prompt(53, 13)
    want = _engine(models).generate({1: p}, max_new_tokens=12)[1]
    full = p + want

    def oracle(self, uid, next_token, ngram, k):
        ctx = self.seqs[uid].tokens + [next_token]
        assert ctx == full[:len(ctx)]           # the stream stays validated
        return full[len(ctx): len(ctx) + k]

    monkeypatch.setattr(RaggedInferenceEngine, "draft_tokens", oracle)
    te = _engine(models)
    assert te.generate_speculative({1: p}, max_new_tokens=12,
                                   lookahead=4)[1] == want
    assert te.spec_stats == {"proposed": 8, "accepted": 8, "rounds": 3}


def test_speculative_composes_with_prefix_cache_and_budget(models):
    p = [3, 4, 5] * 8
    want = _engine(models).generate({1: p}, max_new_tokens=10)[1]
    te = _engine(models)
    assert te.generate_speculative({1: p}, max_new_tokens=10)[1] == want
    assert te.generate_speculative({2: p}, max_new_tokens=10)[2] == want
    assert te.prefix_cache.hits >= 1
    prompts = {i: _prompt(61 + i, 9) for i in range(4)}
    want = _engine(models, token_budget=16).generate(prompts,
                                                     max_new_tokens=6)
    assert _engine(models, token_budget=16).generate_speculative(
        prompts, max_new_tokens=6, lookahead=32) == want


def test_put_spec_matches_jax(models):
    """One step with a prefill chunk, a plain decode and two draft chains
    (one right, one wrong): the same chains, and every row's logits
    within 1e-4."""
    je, te = _jax_engine(models), _engine(models)
    a, b, c = [5, 6, 7, 8] * 4, _prompt(2, 9), _prompt(3, 11)
    for eng in (je, te):
        eng.put([1, 2, 3], [a, b, c])
    ref = je.put([1, 2, 3], [[5], [7], [9]])
    t1, t2 = int(np.argmax(ref[0])), int(np.argmax(ref[1]))
    te.put([1, 2, 3], [[5], [7], [9]])
    args = ([1, 2, 3, 4], [[t1], [t2], [11], _prompt(4, 12)],
            [[5, 6, 7, 8], [1, 2, 3], [], []])
    jout, jver = je.put_spec(*args)
    tout, tver = te.put_spec(*args)
    np.testing.assert_allclose(tout, jout, **TOL)
    assert set(tver) == set(jver) == {1, 2}
    for uid in jver:
        assert tver[uid][0] == jver[uid][0]
        np.testing.assert_allclose(tver[uid][1], jver[uid][1], **TOL)
    for uid in (1, 2, 3, 4):
        assert te.seqs[uid].tokens == je.seqs[uid].tokens
        assert te.seqs[uid].seen == je.seqs[uid].seen


def test_put_spec_invalid_chain_and_pool_exhaustion_leave_no_drafts(models):
    te = _engine(models)
    te.put([1], [[5, 6, 7, 8]])
    te.put([2], [[9, 3, 9, 3]])
    len1 = len(te.seqs[1].tokens)
    with pytest.raises(ValueError, match="pending"):
        te.put_spec([1, 2], [[11], [12, 13]], [[21, 22], [23]])
    assert te.seqs[1].tokens[len1:] == [11]           # no draft residue
    te.flush([1, 2])
    assert_block_balance(te)
    # a pool of 3 pages: the chain's third page cannot be had
    te = _engine(models, n_kv_blocks=3, enable_prefix_cache=False)
    p = _prompt(7, 15)
    te.put([1], [p])
    before = list(te.seqs[1].tokens)
    with pytest.raises(PoolExhausted):
        te.put_spec([1], [[4]], [list(range(1, 12))])
    assert te.seqs[1].tokens == before + [4]          # fed token only
    out = te.put([1], [[]])                           # the plain retry
    assert not np.isnan(out).any()
    te.flush([1])
    assert_block_balance(te, expect_free=3)


def test_generate_speculative_refuses_sampling(models):
    te = _engine(models, temperature=0.8)
    with pytest.raises(NotImplementedError, match="greedy-only"):
        te.generate_speculative({1: [1, 2, 3]})


# ------------------------------------------------------------ the server
def _serve(srv, prompt, n_new, **kw):
    streamed = []
    req = srv.submit(prompt, max_new_tokens=n_new, on_token=streamed.append,
                     **kw)
    for _ in range(400):
        if req.is_terminal:
            break
        srv.step()
    assert req.is_terminal, req.state
    return req, streamed


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_speculative_serving_identical_to_jax_and_plain(models, kv_quant):
    """Same streams with speculation on and off, on the port and the JAX
    server, in fewer ticks; the per-request ledger equals JAX's."""
    scfg = {"speculative": True, "spec_ngram": 2, "spec_lookahead": 4,
            "kv_quant": kv_quant}
    runs = {}
    for name, spec in (("plain", False), ("spec", True)):
        srv = ServingEngine(_engine(models, kv_quant=kv_quant),
                            {**scfg, "speculative": spec}, start=False,
                            device="cpu")
        req, streamed = _serve(srv, [5, 6, 7, 8], 48)
        assert streamed == req.tokens and srv.block_leaks() == []
        runs[name] = (req, srv._tick_count)
        srv.close()
    jsrv = JaxServingEngine(_jax_engine(models, kv_quant=kv_quant),
                            JaxServingConfig(**scfg), start=False)
    jreq = jsrv.submit([5, 6, 7, 8], max_new_tokens=48)
    for _ in range(400):
        if jreq.is_terminal:
            break
        jsrv._tick()
    jsrv.close()
    (plain, n_plain), (spec, n_spec) = runs["plain"], runs["spec"]
    assert spec.tokens == plain.tokens == jreq.tokens
    assert spec.state is RequestState.FINISHED
    assert 0 < spec.spec_accepted <= spec.spec_proposed
    assert (spec.spec_proposed, spec.spec_accepted) == \
        (jreq.spec_proposed, jreq.spec_accepted)
    assert n_spec < n_plain and n_spec == jsrv._tick_count


def test_speculative_serving_many_requests_match_jax(models):
    """Six requests over four slots, prefill chunks beside drafted
    decodes: every stream identical to the JAX server's."""
    prompts = [[3, 4, 5] * 7, _prompt(2, 45), [9, 2] * 6, _prompt(4, 3),
               [1, 2, 3, 4] * 5, _prompt(6, 12)]
    scfg = {"policy": "fcfs", "speculative": True, "spec_ngram": 2}
    tsrv = ServingEngine(_engine(models), scfg, start=False, device="cpu")
    jsrv = JaxServingEngine(_jax_engine(models), scfg, start=False)
    treqs = [tsrv.submit(p, max_new_tokens=10) for p in prompts]
    jreqs = [jsrv.submit(p, max_new_tokens=10) for p in prompts]
    for srv, reqs in ((tsrv, treqs), (jsrv, jreqs)):
        for _ in range(400):
            if all(r.is_terminal for r in reqs):
                break
            srv.step()
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert all(r.state is RequestState.FINISHED for r in treqs)
    assert sum(r.spec_proposed for r in treqs) > 0
    assert tsrv._engine.spec_stats == jsrv._engine.spec_stats
    assert tsrv.block_leaks() == []


def test_fallback_latch_trips_on_the_same_request(models):
    scfg = {"speculative": True, "spec_ngram": 2, "spec_lookahead": 4,
            "spec_accept_floor": 0.99, "spec_floor_min_proposed": 4,
            "spec_ema": 0.5}
    prompt = _prompt(9, 10)
    plain, _ = _serve(ServingEngine(_engine(models), start=False,
                                    device="cpu"), prompt, 40)
    srv = ServingEngine(_engine(models), scfg, start=False, device="cpu")
    req, _ = _serve(srv, prompt, 40)
    jsrv = JaxServingEngine(_jax_engine(models), JaxServingConfig(**scfg),
                            start=False)
    jreq = jsrv.submit(prompt, max_new_tokens=40)
    for _ in range(400):
        if jreq.is_terminal:
            break
        jsrv._tick()
    assert req.tokens == plain.tokens == jreq.tokens
    assert req._spec_disabled and jreq._spec_disabled
    assert (req.spec_proposed, req.spec_accepted, req._spec_ema) == \
        (jreq.spec_proposed, jreq.spec_accepted, jreq._spec_ema)


def test_verify_trim_failure_takes_tick_fault_path(models):
    plain, _ = _serve(ServingEngine(_engine(models), start=False,
                                    device="cpu"), [5, 6, 7, 8], 48)
    eng = _engine(models)
    real_trim, fails = eng.trim, [0]

    def flaky_trim(uid, length):
        if fails[0] == 0:
            fails[0] += 1
            raise PoolExhausted("injected: copy-on-write page")
        return real_trim(uid, length)

    eng.trim = flaky_trim
    srv = ServingEngine(eng, {"speculative": True, "spec_ngram": 2,
                              "tick_retry_limit": 3}, start=False,
                        device="cpu")
    req, _ = _serve(srv, [5, 6, 7, 8], 48)
    assert req.state is RequestState.FINISHED, req.error
    assert fails[0] == 1 and req.retries == 1
    assert req.tokens == plain.tokens
    assert_block_balance(eng)


def test_serving_config_parses_and_validates_spec_knobs():
    c = ServingConfig.from_dict({"speculative": True, "spec_lookahead": 6,
                                 "spec_ngram": 2, "spec_accept_floor": 0.3,
                                 "spec_floor_min_proposed": 8,
                                 "spec_ema": 0.5})
    j = JaxServingConfig.from_dict({"speculative": True, "spec_lookahead": 6,
                                    "spec_ngram": 2,
                                    "spec_accept_floor": 0.3,
                                    "spec_floor_min_proposed": 8,
                                    "spec_ema": 0.5})
    for key in ("speculative", "spec_lookahead", "spec_ngram",
                "spec_accept_floor", "spec_floor_min_proposed", "spec_ema"):
        assert getattr(c, key) == getattr(j, key)
    assert ServingConfig().speculative is False
    for bad in ({"spec_lookahead": 0}, {"spec_ngram": 0},
                {"spec_accept_floor": 1.5}, {"spec_ema": 0.0}):
        with pytest.raises(ConfigError):
            ServingConfig.from_dict(bad)


def test_request_carries_the_speculative_ledger():
    r = Request(prompt=[1, 2])
    assert (r.spec_proposed, r.spec_accepted) == (0, 0)
    assert r._spec_ema == 1.0 and r._spec_disabled is False


@pytest.mark.gpu
def test_cuda_speculative_serving_and_handoff_match_cpu():
    """On the card (fp32, TF32 off, head_dim 64): speculative serving emits
    the cpu server's streams through put_spec's own work lists, and a
    sequence exported by the cuda engine continues on the cpu engine with
    the cuda engine's tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    from deepspeed_tpu_torch.ops import paged_attention as pa

    kw = dict(TINY, d_model=128, n_heads=2, n_kv_heads=1)
    prompts = [[5, 6, 7, 8] * 5, _prompt(81, 45), [9, 2] * 8, _prompt(83, 3)]
    cpu_model = Llama("tiny", device="cpu", seed=4, **kw)
    cuda_model = Llama("tiny", device="cuda", **kw)
    cuda_model.load_state_dict(cpu_model.state_dict())   # one set of weights
    out, engines = {}, {}
    for dev, model in (("cuda", cuda_model), ("cpu", cpu_model)):
        eng = RaggedInferenceEngine(
            model, RaggedConfig(dtype=torch.float32, **CFG), device=dev)
        before = pa.paged_attention.launches
        with ServingEngine(eng, {"policy": "fcfs", "speculative": True,
                                 "spec_ngram": 2}, device=dev) as srv:
            reqs = [srv.submit(p, max_new_tokens=12) for p in prompts]
            out[dev] = [r.result(timeout=120) for r in reqs]
        assert srv.block_leaks() == []
        assert (pa.paged_attention.launches > before) == (dev == "cuda")
        engines[dev] = eng
    assert out["cuda"] == out["cpu"]
    assert engines["cuda"].spec_stats["rounds"] > 0
    a, b = engines["cuda"], engines["cpu"]
    first = int(np.argmax(a.put([1], [prompts[1]])[0]))
    b.import_kv(1, a.export_kv(1))
    assert b.decode_steps({1: first}, 6)[1] == a.decode_steps({1: first}, 6)[1]
