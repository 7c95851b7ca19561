"""The serving front-end of the PyTorch port, on the CPU.

With manual ``step()`` and the FCFS policy, the port's ``ServingEngine``
emits the same greedy streams as the JAX package's server on the same
weights. The lifecycle (state machine, policies, backpressure, cancel at
every stage, preempt-and-resume, tick-fault retry) is checked with zero
leaked KV blocks, plus one run through the real driver thread. Over
int8 and int4 KV pools (``serving.kv_quant``) the streams stay identical
to the JAX server's, and a declared ``kv_quant`` the engine does not store
is refused at construction.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.inference.ragged import (
    RaggedConfig as JaxRaggedConfig,
    RaggedInferenceEngine as JaxRaggedEngine)
from deepspeed_tpu.models import Llama as JaxLlama
from deepspeed_tpu.serving import ServingEngine as JaxServingEngine
from deepspeed_tpu_torch.checkpoint.jax_params import load_jax_params
from deepspeed_tpu_torch.config import ConfigError, ServingConfig
from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                  RaggedInferenceEngine,
                                                  assert_block_balance)
from deepspeed_tpu_torch.models.llama import Llama
from deepspeed_tpu_torch.resilience.clock import SimClock, get_clock, use_clock
from deepspeed_tpu_torch.serving.request import (InvalidTransition, Request,
                                                 RequestState)
from deepspeed_tpu_torch.serving.scheduler import (FCFSPolicy, SLOPolicy,
                                                   make_policy)
from deepspeed_tpu_torch.serving.server import ServingEngine

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, vocab_size=128,
            max_seq_len=256)
CFG = dict(token_budget=32, max_seqs=4, kv_block_size=8, n_kv_blocks=64,
           max_context=128, enable_prefix_cache=True)


@pytest.fixture(scope="module")
def models():
    jm = JaxLlama("tiny", use_flash=False, remat=False, **TINY)
    params = jm.init(jax.random.PRNGKey(5))
    tm = load_jax_params(Llama("tiny", device="cpu", **TINY),
                         jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


def _engine(models, **kw):
    _, _, tm = models
    return RaggedInferenceEngine(
        tm, RaggedConfig(dtype=torch.float32, **{**CFG, **kw}), device="cpu")


def _jax_engine(models, **kw):
    jm, params, _ = models
    return JaxRaggedEngine(jm, JaxRaggedConfig(dtype=jnp.float32,
                                               **{**CFG, **kw}),
                           params=params)


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(1, 128, n).tolist()


def _tick_until(srv, done, limit=300):
    for _ in range(limit):
        if done():
            return
        srv.step()
    raise AssertionError(f"no progress after {limit} ticks")


def test_fcfs_streams_identical_to_jax_server(models):
    prompts = [_prompt(1, 9), _prompt(2, 45), _prompt(3, 20), _prompt(4, 3),
               _prompt(5, 30), _prompt(6, 12)]          # 6 requests, 4 slots
    jsrv = JaxServingEngine(_jax_engine(models), {"policy": "fcfs"},
                            start=False)
    tsrv = ServingEngine(_engine(models), {"policy": "fcfs"}, start=False,
                         device="cpu")
    jreqs = [jsrv.submit(p, max_new_tokens=7) for p in prompts]
    treqs = [tsrv.submit(p, max_new_tokens=7) for p in prompts]
    ticks = 0
    while not all(r.is_terminal for r in treqs):
        assert tsrv.step() and jsrv.step()
        ticks += 1
        # same admission and the same tokens after every tick
        assert [r.state.value for r in treqs] == \
            [r.state.value for r in jreqs]
        assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert all(r.is_terminal for r in jreqs)
    assert all(r.state is RequestState.FINISHED and len(r.tokens) == 7
               for r in treqs)
    assert ticks > 7                          # long prompts spanned ticks
    assert tsrv.block_leaks() == []


def test_serving_output_matches_direct_engine_with_driver_thread(models):
    p = _prompt(3, 9)
    ref = _engine(models).generate({1: p}, max_new_tokens=6)[1]
    eng = _engine(models)
    with ServingEngine(eng, {"policy": "slo"}, device="cpu") as srv:
        assert srv.submit(p, max_new_tokens=6).result(timeout=60) == ref
        assert list(srv.stream(p, max_new_tokens=6)) == ref
        assert srv.drain(timeout=30)
    assert srv.block_leaks() == []
    assert srv._driver is None


def test_eos_finishes_early(models):
    p = _prompt(3, 9)
    ref = _engine(models).generate({1: p}, max_new_tokens=6)[1]
    eos = ref[2]
    eng = _engine(models)
    srv = ServingEngine(eng, start=False, device="cpu")
    req = srv.submit(p, max_new_tokens=6, eos_token_id=eos)
    _tick_until(srv, lambda: req.is_terminal)
    assert req.result() == ref[:ref.index(eos) + 1]
    assert_block_balance(eng)


def test_rejections(models):
    eng = _engine(models, n_kv_blocks=8)
    srv = ServingEngine(eng, {"max_queue": 2}, start=False, device="cpu")
    a, b, c = (srv.submit(_prompt(i, 5), max_new_tokens=4) for i in range(3))
    assert c.state is RequestState.REJECTED and "queue full" in c.error
    big = srv.submit(_prompt(9, 100), max_new_tokens=40)
    assert big.state is RequestState.REJECTED and "max_context" in big.error
    pool = srv.submit(_prompt(9, 70), max_new_tokens=10)
    assert pool.state is RequestState.REJECTED and "KV pool" in pool.error
    srv.drain(timeout=0.0, reject_queued=True)
    assert a.state is b.state is RequestState.REJECTED
    late = srv.submit(_prompt(8, 5))
    assert late.state is RequestState.REJECTED and "closed" in late.error


def test_cancel_at_every_stage_leaks_nothing(models):
    eng = _engine(models)
    srv = ServingEngine(eng, start=False, device="cpu")
    queued = srv.submit(_prompt(0, 6), max_new_tokens=4)
    assert srv.cancel(queued) and queued.state is RequestState.CANCELLED
    assert srv.cancel(queued) is False
    prefill = srv.submit(_prompt(1, 50), max_new_tokens=4)
    srv.step()
    assert prefill.state is RequestState.PREFILL
    assert eng.seqs[prefill.uid].pending > 0
    srv.cancel(prefill)
    srv.step()
    assert prefill.state is RequestState.CANCELLED
    decode = srv.submit(_prompt(2, 8), max_new_tokens=32)
    _tick_until(srv, lambda: len(decode.tokens) >= 3)
    assert srv.cancel(decode.uid) is True
    srv.step()
    assert decode.state is RequestState.CANCELLED and len(decode.tokens) >= 3
    assert srv.live_requests == 0 and srv.queue_depth == 0
    assert_block_balance(eng)


def test_preempt_then_resume_bit_exact(models):
    p_low, p_high = _prompt(10, 9), _prompt(11, 8)
    ref = _engine(models).generate({1: p_low}, max_new_tokens=8)[1]
    eng = _engine(models, max_seqs=1)
    srv = ServingEngine(eng, {"policy": "slo", "kv_pressure": 0.0},
                        start=False, device="cpu")
    low = srv.submit(p_low, max_new_tokens=8, priority=0)
    _tick_until(srv, lambda: len(low.tokens) >= 3)
    high = srv.submit(p_high, max_new_tokens=4, priority=5)
    srv.step()                               # admission preempts `low`
    assert low.state is RequestState.QUEUED and low.preemptions == 1
    _tick_until(srv, lambda: high.is_terminal and low.is_terminal)
    assert low.tokens == ref                 # identical greedy continuation
    assert eng.prefix_cache.hits >= 1        # resume rode cached KV pages
    assert low.uid not in eng._resume_uids
    assert_block_balance(eng)


def test_tick_fault_retries_bit_exact_then_fails_when_spent(models):
    p = _prompt(20, 8)
    ref = _engine(models).generate({1: p}, max_new_tokens=6)[1]
    eng = _engine(models)
    srv = ServingEngine(eng, {"tick_retry_limit": 1}, start=False,
                        device="cpu")
    real_put, calls = eng.put, [0]

    def flaky_put(uids, toks):
        calls[0] += 1
        if calls[0] == 3:
            raise RuntimeError("injected device fault")
        return real_put(uids, toks)

    eng.put = flaky_put
    req = srv.submit(p, max_new_tokens=6)
    _tick_until(srv, lambda: req.is_terminal)
    assert req.retries == 1 and req.result() == ref
    assert_block_balance(eng)

    def dead_put(uids, toks):
        raise RuntimeError("injected device fault")

    eng.put = dead_put
    req = srv.submit(p, max_new_tokens=6)
    _tick_until(srv, lambda: req.is_terminal, limit=10)
    assert req.state is RequestState.CANCELLED and "tick fault" in req.error
    assert req.retries == 2
    assert_block_balance(eng)


def test_request_state_machine():
    r = Request(prompt=[1, 2])
    for s in (RequestState.PREFILL, RequestState.DECODE, RequestState.QUEUED,
              RequestState.PREFILL, RequestState.DECODE,
              RequestState.FINISHED):
        r.transition(s)
    assert r.is_terminal and r.t_finish is not None
    with pytest.raises(InvalidTransition):
        r.transition(RequestState.DECODE)
    with pytest.raises(InvalidTransition):
        Request(prompt=[1]).transition(RequestState.FINISHED)
    with pytest.raises(ValueError):
        Request(prompt=[])
    with pytest.raises(ValueError):
        Request(prompt=[1], max_new_tokens=0)


def test_policies_and_slo_judgment():
    with use_clock(SimClock()) as clk:
        reqs = [Request(prompt=[1], priority=p, deadline_s=d)
                for p, d in ((0, 5.0), (2, 9.0), (2, 1.0), (1, None))]
        for i, r in enumerate(reqs):
            r.t_submit = float(i)
        slo = SLOPolicy()
        assert [r.priority for r in slo.admission_order(reqs, 0.0)] == \
            [2, 2, 1, 0]
        assert slo.admission_order(reqs, 0.0)[0] is reqs[2]   # EDF in tier
        assert slo.should_reject(reqs[2], 10.0) == "deadline expired in queue"
        fcfs = FCFSPolicy()
        assert fcfs.admission_order(reqs[::-1], 0.0) == reqs
        assert fcfs.should_reject(reqs[2], 99.0) is None
        clk.advance(4.0)
        assert reqs[2].in_slo() is False and reqs[3].in_slo() is None
    assert isinstance(make_policy("fcfs"), FCFSPolicy)
    with pytest.raises(ValueError):
        make_policy("lifo")
    assert get_clock().now() > 0


def test_serving_config():
    c = ServingConfig.from_dict({"policy": "fcfs", "max_queue": 3,
                                 "speculative": False, "kv_quant": "none"})
    assert (c.policy, c.max_queue) == ("fcfs", 3)
    with pytest.raises(ConfigError):
        ServingConfig.from_dict({"policy": "lifo"})
    with pytest.raises(ConfigError):
        ServingConfig.from_dict({"kv_pressure": 2.0})
    # the replica's keys are ported; the fleet's blocks still raise
    c = ServingConfig.from_dict({"model_version": 1,
                                 "kv_tier": {"enabled": True},
                                 "stuck_tick_timeout_s": 0.5,
                                 "stuck_tick_escalate_polls": 2})
    assert (c.model_version, c.kv_tier.enabled, c.stuck_tick_timeout_s,
            c.stuck_tick_escalate_polls) == (1, True, 0.5, 2)
    assert ServingConfig().stuck_tick_timeout_s == 30.0
    with pytest.raises(ConfigError, match="model_version"):
        ServingConfig.from_dict({"model_version": -1})
    for key, val in (("fleet", {"n": 2}), ("region", {"cells": 2}),
                     ("rollout", {"warmup_ticks": 3})):
        with pytest.raises(NotImplementedError, match="later slice.*item 5"):
            ServingConfig.from_dict({key: val})
    # speculative serving is ported (tests/test_torch_spec.py)
    assert ServingConfig.from_dict({"speculative": True}).speculative
    assert ServingConfig.from_dict({"kv_quant": "int4"}).kv_quant == "int4"
    assert ServingConfig().kv_quant == "none"
    with pytest.raises(ConfigError, match="kv_quant"):
        ServingConfig.from_dict({"kv_quant": "fp8"})


@pytest.mark.parametrize("kv_quant", ["int8", "int4"])
def test_quantized_pool_streams_identical_to_jax_server(models, kv_quant):
    prompts = [_prompt(1, 9), _prompt(2, 45), _prompt(3, 20), _prompt(4, 3),
               _prompt(5, 30)]
    cfg = {"policy": "fcfs", "kv_quant": kv_quant}
    jsrv = JaxServingEngine(_jax_engine(models, kv_quant=kv_quant), cfg,
                            start=False)
    tsrv = ServingEngine(_engine(models, kv_quant=kv_quant), cfg,
                         start=False, device="cpu")
    jreqs = [jsrv.submit(p, max_new_tokens=6) for p in prompts]
    treqs = [tsrv.submit(p, max_new_tokens=6) for p in prompts]
    _tick_until(tsrv, lambda: all(r.is_terminal for r in treqs))
    _tick_until(jsrv, lambda: all(r.is_terminal for r in jreqs))
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert all(r.state is RequestState.FINISHED for r in treqs)
    assert tsrv.block_leaks() == []


def test_declared_kv_quant_must_match_the_engine(models):
    for want, have in (("int8", "none"), ("int4", "int8")):
        with pytest.raises(ValueError, match="kv_quant"):
            ServingEngine(_engine(models, kv_quant=have),
                          {"kv_quant": want}, start=False, device="cpu")
        with pytest.raises(ValueError, match="kv_quant"):
            JaxServingEngine(_jax_engine(models, kv_quant=have),
                             {"kv_quant": want}, start=False)
    # "none" declares nothing: any engine is taken
    ServingEngine(_engine(models, kv_quant="int8"), {"kv_quant": "none"},
                  start=False, device="cpu")


def test_server_and_engine_devices_must_agree(models):
    eng = _engine(models)
    with pytest.raises(ValueError, match="device"):
        ServingEngine(eng, start=False, device="meta")


@pytest.mark.gpu
def test_cuda_server_streams_match_cpu_server():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(TINY, d_model=128, n_heads=2, n_kv_heads=1)
    prompts = [_prompt(80 + i, n) for i, n in enumerate((9, 45, 20, 3, 30))]
    cpu_model = Llama("tiny", device="cpu", seed=4, **kw)
    cuda_model = Llama("tiny", device="cuda", **kw)
    cuda_model.load_state_dict(cpu_model.state_dict())   # one set of weights
    out = {}
    for dev, model in (("cuda", cuda_model), ("cpu", cpu_model)):
        eng = RaggedInferenceEngine(
            model, RaggedConfig(dtype=torch.float32, **CFG), device=dev)
        with ServingEngine(eng, {"policy": "fcfs"}, device=dev) as srv:
            reqs = [srv.submit(p, max_new_tokens=8) for p in prompts]
            out[dev] = [r.result(timeout=120) for r in reqs]
        assert srv.block_leaks() == []
    assert out["cuda"] == out["cpu"]
