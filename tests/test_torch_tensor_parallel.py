"""Tensor-parallel serving in the port against the JAX package, on the CPU.

The port's ranks are gloo processes (``tests/torch_ranks.py``, jobs
``tp_job`` and ``tp_rank_death_job``): each builds a tiny fp32 Llama, cuts
it to its shard (``shard_params``) and loads the carried JAX weights into
the shard (``load_jax_params``). Group rank 0 is the ragged engine's
controller; the other ranks replay its step records in ``serve_worker``.
The JAX side runs in the pytest process on the 8 virtual CPU devices of
``tests/conftest.py``: the unsharded engine and the engine over
``Topology.build_virtual({"model": tp})``. The ranks start once for the
module and run every case in one job each (TP 2 and TP 4).

* ``partition_specs`` equal JAX's key for key; ``shard_params`` ->
  ``gather_params`` is bitwise, on the JAX tree and on a model's shards.
* The ragged engine at TP 2 on the configs of the JAX package's TP tests:
  fp32, GQA (``n_kv_heads`` 2), windows (32, 32) and an int8 pool, and at
  TP 4: the logits of every ``put`` of a greedy run within 1e-4 of both
  JAX engines', and ``generate``'s greedy streams identical to theirs.
* ``ValueError`` on ``n_kv_heads`` that the model axis does not divide;
  the item-6b operations and ``data`` x ``model`` raise naming the item;
  ``tensor_parallel`` / ``mp_size`` / ``{"tp_size": n}`` parse as JAX's.
* v1 ``init_inference(tensor_parallel=2)`` (plain SPMD): tokens equal to
  JAX's ``InferenceEngine(tensor_parallel=2)`` on the fused (``"pallas"``)
  and reference (``"xla"``) backends; the fused backend takes one
  ``decode_mlp_all_reduce`` a layer per decode step and the reference
  none, as the JAX package's counter test expects (JAX counts at trace
  time, so only its zero / non-zero is compared).
* ``ServingEngine`` over a TP 2 engine: 4 requests' streams equal to the
  JAX ``ServingEngine`` over JAX's TP engine; no leaked block.
* A worker whose process ends mid-run makes the controller raise
  ``RankFailure`` within seconds, and every later step too.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.inference.engine import (
    InferenceConfig as JaxInferenceConfig,
    InferenceEngine as JaxInferenceEngine)
from deepspeed_tpu.inference.ragged import (
    RaggedConfig as JaxRaggedConfig,
    RaggedInferenceEngine as JaxRaggedEngine)
from deepspeed_tpu.models import Llama as JaxLlama
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu.serving import ServingEngine as JaxServingEngine
from deepspeed_tpu.telemetry.registry import (MetricsRegistry as JaxRegistry,
                                              get_registry as jax_registry,
                                              set_registry as jax_set_registry)
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.checkpoint.jax_params import (gather_params,
                                                       shard_params)
from deepspeed_tpu_torch.config import ConfigError
from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                  RaggedInferenceEngine)
from deepspeed_tpu_torch.models.llama import Llama
from deepspeed_tpu_torch.parallel.mesh import PartitionSpec, Topology
from torch_ranks import drive_puts, start_ranks

BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, vocab_size=256,
            max_seq_len=128)
CFG = dict(token_budget=64, max_seqs=4, kv_block_size=16, n_kv_blocks=64,
           max_context=128)
FUSED_OP = "comm/facade/fused/decode_mlp_all_reduce"
LOGIT_TOL = 1e-4


def _prompts(seed, *lengths):
    rng = np.random.default_rng(seed)
    return {i + 1: rng.integers(1, 256, (n,)).tolist()
            for i, n in enumerate(lengths)}


# name -> (model overrides, config overrides, prompts, new tokens, jax seed)
RAGGED = {
    "fp32": ({}, {}, _prompts(12, 9, 17), 8, 3),
    "gqa": ({"n_kv_heads": 2}, {}, _prompts(14, 9, 17), 8, 4),
    "window": ({"attn_windows": (32, 32)}, {}, _prompts(17, 40, 50), 6, 6),
    "int8": ({}, {"kv_quant": "int8"}, _prompts(15, 9, 17), 8, 5),
}
N_DECODE = 5
V1 = dict(BASE, d_ff=128)
V1_IDS = np.arange(1, 9, dtype=np.int32)[None].repeat(4, 0)
V1_NEW = 8
SERVE_PROMPTS = [_prompts(20 + i, n)[1] for i, n in enumerate((9, 45, 20, 3))]


def _jax_model(kw):
    return JaxLlama("tiny", use_flash=False, remat=False, **{**BASE, **kw})


def _numpy(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _ragged_case(name):
    mkw, ckw, prompts, new, seed = RAGGED[name]
    params = _numpy(_jax_model(mkw).init(jax.random.PRNGKey(seed)))
    return {"model": {**BASE, **mkw}, "params": params,
            "cfg": {**CFG, **ckw}, "prompts": prompts, "new": new,
            "n_decode": N_DECODE}


@pytest.fixture(scope="module")
def ranks():
    cases = {name: _ragged_case(name) for name in RAGGED}
    v1_params = _numpy(JaxLlama("tiny", use_flash=False, remat=False,
                                **V1).init(jax.random.PRNGKey(0)))
    v1 = {kb: {"model": V1, "params": v1_params, "ids": V1_IDS,
               "new": V1_NEW,
               "config": {"tensor_parallel": 2, "dtype": "float32",
                          "temperature": 0.0, "kernel_backend": kb}}
          for kb in ("pallas", "xla")}
    serve = {**cases["gqa"], "prompts": SERVE_PROMPTS, "new": 7}
    procs = {
        "tp2": start_ranks(2, "tp_job", {"ragged": cases, "v1": v1,
                                         "serve": serve}, timeout=240),
        "tp4": start_ranks(4, "tp_job", {"ragged": {"fp32": cases["fp32"]}},
                           timeout=240),
        "death": start_ranks(2, "tp_rank_death_job",
                             {**cases["fp32"], "steps": 1}, timeout=240),
    }
    box = {}

    def results(name):
        if name not in box:
            box[name] = procs[name].results()
        return box[name]

    yield cases, v1_params, serve, results
    for p in procs.values():
        p.kill()


def _jax_ragged(case, tp=1):
    jmesh.reset_topology()
    topo = jmesh.Topology.build_virtual({"model": tp}) if tp > 1 else None
    return JaxRaggedEngine(_jax_model(case["model"]),
                           JaxRaggedConfig(dtype=jnp.float32, **case["cfg"]),
                           params=case["params"], topology=topo)


def _assert_rows_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert (np.isnan(g) == np.isnan(w)).all()
        ok = ~np.isnan(w)
        np.testing.assert_allclose(g[ok], w[ok], rtol=0, atol=LOGIT_TOL)


# ------------------------------------------------------------ placement

def test_partition_specs_equal_jax_key_for_key():
    jm = _jax_model({})
    jspecs = jm.partition_specs(jm.init(jax.random.PRNGKey(0)))
    tspecs = Llama("tiny", device="cpu", **BASE).partition_specs()
    assert set(tspecs) == set(jspecs)
    assert set(tspecs["layers"]) == set(jspecs["layers"])
    for key, spec in tspecs.items():
        if key == "layers":
            for leaf, sp in spec.items():
                assert isinstance(sp, PartitionSpec)
                assert tuple(sp) == tuple(jspecs["layers"][leaf]), leaf
        else:
            assert tuple(spec) == tuple(jspecs[key]), key


def _rank_topo(tp, rank):
    topo = Topology({"model": tp}, {})
    topo.rank = lambda axis: rank
    return topo


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_then_gather_is_bitwise(tp):
    params = _ragged_case("gqa")["params"]
    model = Llama("tiny", device="cpu", **{**BASE, "n_kv_heads": 2})
    shards = [shard_params(params, _rank_topo(tp, r), model=model)
              for r in range(tp)]
    assert shards[1]["tok_embed"].shape == (256 // tp, 64)
    assert shards[1]["layers"]["wq"].shape == (2, 64, 64 // tp)
    assert shards[1]["layers"]["w_down"].shape[1] == model.config.d_ff // tp
    full = gather_params(shards, model)
    for path in (("tok_embed",), ("lm_head",), ("final_norm_w",)):
        np.testing.assert_array_equal(full[path[0]], params[path[0]])
    for leaf, arr in params["layers"].items():
        np.testing.assert_array_equal(full["layers"][leaf], arr)


def test_sharded_model_loads_its_slice_of_the_jax_tree(ranks):
    cases, _, _, results = ranks
    shards = [r["shards"] for r in results("tp2")]
    model = Llama("tiny", device="cpu", **BASE)
    full = gather_params(shards, model)
    params = cases["fp32"]["params"]
    for key in ("tok_embed", "lm_head", "final_norm_w"):
        np.testing.assert_array_equal(full[key], params[key])
    for leaf, arr in params["layers"].items():
        np.testing.assert_array_equal(full["layers"][leaf], arr)


# --------------------------------------------------------- ragged engine

@pytest.mark.parametrize("name", list(RAGGED))
def test_ragged_tp2_matches_jax_unsharded_and_tp(ranks, name):
    cases, _, _, results = ranks
    case = cases[name]
    got = results("tp2")
    ctrl, worker = got[0][name], got[1][name]
    for tp in (1, 2):
        eng = _jax_ragged(case, tp)
        want_rows = drive_puts(eng, case["prompts"], N_DECODE)
        want = eng.generate(dict(case["prompts"]), max_new_tokens=case["new"])
        _assert_rows_close(ctrl["rows"], want_rows)
        assert ctrl["streams"] == want, (tp, ctrl["streams"], want)
    assert ctrl["free"] == CFG["n_kv_blocks"]
    # the worker replayed every put and decode chunk and the page copy,
    # then stopped
    assert worker["core"] >= len(ctrl["rows"]) and worker["stop"] == 1
    assert worker["decode"] >= 1 and worker["copy_page"] == 1
    assert ctrl["copied"] and worker["copied"]


def test_ragged_tp4_matches_jax(ranks):
    cases, _, _, results = ranks
    case = cases["fp32"]
    got = results("tp4")
    eng = _jax_ragged(case, 4)
    _assert_rows_close(got[0]["fp32"]["rows"],
                       drive_puts(eng, case["prompts"], N_DECODE))
    assert got[0]["fp32"]["streams"] == eng.generate(
        dict(case["prompts"]), max_new_tokens=case["new"])
    assert all(r["fp32"]["stop"] == 1 for r in got[1:])


def test_indivisible_kv_heads_and_later_items_raise():
    model = Llama("tiny", device="cpu", **{**BASE, "n_kv_heads": 1})
    with pytest.raises(ValueError, match="n_kv_heads"):
        RaggedInferenceEngine(model, RaggedConfig(max_context=128),
                              device="cpu",
                              topology=Topology({"model": 2}, {}))
    with pytest.raises(ConfigError, match="6b"):
        Topology.build({"data": 2, "model": 2})
    with pytest.raises(ConfigError, match="world size"):
        Topology.build({"model": 2})
    with pytest.raises(NotImplementedError, match="6b"):
        init_inference(Llama("tiny", device="cpu", **BASE),
                       {"tensor_parallel": 2, "quant": {"enabled": True}},
                       device="cpu")
    # the item-6b operations of a TP engine, checked before any collective
    eng = RaggedInferenceEngine(Llama("tiny", device="cpu", **BASE),
                                RaggedConfig(max_context=128,
                                             enable_prefix_cache=True),
                                device="cpu")
    eng._tp = 2
    for call in (lambda: eng.put_spec([1], [[1]], [[2]]),
                 lambda: eng.export_kv(1), lambda: eng.import_kv(1, None),
                 lambda: eng.export_prefix([1, 2]),
                 lambda: eng.import_prefix(None),
                 lambda: eng.enable_kv_tier(member="a"),
                 lambda: eng.generate_speculative({1: [1, 2, 3]})):
        with pytest.raises(NotImplementedError, match="6b"):
            call()


@pytest.mark.parametrize("config", [
    {"tensor_parallel": 2}, {"mp_size": 2}, {"tensor_parallel": {"tp_size": 2}},
    {"mp_size": {"tp_size": 2}}])
def test_tensor_parallel_config_keys_parse_as_jax(config):
    from deepspeed_tpu.inference.engine import InferenceConfig as JaxConfig
    from deepspeed_tpu_torch.inference.engine import InferenceConfig

    assert InferenceConfig.from_any(config).tensor_parallel == \
        JaxConfig.from_any(config).tensor_parallel == 2


# ------------------------------------------------------------- v1 engine

def _jax_v1(params, kb):
    old = jax_registry()
    reg = jax_set_registry(JaxRegistry())
    try:
        jmesh.reset_topology()
        eng = JaxInferenceEngine(
            JaxLlama("tiny", use_flash=False, remat=False, **V1),
            JaxInferenceConfig(tensor_parallel=2, dtype="float32",
                               temperature=0.0, kernel_backend=kb),
            params=params)
        assert eng.topo.model_parallel_size == 2
        ids = np.asarray(eng.generate(jnp.asarray(V1_IDS),
                                      max_new_tokens=V1_NEW))
        return ids, reg.counter(FUSED_OP).value
    finally:
        jax_set_registry(old)
        jmesh.reset_topology()


@pytest.mark.parametrize("kb", ["pallas", "xla"])
def test_v1_tp2_tokens_and_fused_counter_match_jax(ranks, kb):
    _, params, _, results = ranks
    want, jax_fused = _jax_v1(params, kb)
    got = results("tp2")
    n_steps = V1_NEW - 1          # the first token comes from the prefill
    for r in got:
        run = r[f"v1_{kb}"]
        np.testing.assert_array_equal(run["ids"], want)
        fused = run["counters"].get(FUSED_OP, 0)
        if kb == "pallas":
            assert run["bound"] and jax_fused >= 1
            assert fused == V1["n_layers"] * n_steps
        else:
            assert not run["bound"] and jax_fused == 0 and fused == 0


# ------------------------------------------------------------ the server

def test_serving_engine_over_tp2_matches_jax_server(ranks):
    _, _, serve, results = ranks
    eng = _jax_ragged(serve, 2)
    jsrv = JaxServingEngine(eng, {"policy": "fcfs"}, start=False)
    jreqs = [jsrv.submit(p, max_new_tokens=serve["new"])
             for p in serve["prompts"]]
    for _ in range(500):
        if all(r.is_terminal for r in jreqs):
            break
        jsrv.step()
    got = results("tp2")
    assert got[0]["serve"]["tokens"] == [r.tokens for r in jreqs]
    assert got[0]["serve"]["states"] == ["finished"] * 4
    assert got[0]["serve"]["leaks"] == []
    assert got[1]["serve"]["stop"] == 1 and got[1]["serve"]["core"] > 7


def test_a_dead_worker_makes_the_controller_raise(ranks):
    *_, results = ranks
    ctrl, worker = results("death")
    assert worker == {"replayed": 1}
    assert ctrl["first"] is not None and "no longer in step" in ctrl["first"]
    assert ctrl["elapsed"] < 30.0
    assert ctrl["second"] is not None and "earlier step failed" in \
        ctrl["second"]
