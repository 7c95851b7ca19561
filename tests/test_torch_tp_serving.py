"""Tensor-parallel serving beyond the Llama flag set, against the JAX
package, on the CPU.

The port's ranks are gloo processes (``tests/torch_ranks.py``, job
``tp_serving_job``), started once for the module at TP 2 and TP 4; the
JAX side runs in the pytest process on the 8 virtual CPU devices of
``tests/conftest.py``, over ``Topology.build_virtual({"model": tp})``.
Every weight is the JAX init perturbed by N(0, 0.05^2) from a numpy seed,
so biases and norm vectors are non-zero: a bias added on every rank's
partial product, or dropped, moves the logits.

* ``partition_specs`` equal JAX's key for key for Llama, GPT-2, OPT,
  GPT-Neo, BERT, an ALiBi set and GPT-MoE; ``shard_params`` ->
  ``gather_params`` is bitwise on the JAX tree and on a model's shards.
* The ragged engine over the OPT and GPT-2 flag sets and GPT-MoE (fp32):
  the logits of every ``put`` within 1e-4 of JAX's TP engine and greedy
  streams identical; every rank routes every MoE token alike (the gate
  inputs and chosen experts bitwise equal on every rank).
* ``put_spec`` rows within 1e-4 and ``generate_speculative`` streams
  identical to JAX's; the hand-offs TP 2 -> one device and back over
  fp32, bf16 and int8 pools: each export re-exported bitwise by its
  importer, the TP export's pages within 1e-5 of JAX's TP export, and
  the continued streams equal to the uninterrupted one; prefix export /
  import (re-exported bitwise) and a cold-tier re-admission.
* v1 ``init_inference(tensor_parallel=2)`` over BERT (MLM logits), an
  ALiBi set, a parallel-residual set and OPT, int8 and int4 weights at
  group 64, where shards straddle blocks (an untied ``lm_head`` of 96
  columns: 48 a rank, re-blocked at 16): tokens identical to JAX's TP
  engine (BERT's logits within 1e-4); each rank's dequantized shards
  bitwise the slice of the one-device engine's dequantized leaves, and
  JAX's dequantized TP tree wherever the two packages' scales agree (JAX
  quantizes under jit, where XLA's scale is absmax x fp32(1 / qmax), at
  most one ulp from the port's IEEE division; tests/test_torch_inference.py).
* An indivisible vocab raises in both packages; indivisible heads raise
  in the port and are resharded by GSPMD in JAX's v1 engine.
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
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.models.moe import (MoETransformer as JaxMoE,
                                      MoETransformerConfig as JaxMoEConfig)
from deepspeed_tpu.models.transformer import (Transformer as JaxTransformer,
                                              TransformerConfig as JaxConfig)
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu_torch.checkpoint.jax_params import (export_params,
                                                       gather_params,
                                                       shard_params)
from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                  RaggedInferenceEngine)
from deepspeed_tpu_torch.models import gpt2, llama
from deepspeed_tpu_torch.models.moe import (MoETransformer,
                                            MoETransformerConfig)
from deepspeed_tpu_torch.models.transformer import (Transformer,
                                                    TransformerConfig)
from deepspeed_tpu_torch.parallel.mesh import PartitionSpec, Topology
from torch_ranks import drive_puts, start_ranks

BASE = dict(d_model=64, n_heads=4, n_layers=2, vocab_size=96,
            max_seq_len=64, remat=False, use_flash=False)
LAYER_NORM = dict(norm="layer", use_bias=True, norm_eps=1e-5)
OPT = dict(BASE, **LAYER_NORM, activation="relu", position="learned",
           tie_embeddings=True)
GPT2 = dict(BASE, **LAYER_NORM, activation="gelu", position="learned",
            tie_embeddings=True)
MOE = dict(GPT2, n_experts=4, top_k=2)
BERT = dict(BASE, norm="layer", activation="gelu_exact", position="learned",
            causal=False, prenorm=False, embed_norm=True, type_vocab_size=2,
            mlm_head=True, pooler=True, tie_embeddings=True, use_bias=True,
            norm_eps=1e-12)
ALIBI = dict(BASE, **LAYER_NORM, activation="gelu", position="alibi",
             embed_norm=True, tie_embeddings=False)
PARALLEL = dict(BASE, **LAYER_NORM, activation="gelu", position="rope",
                rope_pct=0.25, rope_interleaved=True, parallel_residual=True,
                tie_embeddings=False, qkv_bias=False, attn_o_bias=False)
CFG = dict(token_budget=64, max_seqs=4, kv_block_size=16, n_kv_blocks=64,
           max_context=64)
QUANT = {"int8": {"enabled": True, "bits": 8, "group_size": 64},
         "int4": {"enabled": True, "bits": 4, "group_size": 64}}
LOGIT_TOL = 1e-4
PAGE_TOL = 1e-5
N_DECODE = 3
NEW = 6


def _prompts(seed, *lengths):
    rng = np.random.default_rng(seed)
    return {i + 1: rng.integers(1, 96, (n,)).tolist()
            for i, n in enumerate(lengths)}


SPEC = {"prompts": {5: [7, 8, 9, 7, 8, 9, 7, 8], 6: [3, 4, 5, 6, 3, 4, 5]},
        "drafts": [[8, 9, 7], [7]]}
HANDOFF = _prompts(31, 21)[1]
PREFIX = _prompts(32, 40)[1]          # two full pages and 8 tokens
V1_IDS = np.random.default_rng(33).integers(1, 96, (2, 7)).astype(np.int32)


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape))
        .astype(np.float32), params)


def _config(family, kw):
    return (MoETransformerConfig if family == "moe"
            else TransformerConfig)(**kw)


def _port_model(family, config, seed=0):
    cls = MoETransformer if family == "moe" else Transformer
    return cls(config, device="cpu", seed=seed)


def _jax_model(family, kw):
    if family == "moe":
        return JaxMoE(JaxMoEConfig(**kw))
    return JaxTransformer(JaxConfig(**kw))


def _case(family, kw, seed, **extra):
    """A flag set's weights in the JAX layout: the port's seeded init
    (the JAX scheme) perturbed from a numpy seed, so no bias is zero and
    no norm weight one."""
    model = _port_model(family, _config(family, kw), seed)
    params = _perturbed(export_params(model), seed)
    return {"family": family, "config": kw, "params": params, **extra}


def _ragged(family, kw, seed, prompts, **extra):
    return _case(family, kw, seed, cfg=CFG, prompts=prompts,
                 n_decode=N_DECODE, new=NEW, **extra)


def _v1(family, kw, seed, quant, **extra):
    engine = {"tensor_parallel": 2, "dtype": "float32", "temperature": 0.0,
              "quant": QUANT[quant]}
    return _case(family, kw, seed, ids=V1_IDS, new=NEW, engine=engine,
                 **extra)


@pytest.fixture(scope="module")
def ranks():
    ragged = {
        "opt": _ragged("dense", OPT, 1, _prompts(11, 9, 17), spec=SPEC,
                       handoff=HANDOFF, prefix=PREFIX),
        "gpt2": _ragged("dense", GPT2, 2, _prompts(12, 13, 5)),
        "moe": _ragged("moe", MOE, 3, _prompts(13, 9, 17)),
    }
    v1 = {"bert": _v1("dense", BERT, 4, "int8", forward=True),
          "alibi": _v1("dense", ALIBI, 5, "int8"),
          "parallel": _v1("dense", PARALLEL, 6, "int4", cut=True),
          "opt": _v1("dense", OPT, 7, "int8")}
    tp4 = {name: {k: v for k, v in ragged[name].items()
                  if k not in ("spec", "handoff", "prefix")}
           for name in ("opt", "moe")}
    procs = {"tp2": start_ranks(2, "tp_serving_job",
                                {"ragged": ragged, "v1": v1}, timeout=300),
             "tp4": start_ranks(4, "tp_serving_job", {"ragged": tp4},
                                timeout=300)}
    box = {}

    def results(name):
        if name not in box:
            box[name] = procs[name].results()
        return box[name]

    yield ragged, v1, results
    for p in procs.values():
        p.kill()


_ENGINES = {}


def _jax_ragged(case, tp, **cfg):
    """JAX's TP engine of ``case`` (built once per module and config)."""
    key = (id(case), tp, tuple(sorted(cfg.items())))
    if key not in _ENGINES:
        jmesh.reset_topology()
        _ENGINES[key] = JaxRaggedEngine(
            _jax_model(case["family"], case["config"]),
            JaxRaggedConfig(dtype=jnp.float32, **{**case["cfg"], **cfg}),
            params=case["params"],
            topology=jmesh.Topology.build_virtual({"model": tp}))
    return _ENGINES[key]


def _assert_rows_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        assert (np.isnan(g) == np.isnan(w)).all()
        ok = ~np.isnan(w)
        np.testing.assert_allclose(g[ok], w[ok], rtol=0, atol=LOGIT_TOL)


# ------------------------------------------------------------ placement

SPEC_SETS = {
    "llama": ("dense", lambda: jax_llama.llama_config("tiny", **BASE),
              lambda: llama.llama_config("tiny", **BASE)),
    "gpt2": ("dense", lambda: jax_gpt2.gpt2_config("tiny", **BASE),
             lambda: gpt2.gpt2_config("tiny", **BASE)),
    "opt": ("dense", lambda: jax_gpt2.opt_config("125m", **BASE),
            lambda: gpt2.opt_config("125m", **BASE)),
    "gpt_neo": ("dense", lambda: jax_gpt2.gpt_neo_config(
        "tiny", **{**BASE, "attn_windows": (0, 4)}),
        lambda: gpt2.gpt_neo_config("tiny", **{**BASE,
                                               "attn_windows": (0, 4)})),
    "bert": ("dense", lambda: JaxConfig(**BERT),
             lambda: TransformerConfig(**BERT)),
    "alibi": ("dense", lambda: JaxConfig(**ALIBI),
              lambda: TransformerConfig(**ALIBI)),
    "moe": ("moe", lambda: JaxMoEConfig(**MOE),
            lambda: MoETransformerConfig(**MOE)),
    "moe_glu": ("moe", lambda: JaxMoEConfig(**{**BASE, "n_experts": 4}),
                lambda: MoETransformerConfig(**{**BASE, "n_experts": 4})),
}




@pytest.mark.parametrize("name", list(SPEC_SETS))
def test_partition_specs_equal_jax_key_for_key(name):
    family, jc, tc = SPEC_SETS[name]
    jm = JaxMoE(jc()) if family == "moe" else JaxTransformer(jc())
    jspecs = jm.partition_specs({})
    tspecs = _port_model(family, tc()).partition_specs()
    assert set(tspecs) == set(jspecs)
    assert set(tspecs["layers"]) == set(jspecs["layers"])
    for key, spec in tspecs.items():
        if key == "layers":
            for leaf, sp in spec.items():
                assert isinstance(sp, PartitionSpec)
                assert tuple(sp) == tuple(jspecs["layers"][leaf]), leaf
        else:
            assert tuple(spec) == tuple(jspecs[key]), key
    # an ingested GPT-J tree's head bias follows the head, as JAX's
    if not tc().tie_embeddings:
        assert tuple(_port_model(family, tc()).partition_specs(
            {"lm_head_b": None})["lm_head_b"]) == ("model",)


def _rank_topo(tp, rank):
    topo = Topology({"model": tp}, {})
    topo.rank = lambda axis: rank
    return topo


def _tree_equal(a, b):
    assert set(a) == set(b)
    for key, leaf in a.items():
        if isinstance(leaf, dict):
            _tree_equal(leaf, b[key])
        else:
            np.testing.assert_array_equal(leaf, b[key])


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name,kw", [("bert", BERT), ("alibi", ALIBI),
                                     ("moe", MOE)])
def test_shard_then_gather_is_bitwise(tp, name, kw):
    family = "moe" if name == "moe" else "dense"
    params = _case(family, kw, 8)["params"]
    model = _port_model(family, _config(family, kw))
    shards = [shard_params(params, _rank_topo(tp, r), model=model)
              for r in range(tp)]
    if family == "moe":
        assert shards[1]["layers"]["w_up"].shape == (2, 4, 64, 256 // tp)
        assert shards[1]["layers"]["b_down"].shape == (2, 4, 64)
    else:
        assert shards[1]["layers"]["bq"].shape == (2, 64 // tp)
    _tree_equal(gather_params(shards, model), params)


def test_sharded_models_gather_to_the_jax_tree(ranks):
    ragged, _, results = ranks
    for run, names in (("tp2", ("opt", "gpt2", "moe")), ("tp4", ("opt",
                                                                 "moe"))):
        got = results(run)
        for name in names:
            case = ragged[name]
            model = _port_model(case["family"],
                                _config(case["family"], case["config"]))
            _tree_equal(gather_params([r["shards"][name] for r in got],
                                      model), case["params"])


# --------------------------------------------------------- ragged engine

@pytest.mark.parametrize("tp,name", [(2, "opt"), (2, "gpt2"), (2, "moe"),
                                     (4, "opt"), (4, "moe")])
def test_ragged_tp_matches_jax(ranks, tp, name):
    ragged, _, results = ranks
    case = ragged[name]
    got = results(f"tp{tp}")
    eng = _jax_ragged(case, tp)
    _assert_rows_close(got[0][name]["rows"],
                       drive_puts(eng, case["prompts"], N_DECODE))
    assert got[0][name]["streams"] == eng.generate(
        dict(case["prompts"]), max_new_tokens=NEW)
    assert all(r[name]["stop"] == 1 and r[name]["core"] > N_DECODE
               for r in got[1:])
    if name == "moe":
        # every rank routed every token alike, in the same calls
        routes = [r["moe_routes"] for r in got]
        assert len(routes[0]) > 2 * N_DECODE
        assert all(r == routes[0] for r in routes[1:])


def test_put_spec_and_speculative_streams_match_jax(ranks):
    ragged, _, results = ranks
    case = ragged["opt"]
    ctrl = results("tp2")[0]["opt"]
    eng = _jax_ragged(case, 2)
    prompts = case["spec"]["prompts"]
    assert ctrl["spec"] == eng.generate(dict(prompts), max_new_tokens=NEW)
    assert ctrl["spec_stats"]["accepted"] > 0
    uids = list(prompts)
    rows = eng.put(uids, list(prompts.values()))
    toks = [[int(np.argmax(r))] for r in rows]
    out, verified = eng.put_spec(uids, toks, case["spec"]["drafts"])
    eng.flush(uids)
    got = ctrl["put_spec"]
    _assert_rows_close(got["out"], np.asarray(out))
    assert set(got["verified"]) == set(verified) == set(uids)
    for u, (chain, r) in verified.items():
        assert got["verified"][u][0] == list(chain)
        _assert_rows_close(got["verified"][u][1], np.asarray(r))


@pytest.mark.parametrize("pool", ["fp32", "bf16", "int8"])
def test_handoffs_between_tp_and_one_device(ranks, pool):
    ragged, _, results = ranks
    case = ragged["opt"]
    got = results("tp2")
    ctrl = got[0][f"handoff_{pool}"]
    assert got[1][f"handoff_{pool}"]["stop"] == 1
    assert got[1][f"handoff_{pool}"]["write_pages"] == 1
    assert got[1][f"handoff_{pool}"]["gather_pages"] == 2
    for tag in ("to_tp", "from_tp"):
        assert ctrl[tag]["bitwise"], tag
        assert ctrl[tag]["stream"] == ctrl["ref"], tag
    a, b = ctrl["to_tp"]["pages"], ctrl["from_tp"]["pages"]
    assert a.keys() == b.keys() and a["k"].shape[2] == 4   # every KV head
    if pool == "fp32":
        eng = _jax_ragged(case, 2)
        eng.put([1], [HANDOFF])
        want = eng.export_kv(1)
        eng.flush([1])
        np.testing.assert_allclose(b["k"], np.asarray(want.k_pages),
                                   rtol=0, atol=PAGE_TOL)
        np.testing.assert_allclose(b["v"], np.asarray(want.v_pages),
                                   rtol=0, atol=PAGE_TOL)
    if pool == "int8":
        assert {"ks", "vs"} <= set(b)


def test_prefix_export_import_and_cold_readmission(ranks):
    *_, results = ranks
    got = results("tp2")
    p = got[0]["prefix"]
    assert p["checksum"] and p["n_pages"] == 2 and p["adopted"]
    assert p["bitwise"]
    assert p["spills"] >= 2 and p["readmits"] == 1
    assert p["second"] == p["first"]
    # every KV head of both layers' two pages
    assert p["pages"]["k"].shape == (2, 2, 4, 16, 16)
    assert got[1]["prefix"]["stop"] == 1


# ------------------------------------------------------------- v1 engine

_V1 = {}


def _jax_v1(case):
    """JAX's TP 2 v1 engine of ``case``: (tokens or MLM logits, the
    dequantized tree, the stored tree), once per module."""
    if id(case) not in _V1:
        jmesh.reset_topology()
        je = JaxInferenceEngine(_jax_model(case["family"], case["config"]),
                                JaxInferenceConfig(**case["engine"]),
                                params=case["params"])
        assert je.topo.model_parallel_size == 2
        ids = jnp.asarray(case["ids"])
        out = je.forward(ids) if case.get("forward") else \
            je.generate(ids, max_new_tokens=case["new"])
        tree = jax.tree_util.tree_map(np.asarray, je.params)
        _V1[id(case)] = (np.asarray(out), jax.tree_util.tree_map(
            np.asarray, je._dequant_tree(je.params)), tree)
        jmesh.reset_topology()
    return _V1[id(case)]


def _jax_leaf(tree, name, n_layers):
    """The JAX leaf of a port parameter name (a layer's slice of the
    stacked leaf; for a quantized leaf its layer's scales)."""
    parts = name.split(".")
    if parts[0] != "layers":
        return tree[name]
    leaf = tree["layers"][parts[2]]
    if isinstance(leaf, dict):
        return np.split(leaf["s"], n_layers)[int(parts[1])]
    return leaf[int(parts[1])]


@pytest.mark.parametrize("name", ["bert", "alibi", "parallel", "opt"])
def test_v1_tp2_matches_jax_and_dequantized_shards_are_bitwise(ranks, name):
    _, v1, results = ranks
    case = v1[name]
    want, jdeq, jtree = _jax_v1(case)
    got = results("tp2")
    for r in got:
        run = r[f"v1_{name}"]
        if case.get("forward"):
            np.testing.assert_allclose(run["logits"], want, rtol=0,
                                       atol=LOGIT_TOL)
        else:
            np.testing.assert_array_equal(run["ids"], want)
    n = case["config"]["n_layers"]
    qmax = 2.0 ** (case["engine"]["quant"]["bits"] - 1) - 1
    model = _port_model("dense", TransformerConfig(**case["config"]))
    tp1 = got[0][f"v1_{name}"]["deq_tp1"]
    agreed = 0
    for rank, r in enumerate(got):
        run = r[f"v1_{name}"]
        assert set(run["deq"]) == set(tp1)
        model._tp_size, model._tp_rank = 2, rank
        for leaf, arr in run["deq"].items():
            def mine(full):
                return model.local_shard(leaf, torch.from_numpy(
                    np.array(full))).numpy()
            # bitwise the slice of the one-device engine's leaf
            np.testing.assert_array_equal(arr, mine(tp1[leaf]))
            # JAX's: bitwise where its block scale (absmax x fp32(1 /
            # qmax)) equals the port's (absmax / qmax), one ulp of the
            # scale elsewhere
            jarr = mine(_jax_leaf(jdeq, leaf, n))
            parts = leaf.split(".")
            x = case["params"]["layers"][parts[2]][int(parts[1])] \
                if parts[0] == "layers" else case["params"][leaf]
            blocks = torch.from_numpy(np.ascontiguousarray(x)).reshape(-1, 64)
            amax = blocks.abs().amax(dim=1)
            ieee = torch.where(amax == 0, torch.ones_like(amax),
                               amax / torch.tensor(qmax))
            js = _jax_leaf(jtree, leaf, n) if parts[0] == "layers" \
                else jtree[leaf]["s"]
            same = mine(np.repeat(ieee.numpy() == js, 64).reshape(x.shape))
            agreed += int(same.sum())
            np.testing.assert_array_equal(arr[same], jarr[same])
            np.testing.assert_allclose(arr, jarr, rtol=2.5e-7, atol=0)
    assert agreed > 0
    blocks = got[0][f"v1_{name}"]["blocks"]
    # a column shard of 32 splits every block of 64 of wq's rows
    assert blocks["layers.0.wq"] == 32 and blocks["tok_embed"] == 64
    if not case["config"]["tie_embeddings"]:
        # 96 columns, 48 a rank: blocks straddle the shards, kept at 16
        assert blocks["lm_head"] == 16


# ----------------------------------------------------------- refusals

def test_indivisible_vocab_or_heads_raise_as_jax_places_them():
    odd = dict(GPT2, vocab_size=97)
    # JAX: the vocab-sharded embedding cannot be placed over 2 devices
    jmesh.reset_topology()
    jm = _jax_model("dense", odd)
    with pytest.raises(ValueError, match="divisible"):
        JaxRaggedEngine(jm, JaxRaggedConfig(dtype=jnp.float32, **CFG),
                        params=jm.init(jax.random.PRNGKey(0)),
                        topology=jmesh.Topology.build_virtual({"model": 2}))
    jmesh.reset_topology()
    with pytest.raises(ValueError, match="vocab_size 97"):
        RaggedInferenceEngine(Transformer(TransformerConfig(**odd),
                                          device="cpu"),
                              RaggedConfig(**CFG), device="cpu",
                              topology=Topology({"model": 2}, {}))
    # five heads: JAX's v1 engine reshards the 2 x 40 wq columns into
    # heads (GSPMD) and generates; the port raises
    five = dict(GPT2, d_model=80, n_heads=5)
    jm = _jax_model("dense", five)
    je = JaxInferenceEngine(jm, JaxInferenceConfig(
        tensor_parallel=2, dtype="float32", temperature=0.0),
        params=jm.init(jax.random.PRNGKey(0)))
    ids = np.asarray(je.generate(jnp.ones((1, 3), jnp.int32),
                                 max_new_tokens=1))
    assert ids.shape == (1, 4)
    jmesh.reset_topology()
    model = Transformer(TransformerConfig(**five), device="cpu")
    with pytest.raises(ValueError, match="n_heads 5"):
        model.shard_(_rank_topo(2, 0))
