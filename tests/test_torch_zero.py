"""ZeRO stages 1-3 over the ``data`` ranks, the PyTorch port against the
JAX package, on the CPU, at tiny sizes in fp32.

The port's ranks are gloo processes (``tests/torch_ranks.py``, job
``zero_train_job``), started once for the module at 2 and at 4 ranks; the
JAX side runs in the pytest process on the virtual CPU devices of
``tests/conftest.py``, its ``initialize`` over
``Topology.build_virtual({"data": D})``. The families and their weights
are ``tests/test_torch_tp_train.py``'s (Llama, the OPT flag set, BERT MLM
with a loss mask whose count differs by row, CLIP, GPT-MoE on the
capacity route), with ``train_batch_size`` 8 so that every rank of 4
takes one row of each micro-batch.

Runs: stage 0, 1, 2, 2 with ``zero_quantized_gradients`` (qgZ), 3 with
``stage3_param_persistence_threshold`` 0 and 3 with its default, on 2
ranks (stages 1, 2 and 3 on 4 for Llama and MoE, and qgZ for Llama;
stage 3 with qgZ for Llama on 2);
stage 3 on ``SequentialBlockModel`` under a custom ``loss_fn`` and under
``overlap="off"`` (the JAX facade path, off the staged schedule). The
qgZ cases take the plain attention in both packages: JAX's facade
shard_map cannot hold its flash kernel's own.
Without qgZ the JAX stages differ in placement only (the JAX package's
``tests/test_engine.py::test_zero_stages_numerically_equivalent``), so
each family's dense runs are held to one JAX run at stage 3 on 2 ranks;
qgZ is held to JAX's run of its stage with qgZ on the same number of
ranks.

Tolerances: losses within 1e-5 and grad norms within 1e-4 relative;
masters (gathered whole) within 1e-5 except Adam's near-eps elements,
which ``tests/torch_train_parity.py``'s ``assert_weights`` names
(|g| < 1e-7 at some step, fewer than 1e-4 of all, within 2 lr a step).
qgZ takes the compressed facade's rules of
``tests/test_torch_fused_collectives.py``: losses within 1e-4, weights
within 1e-5 except at most 1 in 200, each within 2 lr a step. Also:
every rank reports the same steps and (stages 1-2) holds bitwise equal
masters; each run's ``eval_batch`` after the steps is within 1e-5 of a
stage-0 engine's on the run's trained masters; stage 1 is bitwise equal to stage 0 (clipping on: its norm is
taken over the same whole gradients); the layout (masters whole and
moments cut at stages 1-2, masters cut at stage 3) and the specs equal
JAX's ``param_spec`` / ``state_spec`` / ``grad_shardings`` key for key;
a stage-3 step books one gather of the top-level leaves and two of each
layer (forward and remat replay) and one reduce-scatter each.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import deepspeed_tpu
from deepspeed_tpu.config import ZeroConfig as JaxZeroConfig
from deepspeed_tpu.models import clip as jax_clip
from deepspeed_tpu.models.moe import (MoETransformer as JaxMoE,
                                      MoETransformerConfig as JaxMoEConfig)
from deepspeed_tpu.models.transformer import (Transformer as JaxTransformer,
                                              TransformerConfig as JaxConfig)
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu.parallel.zero import (SequentialBlockModel as JaxBlocks,
                                         ZeroShardingRules as JaxRules)
from deepspeed_tpu_torch.checkpoint.jax_params import export_params
from deepspeed_tpu_torch.config import ZeroConfig
from deepspeed_tpu_torch.parallel.mesh import Topology
from deepspeed_tpu_torch.parallel.zero import (SequentialBlockModel,
                                               ZeroShardingRules,
                                               stack_counts)

from test_torch_tp_train import (PIXELS, SLOW, TEXT, VISION, _jax_model,
                                 _perturbed, _port_model)
from torch_ranks import start_ranks
from torch_train_parity import assert_weights, flat_jax

FAMILIES = ("llama", "opt", "bert", "clip", "moe")
ROWS = 8
CFG = {**SLOW, "train_batch_size": ROWS}
ZERO = {
    "s0": {"zero_optimization": {"stage": 0}},
    "s1": {"zero_optimization": {"stage": 1}},
    "s2": {"zero_optimization": {"stage": 2}},
    "s2q": {"zero_optimization": {"stage": 2,
                                  "zero_quantized_gradients": True}},
    "s3": {"zero_optimization": {"stage": 3,
                                 "stage3_param_persistence_threshold": 0}},
    "s3p": {"zero_optimization": {"stage": 3}},
}
QGZ3 = {"zero_optimization": {"stage": 3, "zero_quantized_gradients": True,
                               "stage3_param_persistence_threshold": 0}}
WIDE = {2: list(ZERO), 4: ["s1", "s2", "s3"]}
WIDE_FAMILIES = {2: FAMILIES, 4: ("llama", "moe")}
WIDE_QGZ = "llama"      # qgZ on 4 ranks
BLOCK_DIMS = (16, 32, 24, 8)
BLOCK_RUNS = {
    "custom_loss": ("blocks_custom", ZERO["s3"]),
    "overlap_off": ("blocks", {**ZERO["s3"],
                               "comm_compression": {"overlap": "off"}})}


def _batch(name, seed, rows=ROWS):
    rng = np.random.default_rng(seed)
    if name == "clip":
        toks = rng.integers(1, 90, (rows, 16))
        toks[np.arange(rows), rng.integers(4, 16, rows)] = 95
        return {"input_ids": toks.astype(np.int32),
                "pixel_values": rng.standard_normal(
                    (rows, 3, 32, 32)).astype(np.float32)}
    if name == "bert":
        lens = rng.integers(8, 17, rows)
        real = np.arange(16)[None, :] < lens[:, None]
        pick = (rng.random((rows, 16)) < 0.15) & real
        pick[:, 1] = True
        return {"input_ids": rng.integers(0, 96, (rows, 16)).astype(np.int32),
                "labels": rng.integers(0, 96, (rows, 16)).astype(np.int32),
                "loss_mask": pick.astype(np.float32),
                "attention_mask": real.astype(np.int32),
                "token_type_ids": ((np.arange(16)[None, :]
                                    >= lens[:, None] // 2)
                                   & real).astype(np.int32)}
    return {"input_ids": rng.integers(0, 96, (rows, 16)).astype(np.int32)}


def _case(name, seed, flash=True):
    """A family's case; ``flash=False`` for qgZ (the module docstring).
    """
    model = _port_model(name)
    params = _perturbed(export_params(model), np.random.default_rng(seed))
    config = dataclasses.asdict(model.config) if name != "clip" else \
        {"text": TEXT, "vision": VISION, "pixels": PIXELS}
    if not flash:
        if name == "clip":
            config = {**config, "text": {**TEXT, "use_flash": False},
                      "vision": {**VISION, "use_flash": False}}
        else:
            config = {**config, "use_flash": False}
    family = name if name in ("clip", "moe") else "dense"
    return {"family": family, "config": config, "params": params,
            "cfg": CFG, "batches": [_batch(name, 60 + seed)] * 3}


def _block_case(custom: bool):
    rng = np.random.default_rng(5)
    batch = {"x": rng.normal(size=(ROWS, BLOCK_DIMS[0])).astype(np.float32),
             "y": rng.normal(size=(ROWS, BLOCK_DIMS[-1])).astype(np.float32)}
    return {"family": "blocks", "dims": BLOCK_DIMS, "custom_loss": custom,
            "params": _block_params(), "cfg": CFG, "batches": [batch] * 3}


def _cases():
    cases = {name: _case(name, i) for i, name in enumerate(FAMILIES)}
    cases.update({f"{name}+q": _case(name, i, flash=False)
                  for i, name in enumerate(FAMILIES)})
    cases["blocks"] = _block_case(False)
    cases["blocks_custom"] = _block_case(True)
    return cases


def _runs(world):
    runs = {f"{name}/{z}": (name + "+q" * (z == "s2q"), ZERO[z])
            for name in WIDE_FAMILIES[world] for z in WIDE[world]}
    if world == 2:
        runs.update(BLOCK_RUNS)
        runs["llama/s3q"] = ("llama+q", QGZ3)
    else:
        runs[f"{WIDE_QGZ}/s2q"] = (WIDE_QGZ + "+q", ZERO["s2q"])
    return runs


@pytest.fixture(scope="module")
def ranks():
    cases = _cases()
    procs = {w: start_ranks(w, "zero_train_job", cases, _runs(w),
                            timeout=400) for w in (2, 4)}
    # the JAX references, while the ranks run
    for world in (2, 4):
        for key in _runs(world):
            _reference(key, cases, world)
    box = {}

    def results(world):
        if world not in box:
            box[world] = procs[world].results()
        return box[world]

    yield cases, results
    for p in procs.values():
        p.kill()


_JAX = {}


def _jax_model_of(case):
    kw = case["config"]
    if case["family"] == "clip":
        return jax_clip.CLIP(jax_clip.CLIPConfig(
            jax_clip.clip_text_config(**kw["text"]),
            jax_clip.clip_vision_config(**kw["vision"]), **kw["pixels"]))
    if case["family"] == "moe":
        return JaxMoE(JaxMoEConfig(**kw))
    return JaxTransformer(JaxConfig(**kw))


def _jax_run(name, case, zero, world):
    """JAX's ``initialize`` over ``{"data": world}`` on the case's weights
    and batches: (per-step metrics, final weights by port name)."""
    key = (name, str(zero), world)
    if key not in _JAX:
        jmesh.reset_topology()
        cfg = {**case["cfg"], **zero, "mesh": {"data": world}}
        if case["family"] == "blocks":
            model = JaxBlocks(case["dims"])
            params = jax.tree_util.tree_map(jnp.asarray, case["params"])
            kw = {}
            if case.get("custom_loss"):
                kw["loss_fn"] = lambda p, b, r: model.loss(p, b, r)
        else:
            model = _jax_model_of(case)
            params = jax.tree_util.tree_map(jnp.asarray, case["params"])
            kw = {}
        eng, *_ = deepspeed_tpu.initialize(
            model=model, params=params, config=cfg,
            topology=jmesh.Topology.build_virtual({"data": world}), **kw)
        steps = [{k: float(np.asarray(v)) for k, v in eng.train_batch(
            {k: jnp.asarray(v) for k, v in b.items()}).items()}
            for b in case["batches"]]
        weights = jax.tree_util.tree_map(np.asarray, eng.params)
        if case["family"] == "blocks":
            weights = {f"{blk}.{leaf}": v for blk, leaves in weights.items()
                       for leaf, v in leaves.items()}
        else:
            weights = flat_jax(weights)
        jmesh.reset_topology()
        _JAX[key] = (steps, weights)
    return _JAX[key]


def _reference(key, cases, world):
    """(the case, its ZeRO config name, the JAX run) that the port's run
    ``key`` is held to (the module docstring)."""
    if key in BLOCK_RUNS:
        name, zero = BLOCK_RUNS[key]
        return cases[name], "s3", _jax_run(name, cases[name], zero, 2)
    name, z = key.split("/")
    if z in ("s2q", "s3q"):
        case = cases[name + "+q"]
        zero = ZERO["s2q"] if z == "s2q" else QGZ3
        return case, z, _jax_run(name + "+q", case, zero, world)
    return cases[name], z, _jax_run(name, cases[name], ZERO["s3"], 2)


def _assert_steps(got, ref, loss_rtol=1e-5):
    for t, r in zip(got, ref):
        assert t["skipped"] == r["skipped"] == 0
        np.testing.assert_allclose(t["loss"], r["loss"], rtol=loss_rtol)
        np.testing.assert_allclose(t["grad_norm"], r["grad_norm"],
                                   rtol=1e-4)


def _lr_sum(case):
    from deepspeed_tpu_torch.runtime.lr_schedules import build_schedule

    s = case["cfg"]["scheduler"]
    sched = build_schedule(s["type"], s["params"],
                           case["cfg"]["optimizer"]["params"]["lr"])
    return sum(sched(c) for c in range(1, 4))


def _assert_quantized_weights(got, ref, lr_sum):
    """The compressed facade's rule: within 1e-5 except at most 1 in 200
    weights, each within 2 lr a step."""
    n_out = n_all = 0
    for n, w in got.items():
        d = np.abs(w - ref[n])
        n_out += int((d > 1e-5).sum())
        n_all += d.size
        assert np.all(d <= 2 * lr_sum + 1e-5), n
    assert n_out <= n_all // 200, (n_out, n_all)


def _check_run(results, cases, world, key):
    case, z, (ref_steps, ref_w) = _reference(key, cases, world)
    got = results(world)
    r0 = got[0][key]
    for rr in got[1:]:
        assert rr[key]["steps"] == r0["steps"], key
    lo = {n: (r0["lo"][n], float(r0["hi"][n].max())) for n in r0["lo"]}
    full = r0["full"] if case["family"] == "blocks" else flat_jax(r0["full"])
    lr_sum = _lr_sum(case)
    if z in ("s2q", "s3q"):
        _assert_steps(r0["steps"], ref_steps, loss_rtol=1e-4)
        _assert_quantized_weights(full, ref_w, lr_sum)
    else:
        _assert_steps(r0["steps"], ref_steps)
        assert_weights(full, ref_w, lo, lr_sum, atol=1e-5)
    assert r0["steps"][-1]["loss"] < r0["steps"][0]["loss"], key
    for rr in got:
        assert rr[key]["eval"] == pytest.approx(r0["eval"], rel=1e-6)
        assert rr[key]["eval"] == pytest.approx(rr[key]["eval_stage0"],
                                                rel=1e-5), key
    return got


@pytest.mark.parametrize("z", list(ZERO))
@pytest.mark.parametrize("name", FAMILIES)
def test_zero_training_matches_jax_on_2_ranks(ranks, name, z):
    cases, results = ranks
    _check_run(results, cases, 2, f"{name}/{z}")


@pytest.mark.parametrize("key", sorted(_runs(4)))
def test_zero_training_matches_jax_on_4_ranks(ranks, key):
    cases, results = ranks
    _check_run(results, cases, 4, key)


def test_stage3_with_qgz_matches_jax(ranks):
    """Stage 3 with qgZ on Llama: the per-layer gather, each leaf's
    gradient through the facade's quantized mean and then cut to the
    shard, against JAX's qgZ facade path."""
    cases, results = ranks
    got = _check_run(results, cases, 2, "llama/s3q")
    assert got[0]["llama/s3q"]["route"] == "gather"
    assert got[0]["llama/s3q"]["ledger"]["qgz_inter_reduce_scatter"] > 0


@pytest.mark.parametrize("key", list(BLOCK_RUNS))
def test_stage3_facade_path_matches_jax(ranks, key):
    """Stage 3 on a ``zero3_blocks`` model off the staged schedule: a
    custom ``loss_fn`` (which JAX warns about and trains on its facade
    path) and ``overlap="off"``."""
    cases, results = ranks
    got = _check_run(results, cases, 2, key)
    assert got[0][key]["route"] == "gather"


def _block_params():
    """The port's ``SequentialBlockModel`` weights (seed 2) as JAX's
    tree."""
    model = SequentialBlockModel(BLOCK_DIMS, seed=2, device="cpu")
    tree = {}
    for n, p in model.named_parameters():
        blk, leaf = n.split(".")
        tree.setdefault(blk, {})[leaf] = p.detach().numpy().copy()
    return tree


@pytest.mark.parametrize("name", FAMILIES)
def test_stage1_is_bitwise_stage0_and_masters_agree_across_ranks(ranks,
                                                                  name):
    _, results = ranks
    got = results(2)
    a, b = got[0][f"{name}/s0"], got[0][f"{name}/s1"]
    assert a["steps"] == b["steps"]
    np.testing.assert_array_equal(
        np.concatenate([v.reshape(-1) for v in flat_jax(a["full"]).values()]),
        np.concatenate([v.reshape(-1) for v in flat_jax(b["full"]).values()]))
    for world in (2, 4):
        for key in (f"{name}/s1", f"{name}/s2", f"{name}/s2q"):
            runs = [r.get(key) for r in results(world)]
            if runs[0] is None:
                continue
            assert all(r["digest"] == runs[0]["digest"] for r in runs), key
            assert len(runs[0]["whole"]) == len(runs[0]["shapes"]), key


@pytest.mark.parametrize("world", [2, 4])
def test_layout_masters_moments_and_gradients(ranks, world):
    """Stages 1-2: every master whole, the moments of each leaf that the
    ranks divide cut (JAX's ``test_zero1_opt_state_sharded_params_
    replicated``); stage 3: the masters cut too, and at the default
    threshold the small leaves kept whole."""
    _, results = ranks
    r0 = results(world)[0]
    name = "llama"
    for z in ("s1", "s2"):
        run = r0[f"{name}/{z}"]
        assert len(run["whole"]) == len(run["shapes"])
        assert any(run["moments"][n] != run["shapes"][n]
                   for n in run["shapes"])
    cut3 = r0[f"{name}/s3"]
    assert not cut3["whole"] or all(
        min(cut3["shapes"][n]) % world for n in cut3["whole"])
    assert cut3["moments"] == cut3["shapes"]
    if world == 2:
        kept = set(r0[f"{name}/s3p"]["whole"])
        assert kept and kept != set(r0[f"{name}/s3p"]["shapes"])


def _jax_specs(name, stage, world, threshold=0):
    """JAX's param / state / grad specs of the family's tree, as
    ``{port name: tuple}`` (a stacked layer leaf's spec without its layer
    dim, once per layer)."""
    params = _perturbed(export_params(_port_model(name)),
                        np.random.default_rng(0))
    shapes = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(np.shape(a), jnp.float32), params)
    rules = JaxRules(jmesh.Topology.build_virtual({"data": world}),
                     JaxZeroConfig(stage=stage,
                                   stage3_param_persistence_threshold=threshold))
    out = {}
    grads = rules.grad_shardings(shapes)

    def walk(tree, gtree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, gtree[k], f"{prefix}{k}.")
                continue
            shape = tuple(v.shape)
            specs = (tuple(rules.param_spec(shape)),
                     tuple(rules.state_spec(shape)),
                     tuple(gtree[k].spec))
            specs = tuple(s + (None,) * (len(shape) - len(s)) for s in specs)
            if prefix.endswith("layers."):
                for i in range(shape[0]):
                    out[f"{prefix}{i}.{k}"] = tuple(s[1:] for s in specs)
            else:
                out[f"{prefix}{k}"] = specs

    walk(shapes, grads, "")
    return out


@pytest.mark.parametrize("stage,threshold", [(1, 0), (2, 0), (3, 0),
                                             (3, 10_000)])
@pytest.mark.parametrize("name", FAMILIES)
def test_zero_specs_equal_jax_key_for_key(name, stage, threshold):
    """Every leaf's param, state and gradient spec equals JAX's (the
    persistence threshold counting the stacked leaf, ``stack_counts``);
    the moments' specs (``opt_state_specs``) are the state specs."""
    world = 2
    ref = _jax_specs(name, stage, world, threshold)
    rules = ZeroShardingRules(
        Topology({"data": world, "model": 1}, {}),
        ZeroConfig(stage=stage, stage3_param_persistence_threshold=threshold))
    model = _port_model(name)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    stack = stack_counts(list(shapes))
    grads = rules.grad_specs(shapes)
    moments = rules.opt_state_specs(shapes)
    got = {}
    for n, s in shapes.items():
        got[n] = (tuple(rules.param_spec(s, stack[n])),
                             tuple(rules.state_spec(s)), tuple(grads[n]))
        assert moments["mu"][n] == moments["nu"][n] == rules.state_spec(s)
    assert got == ref
    if stage < 3:
        assert all(all(e is None for e in p) for p, _, _ in got.values())
    else:       # whole below the threshold: the small leaves
        kept = [n for n, (p, st, _) in got.items() if p != st]
        assert bool(kept) == (threshold > 0), kept
    assert any("data" in st for _, st, _ in got.values())


def test_stage3_books_one_gather_a_layer_and_its_replay(ranks):
    """ZeRO-3 with remat on Llama (2 layers, threshold 0: every leaf
    cut): each micro-batch gathers the top-level leaves once and each
    layer twice (the forward, the backward pass's replay), and
    reduce-scatters each group's gradients once: 3 steps of GAS 2."""
    _, results = ranks
    micro, layers = 3 * 2, 2
    for world in (2, 4):
        led = results(world)[0]["llama/s3"]["ledger"]
        assert led["zero3_param_gather"] == micro * (1 + 2 * layers)
        assert led["zero3_grad_reduce_scatter"] == micro * (1 + layers)
        assert "zero3_grad_all_reduce" not in led
