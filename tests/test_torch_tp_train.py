"""Tensor-parallel training of the PyTorch port against the JAX package,
on the CPU, at tiny sizes in fp32.

The port's ranks are gloo processes (``tests/torch_ranks.py``, job
``tp_train_job``), started once for the module over ``{"model": 2}``
(world 2) and ``{"data": 2, "model": 2}`` (world 4); the JAX side runs in
the pytest process on the 8 virtual CPU devices of ``tests/conftest.py``,
its ``initialize`` over ``Topology.build_virtual({"data": 2, "model":
2})``. Every weight is the port's seeded init perturbed by N(0, 0.05^2)
from a numpy seed (no JAX ``init``: it compiles), so no bias is zero and
no norm weight one. Each rank gets the full-width model and
``initialize`` cuts it by its ``partition_specs``.

Cases: the Llama (GQA, flash path's plain version), GPT-2, OPT and
GPT-Neo (varying windows: the plain attention) flag sets, BERT MLM
(padding mask, segments, a loss mask whose count differs by row: the
data ranks' loss shares), CLIP (the in-batch negatives gathered over the
data ranks) and GPT-MoE on the capacity route (top-2, drops, noise-free
gate). Three ``train_batch`` steps of GAS 2 on one batch at lr 1e-3
(``SLOW``; the config gives GAS, so every mesh sees the same global
micro-batches): losses within 1e-5 and grad norms within 1e-4 of JAX's
and of the port's own TP 1 engine, and the masters gathered to full
width (``TrainEngine.full_params``, carried to the JAX layout by
``jax_params.export_params``) within ``tests/torch_train_parity.py``'s
bounds of JAX's and of TP 1's; ``eval_batch`` after the steps within
1e-5 of TP 1's. Replicated leaves are bitwise equal on every rank, and
cut leaves on the ranks of a model column; an inf planted in one rank's
shard under fp16 skips the step on every rank; CLIP's
``partition_specs`` equal JAX's key for key; ZeRO stages 1-3 with
``model`` > 1 raise naming Queue A item 12.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
from deepspeed_tpu.models import clip as jax_clip
from deepspeed_tpu.models.moe import (MoETransformer as JaxMoE,
                                      MoETransformerConfig as JaxMoEConfig)
from deepspeed_tpu.models.transformer import (Transformer as JaxTransformer,
                                              TransformerConfig as JaxConfig)
from deepspeed_tpu.parallel import mesh as jmesh
import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint.jax_params import export_params
from deepspeed_tpu_torch.config import Config, ConfigError
from deepspeed_tpu_torch.models import bert, clip, gpt2, llama
from deepspeed_tpu_torch.models import moe as moe_models
from deepspeed_tpu_torch.models.transformer import Transformer
from deepspeed_tpu_torch.runtime import optimizers as opt

from torch_ranks import start_ranks
from torch_train_parity import CFG, assert_weights, flat_jax

MESHES = {"tp2": {"model": 2}, "dp2_tp2": {"data": 2, "model": 2}}
# the config gives GAS 2: every mesh (and the one-device engine) trains on
# the same two global micro-batches of 2 rows a step
TP_CFG = {k: v for k, v in CFG.items()
          if k != "train_micro_batch_size_per_gpu"}
TP_CFG["gradient_accumulation_steps"] = 2
# every family trains at a tenth of CFG's lr, as the encoders of
# tests/test_torch_train_encoders.py do: an Adam step moves a weight by
# about lr x (its gradient relative to the gradient's history), so the
# fp32 summation-order noise of the two packages' model-group and
# data-group sums (each in its own order; XLA's GSPMD sums move the JAX
# TP engine's weights from the JAX one-device engine's as much) reaches
# 7e-5 in a few weights at lr 1e-2, 2e-5's ten-fold at 1e-3's scale
SLOW = {**TP_CFG, "optimizer": {"type": "adamw",
                                "params": {"lr": 1e-3,
                                           "weight_decay": 0.1}},
        "scheduler": {"type": "WarmupDecayLR",
                      "params": {"total_num_steps": 10,
                                 "warmup_num_steps": 2,
                                 "warmup_max_lr": 1e-3}}}
SMALL = dict(vocab_size=96, d_model=64, n_layers=2, n_heads=4,
             max_seq_len=32, remat=True, use_flash=True)
TEXT = dict(vocab_size=96, d_model=64, n_layers=2, n_heads=4, d_ff=128,
            max_seq_len=16, remat=True)
VISION = dict(d_model=64, n_layers=2, n_heads=4, d_ff=128, remat=True)
PIXELS = dict(proj_dim=32, image_size=32, patch_size=8)
FAMILIES = ("llama", "gpt2", "opt", "gpt_neo", "bert", "clip", "moe")


def _config(name):
    if name == "llama":
        return llama.llama_config("tiny", **SMALL, n_kv_heads=2)
    if name == "gpt2":
        return gpt2.gpt2_config("tiny", **SMALL)
    if name == "opt":
        return gpt2.opt_config("125m", **SMALL)
    if name == "gpt_neo":
        return gpt2.gpt_neo_config("tiny", **SMALL, attn_windows=(0, 6))
    if name == "bert":
        return bert.bert_config("tiny", vocab_size=96, max_seq_len=32,
                                remat=True)
    # a capacity that drops: 4 x 4 slots for 32 choices a row
    return moe_models.gpt_moe_config("tiny", 4, **SMALL, top_k=2,
                                     capacity_factor=0.5, min_capacity=1)


def _port_model(name):
    if name == "clip":
        return clip.CLIP(clip.CLIPConfig(clip.clip_text_config(**TEXT),
                                         clip.clip_vision_config(**VISION),
                                         **PIXELS), device="cpu", seed=3)
    if name == "moe":
        return moe_models.MoETransformer(_config(name), device="cpu", seed=3)
    return Transformer(_config(name), device="cpu", seed=3)


def _jax_model(name):
    if name == "clip":
        return jax_clip.CLIP(jax_clip.CLIPConfig(
            jax_clip.clip_text_config(**TEXT),
            jax_clip.clip_vision_config(**VISION), **PIXELS))
    kw = dataclasses.asdict(_config(name))
    return JaxMoE(JaxMoEConfig(**kw)) if name == "moe" else \
        JaxTransformer(JaxConfig(**kw))


def _perturbed(tree, rng):
    if isinstance(tree, dict):
        return {k: _perturbed(v, rng) for k, v in tree.items()}
    return (tree + 0.05 * rng.standard_normal(np.shape(tree))).astype(
        np.float32)


def _batch(name, seed):
    rng = np.random.default_rng(seed)
    if name == "clip":
        toks = rng.integers(1, 90, (4, 16))
        toks[np.arange(4), rng.integers(4, 16, 4)] = 95  # argmax pooling
        return {"input_ids": toks.astype(np.int32),
                "pixel_values": rng.standard_normal(
                    (4, 3, 32, 32)).astype(np.float32)}
    if name == "bert":
        # a loss mask on ~15 % of the real positions: its count differs
        # by row, so a data rank's mean is not its share of the batch's
        lens = np.array([16, 12, 9, 16])
        real = np.arange(16)[None, :] < lens[:, None]
        pick = (rng.random((4, 16)) < 0.15) & real
        pick[:, 1] = True
        return {"input_ids": rng.integers(0, 96, (4, 16)).astype(np.int32),
                "labels": rng.integers(0, 96, (4, 16)).astype(np.int32),
                "loss_mask": pick.astype(np.float32),
                "attention_mask": real.astype(np.int32),
                "token_type_ids": ((np.arange(16)[None, :]
                                    >= lens[:, None] // 2)
                                   & real).astype(np.int32)}
    return {"input_ids": rng.integers(0, 96, (4, 16)).astype(np.int32)}


def _case(name, seed):
    model = _port_model(name)
    params = _perturbed(export_params(model), np.random.default_rng(seed))
    config = dataclasses.asdict(model.config) if name != "clip" else \
        {"text": TEXT, "vision": VISION, "pixels": PIXELS}
    family = name if name in ("clip", "moe") else "dense"
    return {"family": family, "config": config, "params": params,
            "cfg": SLOW,
            "batches": [_batch(name, 40 + seed)] * 3}


def _fp16_case():
    case = _case("gpt2", 20)
    case["config"].update(remat=False, use_flash=False)
    case["cfg"] = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
                   "gradient_clipping": 1.0, "steps_per_print": 100,
                   "optimizer": {"type": "adam", "params": {"lr": 1e-3}},
                   "fp16": {"enabled": True, "initial_scale_power": 8,
                            "hysteresis": 1}}
    return case


@pytest.fixture(scope="module")
def ranks():
    cases = {name: _case(name, i) for i, name in enumerate(FAMILIES)}
    procs = {}
    for tag, mesh in MESHES.items():
        world = 2 if tag == "tp2" else 4
        planted = {**_fp16_case(), "plant": (world - 1, 1)}
        procs[tag] = start_ranks(world, "tp_train_job",
                                 {**cases, "fp16": planted}, mesh,
                                 timeout=300)
    box = {}

    def results(tag):
        if tag not in box:
            box[tag] = procs[tag].results()
        return box[tag]

    yield cases, results
    for p in procs.values():
        p.kill()


_RUNS = {}


def _jax_run(name, case):
    """JAX's ``initialize`` over a data 2 x model 2 mesh on the case's
    weights: (per-step metrics, final weights by port name)."""
    if name not in _RUNS:
        jmesh.reset_topology()
        eng, *_ = deepspeed_tpu.initialize(
            model=_jax_model(name),
            params=jax.tree_util.tree_map(jnp.asarray, case["params"]),
            config={**case["cfg"], "mesh": MESHES["dp2_tp2"]},
            topology=jmesh.Topology.build_virtual(MESHES["dp2_tp2"]))
        steps = [{k: float(np.asarray(v)) for k, v in eng.train_batch(
            {k: jnp.asarray(v) for k, v in b.items()}).items()}
            for b in case["batches"]]
        jmesh.reset_topology()
        _RUNS[name] = (steps, flat_jax(jax.tree_util.tree_map(np.asarray,
                                                              eng.params)))
    return _RUNS[name]


def _port_tp1(name, case):
    """The port's one-device engine on the case's weights: (per-step
    metrics, final weights, smallest / largest |g| of each element)."""
    key = ("tp1", name)
    if key not in _RUNS:
        from deepspeed_tpu_torch.checkpoint.jax_params import load_jax_params

        model = load_jax_params(_port_model(name), case["params"])
        eng, *_ = deepspeed_tpu_torch.initialize(model=model,
                                                 config=case["cfg"],
                                                 device="cpu")
        lo, hi = {}, {}
        inner = eng.optimizer

        def update(grads, state, params):
            for n, g in grads.items():
                a = g.abs()
                lo[n] = torch.minimum(lo[n], a) if n in lo else a.clone()
                hi[n] = torch.maximum(hi[n], a) if n in hi else a.clone()
            return inner.update(grads, state, params)

        eng.optimizer = opt.Transform(inner.init, update)
        steps = [{k: float(v) for k, v in eng.train_batch(
            {k: torch.from_numpy(v) for k, v in b.items()}).items()}
            for b in case["batches"]]
        lr_sum = sum(eng.lr_schedule(c) for c in range(1, 4))
        steps.append(float(eng.eval_batch(case["batches"][0])))
        _RUNS[key] = (steps, {n: p.numpy().copy()
                              for n, p in eng.params.items()},
                      {n: lo[n].numpy() for n in lo},
                      {n: hi[n].numpy() for n in hi}, lr_sum)
    return _RUNS[key]


def _assert_steps(got, ref):
    for t, r in zip(got, ref):
        assert t["skipped"] == r["skipped"] == 0
        np.testing.assert_allclose(t["loss"], r["loss"], rtol=1e-5)
        np.testing.assert_allclose(t["grad_norm"], r["grad_norm"],
                                   rtol=1e-4)


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("name", FAMILIES)
def test_tp_training_matches_jax_and_tp1(ranks, name, tag):
    cases, results = ranks
    case = cases[name]
    got = results(tag)
    r0 = got[0][name]
    jsteps, jweights = _jax_run(name, case)
    (*tsteps, teval), tweights, _, _, lr_sum = _port_tp1(name, case)
    _assert_steps(r0["steps"], jsteps)
    _assert_steps(r0["steps"], tsteps)
    # eval_batch after the steps: every rank's (the data ranks' shares
    # summed) equals the one-device engine's
    for rr in got:
        np.testing.assert_allclose(rr[name]["eval"], teval, rtol=1e-5)
    assert r0["steps"][-1]["loss"] < r0["steps"][0]["loss"]
    # every rank reports the same step (the loss and the norm are the
    # model group's and the data group's)
    for rr in got[1:]:
        assert rr[name]["steps"] == r0["steps"]
    assert r0["sharded"], name
    lo = {n: (r0["lo"][n], float(r0["hi"][n].max())) for n in r0["lo"]}
    full = flat_jax(r0["full"])       # the gathered masters, JAX's layout
    assert_weights(full, jweights, lo, lr_sum)
    assert_weights(full, tweights, lo, lr_sum)


@pytest.mark.parametrize("tag", list(MESHES))
def test_replicated_leaves_bitwise_across_ranks(ranks, tag):
    _, results = ranks
    got = results(tag)
    tp = MESHES[tag]["model"]
    for name in FAMILIES:
        cut = set(got[0][name]["sharded"])
        for r, rr in enumerate(got[1:], 1):
            for n, w in rr[name]["local"].items():
                if n not in cut:            # replicated: every rank
                    assert np.array_equal(w, got[0][name]["local"][n]), \
                        (name, n, r)
                else:                       # cut: the ranks of a column
                    col = got[r % tp][name]["local"][n]
                    assert np.array_equal(w, col), (name, n, r)


@pytest.mark.parametrize("tag", list(MESHES))
def test_fp16_inf_in_one_shard_skips_every_rank(ranks, tag):
    _, results = ranks
    got = results(tag)
    for rr in got:
        steps = rr["fp16"]["steps"]
        assert [s["skipped"] for s in steps] == [0, 1, 0]
        assert [s["loss_scale"] for s in steps] == \
            [s["loss_scale"] for s in got[0]["fp16"]["steps"]]
        assert steps[2]["loss_scale"] < steps[0]["loss_scale"]
    for n, w in got[0]["fp16"]["local"].items():
        for rr in got[1:]:
            if n not in got[0]["fp16"]["sharded"]:
                assert np.array_equal(w, rr["fp16"]["local"][n]), n


def test_clip_partition_specs_equal_jax_key_for_key():
    port = _port_model("clip").partition_specs()
    ref = _jax_model("clip").partition_specs({})

    def norm(tree):
        return {k: norm(v) if isinstance(v, dict) else tuple(v)
                for k, v in tree.items()}

    assert norm(port) == norm(ref)
    assert norm(port)["vision"]["tok_embed"] == (None, None)
    assert norm(port)["text"]["tok_embed"] == ("model", None)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_zero_stages_with_a_model_axis_raise(stage):
    cfg = {"train_batch_size": 2, "mesh": {"model": 2},
           "zero_optimization": {"stage": stage}}
    with pytest.raises(ConfigError, match="item 12"):
        Config.from_dict(cfg)
    with pytest.raises(NotImplementedError if stage == 3 else ConfigError,
                       match="item 12"):
        Config.from_dict(cfg)
    # stage 0 over a model axis parses
    assert Config.from_dict({"train_batch_size": 2,
                             "mesh": {"model": 2}}).mesh["model"] == 2
