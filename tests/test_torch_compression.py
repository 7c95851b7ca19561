"""The port's compression against the JAX package's, on the CPU: the
eight cases of ``tests/test_compression.py``, each held to the JAX
function.

* The ``compression_training`` vocabulary parses as JAX's.
* Sparse, row and head masks from the same weights: the same elements,
  keyed by the same stacked-leaf paths (the port's per-layer leaves read
  as JAX's ``[n_layers, ...]`` stacks; ties kept, as JAX's threshold
  keeps them). The schedule activates sparse masks at its offset inside
  a training run, and training continues.
* QAT's forward against the JAX engine's within 1e-6, and it trains.
* Head pruning keeps a planted dominant head.
* Layer reduction keeps the ``teacher_layer`` layers, and refuses a live
  engine.
* ``redundancy_clean`` bakes the masks, as JAX's.
* The progressive bit schedule.
* On the card (``gpu``): QAT plus sparse pruning over 3 fp32 steps on
  cuda against the CPU.

The JAX package is imported inside the tests that use it, so the card's
machine (no JAX) collects the file and runs its ``gpu`` case.
"""

import copy

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as tdst
from deepspeed_tpu_torch.checkpoint.jax_params import load_jax_params
from deepspeed_tpu_torch.compression import (CompressionConfig, Compressor,
                                             init_compression,
                                             redundancy_clean)
from deepspeed_tpu_torch.models.llama import Llama

SMALL = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=4, vocab_size=64,
             max_seq_len=16, use_flash=False, remat=False)
CFG = {"train_batch_size": 8,
       "optimizer": {"type": "adamw", "params": {"lr": 3e-3}},
       "steps_per_print": 1000}
SPARSE_CFG = {"compression_training": {"sparse_pruning": {
    "shared_parameters": {"enabled": True, "schedule_offset": 2,
                          "method": "l1"},
    "different_groups": {"sp1": {"params": {"dense_ratio": 0.3},
                                 "modules": ["w_up", "w_down"]}}}}}
QAT_CFG = {"compression_training": {"weight_quantization": {
    "shared_parameters": {"enabled": True, "schedule_offset": 0},
    "different_groups": {"wq1": {"params": {"target_bits": 8},
                                 "modules": ["*"]}}}}}
ROW_GROUP = {"name": "r", "modules": ["wq", "w_gate"], "dense_ratio": 0.5}
HEAD_GROUP = {"name": "h", "modules": ["wo"], "dense_ratio": 0.5,
              "num_heads": 4}


def _jax_model(n_layers=2, seed=0):
    import jax

    from deepspeed_tpu.models import Llama as JaxLlama

    jm = JaxLlama("tiny", **{**SMALL, "n_layers": n_layers})
    return jm, jm.init(jax.random.PRNGKey(seed))


def _port(jparams, n_layers=2):
    import jax

    return load_jax_params(Llama("tiny", device="cpu",
                                 **{**SMALL, "n_layers": n_layers}),
                           jax.tree_util.tree_map(np.asarray, jparams))


def _engine(model):
    return tdst.initialize(model=model, config=CFG, device="cpu")[0]


def _batch(seed=0):
    return {"input_ids": torch.from_numpy(np.random.default_rng(seed)
                                          .integers(0, 64, (8, 16)))}


def test_config_parsing_follows_jax():
    from deepspeed_tpu.compression import CompressionConfig as JCfg

    for cfg in (SPARSE_CFG, QAT_CFG, {}):
        assert vars(CompressionConfig.from_dict(cfg)) == vars(
            JCfg.from_dict(cfg))
    g = CompressionConfig.from_dict(SPARSE_CFG).sparse_pruning[0]
    assert g["dense_ratio"] == 0.3 and g["modules"] == ["w_up", "w_down"]


@pytest.mark.parametrize("kind,group", [
    ("sparse", {"name": "s", "modules": ["w_up", "w_down", "tok_embed"],
                "dense_ratio": 0.3}),
    ("row", ROW_GROUP), ("head", HEAD_GROUP)])
def test_masks_pick_jax_elements(kind, group):
    from deepspeed_tpu.compression.compress import Compressor as JComp

    _, jparams = _jax_model()
    tparams = dict(_port(jparams).named_parameters())
    theirs, ours = JComp(None), Compressor(None)
    theirs._compute_masks(jparams, kind, dict(group))
    ours._compute_masks(tparams, kind, dict(group))
    assert ours.masks and set(ours.masks) == set(theirs.masks)
    for path, m in theirs.masks.items():
        np.testing.assert_array_equal(ours.masks[path], m, err_msg=path)


def test_sparse_schedule_activates_in_training():
    _, jparams = _jax_model()
    engine = _engine(_port(jparams))
    comp = init_compression(engine, SPARSE_CFG)
    assert not comp.masks                     # offset 2 not reached
    for i in range(4):
        engine.train_batch(_batch(i))
    assert comp.masks
    pc = comp.transform(dict(engine.params))
    checked = 0
    for n, leaf in pc.items():
        if "w_up" in n or "w_down" in n:
            density = float((leaf != 0).float().mean())
            assert 0.15 < density < 0.45, (n, density)
            checked += 1
    assert checked == 4
    assert np.isfinite(float(engine.train_batch(_batch(9))["loss"]))


def test_qat_forward_matches_jax_and_trains():
    import jax.numpy as jnp

    import deepspeed_tpu as jdst
    from deepspeed_tpu.compression import init_compression as jinit
    from deepspeed_tpu.parallel.mesh import Topology

    jm, jparams = _jax_model()
    model = _port(jparams)
    je = jdst.initialize(model=jm, params=jparams, config=CFG,
                         topology=Topology.build_virtual({"data": 1}))[0]
    te = _engine(model)
    b = _batch(0)
    base = float(te.eval_batch(b))
    jinit(je, QAT_CFG)
    init_compression(te, QAT_CFG)
    jq = float(je.eval_batch({"input_ids": jnp.asarray(
        b["input_ids"].numpy().astype(np.int32))}))
    tq = float(te.eval_batch(b))
    assert tq != base
    np.testing.assert_allclose(tq, jq, rtol=1e-6)
    losses = [float(te.train_batch(_batch(i))["loss"]) for i in range(4)]
    assert losses[-1] < losses[0]


def test_head_pruning_keeps_the_dominant_head():
    from deepspeed_tpu.compression.compress import Compressor as JComp

    _, jparams = _jax_model()
    model = _port(jparams)
    hd = 32 // 4
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith(".wo"):
                p[2 * hd:3 * hd, :] *= 100.0       # head 2 dominates
    engine = _engine(model)
    cfg = {"compression_training": {"head_pruning": {
        "shared_parameters": {"enabled": True, "schedule_offset": 0},
        "different_groups": {"hp1": {"params": {"dense_ratio": 0.5,
                                                "num_heads": 4},
                                     "modules": ["wo"]}}}}}
    comp = init_compression(engine, cfg)
    (path, mask), = comp.masks.items()
    assert path == "['layers']['wo']"
    rows = mask.reshape(4, hd, -1)
    assert all(len(np.unique(rows[h])) == 1 for h in range(4))
    assert 0 < mask.mean() < 1 and rows[2].max() == 1.0
    theirs = JComp(None)
    stacked = np.stack([engine.params[f"layers.{i}.wo"].numpy()
                        for i in range(2)])
    theirs._compute_masks({"layers": {"wo": stacked}}, "head",
                          dict(HEAD_GROUP))
    np.testing.assert_array_equal(theirs.masks[path], mask)


def test_layer_reduction_student_init():
    import jax

    from deepspeed_tpu.compression import init_compression as jinit

    _, jparams = _jax_model(n_layers=4)
    tparams = dict(_port(jparams, n_layers=4).named_parameters())
    cfg = {"compression_training": {"layer_reduction": {
        "enabled": True, "keep_number_layer": 2, "teacher_layer": [0, 3]}}}
    student = init_compression(tparams, cfg).student_params(tparams)
    jstudent = jinit(jparams, cfg).student_params(jparams)
    assert sorted({n.split(".")[1] for n in student
                   if n.startswith("layers.")}) == ["0", "1"]
    for leaf, stacked in jstudent["layers"].items():
        for i in range(2):
            np.testing.assert_array_equal(
                student[f"layers.{i}.{leaf}"].numpy(),
                np.asarray(stacked[i]))
    assert torch.equal(student["layers.1.wq"], tparams["layers.3.wq"])
    assert jax.tree_util.tree_leaves(jstudent["layers"])[0].shape[0] == 2


def test_layer_reduction_on_engine_raises():
    _, jparams = _jax_model()
    engine = _engine(_port(jparams))
    cfg = {"compression_training": {"layer_reduction": {
        "enabled": True, "keep_number_layer": 1}}}
    with pytest.raises(ValueError, match="before initialize"):
        init_compression(engine, cfg)


def test_redundancy_clean_bakes_masks_as_jax():
    from deepspeed_tpu.compression import redundancy_clean as jclean
    from deepspeed_tpu.compression.compress import Compressor as JComp
    from torch_train_parity import flat_jax

    _, jparams = _jax_model()
    engine = _engine(_port(jparams))
    comp = init_compression(engine, SPARSE_CFG)
    for i in range(3):
        engine.train_batch(_batch(i))
    cleaned = redundancy_clean(engine, SPARSE_CFG, compressor=comp)
    hit = 0
    for n, leaf in cleaned.items():
        if "w_up" in n or "w_down" in n:
            assert float((leaf == 0).float().mean()) > 0.4, n
            hit += 1
    assert hit == 4
    # JAX's clean of the same masters with the same masks
    stacked = {"layers": {leaf: np.stack([
        engine.params[f"layers.{i}.{leaf}"].numpy() for i in range(2)])
        for leaf in ("w_up", "w_down")}}
    theirs = JComp(CompressionConfig.from_dict(SPARSE_CFG))
    theirs.masks = dict(comp.masks)
    ref = flat_jax(jclean(stacked, SPARSE_CFG, compressor=theirs))
    for n, w in ref.items():
        np.testing.assert_array_equal(cleaned[n].numpy(), np.asarray(w))


def test_progressive_quantization_bit_schedule():
    from deepspeed_tpu.compression.compress import Compressor as JComp

    g = {"name": "g", "schedule_offset": 10, "start_bits": 16,
         "target_bits": 4, "quantization_period": 5}
    assert [Compressor._bits_at(g, s) for s in (10, 15, 20, 100)] \
        == [16, 8, 4, 4]
    for step in range(0, 40):
        assert Compressor._bits_at(g, step) == JComp._bits_at(g, step)
    assert Compressor._bits_at({"name": "x", "schedule_offset": 0,
                                "target_bits": 8}, 0) == 8


@pytest.mark.gpu
def test_cuda_qat_and_pruning_train_as_on_the_cpu():
    """QAT on every matrix plus sparse pruning from step 0 (masks from the
    same weights on both devices), 3 fp32 steps of a 2-layer Llama (head
    dim 64) on the card and on the CPU: the same masks, the first loss
    within 1e-5 and the next two within 1e-4 (TF32 off; as chip phase 8e
    (f)), and ``redundancy_clean`` baking the same zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kw = dict(n_layers=2, d_model=128, n_heads=2, n_kv_heads=1,
              vocab_size=256, max_seq_len=64, use_flash=True)
    cfg = {"compression_training": {
        **QAT_CFG["compression_training"],
        "sparse_pruning": {**SPARSE_CFG["compression_training"][
            "sparse_pruning"], "shared_parameters": {
                "enabled": True, "schedule_offset": 0}}}}
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (8, 64)))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        cpu_model = Llama("tiny", device="cpu", seed=3, **kw)
        models = {"cuda": copy.deepcopy(cpu_model).to("cuda"),
                  "cpu": cpu_model}         # one set of weights
        for dev in ("cuda", "cpu"):
            eng = tdst.initialize(model=models[dev], config=CFG,
                                  device=dev)[0]
            comp = init_compression(eng, cfg)
            losses = [float(eng.train_batch({"input_ids": toks})["loss"])
                      for _ in range(3)]
            clean = redundancy_clean(eng, cfg, compressor=comp)
            out[dev] = (losses, comp.masks,
                        {n: (t == 0).cpu() for n, t in clean.items()})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    # the first step from the same weights; then QAT can put a weight a
    # level apart on the two devices (and Adam's near-eps elements move)
    np.testing.assert_allclose(out["cuda"][0][0], out["cpu"][0][0],
                               rtol=1e-5)
    np.testing.assert_allclose(out["cuda"][0][1:], out["cpu"][0][1:],
                               rtol=1e-4)
    assert set(out["cuda"][1]) == set(out["cpu"][1])
    for k, m in out["cpu"][1].items():
        np.testing.assert_array_equal(out["cuda"][1][k], m)
    assert all(torch.equal(out["cuda"][2][n], z)
               for n, z in out["cpu"][2].items() if "w_" in n)
