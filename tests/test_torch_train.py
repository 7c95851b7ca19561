"""The training path of the PyTorch port against the JAX package, on the CPU.

Inputs and weights are made with numpy from a seed; JAX weights are
carried into the port with ``load_jax_params``. Everything is fp32.

* ``Transformer.apply`` logits, ``loss`` (with and without
  ``loss_chunk_size``) and the loss's gradients against the JAX model,
  1e-5.
* ``TrainEngine``: three ``train_batch`` steps of a 2-layer tiny Llama
  (GQA 4:2, ``remat``, ``use_flash``, GAS 2, AdamW with weight decay, a
  warmup/decay schedule, clipping that engages) against the JAX
  ``TrainEngine`` on a one-device mesh: per-step loss and grad norm within
  1e-5 relative, and the weights after the steps within 2e-5 absolute
  except where a gradient element fell near Adam's eps, by the rule that
  ``tests/torch_train_parity.py`` states and every training test shares.
* fp16 with dynamic loss scaling: the same skipped-step and loss-scale
  sequence as the JAX engine.
* Units: ``lr_schedules`` values, ``loss_scaler.update`` sequences, the
  Adam rules and ``global_norm`` against the JAX functions; ``Config``
  batch resolution and its ``ConfigError``s; the remat policies and the
  other optimizer rules build and run, and the ``telemetry`` and
  ``offload_optimizer`` blocks are read.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu_torch
from deepspeed_tpu.models import Llama as JaxLlama
from deepspeed_tpu.runtime import loss_scaler as jax_ls
from deepspeed_tpu.runtime import lr_schedules as jax_sched
from deepspeed_tpu.runtime import optimizers as jax_opt
from deepspeed_tpu.runtime.engine import global_norm as jax_global_norm
from deepspeed_tpu_torch.checkpoint.jax_params import (export_params,
                                                       load_jax_params)
from deepspeed_tpu_torch import config as config_mod
from deepspeed_tpu_torch.config import Config, ConfigError
from deepspeed_tpu_torch.models.llama import Llama
from deepspeed_tpu_torch.runtime import activation_checkpointing as ac
from deepspeed_tpu_torch.runtime import loss_scaler as ls
from deepspeed_tpu_torch.runtime import lr_schedules as sched
from deepspeed_tpu_torch.runtime import optimizers as opt

from torch_train_parity import CFG, assert_parity, run_both

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, vocab_size=128,
            max_seq_len=64, remat=True, use_flash=True)
TOL = dict(rtol=1e-5, atol=1e-5)


def _models(seed=11, **overrides):
    kw = {**TINY, **overrides}
    jm = JaxLlama("tiny", **kw)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = load_jax_params(Llama("tiny", device="cpu", **kw),
                         jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 128, shape).astype(np.int32)


# ---------------------------------------------------------------- model
@pytest.mark.parametrize("chunk", [0, 5])
def test_apply_loss_and_grads_match_jax(chunk):
    jm, params, tm = _models(loss_chunk_size=chunk)
    toks = _tokens(1, (2, 12))
    with torch.no_grad():
        logits = tm.apply(torch.from_numpy(toks).long())
    np.testing.assert_allclose(logits.numpy(),
                               np.asarray(jm.apply(params, jnp.asarray(toks))),
                               **TOL)
    batch = {"input_ids": jnp.asarray(toks)}
    jloss, jgrads = jax.value_and_grad(jm.loss)(params, batch)
    p = {n: w.detach().clone().requires_grad_(True)
         for n, w in tm.named_parameters()}
    loss = tm.loss({"input_ids": torch.from_numpy(toks).long()}, params=p)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    got = export_params({n: w.grad for n, w in p.items()})
    ref = jax.tree_util.tree_map(np.asarray, jgrads)
    for name in ("tok_embed", "final_norm_w", "lm_head"):
        np.testing.assert_allclose(got[name], ref[name], **TOL, err_msg=name)
    for name, g in got["layers"].items():
        np.testing.assert_allclose(g, ref["layers"][name], **TOL,
                                   err_msg=name)


def test_loss_with_labels_and_mask_matches_jax():
    jm, params, tm = _models()
    toks, labels = _tokens(2, (2, 10)), _tokens(3, (2, 10))
    mask = (np.random.default_rng(4).random((2, 10)) > 0.3).astype(np.float32)
    ref = jm.loss(params, {"input_ids": jnp.asarray(toks),
                           "labels": jnp.asarray(labels),
                           "loss_mask": jnp.asarray(mask)})
    with torch.no_grad():
        got = tm.loss({"input_ids": torch.from_numpy(toks).long(),
                       "labels": torch.from_numpy(labels).long(),
                       "loss_mask": torch.from_numpy(mask)})
    np.testing.assert_allclose(got.item(), float(ref), **TOL)


def test_flops_and_param_count_match_jax():
    from deepspeed_tpu.models.llama import llama_config as jax_llama_config
    from deepspeed_tpu_torch.models.llama import llama_config

    for size in ("tiny", "1b", "7b"):
        c, jc = llama_config(size), jax_llama_config(size)
        assert c.param_count() == jc.param_count()
        assert c.flops_per_token(2048) == jc.flops_per_token(2048)
    assert llama_config("1b").param_count() == 1_100_048_384


def test_remat_replays_each_layer_in_the_backward_pass():
    calls = []
    _, _, tm = _models()
    real = tm._block

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    tm._block = counted
    p = {n: w.detach().clone().requires_grad_(True)
         for n, w in tm.named_parameters()}
    tm.loss({"input_ids": torch.from_numpy(_tokens(5, (1, 8))).long()},
            params=p).backward()
    assert len(calls) == 2 * TINY["n_layers"]   # forward + replay


# ---------------------------------------------------------------- engine
def _run_both(cfg, steps=3, seed=21, **overrides):
    jm, params, tm = _models(seed, **overrides)
    batches = [{"input_ids": _tokens(100 + i, (4, 16))} for i in range(steps)]
    return run_both(jm, params, tm, batches, cfg)


def test_train_batch_matches_jax_engine():
    jeng, teng, steps, min_abs_g = _run_both(CFG)
    assert teng.gradient_accumulation_steps == 2
    assert teng.train_micro_batch_size_per_gpu == 2
    # losses and grad norms within 1e-5, the weights after the steps by
    # the near-eps rule (tests/torch_train_parity.py says which elements
    # and why)
    assert_parity(jeng, teng, steps, min_abs_g)
    assert all(t["loss_scale"] == 1.0 for _, t in steps)
    # clipping engaged (grad norm above 0.5) and the loss went down
    assert max(t["grad_norm"] for _, t in steps) > CFG["gradient_clipping"]
    assert steps[-1][1]["loss"] < steps[0][1]["loss"]
    assert teng.global_steps == 3 and teng.micro_steps == 6
    np.testing.assert_allclose(teng.get_lr(), float(jeng.get_lr()), rtol=1e-6)
    # the model was fp32 on the engine's device: it trained in place
    assert teng.params["lm_head"].data_ptr() == \
        teng.model.lm_head.data_ptr()
    ev = teng.eval_batch({"input_ids": torch.from_numpy(_tokens(9, (4, 16)))})
    jev = jeng.eval_batch({"input_ids": jnp.asarray(_tokens(9, (4, 16)))})
    np.testing.assert_allclose(ev.item(), float(jev), rtol=1e-5)


def test_fp16_loss_scaling_matches_jax_engine():
    cfg = {"train_batch_size": 4, "gradient_clipping": 1.0,
           "optimizer": {"type": "adam", "params": {"lr": 1e-3}},
           "fp16": {"enabled": True, "initial_scale_power": 40,
                    "hysteresis": 2}}
    _, teng, steps, _ = _run_both(cfg, steps=4, seed=22, remat=False,
                                  use_flash=False)
    # a 2^40 loss scale overflows fp16: skip, consume hysteresis, back off
    assert [t["skipped"] for _, t in steps] == \
        [j["skipped"] for j, _ in steps]
    assert [t["loss_scale"] for _, t in steps] == \
        [j["loss_scale"] for j, _ in steps]
    assert steps[0][1]["skipped"] == 1
    assert teng.skipped_steps == sum(t["skipped"] for _, t in steps)


def test_batch_of_the_wrong_size_raises():
    _, _, tm = _models()
    eng, *_ = deepspeed_tpu_torch.initialize(model=tm, config=CFG,
                                             device="cpu")
    with pytest.raises(ValueError, match="train_batch_size"):
        eng.train_batch({"input_ids": torch.zeros(3, 8, dtype=torch.long)})


# ---------------------------------------------------------------- units
SCHEDULES = [
    ("WarmupLR", dict(warmup_min_lr=1e-4, warmup_max_lr=1e-2,
                      warmup_num_steps=10)),
    ("WarmupLR", dict(warmup_max_lr=1e-2, warmup_num_steps=10,
                      warmup_type="linear")),
    ("WarmupDecayLR", dict(total_num_steps=30, warmup_num_steps=5,
                           warmup_max_lr=3e-3)),
    ("WarmupCosineLR", dict(total_num_steps=30, warmup_num_steps=5,
                            warmup_min_ratio=0.1, warmup_max_lr=3e-3)),
    ("OneCycle", dict(cycle_min_lr=1e-4, cycle_max_lr=1e-2,
                      cycle_first_step_size=8, decay_step_size=3,
                      decay_lr_rate=0.5)),
    ("LRRangeTest", dict(lr_range_test_min_lr=1e-4,
                         lr_range_test_step_size=4,
                         lr_range_test_staircase=True)),
    (None, {}),
]


@pytest.mark.parametrize("name,params", SCHEDULES)
def test_lr_schedules_match_jax(name, params):
    # The JAX schedules compute in fp32 and the port's in fp64, so where
    # a formula cancels (OneCycle's way down) they differ by a few fp32
    # ulps of the largest lr in it: atol 1e-7 of that lr.
    got = sched.build_schedule(name, params, fallback_lr=2e-3)
    ref = jax_sched.build_schedule(name, params, fallback_lr=2e-3)
    top = max([v for k, v in params.items() if k.endswith("lr")] + [2e-3])
    for step in range(0, 40):
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-6,
                                   atol=1e-7 * top, err_msg=str(step))


@pytest.mark.parametrize("consecutive", [False, True])
def test_loss_scaler_sequence_matches_jax(consecutive):
    pattern = [True, False, True, False, False, True, True, True, False,
               False, False, True, True, True, True]
    kw = dict(scale_window=3, min_scale=2.0, consecutive_hysteresis=consecutive,
              init_hysteresis=2)
    s, j = ls.make_state(4, 2), jax_ls.make_state(4, 2)
    for finite in pattern:
        s = ls.update(s, finite, **kw)
        j = jax_ls.update(j, jnp.asarray(finite), **kw)
        assert (s.scale, s.good_steps, s.hysteresis) == \
            (float(j.scale), int(j.good_steps), int(j.hysteresis))
    static = ls.static_state(128.0)
    assert ls.update(static, False, dynamic=False) == static
    grads = [torch.ones(3), torch.tensor([1.0, float("inf")])]
    assert not bool(ls.grads_finite(grads))
    assert bool(ls.grads_finite(grads[:1]))


@pytest.mark.parametrize("kind", ["adamw", "adam-l2", "adam-no-bias-corr"])
def test_adam_rules_match_jax(kind):
    rng = np.random.default_rng(6)
    shapes = {"a": (5, 3), "b": (7,)}
    p0 = {n: rng.standard_normal(s).astype(np.float32)
          for n, s in shapes.items()}
    kw = {"adamw": dict(weight_decay=0.1),
          "adam-l2": dict(weight_decay=0.1, adam_w_mode=False),
          "adam-no-bias-corr": dict(bias_correction=False)}[kind]
    tr = opt.adam(lr=lambda c: 1e-2 / c, **kw)
    jr = jax_opt.adam(lr=lambda c: 1e-2 / c, **kw)
    tp = {n: torch.from_numpy(v.copy()) for n, v in p0.items()}
    jp = {n: jnp.asarray(v) for n, v in p0.items()}
    ts, js = tr.init(tp), jr.init(jp)
    for _ in range(3):
        g = {n: rng.standard_normal(s).astype(np.float32)
             for n, s in shapes.items()}
        ts = tr.update({n: torch.from_numpy(v) for n, v in g.items()}, ts, tp)
        upd, js = jr.update({n: jnp.asarray(v) for n, v in g.items()}, js, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        for n in shapes:
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                       rtol=1e-6, atol=1e-7)
    assert ts.count == int(js.count) == 3
    grads = [torch.from_numpy(v) for v in p0.values()]
    np.testing.assert_allclose(
        opt.global_norm(grads).item(),
        float(jax_global_norm([jnp.asarray(v) for v in p0.values()])),
        rtol=1e-6)


def test_optimizers_of_later_slices_raise():
    # the other rules are ported now: each builds, with its JAX rule's
    # state (held to JAX in tests/test_torch_optimizers.py)
    states = {"sgd": opt.SgdState, "lamb": opt.LambState,
              "lion": opt.LionState, "adagrad": opt.AdagradState}
    for name, state in states.items():
        t = opt.build_optimizer(name, {"lr": 1e-3})
        assert isinstance(t.init({"w": torch.zeros(2)}), state)
    with pytest.raises(ValueError, match="Unknown optimizer"):
        opt.build_optimizer("nope")
    assert isinstance(opt.build_optimizer("AdamW", {"lr": 1e-3,
                                                    "torch_adam": True}),
                      opt.Transform)


def test_remat_policies():
    fn = lambda x: x * 2  # noqa: E731
    # None reads the process-wide default, as the JAX function does
    saved = (ac._config, ac._configured)
    try:
        assert ac.checkpoint_wrapper(fn, None) is not fn      # "full"
        ac.configure(config_mod.ActivationCheckpointingConfig(policy="none"))
        assert ac.is_configured() and ac.checkpoint_wrapper(fn, None) is fn
    finally:
        ac._config, ac._configured = saved
    assert ac.checkpoint_wrapper(fn, "none") is fn
    x = torch.ones(3, requires_grad=True)
    ac.checkpoint(fn, x, policy="full").sum().backward()
    assert torch.equal(x.grad, torch.full((3,), 2.0))
    # every policy and offloaded residuals are ported now (held to JAX in
    # tests/test_torch_remat.py): each gives the function's gradient
    for policy in ("selective", "selective_flash", "dots_with_no_batch_dims",
                   "nothing"):
        y = torch.ones(3, requires_grad=True)
        ac.checkpoint(fn, y, policy=policy).sum().backward()
        assert torch.equal(y.grad, torch.full((3,), 2.0))
    y = torch.ones(3, requires_grad=True)
    ac.checkpoint(fn, y, policy="full", offload=True).sum().backward()
    assert torch.equal(y.grad, torch.full((3,), 2.0))
    with pytest.raises(ValueError, match="unknown remat policy"):
        ac.checkpoint_wrapper(fn, "everything")


@pytest.mark.parametrize("given,expect", [
    (dict(train_batch_size=8, train_micro_batch_size_per_gpu=2), (8, 2, 4)),
    (dict(train_batch_size=8, gradient_accumulation_steps=2), (8, 4, 2)),
    (dict(train_micro_batch_size_per_gpu=3, gradient_accumulation_steps=2),
     (6, 3, 2)),
    (dict(train_batch_size=6), (6, 6, 1)),
    (dict(train_micro_batch_size_per_gpu=5), (5, 5, 1)),
    (dict(train_batch_size=8, train_micro_batch_size_per_gpu=2,
          gradient_accumulation_steps=4), (8, 2, 4)),
    (dict(train_batch_size=8, train_micro_batch_size_per_gpu="auto",
          gradient_accumulation_steps=2), (8, 4, 2)),
])
def test_batch_resolution(given, expect):
    cfg = Config.from_dict(given)
    cfg.resolve_batch_config()
    assert (cfg.train_batch_size, cfg.train_micro_batch_size_per_gpu,
            cfg.gradient_accumulation_steps) == expect


@pytest.mark.parametrize("given,match", [
    (dict(train_batch_size=8, train_micro_batch_size_per_gpu=3), "divisible"),
    (dict(train_batch_size=8, train_micro_batch_size_per_gpu=2,
          gradient_accumulation_steps=3), "!="),
    (dict(train_batch_size=7, gradient_accumulation_steps=2), "divisible"),
    (dict(), "At least one"),
])
def test_batch_resolution_errors(given, match):
    with pytest.raises(ConfigError, match=match):
        Config.from_dict(given).resolve_batch_config()


@pytest.mark.parametrize("block", [
    {"zero_optimization": {"stage": 2, "mics_shard_size": 2}},
    {"zero_optimization": {"offload_optimizer": {"device": "cpu"}}},
    {"mesh": {"model": 2}, "zero_optimization": {"stage": 3}},
    {"pipeline": {"stages": 2}},
    {"zero_optimization": {"stage": 3, "zero_hpz_partition_size": 2}},
    {"telemetry": {"enabled": True}},
    {"checkpoint": {"load_universal": True}},
    {"mesh": {"expert": 2}},
    {"fp16": {"enabled": True}, "bf16": {"enabled": True}},
])
def test_config_blocks_of_later_slices_raise(block):
    if "telemetry" in block:
        # training telemetry is ported: the block is read, not refused
        cfg = Config.from_dict({"train_batch_size": 2, **block})
        assert cfg.telemetry.enabled is True
        return
    if "offload_optimizer" in block.get("zero_optimization", {}):
        # ZeRO offload is ported: the block is read, not refused
        cfg = Config.from_dict({"train_batch_size": 2, **block})
        assert cfg.zero.offload_optimizer.device == "cpu"
        return
    with pytest.raises(ConfigError):
        Config.from_dict({"train_batch_size": 2, **block})


def test_config_reads_this_slices_keys(monkeypatch):
    warned = []
    monkeypatch.setattr(config_mod.logger, "warning", warned.append)
    cfg = Config.from_dict({"train_batch_size": 2, "gradient_clipping": 1.0,
                            "steps_per_print": 5, "seed": 7,
                            "bf16": {"enabled": True},
                            "zero_optimization": {"stage": 0},
                            "mesh": {"data": 1},
                            "optimizer": {"type": "AdamW",
                                          "params": {"lr": 3e-4}}})
    assert (cfg.gradient_clipping, cfg.steps_per_print) == (1.0, 5)
    # `seed` is the trainer's random stream and the loader's shuffle
    assert cfg.train_seed == 7 and warned == []
    assert Config.from_dict({}).train_seed == 42
    assert cfg.dataloader.prefetch_depth == 2
    assert cfg.compute_dtype == torch.bfloat16
    assert cfg.optimizer.type == "adamw" and cfg.optimizer.params["lr"] == 3e-4
    assert Config.from_dict({"fp16": {"enabled": True}}).compute_dtype == \
        torch.float16
    assert Config.from_any(None).compute_dtype == torch.float32
