"""The port's optimizer rules against the JAX package's, on the CPU.

* Each rule of ``runtime/optimizers.py`` (SGD plain / momentum /
  Nesterov, LAMB, Lion, Adagrad, with weight decay) over 5 updates of the
  same numpy-seeded parameters and gradients as the JAX rule: every
  element within 1e-6 relative.
* The registry names the rules JAX's names, alias for alias;
  ``build_optimizer`` renames and drops the reference's keys as JAX's
  does; ``as_transform`` takes a Transform or an init/update object.
* Three ``train_batch`` steps of a tiny Llama for each rule by its config
  name against JAX's ``TrainEngine``, through ``tests/
  torch_train_parity.py`` (its tolerances).
* Every rule at every layout ``train_batch`` takes (ZeRO stages 1-3 over
  two gloo ranks, tensor parallelism 2) against one rank: LAMB's trust
  ratio reads whole-leaf norms over a cut layout (``leaf_sq_sums``); and
  the compat ``backward`` / ``step`` path at each layout bitwise
  ``train_batch``.
* On the card (``gpu``): each rule, two fp32 steps of a 2-layer model on
  cuda against the CPU.

The JAX package is imported inside the tests that use it, so the card's
machine (no JAX) collects the file and runs its ``gpu`` case.
"""

import copy

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as tdst
from deepspeed_tpu_torch.checkpoint.jax_params import (export_params,
                                                       load_jax_params)
from deepspeed_tpu_torch.models.llama import Llama
from deepspeed_tpu_torch.runtime import optimizers as opt

import torch_ranks


def _jax():
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.runtime import optimizers as jax_opt

    return jax, jnp, jax_opt


RULES = {
    "sgd": ("sgd", dict(lr=0.1, weight_decay=0.01)),
    "sgd_momentum": ("sgd", dict(lr=0.1, momentum=0.9, weight_decay=0.01)),
    "sgd_nesterov": ("sgd", dict(lr=0.1, momentum=0.9, nesterov=True)),
    "lamb": ("lamb", dict(lr=1e-2, weight_decay=0.01)),
    "lion": ("lion", dict(lr=1e-3, weight_decay=0.1)),
    "adagrad": ("adagrad", dict(lr=1e-2, weight_decay=0.01,
                                initial_accumulator_value=0.1)),
}
SHAPES = {"w": (8, 16), "b": (16,), "zero": (4, 4)}


def _tree(seed):
    rng = np.random.default_rng(seed)
    out = {n: rng.standard_normal(s).astype(np.float32)
           for n, s in SHAPES.items()}
    out["zero"][:] = 0.0          # LAMB's trust ratio at |w| = 0
    return out


@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_matches_jax_over_five_updates(rule):
    jax, jnp, jax_opt = _jax()
    name, kw = RULES[rule]
    jt = getattr(jax_opt, name)(**kw)
    tt = getattr(opt, name)(**kw)
    p0 = _tree(0)
    jp = {n: jnp.asarray(v) for n, v in p0.items()}
    tp = {n: torch.from_numpy(v.copy()) for n, v in p0.items()}
    js, ts = jt.init(jp), tt.init(tp)
    for step in range(5):
        g = _tree(10 + step)
        upd, js = jt.update({n: jnp.asarray(v) for n, v in g.items()}, js,
                            jp)
        jp = {n: jp[n] + upd[n] for n in jp}
        ts = tt.update({n: torch.from_numpy(v) for n, v in g.items()}, ts,
                       tp)
        for n in SHAPES:
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                       rtol=1e-6, atol=1e-7)
    assert ts.count == int(js.count) == 5


def test_registry_and_build_optimizer_follow_jax():
    jax, jnp, jax_opt = _jax()
    assert set(opt.OPTIMIZER_REGISTRY) == set(jax_opt.OPTIMIZER_REGISTRY)
    for key, factory in jax_opt.OPTIMIZER_REGISTRY.items():
        assert opt.OPTIMIZER_REGISTRY[key].__name__ == factory.__name__, key
    # the reference's spellings: adamw_mode, dropped 1-bit / CUDA keys
    params = {"lr": 1e-2, "betas": [0.8, 0.9], "adamw_mode": False,
              "weight_decay": 0.1, "freeze_step": 10, "cuda_aware": True,
              "comm_backend_name": "nccl"}
    for name in ("OneBitAdam", "fused_lamb", "cpu-adagrad", "ZeroOneAdam"):
        jt = jax_opt.build_optimizer(name, dict(params))
        tt = opt.build_optimizer(name, dict(params))
        p0 = _tree(1)
        jp = {n: jnp.asarray(v) for n, v in p0.items()}
        tp = {n: torch.from_numpy(v.copy()) for n, v in p0.items()}
        js, ts = jt.init(jp), tt.init(tp)
        g = _tree(2)
        upd, js = jt.update({n: jnp.asarray(v) for n, v in g.items()}, js,
                            jp)
        tt.update({n: torch.from_numpy(v) for n, v in g.items()}, ts, tp)
        for n in SHAPES:
            np.testing.assert_allclose(tp[n].numpy(),
                                       np.asarray(jp[n] + upd[n]),
                                       rtol=1e-6, atol=1e-7)


def test_as_transform():
    t = opt.adamw(1e-3)
    assert opt.as_transform(t) is t

    class Client:
        def init(self, params):
            return 0

        def update(self, grads, state, params):
            for n, p in params.items():
                p.sub_(grads[n])
            return state + 1

    c = opt.as_transform(Client())
    p = {"w": torch.ones(3)}
    assert c.update({"w": torch.ones(3)}, c.init(p), p) == 1
    assert torch.equal(p["w"], torch.zeros(3))
    with pytest.raises(TypeError, match="optimizer"):
        opt.as_transform(object())


TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, vocab_size=128,
            max_seq_len=64, remat=True, use_flash=True)
ENGINE_RULES = {"sgd": {"lr": 1e-2, "momentum": 0.9, "weight_decay": 0.01},
                "lamb": {"lr": 1e-2, "weight_decay": 0.01},
                "lion": {"lr": 1e-3, "weight_decay": 0.01},
                "adagrad": {"lr": 1e-2, "weight_decay": 0.01}}


@pytest.mark.parametrize("name", sorted(ENGINE_RULES))
def test_train_batch_each_rule_matches_jax(name):
    jax, _, _ = _jax()
    from deepspeed_tpu.models import Llama as JaxLlama
    from torch_train_parity import CFG, assert_parity, run_both

    jm = JaxLlama("tiny", **TINY)
    jparams = jm.init(jax.random.PRNGKey(3))
    tm = load_jax_params(Llama("tiny", device="cpu", **TINY),
                         jax.tree_util.tree_map(np.asarray, jparams))
    cfg = {**CFG, "optimizer": {"type": name,
                                "params": ENGINE_RULES[name]}}
    rng = np.random.default_rng(7)
    batches = [{"input_ids": rng.integers(0, 128, (4, 16)).astype(np.int32)}
               for _ in range(3)]
    jeng, teng, steps, min_abs_g = run_both(jm, jparams, tm, batches, cfg)
    assert_parity(jeng, teng, steps, min_abs_g)


LAYOUT_TINY = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                   vocab_size=64, max_seq_len=16, use_flash=False,
                   remat=False)
LAYOUTS = {"stage1": ({"data": 2}, 1), "stage2": ({"data": 2}, 2),
           "stage3": ({"data": 2}, 3), "tp2": ({"model": 2}, 0)}


def test_every_rule_at_every_layout_matches_one_rank():
    src = Llama("tiny", device="cpu", seed=4, **LAYOUT_TINY)
    base = {"train_batch_size": 8, "gradient_accumulation_steps": 2,
            "seed": 5, "steps_per_print": 1000, "gradient_clipping": 1.0}
    rng = np.random.default_rng(11)
    case = {"family": "dense",
            "config": {**LAYOUT_TINY, "norm": "rms",
                       "activation": "silu_glu", "position": "rope",
                       "tie_embeddings": False, "use_bias": False},
            "params": export_params(src), "cfg": base,
            "batches": [{"input_ids": rng.integers(0, 64, (8, 16)).astype(
                np.int32)} for _ in range(2)]}
    runs = {f"{name}-{lay}": (mesh, stage, {"type": name, "params": kw},
                              False)
            for name, kw in ENGINE_RULES.items()
            for lay, (mesh, stage) in LAYOUTS.items()}
    # the compat micro-step path at each layout, bitwise train_batch's
    runs.update({f"compat-{lay}": (mesh, stage, {
        "type": "lamb", "params": ENGINE_RULES["lamb"]}, True)
        for lay, (mesh, stage) in LAYOUTS.items()})
    res = torch_ranks.start_ranks(2, "optimizer_layout_job", case,
                                  runs).results()
    for name, kw in ENGINE_RULES.items():
        ref = tdst.initialize(
            model=load_jax_params(Llama("tiny", device="cpu",
                                        **LAYOUT_TINY), case["params"]),
            config={**base, "optimizer": {"type": name, "params": kw}},
            device="cpu")[0]
        ref_steps = [ref.train_batch({k: torch.from_numpy(v)
                                      for k, v in b.items()})
                     for b in case["batches"]]
        for lay in LAYOUTS:
            r0, r1 = res[0][f"{name}-{lay}"], res[1][f"{name}-{lay}"]
            assert r0["steps"] == r1["steps"], (name, lay)
            for (loss, gn, skipped), m in zip(r0["steps"], ref_steps):
                assert not skipped
                np.testing.assert_allclose(loss, float(m["loss"]),
                                           rtol=1e-5)
                np.testing.assert_allclose(gn, float(m["grad_norm"]),
                                           rtol=1e-5)
            for n, w in ref.params.items():
                np.testing.assert_allclose(r0["full"][n], w.numpy(),
                                           rtol=1e-4, atol=2e-5,
                                           err_msg=f"{name} {lay} {n}")
    for lay in LAYOUTS:
        got, ref = res[0][f"compat-{lay}"], res[0][f"lamb-{lay}"]
        # over data ranks the compat losses sum each micro-batch's shares
        # (train_batch sums the step's): the same value in another order
        np.testing.assert_allclose([s[0] for s in got["steps"]],
                                   [s[0] for s in ref["steps"]], rtol=1e-6)
        assert all(np.array_equal(got["full"][n], w)
                   for n, w in ref["full"].items()), lay


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(ENGINE_RULES))
def test_cuda_rule_trains_as_on_the_cpu(name):
    """One fp32 step (GAS 2) of a 2-layer Llama (head dim 64) on the card
    and on the CPU from the same weights, as chip phase 7 holds AdamW:
    loss within 1e-5, grad norm within 1e-4, the masters within 1e-5
    (TF32 off) but where the gradient the rule sees (Adagrad's and SGD's
    with the weight decay folded in) is within 1e-6 of 0: there a
    sign-like first step (Adagrad's lr g / (|g| + eps), Lion's sign,
    LAMB's eps) may flip, by at most 2 lr. (A second step would carry a
    flipped weight into every later gradient; the rules' state over 5
    updates is held to JAX's on the CPU.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kw = dict(n_layers=2, d_model=128, n_heads=2, n_kv_heads=1,
              vocab_size=256, max_seq_len=64, use_flash=True)
    params = ENGINE_RULES[name]
    cfg = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
           "gradient_clipping": 1.0, "steps_per_print": 1000,
           "optimizer": {"type": name, "params": params}}
    wd = params.get("weight_decay", 0.0) if name in ("sgd", "adagrad") \
        else 0.0
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (4, 64)))
    lo = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        cpu_model = Llama("tiny", device="cpu", seed=3, **kw)
        models = {"cuda": copy.deepcopy(cpu_model).to("cuda"),
                  "cpu": cpu_model}         # one set of weights
        for dev in ("cuda", "cpu"):
            eng = tdst.initialize(model=models[dev], config=cfg,
                                  device=dev)[0]
            if dev == "cpu":
                inner = eng.optimizer

                def update(grads, state, params, inner=inner):
                    for n, g in grads.items():
                        a = (g + params[n] * wd).abs()
                        lo[n] = torch.minimum(lo[n], a) if n in lo else a
                    return inner.update(grads, state, params)

                eng.optimizer = opt.Transform(inner.init, update)
            ms = [eng.train_batch({"input_ids": toks})]
            out[dev] = ([float(m["loss"]) for m in ms],
                        [float(m["grad_norm"]) for m in ms],
                        {n: p.cpu() for n, p in eng.params.items()})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-4)
    for n, w in out["cpu"][2].items():
        d = (out["cuda"][2][n] - w).abs()
        beyond = d > 1e-5
        assert bool((lo[n][beyond] < 1e-6).all()), n
        assert float(d.max()) <= 2 * params["lr"] + 2.4e-7, n
