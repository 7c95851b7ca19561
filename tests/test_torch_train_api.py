"""The rest of the trainer's API against the JAX package's, on the CPU.

* The compat micro-step path (``forward`` / ``backward`` / ``step``):
  bitwise the port's ``train_batch``, and against JAX's compat path
  (``tests/test_engine.py::test_micro_step_api_matches_fused``) within
  1e-5; ``step`` does nothing off the accumulation boundary.
* ``train_steps``: bitwise k ``train_batch`` calls (losses, grad norms,
  masters), the bound loader's position after ``train_steps(k)`` and
  across an epoch (``tests/test_perf_pipeline.py``'s), and the per-step
  fallback with each of JAX's reasons (hooks, the preemption guard, the
  divergence guard).
* Warmup: ``warmup`` / ``warmup_async`` on a batch or the loader's
  ``batch_struct``, a later step bitwise a run without it, a failing
  warmup returning False with a warning; ``prefetch``.
* A client optimizer (a Transform, or an init/update object) and
  ``register_param_transform`` (against JAX's, within 1e-5; it joins an
  in-flight warmup).
* On the card (``gpu``): ``train_steps(3)`` bitwise three ``train_batch``
  calls, and the compat path bitwise ``train_batch``.

The JAX package is imported inside the tests that use it, so the card's
machine (no JAX) collects the file and runs its ``gpu`` cases.
"""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as tdst
from deepspeed_tpu_torch.models.llama import Llama
from deepspeed_tpu_torch.runtime import engine as engine_mod
from deepspeed_tpu_torch.runtime import optimizers as opt
from deepspeed_tpu_torch.runtime.dataloader import (DataLoader, TensorSpec,
                                                    prefetch)

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, vocab_size=128,
            max_seq_len=64, remat=True, use_flash=True)
CFG = {"train_batch_size": 8, "gradient_accumulation_steps": 2,
       "gradient_clipping": 1.0, "steps_per_print": 1000, "seed": 3,
       "optimizer": {"type": "adamw",
                     "params": {"lr": 1e-2, "weight_decay": 0.1}}}


def _engine(cfg=None, device="cpu", seed=1, **kw):
    return tdst.initialize(model=Llama("tiny", device=device, seed=seed,
                                       **{**TINY, **kw}),
                           config={**CFG, **(cfg or {})}, device=device)[0]


def _batches(n, seed=0, rows=8):
    rng = np.random.default_rng(seed)
    return [{"input_ids": torch.from_numpy(
        rng.integers(0, 128, (rows, 16)).astype(np.int64))}
        for _ in range(n)]


def _same_masters(a, b):
    return all(torch.equal(a.params[n], b.params[n]) for n in a.params)


# ---------------------------------------------------------------- compat
def test_compat_path_bitwise_train_batch():
    fused, compat = _engine(), _engine()
    for b in _batches(2):
        mbs = [{k: v[i * 4:(i + 1) * 4] for k, v in b.items()}
               for i in range(2)]
        assert torch.equal(compat.forward(mbs[0]), fused.eval_batch(mbs[0]))
        m = fused.train_batch(b)
        l0 = compat.backward(mbs[0])
        compat.step()                       # off the boundary: nothing
        assert compat.global_steps == fused.global_steps - 1
        assert compat.is_gradient_accumulation_boundary()
        l1 = compat.backward(mbs[1])
        compat.step()
        assert torch.equal((l0 + l1) * 0.5, m["loss"])
    assert compat.global_steps == 2 and compat.micro_steps == 4
    assert _same_masters(fused, compat)
    with pytest.raises(ValueError, match="micro-batch"):
        compat.backward(_batches(1)[0])


def test_compat_path_matches_jax():
    import jax
    import jax.numpy as jnp

    import deepspeed_tpu as jdst
    from deepspeed_tpu.models import Llama as JaxLlama
    from deepspeed_tpu.parallel.mesh import Topology
    from deepspeed_tpu_torch.checkpoint.jax_params import load_jax_params
    from torch_train_parity import assert_weights, flat_jax

    jm = JaxLlama("tiny", **TINY)
    jparams = jm.init(jax.random.PRNGKey(4))
    tm = load_jax_params(Llama("tiny", device="cpu", **TINY),
                         jax.tree_util.tree_map(np.asarray, jparams))
    je = jdst.initialize(model=jm, params=jparams, config=CFG,
                         topology=Topology.build_virtual({"data": 1}))[0]
    te = tdst.initialize(model=tm, config=CFG, device="cpu")[0]
    min_abs_g = {}
    inner = te.optimizer

    def update(grads, state, params):
        min_abs_g.update({n: (g.abs().numpy(), float(g.abs().max()))
                          for n, g in grads.items()})
        return inner.update(grads, state, params)

    te.optimizer = opt.Transform(inner.init, update)
    b = _batches(1, seed=5)[0]["input_ids"].numpy().astype(np.int32)
    for i in range(2):
        mb = b[i * 4:(i + 1) * 4]
        jl = je.backward({"input_ids": jnp.asarray(mb)})
        tl = te.backward({"input_ids": torch.from_numpy(mb)})
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        je.step()
        te.step()
    assert je.global_steps == te.global_steps == 1
    # the weights by torch_train_parity's rule (2e-5, but where a
    # gradient element is near Adam's eps)
    ref = flat_jax(jax.tree_util.tree_map(np.asarray, je.params))
    assert_weights({n: w.numpy() for n, w in te.params.items()}, ref,
                   min_abs_g, te.lr_schedule(1))


# ------------------------------------------------------------ train_steps
@pytest.mark.parametrize("k", [2, 4])
def test_train_steps_bitwise_train_batch(k):
    per, fused = _engine(), _engine()
    batches = _batches(k, seed=k)
    ms = [per.train_batch(b) for b in batches]
    out = fused.train_steps(batches)
    assert torch.equal(out["losses"], torch.stack([m["loss"] for m in ms]))
    assert torch.equal(out["grad_norms"],
                       torch.stack([m["grad_norm"] for m in ms]))
    assert torch.equal(out["loss"], ms[-1]["loss"])
    assert _same_masters(per, fused)
    assert fused.global_steps == per.global_steps == k
    assert fused.micro_steps == per.micro_steps == 2 * k


def test_train_steps_pulls_from_the_bound_loader():
    data = {"input_ids": np.random.default_rng(0).integers(
        0, 128, (32, 16)).astype(np.int64)}
    eng, _, loader, _ = tdst.initialize(
        model=Llama("tiny", device="cpu", seed=1, **TINY), config=CFG,
        training_data=data, device="cpu")
    out = eng.train_steps(3)
    assert len(out["losses"]) == 3
    assert loader.state_dict()["batch_index"] == 3
    eng.train_steps(2)              # crosses into the next epoch
    assert eng.global_steps == 5
    assert loader.state_dict() == {"epoch": 1, "batch_index": 1,
                                   "seed": loader.seed}
    # the same batches through train_batch, bitwise
    ref = tdst.initialize(model=Llama("tiny", device="cpu", seed=1, **TINY),
                          config=CFG, training_data=data, device="cpu")
    it = iter(ref[2])
    for _ in range(4):
        ref[0].train_batch(next(it))
    ref[2].set_epoch(1)
    ref[0].train_batch(next(iter(ref[2])))
    assert _same_masters(ref[0], eng)


def _fallback(eng, monkeypatch, want):
    ok, reason = eng.train_steps_eligible()
    assert not ok and want in reason
    logged = []
    monkeypatch.setattr(engine_mod, "log_dist",
                        lambda msg, *a, **k: logged.append(msg))
    out = eng.train_steps(_batches(3))
    eng.train_steps(_batches(2))
    assert eng.global_steps == 5 and len(out["losses"]) == 3
    logged = [m for m in logged if "ineligible" in m]
    assert len(logged) == 1 and want in logged[0]


def test_train_steps_falls_back_with_step_hooks(monkeypatch):
    eng = _engine()
    calls = []
    eng.register_step_hook(lambda _e, step: calls.append(step))
    _fallback(eng, monkeypatch, "hook")
    assert calls == [0, 1, 2, 3, 4]


def test_train_steps_falls_back_with_the_preemption_guard(monkeypatch):
    eng = _engine()
    eng.attach_preemption_guard()
    _fallback(eng, monkeypatch, "preemption")


def test_train_steps_falls_back_with_the_divergence_guard(monkeypatch):
    eng = _engine({"resilience": {"divergence": {"spike_action": "warn"}}})
    _fallback(eng, monkeypatch, "divergence")


# ----------------------------------------------------------------- warmup
def test_warmup_then_a_step_bitwise_a_run_without(monkeypatch):
    warm, cold = _engine(), _engine()
    b = _batches(1)[0]
    assert warm.warmup(b) is True
    assert warm._count_batch_tokens() == 8 * 16
    t = warm.warmup_async({"input_ids": TensorSpec((8, 16), torch.int64)})
    m = warm.train_batch(b)
    assert not t.is_alive() and warm._warmup_thread is None
    assert torch.equal(m["loss"], cold.train_batch(b)["loss"])
    assert _same_masters(warm, cold)
    warned = []
    monkeypatch.setattr(engine_mod.logger, "warning", warned.append)
    assert warm.warmup(_batches(1, rows=4)[0]) is False
    assert any("warmup failed" in w for w in warned)


def test_loader_batch_struct_and_prefetch():
    data = {"input_ids": np.arange(64 * 16).reshape(64, 16)}
    loader = DataLoader(data, 8, "cpu", seed=2)
    struct = loader.batch_struct()
    assert struct == {"input_ids": TensorSpec((8, 16), torch.int64)}
    assert loader.state_dict()["batch_index"] == 0
    first = next(iter(loader))
    assert tuple(first["input_ids"].shape) == struct["input_ids"].shape
    eng = _engine()
    assert eng.warmup(struct) is True
    got = list(prefetch(iter(DataLoader(data, 8, "cpu", seed=2)), size=3,
                        device="cpu"))
    ref = list(DataLoader(data, 8, "cpu", seed=2))
    assert len(got) == len(ref) == 8
    assert all(torch.equal(a["input_ids"], b["input_ids"])
               for a, b in zip(got, ref))


# ------------------------------------------- client optimizer, transform
def test_client_optimizer():
    cfg_run = _engine({"optimizer": {"type": "sgd", "params": {
        "lr": 1e-2, "momentum": 0.9}}})
    client = tdst.initialize(
        model=Llama("tiny", device="cpu", seed=1, **TINY), config=CFG,
        optimizer=opt.sgd(lr=1e-2, momentum=0.9), device="cpu")
    assert client[1] is client[0].optimizer
    for b in _batches(2):
        assert torch.equal(cfg_run.train_batch(b)["loss"],
                           client[0].train_batch(b)["loss"])
    assert _same_masters(cfg_run, client[0])

    class Halve:
        def init(self, params):
            return 0

        def update(self, grads, state, params):
            for n, p in params.items():
                p.mul_(0.5)
            return state + 1

    eng = tdst.initialize(model=Llama("tiny", device="cpu", seed=1, **TINY),
                          config=CFG, optimizer=Halve(), device="cpu")[0]
    before = {n: p.clone() for n, p in eng.params.items()}
    eng.train_batch(_batches(1)[0])
    assert eng.opt_state == 1
    assert all(torch.equal(eng.params[n], before[n] * 0.5) for n in before)
    with pytest.raises(TypeError, match="optimizer"):
        tdst.initialize(model=Llama("tiny", device="cpu", **TINY),
                        config=CFG, optimizer=object(), device="cpu")


def test_register_param_transform_matches_jax():
    import jax

    import deepspeed_tpu as jdst
    from deepspeed_tpu.models import Llama as JaxLlama
    from deepspeed_tpu.parallel.mesh import Topology
    from deepspeed_tpu_torch.checkpoint.jax_params import load_jax_params

    jm = JaxLlama("tiny", **TINY)
    jparams = jm.init(jax.random.PRNGKey(6))
    tm = load_jax_params(Llama("tiny", device="cpu", **TINY),
                         jax.tree_util.tree_map(np.asarray, jparams))
    je = jdst.initialize(model=jm, params=jparams, config=CFG,
                         topology=Topology.build_virtual({"data": 1}))[0]
    te = tdst.initialize(model=tm, config=CFG, device="cpu")[0]
    te.warmup_async(_batches(1)[0])
    te.register_param_transform(
        lambda p: {n: t * 0.9 for n, t in p.items()})
    assert te._warmup_thread is None           # joined
    je.register_param_transform(
        lambda p: jax.tree_util.tree_map(lambda x: x * 0.9, p))
    for b in _batches(2, seed=8):
        jm_ = je.train_batch({"input_ids": b["input_ids"].numpy().astype(
            np.int32)})
        tm_ = te.train_batch(b)
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm_["grad_norm"]),
                                   float(jm_["grad_norm"]), rtol=1e-5)
    plain = _engine()
    b = _batches(1, seed=9)[0]
    assert not torch.equal(te.eval_batch(b), plain.eval_batch(b))
    te.register_param_transform(None)
    assert te._param_transform is None


# ---------------------------------------------------------------- the card
@pytest.mark.gpu
def test_cuda_train_steps_and_compat_bitwise_train_batch():
    """A 2-layer Llama at head dim 64 in bf16: ``train_steps(3)`` bitwise
    three ``train_batch`` calls, and the compat path bitwise
    ``train_batch``, from the same weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    kw = dict(d_model=256, n_heads=4, n_kv_heads=2, vocab_size=512,
              max_seq_len=256)
    cfg = {"bf16": {"enabled": True}}
    rng = np.random.default_rng(1)
    batches = [{"input_ids": torch.from_numpy(rng.integers(
        0, 512, (8, 256))).cuda()} for _ in range(3)]
    per = _engine(cfg, device="cuda", **kw)
    fused = _engine(cfg, device="cuda", **kw)
    compat = _engine(cfg, device="cuda", **kw)
    ms = [per.train_batch(b) for b in batches]
    out = fused.train_steps(batches)
    for b in batches:
        for i in range(2):
            compat.backward({"input_ids": b["input_ids"][i * 4:(i + 1) * 4]})
            compat.step()
    torch.cuda.synchronize()
    assert torch.equal(out["losses"], torch.stack([m["loss"] for m in ms]))
    assert _same_masters(per, fused) and _same_masters(per, compat)
