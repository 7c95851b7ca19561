"""The port's remat policies against the JAX package's, on the CPU.

* Each policy of ``runtime/activation_checkpointing.py`` (``full``,
  ``selective``, ``selective_flash``, ``dots_with_no_batch_dims``,
  ``nothing``, and offloaded residuals): a tiny Llama's loss and
  gradients against the JAX model under the same policy, within 1e-5,
  and bitwise the port's ``full`` (recomputation repeats the same ops on
  the same inputs).
* The flash-attention op's calls a step through ``TrainEngine`` at GAS 2,
  counted on the CPU per policy: 2 L g under ``full``, ``selective`` and
  ``dots_with_no_batch_dims`` (the forward replayed), L g under
  ``selective_flash`` and ``nothing``.
* The dot rulings (which aten ops each policy saves), ``configure`` /
  ``is_configured``, the Megatron names and the ``activation_
  checkpointing`` config block against JAX's.
* On the card (``gpu``): the launches of rows 2-4 per policy, all on the
  Hopper kernels, and the step bitwise across policies.

The JAX package is imported inside the tests that use it, so the card's
machine (no JAX) collects the file and runs its ``gpu`` case.
"""

import dataclasses

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as tdst
from deepspeed_tpu_torch.config import ActivationCheckpointingConfig, Config
from deepspeed_tpu_torch.models.llama import Llama
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.runtime import activation_checkpointing as ac

POLICIES = ("full", "selective", "selective_flash",
            "dots_with_no_batch_dims", "nothing")
REPLAYED = ("full", "selective", "dots_with_no_batch_dims")
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, vocab_size=128,
            max_seq_len=64, remat=True, use_flash=True)


@pytest.fixture
def restore_config():
    # configure(**kw) sets fields on the config object: keep a copy
    saved = (dataclasses.replace(ac._config), ac._configured)
    yield
    ac._config, ac._configured = saved


def _port_grads(model, toks):
    p = {n: w.detach().clone().requires_grad_(True)
         for n, w in model.named_parameters()}
    loss = model.loss({"input_ids": torch.from_numpy(toks).long()}, params=p)
    grads = torch.autograd.grad(loss, list(p.values()))
    return loss.detach(), dict(zip(p, grads))


def _jax_model(policy):
    import jax

    from deepspeed_tpu.models import Llama as JaxLlama

    jm = JaxLlama("tiny", remat_policy=policy, **TINY)
    return jm, jm.init(jax.random.PRNGKey(5))


@pytest.mark.parametrize("policy", POLICIES + ("offload",))
def test_policy_matches_jax_and_full_bitwise(policy, restore_config):
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu_torch.checkpoint.jax_params import load_jax_params
    from torch_train_parity import flat_jax

    toks = np.random.default_rng(3).integers(0, 128, (2, 16)).astype(
        np.int32)
    jpol = "full" if policy == "offload" else policy
    jm, jparams = _jax_model(jpol)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        jparams, {"input_ids": jnp.asarray(toks)})
    jgrads = flat_jax(jax.tree_util.tree_map(np.asarray, jgrads))

    full = load_jax_params(Llama("tiny", device="cpu", **TINY), np_params)
    ref_loss, ref_grads = _port_grads(full, toks)
    if policy == "offload":
        ac.configure(cpu_checkpointing=True)
    model = load_jax_params(Llama("tiny", device="cpu", remat_policy=jpol,
                                  **TINY), np_params)
    loss, grads = _port_grads(model, toks)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[n], rtol=1e-5,
                                   atol=1e-5, err_msg=n)
        assert torch.equal(g, ref_grads[n]), n
    assert torch.equal(loss, ref_loss)


@pytest.mark.parametrize("policy", POLICIES)
def test_flash_calls_a_step_per_policy(policy, monkeypatch):
    calls = []
    inner = fa.flash_forward

    def counting(*args, **kwargs):
        calls.append(1)
        return inner(*args, **kwargs)

    monkeypatch.setattr(fa, "flash_forward", counting)
    eng = tdst.initialize(
        model=Llama("tiny", device="cpu", seed=1, remat_policy=policy,
                    **TINY),
        config={"train_batch_size": 4, "gradient_accumulation_steps": 2,
                "steps_per_print": 1000}, device="cpu")[0]
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 128, (4, 16)))
    eng.train_batch({"input_ids": toks})
    layers, gas = TINY["n_layers"], 2
    assert len(calls) == (2 if policy in REPLAYED else 1) * layers * gas


def test_dot_rulings():
    aten = torch.ops.aten
    saved = {name: ops() for name, ops in ac._SELECTIVE.items()}
    for op in (aten.mm.default, aten.mm.dtype, aten.addmm.default):
        assert all(op in s for s in saved.values())
    for op in (aten.bmm.default, aten.convolution.default):
        assert op in saved["selective"]
        assert op not in saved["dots_with_no_batch_dims"]
    flash = torch.ops.dst.flash_attention.default
    assert [n for n, s in saved.items() if flash in s] == ["selective_flash"]
    assert all(aten._grouped_mm.default not in s for s in saved.values())
    with pytest.raises(ValueError, match="unknown remat policy"):
        ac.checkpoint_wrapper(lambda x: x, "everything")


def test_configure_and_config_block_follow_jax(restore_config):
    from deepspeed_tpu.config import ActivationCheckpointingConfig as JCfg
    from deepspeed_tpu.runtime import activation_checkpointing as jac

    block = {"partition_activations": True, "cpu_checkpointing": True,
             "number_checkpoints": 4, "profile": True,
             "policy": "selective_flash"}
    assert vars(ActivationCheckpointingConfig.from_dict(block)) == vars(
        JCfg.from_dict(block))
    cfg = Config.from_dict({"train_batch_size": 2,
                            "activation_checkpointing": block})
    assert cfg.activation_checkpointing.policy == "selective_flash"
    fn = lambda x: x * 3  # noqa: E731
    ac.configure(policy="none")
    assert ac.is_configured() and ac.checkpoint_wrapper(fn) is fn
    ac.configure(ActivationCheckpointingConfig(policy="nothing"))
    assert ac.checkpoint_wrapper(fn) is fn
    ac.model_parallel_cuda_manual_seed(3)
    assert ac.get_rng_state_tracker() is jac.get_rng_state_tracker() is None


@pytest.mark.gpu
def test_cuda_policies_launch_the_table_on_the_hopper_kernels():
    """A 2-layer Llama at head dim 64 in bf16, one step at GAS 2 from the
    same weights under each policy: rows 2-4's launches as the table
    (forward 2 L g where the forward is replayed, else L g; dq and dk/dv
    L g), all on the Hopper kernels, and loss and grad norm bitwise
    ``full``'s."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    kw = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
              vocab_size=512, max_seq_len=256, remat=True, use_flash=True)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 512, (4, 256))).cuda()
    out = {}
    for policy in POLICIES:
        eng = tdst.initialize(
            model=Llama("tiny", seed=1, remat_policy=policy, **kw),
            config={"train_batch_size": 4, "gradient_accumulation_steps": 2,
                    "bf16": {"enabled": True},
                    "steps_per_print": 1000})[0]
        counters = (fa.flash_forward, fa.flash_backward_dq,
                    fa.flash_backward_dkv)
        for c in counters:
            c.launches = c.wgmma_launches = 0
        m = eng.train_batch({"input_ids": toks})
        torch.cuda.synchronize()
        fwd = (2 if policy in REPLAYED else 1) * 2 * 2
        assert [c.launches for c in counters] == [fwd, 4, 4], policy
        assert [c.wgmma_launches for c in counters] == [fwd, 4, 4], policy
        out[policy] = (m["loss"].item(), m["grad_norm"].item())
    assert len(set(out.values())) == 1, out
