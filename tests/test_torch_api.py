"""``models/api.py``: the port's ``from_module`` against the JAX package's
``from_flax``, on the CPU in fp32.

A two-layer flax MLP wrapped by ``deepspeed_tpu.models.api.from_flax`` and
its torch twin wrapped by ``deepspeed_tpu_torch.models.api.from_module``
get the same weights and the same numpy-seeded batches, and train 3 AdamW
steps (GAS 2, clipping, the warm-up schedule) through each package's
``initialize``: losses and grad norms within 1e-5 relative, the weights
after the steps within 2e-5. Both with a ``loss_fn`` on the module's
output and with ``loss_fn=None``, where the module returns the loss.
The card's case is in ``tests/test_torch_api_gpu.py`` (a file without
JAX or flax, which the chip machine does not have).
"""

import numpy as np
import pytest
import torch
from torch import nn

import flax.linen as fnn
import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.api import from_flax
from deepspeed_tpu.parallel.mesh import Topology
from deepspeed_tpu_torch.models.api import FromModule, from_module

from torch_train_parity import CFG

D_IN, HIDDEN, D_OUT = 8, 16, 4


class FlaxMLP(fnn.Module):
    returns_loss: bool = False

    @fnn.compact
    def __call__(self, batch):
        h = jnp.tanh(fnn.Dense(HIDDEN)(batch["x"]))
        out = fnn.Dense(D_OUT)(h)
        if self.returns_loss:
            return jnp.mean(jnp.square(out - batch["y"]))
        return out


class TorchMLP(nn.Module):
    def __init__(self, returns_loss: bool = False):
        super().__init__()
        self.returns_loss = returns_loss
        self.fc1 = nn.Linear(D_IN, HIDDEN)
        self.fc2 = nn.Linear(HIDDEN, D_OUT)

    def forward(self, batch):
        out = self.fc2(torch.tanh(self.fc1(batch["x"])))
        if self.returns_loss:
            return torch.mean(torch.square(out - batch["y"]))
        return out


def _jax_mse(out, batch):
    return jnp.mean(jnp.square(out - batch["y"]))


def _torch_mse(out, batch):
    return torch.mean(torch.square(out - batch["y"]))


def _batches(seed, n=3):
    rng = np.random.default_rng(seed)
    return [{"x": rng.standard_normal((4, D_IN)).astype(np.float32),
             "y": rng.standard_normal((4, D_OUT)).astype(np.float32)}
            for _ in range(n)]


def _twins(returns_loss: bool, seed: int = 0):
    """The flax model, its initial params and the torch twin carrying the
    same weights (``nn.Linear`` keeps [out, in], flax ``Dense`` [in, out])."""
    fm = FlaxMLP(returns_loss)
    params = fm.init(jax.random.PRNGKey(seed), _batches(seed, 1)[0])
    tm = TorchMLP(returns_loss)
    with torch.no_grad():
        for name, layer in (("Dense_0", tm.fc1), ("Dense_1", tm.fc2)):
            p = params["params"][name]
            layer.weight.copy_(torch.from_numpy(np.array(p["kernel"]).T))
            layer.bias.copy_(torch.from_numpy(np.array(p["bias"])))
    return fm, params, tm


@pytest.mark.parametrize("returns_loss", [False, True],
                         ids=["loss_fn", "module_loss"])
def test_from_module_trains_as_from_flax(returns_loss):
    fm, params, tm = _twins(returns_loss)
    jmodel = from_flax(fm, loss_fn=None if returns_loss else _jax_mse)
    tmodel = from_module(tm, loss_fn=None if returns_loss else _torch_mse)
    assert isinstance(tmodel, FromModule)
    jeng, *_ = deepspeed_tpu.initialize(
        model=jmodel, params=params, config=CFG,
        topology=Topology.build_virtual({"data": 1}))
    teng, *_ = deepspeed_tpu_torch.initialize(model=tmodel, config=CFG,
                                              device="cpu")
    assert set(teng.params) == {"fc1.weight", "fc1.bias", "fc2.weight",
                                "fc2.bias"}
    for batch in _batches(1):
        j = jeng.train_batch({k: jnp.asarray(v) for k, v in batch.items()})
        t = teng.train_batch({k: torch.from_numpy(v)
                              for k, v in batch.items()})
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(t[key]), float(np.asarray(
                j[key])), rtol=1e-5)
    assert teng.global_steps == 3
    jp = jax.tree_util.tree_map(np.asarray, jeng.params)["params"]
    for name, prefix in (("Dense_0", "fc1"), ("Dense_1", "fc2")):
        np.testing.assert_allclose(teng.params[f"{prefix}.weight"].numpy(),
                                   jp[name]["kernel"].T, atol=2e-5)
        np.testing.assert_allclose(teng.params[f"{prefix}.bias"].numpy(),
                                   jp[name]["bias"], atol=2e-5)


def test_loss_reads_the_given_params_not_the_modules():
    """``loss(batch, params=...)`` runs the module on the mapping it is
    given (``torch.func.functional_call``) and leaves its own weights."""
    _, _, tm = _twins(False)
    model = from_module(tm, _torch_mse)
    batch = {k: torch.from_numpy(v) for k, v in _batches(2, 1)[0].items()}
    own = {n: p.detach().clone() for n, p in model.named_parameters()}
    zeroed = {n: torch.zeros_like(p) for n, p in own.items()}
    with torch.no_grad():
        assert float(model.loss(batch, params=zeroed)) == pytest.approx(
            float(torch.mean(torch.square(batch["y"]))), rel=1e-6)
        assert float(model.loss(batch)) == float(model.loss(batch,
                                                            params=own))
    for n, p in model.named_parameters():
        assert torch.equal(p, own[n])


def test_forward_arguments_pass_through():
    class Scaled(nn.Module):
        def __init__(self):
            super().__init__()
            self.w = nn.Parameter(torch.ones(3))

        def forward(self, batch, factor, *, shift=0.0):
            return (self.w * batch["x"] * factor + shift).sum()

    model = from_module(Scaled(), args=(2.0,), kwargs={"shift": 1.0})
    batch = {"x": torch.arange(3.0)}
    with torch.no_grad():
        assert float(model.loss(batch)) == 9.0
        assert float(model.loss(batch,
                                params={"w": 2 * torch.ones(3)})) == 15.0
