"""``models/api.py`` ``from_module`` on the card (the ``gpu`` marker; skips
without a CUDA device). The file imports no JAX and no flax: the chip
machine runs it. The CPU parity against the JAX package's ``from_flax``
is ``tests/test_torch_api.py``."""

import numpy as np
import pytest
import torch
from torch import nn

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.api import from_module

CFG = {"train_batch_size": 4, "optimizer": {"type": "adamw",
                                            "params": {"lr": 1e-2}}}


class MLP(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(8, 16)
        self.fc2 = nn.Linear(16, 4)

    def forward(self, batch):
        return self.fc2(torch.tanh(self.fc1(batch["x"])))


def _mse(out, batch):
    return torch.mean(torch.square(out - batch["y"]))


def _train(dev: str) -> list:
    """3 AdamW steps on one seeded batch through ``initialize``."""
    torch.manual_seed(0)
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=from_module(MLP().to(dev), _mse), config=CFG, device=dev)
    rng = np.random.default_rng(1)
    batch = {"x": torch.from_numpy(rng.standard_normal((4, 8))
                                   .astype(np.float32)).to(dev),
             "y": torch.from_numpy(rng.standard_normal((4, 4))
                                   .astype(np.float32)).to(dev)}
    return [float(eng.train_batch(batch)["loss"]) for _ in range(3)]


def test_from_module_trains_on_the_cpu():
    losses = _train("cpu")
    assert losses[2] < losses[1] < losses[0]


@pytest.mark.gpu
def test_cuda_from_module_trains_as_on_the_cpu():
    """The same module and batch on the card: the loss falls and matches
    the CPU run in fp32 within 1e-5 (TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card, cpu = _train("cuda"), _train("cpu")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert card[-1] < card[0]
    np.testing.assert_allclose(card, cpu, rtol=1e-5)
