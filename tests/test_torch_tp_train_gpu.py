"""Tensor-parallel training on the card (the ``gpu`` marker; skips
without a CUDA device): two gloo rank processes share the card
(``tests/torch_ranks.py`` ``tp_card_job``) and train a 2-layer Llama at
TP 2 through ``initialize``, against the one-device engine in the test's
process. The file imports no JAX: the chip machine runs it. The CPU
case runs the same job on the host; the parity against the JAX package
is ``tests/test_torch_tp_train.py``."""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch

from torch_ranks import (card_config, card_model, card_tokens,
                         start_ranks)


def _tp1(device: str) -> list:
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=card_model().to(device), config=card_config(1, False),
        device=device)
    ids = torch.from_numpy(card_tokens()).to(device)
    return [{k: float(v) for k, v in eng.train_batch(
        {"input_ids": ids}).items()} for _ in range(3)]


def _tp2(device: str, bf16: bool) -> list:
    return start_ranks(2, "tp_card_job", device, bf16,
                       timeout=300).results()


def _assert_close(got: list, ref: list) -> None:
    for g, r in zip(got, ref):
        assert g["skipped"] == r["skipped"] == 0
        np.testing.assert_allclose(g["loss"], r["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["grad_norm"], r["grad_norm"],
                                   rtol=1e-4)


def test_tp2_trains_as_tp1_on_the_cpu():
    got = _tp2("cpu", False)
    assert got[0]["steps"] == got[1]["steps"]
    _assert_close(got[0]["steps"], _tp1("cpu"))
    assert got[0]["steps"][2]["loss"] < got[0]["steps"][0]["loss"]


@pytest.mark.gpu
def test_cuda_tp2_trains_as_tp1_and_on_the_hopper_flash_kernels():
    """fp32 (TF32 off): TP 2 on the card within 1e-5 (loss) / 1e-4 (grad
    norm) of TP 1 on the card. bf16: every flash forward (2 a layer a
    micro-batch with the remat replay), dq and dk/dv launch of the 3
    steps on the Hopper kernels, at hq 2, hkv 1 of d 64 a rank."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref = _tp1("cuda")
        fp32 = _tp2("cuda", False)
        bf16 = _tp2("cuda", True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    _assert_close(fp32[0]["steps"], ref)
    want = [(3 * 2 * 2 * 2,) * 2, (3 * 2 * 2,) * 2, (3 * 2 * 2,) * 2]
    for rank in bf16:
        assert rank["launches"] == want
        assert rank["steps"][2]["loss"] < rank["steps"][0]["loss"]
