"""ZeRO stages 1-3 on the card (the ``gpu`` marker; skips without a CUDA
device): two gloo rank processes share the card (``tests/torch_ranks.py``
``zero_card_job``) and train a 2-layer Llama over ``{"data": 2}`` through
``initialize``, against the one-device engine in the test's process. The
file imports no JAX: the chip machine runs it. The CPU case runs the same
job on the host; the parity against the JAX package is
``tests/test_torch_zero.py``."""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch

from torch_ranks import card_config, card_model, card_tokens, start_ranks


def _one_device(device: str) -> list:
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=card_model().to(device), config=card_config(1, False),
        device=device)
    ids = torch.from_numpy(card_tokens()).to(device)
    return [{k: float(v) for k, v in eng.train_batch(
        {"input_ids": ids}).items()} for _ in range(3)]


def _ranks(device: str, runs) -> list:
    """Every rank's results of ``runs`` (``(stage, qgz)`` pairs)."""
    return start_ranks(2, "zero_card_job", device, list(runs),
                       timeout=300).results()


@pytest.fixture(scope="module")
def cpu_runs():
    got = _ranks("cpu", [(1, False), (2, False), (3, False)])
    return {stage: [r[i] for r in got] for i, stage in enumerate((1, 2, 3))}


def _assert_close(got: list, ref: list) -> None:
    for g, r in zip(got, ref):
        assert g["skipped"] == r["skipped"] == 0
        np.testing.assert_allclose(g["loss"], r["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["grad_norm"], r["grad_norm"],
                                   rtol=1e-4)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_zero_stage_trains_as_one_device_on_the_cpu(cpu_runs, stage):
    got = cpu_runs[stage]
    assert got[0]["steps"] == got[1]["steps"]
    _assert_close(got[0]["steps"], _one_device("cpu"))
    assert got[0]["steps"][2]["loss"] < got[0]["steps"][0]["loss"]


@pytest.mark.gpu
def test_cuda_zero_stages_train_as_one_device_on_the_hopper_kernels():
    """fp32 (TF32 off): stages 1, 2 and 3 on two ranks of the card within
    1e-5 (loss) / 1e-4 (grad norm) of the one-device engine on the card.
    bf16 at stage 2 with ``zero_quantized_gradients``: every flash
    forward (2 a layer a micro-batch with the remat replay), dq and dk/dv
    launch of the 3 steps on the Hopper kernels (hq 4, hkv 2 of d 64),
    and the gradients' quantize / dequantize kernels (``csrc/quant.cu``)
    launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref = _one_device("cuda")
        got = _ranks("cuda", [(1, False), (2, False), (3, False), (2, True)])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for i, stage in enumerate((1, 2, 3)):
        assert got[0][i]["steps"] == got[1][i]["steps"], stage
        _assert_close(got[0][i]["steps"], ref)
    want = [(3 * 2 * 2 * 2,) * 2, (3 * 2 * 2,) * 2, (3 * 2 * 2,) * 2]
    for rank in (r[3] for r in got):
        assert rank["launches"] == want
        assert all(n > 0 for n in rank["quant_launches"])
        assert rank["steps"][2]["loss"] < rank["steps"][0]["loss"]
