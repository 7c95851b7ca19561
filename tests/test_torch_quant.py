"""Blockwise quantization of the PyTorch port against the JAX package.

The port's quantizer (what its wrappers run on CPU tensors) is held to
``deepspeed_tpu.ops.quantizer`` (its jnp path on the CPU) and to the Pallas
kernels ``quantize_blockwise_pallas`` / ``dequantize_blockwise_pallas`` in
interpret mode: quantized bytes and scales bitwise equal, symmetric and
asymmetric, int8 and int4, fp32 and bf16 inputs, blocks 128 and 256. Inputs
are made with numpy from a seed. The CUDA kernels run only on a GPU: the
``gpu`` tests hold them bitwise to the plain versions there and skip here.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops import quantizer as jq
from deepspeed_tpu.ops.pallas.quant import (dequantize_blockwise_pallas,
                                            quantize_blockwise_pallas)
from deepspeed_tpu_torch.ops import quant
from deepspeed_tpu_torch.ops import quantizer as tq

DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _x(seed, shape=(64, 256), zero_block=True):
    """Seeded normal values with a spread of magnitudes, one all-zero
    block (scale 0 -> 1) and exact .5 quotients to exercise rounding."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x *= rng.uniform(0.01, 10.0, (shape[0],) + (1,) * (len(shape) - 1)) \
        .astype(np.float32)
    if zero_block:
        x[0] = 0.0
    return x


def _pair(x, dtype):
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor)
                      and a.dtype == torch.bfloat16 else a)


@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("symmetric", [True, False])
def test_quantize_dequantize_match_jax(symmetric, bits, dtype, block):
    xt, xj = _pair(_x(bits + block), dtype)
    q, s, z = tq.quantize_blockwise(xt, bits=bits, block=block,
                                    symmetric=symmetric)
    jqv, js, jz = jq.quantize_blockwise(xj, bits=bits, block=block,
                                        symmetric=symmetric)
    assert q.dtype == (torch.int8 if symmetric else torch.uint8)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert (z is None) == (jz is None)
    if z is not None:
        np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    tdt, jdt = DTYPES[dtype]
    got = tq.dequantize_blockwise(q, s, z, block=block, dtype=tdt)
    ref = jq.dequantize_blockwise(jqv, js, jz, block=block, dtype=jdt)
    assert got.dtype == tdt and got.shape == xt.shape
    if symmetric:       # one fp32 product, then the cast: bitwise
        np.testing.assert_array_equal(_np(got), np.asarray(ref, np.float32))
    else:               # XLA may contract q * s + z into one FMA
        np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32),
                                   rtol=1e-6, atol=1e-6)
    if symmetric:       # and the Pallas kernels themselves, interpreted
        _check_pallas(xt, xj, q, s, got, bits, block, jdt)


def _check_pallas(xt, xj, q, s, got, bits, block, jdt):
    """The Pallas kernels in interpret mode. XLA compiles the kernel body
    and rewrites its division by the constant qmax as a multiply by the
    fp32 reciprocal, so its scales are absmax * fp32(1 / qmax): equal to
    the port's absmax / qmax or one ulp off. Given its scales, its bytes
    are the port's arithmetic (an IEEE x / scale, round half to even)."""
    qmax = 2.0 ** (bits - 1) - 1
    pq, ps, _ = quantize_blockwise_pallas(xj, bits=bits, block=block,
                                          interpret=True)
    pq, ps = np.array(pq), np.array(ps)
    blocks = xt.reshape(-1, block).float()
    amax = blocks.abs().amax(dim=1)
    recip = amax * torch.tensor(1.0 / qmax, dtype=torch.float32)
    recip = torch.where(recip == 0, torch.ones_like(recip), recip)
    np.testing.assert_array_equal(ps, recip.numpy())
    ulps = (torch.from_numpy(ps).view(torch.int32)
            - s.view(torch.int32)).abs()
    assert int(ulps.max()) <= 1
    from_ps = torch.clamp(torch.round(
        blocks / torch.from_numpy(ps)[:, None]), -qmax - 1, qmax)
    np.testing.assert_array_equal(pq.reshape(-1, block),
                                  from_ps.to(torch.int8).numpy())
    same = (ulps == 0).numpy()
    np.testing.assert_array_equal(pq.reshape(-1, block)[same],
                                  q.reshape(-1, block).numpy()[same])
    # dequantize is one fp32 product and the cast: bitwise
    pd = dequantize_blockwise_pallas(jnp.asarray(q.numpy()),
                                     jnp.asarray(s.numpy()), block=block,
                                     dtype=jdt, interpret=True)
    np.testing.assert_array_equal(_np(got), np.asarray(pd, np.float32))


@pytest.mark.parametrize("block", [128, 256])
def test_offset_int4_packing_matches_the_v1_engine_layout(block):
    """pack=True writes the JAX v1 engine's int4 weight bytes
    (inference/engine.py ``_quantize_tree``), and packed dequantize
    reads them back as its ``_dequant_tree`` does."""
    xt, xj = _pair(_x(3), "bf16")
    q, s = quant.quantize_blockwise(xt, bits=4, block=block, pack=True)
    jqv, js, _ = jq.quantize_blockwise(xj, bits=4, block=block)
    q4 = (jqv + 8).astype(jnp.uint8).reshape(-1, 2)
    jpacked = (q4[:, 0] | (q4[:, 1] << 4)).astype(jnp.uint8)
    assert q.dtype == torch.uint8 and q.shape == (xt.numel() // 2,)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jpacked))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    lo = (jpacked & 0xF).astype(jnp.int8) - 8
    hi = (jpacked >> 4).astype(jnp.int8) - 8
    junp = jnp.stack([lo, hi], axis=-1).reshape(-1)
    ref = jq.dequantize_blockwise(junp, js, block=block, dtype=jnp.bfloat16)
    got = quant.dequantize_blockwise(q, s, block=block, dtype=torch.bfloat16,
                                     packed=True)
    np.testing.assert_array_equal(_np(got), np.asarray(ref, np.float32))
    np.testing.assert_array_equal(
        quant.unpack_int4_offset(q).numpy(), np.asarray(junp))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_kv_matches_jax(bits):
    x = _x(11, (5, 3, 64), zero_block=False)
    x[1, 2] = 0.0                          # one all-zero head-vector
    pt, st = tq.quantize_kv(torch.from_numpy(x), bits)
    pj, sj = jq.quantize_kv(jnp.asarray(x), bits)
    assert pt.dtype == (torch.int8 if bits == 8 else torch.uint8)
    assert pt.shape == ((5, 3, 64) if bits == 8 else (5, 3, 32))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    dt = tq.dequantize_kv(pt, st, bits)
    dj = jq.dequantize_kv(pj, sj, bits)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    # the stated bound: each element within scale / 2 of the input
    assert bool(((dt - torch.from_numpy(x)).abs()
                 <= st[..., None] / 2 + 1e-6).all())
    if bits == 4:
        np.testing.assert_array_equal(tq.unpack_kv_int4(pt).numpy(),
                                      np.asarray(jq.unpack_kv_int4(pj)))


def test_int4_wire_packing_matches_jax():
    q = np.random.default_rng(2).integers(-8, 8, (6, 10)).astype(np.int8)
    pt = tq.pack_int4(torch.from_numpy(q))
    pj = jq.pack_int4(jnp.asarray(q))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(tq.unpack_int4(pt).numpy(), q.reshape(-1))
    np.testing.assert_array_equal(tq.unpack_int4(pt).numpy(),
                                  np.asarray(jq.unpack_int4(pj)))
    with pytest.raises(ValueError, match="even"):
        tq.pack_int4(torch.zeros(7, dtype=torch.int8))


def test_the_three_int4_layouts_differ():
    """pack_int4 (two's complement), quantize_kv (two's complement, per
    head-vector) and the v1 engine's offset binary give other bytes for
    the same nibbles: each is kept where the JAX package uses it."""
    vals = torch.tensor([-7, 7, -1, 0], dtype=torch.int8)
    assert tq.pack_int4(vals).tolist() == [0x79, 0x0F]
    assert quant.pack_int4_offset(vals).tolist() == [0xF1, 0x87]
    kv, scale = tq.quantize_kv(torch.tensor([[-7.0, 7.0, -1.0, 0.0]]), 4)
    assert kv.tolist() == [[0x79, 0x0F]] and scale.tolist() == [1.0]


@pytest.mark.parametrize("symmetric", [True, False])
def test_fake_quantize_forward_and_straight_through_gradient(symmetric):
    x = _x(21, (8, 256))
    w = np.random.default_rng(22).standard_normal((8, 256)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tq.fake_quantize(xt, bits=8, block=256, symmetric=symmetric)
    (out * torch.from_numpy(w)).sum().backward()
    ref, grad = jax.value_and_grad(
        lambda a: jnp.sum(jq.fake_quantize(a, bits=8, block=256,
                                           symmetric=symmetric) * w))(
        jnp.asarray(x))
    jout = jq.fake_quantize(jnp.asarray(x), bits=8, block=256,
                            symmetric=symmetric)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(xt.grad.numpy(), w)
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(grad))


@pytest.mark.parametrize("numel,bits,block", [(1024, 8, 256), (1023, 4, 256),
                                              (7, 4, 4), (4096, 4, 128)])
def test_quantized_nbytes_matches_jax(numel, bits, block):
    assert tq.quantized_nbytes(numel, bits, block) == \
        jq.quantized_nbytes(numel, bits, block)


def test_cpu_wrappers_run_the_plain_versions_without_counting():
    xt = torch.from_numpy(_x(30)).to(torch.bfloat16)
    before = (quant.quantize_blockwise.launches,
              quant.dequantize_blockwise.launches)
    q, s = quant.quantize_blockwise(xt, bits=8, block=256)
    rq, rs = quant.quantize_blockwise_reference(xt, bits=8, block=256)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    out = quant.dequantize_blockwise(q, s, block=256, dtype=torch.bfloat16)
    assert torch.equal(out, quant.dequantize_blockwise_reference(
        q, s, block=256, dtype=torch.bfloat16))
    assert (quant.quantize_blockwise.launches,
            quant.dequantize_blockwise.launches) == before


@pytest.mark.parametrize("call,exc", [
    (lambda: quant.quantize_blockwise(torch.zeros(300), block=256),
     ValueError),
    (lambda: quant.quantize_blockwise(torch.zeros(256), bits=3), ValueError),
    (lambda: quant.quantize_blockwise(torch.zeros(256), bits=8, pack=True),
     ValueError),
    (lambda: quant.quantize_blockwise(torch.zeros(256, device="meta")),
     ValueError),
    (lambda: quant.dequantize_blockwise(
        torch.zeros(256, dtype=torch.int8, device="meta"),
        torch.ones(1, device="meta")), ValueError),
])
def test_wrappers_reject_bad_inputs(call, exc):
    with pytest.raises(exc):
        call()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("bits,block,pack", [(8, 256, False), (8, 128, False),
                                             (4, 128, False), (4, 256, True)])
def test_cuda_kernels_bitwise_equal_to_plain_versions(dtype, bits, block,
                                                      pack):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    x = torch.from_numpy(_x(40, (37, 512))).to(dtype).cuda()  # 37 rows of 512
    before = quant.quantize_blockwise.launches
    q, s = quant.quantize_blockwise(x, bits=bits, block=block, pack=pack)
    out = quant.dequantize_blockwise(q, s, block=block, dtype=dtype,
                                     packed=pack)
    torch.cuda.synchronize()
    assert quant.quantize_blockwise.launches == before + 1
    rq, rs = quant.quantize_blockwise_reference(x, bits, block, pack)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    ref = quant.dequantize_blockwise_reference(rq, rs, block, dtype, pack)
    assert torch.equal(out, ref)
