"""Flash attention of the PyTorch port against the JAX package.

The port's plain versions (what the wrappers run on CPU tensors) are held
against the JAX Pallas kernels in interpret mode, fp32, 1e-5 abs + rel, on
inputs made with numpy from a seed: the forward's (out, lse) against
``_flash_forward``, the backward's (dq, dk, dv) against ``_flash_backward``
on the same (out, lse), and ``flash_attention_op``'s gradients against
``jax.grad`` of the JAX ``flash_attention`` ``custom_vjp``. The cases cover
causal and non-causal, GQA/MQA, sq < skv, sq > skv (rows that see no key:
0 and LSE 1e30), a window band, a scale override and multi-tile grids.
``dot_product_attention`` is held to its JAX twin with masks, bias and
scale. ``flash_wgmma_path`` and ``flash_forward_wgmma_path`` (which
backward and forward the Hopper TMA + wgmma kernels take) are checked on
the CPU. The CUDA kernels run only on a GPU: the ``gpu`` tests hold them
against the plain versions there and skip here; the Hopper kernels'
cases also check their launch counts and that two runs give equal bits.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops.attention import (
    dot_product_attention as jax_dot_product_attention)
from deepspeed_tpu.ops.pallas.flash_attention import (
    _flash_backward as jax_flash_backward,
    _flash_forward as jax_flash_forward,
    flash_attention as jax_flash_attention)
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops.attention import (dot_product_attention,
                                               flash_attention)

TOL = dict(rtol=1e-5, atol=1e-5)

CASES = {
    # name: (b, sq, skv, hq, hkv, d, causal, window, scale, block)
    "causal-gqa": (2, 16, 16, 4, 2, 64, True, 0, None, 8),
    "non-causal-mqa": (1, 16, 16, 4, 1, 64, False, 0, None, 8),
    "sq-lt-skv": (1, 8, 24, 4, 2, 64, True, 0, None, 8),
    "sq-gt-skv-masked-rows": (1, 24, 8, 2, 1, 64, True, 0, None, 8),
    "window": (1, 32, 32, 4, 2, 64, True, 5, None, 8),
    "window-sq-lt-skv": (1, 16, 32, 2, 2, 64, True, 12, None, 8),
    "scale-d128": (1, 16, 16, 2, 2, 128, True, 0, 0.3, 16),
    # head_dim 128, the Hopper backward's second width: GQA group 4 at a
    # length that is no multiple of the CUDA kernels' 64-row tiles, sq >
    # skv under MQA, and a window
    "d128-gqa-ragged": (1, 40, 40, 8, 2, 128, True, 0, None, 8),
    "d128-sq-gt-skv": (1, 24, 16, 4, 1, 128, True, 0, None, 8),
    "d128-window": (1, 32, 32, 4, 2, 128, True, 6, None, 8),
}


def _qkv(seed, b, sq, skv, hq, hkv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    do = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    return q, k, v, do


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _scale(d, scale):
    return scale if scale is not None else 1.0 / np.sqrt(d)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_forward_matches_jax_kernel(name):
    b, sq, skv, hq, hkv, d, causal, window, scale, blk = CASES[name]
    q, k, v, _ = _qkv(1, b, sq, skv, hq, hkv, d)
    jout, jlse = jax_flash_forward(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), _scale(d, scale), causal,
                                   blk, blk, True, window)
    out, lse = fa.flash_attention_forward_reference(
        *_t(q, k, v), causal=causal, scale=scale, window=window)
    assert out.shape == (b, sq, hq, d) and lse.shape == (b, hq, sq)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)
    if name == "sq-gt-skv-masked-rows":
        # rows 0..15 sit at positions < 0: they see no key
        assert torch.all(out[:, :sq - skv] == 0)
        assert torch.all(lse[:, :, :sq - skv] == 1e30)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_jax_kernels(name):
    b, sq, skv, hq, hkv, d, causal, window, scale, blk = CASES[name]
    q, k, v, do = _qkv(2, b, sq, skv, hq, hkv, d)
    sc = _scale(d, scale)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    jout, jlse = jax_flash_forward(jq, jk, jv, sc, causal, blk, blk, True,
                                   window)
    jdq, jdk, jdv = jax_flash_backward(jq, jk, jv, jout, jlse, jdo, sc,
                                       causal, blk, blk, True, window)
    dq, dk, dv = fa.flash_attention_backward_reference(
        *_t(q, k, v, jout, jlse, do), causal=causal, scale=scale,
        window=window)
    for got, ref, what in ((dq, jdq, "dq"), (dk, jdk, "dk"), (dv, jdv, "dv")):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL,
                                   err_msg=what)


@pytest.mark.parametrize("name", sorted(CASES))
def test_autograd_function_matches_jax_grad(name):
    b, sq, skv, hq, hkv, d, causal, window, scale, blk = CASES[name]
    q, k, v, do = _qkv(3, b, sq, skv, hq, hkv, d)
    jout, vjp = jax.vjp(
        lambda q, k, v: jax_flash_attention(q, k, v, causal, scale, blk, blk,
                                            True, window),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (t.requires_grad_(True) for t in _t(q, k, v))
    before = (fa.flash_forward.launches, fa.flash_backward_dq.launches,
              fa.flash_backward_dkv.launches)
    out = flash_attention(tq, tk, tv, causal=causal, scale=scale,
                          window=window)
    (out * torch.from_numpy(do)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    for got, ref, what in zip((tq.grad, tk.grad, tv.grad), jgrads, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL,
                                   err_msg=f"d{what}")
    # the plain path on CPU tensors launches no kernel
    assert before == (fa.flash_forward.launches,
                      fa.flash_backward_dq.launches,
                      fa.flash_backward_dkv.launches)


@pytest.mark.parametrize("kind", ["causal", "window", "mask", "bias-scale",
                                  "sq-lt-skv"])
def test_dot_product_attention_matches_jax(kind):
    rng = np.random.default_rng(4)
    sq, skv = (5, 9) if kind == "sq-lt-skv" else (9, 9)
    q, k, v, _ = _qkv(5, 2, sq, skv, 4, 2, 16)
    kw = {"causal": kind != "mask"}
    tkw = dict(kw)
    if kind == "window":
        kw["window"] = tkw["window"] = 3
    if kind == "mask":
        m = rng.random((2, 1, sq, skv)) > 0.3
        m[..., 0] = True
        kw["mask"], tkw["mask"] = jnp.asarray(m), torch.from_numpy(m)
    if kind == "bias-scale":
        bias = rng.standard_normal((1, 4, sq, skv)).astype(np.float32)
        kw["bias"], tkw["bias"] = jnp.asarray(bias), torch.from_numpy(bias)
        kw["scale"] = tkw["scale"] = 0.7
    ref = jax_dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), **kw)
    got = dot_product_attention(*_t(q, k, v), **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_flash_dispatcher_matches_dot_product_attention_in_bf16():
    q, k, v, _ = _qkv(6, 1, 12, 12, 4, 2, 64)
    tq, tk, tv = (t.to(torch.bfloat16) for t in _t(q, k, v))
    got = flash_attention(tq, tk, tv, causal=True)
    ref = dot_product_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("mutate,exc,match", [
    (lambda a: {**a, "k": a["k"][..., :32], "v": a["v"][..., :32]},
     ValueError, "must be"),
    (lambda a: {**a, "q": a["q"][:, :, :3]}, ValueError, "multiple"),
    (lambda a: {**a, "k": a["k"].double()}, TypeError, "share"),
    (lambda a: {**a, "window": 4, "causal": False}, ValueError, "causal"),
    (lambda a: {**a, "q": a["q"][:, :0]}, ValueError, "empty"),
])
def test_wrapper_raises_on_what_the_kernels_do_not_take(mutate, exc, match):
    q, k, v, _ = _qkv(7, 1, 8, 8, 4, 2, 64)
    a = mutate(dict(zip("qkv", _t(q, k, v)), causal=True, window=0))
    with pytest.raises(exc, match=match):
        fa.flash_forward(a["q"], a["k"], a["v"], causal=a["causal"],
                         window=a["window"])


def test_wrapper_raises_on_a_device_it_has_no_kernel_for():
    meta = [torch.empty((1, 8, h, 64), device="meta") for h in (4, 2, 2)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_forward(*meta)


WGMMA_PATH_CASES = {
    # name: (dtype, d, hq, hkv, address offset in bytes) -> Hopper kernels?
    "1b-bf16": ((torch.bfloat16, 64, 32, 4, 0), True),
    "fp16-mha": ((torch.float16, 64, 8, 8, 0), True),
    "mqa-bf16": ((torch.bfloat16, 64, 8, 1, 0), True),
    "fp32": ((torch.float32, 64, 32, 4, 0), False),
    "d128": ((torch.bfloat16, 128, 16, 4, 0), True),
    "d128-fp16-mha": ((torch.float16, 128, 32, 32, 0), True),
    "d128-fp32": ((torch.float32, 128, 32, 32, 0), False),
    "d128-unaligned": ((torch.bfloat16, 128, 32, 32, 8), False),
    "d256": ((torch.float16, 256, 8, 2, 0), False),
    "unaligned": ((torch.bfloat16, 64, 32, 4, 8), False),
    "heads-not-grouped": ((torch.bfloat16, 64, 6, 4, 0), False),
}


@pytest.mark.parametrize("name", sorted(WGMMA_PATH_CASES))
def test_flash_wgmma_path_predicate(name):
    (dtype, d, hq, hkv, off), want = WGMMA_PATH_CASES[name]
    addrs = (4096, 8192 + off, 12288, 16384)
    assert fa.flash_wgmma_path(dtype, d, hq, hkv, addrs) is want


FWD_PATH_CASES = {
    # name: (dtype, d, hq, hkv, address offset, scale) -> Hopper forward?
    "1b-bf16": ((torch.bfloat16, 64, 32, 4, 0, 0.125), True),
    "7b-fp16-d128": ((torch.float16, 128, 32, 32, 0, 0.088), True),
    "fp32": ((torch.float32, 64, 32, 4, 0, 0.125), False),
    "d256": ((torch.bfloat16, 256, 8, 2, 0, 0.0625), False),
    "unaligned": ((torch.bfloat16, 128, 8, 2, 8, 0.088), False),
    "negative-scale": ((torch.bfloat16, 64, 8, 2, 0, -0.125), False),
}


@pytest.mark.parametrize("name", sorted(FWD_PATH_CASES))
def test_flash_forward_wgmma_path_predicate(name):
    (dtype, d, hq, hkv, off, scale), want = FWD_PATH_CASES[name]
    addrs = (4096, 8192 + off, 12288)
    assert fa.flash_forward_wgmma_path(dtype, d, hq, hkv, addrs,
                                       scale) is want


def test_cpu_wrappers_leave_the_hopper_counts():
    q, k, v, do = _t(*_qkv(8, 1, 8, 8, 4, 2, 64))
    q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
    def counts():
        return (fa.flash_forward.launches, fa.flash_forward.wgmma_launches,
                fa.flash_backward_dq.launches,
                fa.flash_backward_dq.wgmma_launches,
                fa.flash_backward_dkv.launches,
                fa.flash_backward_dkv.wgmma_launches)
    before = counts()
    out, lse = fa.flash_forward(q, k, v)
    fa.flash_backward(q, k, v, out, lse, do)
    assert before == counts()


def _cuda_case(seed, b, sq, skv, hq, hkv, d, dtype):
    gen = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=gen).to(dtype).cuda()  # noqa: E731
    return (mk(b, sq, hq, d), mk(b, skv, hkv, d), mk(b, skv, hkv, d),
            mk(b, sq, hq, d))


GPU_CASES = [
    # b, sq, skv, hq, hkv, d, causal, window, dtype: fp32 and d 256 take
    # the scalar kernels, bf16/fp16 at d 64/128 the tensor-core ones
    (2, 200, 200, 8, 2, 64, True, 0, torch.float32),
    (1, 130, 70, 4, 4, 128, True, 0, torch.float32),
    (1, 70, 130, 4, 1, 256, True, 0, torch.float32),
    (1, 100, 100, 4, 2, 64, False, 0, torch.float32),
    (1, 300, 300, 8, 2, 64, True, 37, torch.bfloat16),
    (1, 130, 70, 4, 2, 64, True, 0, torch.bfloat16),
    (1, 70, 130, 4, 4, 128, True, 0, torch.float16),
    (1, 100, 100, 4, 2, 128, False, 0, torch.bfloat16),
    (1, 90, 90, 4, 2, 256, True, 0, torch.bfloat16),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_CASES)
def test_cuda_kernels_match_plain_versions(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b, sq, skv, hq, hkv, d, causal, window, dtype = case
    q, k, v, do = _cuda_case(0, b, sq, skv, hq, hkv, d, dtype)
    kw = dict(causal=causal, window=window)
    out, lse = fa.flash_forward(q, k, v, **kw)
    dq, dk, dv = fa.flash_backward(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    rout, rlse = fa.flash_attention_forward_reference(q, k, v, **kw)
    rdq, rdk, rdv = fa.flash_attention_backward_reference(q, k, v, rout, rlse,
                                                          do, **kw)
    a, r = (2e-5, 0.0) if dtype == torch.float32 else (4e-3, 1e-2)
    for got, ref, what in ((out, rout, "out"), (lse, rlse, "lse")):
        err = (got.float() - ref.float()).abs()
        assert bool((err <= a + r * ref.float().abs()).all()), (what, err.max())
    for got, ref, what in ((dq, rdq, "dq"), (dk, rdk, "dk"), (dv, rdv, "dv")):
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        bound = 1e-4 * (1 + scale) if dtype == torch.float32 else 2e-2 * scale
        assert err <= bound, (what, err, scale)
    dk2, dv2 = fa.flash_backward_dkv(q, k, v, do, lse, fa._delta(out, do), **kw)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


HOPPER_CASES = [
    # b, sq, skv, hq, hkv, d, causal, window, dtype at d 64 and 128: GQA
    # groups 1, 2, 4 and 8, sq < skv and sq > skv, ragged lengths (TMA
    # zero-fills the tail of the last tile), windows, non-causal, bf16 and
    # fp16; at d 128 also Llama-2-7B's heads at 2048 (ZeRO-3 training)
    (1, 256, 256, 4, 4, 64, True, 0, torch.bfloat16),
    (2, 300, 300, 8, 4, 64, True, 0, torch.float16),
    (1, 1000, 1000, 16, 2, 64, True, 0, torch.bfloat16),
    (1, 333, 517, 8, 2, 64, True, 0, torch.float16),
    (1, 517, 333, 8, 2, 64, True, 0, torch.bfloat16),
    (1, 600, 600, 8, 2, 64, True, 100, torch.bfloat16),
    (1, 333, 517, 8, 2, 64, True, 100, torch.float16),
    (1, 200, 330, 4, 1, 64, False, 0, torch.bfloat16),
    (1, 256, 256, 4, 4, 128, True, 0, torch.bfloat16),
    (2, 300, 300, 8, 2, 128, True, 0, torch.float16),
    (1, 1000, 1000, 16, 2, 128, True, 0, torch.bfloat16),
    (1, 333, 517, 8, 2, 128, True, 0, torch.float16),
    (1, 517, 333, 8, 2, 128, True, 0, torch.bfloat16),
    (1, 600, 600, 8, 2, 128, True, 100, torch.bfloat16),
    (1, 333, 517, 8, 1, 128, True, 100, torch.float16),
    (1, 200, 330, 4, 1, 128, False, 0, torch.bfloat16),
    (1, 300, 300, 8, 8, 128, False, 0, torch.float16),
    (1, 2048, 2048, 32, 32, 128, True, 0, torch.bfloat16),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", HOPPER_CASES)
def test_cuda_hopper_backward_matches_plain_and_repeats(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    b, sq, skv, hq, hkv, d, causal, window, dtype = case
    q, k, v, do = _cuda_case(1, b, sq, skv, hq, hkv, d, dtype)
    assert fa.flash_wgmma_path(dtype, d, hq, hkv,
                               tuple(t.data_ptr() for t in (q, k, v, do)))
    kw = dict(causal=causal, window=window)
    out, lse = fa.flash_attention_forward_reference(q, k, v, **kw)
    delta = fa._delta(out, do)
    dq_w = fa.flash_backward_dq.wgmma_launches
    dkv_w = fa.flash_backward_dkv.wgmma_launches
    dq = fa.flash_backward_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_backward_dkv(q, k, v, do, lse, delta, **kw)
    dq2 = fa.flash_backward_dq(q, k, v, do, lse, delta, **kw)
    dk2, dv2 = fa.flash_backward_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert fa.flash_backward_dq.wgmma_launches == dq_w + 2
    assert fa.flash_backward_dkv.wgmma_launches == dkv_w + 2
    rdq, rdk, rdv = fa._backward_from_delta(q, k, v, lse, delta, do, causal,
                                            None, window)
    for got, ref, what in ((dq, rdq, "dq"), (dk, rdk, "dk"), (dv, rdv, "dv")):
        assert bool(torch.isfinite(got).all()), what
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        assert err <= 2e-2 * scale, (what, err, scale)
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) \
        and torch.equal(dv, dv2)
    if sq > skv:    # rows before the first key see nothing: dq 0
        assert bool((dq[:, :sq - skv] == 0).all())


FWD_CASES = [
    # b, sq, skv, hq, hkv, d, causal, window, dtype: the training shape
    # (Llama("1b"), micro-batch 4) in bf16 and fp16, non-causal, sq < skv
    # and sq > skv, ragged lengths, windows, GQA groups 1, 2, 4 and 8, d 128
    (4, 2048, 2048, 32, 4, 64, True, 0, torch.bfloat16),
    (4, 2048, 2048, 32, 4, 64, True, 0, torch.float16),
    (2, 300, 300, 8, 8, 64, False, 0, torch.bfloat16),
    (1, 333, 517, 8, 4, 64, True, 0, torch.float16),
    (1, 517, 333, 8, 2, 64, True, 0, torch.bfloat16),
    (1, 600, 600, 8, 1, 64, True, 100, torch.bfloat16),
    (1, 1000, 1000, 16, 2, 128, True, 0, torch.bfloat16),
    (1, 333, 517, 8, 2, 128, True, 77, torch.float16),
    (1, 200, 330, 4, 1, 128, False, 0, torch.bfloat16),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", FWD_CASES)
def test_cuda_hopper_forward_matches_plain_and_repeats(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    b, sq, skv, hq, hkv, d, causal, window, dtype = case
    q, k, v, _ = _cuda_case(2, b, sq, skv, hq, hkv, d, dtype)
    assert fa.flash_forward_wgmma_path(
        dtype, d, hq, hkv, tuple(t.data_ptr() for t in (q, k, v)),
        1.0 / np.sqrt(d))
    kw = dict(causal=causal, window=window)
    w = fa.flash_forward.wgmma_launches
    out, lse = fa.flash_forward(q, k, v, **kw)
    out2, lse2 = fa.flash_forward(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_forward.wgmma_launches == w + 2
    rout, rlse = fa.flash_attention_forward_reference(q, k, v, **kw)
    err = (out.float() - rout.float()).abs()
    assert bool((err <= 4e-3 + 1e-2 * rout.float().abs()).all()), err.max()
    err = (lse - rlse).abs()
    assert bool((err <= 1e-4 + 1e-5 * rlse.abs()).all()), err.max()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    if sq > skv:    # rows before the first key see nothing: 0 and 1e30
        assert bool((out[:, :sq - skv] == 0).all())
        assert bool((lse[:, :, :sq - skv] == 1e30).all())
