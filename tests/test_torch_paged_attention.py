"""Paged attention of the PyTorch port against the JAX package.

The port's plain ``paged_attention_reference`` (what the wrapper runs on CPU
tensors) is held against the JAX Pallas kernel in interpret mode and against
the JAX gather reference, fp32, 1e-5 abs/rel, on inputs made with numpy from
a seed, over fp pools and over int8 / int4 pools quantized by
``quantize_kv``. The CUDA kernel itself runs only on a GPU: the ``gpu`` test holds it
against the plain version there and skips here.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.ops.pallas.paged_attention import (
    paged_attention as jax_paged_attention,
    paged_attention_reference as jax_paged_reference)
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops import paged_attention as pa
from deepspeed_tpu_torch.ops.quantizer import quantize_kv

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, *, T=8, hq=4, hkv=4, hd=64, block=8, n_seqs=3,
            max_pages=6, live_pages=None, tail=False):
    """Per-sequence tables over distinct pages, each token on a random
    sequence at a random position below ``live_pages * block``. ``tail``
    keeps every position off a page end, so each last page has a masked
    ragged tail."""
    rng = np.random.default_rng(seed)
    n_pages = n_seqs * max_pages + 2
    live = live_pages or max_pages
    q = rng.standard_normal((T, hq, hd)).astype(np.float32)
    kp = rng.standard_normal((n_pages, hkv, block, hd)).astype(np.float32)
    vp = rng.standard_normal((n_pages, hkv, block, hd)).astype(np.float32)
    tables = rng.permutation(n_pages)[:n_seqs * max_pages] \
        .reshape(n_seqs, max_pages).astype(np.int32)
    slots = rng.integers(0, n_seqs, T).astype(np.int32)
    pos = rng.integers(0, live * block, T).astype(np.int32)
    if tail:
        pos = (pos // block) * block + rng.integers(0, block - 1, T)
        pos = pos.astype(np.int32)
    return q, kp, vp, tables, slots, pos


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


CASES = {
    # name: (input kwargs, per_token_tables, window)
    "per-token-tables": (dict(), True, 0),
    "seq-slots": (dict(), False, 0),
    "live-pages": (dict(max_pages=8, live_pages=3), False, 0),
    "window": (dict(), False, 5),
    "gqa": (dict(hq=8, hkv=2), False, 0),
    "gqa-window-live": (dict(hq=8, hkv=2, max_pages=8, live_pages=4), False, 11),
    "tail-mask": (dict(block=16, tail=True), False, 0),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_kernel_and_reference(name):
    kw, per_token, window = CASES[name]
    q, kp, vp, tables, slots, pos = _inputs(7, **kw)
    live = kw.get("live_pages")
    tok_tables = tables[slots]
    q_t, kp_t, vp_t, tab_t, slots_t, pos_t, tok_t = _torch(
        q, kp, vp, tables, slots, pos, tok_tables)

    if per_token:
        got = pa.paged_attention_reference(q_t, kp_t, vp_t, tok_t, pos_t,
                                           live_pages=live, window=window)
        jk = jax_paged_attention(jnp.asarray(q), jnp.asarray(kp),
                                 jnp.asarray(vp), jnp.asarray(tok_tables),
                                 jnp.asarray(pos), live_pages=live,
                                 window=window, interpret=True)
    else:
        got = pa.paged_attention_reference(q_t, kp_t, vp_t, tab_t, pos_t,
                                           seq_slots=slots_t, live_pages=live,
                                           window=window)
        jk = jax_paged_attention(jnp.asarray(q), jnp.asarray(kp),
                                 jnp.asarray(vp), jnp.asarray(tables),
                                 jnp.asarray(pos),
                                 seq_slots=jnp.asarray(slots),
                                 live_pages=live, window=window,
                                 interpret=True)
    jr = jax_paged_reference(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                             jnp.asarray(tok_tables), jnp.asarray(pos),
                             window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jr), **TOL)


def _quantized(kp, vp, bits):
    """(k payload, v payload, k scales, v scales) as torch tensors."""
    qk, sk = quantize_kv(torch.from_numpy(kp), bits)
    qv, sv = quantize_kv(torch.from_numpy(vp), bits)
    return qk, qv, sk, sv


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("name", ["per-token-tables", "seq-slots",
                                  "gqa-window-live", "tail-mask"])
def test_quantized_pools_match_jax_kernel_and_reference(name, bits):
    kw, per_token, window = CASES[name]
    q, kp, vp, tables, slots, pos = _inputs(17, **kw)
    live = kw.get("live_pages")
    tok_tables = tables[slots]
    qk, qv, sk, sv = _quantized(kp, vp, bits)
    q_t, tab_t, slots_t, pos_t, tok_t = _torch(q, tables, slots, pos,
                                               tok_tables)
    quant = dict(k_scale=sk, v_scale=sv, kv_bits=bits)
    jquant = dict(k_scale=jnp.asarray(sk.numpy()),
                  v_scale=jnp.asarray(sv.numpy()), kv_bits=bits)
    jk_pool, jv_pool = jnp.asarray(qk.numpy()), jnp.asarray(qv.numpy())
    if per_token:
        got = pa.paged_attention_reference(q_t, qk, qv, tok_t, pos_t,
                                           live_pages=live, window=window,
                                           **quant)
        jk = jax_paged_attention(jnp.asarray(q), jk_pool, jv_pool,
                                 jnp.asarray(tok_tables), jnp.asarray(pos),
                                 live_pages=live, window=window,
                                 interpret=True, **jquant)
    else:
        got = pa.paged_attention_reference(q_t, qk, qv, tab_t, pos_t,
                                           seq_slots=slots_t, live_pages=live,
                                           window=window, **quant)
        jk = jax_paged_attention(jnp.asarray(q), jk_pool, jv_pool,
                                 jnp.asarray(tables), jnp.asarray(pos),
                                 seq_slots=jnp.asarray(slots),
                                 live_pages=live, window=window,
                                 interpret=True, **jquant)
    jr = jax_paged_reference(jnp.asarray(q), jk_pool, jv_pool,
                             jnp.asarray(tok_tables), jnp.asarray(pos),
                             window=window, **jquant)
    np.testing.assert_allclose(got.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jr), **TOL)
    # the wrapper on CPU tensors is the plain version, and counts nothing
    counts = (pa.paged_attention.int8_launches,
              pa.paged_attention.int4_launches)
    again = pa.paged_attention(q_t, qk, qv, tab_t, pos_t, seq_slots=slots_t,
                               live_pages=live, window=window, **quant)
    assert torch.equal(again, pa.paged_attention_reference(
        q_t, qk, qv, tab_t, pos_t, seq_slots=slots_t, live_pages=live,
        window=window, **quant))
    assert counts == (pa.paged_attention.int8_launches,
                      pa.paged_attention.int4_launches)


@pytest.mark.parametrize("mutate,match", [
    (lambda a: {**a, "kv_bits": 4}, "kv_bits=4"),
    (lambda a: {**a, "v_scale": None}, "v_scale"),
    (lambda a: {**a, "k_scale": a["k_scale"][:, :1]}, "k_scale"),
    (lambda a: {**a, "kv_bits": 2}, "kv_bits"),
])
def test_quantized_pool_geometry_is_checked(mutate, match):
    q, kp, vp, tables, slots, pos = _inputs(9)
    qk, qv, sk, sv = _quantized(kp, vp, 8)
    a = mutate(dict(k_scale=sk, v_scale=sv, kv_bits=8))
    q_t, tab_t, pos_t, slots_t = _torch(q, tables, pos, slots)
    with pytest.raises(ValueError, match=match):
        pa.paged_attention(q_t, qk, qv, tab_t, pos_t, seq_slots=slots_t, **a)


def test_wrapper_on_cpu_runs_the_plain_version_without_counting():
    q, kp, vp, tables, slots, pos = _inputs(3, hq=8, hkv=2)
    args = _torch(q, kp, vp, tables, pos)
    slots_t = torch.from_numpy(slots)
    before = pa.paged_attention.launches
    got = pa.paged_attention(*args, seq_slots=slots_t, live_pages=4, window=9)
    ref = pa.paged_attention_reference(*args, seq_slots=slots_t,
                                       live_pages=4, window=9)
    assert torch.equal(got, ref)
    assert pa.paged_attention.launches == before


def test_row_with_no_visible_key_is_zero():
    # the kernel's l == 0 guard: a lane whose walk sees nothing writes 0
    q, kp, vp, tables, slots, pos = _inputs(4)
    pos[:] = -1
    got = pa.paged_attention_reference(*_torch(q, kp, vp, tables, pos),
                                       seq_slots=torch.from_numpy(slots))
    assert torch.count_nonzero(got) == 0


def test_bf16_plain_matches_fp32_within_bf16_rounding():
    q, kp, vp, tables, slots, pos = _inputs(5, hq=8, hkv=2)
    t32 = _torch(q, kp, vp, tables, pos)
    t16 = [a.to(torch.bfloat16) if a.is_floating_point() else a for a in t32]
    s = torch.from_numpy(slots)
    out16 = pa.paged_attention_reference(*t16, seq_slots=s)
    out32 = pa.paged_attention_reference(*t32, seq_slots=s)
    assert out16.dtype == torch.bfloat16
    np.testing.assert_allclose(out16.float().numpy(), out32.numpy(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("mutate,exc", [
    (lambda a: {**a, "kp": a["kp"].to(torch.bfloat16)}, TypeError),
    (lambda a: {**a, "tables": a["tables"].long()}, TypeError),
    (lambda a: {**a, "pos": a["pos"][:-1]}, ValueError),
    (lambda a: {**a, "slots": None}, ValueError),      # 3-row table, T=8
    (lambda a: {**a, "vp": a["vp"][:, :2]}, ValueError),
    (lambda a: {**a, "q": a["q"][:, :3]}, ValueError),  # hq % hkv != 0
])
def test_wrapper_rejects_bad_inputs(mutate, exc):
    q, kp, vp, tables, slots, pos = _inputs(6)
    a = dict(zip(("q", "kp", "vp", "tables", "slots", "pos"),
                 _torch(q, kp, vp, tables, slots, pos)))
    a = mutate(a)
    with pytest.raises(exc):
        pa.paged_attention(a["q"], a["kp"], a["vp"], a["tables"], a["pos"],
                           seq_slots=a["slots"])


def test_wrapper_raises_on_a_device_it_has_no_kernel_for():
    q, kp, vp, tables, slots, pos = _inputs(6)
    meta = [torch.empty(a.shape, dtype=torch.from_numpy(a).dtype,
                        device="meta") for a in (q, kp, vp, tables, pos, slots)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        pa.paged_attention(*meta[:5], seq_slots=meta[5])


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(op_builder, "NVCC_FALLBACK", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        op_builder.find_nvcc()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 2e-5, 2e-5),
                                             (torch.bfloat16, 4e-3, 1e-2)])
def test_cuda_kernel_matches_plain_version(dtype, atol, rtol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    q, kp, vp, tables, slots, pos = _inputs(8, T=24, hq=8, hkv=2, hd=128,
                                            block=16, max_pages=8,
                                            live_pages=6, tail=True)
    args = [a.to("cuda") for a in _torch(q, kp, vp, tables, pos)]
    args = [a.to(dtype) if a.is_floating_point() else a for a in args]
    s = torch.from_numpy(slots).cuda()
    before = pa.paged_attention.launches
    got = pa.paged_attention(*args, seq_slots=s, live_pages=6, window=37)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    ref = pa.paged_attention_reference(*args, seq_slots=s, live_pages=6,
                                       window=37)
    err = (got.float() - ref.float()).abs()
    assert bool((err <= atol + rtol * ref.float().abs()).all()), err.max()


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 2e-5, 2e-5),
                                             (torch.bfloat16, 4e-3, 1e-2)])
def test_cuda_quantized_kernel_matches_plain_version(bits, dtype, atol, rtol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, kp, vp, tables, slots, pos = _inputs(18, T=24, hq=8, hkv=2, hd=128,
                                            block=16, max_pages=8,
                                            live_pages=6, tail=True)
    qk, qv, sk, sv = (a.cuda() for a in _quantized(kp, vp, bits))
    q_t, tab_t, pos_t, s = (a.cuda() for a in _torch(q, tables, pos, slots))
    q_t = q_t.to(dtype)
    quant = dict(k_scale=sk, v_scale=sv, kv_bits=bits)
    name = f"int{bits}_launches"
    before = getattr(pa.paged_attention, name)
    got = pa.paged_attention(q_t, qk, qv, tab_t, pos_t, seq_slots=s,
                             live_pages=6, window=37, **quant)
    torch.cuda.synchronize()
    assert getattr(pa.paged_attention, name) == before + 1
    ref = pa.paged_attention_reference(q_t, qk, qv, tab_t, pos_t, seq_slots=s,
                                       live_pages=6, window=37, **quant)
    assert got.dtype == dtype
    err = (got.float() - ref.float()).abs()
    assert bool((err <= atol + rtol * ref.float().abs()).all()), err.max()
