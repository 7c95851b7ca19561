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


# bf16 pools against the JAX Pallas kernel in interpret mode: lanes as
# (sequence, position), over 4 sequences of 8 pages of 16
BF16_CASES = {
    "prefill-chunk": ([(1, p) for p in range(40, 64)], 4, 4, 0),
    "decode-lanes": ([(0, 100), (2, 7), (3, 127), (1, 64)], 4, 4, 0),
    "mixed-put": ([(0, 100), (2, 7), (3, 127)]
                  + [(1, p) for p in range(37, 57)], 4, 4, 0),
    "window": ([(0, 100), (2, 7)] + [(1, p) for p in range(37, 57)], 4, 4,
               13),
    "gqa-group4": ([(0, 100), (3, 127)] + [(1, p) for p in range(37, 57)],
                   8, 2, 0),
}


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("name", sorted(BF16_CASES))
def test_bf16_plain_matches_jax_kernel_rounding(name):
    """On bf16 pools the TPU kernel rounds P to V's dtype before P.V
    (``paged_attention.py:123``); so does the plain version. With the JAX
    kernel's page chunk covering the whole walk, both take P against the
    same row max, and the outputs agree bit for bit up to a flip of P's
    rounding where the fp32 logits sum in another order: at most one bf16
    ulp on any element and at least 99 % of elements bitwise equal. (The
    plain version with P left in fp32 differs on about 38 % of them.)"""
    lanes, hq, hkv, window = BF16_CASES[name]
    rng = np.random.default_rng(21)
    n_seqs, max_pages, block, hd = 4, 8, 16, 64
    n_pages = n_seqs * max_pages + 2
    q = rng.standard_normal((len(lanes), hq, hd)).astype(np.float32)
    kp = rng.standard_normal((n_pages, hkv, block, hd)).astype(np.float32)
    vp = rng.standard_normal((n_pages, hkv, block, hd)).astype(np.float32)
    tables = rng.permutation(n_pages)[:n_seqs * max_pages] \
        .reshape(n_seqs, max_pages).astype(np.int32)
    slots = np.array([s for s, _ in lanes], np.int32)
    pos = np.array([p for _, p in lanes], np.int32)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, kp, vp)]
    got = pa.paged_attention_reference(
        *bf, torch.from_numpy(tables), torch.from_numpy(pos),
        seq_slots=torch.from_numpy(slots), window=window)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, kp, vp)]
    ref = jax_paged_attention(*jb, jnp.asarray(tables), jnp.asarray(pos),
                              seq_slots=jnp.asarray(slots), window=window,
                              pages_per_chunk=max_pages, interpret=True)
    assert got.dtype == torch.bfloat16
    g, r = got.float().numpy(), np.asarray(ref, np.float32)
    err = np.abs(g - r)
    assert np.all(err <= _bf16_ulp(r)), err.max()
    assert np.mean(err == 0) >= 0.99, np.mean(err == 0)


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


# ---------------------------------------------------------------- work list
WORK_CASES = {
    # name: (seq_slots, walk, hkv, tiles)
    "decode-16": (list(range(16)), 64, 32, True),
    "prefill-512": ([0] * 512, 32, 32, True),
    "mixed": ([3, 5, 1] + [2] * 70 + [4] * 15 + [0] * 20, 64, 8, True),
    "short-runs-only": ([1] * 15 + [2] * 15, 8, 4, True),
    "tiles-off": ([2] * 100, 16, 32, False),
    "per-token-tables": (None, 16, 4, True),
    "padded-put": ([3, 5] + [2] * 30 + [-1] * 32, 64, 32, True),
}


@pytest.mark.parametrize("name", sorted(WORK_CASES))
def test_work_list_covers_every_lane_once(name):
    slots, walk, hkv, tiles = WORK_CASES[name]
    T = 24 if slots is None else len(slots)
    arr = None if slots is None else np.asarray(slots, np.int32)
    pad = None if arr is None else arr < 0
    t, i, l = pa.paged_work_arrays(
        None if arr is None else np.maximum(arr, 0), T, walk, hkv, tiles,
        pad)
    covered = np.zeros(T, int)
    for t0, n in t:
        assert 1 <= n <= pa.TILE_LANES
        assert len(set(arr[t0:t0 + n])) == 1         # one sequence a tile
        covered[t0:t0 + n] += 1
    for lane, first, n in l:
        covered[lane] += 1
        spans = i[first:first + n]
        if pad is not None and pad[lane]:      # one span over the walk
            assert spans.tolist() == [[lane, 0, walk]]
            continue
        assert (spans[:, 0] == lane).all()
        # the spans partition the walk, in order
        assert spans[0, 1] == 0 and spans[-1, 2] == walk
        assert (spans[1:, 1] == spans[:-1, 2]).all()
    assert (covered == 1).all()
    assert len(i) == sum(n for *_, n in l)
    if not tiles or slots is None:
        assert len(t) == 0
    # runs of at least MIN_TILE_RUN lanes take tiles, the rest lane items
    if name == "mixed":
        assert t.tolist() == [[3, 64], [67, 6], [88, 20]]
        assert l[:, 0].tolist() == [0, 1, 2] + list(range(73, 88))
    if name == "padded-put":     # padding never joins a tile
        assert t.tolist() == [[2, 30]]
    # the real lanes' items fill the card: at least SPLIT_BLOCKS blocks
    # where the walk has pages enough
    real = [n for lane, _, n in l if pad is None or not pad[lane]]
    if real:
        assert sum(real) * hkv >= min(pa.SPLIT_BLOCKS,
                                      len(real) * walk * hkv)


def _run_lane_items(q, kp, vp, tables, slots, pos, walk, window, items,
                    lanes):
    """The split kernel and its combine pass in numpy (fp64): each item's
    (m, l, acc) over its pages of the lane's walk, merged in item order."""
    T, hq, hd = q.shape
    _, hkv, block, _ = kp.shape
    group = hq // hkv
    out = np.zeros_like(q, dtype=np.float64)
    scale = 1.0 / np.sqrt(hd)
    for lane, first, n in lanes:
        p = int(pos[lane])
        hi = min(p // block + 1 if p >= 0 else 0, walk)
        lo = max(p - window + 1, 0) // block if window > 0 else 0
        parts = []
        for _, p0, p1 in items[first:first + n]:
            pages = range(max(lo, p0), min(hi, p1))
            keys = [(pg * block + r, tables[slots[lane], pg], r)
                    for pg in pages for r in range(block)]
            keys = [k for k in keys if k[0] <= p
                    and (window <= 0 or k[0] > p - window)]
            m = np.full(hq, -1e30)
            s_l = np.zeros(hq)
            acc = np.zeros((hq, hd))
            if keys:
                h_kv = np.arange(hq) // group
                kk = np.stack([kp[page, h_kv, r] for _, page, r in keys], 1)
                vv = np.stack([vp[page, h_kv, r] for _, page, r in keys], 1)
                s = np.einsum("hd,hkd->hk", q[lane], kk) * scale
                m = s.max(1)
                e = np.exp(s - m[:, None])
                s_l = e.sum(1)
                acc = np.einsum("hk,hkd->hd", e, vv)
            parts.append((m, s_l, acc))
        mx = np.max([m for m, _, _ in parts], 0)
        w = [np.exp(m - mx) for m, _, _ in parts]
        tot = sum(s_l * wi for (_, s_l, _), wi in zip(parts, w))
        acc = sum(a * wi[:, None] for (_, _, a), wi in zip(parts, w))
        out[lane] = np.where(tot[:, None] == 0, 0.0,
                             acc / np.where(tot == 0, 1, tot)[:, None])
    return out


@pytest.mark.parametrize("window", [0, 9])
def test_lane_items_merge_to_the_plain_version(window):
    """The split-K decomposition (spans of pages, partials merged by their
    maxima) computes the plain version's function, fp32, 1e-5."""
    q, kp, vp, tables, slots, pos = _inputs(11, T=12, hq=8, hkv=2,
                                            max_pages=8, live_pages=5)
    walk = 5
    t, items, lanes = pa.paged_work_arrays(slots, len(slots), walk, 2, False)
    assert len(t) == 0 and len(items) > len(lanes)   # the walk is split
    got = _run_lane_items(q.astype(np.float64), kp, vp, tables, slots, pos,
                          walk, window, items, lanes)
    ref = pa.paged_attention_reference(
        *_torch(q, kp, vp, tables, pos), seq_slots=torch.from_numpy(slots),
        live_pages=walk, window=window)
    np.testing.assert_allclose(got, ref.numpy(), **TOL)


def _pool(dtype, hd=64, block=16, hkv=4):
    return torch.zeros((4, hkv, block, hd), dtype=dtype)


def test_wrapper_refuses_a_work_list_of_another_call():
    """The rule the wrapper applies to a work list it is given: the call's
    (T, walk, hkv), and tile items only where the call takes them."""
    pool = _pool(torch.bfloat16)
    work = pa.plan_paged_work(np.zeros(40, np.int32), 40, 6, pool,
                              dtype=torch.bfloat16)
    assert work.n_tiles == 1
    pa.check_paged_work(work, 40, 6, 4, tiles=True)
    for geometry in ((41, 6, 4), (40, 5, 4), (40, 6, 2)):
        with pytest.raises(ValueError, match="work list for"):
            pa.check_paged_work(work, *geometry, tiles=True)
    with pytest.raises(ValueError, match="tile items"):
        pa.check_paged_work(work, 40, 6, 4, tiles=False)


WORK_PLAN_CASES = {
    # name: (q dtype, pool, quantized, scale, slots given) -> tile items?
    "bf16-hd64": ((torch.bfloat16, _pool(torch.bfloat16), False, None,
                   True), True),
    "fp16-hd128-block8": ((torch.float16, _pool(torch.float16, 128, 8),
                           False, None, True), True),
    "fp32": ((torch.float32, _pool(torch.float32), False, None, True),
             False),
    "int8": ((torch.bfloat16, _pool(torch.int8), True, None, True), False),
    "negative-scale": ((torch.bfloat16, _pool(torch.bfloat16), False, -0.1,
                        True), False),
    "per-token-tables": ((torch.bfloat16, _pool(torch.bfloat16), False,
                          None, False), False),
}


@pytest.mark.parametrize("name", sorted(WORK_PLAN_CASES))
def test_planner_and_wrapper_share_the_tile_decision(name):
    """plan_paged_work plans tile items exactly where _takes_tiles (the
    wrapper's check) lets the call run them, so the wrapper accepts every
    list the planner gives for that call."""
    (dtype, pool, quantized, scale, has_slots), want = WORK_PLAN_CASES[name]
    assert pa._takes_tiles(has_slots, dtype, pool, quantized, scale) is want
    slots = np.repeat(np.arange(3, dtype=np.int32), 20)
    work = pa.plan_paged_work(slots if has_slots else None, len(slots), 4,
                              pool, dtype=dtype, quantized=quantized,
                              scale=scale)
    assert (work.n_tiles > 0) is want
    pa.check_paged_work(work, len(slots), 4, pool.shape[1], want)


def test_decode_lanes_plan_no_tiles_and_fit_a_tile_call():
    """A decode step's lanes (one slot each, padding marked), as the
    ragged engine's decode_steps plans them, form no tile on a pool that
    takes tiles, and the wrapper's check accepts that list for the call."""
    slots = np.array([0, 1, 2, -1, 4, 5, -1, 7] * 4, np.int32)
    slots[slots >= 0] = np.arange((slots >= 0).sum())
    pool = _pool(torch.bfloat16, 128, 16, hkv=32)
    work = pa.plan_paged_work(np.maximum(slots, 0), len(slots), 64, pool,
                              dtype=torch.bfloat16, pad=slots < 0)
    assert work.n_tiles == 0 and work.n_pad == 8
    assert work.n_lanes == len(slots)
    pa.check_paged_work(work, len(slots), 64, 32, tiles=True)


TILE_PATH_CASES = {
    # name: (dtype, hd, block, quantized) -> tile items?
    "7b-bf16": ((torch.bfloat16, 128, 16, False), True),
    "1b-fp16-block32": ((torch.float16, 64, 32, False), True),
    "block8": ((torch.bfloat16, 64, 8, False), True),
    "block4": ((torch.bfloat16, 64, 4, False), False),
    "fp32": ((torch.float32, 128, 16, False), False),
    "hd256": ((torch.bfloat16, 256, 16, False), False),
    "int8": ((torch.bfloat16, 128, 16, True), False),
}


@pytest.mark.parametrize("name", sorted(TILE_PATH_CASES))
def test_paged_tile_path_predicate(name):
    args, want = TILE_PATH_CASES[name]
    assert pa.paged_tile_path(*args) is want


def _cuda_paged(seed, seqs, lanes, hq, hkv, hd, block, dtype, max_pages=None):
    """Pools of random pages, one table row a sequence of ``seqs`` context
    lengths, and q for ``lanes`` (sequence, position) on the card."""
    gen = torch.Generator().manual_seed(seed)
    per = [-(-c // block) for c in seqs]
    max_pages = max_pages or max(per)
    n_pages = sum(per) + 4
    perm = torch.randperm(n_pages, generator=gen)
    tables = torch.zeros((len(seqs), max_pages), dtype=torch.int32)
    at = 0
    for i, n in enumerate(per):
        tables[i, :n] = perm[at:at + n].to(torch.int32)
        at += n

    def mk(*shape):
        return torch.randn(shape, generator=gen).to(dtype).cuda()
    slots = torch.tensor([s for s, _ in lanes], dtype=torch.int32).cuda()
    pos = torch.tensor([p for _, p in lanes], dtype=torch.int32).cuda()
    return (mk(len(lanes), hq, hd), mk(n_pages, hkv, block, hd),
            mk(n_pages, hkv, block, hd), tables.cuda(), pos, slots)


def _chunk(seq, first, n):
    return [(seq, p) for p in range(first, first + n)]


def _decode(ctxs):
    return [(s, c - 1) for s, c in enumerate(ctxs)]


CUDA_WORK_CASES = {
    # name: (contexts, lanes, hq, hkv, hd, block, dtype, window, live,
    #        tiles expected, lane items expected)
    "chunk-70-of-200": ([200], _chunk(0, 130, 70), 8, 8, 128, 16,
                        torch.bfloat16, 0, None, True, False),
    "chunk-mid-page": ([300], _chunk(0, 37, 100), 8, 2, 64, 16,
                       torch.float16, 0, None, True, False),
    "tile-window-spans-two-sequences": (
        [90, 120], _chunk(0, 50, 40) + _chunk(1, 80, 40), 8, 8, 128, 16,
        torch.bfloat16, 0, None, True, False),
    "decode-1-lane-17": ([17], _decode([17]), 8, 8, 128, 16, torch.bfloat16,
                         0, None, False, True),
    "decode-1-lane-4096": ([4096], _decode([4096]), 32, 32, 128, 16,
                           torch.bfloat16, 0, None, False, True),
    "decode-16-lanes-17": ([17] * 16, _decode([17] * 16), 32, 32, 128, 16,
                           torch.bfloat16, 0, None, False, True),
    "decode-16-lanes-1024": ([1024] * 16, _decode([1024] * 16), 32, 32, 128,
                             16, torch.bfloat16, 0, None, False, True),
    "decode-16-lanes-4096": ([4096] * 16, _decode([4096] * 16), 32, 4, 64,
                             16, torch.bfloat16, 0, None, False, True),
    "mixed-put-live-below-width": (
        [17, 1024, 4096, 700], _decode([17, 1024, 4096]) + _chunk(3, 600, 100),
        32, 32, 128, 16, torch.bfloat16, 0, 512, True, True),
    "window-100-gqa": ([1000, 300], _decode([1000]) + _chunk(1, 200, 100),
                       32, 4, 64, 16, torch.bfloat16, 100, None, True, True),
    "block32-fp16": ([500, 333], _decode([500]) + _chunk(1, 300, 33), 16, 4,
                     128, 32, torch.float16, 0, None, True, True),
    "block8-window": ([250], _chunk(0, 150, 100), 8, 2, 64, 8,
                      torch.bfloat16, 40, None, True, False),
    "fp32-lane-items": ([400, 90], _decode([400]) + _chunk(1, 10, 80), 8, 2,
                        128, 16, torch.float32, 0, None, False, True),
    "hd256-lane-items": ([300], _chunk(0, 250, 50), 8, 2, 256, 64,
                         torch.bfloat16, 0, None, False, True),
}


def _half_close(got, ref, dtype):
    a, r = (2e-5, 2e-5) if dtype == torch.float32 else (4e-3, 1e-2)
    err = (got.float() - ref.float()).abs()
    return bool((err <= a + r * ref.float().abs()).all()), err.max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CUDA_WORK_CASES))
def test_cuda_tile_and_lane_items_match_plain_and_repeat(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    (ctxs, lanes, hq, hkv, hd, block, dtype, window, live, want_tiles,
     want_items) = CUDA_WORK_CASES[name]
    q, kp, vp, tab, pos, slots = _cuda_paged(
        30, ctxs, lanes, hq, hkv, hd, block, dtype,
        max_pages=None if live is None else 2 * live)
    kw = dict(seq_slots=slots, live_pages=live, window=window)
    counts = (pa.paged_attention.tile_launches,
              pa.paged_attention.split_launches)
    got = pa.paged_attention(q, kp, vp, tab, pos, **kw)
    again = pa.paged_attention(q, kp, vp, tab, pos, **kw)
    torch.cuda.synchronize()
    assert (pa.paged_attention.tile_launches - counts[0],
            pa.paged_attention.split_launches - counts[1]) == \
        (2 * want_tiles, 2 * want_items)
    ref = pa.paged_attention_reference(q, kp, vp, tab, pos, **kw)
    ok, err = _half_close(got, ref, dtype)
    assert ok, err
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("name", ["decode-16-lanes-1024", "chunk-mid-page",
                                  "window-100-gqa"])
def test_cuda_quantized_lane_items_match_plain_and_repeat(name, bits):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    ctxs, lanes, hq, hkv, hd, block, dtype, window, live, *_ = \
        CUDA_WORK_CASES[name]
    q, kp, vp, tab, pos, slots = _cuda_paged(31, ctxs, lanes, hq, hkv, hd,
                                             block, dtype)
    kq, ks = quantize_kv(kp, bits)
    vq, vs = quantize_kv(vp, bits)
    kw = dict(seq_slots=slots, live_pages=live, window=window, k_scale=ks,
              v_scale=vs, kv_bits=bits)
    counts = (pa.paged_attention.tile_launches,
              pa.paged_attention.split_launches)
    got = pa.paged_attention(q, kq, vq, tab, pos, **kw)
    again = pa.paged_attention(q, kq, vq, tab, pos, **kw)
    torch.cuda.synchronize()
    assert (pa.paged_attention.tile_launches - counts[0],
            pa.paged_attention.split_launches - counts[1]) == (0, 2)
    ref = pa.paged_attention_reference(q, kq, vq, tab, pos, **kw)
    ok, err = _half_close(got, ref, dtype)
    assert ok, err
    assert torch.equal(got, again)
