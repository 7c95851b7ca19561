"""The ragged engine of the PyTorch port against the JAX engine, on the CPU.

Both engines serve the same tiny Llama (JAX weights carried across) in
fp32. ``put`` logits agree within 1e-4 — including a prompt longer than
the token budget, which spans several SplitFuse steps — and greedy
``generate`` / ``stream`` / ``decode_steps`` streams are identical. The
host-side pieces (allocator, prefix cache, block balance, pool
exhaustion) and the pool scatter's indexing are checked on their own. With
``kv_quant`` int8 and int4 the pools hold quantized payloads and scales:
greedy streams stay identical to the JAX engine's, logits agree within
1e-4, and ``kv_blocks_for_bytes`` sizes the pools alike. ``trim`` (with
its copy-on-write of a shared boundary page) leaves the JAX engine's
tokens, blocks and refcounts; ``export_kv`` / ``import_kv`` hand a
sequence over bitwise, also from a JAX export; sampled decoding is
seeded, in vocab and invariant to the decode chunk.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.inference.ragged import (
    RaggedConfig as JaxRaggedConfig,
    RaggedInferenceEngine as JaxRaggedEngine,
    kv_blocks_for_bytes as jax_kv_blocks_for_bytes,
    kv_page_bytes as jax_kv_page_bytes)
from deepspeed_tpu.models import Llama as JaxLlama
from deepspeed_tpu_torch.checkpoint.jax_params import (load_jax_params,
                                                       load_kv_export)
from deepspeed_tpu_torch.comm.comm import get_comms_logger
from deepspeed_tpu_torch.inference.engine import _filter_logits
from deepspeed_tpu_torch.inference.ragged import (
    BlockedAllocator, PoolExhausted, RaggedConfig, RaggedInferenceEngine,
    assert_block_balance, block_balance_report, kv_blocks_for_bytes,
    kv_page_bytes)
from deepspeed_tpu_torch.models.llama import Llama
from deepspeed_tpu_torch.ops.ragged_host import build_batch, fill_tables

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, vocab_size=128,
            max_seq_len=256)
CFG = dict(token_budget=32, max_seqs=4, kv_block_size=8, n_kv_blocks=64,
           max_context=128)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    jm = JaxLlama("tiny", use_flash=False, remat=False, **TINY)
    params = jm.init(jax.random.PRNGKey(5))
    pnp = jax.tree_util.tree_map(np.asarray, params)
    return jm, params, pnp


def _pair(models, model_kw=None, **kw):
    jm, params, pnp = models
    if model_kw:
        jm = JaxLlama("tiny", use_flash=False, remat=False,
                      **{**TINY, **model_kw})
    cfg = {**CFG, **kw}
    je = JaxRaggedEngine(jm, JaxRaggedConfig(dtype=jnp.float32, **cfg),
                         params=params)
    tm = load_jax_params(Llama("tiny", device="cpu",
                               **{**TINY, **(model_kw or {})}), pnp)
    te = RaggedInferenceEngine(tm, RaggedConfig(dtype=torch.float32, **cfg),
                               device="cpu")
    return je, te


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(1, 128, n).tolist()


def _assert_rows(got, ref):
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    m = ~np.isnan(ref)
    np.testing.assert_allclose(got[m], ref[m], **TOL)


def test_put_logits_match_jax_across_splitfuse_steps(models):
    je, te = _pair(models)
    prompts = {1: _prompt(1, 5), 2: _prompt(2, 45), 3: _prompt(3, 13)}
    uids, toks = list(prompts), list(prompts.values())
    ref, got = je.put(uids, toks), te.put(uids, toks)
    _assert_rows(got, ref)
    assert np.isnan(got[1]).all()                 # uid 2 still mid-prefill
    # continue uid 2's prefill while the others decode one token each
    for _ in range(3):
        feed = [[int(np.nanargmax(r))] if not np.isnan(r).any() else []
                for r in ref]
        ref, got = je.put(uids, feed), te.put(uids, feed)
        _assert_rows(got, ref)
    assert not np.isnan(got).any()
    assert te.seqs[2].seen == je.seqs[2].seen == 45 + 1
    assert_block_balance(te)


def test_generate_streams_identical_to_jax(models):
    je, te = _pair(models)
    prompts = {7: _prompt(7, 40), 8: _prompt(8, 6), 9: _prompt(9, 17)}
    ref = je.generate(prompts, max_new_tokens=12, decode_chunk=5)
    got = te.generate(prompts, max_new_tokens=12, decode_chunk=5)
    assert got == ref
    assert_block_balance(te, expect_free=CFG["n_kv_blocks"])


def test_eos_and_stream_identical_to_jax(models):
    je, te = _pair(models)
    p = _prompt(10, 11)
    full = je.generate({1: p}, max_new_tokens=10)[1]
    eos = full[4]
    assert te.generate({1: p}, max_new_tokens=10, eos_token_id=eos) == \
        je.generate({1: p}, max_new_tokens=10, eos_token_id=eos)
    assert list(te.stream(2, p, max_new_tokens=9, decode_chunk=4)) == \
        list(je.stream(2, p, max_new_tokens=9, decode_chunk=4))
    assert te.seqs == {} and te.allocator.free_blocks == CFG["n_kv_blocks"]


def test_decode_steps_with_eos_freeze_identical_to_jax(models):
    je, te = _pair(models)
    p = _prompt(12, 9)
    lj, lt = je.put([1], [p]), te.put([1], [p])
    first = int(np.argmax(lj[0]))
    assert first == int(np.argmax(lt[0]))
    chain = je.decode_steps({1: first}, 6)[1]
    eos = chain[2]
    je2, te2 = _pair(models)
    je2.put([1], [p])
    te2.put([1], [p])
    assert te2.decode_steps({1: first}, 6, eos_token_id=eos) == \
        je2.decode_steps({1: first}, 6, eos_token_id=eos)
    assert te2.seqs[1].tokens == je2.seqs[1].tokens
    assert te2.seqs[1].seen == je2.seqs[1].seen


def test_prefix_cache_reuse_matches_jax(models):
    je, te = _pair(models, enable_prefix_cache=True)
    shared = _prompt(20, 24)
    a, b = shared + _prompt(21, 3), shared + _prompt(22, 5)
    assert te.generate({1: a}, max_new_tokens=4) == \
        je.generate({1: a}, max_new_tokens=4)
    ref, got = je.put([2], [b]), te.put([2], [b])
    assert te.prefix_cache.hits == 1 and te.seqs[2].seen == 24 + 5
    _assert_rows(got, ref)
    te.flush([2])
    assert_block_balance(te)


def test_sliding_window_model_matches_jax(models):
    je, te = _pair(models, model_kw=dict(attn_windows=(8, 0)))
    prompts = {1: _prompt(30, 30), 2: _prompt(31, 11)}
    assert te.generate(prompts, max_new_tokens=8) == \
        je.generate(prompts, max_new_tokens=8)


def test_pool_scatter_indexing_matches_numpy():
    # kp.at[page, :, row].set(kk) in JAX; pool[page, :, row] = kk here: two
    # advanced indices around a slice put the lane dim first
    rng = np.random.default_rng(0)
    pool = np.zeros((5, 3, 4, 2), np.float32)
    page = np.array([4, 0, 2])
    row = np.array([1, 3, 0])
    kk = rng.standard_normal((3, 3, 2)).astype(np.float32)
    ref = pool.copy()
    for t in range(3):
        ref[page[t], :, row[t]] = kk[t]
    got = torch.from_numpy(pool.copy())
    got[torch.from_numpy(page), :, torch.from_numpy(row)] = torch.from_numpy(kk)
    assert got[torch.from_numpy(page), :, torch.from_numpy(row)].shape == (3, 3, 2)
    np.testing.assert_array_equal(got.numpy(), ref)
    jgot = jnp.asarray(pool).at[page, :, row].set(kk)
    np.testing.assert_array_equal(np.asarray(jgot), ref)


def test_padding_lanes_write_only_the_sink_page(models):
    _, te = _pair(models, n_kv_blocks=16, max_seqs=2)
    te.put([1], [_prompt(40, 3)])            # T bucket 32: 29 padding lanes
    sink = te.config.n_kv_blocks
    live = set(te.seqs[1].blocks)
    for leaf in te.kv_pool[0]:
        written = {int(p) for p in torch.nonzero(
            leaf.abs().sum(dim=(1, 2, 3)))[:, 0]}
        assert written <= live | {sink}
        assert sink in written


def test_host_builders():
    toks, slots, pos, last = build_batch([[5, 6, 7], [9]], [4, 0], [2, 0], 8)
    assert toks.tolist() == [5, 6, 7, 9, 0, 0, 0, 0]
    assert slots.tolist() == [2, 2, 2, 0, -1, -1, -1, -1]
    assert pos.tolist() == [4, 5, 6, 0, 0, 0, 0, 0]
    assert last.tolist() == [2, 3]
    with pytest.raises(ValueError):
        build_batch([[1, 2, 3]], [0], [0], 2)
    tab = fill_tables([[3, 1], [7]], [1, 0], 3, 4)
    assert tab.tolist() == [[7, 0, 0, 0], [3, 1, 0, 0], [0, 0, 0, 0]]
    with pytest.raises(ValueError):
        fill_tables([[1, 2, 3]], [0], 1, 2)


def test_allocator_refcounts_and_exhaustion():
    a = BlockedAllocator(4)
    blocks = a.allocate(3)
    a.retain(blocks[:1])
    a.release(blocks)
    assert a.free_blocks == 3 and a.refcount(blocks[0]) == 1
    with pytest.raises(PoolExhausted):
        a.allocate(4)


def test_pool_exhaustion_leaves_state_consistent(models):
    _, te = _pair(models, n_kv_blocks=4)
    te.put([1], [_prompt(50, 20)])           # 3 pages
    with pytest.raises(PoolExhausted):
        te.put([2], [_prompt(51, 20)])
    assert te.seqs[2].seen == 0 and te.seqs[2].blocks == []
    te.discard(2)
    te.preempt(1)
    assert_block_balance(te, expect_free=4)
    assert block_balance_report(te)["held"] == 0


def test_query_and_can_schedule(models):
    _, te = _pair(models)
    assert te.can_schedule([1, 2], [40, 40])
    assert not te.can_schedule([1, 2, 3, 4, 5], [1] * 5)     # 4 slots
    assert te.blocks_needed(17) == 4
    te.put([1], [_prompt(60, 10)])
    room, free = te.query(1)
    assert free == CFG["n_kv_blocks"] - 2 and room == CFG["token_budget"]
    assert 0 < te.kv_occupancy() < 1


@pytest.mark.parametrize("kw,match", [(dict(kv_quant="fp8"), "kv_quant"),
                                      (dict(temperature=-0.7), "temperature")])
def test_later_slice_options_raise(models, kw, match):
    """An unknown kv_quant is refused as the JAX engine refuses it, and a
    negative temperature is refused (sampling itself is ported:
    ``test_sampled_decoding_is_seeded_and_chunk_invariant``)."""
    with pytest.raises(ValueError, match=match):
        _pair(models, **kw)


@pytest.mark.parametrize("kv_quant", ["int8", "int4"])
def test_quantized_pools_match_jax(models, kv_quant):
    je, te = _pair(models, kv_quant=kv_quant)
    assert te.kv_pool[0][0].dtype == (torch.int8 if kv_quant == "int8"
                                      else torch.uint8)
    assert te.kv_pool[0][0].shape[-1] == (16 if kv_quant == "int8" else 8)
    assert len(te.kv_pool) == 4 and te.kv_pool[2][0].dtype == torch.float32
    prompts = {1: _prompt(1, 5), 2: _prompt(2, 45), 3: _prompt(3, 13)}
    uids, toks = list(prompts), list(prompts.values())
    _assert_rows(te.put(uids, toks), je.put(uids, toks))
    je.flush(uids)
    te.flush(uids)
    prompts = {7: _prompt(7, 40), 8: _prompt(8, 6), 9: _prompt(9, 17)}
    ref = je.generate(prompts, max_new_tokens=12, decode_chunk=5)
    assert te.generate(prompts, max_new_tokens=12, decode_chunk=5) == ref
    assert_block_balance(te, expect_free=CFG["n_kv_blocks"])
    # pages never written (all but the ones used and the sink) keep zero
    # payloads and zero scales
    sink = CFG["n_kv_blocks"]
    used = {int(p) for leaf in te.kv_pool[2]
            for p in torch.nonzero(leaf.abs().sum(dim=(1, 2)))[:, 0]}
    assert sink in used and len(used) < sink
    for leaf in te.kv_pool[0] + te.kv_pool[2]:
        unused = [p for p in range(sink) if p not in used]
        assert not leaf[unused].any()


@pytest.mark.parametrize("kv_quant", ["none", "int8", "int4"])
def test_kv_page_bytes_and_blocks_for_bytes_match_jax(kv_quant):
    """At Llama-2-7B's widths and the fp pool's byte budget (2048 bf16
    pages of 16 tokens)."""
    from deepspeed_tpu.models.llama import llama_config as jax_llama_config
    from deepspeed_tpu_torch.models.llama import llama_config

    tc, jc = llama_config("7b"), jax_llama_config("7b")
    tcfg = RaggedConfig(kv_block_size=16, dtype=torch.bfloat16,
                        kv_quant=kv_quant)
    jcfg = JaxRaggedConfig(kv_block_size=16, dtype=jnp.bfloat16,
                           kv_quant=kv_quant)
    budget = 2048 * kv_page_bytes(tc, RaggedConfig(kv_block_size=16,
                                                   dtype=torch.bfloat16))
    assert budget == 2048 * 8_388_608
    assert kv_page_bytes(tc, tcfg) == jax_kv_page_bytes(jc, jcfg)
    got = kv_blocks_for_bytes(budget, tc, tcfg)
    assert got == jax_kv_blocks_for_bytes(budget, jc, jcfg)
    assert got == {"none": 2048, "int8": 3971, "int4": 7710}[kv_quant]


def test_int4_pools_need_an_even_head_dim(models):
    with pytest.raises(ValueError, match="even head_dim"):
        _pair(models, model_kw=dict(d_model=60, n_heads=4), kv_quant="int4")


@pytest.mark.gpu
def test_cuda_engine_matches_cpu_engine(models):
    """The engine through the CUDA kernel against the same engine through
    the plain version (head_dim 64, a shape the kernel takes), fp32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from deepspeed_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(TINY, d_model=128, n_heads=2, n_kv_heads=1)
    cpu_model = Llama("tiny", device="cpu", seed=3, **kw)
    cuda_model = Llama("tiny", device="cuda", **kw)
    cuda_model.load_state_dict(cpu_model.state_dict())   # one set of weights
    engines = {dev: RaggedInferenceEngine(
        m, RaggedConfig(dtype=torch.float32, **CFG), device=dev)
        for dev, m in (("cuda", cuda_model), ("cpu", cpu_model))}
    prompts = {1: _prompt(70, 45), 2: _prompt(71, 9), 3: _prompt(72, 20)}
    before = pa.paged_attention.launches
    got = engines["cuda"].put(list(prompts), list(prompts.values()))
    assert pa.paged_attention.launches == before + kw["n_layers"]
    ref = engines["cpu"].put(list(prompts), list(prompts.values()))
    _assert_rows(got, ref)
    for e in engines.values():
        e.flush(list(prompts))
    assert engines["cuda"].generate(prompts, max_new_tokens=10) == \
        engines["cpu"].generate(prompts, max_new_tokens=10)
    assert_block_balance(engines["cuda"])


@pytest.mark.gpu
@pytest.mark.parametrize("kv_quant", ["int8", "int4"])
def test_cuda_quantized_pool_engine_matches_cpu_engine(kv_quant):
    """The quantized-pool kernel inside the engine against the plain
    version: the same weights on cuda and cpu, fp32, greedy streams
    identical, one launch per layer and put."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from deepspeed_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(TINY, d_model=128, n_heads=2, n_kv_heads=1)
    cpu_model = Llama("tiny", device="cpu", seed=3, **kw)
    cuda_model = Llama("tiny", device="cuda", **kw)
    cuda_model.load_state_dict(cpu_model.state_dict())
    engines = {dev: RaggedInferenceEngine(
        m, RaggedConfig(dtype=torch.float32, kv_quant=kv_quant, **CFG),
        device=dev) for dev, m in (("cuda", cuda_model), ("cpu", cpu_model))}
    prompts = {1: _prompt(70, 45), 2: _prompt(71, 9), 3: _prompt(72, 20)}
    name = f"{kv_quant}_launches"
    before = getattr(pa.paged_attention, name)
    got = engines["cuda"].put(list(prompts), list(prompts.values()))
    assert getattr(pa.paged_attention, name) == before + kw["n_layers"]
    _assert_rows(got, engines["cpu"].put(list(prompts),
                                         list(prompts.values())))
    for e in engines.values():
        e.flush(list(prompts))
    assert engines["cuda"].generate(prompts, max_new_tokens=10) == \
        engines["cpu"].generate(prompts, max_new_tokens=10)
    assert_block_balance(engines["cuda"])


@pytest.mark.gpu
def test_cuda_bf16_pool_engine_puts_tiles_then_decodes_on_lane_items():
    """A bf16 pool at head_dim 64 with pages of 8, which the tile kernel
    takes: the first prefill put runs the 20-token chunk it schedules on
    tile items with the engine's own work list, and decode_steps runs
    lane items only, one launch a layer and step. Logits within 3e-2 x
    max|ref| of the cpu engine's in bf16 (on the CPU this model's bf16
    logits lie within 1.1 % of its fp32 ones), greedy streams
    identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from deepspeed_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(TINY, d_model=128, n_heads=2, n_kv_heads=1)
    cpu_model = Llama("tiny", device="cpu", seed=3, dtype=torch.bfloat16,
                      **kw)
    cuda_model = Llama("tiny", device="cuda", dtype=torch.bfloat16, **kw)
    cuda_model.load_state_dict(cpu_model.state_dict())
    engines = {dev: RaggedInferenceEngine(
        m, RaggedConfig(dtype=torch.bfloat16, **CFG), device=dev)
        for dev, m in (("cuda", cuda_model), ("cpu", cpu_model))}
    prompts = {1: _prompt(70, 45), 2: _prompt(71, 9), 3: _prompt(72, 20)}
    uids, toks = list(prompts), list(prompts.values())

    def counts():
        return (pa.paged_attention.tile_launches,
                pa.paged_attention.split_launches)

    before = counts()
    got = engines["cuda"].put(uids, toks)
    assert counts()[0] - before[0] == kw["n_layers"]
    ref = engines["cpu"].put(uids, toks)
    m = ~np.isnan(ref)
    assert np.array_equal(np.isnan(got), ~m)
    assert np.abs(got[m] - ref[m]).max() <= 3e-2 * np.abs(ref[m]).max()
    for e in engines.values():
        e.flush(uids)
    first = {u: 5 for u in uids}
    streams = {}
    for dev, e in engines.items():
        e.put(uids, toks)
        while any(e.seqs[u].pending for u in uids):
            pending = [u for u in uids if e.seqs[u].pending]
            e.put(pending, [[] for _ in pending])
        before = counts()
        streams[dev] = e.decode_steps(first, 6)
        if dev == "cuda":
            assert counts()[0] == before[0]
            assert counts()[1] - before[1] == 6 * kw["n_layers"]
        e.flush(uids)
    assert streams["cuda"] == streams["cpu"]
    assert engines["cuda"].generate(prompts, max_new_tokens=10) == \
        engines["cpu"].generate(prompts, max_new_tokens=10)
    assert_block_balance(engines["cuda"])


def _refcounts(eng, uid):
    return [eng.allocator.refcount(b) for b in eng.seqs[uid].blocks]


def test_trim_and_copy_on_write_match_jax(models):
    """Trim after a decode chunk, then into a page the prefix cache
    shares: the same tokens, block ids and refcounts as the JAX engine,
    the continuation's logits within 1e-4, and the cached prefix left
    intact for the next prompt."""
    je, te = _pair(models, enable_prefix_cache=True)
    p = _prompt(70, 16)
    assert te.generate({1: p}, max_new_tokens=6) == \
        je.generate({1: p}, max_new_tokens=6)
    for eng in (je, te):
        first = int(np.argmax(eng.put([2], [p])[0]))
        eng.decode_steps({2: first}, 5)
        eng.trim(2, 19)                   # back into the decoded tail
    assert te.seqs[2].tokens == je.seqs[2].tokens
    shared = te.seqs[2].blocks[0]
    assert te.allocator.refcount(shared) >= 2
    for eng in (je, te):
        eng.trim(2, 4)                    # into the shared page: a copy
    assert te.seqs[2].blocks == je.seqs[2].blocks
    assert te.seqs[2].blocks[0] != shared
    assert _refcounts(te, 2) == _refcounts(je, 2) == [1]
    assert te.seqs[2].tokens == je.seqs[2].tokens == p[:4]
    _assert_rows(te.put([2], [[3, 5, 7, 9]]), je.put([2], [[3, 5, 7, 9]]))
    for eng in (je, te):
        eng.flush([2])
    assert te.generate({3: p}, max_new_tokens=6) == \
        je.generate({3: p}, max_new_tokens=6)
    assert_block_balance(te)
    with pytest.raises(ValueError, match="trim length"):
        te.put([4], [p])
        te.trim(4, 99)


@pytest.mark.parametrize("kv_quant", ["none", "int8", "int4"])
def test_export_import_kv_bitwise_and_from_jax(models, kv_quant):
    """A hand-off between two port engines moves the pages (and scales)
    bitwise and continues the greedy stream; a JAX export carried across
    continues the JAX engine's stream with identical tokens and logits
    within 1e-4."""
    je, a = _pair(models, kv_quant=kv_quant)
    p = _prompt(71, 21)
    first = int(np.argmax(a.put([1], [p])[0]))
    logger = get_comms_logger()
    logger.enabled = True
    try:
        before = logger.snapshot_totals().get("kv_handoff", {})
        export = a.export_kv(1)
        after = logger.snapshot_totals()["kv_handoff"]
    finally:
        logger.enabled = False
    # the ledger books an fp copy's bytes beside the bytes on the wire
    assert after["count"] == before.get("count", 0) + 1
    assert after["wire_bytes"] - before.get("wire_bytes", 0) == export.nbytes
    assert after["bytes"] - before.get("bytes", 0) == 2 * 3 * 2 * 2 * 8 * 16 * 4
    assert export.n_pages == 3 and export.seen == 21
    assert export.dtype == "float32" and export.kv_quant == kv_quant
    assert (export.k_scales is None) == (kv_quant == "none")
    _, b = _pair(models, kv_quant=kv_quant, n_kv_blocks=16)
    b.put([5], [_prompt(72, 9)])          # B's pages are not A's
    b.import_kv(7, export)
    src, dst = a.seqs[1].blocks, b.seqs[7].blocks
    for ga, gb in zip(a.kv_pool, b.kv_pool):
        for la, lb in zip(ga, gb):
            assert torch.equal(la[src], lb[dst])
    assert b.decode_steps({7: first}, 6)[7] == a.decode_steps({1: first}, 6)[1]
    assert_block_balance(b)
    # from the JAX engine: its export continues on the port
    jfirst = int(np.argmax(je.put([1], [p])[0]))
    assert jfirst == first
    _, c = _pair(models, kv_quant=kv_quant)
    c.import_kv(3, load_kv_export(je.export_kv(1)))
    ref = je.put([1], [[first]])
    _assert_rows(c.put([3], [[first]]), ref)
    nxt = int(np.argmax(ref[0]))
    assert c.decode_steps({3: nxt}, 5)[3] == je.decode_steps({1: nxt}, 5)[1]
    with pytest.raises(ValueError, match="already live"):
        c.import_kv(3, export)
    assert_block_balance(c)


def test_import_kv_failures_mutate_nothing(models):
    _, a = _pair(models)
    a.put([1], [_prompt(73, 20)])
    export = a.export_kv(1)
    _, q = _pair(models, kv_quant="int8")
    with pytest.raises(ValueError, match="geometry"):
        q.import_kv(2, export)
    _, small = _pair(models, n_kv_blocks=2)
    with pytest.raises(PoolExhausted):
        small.import_kv(2, export)
    for eng in (q, small):
        assert eng.seqs == {}
        assert_block_balance(eng, expect_free=eng.allocator.n_blocks)
    with pytest.raises(ValueError, match="pending"):
        a.put([2], [_prompt(74, 60)])     # mid-prefill after one step
        a.export_kv(2)
    with pytest.raises(KeyError):
        a.export_kv(99)


def test_sampled_decoding_is_seeded_and_chunk_invariant(models):
    """temperature 0.8, top-k 20, top-p 0.9: the same seed gives the same
    streams whatever the decode chunk; another seed differs; every token
    lies in the filtered set of its logits."""
    tm = _pair(models)[1].model
    prompts = {0: _prompt(80, 9), 1: _prompt(81, 12)}

    def run(seed, chunk, **kw):
        eng = RaggedInferenceEngine(
            tm, RaggedConfig(dtype=torch.float32, temperature=0.8, top_k=20,
                             top_p=0.9, **{**CFG, **kw}),
            device="cpu", seed=seed)
        return eng.generate({u: list(p) for u, p in prompts.items()},
                            max_new_tokens=12, decode_chunk=chunk)

    a, b, c = run(5, 1), run(5, 7), run(6, 7)
    assert a == b and a != c
    assert all(0 <= t < 128 for s in a.values() for t in s)
    # the stream of one step: every draw is inside top-k/top-p of its row
    eng = RaggedInferenceEngine(
        tm, RaggedConfig(dtype=torch.float32, temperature=0.8, top_k=20,
                         top_p=0.9, **CFG), device="cpu", seed=5)
    rows = eng.put([0, 1], [prompts[0], prompts[1]])
    logits = torch.from_numpy(rows)
    kept = torch.isfinite(_filter_logits(logits, 0.8, 20, 0.9))
    for _ in range(20):
        toks = eng._next_tokens(logits, 0)
        assert all(kept[i, t] for i, t in enumerate(toks.tolist()))
    assert torch.equal(eng._next_tokens(logits, 3),
                       eng._next_tokens(logits, 3))
