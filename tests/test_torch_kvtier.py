"""The KV tier's data half and the prefix hand-off of the PyTorch port
against the JAX package, on the CPU.

``prefix_hash`` and ``export_checksum`` equal the JAX package's; a
``PrefixExport`` stamps the JAX checksum for the same tokens and page
bytes (bf16 pages read through an integer view) and catches corruption
(``CorruptExport``); ``PrefixDirectory`` and ``ColdTier`` behave as the
JAX ones. On the tiny Llama (fp32, JAX weights carried across),
``export_prefix`` -> ``import_prefix`` adopts a prefix so that a prompt
sharing it schedules only its suffix, with logits within 1e-4 of the JAX
engine's, also from a JAX export carried across by
``jax_params.load_prefix_export``; the prefix cache's ``lookup``,
``drop_all`` and eviction hook, the cold-tier spill and re-admission and
``kv_demand`` match the JAX engine's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

from deepspeed_tpu.inference.ragged import (
    RaggedConfig as JaxRaggedConfig,
    RaggedInferenceEngine as JaxRaggedEngine)
from deepspeed_tpu.models import Llama as JaxLlama
from deepspeed_tpu.serving import kvtier as jkv
from deepspeed_tpu_torch.checkpoint.jax_params import (load_jax_params,
                                                       load_prefix_export)
from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                  RaggedInferenceEngine,
                                                  assert_block_balance)
from deepspeed_tpu_torch.models.llama import Llama
from deepspeed_tpu_torch.serving.kvtier import (
    ColdTier, CorruptExport, PrefixDirectory, PrefixExport, export_checksum,
    prefix_hash)

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, vocab_size=128,
            max_seq_len=256)
CFG = dict(token_budget=32, max_seqs=4, kv_block_size=8, n_kv_blocks=64,
           max_context=128, enable_prefix_cache=True)
TOL = dict(rtol=1e-4, atol=1e-4)


def _export(tokens, block=4):
    toks = tuple(tokens)
    return PrefixExport(tokens=toks, n_pages=len(toks) // block,
                        block_size=block, n_layers=1, n_kv_heads=1,
                        head_dim=1, dtype="float32", kv_quant="none")


# -------------------------------------------------------------- wire form
@pytest.mark.parametrize("tokens", [[1, 2, 3], (1, 2, 3), [1, 2], [],
                                    list(range(100, 164))])
def test_prefix_hash_and_checksum_equal_jax(tokens):
    assert prefix_hash(tokens) == jkv.prefix_hash(tokens)
    for payloads in ([], [b"abcd"], [b"abcd", bytes(range(256))]):
        assert export_checksum(tokens, payloads) == \
            jkv.export_checksum(tokens, payloads)
    assert prefix_hash([1, 2, 3]) != prefix_hash([1, 2, 4])


@pytest.mark.parametrize("dtype,kv_quant", [
    (torch.bfloat16, "none"), (torch.float32, "none"), (torch.int8, "int8"),
    (torch.uint8, "int4")])
def test_prefix_export_checksum_equals_jax(dtype, kv_quant):
    """The same tokens and page bytes: the port's tensors and the JAX
    package's numpy arrays (ml_dtypes bfloat16) stamp one checksum."""
    gen = torch.Generator().manual_seed(0)
    shape = (2, 3, 2, 4, 8)
    if dtype.is_floating_point:
        k, v = (torch.randn(shape, generator=gen).to(dtype) for _ in "kv")
    else:
        k, v = (torch.randint(0, 100, shape, generator=gen).to(dtype)
                for _ in "kv")
    scales = None if kv_quant == "none" else tuple(
        torch.rand(shape[:-1], generator=gen) for _ in "kv")

    def np_of(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    kw = dict(tokens=list(range(12)), n_pages=3, block_size=4, n_layers=2,
              n_kv_heads=2, head_dim=8, dtype="bfloat16", kv_quant=kv_quant)
    mine = PrefixExport(pages=(k, v), scales=scales, **kw)
    theirs = jkv.PrefixExport(
        pages=(np_of(k), np_of(v)),
        scales=None if scales is None else tuple(map(np_of, scales)), **kw)
    assert mine.checksum == theirs.checksum and mine.verify()
    assert mine.geometry() == theirs.geometry()
    back = load_prefix_export(theirs)
    assert back.checksum == theirs.checksum and back.verify()
    assert torch.equal(back.pages[0], k)
    k.view(torch.uint8).view(-1)[5] ^= 0x1        # one payload bit
    assert not mine.verify()


def test_token_flip_is_detected_and_corrupt_export_is_a_value_error():
    e = _export(range(1, 9))
    assert e.verify()
    e.tokens = (e.tokens[0] ^ 0x1,) + e.tokens[1:]
    assert not e.verify()
    assert issubclass(CorruptExport, ValueError)


# -------------------------------------------------------------- directory
def test_directory_matches_jax():
    for D in (PrefixDirectory, jkv.PrefixDirectory):
        d = D(staleness_s=5.0)
        d.publish("a", [11, 22], now=0.0)
        d.publish("b", [22], now=3.0)
        assert d.holders(22, now=4.0) == (["a", "b"], False)
        assert d.holders(22, now=6.0) == (["b"], False)
        assert d.holders(22, now=9.0) == ([], True)
        assert d.holders(33, now=0.0) == ([], False)
        assert d.has_fresh(11, now=4.0) and not d.has_fresh(11, now=9.0)
        d.publish("a", [2, 3], now=10.0)            # full replacement
        assert d.entries_for("a") == {2, 3}
        d.invalidate("a", 2)
        d.invalidate("a", 999)
        assert d.entries_for("a") == {3}
        assert d.drop_member("b") == 1 and d.drop_member("b") == 0
        d.publish("c", [], now=11.0)
        assert d.members() == ["a"] and d.size() == 1
        assert d.snapshot() == {"entries": 1, "members": {"a": 1},
                                "publishes": 4, "invalidations": 2}


# -------------------------------------------------------------- cold tier
def test_cold_tier_matches_jax():
    with pytest.raises(ValueError):
        ColdTier(0)
    stats = []
    for C, mk in ((ColdTier, _export),
                  (jkv.ColdTier, lambda t: jkv.PrefixExport(
                      tokens=tuple(t), n_pages=len(tuple(t)) // 4,
                      block_size=4, n_layers=1, n_kv_heads=1, head_dim=1,
                      dtype="float32", kv_quant="none"))):
        cold = C(capacity_pages=4)
        a, b, c = mk(range(0, 8)), mk(range(8, 16)), mk(range(16, 24))
        assert cold.put(a) and cold.put(b)
        assert cold.used_pages == 4 == sum(cold.entry_pages())
        assert cold.get(a.key) is a                 # b is now LRU
        assert cold.put(c)
        assert cold.keys() == [a.key, c.key]
        assert cold.get(b.key) is None
        assert [e.key for e in cold.entries_snapshot()] == cold.keys()
        assert not cold.put(mk(range(20)))          # 5 pages > the tier
        assert cold.contains(a.key) and cold.invalidate(a.key)
        assert not cold.invalidate(a.key) and len(cold) == 1
        st = cold.stats()
        st.pop("chaos_drops", None)     # the JAX tier's injected pressure
        stats.append(st)
        cold.drop_all()
        assert cold.used_pages == 0 and len(cold) == 0
    assert stats[0] == stats[1]


# ----------------------------------------------------------- the engines
@pytest.fixture(scope="module")
def models():
    jm = JaxLlama("tiny", use_flash=False, remat=False, **TINY)
    params = jm.init(jax.random.PRNGKey(5))
    tm = load_jax_params(Llama("tiny", device="cpu", **TINY),
                         jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


def _engine(models, **kw):
    return RaggedInferenceEngine(
        models[2], RaggedConfig(dtype=torch.float32, **{**CFG, **kw}),
        device="cpu")


def _jax_engine(models, **kw):
    jm, params, _ = models
    return JaxRaggedEngine(jm, JaxRaggedConfig(dtype=jnp.float32,
                                               **{**CFG, **kw}),
                           params=params)


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(1, 128, n).tolist()


def test_prefix_cache_lookup_drop_all_and_kv_demand_match_jax(models):
    je, te = _jax_engine(models), _engine(models)
    p = _prompt(1, 27)
    for eng in (je, te):
        eng.generate({1: p}, max_new_tokens=4)      # publishes 3 blocks
    tc, jc = te.prefix_cache, je.prefix_cache
    assert len(tc) == len(jc) == 3
    for toks in (p, p[:16], p[:15], p[:7], [0] * 20):
        tk, tb = tc.lookup(toks)
        jk, jb = jc.lookup(toks)
        assert tk == jk and tb == jb
    assert list(tc._entries) == list(jc._entries)   # same LRU order
    assert te.kv_demand() == je.kv_demand() == 0.0
    te.put([2], [p[:10]])
    je.put([2], [p[:10]])
    assert te.kv_demand() == je.kv_demand() > 0
    evicted = []
    tc.on_evict = lambda key, blocks: evicted.append((len(key), blocks))
    tc.drop_all(te.allocator)
    jc.drop_all(je.allocator)
    assert len(tc) == 0 and [n for n, _ in evicted] == [24, 16, 8]
    assert te.allocator.free_blocks == je.allocator.free_blocks
    assert_block_balance(te)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_export_import_prefix_schedules_only_the_suffix(models, kv_quant):
    """A prefix exported by one port engine (and one exported by the JAX
    engine, carried across) lands in another engine's cache: a prompt
    sharing it prefills only its suffix, logits within 1e-4 of the JAX
    engine that computed the whole prompt."""
    shared = _prompt(2, 24)
    prompt = shared + _prompt(3, 5)
    donor, jdonor = _engine(models, kv_quant=kv_quant), \
        _jax_engine(models, kv_quant=kv_quant)
    for eng in (donor, jdonor):
        eng.generate({1: shared + [7]}, max_new_tokens=2)
    ref = _jax_engine(models, kv_quant=kv_quant,
                      enable_prefix_cache=False).put([9], [prompt])
    for export in (donor.export_prefix(prompt),
                   load_prefix_export(jdonor.export_prefix(prompt))):
        assert export.tokens == tuple(shared) and export.n_pages == 3
        assert export.verify()
        eng = _engine(models, kv_quant=kv_quant)
        assert eng.import_prefix(export) is True
        assert eng.import_prefix(export) is False   # already resident
        assert eng.kvtier_adopt_imports == 1
        assert_block_balance(eng)
        got = eng.put([9], [prompt])
        assert eng.prefix_cache.hits == 1
        assert eng.seqs[9].seen == len(prompt)
        np.testing.assert_allclose(got, ref, **TOL)
        eng.flush([9])
        assert_block_balance(eng)
    assert donor.export_prefix(_prompt(4, 20)) is None


def test_port_export_checksum_equals_jax_checksum_of_its_bytes(models):
    te = _engine(models)
    p = _prompt(5, 17)
    te.generate({1: p}, max_new_tokens=2)
    mine = te.export_prefix(p)
    theirs = jkv.PrefixExport(
        tokens=mine.tokens, n_pages=mine.n_pages, block_size=mine.block_size,
        n_layers=mine.n_layers, n_kv_heads=mine.n_kv_heads,
        head_dim=mine.head_dim, dtype=mine.dtype, kv_quant=mine.kv_quant,
        pages=tuple(t.numpy() for t in mine.pages))
    assert theirs.checksum == mine.checksum
    assert mine.geometry() == (8, 2, 2, 16, "float32", "none")
    assert mine.wire_bytes == mine.logical_bytes == 2 * 2 * 2 * 2 * 8 * 16 * 4


def test_corrupt_or_mismatched_prefix_never_lands(models):
    te = _engine(models)
    p = _prompt(6, 17)
    te.generate({1: p}, max_new_tokens=2)
    export = te.export_prefix(p)
    export.pages[0].view(-1)[3] += 1.0              # corrupted in transit
    eng = _engine(models)
    with pytest.raises(CorruptExport):
        eng.import_prefix(export)
    other = _engine(models, kv_quant="int8")
    with pytest.raises(ValueError, match="geometry"):
        other.import_prefix(te.export_prefix(p))
    for e in (eng, other):
        assert len(e.prefix_cache) == 0
        assert_block_balance(e, expect_free=CFG["n_kv_blocks"])
    with pytest.raises(ValueError, match="prefix cache disabled"):
        _engine(models, enable_prefix_cache=False).import_prefix(
            te.export_prefix(p))


def test_cold_tier_spills_and_readmits_like_jax(models):
    """A tiny pool: the second prompt evicts the first one's prefix into
    the cold tier (directory invalidated first), and the first prompt's
    return re-admits it; streams equal the JAX engine's."""
    shared = _prompt(7, 16)
    out = []
    for eng in (_engine(models, n_kv_blocks=8),
                _jax_engine(models, n_kv_blocks=8)):
        cold = ColdTier(16) if isinstance(eng, RaggedInferenceEngine) \
            else jkv.ColdTier(16)
        dropped = []
        eng.enable_kv_tier(member="r0", cold_tier=cold,
                           on_invalidate=dropped.append)
        a = eng.generate({1: shared + [3, 4]}, max_new_tokens=3)
        hashes = eng.prefix_residency_hashes()
        b = eng.generate({2: _prompt(8, 50)}, max_new_tokens=3)
        c = eng.generate({3: shared + [5, 6]}, max_new_tokens=3)
        stats = cold.stats()
        stats.pop("chaos_drops", None)
        out.append((a, b, c, len(hashes), len(dropped) > 0,
                    eng.kvtier_cold_spills, eng.kvtier_cold_readmits, stats))
    assert out[0] == out[1]
    assert out[0][5] > 0 and out[0][6] == 1
