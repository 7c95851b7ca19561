"""The port's native ragged host library (``csrc/ragged_host.cpp``, built
by the host C++ compiler through ``op_builder.load_host``) equals its numpy
path bitwise on numpy-seeded random chunk sets and block lists, and equals
the JAX package's native library (``deepspeed_tpu/ops/ragged_host.py`` over
``csrc/ragged/ds_ragged_host.cpp``) where that one builds. The error paths
(a batch wider than T, a block list longer than max_pages, a failed build)
raise on both paths. Tolerance: none — int32 arrays, exact equality.
"""

import numpy as np
import pytest

import deepspeed_tpu.ops.ragged_host as jrh
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops import ragged_host as rh


def _chunks(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 9))
    lens = rng.integers(0, 40, n)
    chunks = [rng.integers(0, 32000, int(k)).tolist() for k in lens]
    seens = rng.integers(0, 500, n).tolist()
    slots = rng.permutation(16)[:n].tolist()
    T = int(max(1, lens.sum() + rng.integers(0, 16)))
    return chunks, seens, slots, T


def _blocks(seed, max_pages=12):
    rng = np.random.default_rng(seed + 1000)
    n = int(rng.integers(0, 9))
    lists = [rng.integers(0, 4096, int(k)).tolist()
             for k in rng.integers(0, max_pages + 1, n)]
    return lists, rng.permutation(16)[:n].tolist(), 16, max_pages


@pytest.mark.parametrize("seed", range(12))
def test_native_build_batch_equals_numpy_and_jax(seed):
    chunks, seens, slots, T = _chunks(seed)
    before = rh.build_batch.native_launches
    nat = rh.build_batch(chunks, seens, slots, T, native=True)
    ref = rh.build_batch(chunks, seens, slots, T)
    assert rh.build_batch.native_launches == before + 1
    for a, b in zip(nat, ref):
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
    # the JAX package's batch code (native where its toolchain builds it)
    for a, b in zip(nat, jrh.build_batch(chunks, seens, slots, T)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("seed", range(12))
def test_native_fill_tables_equals_numpy_and_jax(seed):
    lists, slots, max_seqs, max_pages = _blocks(seed)
    before = rh.fill_tables.native_launches
    nat = rh.fill_tables(lists, slots, max_seqs, max_pages, native=True)
    ref = rh.fill_tables(lists, slots, max_seqs, max_pages)
    assert rh.fill_tables.native_launches == before + 1
    assert nat.dtype == np.int32 and np.array_equal(nat, ref)
    assert np.array_equal(nat, jrh.fill_tables(lists, slots, max_seqs,
                                               max_pages))


def test_jax_native_library_builds_here():
    # the JAX package's native path exists on this host (so the
    # comparisons above are native against native, not against numpy)
    assert jrh._lib() is not None


@pytest.mark.parametrize("native", [False, True])
def test_error_paths_raise_on_both_paths(native):
    with pytest.raises(ValueError, match="exceed batch width"):
        rh.build_batch([[1, 2, 3], [4, 5]], [0, 0], [0, 1], 4, native=native)
    with pytest.raises(ValueError, match="max_pages"):
        rh.fill_tables([[1, 2, 3]], [0], 2, 2, native=native)
    if native:       # the C loops index by these: checked before the call
        with pytest.raises(ValueError, match="slots"):
            rh.build_batch([[1], [2]], [0, 0], [0], 4, native=True)
        with pytest.raises(ValueError, match="name"):
            rh.fill_tables([[1]], [3], 3, 2, native=True)
        with pytest.raises(ValueError, match="name"):
            rh.fill_tables([[1]], [-1], 3, 2, native=True)
    # empty schedules are legal
    tok, slot, pos, last = rh.build_batch([], [], [], 4, native=native)
    assert (slot == -1).all() and last.shape == (0,)
    assert not rh.fill_tables([], [], 3, 2, native=native).any()


def test_host_library_is_named_by_source_and_a_failed_build_raises(
        tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "ragged_host.cpp").write_bytes(
        (op_builder.CSRC / "ragged_host.cpp").read_bytes())
    a = op_builder.host_digest("ragged_host", src)
    assert a == op_builder.host_digest("ragged_host")
    with open(src / "ragged_host.cpp", "a") as f:
        f.write("// edited\n")
    assert op_builder.host_digest("ragged_host", src) != a
    (src / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(op_builder, "CSRC", src)
    monkeypatch.setattr(op_builder, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="host library build failed"):
        op_builder.load_host("broken")
    assert not list((tmp_path / "build").glob("*.so"))
