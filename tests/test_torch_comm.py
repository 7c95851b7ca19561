"""The port's compressed-collective facade on 4 gloo ranks against the JAX
facade in ``shard_map`` over a 4-device virtual mesh, on the CPU.

The ranks (``tests/torch_ranks.py``, one process each, no JAX) start once
for the module and run every facade op on their slice of the inputs made
here with numpy; the JAX side runs here meanwhile. Covered:
``quantized_all_gather`` (int8/int4, dims 0 and 1, dense),
``quantized_chunk_exchange`` (mean and sum), ``hierarchical_pmean``
(quantized, and the dense fallback with its counter), ``chunked_all_reduce``
(quantized, dense chunked, ragged), ``ring_permute``, and the dtypes that
gloo carries (int8, uint8, fp32) on all_gather, all_to_all, isend/irecv
and all_reduce.

Tolerances. Under ``jit`` XLA turns ``absmax / qmax`` into a multiply by
``fp32(1/qmax)``, so a JAX scale can sit one ulp from the port's IEEE
quotient (ROADMAP.md, Queue C) and a value at a rounding boundary then
lands one level away. So a quantized result may differ from JAX's by one
level of its block's scale per quantization it went through (a gather:
one; a chunk exchange: the local one on each rank, then the re-quantized
chunk), and at most 5 % of the elements may differ by more than 1e-6
relative (a scale one ulp apart moves its whole block by about an ulp). Dense
paths agree within 1e-6 (fp32 summation order of the backend's
all_reduce).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from deepspeed_tpu.comm import compressed as jcc
from deepspeed_tpu.parallel.mesh import Topology, shard_map_compat
from deepspeed_tpu.telemetry import MetricsRegistry, get_registry, set_registry
from deepspeed_tpu_torch.comm import compressed as cc
from torch_ranks import start_ranks

WORLD = 4
BLOCK = 64


def _cases():
    rng = np.random.default_rng(0)
    scale = rng.uniform(0.1, 10.0, size=(WORLD, 1)).astype(np.float32)
    return {
        "ag": rng.normal(size=(WORLD, 8, 32)).astype(np.float32),
        "flat": (rng.normal(size=(WORLD, 1024)) * scale).astype(np.float32),
        "ragged": rng.normal(size=(WORLD, 30)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def setup():
    cases = _cases()
    ranks = start_ranks(WORLD, "facade_job", cases)
    box = {}

    def port():
        if "r" not in box:
            box["r"] = ranks.results()
        return box["r"]

    yield cases, port
    ranks.kill()


def _spmd(fn, *args):
    topo = Topology.build_virtual({"data": WORLD})
    return np.asarray(jax.jit(shard_map_compat(
        lambda *a: fn(*[x[0] for x in a])[None], mesh=topo.mesh,
        axis_names={"data"}, in_specs=tuple(P("data") for _ in args),
        out_specs=P("data"), check_vma=False))(*args))


def _jax_counters(fn):
    old = get_registry()
    reg = set_registry(MetricsRegistry())
    try:
        out = fn()
        return out, {k: v for k, v in reg.snapshot().items()
                     if k.startswith("comm/facade")}
    finally:
        set_registry(old)


def _level(x: np.ndarray, bits: int) -> float:
    """The largest quantization step of ``x``'s blocks."""
    qmax = 2.0 ** (bits - 1) - 1
    return float(np.abs(x.reshape(-1, BLOCK)).max(axis=1).max() / qmax)


def _close_levels(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    diff = np.abs(got - ref)
    assert diff.max() <= tol * 1.0001 + 1e-7, (diff.max(), tol)
    # a scale one ulp apart moves its block's values by about an ulp; a
    # level flip moves one value by a whole step: those stay rare
    flips = diff > 1e-6 * np.abs(ref) + 1e-7
    assert np.mean(flips) <= 0.05, np.mean(flips)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dim", [0, 1])
def test_quantized_all_gather_matches_jax(setup, bits, dim):
    cases, port = setup
    spec = jcc.QuantSpec(bits, BLOCK)
    ref = _spmd(lambda x: jcc.quantized_all_gather(x, "data", dim=dim,
                                                   qspec=spec),
                jnp.asarray(cases["ag"]))
    for r in range(WORLD):
        _close_levels(port()[r][f"ag_{bits}_{dim}"], ref[r],
                      _level(cases["ag"], bits))
    shape = list(cases["ag"].shape[1:])
    shape[dim] *= WORLD
    assert port()[0][f"ag_{bits}_{dim}"].shape == tuple(shape)


def test_dense_all_gather_and_ring_permute_match_jax(setup):
    cases, port = setup
    x = jnp.asarray(cases["ag"])
    ref = _spmd(lambda v: jcc.quantized_all_gather(v, "data", dim=1), x)
    ring = _spmd(lambda v: jcc.ring_permute(v, "data", world=WORLD), x)
    for r in range(WORLD):
        np.testing.assert_array_equal(port()[r]["ag_dense"], ref[r])
        np.testing.assert_array_equal(port()[r]["ring"], ring[r])
        np.testing.assert_array_equal(port()[r]["ring"],
                                      cases["ag"][(r - 1) % WORLD])


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("reduce", ["mean", "sum"])
def test_quantized_chunk_exchange_matches_jax(setup, bits, reduce):
    cases, port = setup
    spec = jcc.QuantSpec(bits, BLOCK)

    def fn(x):
        from deepspeed_tpu.ops.quantizer import pack_int4, quantize_blockwise

        q, s, _ = quantize_blockwise(x, bits=bits, block=BLOCK,
                                     manual_sharding=True)
        payload = pack_int4(q) if bits == 4 else q
        return jcc.quantized_chunk_exchange(
            payload, s, n=x.size, axis_name="data", world=WORLD, qspec=spec,
            op_prefix="t", reduce=reduce)

    ref = _spmd(fn, jnp.asarray(cases["flat"]))
    local = _level(cases["flat"], bits)
    out = ref[0].reshape(-1)
    tol = local * (WORLD if reduce == "sum" else 1) + _level(out, bits)
    for r in range(WORLD):
        _close_levels(port()[r][f"xchg_{bits}_{reduce}"], ref[r], tol)
        np.testing.assert_array_equal(port()[r][f"xchg_{bits}_{reduce}"],
                                      port()[0][f"xchg_{bits}_{reduce}"])
    exact = cases["flat"].sum(0) / (WORLD if reduce == "mean" else 1)
    assert np.abs(port()[0][f"xchg_{bits}_{reduce}"] - exact).max() <= tol


def test_hierarchical_pmean_matches_jax_with_its_fallback_counter(setup):
    cases, port = setup
    spec = jcc.QuantSpec(8, BLOCK)

    def run(name):
        return _spmd(lambda x: jcc.hierarchical_pmean(
            x, outer_axis="data", outer_world=WORLD, qspec=spec),
            jnp.asarray(cases[name]))

    ref_q, _ = _jax_counters(lambda: run("flat"))
    ref_d, counters = _jax_counters(lambda: run("ragged"))
    tol = _level(cases["flat"], 8) + _level(ref_q[0], 8)
    for r in range(WORLD):
        _close_levels(port()[r]["hier_q"], ref_q[r], tol)
        np.testing.assert_allclose(port()[r]["hier_dense"], ref_d[r],
                                   rtol=1e-6, atol=1e-6)
        assert port()[r]["hier_counters"] == counters
    assert counters["comm/facade/fallbacks/qgz_inter_reduce_dense"] == 1


def test_chunked_all_reduce_matches_jax(setup):
    cases, port = setup
    spec = jcc.QuantSpec(8, BLOCK)
    flat = jnp.asarray(cases["flat"])
    ref_q = _spmd(lambda x: jcc.chunked_all_reduce(x, "data", qspec=spec),
                  flat)
    ref_d = _spmd(lambda x: jcc.chunked_all_reduce(x, "data"), flat)
    ref_r, counters = _jax_counters(lambda: _spmd(
        lambda x: jcc.chunked_all_reduce(x, "data", qspec=spec),
        jnp.asarray(cases["ragged"])))
    tol = WORLD * _level(cases["flat"], 8) + _level(ref_q[0], 8)
    for r in range(WORLD):
        _close_levels(port()[r]["car_q"], ref_q[r], tol)
        np.testing.assert_allclose(port()[r]["car_dense"], ref_d[r],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(port()[r]["car_ragged"], ref_r[r],
                                   rtol=1e-6, atol=1e-6)
    assert port()[0]["car_counters"][
        "comm/facade/fallbacks/decode_mlp_all_reduce"] == counters[
        "comm/facade/fallbacks/decode_mlp_all_reduce"] == 1


def test_wire_ledger_matches_jax(setup):
    """The bytes-on-wire ledger books the same rows as the JAX facade's
    (one quantized int4 gather, one quantized chunked all-reduce): op
    names, calls, logical and wire bytes."""
    from deepspeed_tpu.comm.comm import (configure_comms_logger,
                                         get_comms_logger)

    cases, port = setup
    logger = get_comms_logger()
    logger.reset()
    configure_comms_logger(True)
    try:
        _spmd(lambda x: jcc.quantized_all_gather(
            x, "data", dim=1, qspec=jcc.QuantSpec(4, BLOCK)),
            jnp.asarray(cases["ag"]))
        _spmd(lambda x: jcc.chunked_all_reduce(
            x, "data", qspec=jcc.QuantSpec(8, BLOCK)),
            jnp.asarray(cases["flat"]))
        ref = logger.snapshot_totals()
    finally:
        configure_comms_logger(False)
        logger.reset()
    keys = ("count", "bytes", "wire_bytes")
    got = port()[0]["ledger"]
    assert {op: {k: v[k] for k in keys} for op, v in got.items()} == \
        {op: {k: v[k] for k in keys} for op, v in ref.items()}
    assert got["qwz_all_gather"]["wire_bytes"] < \
        got["qwz_all_gather"]["bytes"]


@pytest.mark.parametrize("dtype", ["int8", "uint8", "float32"])
def test_gloo_carries_the_wire_dtypes(setup, dtype):
    _, port = setup
    base = np.arange(8).astype(dtype)
    for r in range(WORLD):
        got = port()[r]["dtypes"][dtype]
        for src, part in enumerate(got["gather"]):
            assert part.dtype == np.dtype(dtype)
            np.testing.assert_array_equal(part, base + src)
        want = np.stack([(base + src).reshape(WORLD, -1)[r]
                         for src in range(WORLD)])
        np.testing.assert_array_equal(got["a2a"], want)
        np.testing.assert_array_equal(got["ring"], base + (r - 1) % WORLD)
        if dtype == "float32":
            np.testing.assert_array_equal(got["sum"],
                                          WORLD * base + sum(range(WORLD)))


def test_quant_spec_matches_jax():
    for bits, block in ((8, 256), (4, 64)):
        a, b = cc.QuantSpec(bits, block), jcc.QuantSpec(bits, block)
        assert a.rel_error_bound == b.rel_error_bound
        for n, w in ((1024, 4), (4096, 4), (300, 1), (256, 1), (0, 1)):
            assert a.divides(n, w) == b.divides(n, w)
            assert a.wire_nbytes(n + 1) == b.wire_nbytes(n + 1)
    with pytest.raises(ValueError):
        cc.QuantSpec(3, 256)
    with pytest.raises(ValueError):
        cc.QuantSpec(8, 255)


def test_init_distributed_refuses_nccl_on_a_shared_device(monkeypatch):
    """NCCL refuses two ranks on one device: the port raises a named error
    before joining a group, and nothing falls back to gloo on its own."""
    from deepspeed_tpu_torch.comm import comm

    with pytest.raises(ValueError, match="dist_backend"):
        comm.init_distributed("mpi", world_size=1, rank=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="gloo"):
        comm.init_distributed("nccl", world_size=2, rank=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    with pytest.raises(comm.SharedDeviceError, match="gloo"):
        comm.init_distributed(world_size=2, rank=0)
    assert not comm.is_initialized()
