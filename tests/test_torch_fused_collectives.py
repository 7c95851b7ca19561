"""The fused compute-collective path of the port against the JAX package,
on the CPU (kernel rows 7-9 of PERF.md's table).

* Plain versions of ``dequant_matmul``, ``matmul_pallas`` and
  ``matmul_quantize`` against the JAX Pallas kernels in interpret mode:
  fp32 and bf16, bits 8 and 4, ``trans_a`` both ways, m = 1, and a row
  length that the block does not divide. Products: within 1e-5 relative
  (fp32 summation order; bf16 operands multiply exactly in fp32).
  Quantized products: on integer-valued operands (exact products and
  sums) the payloads are bitwise equal wherever the scales are, and the
  scales within one ulp (XLA's reciprocal multiply, ROADMAP.md Queue C);
  on random operands each entry that lands one level away is named, and
  none lands further.
* The fused backend against the reference backend on 4 gloo ranks
  (``tests/torch_ranks.py``), all three entry points, unquantized and
  int8/int4: bitwise on integer-valued operands whose blocks have
  power-of-two scales; on random operands ``all_gather_matmul`` within
  1e-6 relative (tile-wise vs whole products) and the reduce paths
  bitwise (the same plain product on the CPU). The fusion counters, and
  the metered fallbacks: a dim-0 gather, mixed dtypes, an indivisible
  shard, a size below ``min_quant_size``.
* The engine: ``SequentialBlockModel((64, 256, 512, 64))`` on 4 ranks, 3
  ``train_batch`` steps, compressed (w8/g4) and dense, on the port's
  ``"pallas"`` and ``"xla"`` backends and the JAX engine on a 4-device
  virtual mesh, from the same carried weights (see the test for the
  tolerances); serial and staged issue bitwise equal.
* The dispatch predicate ``wgmma_path`` (which bf16/fp16 products the
  Hopper TMA + wgmma kernel takes): the ZeRO-3 path's shapes, unaligned
  shapes, fp32, payload widths TMA cannot stride, blocks of partial
  pieces, and a base pointer one element off.
* The dispatch predicate ``wgmma_quantize_path`` (which ``matmul_quantize``
  products the Hopper kernel takes): the ZeRO-3 path's shape with
  ``trans_a`` on and off, the blocks it takes (256, 128, 64, 8) and those
  it refuses (96, 2, 512, one that does not divide n), fp32, unaligned
  bases, and rows that are no whole 16-byte strides.
* Config, weight carry, and the ``gpu``-marked kernel checks (skipped
  without a card): the mma.sync kernels, and the Hopper kernel against
  the plain versions (rows 7/8: bf16/fp16, int8/int4, blocks 256/64/96,
  ragged m, n and k, bitwise on integer-valued operands, across two runs
  and into a column slice; row 9: bf16/fp16, ``trans_a`` both ways,
  int8/int4, blocks 256/128/64/32, ragged rows, n and k, bitwise on
  integer-valued operands and twice, on random ones within the levels
  rule), each case counted on ``.wgmma_launches``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu as jdst
from deepspeed_tpu.ops.pallas import fused_collectives as jfc
from deepspeed_tpu.parallel.mesh import Topology
from deepspeed_tpu.parallel.zero import SequentialBlockModel as JaxBlockModel
from deepspeed_tpu_torch.checkpoint.jax_params import (export_block_params,
                                                       load_block_params)
from deepspeed_tpu_torch.comm import backends as tb
from deepspeed_tpu_torch.config import Config, ConfigError
from deepspeed_tpu_torch.ops import fused_collectives as fc
from deepspeed_tpu_torch.ops.quantizer import unpack_int4
from deepspeed_tpu_torch.parallel.mesh import Topology as TorchTopology
from deepspeed_tpu_torch.parallel.zero import SequentialBlockModel
from torch_ranks import start_ranks

WORLD = 4
DIMS = (64, 256, 512, 64)


def _pow2_levels(rng, shape, bits, block=64):
    """Values whose blocks of ``block`` quantize exactly: integer levels in
    [-qmax, qmax], each block holding a ±qmax, times a power of two."""
    qmax = 2 ** (bits - 1) - 1
    q = rng.integers(-qmax, qmax + 1, size=shape).reshape(-1, block)
    q[:, 0] = qmax * rng.choice([-1, 1], size=q.shape[0])
    e = rng.integers(-2, 2, size=(q.shape[0], 1)).astype(np.float64)
    return (q * 2.0 ** e).reshape(shape).astype(np.float32)


def _ints(rng, shape, lim=3):
    return rng.integers(-lim, lim + 1, size=shape).astype(np.float32)


def _entry_cases():
    rng = np.random.default_rng(5)
    cases = {}
    for tag, dtype in (("rand", "float32"), ("rand_bf16", "bfloat16")):
        cases[tag] = {
            "dtype": dtype, "bits": (None, 8, 4),
            "h": rng.normal(size=(16, 32)).astype(np.float32),
            "w": rng.normal(size=(WORLD, 32, 64)).astype(np.float32),
            "hr": rng.normal(size=(WORLD, 16, 32)).astype(np.float32),
            "g": rng.normal(size=(WORLD, 16, 64)).astype(np.float32),
            "x": rng.normal(size=(WORLD, 8, 32)).astype(np.float32),
            "wr": rng.normal(size=(WORLD, 32, 128)).astype(np.float32)}
    for bits in (8, 4):
        cases[f"int{bits}"] = {
            "dtype": "float32", "bits": (None, bits),
            "h": _ints(rng, (16, 32)),
            "w": _pow2_levels(rng, (WORLD, 32, 64), bits),
            "hr": _ints(rng, (WORLD, 16, 32)), "g": _ints(rng, (WORLD, 16, 64)),
            "x": _ints(rng, (WORLD, 8, 32)), "wr": _ints(rng, (WORLD, 32, 128))}
    return {"entry": cases,
            "dim0_h": rng.normal(size=(16, WORLD * 32)).astype(np.float32)}


def _engine_inputs():
    params = JaxBlockModel(DIMS).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {"x": rng.normal(size=(32, DIMS[0])).astype(np.float32),
             "y": rng.normal(size=(32, DIMS[-1])).astype(np.float32)}
    return jax.tree_util.tree_map(np.asarray, params), batch


RUNS = [("pallas_c", True, "pallas", "staged", False),
        ("xla_c", True, "xla", "staged", False),
        ("pallas_c_serial", True, "pallas", "serial", False),
        ("pallas_c_err", True, "pallas", "staged", True),
        ("pallas_d", False, "pallas", "staged", False),
        ("xla_d", False, "xla", "staged", False)]


@pytest.fixture(scope="module")
def ranks():
    entry = _entry_cases()
    init_np, batch = _engine_inputs()
    procs = {"backend": start_ranks(WORLD, "backend_job", entry),
             "engine": start_ranks(WORLD, "engine_job", init_np, batch, DIMS,
                                   RUNS)}
    box = {}

    def results(name):
        if name not in box:
            box[name] = procs[name].results()
        return box[name]

    yield entry, init_np, batch, results
    for p in procs.values():
        p.kill()


# ------------------------------------------ plain versions vs JAX kernels

def _jax_dtype(name):
    return {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[name]


def _torch_dtype(name):
    return getattr(torch, name)


def _quantized_weight(rng, k, b, bits, block=64):
    w = rng.normal(size=(k, b)).astype(np.float32)
    q, s = fc.quantize_blockwise_reference(torch.from_numpy(w), bits, block)
    payload = fc.pack_int4(q) if bits == 4 else q.reshape(-1)
    return payload.numpy(), s.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [1, 13, 16])
def test_dequant_matmul_plain_matches_pallas(dtype, bits, m):
    rng = np.random.default_rng(m * 10 + bits)
    k, b = 32, 48
    payload, s = _quantized_weight(rng, k, b, bits)
    h = rng.normal(size=(m, k)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda hh, p, ss: jfc.dequant_matmul(
        hh, p, ss, bits=bits, block=64, b=b, w_dtype=_jax_dtype(dtype),
        interpret=True))(jnp.asarray(h, _jax_dtype(dtype)),
                         jnp.asarray(payload), jnp.asarray(s)))
    got = fc.dequant_matmul(torch.from_numpy(h).to(_torch_dtype(dtype)),
                            torch.from_numpy(payload), torch.from_numpy(s),
                            bits=bits, block=64, b=b,
                            w_dtype=_torch_dtype(dtype)).numpy()
    assert got.shape == (m, b) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 24])
def test_matmul_plain_matches_pallas(dtype, m):
    rng = np.random.default_rng(m)
    a = rng.normal(size=(m, 32)).astype(np.float32)
    b = rng.normal(size=(32, 40)).astype(np.float32)
    jd, td = _jax_dtype(dtype), _torch_dtype(dtype)
    ref = np.asarray(jax.jit(lambda x, y: jfc.matmul_pallas(
        x, y, interpret=True))(jnp.asarray(a, jd), jnp.asarray(b, jd)))
    got = fc.matmul_pallas(torch.from_numpy(a).to(td),
                           torch.from_numpy(b).to(td)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def _levels(payload, bits):
    p = torch.from_numpy(np.array(payload))
    return (unpack_int4(p) if bits == 4 else p.reshape(-1)).numpy() \
        .astype(np.int32)


# (rows, kc, n, trans_a): n % 64 != 0 in the second; m = 1 in the third
QUANT_SHAPES = [(32, 24, 64, True), (32, 24, 96, False), (1, 24, 128, False),
                (16, 40, 64, False)]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", QUANT_SHAPES)
@pytest.mark.parametrize("integer", [True, False])
def test_matmul_quantize_plain_matches_pallas(bits, shape, integer):
    rows, kc, n, trans_a = shape
    rng = np.random.default_rng(rows + kc + n + bits)
    mk = (lambda sh: _ints(rng, sh)) if integer else \
        (lambda sh: rng.normal(size=sh).astype(np.float32))
    a = mk((kc, rows) if trans_a else (rows, kc))
    b = mk((kc, n))
    p_ref, s_ref = jax.jit(lambda x, y: jfc.matmul_quantize(
        x, y, bits=bits, block=64, trans_a=trans_a, interpret=True))(
        jnp.asarray(a), jnp.asarray(b))
    p_got, s_got = fc.matmul_quantize(torch.from_numpy(a),
                                      torch.from_numpy(b), bits=bits,
                                      block=64, trans_a=trans_a)
    s_ref, s_got = np.asarray(s_ref), s_got.numpy()
    np.testing.assert_array_max_ulp(s_got, s_ref, maxulp=1)
    l_ref, l_got = _levels(p_ref, bits), _levels(p_got, bits)
    assert l_got.shape == l_ref.shape == (rows * n,)
    same_scale = np.repeat(s_got == s_ref, 64)
    moved = np.nonzero(l_got != l_ref)[0]
    assert np.abs(l_got - l_ref).max(initial=0) <= 1, moved
    if integer:
        np.testing.assert_array_equal(l_got[same_scale], l_ref[same_scale])
    else:
        # named, not tolerated away: random products sit on a level
        # boundary now and then
        assert len(moved) <= max(1, l_got.size // 100), \
            f"entries one level apart: {moved.tolist()}"


# ------------------------------------------- fused vs reference backend

@pytest.mark.parametrize("tag", ["rand", "rand_bf16", "int8", "int4"])
@pytest.mark.parametrize("entry", ["ag", "rs", "ar"])
def test_fused_backend_matches_reference(ranks, tag, entry):
    cases, _, _, results = ranks
    res = results("backend")
    for q in cases["entry"][tag]["bits"]:
        for r in range(WORLD):
            got = res[r][f"{entry}_{tag}_{q}_fused"]
            ref = res[r][f"{entry}_{tag}_{q}_ref"]
            if tag.startswith("int") or entry != "ag":
                np.testing.assert_array_equal(got, ref)
            else:
                np.testing.assert_allclose(got, ref, rtol=1e-6,
                                           atol=1e-6 * np.abs(ref).max())
            # every rank ends with the same result
            np.testing.assert_array_equal(got,
                                          res[0][f"{entry}_{tag}_{q}_fused"])
        fused = res[0][f"counters_{tag}_{q}_fused"]
        assert fused.get("comm/facade/fused", 0) > 0
        assert res[0][f"counters_{tag}_{q}_ref"].get(
            "comm/facade/fused", 0) == 0


def test_fused_backend_reads_the_exact_product(ranks):
    """Integer-valued all_gather_matmul against numpy's exact product."""
    cases, _, _, results = ranks
    res = results("backend")
    for bits in (8, 4):
        c = cases["entry"][f"int{bits}"]
        w_full = np.concatenate(list(c["w"]), axis=1)
        np.testing.assert_array_equal(res[0][f"ag_int{bits}_{bits}_fused"],
                                      c["h"] @ w_full)


@pytest.mark.parametrize("case,op", [
    ("dim0", "qwz_all_gather"), ("mixed", "qwz_all_gather"),
    ("indivisible", "qwz_all_gather"), ("small", "qgz_inter_reduce_dense")])
def test_fallbacks_are_metered(ranks, case, op):
    *_, results = ranks
    counters = results("backend")[0]["fallbacks"][case]
    assert counters.get(f"comm/facade/fallbacks/{op}", 0) >= 1
    assert counters.get("comm/facade/fused", 0) == 0


# ------------------------------------------------------------- engine

def _jax_engine(enabled):
    params, batch = _engine_inputs()
    engine, *_ = jdst.initialize(
        model=JaxBlockModel(DIMS), config={
            "train_batch_size": 32,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-2}},
            "zero_optimization": {"stage": 3,
                                  "stage3_param_persistence_threshold": 0},
            "comm_compression": {"enabled": enabled, "weight_bits": 8,
                                 "grad_bits": 4, "kernel_backend": "xla"},
            "steps_per_print": 1000},
        topology=Topology.build_virtual({"data": WORLD}),
        rng=jax.random.PRNGKey(0))
    losses = [float(engine.train_batch(batch)["loss"]) for _ in range(3)]
    return losses, jax.tree_util.tree_map(np.asarray, engine.params)


def _param_gaps(got, ref, atol):
    """{leaf: flat indices where |got - ref| > atol}, and the largest gap."""
    out, worst = {}, 0.0
    for blk, leaves in ref.items():
        for leaf, r in leaves.items():
            d = np.abs(got[blk][leaf] - r)
            worst = max(worst, float(d.max()))
            idx = np.nonzero(d.reshape(-1) > atol)[0]
            if idx.size:
                out[f"{blk}.{leaf}"] = idx.tolist()
    return out, worst


@pytest.mark.parametrize("compressed", [True, False])
def test_engine_matches_jax(ranks, compressed):
    """Losses within 1e-6 relative (dense) and weights within 1e-5 of the
    JAX engine (whose own fused-vs-XLA gap is 1.0e-7), except the weights
    that are counted and named here:
    * dense: where a gradient element is at Adam's eps scale, the fp32
      summation order decides its update (up to 2 lr per step, ROADMAP.md
      Queue C): at most 1 in 10^4 weights;
    * compressed: the gradient also goes through int4, and an element at a
      level boundary lands one level away in one package, which Adam turns
      into up to 2 lr per step: at most 1 in 200 weights; the losses then
      agree within 1e-4 relative."""
    ref_losses, ref_params = _jax_engine(compressed)
    *_, results = ranks
    res = results("engine")
    tag = "c" if compressed else "d"
    for backend in ("pallas", "xla"):
        run = res[0][f"{backend}_{tag}"]
        for r in range(WORLD):
            assert res[r][f"{backend}_{tag}"]["losses"] == run["losses"]
        np.testing.assert_allclose(run["losses"], ref_losses,
                                   rtol=1e-4 if compressed else 1e-6)
        gaps, worst = _param_gaps(run["params"], ref_params, 1e-5)
        n_gaps = sum(len(v) for v in gaps.values())
        total = sum(v.size for leaves in ref_params.values()
                    for v in leaves.values())
        assert n_gaps <= total // (200 if compressed else 10_000), gaps
        assert worst <= 3 * 2 * 1e-2 + 1e-5, (gaps, worst)
        if backend == "xla":
            assert run["counters"].get("comm/facade/fused", 0) == 0
    fused = res[0][f"pallas_{tag}"]["counters"]
    assert fused["comm/facade/fused"] > 0
    if compressed:
        assert fused["comm/facade/fallbacks"] > 0


def test_engine_fused_matches_reference_and_serial_matches_staged(ranks):
    """The port's fused engine against its reference-backend engine within
    the tolerances above (on the CPU both run the same plain products, so
    they agree bitwise here), and serial issue bitwise equal to staged."""
    *_, results = ranks
    res = results("engine")[0]
    for tag in ("c", "d"):
        assert res[f"pallas_{tag}"]["losses"] == res[f"xla_{tag}"]["losses"]
    a, b = res["pallas_c"], res["pallas_c_serial"]
    assert a["losses"] == b["losses"] and a["norms"] == b["norms"]
    # error_stats reads the quantization error and changes nothing else;
    # it stays under the int4 bound (0.5 / 7 of a tensor's absmax)
    e = res["pallas_c_err"]
    assert e["losses"] == a["losses"] and not a["errs"]
    assert len(e["errs"]) == 3 and all(0 < x <= 0.5 / 7 for x in e["errs"])
    for blk, leaves in a["params"].items():
        for leaf, v in leaves.items():
            np.testing.assert_array_equal(v, b["params"][blk][leaf])


# ------------------------------------------------------- config, carry

def test_config_accepts_stage3_and_refuses_later_slices():
    cfg = Config.from_dict({
        "train_batch_size": 8,
        "zero_optimization": {"stage": 3,
                              "stage3_param_persistence_threshold": 0,
                              "zero_quantized_weights": True},
        "comm_compression": {"enabled": True, "grad_bits": 4,
                             "kernel_backend": "pallas"},
        "mesh": {"data": 1}})
    assert cfg.zero.stage == 3 and cfg.zero.zero_quantized_weights
    assert cfg.comm_compression.grad_bits == 4
    assert cfg.comm_compression.resolve_enabled(1)
    assert not Config.from_dict({}).comm_compression.resolve_enabled(8)
    for stage in (1, 2):
        assert Config.from_dict({"train_batch_size": 8, "zero_optimization":
                                 {"stage": stage}}).zero.stage == stage
    assert Config.from_dict({}).comm_compression.resolve_enabled(16)
    for block, match in (
            ({"zero_optimization": {"stage": 1, "mics_shard_size": 2}},
             "mics"),
            ({"zero_optimization": {"stage": 3,
                                    "zero_hpz_partition_size": 2}}, "hpz"),
            ({"zero_optimization": {"stage": 3, "mics_shard_size": 2}},
             "mics"),
            ({"mesh": {"model": 2}, "zero_optimization": {"stage": 3}},
             "mesh.model"),
            ({"comm_compression": {"kernel_backend": "cuda"}},
             "kernel_backend"),
            ({"comm_compression": {"overlap": "eager"}}, "overlap")):
        with pytest.raises(ConfigError, match=match):
            Config.from_dict({"train_batch_size": 8, **block})
    # ZeRO offload is ported: its blocks parse
    for zero, key, dev in (
            ({"stage": 2, "offload_optimizer": {"device": "cpu"}},
             "offload_optimizer", "cpu"),
            ({"stage": 3, "offload_param": {"device": "cpu"}},
             "offload_param", "cpu"),
            ({"stage": 3, "offload_optimizer": {"device": "nvme"}},
             "offload_optimizer", "nvme")):
        cfg = Config.from_dict({"train_batch_size": 8,
                                "zero_optimization": zero})
        assert getattr(cfg.zero, key).device == dev
    with pytest.raises(ConfigError, match="world size"):
        TorchTopology.build({"data": 2})
    with pytest.raises(ValueError, match="kernel backend"):
        tb.resolve_backend("cuda")
    assert tb.resolve_backend("auto", "cpu").name == "xla"
    assert tb.resolve_backend("auto", "cuda").name == "pallas"


def test_stage3_needs_zero3_blocks_and_the_models_loss():
    """The staged schedule needs a model with ``zero3_blocks`` trained on
    its own loss with overlap on; a custom ``loss_fn``, ``overlap="off"``
    or a model without ``zero3_blocks`` trains at stage 3 all the same,
    off the schedule, as the JAX engine warns and proceeds on its facade
    path (``_staged_mode`` None there). On one rank that path is the
    whole-parameter step; tests/test_torch_zero.py runs it over ranks."""
    from deepspeed_tpu_torch import initialize

    cfg = {"train_batch_size": 4, "zero_optimization": {"stage": 3},
           "optimizer": {"type": "adamw", "params": {"lr": 1e-2}}}
    rng = np.random.default_rng(4)
    batch = {"x": rng.normal(size=(4, 8)).astype(np.float32),
             "y": rng.normal(size=(4, 8)).astype(np.float32)}

    class NoBlocks(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.full((8, 8), 0.1))

        def loss(self, batch, params=None, generator=None):
            return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)

    model = SequentialBlockModel((8, 16, 8), device="cpu")
    runs = {
        "custom_loss": dict(loss_fn=lambda p, b: model.loss(b, params=p),
                            params=dict(model.named_parameters()),
                            model=model, config=cfg),
        "overlap_off": dict(model=SequentialBlockModel((8, 16, 8),
                                                       device="cpu"),
                            config={**cfg, "comm_compression": {
                                "overlap": "off"}}),
        "no_blocks": dict(model=NoBlocks(), config=cfg),
        "staged": dict(model=SequentialBlockModel((8, 16, 8), device="cpu"),
                       config=cfg)}
    for name, kw in runs.items():
        eng, *_ = initialize(device="cpu", **kw)
        assert eng._route == ("staged" if name == "staged" else "whole"), \
            name
        losses = [float(eng.train_batch(batch)["loss"]) for _ in range(3)]
        assert losses[2] < losses[0], name
    # the JAX engine takes the same decisions, on a 2-device data mesh
    jm = JaxBlockModel((8, 16, 8))
    jp = jm.init(jax.random.PRNGKey(0))
    for name, loss_fn, overlap, want in (
            ("custom_loss", lambda p, b, r: jm.loss(p, b, r), "staged", None),
            ("overlap_off", None, "off", None),
            ("staged", None, "staged", "staged")):
        jeng, *_ = jdst.initialize(
            model=jm, params=jp, loss_fn=loss_fn,
            config={**cfg, "comm_compression": {"overlap": overlap}},
            topology=Topology.build_virtual({"data": 2}))
        assert jeng._staged_mode == want, name


@pytest.mark.parametrize("gas", [1, 2])
def test_staged_schedule_on_one_rank_matches_the_plain_engine(gas):
    """World 1: the staged block schedule (gathers and reduces fall back
    to no-ops) against the single-device engine's one autograd pass, GAS 1
    and 2: losses within 1e-6 relative, weights within 1e-6."""
    from deepspeed_tpu_torch import initialize

    rng = np.random.default_rng(9)
    batch = {"x": rng.normal(size=(8, 16)).astype(np.float32),
             "y": rng.normal(size=(8, 8)).astype(np.float32)}
    out = {}
    for stage in (0, 3):
        eng, *_ = initialize(
            model=SequentialBlockModel((16, 32, 24, 8), seed=2, device="cpu"),
            config={"train_batch_size": 8, "gradient_accumulation_steps": gas,
                    "gradient_clipping": 1.0,
                    "optimizer": {"type": "adamw", "params": {"lr": 1e-2}},
                    "zero_optimization": {"stage": stage}},
            device="cpu")
        losses = [float(eng.train_batch(batch)["loss"]) for _ in range(3)]
        out[stage] = (losses, eng.full_params())
    np.testing.assert_allclose(out[3][0], out[0][0], rtol=1e-6)
    for name, w in out[0][1].items():
        np.testing.assert_allclose(out[3][1][name].detach().numpy(),
                                   w.detach().numpy(), atol=1e-6)


def test_block_weight_carry_round_trips():
    params = jax.tree_util.tree_map(
        np.asarray, JaxBlockModel(DIMS).init(jax.random.PRNGKey(3)))
    model = load_block_params(SequentialBlockModel(DIMS, device="cpu"),
                              params)
    back = export_block_params(model)
    assert back.keys() == params.keys()
    for blk, leaves in params.items():
        for leaf, v in leaves.items():
            np.testing.assert_array_equal(back[blk][leaf], v)
    # and the other way: the port's seeded weights into a JAX loss
    own = export_block_params(SequentialBlockModel(DIMS, seed=4,
                                                   device="cpu"))
    rng = np.random.default_rng(1)
    batch = {"x": rng.normal(size=(4, DIMS[0])).astype(np.float32),
             "y": rng.normal(size=(4, DIMS[-1])).astype(np.float32)}
    ref = float(JaxBlockModel(DIMS).loss(
        jax.tree_util.tree_map(jnp.asarray, own),
        jax.tree_util.tree_map(jnp.asarray, batch)))
    m = load_block_params(SequentialBlockModel(DIMS, device="cpu"), own)
    with torch.no_grad():
        got = float(m.loss({k: torch.from_numpy(v)
                            for k, v in batch.items()}))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    bad = dict(params)
    bad.pop("block_0")
    with pytest.raises(ValueError, match="missing"):
        load_block_params(SequentialBlockModel(DIMS, device="cpu"), bad)


# ------------------------------------------ the Hopper kernel's dispatch

# h [2048, 4096] bf16 times a [4096, 5504] shard: the ZeRO-3 path's tile
PATH_M, PATH_K, PATH_N = 2048, 4096, 5504


def _addr(dtype, offset=0):
    """A CPU base address of ``dtype``, ``offset`` elements past an
    allocation's start (the allocator aligns starts to 64 bytes)."""
    return torch.empty(64, dtype=dtype)[offset:].data_ptr()


@pytest.mark.parametrize("case,want", [
    # the path's shapes: row 8 and row 7 (int8 / int4, block 256)
    (dict(dtype=torch.bfloat16), True),
    (dict(dtype=torch.float16), True),
    (dict(dtype=torch.bfloat16, bits=8, block=256), True),
    (dict(dtype=torch.bfloat16, bits=4, block=256), True),
    (dict(dtype=torch.float16, bits=8, block=96), True),
    (dict(dtype=torch.bfloat16, m=1, k=520, n=320, bits=8, block=64), True),
    # fp32 keeps the FMA kernel
    (dict(dtype=torch.float32), False),
    (dict(dtype=torch.float32, bits=8, block=256), False),
    # rows that are not whole 16-byte TMA strides
    (dict(dtype=torch.bfloat16, k=100), False),
    (dict(dtype=torch.bfloat16, n=1370), False),
    (dict(dtype=torch.bfloat16, n=200, bits=8, block=64), False),
    (dict(dtype=torch.bfloat16, n=336, bits=4, block=64), False),
    (dict(dtype=torch.bfloat16, n=336, bits=8, block=64), True),
    # a block of partial 8-element pieces; an empty product; a flat index
    # past 2^31
    (dict(dtype=torch.bfloat16, bits=8, block=100), False),
    (dict(dtype=torch.bfloat16, m=0), False),
    (dict(dtype=torch.bfloat16, k=65536, n=32768, bits=8, block=256), False),
    # a base pointer one element off its allocation's aligned start
    (dict(dtype=torch.bfloat16, off_a=1), False),
    (dict(dtype=torch.bfloat16, off_b=1), False),
    (dict(dtype=torch.bfloat16, bits=8, block=256, off_b=1), False),
    (dict(dtype=torch.bfloat16, bits=4, block=256, off_b=16), True),
])
def test_wgmma_path_predicate(case, want):
    c = {**dict(m=PATH_M, k=PATH_K, n=PATH_N, bits=None, block=None,
                off_a=0, off_b=0), **case}
    b_dtype = c["dtype"] if c["bits"] is None else torch.int8
    addrs = (_addr(c["dtype"], c["off_a"]), _addr(b_dtype, c["off_b"]))
    assert fc.wgmma_path(c["dtype"], c["m"], c["n"], c["k"], addrs,
                         bits=c["bits"], block=c["block"]) is want


@pytest.mark.parametrize("bits", [8, 4])
def test_wgmma_path_leaves_the_old_gpu_case(bits):
    """test_dequant_matmul_kernel_matches_plain's b = 200 keeps the
    mma.sync kernel: 200 columns are no whole 16-byte payload stride."""
    addrs = (_addr(torch.bfloat16), _addr(torch.int8))
    assert not fc.wgmma_path(torch.bfloat16, 77, 200, 160, addrs, bits=bits,
                             block=64)


# row 9 at the path's shape: h^T [4096, 2048] x g [2048, 11008] -> int4,
# the weight gradient of a [4096, 11008] block
QPATH_ROWS, QPATH_K, QPATH_N = 4096, 2048, 11008


@pytest.mark.parametrize("case,want", [
    # the path's shape, both transpositions; the blocks it takes
    (dict(), True),
    (dict(trans_a=False), True),
    (dict(dtype=torch.float16), True),
    (dict(block=128), True),
    (dict(block=64), True),
    (dict(block=8), True),
    # blocks that do not tile the 256-wide output tile, or fall short of a
    # whole 8-element piece
    (dict(block=96), False),
    (dict(block=2), False),
    (dict(block=512), False),
    # a block that does not divide the row length n
    (dict(n=320, block=256), False),
    (dict(n=320, block=64), True),
    # fp32 keeps the FMA kernel
    (dict(dtype=torch.float32), False),
    # a base pointer one element off its allocation's aligned start
    (dict(off_a=1), False),
    (dict(off_b=1), False),
    # rows that are not whole 16-byte strides: b's n, a's rows under
    # trans_a (a is [k, rows]), a's k without it (a is [rows, k])
    (dict(n=11004, block=8), False),
    (dict(rows=4092), False),
    (dict(rows=4092, trans_a=False), True),
    (dict(k=2044, trans_a=False), False),
    (dict(k=2044), True),
    # an empty product
    (dict(rows=0), False),
])
def test_wgmma_quantize_path_predicate(case, want):
    c = {**dict(dtype=torch.bfloat16, rows=QPATH_ROWS, n=QPATH_N, k=QPATH_K,
                trans_a=True, block=256, off_a=0, off_b=0), **case}
    addrs = (_addr(c["dtype"], c["off_a"]), _addr(c["dtype"], c["off_b"]))
    assert fc.wgmma_quantize_path(c["dtype"], c["rows"], c["n"], c["k"],
                                  c["trans_a"], addrs,
                                  block=c["block"]) is want


def test_cpu_wrappers_leave_the_kernel_counts():
    wrappers = (fc.matmul_pallas, fc.dequant_matmul, fc.matmul_quantize)
    before = [(w.launches, w.wgmma_launches) for w in wrappers]
    h = torch.ones((2, 16), dtype=torch.bfloat16)
    fc.matmul_pallas(h, torch.ones((16, 32), dtype=torch.bfloat16))
    q, s = fc.quantize_blockwise_reference(torch.ones(16, 32), 8, 64)
    fc.dequant_matmul(h, q.reshape(-1), s, bits=8, block=64, b=32,
                      w_dtype=torch.bfloat16)
    # the path's kind of call at a size the Hopper predicate takes
    a, b = torch.ones((16, 8), dtype=torch.bfloat16), \
        torch.ones((16, 256), dtype=torch.bfloat16)
    for bits in (8, 4):
        fc.matmul_quantize(a, b, bits=bits, block=256, trans_a=True)
    assert [(w.launches, w.wgmma_launches) for w in wrappers] == before


# -------------------------------------------------- on the card only

def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels of "
                    "csrc/fused_collectives.cu run only on the card")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [1, 77, 256])
def test_dequant_matmul_kernel_matches_plain(dtype, bits, m):
    _cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(m + bits)
    k, b = 160, 200
    w = torch.randn((k, b), generator=gen, device="cuda")
    q, s = fc.quantize_blockwise_reference(w, bits, 64)
    payload = fc.pack_int4(q) if bits == 4 else q.reshape(-1)
    h = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    before = fc.dequant_matmul.wgmma_launches
    got = fc.dequant_matmul(h, payload, s, bits=bits, block=64, b=b,
                            w_dtype=dtype)
    ref = fc.dequant_matmul_reference(h, payload, s, bits=bits, block=64,
                                      b=b, w_dtype=dtype)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-4)
    # b = 200 is no whole 16-byte payload stride: the mma.sync kernel
    assert fc.dequant_matmul.wgmma_launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(1, 96, 256, False), (200, 96, 512, True),
                                   (64, 130, 320, False),
                                   (70, 64, 96, True)])
def test_matmul_quantize_kernel_matches_plain_on_integers(dtype, bits, shape):
    _cuda_or_skip()
    rows, kc, n, trans_a = shape
    gen = torch.Generator(device="cuda").manual_seed(rows + n)
    a = torch.randint(-3, 4, (kc, rows) if trans_a else (rows, kc),
                      generator=gen, device="cuda").to(dtype)
    b = torch.randint(-3, 4, (kc, n), generator=gen, device="cuda").to(dtype)
    p, s = fc.matmul_quantize(a, b, bits=bits, block=64, trans_a=trans_a)
    rp, rs = fc.matmul_quantize_reference(a, b, bits=bits, block=64,
                                          trans_a=trans_a)
    assert torch.equal(p, rp) and torch.equal(s, rs)
    y = fc.matmul_pallas(a.t().contiguous() if trans_a else a, b)
    assert torch.equal(y, fc.matmul_reference(a.t() if trans_a else a, b))


# the Hopper kernel: (m, k, n) with ragged m, n 1376 / 320, k not a multiple
# of the 64-deep stage (520, 528) and the path's 4096
WGMMA_SHAPES = [(1, 520, 320), (77, 4096, 1376), (333, 520, 1376),
                (77, 528, 320)]


def _wgmma_operands(gen, m, k, n, dtype, bits, block, integer):
    """h and, for bits None, b; else (payload, scales). Integer-valued:
    small integers, levels with power-of-two scales (exact products)."""
    if integer:
        h = torch.randint(-3, 4, (m, k), generator=gen, device="cuda")
    else:
        h = torch.randn((m, k), generator=gen, device="cuda")
    h = h.to(dtype)
    if bits is None:
        w = (torch.randint(-3, 4, (k, n), generator=gen, device="cuda")
             if integer else torch.randn((k, n), generator=gen,
                                         device="cuda"))
        return h, (w.to(dtype),)
    if integer:
        qmax = 2 ** (bits - 1) - 1
        q = torch.randint(-qmax - 1, qmax + 1, (k * n,), generator=gen,
                          device="cuda").to(torch.int8)
        e = torch.randint(-2, 2, (k * n // block,), generator=gen,
                          device="cuda").float()
        s = torch.pow(2.0, e)
    else:
        q, s = fc.quantize_blockwise_reference(
            torch.randn((k, n), generator=gen, device="cuda"), bits, block)
    return h, (fc.pack_int4(q) if bits == 4 else q.reshape(-1), s)


def _wgmma_pair(h, w, n, dtype, bits, block, out=None):
    """(kernel, plain) of matmul_pallas (bits None) or dequant_matmul."""
    if bits is None:
        return (fc.matmul_pallas(h, w[0], out=out),
                fc.matmul_reference(h, w[0]))
    kw = dict(bits=bits, block=block, b=n, w_dtype=dtype)
    return (fc.dequant_matmul(h, *w, out=out, **kw),
            fc.dequant_matmul_reference(h, *w, **kw))


def _wgmma_counter(bits):
    return fc.matmul_pallas if bits is None else fc.dequant_matmul


# (bits, block) of each weight kind, a block wherever it divides k*n
WGMMA_CASES = [(shape, bits, block) for shape in WGMMA_SHAPES
               for bits, block in [(None, None), (8, 256), (4, 256), (8, 64),
                                   (4, 64), (8, 96), (4, 96)]
               if block is None or (shape[1] * shape[2]) % block == 0]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape,bits,block", WGMMA_CASES)
def test_wgmma_kernel_matches_plain(dtype, shape, bits, block):
    """Random operands: within 1e-5 of max |plain| (fp32 sums in another
    order), on the Hopper kernel."""
    _cuda_or_skip()
    m, k, n = shape
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(m + k + n)
    h, w = _wgmma_operands(gen, m, k, n, dtype, bits, block, False)
    before = _wgmma_counter(bits).wgmma_launches
    got, ref = _wgmma_pair(h, w, n, dtype, bits, block)
    torch.cuda.synchronize()
    assert _wgmma_counter(bits).wgmma_launches == before + 1
    assert got.shape == (m, n) and bool(torch.isfinite(got).all())
    err = (got - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item(), err


WGMMA_EXACT_CASES = [(shape, bits, block)
                     for shape in [(77, 528, 1376), (333, 4096, 320)]
                     for bits, block in [(None, None), (8, 256), (4, 64),
                                         (8, 96)]
                     if block is None or (shape[1] * shape[2]) % block == 0]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape,bits,block", WGMMA_EXACT_CASES)
def test_wgmma_kernel_bitwise(dtype, shape, bits, block):
    """Integer-valued operands: bitwise the plain version; two runs
    bitwise equal; into a column slice of a wider fp32 output, bitwise the
    contiguous result with the other columns untouched."""
    _cuda_or_skip()
    m, k, n = shape
    gen = torch.Generator(device="cuda").manual_seed(m + n)
    h, w = _wgmma_operands(gen, m, k, n, dtype, bits, block, True)
    before = _wgmma_counter(bits).wgmma_launches
    got, ref = _wgmma_pair(h, w, n, dtype, bits, block)
    again, _ = _wgmma_pair(h, w, n, dtype, bits, block)
    wide = torch.full((m, 3 * n), float("nan"), device="cuda")
    tile, _ = _wgmma_pair(h, w, n, dtype, bits, block,
                          out=wide[:, n:2 * n])
    torch.cuda.synchronize()
    assert _wgmma_counter(bits).wgmma_launches == before + 3
    assert torch.equal(got, ref)
    assert torch.equal(again, got)
    assert tile.data_ptr() == wide[:, n:].data_ptr()
    assert torch.equal(wide[:, n:2 * n], got)
    assert bool(torch.isnan(wide[:, :n]).all())
    assert bool(torch.isnan(wide[:, 2 * n:]).all())


@pytest.mark.gpu
def test_wgmma_kernel_random_column_slice_and_reruns():
    """Random operands at the path's shape: two runs and a column slice of
    the ring's gathered output (row stride 2n) bitwise the first run."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(5)
    h, w = _wgmma_operands(gen, PATH_M, PATH_K, PATH_N, torch.bfloat16, 8,
                           256, False)
    kw = dict(bits=8, block=256, b=PATH_N, w_dtype=torch.bfloat16)
    before = fc.dequant_matmul.wgmma_launches
    got = fc.dequant_matmul(h, *w, **kw)
    again = fc.dequant_matmul(h, *w, **kw)
    wide = torch.full((PATH_M, 2 * PATH_N), float("nan"), device="cuda")
    fc.dequant_matmul(h, *w, out=wide[:, PATH_N:], **kw)
    torch.cuda.synchronize()
    assert fc.dequant_matmul.wgmma_launches == before + 3
    assert torch.equal(again, got)
    assert torch.equal(wide[:, PATH_N:], got)
    assert bool(torch.isnan(wide[:, :PATH_N]).all())


# row 9 on the Hopper kernel: (rows, k, n, block) with ragged rows, n that
# is no multiple of the 256-wide tile (320, 1376, 384), k no multiple of the
# 64-deep stage (520, 528) beside 2048. Under trans_a the rows are a's row
# length, which TMA needs in whole 16-byte strides: 72 / 328 there.
WGMMA_QUANT_SHAPES = [(77, 520, 320, 64), (333, 528, 1376, 32),
                      (77, 2048, 384, 128), (333, 2048, 1280, 256)]


def _quant_operands(gen, shape, dtype, trans_a, integer):
    rows, k, n, _ = shape
    rows -= rows % 8 if trans_a else 0
    a_shape = (k, rows) if trans_a else (rows, k)
    if integer:
        a = torch.randint(-3, 4, a_shape, generator=gen, device="cuda")
        b = torch.randint(-3, 4, (k, n), generator=gen, device="cuda")
    else:
        a = torch.randn(a_shape, generator=gen, device="cuda")
        b = torch.randn((k, n), generator=gen, device="cuda")
    return a.to(dtype), b.to(dtype)


def _levels_of(payload, bits):
    return (unpack_int4(payload) if bits == 4 else payload).int()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("trans_a", [True, False])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", WGMMA_QUANT_SHAPES)
def test_wgmma_quantize_kernel_bitwise(dtype, trans_a, bits, shape):
    """Integer-valued operands (exact products and sums): payload and
    scales bitwise the plain version's, two runs bitwise equal, both
    launches on the Hopper kernel."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(sum(shape) + bits)
    a, b = _quant_operands(gen, shape, dtype, trans_a, True)
    kw = dict(bits=bits, block=shape[3], trans_a=trans_a)
    rows = a.shape[1] if trans_a else a.shape[0]
    assert fc.wgmma_quantize_path(dtype, rows, b.shape[1], b.shape[0],
                                  trans_a, (a.data_ptr(), b.data_ptr()),
                                  block=shape[3])
    before = fc.matmul_quantize.wgmma_launches
    p, s = fc.matmul_quantize(a, b, **kw)
    p2, s2 = fc.matmul_quantize(a, b, **kw)
    rp, rs = fc.matmul_quantize_reference(a, b, **kw)
    torch.cuda.synchronize()
    assert fc.matmul_quantize.wgmma_launches == before + 2
    assert torch.equal(p, rp) and torch.equal(s, rs)
    assert torch.equal(p2, p) and torch.equal(s2, s)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("trans_a", [True, False])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", WGMMA_QUANT_SHAPES)
def test_wgmma_quantize_kernel_matches_plain(dtype, trans_a, bits, shape):
    """Random operands on the Hopper kernel: scales within 1e-5 relative,
    no level more than one apart, and at most one in 1000 levels one apart
    (fp32 sums in another order move a product across a rounding boundary
    now and then)."""
    _cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(sum(shape) + 2 * bits)
    a, b = _quant_operands(gen, shape, dtype, trans_a, False)
    kw = dict(bits=bits, block=shape[3], trans_a=trans_a)
    before = fc.matmul_quantize.wgmma_launches
    p, s = fc.matmul_quantize(a, b, **kw)
    rp, rs = fc.matmul_quantize_reference(a, b, **kw)
    torch.cuda.synchronize()
    assert fc.matmul_quantize.wgmma_launches == before + 1
    assert bool(((s - rs).abs() <= 1e-5 * rs.abs()).all())
    lv, rlv = _levels_of(p, bits), _levels_of(rp, bits)
    assert int((lv - rlv).abs().max()) <= 1
    assert int((lv != rlv).sum()) <= max(1, lv.numel() // 1000)
