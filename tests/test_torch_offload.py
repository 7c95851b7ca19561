"""ZeRO offload in the PyTorch port against the JAX package, on the CPU.

* The aio engine (``ops/aio.py`` over ``csrc/ds_aio.cpp``, built into
  ``build/kernels/``) and the swappers (``runtime/swap_tensor.py``): the
  cases of the JAX package's ``tests/test_aio_swap.py`` (round trip, 16
  requests in flight, a read error raised after the queue is drained,
  the sync calls, a state tree swapped out and back), the same file names
  and bytes as JAX's ``OptimizerSwapper`` writes for the same state, and
  the raises: a short swap file, a failed build, a failed pin.
* The port's offloaded engine against JAX's offloaded ``TrainEngine``, in
  fp32, at the widths of ``tests/test_offload.py`` and
  ``tests/test_sharded_init.py``: ``offload_optimizer`` ``"cpu"`` and
  ``"nvme"`` at stage 1 on one device, and ``offload_param`` ``"cpu"`` at
  stage 3 on 2 gloo ranks (``tests/torch_ranks.py`` job ``offload_job``)
  against JAX over ``{"data": 2}`` of its virtual CPU devices. Losses
  within 1e-5 and grad norms within 1e-4 relative; masters within 2e-5
  except Adam's near-eps elements, by the rule every training test of the
  port shares (``tests/torch_train_parity.py`` ``assert_weights``). At
  1e-6 that rule does not hold for the resident port either: after 3
  steps at lr 3e-3 elements whose |g| is just above its 1e-7 cut differ
  from JAX's by up to 2.1e-6 (fp32 sums in another order, through Adam's
  near-eps step); the offloaded port is held bitwise to its resident
  engine instead.
* The port's offloaded engine bitwise equal to its resident one (losses,
  masters, moments) for each device and stage, the streamed path and the
  whole-state path (LAMB), on 2 ranks with the leaves that are gathered
  after their update; the state parked between steps; an ``"nvme"``
  save / load that resumes bitwise; ``train_steps_eligible`` false with
  JAX's reason; the stream's window never above ``buffer_count`` leaves.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import Llama as JaxLlama
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu.runtime.optimizers import build_optimizer as jax_build
from deepspeed_tpu.runtime.swap_tensor import \
    OptimizerSwapper as JaxOptimizerSwapper
from deepspeed_tpu_torch.checkpoint.jax_params import load_jax_params
from deepspeed_tpu_torch.config import Config, ConfigError
from deepspeed_tpu_torch.models.llama import Llama
from deepspeed_tpu_torch.ops import aio, op_builder
from deepspeed_tpu_torch.runtime import optimizers as opt
from deepspeed_tpu_torch.runtime import swap_tensor as st

from torch_ranks import start_ranks
from torch_train_parity import assert_weights, flat_jax, run_both

# tests/test_offload.py's and tests/test_sharded_init.py's widths
SMALL = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, vocab_size=64,
             max_seq_len=16, use_flash=False, remat=False)
WIDE = dict(SMALL, d_model=64, vocab_size=128, max_seq_len=32)
CFG = {"train_batch_size": 8, "gradient_clipping": 1.0,
       "steps_per_print": 1000,
       "optimizer": {"type": "adamw", "params": {"lr": 3e-3,
                                                 "weight_decay": 0.01}}}
STEPS = 3


def _tokens(seed, vocab=64, seq=16):
    return np.random.default_rng(seed).integers(
        0, vocab, (8, seq)).astype(np.int32)


def _batches(vocab=64, seq=16):
    return [{"input_ids": _tokens(40 + i, vocab, seq)} for i in range(STEPS)]


def _cfg(zero, **extra):
    return {**CFG, "zero_optimization": zero, **extra}


def _engine(zero, widths=SMALL, **extra):
    model = Llama("tiny", device="cpu", seed=3, **widths)
    return deepspeed_tpu_torch.initialize(model=model,
                                          config=_cfg(zero, **extra),
                                          device="cpu")[0]


def _train(eng, batches):
    return [eng.train_batch({k: torch.from_numpy(v) for k, v in b.items()})
            for b in batches]


def _moments(eng):
    fields = eng._opt_tree_fields or ["mu", "nu"]
    if eng._opt_store is not None:
        return {f: eng._opt_store.read(f) for f in fields}
    return {f: getattr(eng.opt_state, f) for f in fields}


def _assert_bitwise(a, b):
    for ma, mb in zip(a[2], b[2]):
        assert float(ma["loss"]) == float(mb["loss"])
        assert float(ma["grad_norm"]) == float(mb["grad_norm"])
    pa, pb = a[0]._materialized_params(), b[0]._materialized_params()
    assert all(torch.equal(pa[n], pb[n]) for n in pa)
    for f, tree in _moments(a[0]).items():
        other = _moments(b[0])[f]
        assert all(torch.equal(tree[n], other[n]) for n in tree), f


def _run(zero, batches, **extra):
    eng = _engine(zero, **extra)
    return eng, None, _train(eng, batches)


# ------------------------------------------------------------- aio, swap
def test_aio_builds_into_build_kernels_and_caches():
    h = aio.AsyncIOHandle(n_threads=2)
    lib = op_builder._libs["host:ds_aio"]
    assert os.path.dirname(lib._name) == str(op_builder.BUILD_DIR)
    assert "-pthread" in op_builder._host_flags("ds_aio")
    assert op_builder.host_digest("ds_aio") != op_builder.host_digest(
        "ragged_host")
    assert aio.AsyncIOHandle()._lib is h._lib is lib


@pytest.mark.parametrize("kind", ["tensor", "numpy"])
def test_aio_write_read_round_trip(tmp_path, kind):
    h = aio.AsyncIOHandle(n_threads=2)
    data = np.random.default_rng(0).normal(size=(1 << 16,)).astype(
        np.float32)
    src = torch.from_numpy(data.copy()) if kind == "tensor" else data
    path = str(tmp_path / "blob.bin")
    req = h.async_pwrite(src, path)
    assert h.wait(1) == [(req, data.nbytes)]
    out = torch.empty(1 << 16) if kind == "tensor" else np.empty_like(data)
    h.async_pread(out, path)
    h.wait(1)
    np.testing.assert_array_equal(np.asarray(out), data)
    assert h.inflight() == 0 and h.poll() == 0


def test_aio_sixteen_in_flight(tmp_path):
    h = aio.AsyncIOHandle(n_threads=4)
    arrays = [torch.full((4096,), float(i)) for i in range(16)]
    for i, a in enumerate(arrays):
        h.async_pwrite(a, str(tmp_path / f"f{i}.bin"))
    assert sum(len(h.wait(1)) for _ in range(16)) == 16
    outs = [torch.empty(4096) for _ in range(16)]
    for i, o in enumerate(outs):
        h.async_pread(o, str(tmp_path / f"f{i}.bin"))
    assert sum(len(h.wait(1)) for _ in range(16)) == 16
    assert all(bool((o == i).all()) for i, o in enumerate(outs))


def test_aio_read_error_is_raised_after_the_queue_drains(tmp_path):
    h = aio.AsyncIOHandle()
    good = torch.arange(64, dtype=torch.float32)
    h.sync_pwrite(good, str(tmp_path / "good.bin"))
    h.async_pread(torch.empty(64), str(tmp_path / "missing.bin"))
    h.async_pread(torch.empty(64), str(tmp_path / "good.bin"))
    with pytest.raises(OSError) as e:
        h.wait(2)
    assert len(e.value.failed) == 1 and len(e.value.completed) == 1
    assert h.inflight() == 0 and not h._buffers


def test_aio_sync_calls(tmp_path):
    h = aio.AsyncIOHandle()
    data = torch.arange(1000, dtype=torch.int32)
    assert h.sync_pwrite(data, str(tmp_path / "s.bin")) == 4000
    out = torch.empty_like(data)
    assert h.sync_pread(out, str(tmp_path / "s.bin")) == 4000
    assert torch.equal(out, data)


def test_optimizer_swapper_round_trip_with_jax_file_names(tmp_path):
    """A port AdamW state swapped out and back, bitwise; its files have
    the names and bytes JAX's swapper writes for the same state."""
    rng = np.random.default_rng(1)
    port = {"tok_embed": rng.normal(size=(8, 4)),
            "layers.0.wq": rng.normal(size=(4, 4)),
            "layers.1.wq": rng.normal(size=(4, 4))}
    port = {n: torch.from_numpy(v.astype(np.float32)) for n, v in
            port.items()}
    state = opt.AdamState(7, {n: t * 2 for n, t in port.items()},
                          {n: t * t for n, t in port.items()})
    sw = st.OptimizerSwapper(str(tmp_path / "port"))
    sw.swap_out(state)
    back = sw.swap_in()
    assert back.count == 7
    for f in ("mu", "nu"):
        for n, t in getattr(state, f).items():
            assert torch.equal(getattr(back, f)[n], t)
    masters = st.OptimizerSwapper(str(tmp_path / "masters"))
    masters.swap_out(port)
    assert all(torch.equal(masters.swap_in()[n], t) for n, t in port.items())

    tree = {"tok_embed": jnp.asarray(port["tok_embed"].numpy()),
            "layers": {"wq": jnp.stack([jnp.asarray(port[f"layers.{i}.wq"]
                                                    .numpy())
                                        for i in range(2)])}}
    jstate = jax_build("adamw", {"lr": 1e-3}).init(tree)
    jstate = jstate._replace(
        mu=jax.tree_util.tree_map(lambda x: x * 2, tree),
        nu=jax.tree_util.tree_map(lambda x: x * x, tree))
    jsw = JaxOptimizerSwapper(str(tmp_path / "jax"))
    jsw.swap_out(jstate)
    jfiles = {p.name for p in (tmp_path / "jax").iterdir()} - {".count.bin"}
    assert jfiles == {p.name for p in (tmp_path / "port").iterdir()}
    for name in jfiles:
        assert (tmp_path / "jax" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes(), name


def test_short_swap_file_raises(tmp_path):
    eng = _engine({"stage": 1, "offload_optimizer": {
        "device": "nvme", "nvme_path": str(tmp_path)}})
    _train(eng, _batches()[:1])
    victim = tmp_path / ".mu__lm_head__.bin"
    victim.write_bytes(victim.read_bytes()[:-4])
    with pytest.raises(st.SwapFileError, match="mu__lm_head"):
        _train(eng, _batches()[:1])


def test_failed_aio_build_raises(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "ds_aio.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(op_builder, "CSRC", src)
    monkeypatch.setattr(op_builder, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(op_builder, "_libs", {})
    with pytest.raises(RuntimeError, match="host library build failed"):
        aio.AsyncIOHandle()
    with pytest.raises(RuntimeError, match="host library build failed"):
        _engine({"stage": 1, "offload_optimizer": {
            "device": "nvme", "nvme_path": str(tmp_path / "swap")}})


def test_failed_pin_raises(monkeypatch):
    class Cudart:
        def cudaHostRegister(self, ptr, n, flags):
            return 2                         # cudaErrorMemoryAllocation

        def cudaHostUnregister(self, ptr):
            return 0

    monkeypatch.setattr(torch.cuda, "cudart", lambda: Cudart())
    with pytest.raises(RuntimeError, match="pinning 4096 B"):
        st.host_zeros((1024,), torch.float32, pin=True)
    assert st.host_zeros((1024,), torch.float32, pin=False).numel() == 1024


# ---------------------------------------------------------------- config
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_config_reads_offload_blocks(stage):
    zero = {"stage": stage, "offload_optimizer": {
        "device": "nvme", "nvme_path": "/x", "buffer_count": 3,
        "ratio": 0.5, "max_in_cpu": 1}}
    if stage == 3:
        zero["offload_param"] = {"device": "cpu", "pin_memory": False}
    cfg = Config.from_dict({"train_batch_size": 8,
                            "zero_optimization": zero})
    z = cfg.zero
    assert (z.offload_optimizer.device, z.offload_optimizer.nvme_path,
            z.offload_optimizer.buffer_count,
            z.offload_optimizer.ratio) == ("nvme", "/x", 3, 0.5)
    assert z.offload_param.enabled == (stage == 3)
    with pytest.raises(ConfigError, match="offload device"):
        Config.from_dict({"train_batch_size": 8, "zero_optimization": {
            "stage": stage, "offload_optimizer": {"device": "gpu"}}})


def test_offload_param_below_stage_3_is_read_and_unused():
    eng = _engine({"stage": 2, "offload_param": {"device": "cpu"}})
    assert eng._param_offload_device == "none" and not eng._offloaded
    assert eng.train_steps_eligible() == (True, None)


# ------------------------------------------------------ against JAX
def _jax_models(widths, seed):
    jm = JaxLlama("tiny", **widths)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = load_jax_params(Llama("tiny", device="cpu", **widths),
                         jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


@pytest.mark.parametrize("device", ["cpu", "nvme"])
def test_stage1_offload_matches_jax(device, tmp_path):
    jm, params, tm = _jax_models(SMALL, 5)
    # the two packages write the same file names: a directory each
    cfg, port_cfg = (_cfg({"stage": 1, "offload_optimizer": {
        "device": device, "nvme_path": str(tmp_path / who)}})
        for who in ("jax", "port"))
    jmesh.reset_topology()
    jeng, teng, steps, min_abs_g = run_both(jm, params, tm, _batches(), cfg,
                                            port_cfg)
    jmesh.reset_topology()
    assert jeng._offload_device == teng._offload_device == device
    for j, t in steps:
        assert t["offload_streamed"] == 1.0
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-5)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"],
                                   rtol=1e-4)
    lr_sum = sum(teng.lr_schedule(c) for c in range(1, STEPS + 1))
    ref = flat_jax(jax.tree_util.tree_map(np.asarray, jeng.params))
    assert_weights({n: w.numpy() for n, w in teng.params.items()}, ref,
                   {n: (g.numpy(), hi) for n, (g, hi) in min_abs_g.items()},
                   lr_sum)
    assert teng.train_steps_eligible() == jeng.train_steps_eligible()
    assert teng.train_steps_eligible() == (
        False, "zero-offload swaps state around every step")


# ---------------------------------------------- bitwise against resident
BITWISE = {
    "opt_cpu_s1": ({"stage": 1}, {"offload_optimizer": {"device": "cpu"}}),
    "opt_nvme_s2": ({"stage": 2}, {"offload_optimizer": {"device": "nvme"}}),
    "param_cpu_s3": ({"stage": 3}, {"offload_param": {"device": "cpu"}}),
    "both_nvme_s3": ({"stage": 3}, {"offload_param": {"device": "nvme"},
                                    "offload_optimizer": {"device": "nvme"}}),
    "lamb_opt_cpu_s1": ({"stage": 1}, {"offload_optimizer": {
        "device": "cpu"}}),
}


@pytest.mark.parametrize("key", list(BITWISE))
def test_offload_is_bitwise_the_resident_engine(key, tmp_path):
    zero, off = BITWISE[key]
    off = {k: dict(v, nvme_path=str(tmp_path / k)) for k, v in off.items()}
    extra = {}
    if key.startswith("lamb"):
        extra["optimizer"] = {"type": "lamb", "params": {"lr": 3e-3}}
    batches = _batches()
    ref = _run(zero, batches, **extra)
    got = _run({**zero, **off}, batches, **extra)
    _assert_bitwise(got, ref)
    assert all(m["offload_streamed"] == (not key.startswith("lamb"))
               for m in got[2])
    assert "offload_streamed" not in ref[2][0]


def test_state_is_parked_between_steps(tmp_path):
    cpu = _engine({"stage": 3, "offload_param": {"device": "cpu"},
                   "offload_optimizer": {"device": "cpu"}})
    _train(cpu, _batches()[:1])
    assert cpu.opt_state.mu is cpu._opt_store.host("mu")
    assert cpu.params is cpu._param_store.host("")
    assert cpu.opt_state.count == 1
    nvme = _engine({"stage": 3, "offload_param": {
        "device": "nvme", "nvme_path": str(tmp_path)},
        "offload_optimizer": {"device": "nvme", "nvme_path": str(tmp_path)}})
    assert nvme.opt_state is None and nvme.params is None
    _train(nvme, _batches()[:2])
    assert nvme.opt_state is None and nvme.params is None
    assert nvme._opt_skeleton.count == 2
    names = {p.name for p in tmp_path.iterdir()}
    assert {".mu__lm_head__.bin", ".nu__layers____wq__.bin",
            "__lm_head__.bin", "__layers____wq__.bin"} <= names
    stats = nvme.offload_stats()
    # masters 1x, moments 2x the model's fp32 bytes
    n = sum(p.numel() for p in nvme.model.parameters()) * 4
    assert stats["opt_bytes_on_disk"] == stats["param_bytes_on_disk"] \
        == 3 * n
    assert stats["h2d_bytes"] == stats["d2h_bytes"] == 3 * n


def test_nvme_checkpoint_resumes_bitwise(tmp_path):
    zero = {"stage": 3, "offload_param": {
        "device": "nvme", "nvme_path": str(tmp_path / "a")},
        "offload_optimizer": {"device": "nvme",
                              "nvme_path": str(tmp_path / "a")}}
    batches = _batches() + [{"input_ids": _tokens(50)}]
    a = _engine(zero)
    _train(a, batches[:2])
    a.save_checkpoint(str(tmp_path / "ckpt"))
    tail_a = _train(a, batches[2:])
    b = _engine(dict(zero, offload_param={
        "device": "nvme", "nvme_path": str(tmp_path / "b")},
        offload_optimizer={"device": "nvme",
                           "nvme_path": str(tmp_path / "b")}))
    b.load_checkpoint(str(tmp_path / "ckpt"))
    assert b.params is None and b.opt_state is None
    assert b._opt_skeleton.count == 2 and b.global_steps == 2
    tail_b = _train(b, batches[2:])
    _assert_bitwise((a, None, tail_a), (b, None, tail_b))
    # the tag loads into a resident engine as well
    c = _engine({"stage": 3})
    c.load_checkpoint(str(tmp_path / "ckpt"), tag="global_step2")
    _assert_bitwise((c, None, []), (_reload(zero, tmp_path), None, []))


def _reload(zero, tmp_path):
    eng = _engine(dict(zero, offload_param={
        "device": "cpu"}, offload_optimizer={"device": "cpu"}))
    eng.load_checkpoint(str(tmp_path / "ckpt"), tag="global_step2")
    assert eng.opt_state.mu is eng._opt_store.host("mu")
    return eng


def test_compat_path_and_eval_read_parked_masters(tmp_path):
    zero = {"stage": 3, "offload_param": {
        "device": "nvme", "nvme_path": str(tmp_path)}}
    batches = _batches()[:2]
    ref = _engine({"stage": 3})
    _train(ref, batches)
    eng = _engine(zero)
    for b in batches:
        eng.backward({k: torch.from_numpy(v) for k, v in b.items()})
        eng.step()
        assert eng.params is None
    _assert_bitwise((eng, None, []), (ref, None, []))
    ids = {"input_ids": torch.from_numpy(_tokens(9))}
    assert float(eng.eval_batch(ids)) == float(ref.eval_batch(ids))
    assert eng.params is None
    full = eng.get_fp32_state_dict()
    assert all(torch.equal(full[n], p) for n, p in ref.params.items())


def test_window_holds_at_most_its_leaves():
    eng = _engine({"stage": 1, "offload_optimizer": {"device": "cpu",
                                                     "buffer_count": 2}})
    _train(eng, _batches()[:1])
    stats = eng.offload_stats()
    assert stats["window_leaves"] == 2
    biggest = sorted((p.numel() * 8 for p in eng.params.values()),
                     reverse=True)
    assert stats["window_bytes"] <= biggest[0] + biggest[1]
    assert eng._stream.live == 0


# ------------------------------------------------ stage 3 on two ranks
def _dense_case():
    import dataclasses

    jm, params, _ = _jax_models(WIDE, 7)
    cfg = dataclasses.asdict(Llama("tiny", device="cpu", **WIDE).config)
    return jm, {"family": "dense", "config": cfg,
                "params": jax.tree_util.tree_map(np.asarray, params),
                "cfg": CFG, "batches": _batches(128, 32)}


S3 = {"stage": 3, "stage3_param_persistence_threshold": 0}
RANK_RUNS = {
    "resident": S3,
    "param_cpu": {**S3, "offload_param": {"device": "cpu"}},
    # the default threshold keeps the norms whole, each gathered after
    # its update inside the stream
    "resident_p": {"stage": 3},
    "both_cpu_p": {"stage": 3, "offload_param": {"device": "cpu"},
                   "offload_optimizer": {"device": "cpu"}},
}


@pytest.fixture(scope="module")
def two_ranks():
    jm, case = _dense_case()
    ranks = start_ranks(2, "offload_job", case, RANK_RUNS, timeout=240)
    jmesh.reset_topology()
    jeng, *_ = deepspeed_tpu.initialize(
        model=jm, params=jax.tree_util.tree_map(jnp.asarray, case["params"]),
        config={**CFG, "mesh": {"data": 2}, "zero_optimization": {
            **S3, "offload_param": {"device": "cpu"}}},
        topology=jmesh.Topology.build_virtual({"data": 2}))
    steps = [{k: float(np.asarray(v)) for k, v in jeng.train_batch(
        {k: jnp.asarray(v) for k, v in b.items()}).items()}
        for b in case["batches"]]
    ref = (steps, flat_jax(jax.tree_util.tree_map(np.asarray, jeng.params)),
           jeng.train_steps_eligible())
    jmesh.reset_topology()
    yield ref, ranks.results()
    ranks.kill()


def test_stage3_param_offload_on_two_ranks_matches_jax(two_ranks):
    (jsteps, jweights, jeligible), res = two_ranks
    got = res[0]["param_cpu"]
    for t, j in zip(got["steps"], jsteps):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-5)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"],
                                   rtol=1e-4)
    assert [r["param_cpu"]["steps"] for r in res] == [got["steps"]] * 2
    lr_sum = 3e-3 * STEPS
    assert_weights(flat_jax(got["full"]), jweights,
                   {n: (g, got["hi"][n]) for n, g in got["lo"].items()},
                   lr_sum)
    assert got["eligible"] == jeligible
    assert all(r["param_cpu"]["parked"] for r in res)


@pytest.mark.parametrize("pair", [("param_cpu", "resident"),
                                  ("both_cpu_p", "resident_p")])
def test_stage3_offload_on_two_ranks_is_bitwise_resident(two_ranks, pair):
    _, res = two_ranks
    off, ref = pair
    for r in res:
        assert r[off]["steps"] == [dict(s, offload_streamed=1.0)
                                   for s in r[ref]["steps"]]
        assert r[off]["digest"] == r[ref]["digest"]
