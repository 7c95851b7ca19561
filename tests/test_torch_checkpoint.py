"""Checkpoints of the port (``runtime/checkpoint.py`` and the trainer's
checkpoint surface) held to the JAX package.

The commit-protocol scenarios of the JAX suite run on both packages and
must reach the same decisions (the tag chosen or refused, the files
outside ``state/``); the port's resume is bitwise its uninterrupted run,
its resumed losses match JAX's resumed run on the same weights and
batches, a tag saved at ZeRO-3 over two gloo ranks or at tensor
parallelism 2 loads at stage 0 on one rank, and the weight-only swap,
the 16-bit export and the fp32 state dict match JAX's on the same
weights.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu as jdst
import deepspeed_tpu_torch as tdst
from deepspeed_tpu.models import Llama as JLlama
from deepspeed_tpu.resilience import chaos as jchaos
from deepspeed_tpu.runtime import checkpoint as jck
from deepspeed_tpu_torch.checkpoint import safetensors_io as sio
from deepspeed_tpu_torch.checkpoint.jax_params import (export_params,
                                                       load_jax_params)
from deepspeed_tpu_torch.models.llama import Llama as TLlama
from deepspeed_tpu_torch.resilience import chaos as tchaos
from deepspeed_tpu_torch.runtime import checkpoint as tck

import torch_ranks


@pytest.fixture(autouse=True)
def _no_injectors():
    yield
    jchaos.install_fault_injector(None)
    tchaos.install_fault_injector(None)


# ----------------------------------------------------------------------
# the JAX suite's tiny linear model, on both packages

def _batch(i, scale=1.0):
    rng = np.random.default_rng(1000 + i)
    return {"x": rng.normal(size=(16, 8)).astype(np.float32),
            "y": rng.normal(size=(16, 4)).astype(np.float32),
            "scale": np.full((16,), scale, np.float32)}


def _cfg(extra):
    cfg = {"train_batch_size": 16,
           "optimizer": {"type": "adamw", "params": {"lr": 1e-2}},
           "steps_per_print": 1000}
    cfg.update(extra or {})
    return cfg


def _jax_loss(params, batch, rng):
    p = batch["x"] @ params["w"] + params["b"]
    return ((p - batch["y"]) ** 2).mean() * batch["scale"][0]


def _torch_loss(params, batch):
    p = batch["x"] @ params["w"] + params["b"]
    return ((p - batch["y"]) ** 2).mean() * batch["scale"][0]


class Pkg:
    """One package's checkpoint module, chaos hooks and engine."""

    def __init__(self, name):
        self.name = name
        self.ck = jck if name == "jax" else tck
        self.chaos = jchaos if name == "jax" else tchaos

    def engine(self, extra=None):
        if self.name == "jax":
            import jax.numpy as jnp
            params = {"w": jnp.ones((8, 4), jnp.float32) * 0.1,
                      "b": jnp.zeros((4,), jnp.float32)}
            return jdst.initialize(loss_fn=_jax_loss, params=params,
                                   config=_cfg(extra))[0]
        params = {"w": torch.ones(8, 4) * 0.1, "b": torch.zeros(4)}
        return tdst.initialize(loss_fn=_torch_loss, params=params,
                               config=_cfg(extra), device="cpu")[0]

    def state(self, n):
        a = np.arange(n, dtype=np.float32)
        return {"a": a if self.name == "jax" else torch.from_numpy(a)}

    def install(self, **kw):
        self.chaos.install_fault_injector(self.chaos.FaultInjector(**kw))

    def registry(self):
        if self.name == "jax":
            from deepspeed_tpu.telemetry.registry import get_registry
        else:
            from deepspeed_tpu_torch.telemetry.registry import get_registry
        return get_registry()


PKGS = (Pkg("jax"), Pkg("torch"))


def _outside_state(path):
    return sorted(n for n in os.listdir(path) if n != "state")


def _both(scenario, tmp_path):
    """The scenario's decisions on each package (each in its own dir)."""
    out = []
    for pkg in PKGS:
        d = tmp_path / pkg.name
        d.mkdir()
        out.append(scenario(pkg, str(d)))
    return out


# ----------------------------------------------------------------------
# the commit protocol, on both packages

def _layout_and_latest(pkg, d):
    path = pkg.ck.CheckpointEngine().save(d, "t1", pkg.state(8),
                                          client_state={"global_steps": 1})
    with open(os.path.join(path, pkg.ck.MANIFEST_FILE)) as f:
        manifest = json.load(f)
    with open(os.path.join(d, "latest")) as f:
        latest = f.read().strip()
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return {"outside": _outside_state(path),
            "manifest_meta": "meta.json" in manifest["files"],
            "manifest_state": any(r.startswith("state")
                                  for r in manifest["files"]),
            "ok": pkg.ck.verify_tag(path), "latest": latest,
            "meta": {k: meta[k] for k in ("tag", "client_state", "version")},
            "debris": [n for n in os.listdir(d) if n.startswith(".tmp-")]}


def test_commit_protocol_layout_and_latest(tmp_path):
    j, t = _both(_layout_and_latest, tmp_path)
    assert j == t
    assert t["outside"] == ["COMMITTED", "manifest.json", "meta.json"]
    assert t["ok"] == (True, "ok") and t["latest"] == "t1"
    assert t["manifest_meta"] and t["manifest_state"] and not t["debris"]


def _crash_before_commit(pkg, d):
    e = pkg.engine({"checkpoint": {"save_dir": d}})
    pkg.install(crash_before_commit_at_save=2)
    e.train_batch(_batch(0))
    e.save_checkpoint(d)
    e.train_batch(_batch(1))
    with pytest.raises(pkg.chaos.InjectedFault):
        e.save_checkpoint(d)
    pkg.chaos.install_fault_injector(None)
    torn = os.path.isdir(os.path.join(d, "global_step2"))
    found = pkg.ck.find_valid_tag(d)
    loaded = e.load_checkpoint(d, auto=True) is not None
    return {"torn": torn, "found": found, "loaded": loaded,
            "step": e.global_steps}


def test_crash_before_commit_preserves_previous(tmp_path):
    j, t = _both(_crash_before_commit, tmp_path)
    assert j == t == {"torn": False, "found": "global_step1",
                      "loaded": True, "step": 1}


def _crash_after_commit(pkg, d):
    ref = pkg.engine()
    ref_losses = [float(ref.train_batch(_batch(i))["loss"])
                  for i in range(6)]
    e = pkg.engine({"checkpoint": {"save_dir": d}})
    for i in range(3):
        e.train_batch(_batch(i))
    pkg.install(crash_after_commit_at_save=1)
    with pytest.raises(pkg.chaos.InjectedFault):
        e.save_checkpoint(d)
    pkg.chaos.install_fault_injector(None)
    latest = os.path.isfile(os.path.join(d, "latest"))
    found = pkg.ck.find_valid_tag(d)
    e2 = pkg.engine({"checkpoint": {"save_dir": d, "auto_resume": True}})
    step = e2.global_steps
    resumed = [float(e2.train_batch(_batch(i))["loss"]) for i in range(3, 6)]
    return {"latest": latest, "found": found, "step": step,
            "bitwise": resumed == ref_losses[3:], "losses": resumed}


def test_crash_after_commit_resumes_bit_exact(tmp_path):
    j, t = _both(_crash_after_commit, tmp_path)
    np.testing.assert_allclose(t.pop("losses"), j.pop("losses"), rtol=1e-5)
    assert j == t == {"latest": False, "found": "global_step3", "step": 3,
                      "bitwise": True}


def _corrupt_shard(pkg, d):
    ck = pkg.ck.CheckpointEngine()
    ck.save(d, "s1", pkg.state(16))
    path2 = ck.save(d, "s2", pkg.state(16))
    pkg.chaos.corrupt_tag(path2)
    ok, reason = pkg.ck.verify_tag(path2)
    return {"ok": ok, "checksum": "checksum mismatch" in reason,
            "found": pkg.ck.find_valid_tag(d), "auto": ck.load(d)["tag"],
            "explicit": ck.load(d, tag="s2")}


def test_corrupt_shard_detected_and_skipped(tmp_path):
    j, t = _both(_corrupt_shard, tmp_path)
    assert j == t == {"ok": False, "checksum": True, "found": "s1",
                      "auto": "s1", "explicit": None}


def _injector_corrupt(pkg, d):
    before = pkg.registry().counter("resilience/chaos/corrupt_shard").value
    pkg.install(corrupt_shard_at_save=1, seed=7)
    path = pkg.ck.CheckpointEngine().save(d, "c1", pkg.state(16))
    pkg.chaos.install_fault_injector(None)
    after = pkg.registry().counter("resilience/chaos/corrupt_shard").value
    return {"ok": pkg.ck.verify_tag(path)[0], "counted": after - before}


def test_injector_corrupt_shard_hook(tmp_path):
    j, t = _both(_injector_corrupt, tmp_path)
    assert j == t == {"ok": False, "counted": 1}


def _keep_last_n(pkg, d):
    ck = pkg.ck.CheckpointEngine(keep_last_n=2)
    for i in range(4):
        ck.save(d, f"t{i}", pkg.state(8))
    kept = sorted(n for n in os.listdir(d) if n.startswith("t"))
    pkg.chaos.corrupt_tag(os.path.join(d, "t3"))
    pkg.ck.CheckpointEngine(keep_last_n=1)._gc(d)
    return {"kept": kept,
            "after": sorted(n for n in os.listdir(d) if n.startswith("t")),
            "found": pkg.ck.find_valid_tag(d)}


def test_keep_last_n_gc_never_deletes_only_valid(tmp_path):
    j, t = _both(_keep_last_n, tmp_path)
    assert j == t == {"kept": ["t2", "t3"], "after": ["t2", "t3"],
                      "found": "t2"}


def test_state_round_trips_every_dtype_and_scalars(tmp_path):
    """The port's state files: every codec dtype, 0-d and empty tensors,
    nested groups and JSON scalars come back as they went in."""
    g = torch.Generator().manual_seed(0)
    state = {"w": {"a": torch.randn(3, 5, generator=g).bfloat16(),
                   "b": torch.randn(4, generator=g).half(),
                   "c": torch.tensor(2.5), "e": torch.empty(0, 3),
                   "n": {"i": torch.arange(6).reshape(2, 3)}},
             "flags": {"m": torch.tensor([True, False]),
                       "u": torch.arange(4, dtype=torch.uint8),
                       "s": torch.arange(3, dtype=torch.int16),
                       "k": torch.arange(3, dtype=torch.int8),
                       "j": torch.arange(3, dtype=torch.int32),
                       "step": 7, "scale": 0.1 + 0.2, "name": "x"}}
    ck = tck.CheckpointEngine()
    ck.save(str(tmp_path), "t", state)
    got = ck.load(str(tmp_path))["state"]
    assert got["flags"]["step"] == 7 and got["flags"]["scale"] == 0.1 + 0.2
    assert got["flags"]["name"] == "x"
    flat = {("w", "a"): state["w"]["a"], ("w", "b"): state["w"]["b"],
            ("w", "c"): state["w"]["c"], ("w", "e"): state["w"]["e"],
            ("w", "n/i"): state["w"]["n"]["i"],
            **{("flags", k): v for k, v in state["flags"].items()
               if isinstance(v, torch.Tensor)}}
    for (grp, k), v in flat.items():
        assert got[grp][k].dtype == v.dtype and got[grp][k].shape == v.shape
        assert torch.equal(got[grp][k], v), (grp, k)


def test_async_save_commits_on_the_writer_thread(tmp_path):
    """``async_save``: the host copies are taken at the save call (the
    step after it does not leak into the tag); ``wait`` joins the writer,
    and the tag resumes like a synchronous one."""
    d = str(tmp_path)
    e = Pkg("torch").engine({"checkpoint": {"save_dir": d,
                                            "async_save": True}})
    e.train_batch(_batch(0))
    at_save = {n: p.clone() for n, p in e.params.items()}
    e.save_checkpoint(d)
    e.train_batch(_batch(1))
    e.close()
    assert tck.find_valid_tag(d) == "global_step1"
    e2 = Pkg("torch").engine({"checkpoint": {"save_dir": d,
                                             "auto_resume": True}})
    assert e2.global_steps == 1
    for n, p in at_save.items():
        assert torch.equal(e2.params[n], p)


# ----------------------------------------------------------------------
# the trainer: resume, parity with JAX, other layouts

TINY = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
            vocab_size=64, max_seq_len=16, use_flash=False, remat=False)


def _tokens(n, seed=0):
    return np.random.default_rng(seed).integers(0, 64, (n, 16)).astype(
        np.int32)


def _llama_cfg(extra=None):
    cfg = {"train_batch_size": 16, "gradient_accumulation_steps": 2,
           "seed": 5, "steps_per_print": 1000,
           "optimizer": {"type": "adamw", "params": {"lr": 3e-3}}}
    cfg.update(extra or {})
    return cfg


def _opt_state(e):
    return {k: {n: t.clone() for n, t in v.items()}
            for k, v in e.opt_state._asdict().items() if isinstance(v, dict)}


@pytest.mark.parametrize("precision", ["fp32", "fp16"])
def test_resume_is_bitwise_its_uninterrupted_run(tmp_path, precision):
    """4 steps straight (A) against 2 steps, a save every 2 steps and a
    fresh ``initialize`` with ``auto_resume`` that runs steps 3-4 (R), on
    the bound loader's batches: losses, masters, moments, the loss
    scaler, the step and the random stream equal A's bit for bit."""
    extra = {"fp16": {"enabled": True, "initial_scale_power": 8,
                      "loss_scale_window": 2}} if precision == "fp16" else {}
    data = {"input_ids": _tokens(80)}

    def run(steps, ck=None):
        m = TLlama("tiny", device="cpu", seed=3, **TINY)
        e, _, loader, _ = tdst.initialize(
            model=m, config=_llama_cfg({**extra, **(ck or {})}),
            training_data=data, device="cpu")
        it = iter(loader)
        return e, [float(e.train_batch(next(it))["loss"])
                   for _ in range(steps)]

    a, a_losses = run(4)
    d = str(tmp_path)
    run(2, {"checkpoint": {"save_dir": d, "save_interval": 2,
                           "keep_last_n": 2}})
    r, r_losses = run(2, {"checkpoint": {"save_dir": d,
                                         "auto_resume": True}})
    assert r_losses == a_losses[2:]
    assert r.global_steps == a.global_steps == 4
    for n, p in a.params.items():
        assert torch.equal(r.params[n], p), n
    for k, tree in _opt_state(a).items():
        for n, t in tree.items():
            assert torch.equal(_opt_state(r)[k][n], t), (k, n)
    assert r.opt_state.count == a.opt_state.count
    assert r.scaler_state == a.scaler_state
    assert torch.equal(r.rng.get_state(), a.rng.get_state())
    assert r.micro_steps == a.micro_steps


def test_save_load_round_trip_is_bitwise(tmp_path):
    """A tag loaded into a fresh engine holds the saved state bit for
    bit, and so does an explicit ``tag``."""
    m = TLlama("tiny", device="cpu", seed=1, **TINY)
    e = tdst.initialize(model=m, config=_llama_cfg(), device="cpu")[0]
    e.train_batch({"input_ids": _tokens(16, 1)})
    e.save_checkpoint(str(tmp_path), tag="x", client_state={"note": 1})
    f = tdst.initialize(model=TLlama("tiny", device="cpu", seed=2, **TINY),
                        config=_llama_cfg(), device="cpu")[0]
    client = f.load_checkpoint(str(tmp_path), tag="x")
    assert client["note"] == 1 and client["global_steps"] == 1
    for n, p in e.params.items():
        assert torch.equal(f.params[n], p)
    assert f.load_checkpoint(str(tmp_path), tag="missing") is None


def _jax_llama():
    return JLlama("tiny", **TINY)


def _jax_tree(engine):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(engine.params))


def test_resumed_losses_match_jax(tmp_path):
    """Both packages train 2 steps from the same weights (carried with
    ``load_jax_params``) and batches, save, and a fresh engine of each
    resumes for 2 more: the resumed losses agree within 1e-5."""
    batches = [{"input_ids": _tokens(16, s)} for s in range(4)]
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    je = jdst.initialize(model=_jax_llama(), config=_llama_cfg(),
                         rng=jax.random.PRNGKey(0))[0]
    tree = _jax_tree(je)

    def port():
        return load_jax_params(TLlama("tiny", device="cpu", **TINY), tree)

    te = tdst.initialize(model=port(), config=_llama_cfg(),
                         device="cpu")[0]
    for b in batches[:2]:
        je.train_batch(b)
        te.train_batch(b)
    je.save_checkpoint(jd)
    te.save_checkpoint(td)
    ck = {"checkpoint": {"save_dir": jd, "auto_resume": True}}
    je2 = jdst.initialize(model=_jax_llama(), config=_llama_cfg(ck),
                          rng=jax.random.PRNGKey(0))[0]
    te2 = tdst.initialize(model=port(), config=_llama_cfg(
        {"checkpoint": {"save_dir": td, "auto_resume": True}}),
        device="cpu")[0]
    assert je2.global_steps == te2.global_steps == 2
    jl = [float(je2.train_batch(b)["loss"]) for b in batches[2:]]
    tl = [float(te2.train_batch(b)["loss"]) for b in batches[2:]]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)


def test_tags_of_zero3_and_tp_load_at_stage0(tmp_path):
    """A tag saved at ZeRO-3 over 2 gloo ranks and one saved at tensor
    parallelism 2 load into a stage-0 engine on one rank: the masters
    and moments are the ranks' gathered ones bit for bit, and the
    resumed losses match the ranks' own continuation within 1e-5."""
    src = TLlama("tiny", device="cpu", seed=4, **TINY)
    cfg = _llama_cfg()
    case = {"family": "dense",
            "config": {**TINY, "norm": "rms", "activation": "silu_glu",
                       "position": "rope", "tie_embeddings": False,
                       "use_bias": False},
            "params": export_params(src), "cfg": cfg,
            "batches": [{"input_ids": _tokens(16, s)} for s in range(4)]}
    runs = {"zero3": ({"data": 2}, 3), "tp2": ({"model": 2}, 0)}
    res = torch_ranks.start_ranks(2, "ckpt_job", case, runs,
                                  str(tmp_path)).results()
    for key in runs:
        r0 = res[0][key]
        assert res[1][key]["steps"] == r0["steps"]
        e = tdst.initialize(model=load_jax_params(
            TLlama("tiny", device="cpu", **TINY), case["params"]),
            config=cfg, device="cpu")[0]
        assert e.load_checkpoint(str(tmp_path / key), tag="t") is not None
        assert e.global_steps == 2
        for n, p in e.params.items():
            np.testing.assert_array_equal(p.numpy(), r0["full"][n])
            np.testing.assert_array_equal(e.opt_state.mu[n].numpy(),
                                          r0["mu"][n])
            np.testing.assert_array_equal(e.opt_state.nu[n].numpy(),
                                          r0["nu"][n])
        steps = [float(e.train_batch(b)["loss"])
                 for b in case["batches"][2:]]
        np.testing.assert_allclose(steps, r0["steps"], rtol=1e-5)


def test_hot_swap_exports_and_loader_position(tmp_path):
    """``hot_swap_checkpoint`` flips the weights to the tag's and leaves
    step, moments and the loader's position; ``save_16bit_model`` keys
    and values are the JAX engine's on the same weights (bf16 bits), and
    ``get_fp32_state_dict`` equals JAX's bitwise; ``model_version`` rides
    in the tag."""
    je = jdst.initialize(model=_jax_llama(), config=_llama_cfg(),
                         rng=jax.random.PRNGKey(1))[0]
    tree = _jax_tree(je)
    m = load_jax_params(TLlama("tiny", device="cpu", **TINY), tree)
    data = {"input_ids": _tokens(48)}
    e, _, loader, _ = tdst.initialize(model=m, config=_llama_cfg(),
                                      training_data=data, device="cpu")
    # exports against JAX's, before any step: the same weights
    want = je.get_fp32_state_dict()
    got = export_params(e.get_fp32_state_dict())
    for (kp, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(want)[0],
            jax.tree_util.tree_flatten_with_path(got)[0]):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(kp))
    jpath = je.save_16bit_model(str(tmp_path / "j16"))
    tpath = e.save_16bit_model(str(tmp_path / "t16"))
    jz = np.load(jpath)
    tz = sio.load_file(tpath)
    assert sorted(jz.files) == sorted(tz)
    for k in jz.files:
        assert tz[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            np.asarray(jz[k]).view(np.uint16),
            tz[k].view(torch.int16).numpy().view(np.uint16), err_msg=k)
    # the swap
    d = str(tmp_path / "ck")
    it = iter(loader)
    e.train_batch(next(it))
    e.save_checkpoint(d, tag="v7", model_version=7)
    swapped = {n: p.clone() for n, p in e.params.items()}
    e.train_batch(next(it))
    moments = _opt_state(e)
    position = loader.state_dict()
    assert e.hot_swap_checkpoint(d) == 7
    for n, p in e.params.items():
        assert torch.equal(p, swapped[n])
    assert e.global_steps == 2 and loader.state_dict() == position
    for k, t in _opt_state(e).items():
        for n in t:
            assert torch.equal(t[n], moments[k][n])
    assert tck.tag_model_version(os.path.join(d, "v7")) == 7
    with pytest.raises(ValueError, match="refusing"):
        e.hot_swap_checkpoint(str(tmp_path / "nothing"))
