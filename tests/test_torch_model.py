"""Model pieces of the PyTorch port against the JAX package, on the CPU.

``rms_norm`` and ``apply_rotary`` are held to the JAX functions at fp32,
1e-6; the Llama ``Transformer``'s ``_embed`` / ``_mlp`` / ``_head`` to the
JAX model on carried weights. Also here: the presets, the weight carry's
checks, the unsupported-flag errors, the serving and training entry
points' CUDA default, and the scan showing that the port and
``chip_smoke.py`` import neither ``jax`` nor ``deepspeed_tpu``, nor does a
tensor-parallel rank process (controller and worker) load them.
"""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.models import Llama as JaxLlama
from deepspeed_tpu.models.llama import llama_config as jax_llama_config
from deepspeed_tpu.ops.norms import rms_norm as jax_rms_norm
from deepspeed_tpu.ops.rotary import (apply_rotary as jax_apply_rotary,
                                      rope_frequencies as jax_rope_frequencies)
from deepspeed_tpu_torch.checkpoint.jax_params import load_jax_params
from deepspeed_tpu_torch.inference.ragged import (RaggedConfig,
                                                  RaggedInferenceEngine)
from deepspeed_tpu_torch.models.llama import Llama, llama_config
from deepspeed_tpu_torch.ops.norms import rms_norm
from deepspeed_tpu_torch.ops.rotary import apply_rotary, rope_frequencies
from deepspeed_tpu_torch.serving.server import ServingEngine

REPO = Path(__file__).resolve().parents[1]
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, vocab_size=128,
            max_seq_len=64)


@pytest.fixture(scope="module")
def carried():
    jm = JaxLlama("tiny", use_flash=False, remat=False, **TINY)
    params = jm.init(jax.random.PRNGKey(11))
    tm = load_jax_params(Llama("tiny", device="cpu", **TINY),
                         jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    ref = jax_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_rope_frequencies_match_jax():
    got = rope_frequencies(32, 64, 10000.0)
    ref = jax_rope_frequencies(32, 64, 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("rotary_dim", [None, 16])
@pytest.mark.parametrize("with_positions", [False, True])
def test_apply_rotary_matches_jax(interleaved, rotary_dim, with_positions):
    rng = np.random.default_rng(1)
    hd = 32
    x = rng.standard_normal((2, 6, 4, hd)).astype(np.float32)
    rd = rotary_dim or hd
    pos = rng.integers(0, 64, (2, 6)).astype(np.int32) \
        if with_positions else None
    got = apply_rotary(torch.from_numpy(x), rope_frequencies(rd, 64),
                       None if pos is None else torch.from_numpy(pos),
                       rotary_dim=rotary_dim, interleaved=interleaved)
    ref = jax_apply_rotary(jnp.asarray(x), jax_rope_frequencies(rd, 64),
                           None if pos is None else jnp.asarray(pos),
                           rotary_dim=rotary_dim, interleaved=interleaved)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_embed_mlp_head_match_jax(carried):
    jm, params, tm = carried
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 128, (2, 7)).astype(np.int32)
    emb = tm._embed(torch.from_numpy(toks))
    np.testing.assert_allclose(emb.numpy(),
                               np.asarray(jm._embed(params, jnp.asarray(toks))),
                               rtol=1e-6, atol=1e-6)
    h = rng.standard_normal((2, 7, 64)).astype(np.float32)
    lp = jax.tree_util.tree_map(lambda a: a[1], params["layers"])
    jdown, _ = jm._mlp(jnp.asarray(h), lp)
    with torch.no_grad():
        down = tm._mlp(torch.from_numpy(h), tm.layers[1])
        logits = tm._head(torch.from_numpy(h))
    np.testing.assert_allclose(down.numpy(), np.asarray(jdown), rtol=1e-5,
                               atol=1e-5)
    jlogits = jm._head(params, jnp.asarray(h))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size", ["tiny", "160m", "1b", "7b", "13b", "70b"])
def test_presets_match_jax(size):
    assert dataclasses.asdict(llama_config(size)) == \
        dataclasses.asdict(jax_llama_config(size))


def test_7b_shapes():
    c = llama_config("7b")
    assert (c.d_model, c.n_layers, c.n_heads, c.n_kv_heads, c.head_dim,
            c.d_ff, c.vocab_size, c.tie_embeddings) == \
        (4096, 32, 32, 32, 128, 11008, 32000, False)


def test_init_is_seeded():
    a = Llama("tiny", device="cpu", seed=3, **TINY)
    b = Llama("tiny", device="cpu", seed=3, **TINY)
    c = Llama("tiny", device="cpu", seed=4, **TINY)
    assert torch.equal(a.layers[0].wq, b.layers[0].wq)
    assert not torch.equal(a.layers[0].wq, c.layers[0].wq)
    assert torch.all(a.layers[1].attn_norm_w == 1)
    std = a.layers[0].w_up.std().item()
    assert abs(std - 64 ** -0.5) < 0.02


@pytest.mark.parametrize("flag", [dict(tie_embeddings=True),
                                  dict(norm="layer"), dict(use_bias=True),
                                  dict(activation="gelu"),
                                  dict(position="learned"),
                                  dict(logits_softcap=30.0)])
def test_other_flags_raise(flag):
    with pytest.raises(NotImplementedError, match="later slice"):
        Llama("tiny", device="cpu", **{**TINY, **flag})
    # the KV-cache branch runs; sliding windows on it come with a later slice
    caches = (torch.zeros(2, 1, 8, 2, 16), torch.zeros(2, 1, 8, 2, 16))
    with pytest.raises(NotImplementedError, match="later slice"):
        Llama("tiny", device="cpu", **{**TINY, "attn_windows": (4, 4)})(
            torch.zeros(1, 2, dtype=torch.long), kv_caches=caches,
            cache_pos=0)


def test_weight_carry_checks_shapes_and_leaves(carried):
    _, params, _ = carried
    pnp = jax.tree_util.tree_map(np.asarray, params)
    other = Llama("tiny", device="cpu", **{**TINY, "d_model": 32})
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(other, pnp)
    missing = {**pnp, "layers": {k: v for k, v in pnp["layers"].items()
                                 if k != "w_gate"}}
    with pytest.raises(ValueError, match="w_gate"):
        load_jax_params(Llama("tiny", device="cpu", **TINY), missing)


def test_weight_carry_lands_in_the_models_dtype(carried):
    _, params, _ = carried
    m = Llama("tiny", device="cpu", dtype=torch.bfloat16, **TINY)
    load_jax_params(m, jax.tree_util.tree_map(np.asarray, params))
    assert m.layers[0].wq.dtype == torch.bfloat16
    np.testing.assert_allclose(
        m.lm_head.float().numpy(), np.asarray(params["lm_head"]),
        rtol=1e-2, atol=1e-2)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    model = Llama("tiny", device="cpu", **TINY)
    eng = RaggedInferenceEngine(
        model, RaggedConfig(token_budget=8, max_seqs=2, kv_block_size=4,
                            n_kv_blocks=8, max_context=32,
                            dtype=torch.float32), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Llama("tiny", **TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RaggedInferenceEngine(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(eng, start=False)
    ServingEngine(eng, start=False, device="cpu")


def test_trainer_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.config import Config
    from deepspeed_tpu_torch.runtime.engine import TrainEngine

    model = Llama("tiny", device="cpu", **TINY)
    cfg = {"train_batch_size": 2}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.initialize(model=model, config=cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrainEngine(loss_fn=lambda p, b: model.loss(b, params=p),
                    params=dict(model.named_parameters()),
                    config=Config.from_dict(cfg))
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                                device="cpu")
    assert engine.device == torch.device("cpu")


def _port_sources():
    files = sorted((REPO / "deepspeed_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return any(module == p or module.startswith(p + ".")
               for p in ("jax", "jaxlib", "deepspeed_tpu"))


def test_port_imports_neither_jax_nor_the_jax_package():
    bad = []
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif (isinstance(node, ast.Call)
                  and getattr(node.func, "attr", getattr(node.func, "id", ""))
                  in ("import_module", "__import__") and node.args
                  and isinstance(node.args[0], ast.Constant)):
                names = [str(node.args[0].value)]
            bad += [f"{path.relative_to(REPO)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert len(_port_sources()) > 10
    assert bad == []


def test_importing_the_port_loads_no_jax():
    mods = sorted(".".join(p.relative_to(REPO).with_suffix("").parts)
                  for p in (REPO / "deepspeed_tpu_torch").rglob("*.py"))
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'deepspeed_tpu')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def test_a_tensor_parallel_rank_loads_no_jax():
    """The worker entry point too: two gloo rank processes serve a
    tensor-parallel engine (the controller's generate, the worker's
    serve_worker) and report the JAX modules they loaded."""
    from torch_ranks import start_ranks

    assert start_ranks(2, "tp_import_job", timeout=120).results() == [[], []]
