"""Hugging Face checkpoints in and out of the port (``checkpoint/hf.py``,
``checkpoint/export.py``, ``checkpoint/safetensors_io.py``) held to the
JAX package and to ``transformers`` / ``safetensors``.

Tiny random HF models of every family (2 layers, d 64) are written by
``transformers``; the port's ``map_hf_params`` must equal JAX's bit for
bit (bf16 compared as bits), ``from_pretrained`` logits JAX's within
1e-5 at fp32 (1e-4 through the v1 engine, whose greedy streams must
agree), exports must round-trip through ``transformers`` and both
packages' readers, a TP-2 load must cut each rank's shards, and the
codec must read ``safetensors``' files and write files it reads, bit for
bit, for every dtype.
"""

import json
import os

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
safetensors = pytest.importorskip("safetensors")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from safetensors import safe_open  # noqa: E402
from safetensors.torch import save_file as st_save  # noqa: E402

import deepspeed_tpu as jdst  # noqa: E402
import deepspeed_tpu_torch as tdst  # noqa: E402
from deepspeed_tpu.checkpoint import export as jexport  # noqa: E402
from deepspeed_tpu.checkpoint import hf as jhf  # noqa: E402
from deepspeed_tpu_torch.checkpoint import export as texport  # noqa: E402
from deepspeed_tpu_torch.checkpoint import hf as thf  # noqa: E402
from deepspeed_tpu_torch.checkpoint import safetensors_io as sio  # noqa: E402

import torch_ranks  # noqa: E402

T = transformers


def _clip_config():
    return T.CLIPConfig(
        text_config=dict(vocab_size=256, hidden_size=64,
                         intermediate_size=128, num_hidden_layers=2,
                         num_attention_heads=4, max_position_embeddings=16),
        vision_config=dict(hidden_size=64, intermediate_size=128,
                           num_hidden_layers=2, num_attention_heads=4,
                           image_size=32, patch_size=8),
        projection_dim=32)


FAMILIES = {
    "llama": lambda: T.LlamaForCausalLM(T.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=176,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rms_norm_eps=1e-6,
        tie_word_embeddings=False)),
    "gpt2": lambda: T.GPT2LMHeadModel(T.GPT2Config(
        vocab_size=256, n_embd=64, n_layer=2, n_head=4, n_positions=128)),
    "opt": lambda: T.OPTForCausalLM(T.OPTConfig(
        vocab_size=256, hidden_size=64, ffn_dim=256, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=128,
        activation_function="relu", do_layer_norm_before=True,
        word_embed_proj_dim=64)),
    "mixtral": lambda: T.MixtralForCausalLM(T.MixtralConfig(
        vocab_size=256, hidden_size=64, intermediate_size=112,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=128, rms_norm_eps=1e-6,
        attn_implementation="eager", tie_word_embeddings=False)),
    "bloom": lambda: T.BloomForCausalLM(T.BloomConfig(
        vocab_size=256, hidden_size=64, n_layer=2, n_head=4,
        layer_norm_epsilon=1e-5)),
    "gptj": lambda: T.GPTJForCausalLM(T.GPTJConfig(
        vocab_size=256, n_embd=64, n_layer=2, n_head=4, n_positions=128,
        rotary_dim=8, n_inner=256)),
    "gpt_neox": lambda: T.GPTNeoXForCausalLM(T.GPTNeoXConfig(
        vocab_size=256, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=256,
        max_position_embeddings=128, rotary_pct=0.5,
        use_parallel_residual=True)),
    "falcon": lambda: T.FalconForCausalLM(T.FalconConfig(
        vocab_size=256, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, multi_query=True, parallel_attn=True,
        new_decoder_architecture=False, alibi=False, bias=False,
        max_position_embeddings=128)),
    "gpt_neo": lambda: T.GPTNeoForCausalLM(T.GPTNeoConfig(
        vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
        intermediate_size=256, max_position_embeddings=128,
        attention_types=[[["global", "local"], 1]], window_size=8)),
    "bert": lambda: T.BertForMaskedLM(T.BertConfig(
        vocab_size=256, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=256,
        max_position_embeddings=128, type_vocab_size=2)),
    "distilbert": lambda: T.DistilBertForMaskedLM(T.DistilBertConfig(
        vocab_size=256, dim=64, n_layers=2, n_heads=4, hidden_dim=256,
        max_position_embeddings=128)),
    "clip": lambda: T.CLIPModel(_clip_config()),
}


def _save(tmp_path, family, *, safe=True, dtype=torch.float32,
          shard=None, name=None):
    torch.manual_seed(0)
    m = FAMILIES[family]().eval()
    if family == "gptj":     # make the LM-head bias count
        with torch.no_grad():
            m.lm_head.bias.normal_(0, 0.5)
    m = m.to(dtype)
    d = tmp_path / (name or family)
    kw = {"max_shard_size": shard} if shard else {}
    m.save_pretrained(str(d), safe_serialization=safe, **kw)
    return m, str(d)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _bits(a):
    """A leaf's bytes as an integer array (bf16 / fp32 compared as bits)."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy().view(np.uint32) if a.dtype == torch.float32 \
            else a.numpy()
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _same_trees(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert set(g) == set(w), sorted(set(g) ^ set(w))
    for k in w:
        assert tuple(g[k].shape) == tuple(np.shape(w[k])), k
        np.testing.assert_array_equal(_bits(g[k]), _bits(w[k]), err_msg=k)


def _tokens(seed=0, rows=2, n=16):
    return np.random.default_rng(seed).integers(1, 250, (rows, n)).astype(
        np.int32)


def _pixels():
    return np.random.default_rng(4).standard_normal(
        (2, 3, 32, 32)).astype(np.float32)


def _port_out(model, family, tokens):
    ids = torch.from_numpy(tokens).long()
    with torch.no_grad():
        if family == "clip":
            return [model.encode_text(ids).numpy(),
                    model.encode_image(torch.from_numpy(_pixels())).numpy()]
        return [model.apply(ids).numpy()]


def _jax_out(model, params, family, tokens):
    if family == "clip":
        return [np.asarray(model.encode_text(params, jnp.asarray(tokens))),
                np.asarray(model.encode_image(params,
                                              jnp.asarray(_pixels())))]
    return [np.asarray(model.apply(params, jnp.asarray(tokens)))]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_map_and_logits_match_jax(tmp_path, family):
    """The port's ``hf_config`` / ``map_hf_params`` equal JAX's (every
    leaf bitwise) and ``from_pretrained``'s fp32 logits (CLIP: text and
    image embeddings) equal JAX's within 1e-5; the config fields match."""
    _, d = _save(tmp_path, family)
    jfam, jcfg = jhf.hf_config(d)
    tfam, tcfg = thf.hf_config(d)
    assert jfam == tfam
    if family != "clip":
        assert {k: v for k, v in vars(tcfg).items()} == {
            k: v for k, v in vars(jcfg).items()}
    _same_trees(thf.map_hf_params(thf.read_hf_state(d), tfam, tcfg),
                jhf.map_hf_params(jhf.read_hf_state(d), jfam, jcfg))
    model, params = thf.from_pretrained(d, dtype=torch.float32,
                                        device="cpu")
    assert dict(model.named_parameters()).keys() == params.keys()
    assert all(p.dtype == torch.float32 for p in params.values())
    jm, jp = jhf.from_pretrained(d, dtype=jnp.float32)
    tokens = _tokens()
    for got, want in zip(_port_out(model, family, tokens),
                         _jax_out(jm, jp, family, tokens)):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_gptj_head_bias_is_carried(tmp_path):
    """GPT-J's LM-head bias becomes ``lm_head_b``: the logits move with
    it and match ``transformers``' forward."""
    hf, d = _save(tmp_path, "gptj")
    model, params = thf.from_pretrained(d, dtype=torch.float32,
                                        device="cpu")
    assert torch.equal(params["lm_head_b"], hf.lm_head.bias.detach())
    tokens = _tokens(1)
    with torch.no_grad():
        want = hf(torch.from_numpy(tokens).long()).logits.numpy()
    np.testing.assert_allclose(_port_out(model, "gptj", tokens)[0], want,
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("safe", [True, False], ids=["safetensors", "bin"])
def test_bf16_checkpoint_is_read_bit_exact(tmp_path, safe):
    """A bf16 checkpoint (safetensors, or a sharded torch pickle) is read
    and mapped in bf16, bit for bit JAX's ml_dtypes arrays, and loads
    into a bf16 model without an fp32 round trip."""
    hf, d = _save(tmp_path, "llama", safe=safe, dtype=torch.bfloat16,
                  shard=None if safe else "100KB")
    if not safe:
        assert os.path.isfile(os.path.join(d, "pytorch_model.bin.index.json"))
    state = thf.read_hf_state(d)
    assert {t.dtype for t in state.values()} == {torch.bfloat16}
    w = hf.model.embed_tokens.weight.detach()
    assert torch.equal(state["model.embed_tokens.weight"].view(torch.int16),
                       w.view(torch.int16))
    fam, cfg = thf.hf_config(d)
    jfam, jcfg = jhf.hf_config(d)
    _same_trees(thf.map_hf_params(state, fam, cfg),
                jhf.map_hf_params(jhf.read_hf_state(d), jfam, jcfg))
    model, params = thf.from_pretrained(d, dtype=torch.bfloat16,
                                        device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in params.values())
    assert torch.equal(params["layers.1.wq"].view(torch.int16),
                       hf.model.layers[1].self_attn.q_proj.weight.detach()
                       .t().contiguous().view(torch.int16))


def test_engine_streams_and_logits_match_jax(tmp_path):
    """``init_inference(config={"checkpoint": dir})`` on both packages:
    the v1 engines' forward logits within 1e-4 and their greedy streams
    equal; a missing directory raises as JAX's does."""
    _, d = _save(tmp_path, "llama")
    teng = tdst.init_inference(config={"checkpoint": d, "dtype": "float32",
                                       "temperature": 0.0}, device="cpu")
    jeng = jdst.init_inference(config={"checkpoint": d, "dtype": "fp32",
                                       "temperature": 0.0})
    tokens = _tokens(2)
    np.testing.assert_allclose(
        teng.forward(torch.from_numpy(tokens).long()).numpy(),
        np.asarray(jeng.forward(jnp.asarray(tokens))), rtol=1e-4, atol=1e-4)
    prompt = _tokens(3, rows=1, n=8)
    np.testing.assert_array_equal(
        np.asarray(teng.generate(torch.from_numpy(prompt).long(),
                                 max_new_tokens=8)),
        np.asarray(jeng.generate(prompt, max_new_tokens=8)))
    with pytest.raises(FileNotFoundError):
        jdst.init_inference(config={"checkpoint": str(tmp_path / "none")})
    with pytest.raises(FileNotFoundError):
        tdst.init_inference(config={"checkpoint": str(tmp_path / "none")},
                            device="cpu")


def _st(path):
    """Every tensor of a safetensors file or directory, read by
    ``safetensors`` itself."""
    files = [path] if path.endswith(".safetensors") else [
        os.path.join(path, f) for f in sorted(os.listdir(path))
        if f.endswith(".safetensors")]
    out = {}
    for f in files:
        with safe_open(f, framework="pt") as h:
            out.update({k: h.get_tensor(k) for k in h.keys()})
    return out


@pytest.mark.parametrize("family,exporter", [
    ("llama", "export_hf_llama"), ("gpt2", "export_hf_gpt2"),
    ("mixtral", "export_hf_mixtral")])
def test_export_round_trips(tmp_path, family, exporter):
    """The port's export of a loaded model: the files hold JAX's export
    of the same weights bit for bit (read by ``safetensors``),
    ``transformers`` reproduces the original logits, and a sharded export
    (index + 2 or more shards) reads back into the same weights."""
    hf, d = _save(tmp_path, family)
    model, params = thf.from_pretrained(d, dtype=torch.float32,
                                        device="cpu")
    out = str(tmp_path / "port")
    getattr(texport, exporter)(model, None, out)
    jm, jp = jhf.from_pretrained(d, dtype=jnp.float32)
    jout = str(tmp_path / "jax")
    getattr(jexport, exporter)(jm, jp, jout)
    got, want = _st(out), _st(jout)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    cls = type(hf)
    kw = {"attn_implementation": "eager"} if family == "mixtral" else {}
    hf2 = cls.from_pretrained(out, **kw).eval()
    tokens = torch.from_numpy(_tokens(5)).long()
    with torch.no_grad():
        np.testing.assert_allclose(hf2(tokens).logits.numpy(),
                                   hf(tokens).logits.numpy(),
                                   rtol=2e-3, atol=2e-3)
    sharded = str(tmp_path / "sharded")
    getattr(texport, exporter)(model, params, sharded,
                               max_shard_bytes=200_000)
    with open(os.path.join(sharded, sio.INDEX_FILE)) as f:
        shards = set(json.load(f)["weight_map"].values())
    assert len(shards) >= 2
    _, back = thf.from_pretrained(sharded, dtype=torch.float32,
                                  device="cpu")
    for n, p in params.items():
        assert torch.equal(back[n], p), n


def test_tp2_load_cuts_each_rank(tmp_path):
    """``from_pretrained`` over a model axis of 2 (two gloo ranks): each
    rank's leaves are its slices of the one-device load (``lm_head_b``
    too), the logits equal the one-device logits within 2e-5, and
    ``init_inference`` with ``tensor_parallel: 2`` streams as one device
    does."""
    dirs = {f: _save(tmp_path, f)[1] for f in ("llama", "gptj")}
    tokens = _tokens(6, n=12)
    res = torch_ranks.start_ranks(2, "hf_tp_job", dirs, tokens).results()
    ids = torch.from_numpy(tokens).long()
    for key, d in dirs.items():
        model, params = thf.from_pretrained(d, dtype=torch.float32,
                                            device="cpu")
        with torch.no_grad():
            want = model.apply(ids).numpy()
        eng = tdst.init_inference(config={"checkpoint": d,
                                          "dtype": "float32"}, device="cpu")
        stream = np.asarray(eng.generate(ids[:1, :8], max_new_tokens=6))
        for rank, r in enumerate(res):
            got = r[key]
            np.testing.assert_allclose(got["logits"], want, rtol=2e-5,
                                       atol=2e-5)
            np.testing.assert_array_equal(got["stream"], stream)
            for n, p in params.items():
                spec = model.leaf_spec(n)
                piece = p.numpy()
                if "model" in spec:
                    dim = list(spec).index("model")
                    piece = np.split(piece, 2, axis=dim)[rank]
                np.testing.assert_array_equal(got["leaves"][n], piece,
                                              err_msg=f"{key} {n}")


# ----------------------------------------------------------------------
# the codec against safetensors

def _every_dtype():
    g = torch.Generator().manual_seed(0)
    return {"f32": torch.randn(3, 5, generator=g),
            "f16": torch.randn(4, 2, generator=g).half(),
            "bf16": torch.randn(7, generator=g).bfloat16(),
            "f64": torch.randn(2, generator=g).double(),
            "i64": torch.arange(6).reshape(2, 3),
            "i32": torch.arange(5, dtype=torch.int32),
            "i16": torch.arange(-3, 3, dtype=torch.int16),
            "i8": torch.arange(-4, 4, dtype=torch.int8),
            "u8": torch.arange(9, dtype=torch.uint8).reshape(3, 3),
            "bool": torch.tensor([True, False, True]),
            "scalar": torch.tensor(2.5),
            "scalar_bf16": torch.tensor(-1.25).bfloat16(),
            "empty": torch.empty(0, 4),
            "empty_i8": torch.empty(3, 0, dtype=torch.int8)}


def _equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and (
        a.numel() == 0 or torch.equal(a.reshape(-1).view(torch.uint8),
                                      b.reshape(-1).view(torch.uint8)))


def test_codec_files_read_by_safetensors(tmp_path):
    ts = _every_dtype()
    path = str(tmp_path / "x.safetensors")
    sio.save_file(ts, path, {"format": "pt", "k": "v"})
    with safe_open(path, framework="pt") as f:
        assert set(f.keys()) == set(ts)
        assert f.metadata() == {"format": "pt", "k": "v"}
        for k in f.keys():
            assert _equal(f.get_tensor(k), ts[k]), k


def test_codec_reads_safetensors_files(tmp_path):
    ts = _every_dtype()
    path = str(tmp_path / "y.safetensors")
    st_save(ts, path, metadata={"a": "b"})
    got = sio.load_file(path)
    assert set(got) == set(ts) and sio.metadata(path) == {"a": "b"}
    for k, v in ts.items():
        assert _equal(got[k], v), k
    assert set(sio.load_file(path, names=["f32", "bool"])) == {"f32", "bool"}


def test_codec_sharded_index_both_ways(tmp_path):
    """A sharded directory the codec writes reads back through
    ``safetensors`` (and its index names every tensor), and one written
    by ``safetensors`` with an index reads through ``read_hf_state``."""
    ts = {f"t{i}": torch.randn(64, 64) for i in range(6)}
    ours = tmp_path / "ours"
    ours.mkdir()
    files = sio.save_sharded(ts, str(ours), max_shard_bytes=40_000)
    assert len(files) >= 2
    with open(ours / sio.INDEX_FILE) as f:
        assert set(json.load(f)["weight_map"]) == set(ts)
    got = _st(str(ours))
    assert all(_equal(got[k], v) for k, v in ts.items())
    theirs = tmp_path / "theirs"
    theirs.mkdir()
    weight_map = {}
    for i, names in enumerate((["t0", "t1", "t2"], ["t3", "t4", "t5"])):
        fname = f"model-{i + 1:05d}-of-00002.safetensors"
        st_save({n: ts[n] for n in names}, str(theirs / fname))
        weight_map.update({n: fname for n in names})
    (theirs / sio.INDEX_FILE).write_text(json.dumps(
        {"metadata": {}, "weight_map": weight_map}))
    back = thf.read_hf_state(str(theirs))
    assert all(_equal(back[k], v) for k, v in ts.items())


def test_codec_refuses_a_truncated_file(tmp_path):
    path = str(tmp_path / "t.safetensors")
    sio.save_file({"a": torch.randn(100)}, path)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 8)
    with pytest.raises(ValueError, match="offsets"):
        sio.load_file(path)


def test_port_modules_import_none_of_the_forbidden_packages():
    """The new modules' imports: no jax, orbax, ml_dtypes, safetensors or
    transformers, nothing of the JAX package."""
    import ast
    from pathlib import Path

    root = Path(tdst.__file__).parent
    banned = ("jax", "orbax", "ml_dtypes", "safetensors", "transformers",
              "deepspeed_tpu")
    for rel in ("checkpoint/hf.py", "checkpoint/export.py",
                "checkpoint/safetensors_io.py", "checkpoint/diffusers.py",
                "runtime/checkpoint.py", "runtime/engine.py",
                "launcher/agent.py", "resilience/divergence.py"):
        tree = ast.parse((root / rel).read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in banned, (rel, n)
