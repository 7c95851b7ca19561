"""Training the decoder families of the PyTorch port against the JAX
``TrainEngine``, on the CPU, at tiny sizes in fp32.

Every leaf of a JAX parameter tree is perturbed from a numpy seed (the JAX
init's zero biases and unit norms would hide a dropped term) and carried
into the port with ``load_jax_params``. Both packages' ``initialize``
build an engine on the same weights (GAS 2, AdamW with weight decay, a
warmup/decay schedule, clipping at 0.5) and take three ``train_batch``
steps on one batch of numpy tokens: per-step loss and grad norm within 1e-5
relative, and the weights after the steps within 2e-5 absolute except
near-eps elements (``tests/torch_train_parity.py``).

Cases: GPT-2 (tied head, learned positions), OPT (ReLU, untied), GPT-Neo
(per-layer windows that vary and bind: the plain attention), the GPT-J
flag set (parallel residual, partial interleaved RoPE) and the Bloom flag
set (ALiBi at 6 heads, embedding norm), each with ``remat`` and the flash
path's plain version; OPT with ``loss_chunk_size`` > 0; GPT-2 in fp16
with dynamic loss scaling (the same skipped steps and loss scales as the
JAX engine).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.models.transformer import (
    Transformer as JaxTransformer, TransformerConfig as JaxConfig)
from deepspeed_tpu_torch.checkpoint.jax_params import load_jax_params
from deepspeed_tpu_torch.models import gpt2
from deepspeed_tpu_torch.models.transformer import (Transformer,
                                                    TransformerConfig)

from torch_train_parity import CFG, assert_parity, run_both

SMALL = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4,
             max_seq_len=32, remat=True, use_flash=True)
RAW_GPTJ = dict(norm="layer", activation="gelu", position="rope",
                rope_pct=0.25, rope_interleaved=True, parallel_residual=True,
                tie_embeddings=False, use_bias=True, qkv_bias=False,
                attn_o_bias=False, norm_eps=1e-5)
RAW_BLOOM = dict(norm="layer", activation="gelu", position="alibi",
                 embed_norm=True, tie_embeddings=True, use_bias=True,
                 norm_eps=1e-5, d_model=48, n_heads=6)
# name -> (preset family, size, overrides of SMALL)
FLAGSETS = {
    "gpt2": ("gpt2", "tiny", {}),
    "opt": ("opt", "125m", {}),
    "gpt_neo": ("gpt_neo", "tiny", {"attn_windows": (0, 6)}),
    "gptj": ("raw", None, RAW_GPTJ),
    "bloom": ("raw", None, RAW_BLOOM),
}
PRESETS = {"gpt2": (jax_gpt2.gpt2_config, gpt2.gpt2_config),
           "opt": (jax_gpt2.opt_config, gpt2.opt_config),
           "gpt_neo": (jax_gpt2.gpt_neo_config, gpt2.gpt_neo_config),
           "raw": (lambda _, **kw: JaxConfig(**kw),
                   lambda _, **kw: TransformerConfig(**kw))}


def _perturbed(params, seed):
    """The JAX tree with N(0, 0.05^2) added to every leaf, as numpy."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape))
        .astype(np.float32), params)


def _models(name, seed=0, **extra):
    family, size, over = FLAGSETS[name]
    kw = {**SMALL, **over, **extra}
    jc, tc = PRESETS[family]
    jm = JaxTransformer(jc(size, **kw))
    pnp = _perturbed(jm.init(jax.random.PRNGKey(seed)), seed)
    params = jax.tree_util.tree_map(jnp.asarray, pnp)
    tm = load_jax_params(Transformer(tc(size, **kw), device="cpu"), pnp)
    return jm, params, tm


def _batches(seed, steps=3, s=16):
    """One batch of tokens, ``steps`` times: the loss must fall."""
    toks = np.random.default_rng(seed).integers(0, 97, (4, s))
    return [{"input_ids": toks.astype(np.int32)}] * steps


@pytest.mark.parametrize("name,extra", [
    ("gpt2", {}), ("opt", {}), ("gpt_neo", {}), ("gptj", {}),
    ("bloom", {}), ("opt", {"loss_chunk_size": 5})],
    ids=["gpt2", "opt", "gpt_neo", "gptj", "bloom", "opt_chunked"])
def test_three_steps_match_jax_engine(name, extra):
    jm, params, tm = _models(name, seed=3, **extra)
    if name == "gpt_neo":       # the windows vary and bind at 16 tokens
        assert tm._dense_windows(16) == ((0, 6), True)
    jeng, teng, steps, small = run_both(jm, params, tm, _batches(30))
    assert_parity(jeng, teng, steps, small)
    assert max(t["grad_norm"] for _, t in steps) > CFG["gradient_clipping"]
    assert steps[-1][1]["loss"] < steps[0][1]["loss"]
    assert teng.micro_steps == 6
    # the tied head's table collects the embedding's and the head's
    # gradients; the model was fp32 on the engine's device: it trained in
    # place
    assert teng.params["tok_embed"].data_ptr() == tm.tok_embed.data_ptr()


def test_fp16_loss_scaling_matches_jax_engine():
    cfg = {"train_batch_size": 4, "gradient_clipping": 1.0,
           "optimizer": {"type": "adam", "params": {"lr": 1e-3}},
           "fp16": {"enabled": True, "initial_scale_power": 40,
                    "hysteresis": 2}}
    jm, params, tm = _models("gpt2", seed=4, remat=False, use_flash=False)
    _, teng, steps, _ = run_both(jm, params, tm, _batches(31, steps=4),
                                 cfg=cfg)
    # a 2^40 loss scale overflows fp16: skip, consume hysteresis, back off
    assert [t["skipped"] for _, t in steps] == \
        [j["skipped"] for j, _ in steps]
    assert [t["loss_scale"] for _, t in steps] == \
        [j["loss_scale"] for j, _ in steps]
    assert steps[0][1]["skipped"] == 1
    assert teng.skipped_steps == sum(t["skipped"] for _, t in steps)
    for j, t in steps:
        if not t["skipped"]:
            np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-3)
