"""Training the encoder families and GPT-MoE of the PyTorch port against
the JAX ``TrainEngine``, on the CPU, at tiny sizes in fp32.

As ``tests/test_torch_train_families.py``: every JAX leaf perturbed from a
numpy seed and carried with ``load_jax_params``, both packages'
``initialize``, three ``train_batch`` steps of GAS 2 on one numpy batch,
held with ``tests/torch_train_parity.py`` (loss and grad norm within 1e-5,
weights within 2e-5 except near-eps elements).

* BERT MLM with ``labels`` / ``loss_mask`` on about 15 % of the real
  positions, two segments in ``token_type_ids`` and a padded
  ``attention_mask`` (the plain masked attention); the pooler, which the
  MLM loss never reads, gets zero gradients as ``jax.grad`` gives it.
  DistilBERT without a mask (the flash path's plain version,
  non-causal). CLIP's symmetric InfoNCE through both towers with remat;
  the projections and ``logit_scale`` get gradients.
* GPT-MoE on the capacity route, top-1 and top-2, with a capacity that
  must drop tokens and the weighted aux loss in the loss, noise-free gate.
* A noisy gate (``RSample``, ``Jitter``) against itself: the draws cannot
  match JAX's, so the same ``seed`` gives bitwise-equal steps twice,
  another seed other losses, and a step with remat the gradients of one
  without (the replay redraws the same noise).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu_torch
from deepspeed_tpu.models import bert as jax_bert
from deepspeed_tpu.models import clip as jax_clip
from deepspeed_tpu.models import moe as jax_moe_models
from deepspeed_tpu.models.transformer import Transformer as JaxTransformer
from deepspeed_tpu_torch.checkpoint.jax_params import load_jax_params
from deepspeed_tpu_torch.models import bert, clip
from deepspeed_tpu_torch.models import moe as moe_models
from deepspeed_tpu_torch.models.transformer import Transformer
from deepspeed_tpu_torch.parallel import moe
from deepspeed_tpu_torch.runtime import optimizers as opt

from torch_train_parity import CFG, assert_parity, run_both

BERTS = {"bert": (jax_bert.bert_config, bert.bert_config),
         "distilbert": (jax_bert.distilbert_config, bert.distilbert_config)}
ENC = dict(vocab_size=97, max_seq_len=32, remat=True)
TEXT = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, d_ff=128,
            max_seq_len=16, remat=True)
VISION = dict(d_model=64, n_layers=2, n_heads=4, d_ff=128, remat=True)
PIXELS = dict(proj_dim=32, image_size=32, patch_size=8)
# the encoders train at a tenth of CFG's lr: post-LN blocks and the InfoNCE
# logit scale (exp(log(1 / 0.07)) = 14.3) amplify the two packages' 1e-6
# gradient rounding step by step, which at lr 1e-2 reaches 1.7e-5 in the
# third loss
SLOW = {**CFG, "optimizer": {"type": "adamw",
                             "params": {"lr": 1e-3, "weight_decay": 0.1}},
        "scheduler": {"type": "WarmupDecayLR",
                      "params": {"total_num_steps": 10,
                                 "warmup_num_steps": 2,
                                 "warmup_max_lr": 1e-3}}}
# a capacity that drops: top-1 has 4 x 2 slots for 16 tokens a row, top-2
# 4 x 4 slots for 32 choices
MOE = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, max_seq_len=32,
           remat=True, use_flash=True, capacity_factor=0.5, min_capacity=1)


def _perturbed(params, seed):
    """The JAX tree with N(0, 0.05^2) added to every leaf, as numpy."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a)))
        .astype(np.float32), params)


def _carry(jm, port, seed):
    pnp = _perturbed(jm.init(jax.random.PRNGKey(seed)), seed)
    return jax.tree_util.tree_map(jnp.asarray, pnp), load_jax_params(port,
                                                                     pnp)


def _mlm_batch(seed, b=4, s=16, padded=True):
    """ids, labels, a loss mask on ~15 % of the real positions (at least
    one a row), two segments and (``padded``) a padding mask."""
    rng = np.random.default_rng(seed)
    lens = np.array([s, 12, 9, s] if padded else [s] * b)
    real = np.arange(s)[None, :] < lens[:, None]
    pick = (rng.random((b, s)) < 0.15) & real
    pick[:, 1] = True
    batch = {"input_ids": rng.integers(0, 97, (b, s)).astype(np.int32),
             "labels": rng.integers(0, 97, (b, s)).astype(np.int32),
             "loss_mask": pick.astype(np.float32)}
    if padded:
        batch["attention_mask"] = real.astype(np.int32)
        batch["token_type_ids"] = ((np.arange(s)[None, :] >= lens[:, None]
                                    // 2) & real).astype(np.int32)
    return batch


@pytest.mark.parametrize("family", ["bert", "distilbert"])
def test_mlm_three_steps_match_jax_engine(family):
    jc, tc = BERTS[family]
    jm = JaxTransformer(jc("tiny", **ENC))
    params, tm = _carry(jm, Transformer(tc("tiny", **ENC), device="cpu"), 5)
    batch = _mlm_batch(40, padded=family == "bert")
    jeng, teng, steps, small = run_both(jm, params, tm, [batch] * 3,
                                        cfg=SLOW)
    assert_parity(jeng, teng, steps, small)
    assert steps[-1][1]["loss"] < steps[0][1]["loss"]
    assert max(t["grad_norm"] for _, t in steps) > CFG["gradient_clipping"]
    if family == "bert":
        assert small["pooler_w"][1] == small["pooler_b"][1] == 0.0
        assert small["type_embed"][1] > 0


def _clip_batch(seed, n=4):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, 90, (n, 16))
    toks[np.arange(n), rng.integers(4, 16, n)] = 96   # argmax pooling's EOS
    pixels = rng.standard_normal((n, 3, 32, 32)).astype(np.float32)
    return {"input_ids": toks.astype(np.int32), "pixel_values": pixels}


def test_clip_three_steps_match_jax_engine():
    jcfg = jax_clip.CLIPConfig(jax_clip.clip_text_config(**TEXT),
                               jax_clip.clip_vision_config(**VISION),
                               **PIXELS)
    tcfg = clip.CLIPConfig(clip.clip_text_config(**TEXT),
                           clip.clip_vision_config(**VISION), **PIXELS)
    jm = jax_clip.CLIP(jcfg)
    params, tm = _carry(jm, clip.CLIP(tcfg, device="cpu"), 6)
    jeng, teng, steps, small = run_both(jm, params, tm, [_clip_batch(41)] * 3,
                                        cfg=SLOW)
    assert_parity(jeng, teng, steps, small)
    assert steps[-1][1]["loss"] < steps[0][1]["loss"]
    for name in ("text_proj", "vision_proj", "logit_scale",
                 "vision.patch_w", "text.tok_embed"):
        assert small[name][1] > 0, name
    # the engine trained the model's own weights: CLIP read them through
    # ``params``
    assert teng.params["text_proj"].data_ptr() == tm.text_proj.data_ptr()


def _moe_models(seed, **extra):
    kw = {**MOE, **extra}
    jm = jax_moe_models.MoETransformer(
        jax_moe_models.gpt_moe_config("tiny", 4, **kw))
    tc = moe_models.gpt_moe_config("tiny", 4, **kw)
    params, tm = _carry(jm, moe_models.MoETransformer(tc, device="cpu"),
                        seed)
    return jm, params, tm


def _tokens(seed, b=4, s=16):
    return {"input_ids": np.random.default_rng(seed).integers(
        0, 97, (b, s)).astype(np.int32)}


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_capacity_route_three_steps_match_jax_engine(top_k):
    jm, params, tm = _moe_models(7, top_k=top_k)
    gate = tm.config.gate_config()
    cap = moe.capacity(16, gate, training=True)
    assert cap * gate.n_experts < 16 * top_k          # the route drops
    batch = _tokens(42)
    # the loss carries the weighted aux loss of the capacity route
    with torch.no_grad():
        ids = torch.from_numpy(batch["input_ids"][:2])
        _, aux = tm.apply(ids, training=True, return_aux=True)
    assert float(aux) > 0
    jeng, teng, steps, small = run_both(jm, params, tm, [batch] * 3)
    assert_parity(jeng, teng, steps, small)
    assert steps[-1][1]["loss"] < steps[0][1]["loss"]
    assert small["layers.0.wg"][1] > 0


def _port_steps(seed, policy, steps=2, **extra):
    """(per-step (loss, grad norm), final weights, first step's gradients)
    of the port alone on a noisy-gate GPT-MoE."""
    tm = moe_models.MoETransformer(moe_models.gpt_moe_config(
        "tiny", 4, noisy_gate_policy=policy, **{**MOE, **extra}),
        device="cpu", seed=2)
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=tm, config={**CFG, "seed": seed}, device="cpu")
    grads = []
    inner = eng.optimizer

    def update(g, state, params):
        grads.append({n: t.clone() for n, t in g.items()})
        return inner.update(g, state, params)

    eng.optimizer = opt.Transform(inner.init, update)
    out = [eng.train_batch({k: torch.from_numpy(v)
                            for k, v in _tokens(43).items()})
           for _ in range(steps)]
    return ([(m["loss"], m["grad_norm"]) for m in out],
            {n: p.clone() for n, p in eng.params.items()}, grads[0])


@pytest.mark.parametrize("policy", ["RSample", "Jitter"])
def test_noisy_gate_is_seeded_by_the_engine(policy):
    a_steps, a_params, _ = _port_steps(5, policy)
    b_steps, b_params, _ = _port_steps(5, policy)
    assert all(torch.equal(x, y) for s, t in zip(a_steps, b_steps)
               for x, y in zip(s, t))
    assert all(torch.equal(a_params[n], b_params[n]) for n in a_params)
    c_steps, _, _ = _port_steps(6, policy)
    assert not torch.equal(a_steps[0][0], c_steps[0][0])


@pytest.mark.parametrize("policy", ["RSample", "Jitter"])
def test_noisy_gate_remat_replays_the_same_noise(policy):
    on = _port_steps(5, policy, steps=1, remat=True)
    off = _port_steps(5, policy, steps=1, remat=False)
    torch.testing.assert_close(on[0][0][0], off[0][0][0], rtol=0, atol=0)
    for name, g in on[2].items():
        torch.testing.assert_close(g, off[2][name], rtol=1e-6, atol=1e-7,
                                   msg=name)
