"""Stable Diffusion in the PyTorch port against the JAX package, on the CPU,
at tiny sizes in fp32.

The same numpy-seeded inputs and the same weights (a JAX ``init`` with
every leaf perturbed from a numpy seed, so that a dropped bias or norm
term would show, carried with ``load_jax_params``) go through both
packages. Held to the JAX package:

* ``ops.norms.group_norm`` (eps 1e-5 / 1e-6, 8 and 32 groups) within
  4e-6 (a few ulps of outputs up to ~4), and each block
  (``resnet_block`` with and without shortcut and ``temb``,
  ``transformer_2d``, ``_attention``, ``_geglu_ff``, ``downsample``,
  ``downsample_asym``, ``upsample``) within 1e-5; ``_attention`` with a
  bf16 ``ctx`` against fp32 q (JAX's einsum promotes, the port casts)
  within 1e-4;
* the tiny UNet of ``tests/test_diffusion.py`` and a tuple-heads variant,
  the VAE ``encode`` / ``decode``, within 2e-5 (the JAX suite holds
  itself to the torch reference at 2e-4);
* ``DDIMSchedule.arrays()`` bitwise, the constant-eps DDIM step of
  ``tests/test_diffusion.py`` within 1e-6, and a 3-step pipeline from
  JAX's own latent draw (latents up to 12.5 within 1e-4, measured 3.8e-5;
  the decoded image within 2e-5, measured 5.6e-6);
* ``timestep_embedding`` within 1e-4 (one ulp of ``exp`` scaled by t up
  to 999), within 1e-6 at t <= 2;
* the diffusers reference (``tests/torch_diffusion_ref.py``) state dicts
  through the port's ``map_diffusers_*`` into the port's modules: the
  same outputs as the reference and as JAX within 2e-5, including SD2's
  linear ``proj_in`` / ``proj_out``;
* bf16 weights under fp32 latents and a bf16 context: both packages
  compute the UNet in fp32, within 1e-4;
* the weight carry (missing / extra / misshapen leaves raise,
  ``export_params`` returns the JAX tree) and ``param_count`` (SD 1.5's
  859,520,964 and the VAE's 83,653,863).
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.checkpoint import diffusers as jax_diffusers
from deepspeed_tpu.inference import diffusion as jax_inf
from deepspeed_tpu.models import diffusion as jax_diff
from deepspeed_tpu.ops.norms import group_norm as jax_group_norm
from deepspeed_tpu_torch.checkpoint import diffusers as port_diffusers
from deepspeed_tpu_torch.checkpoint.jax_params import (export_params,
                                                       load_jax_params)
from deepspeed_tpu_torch.inference import diffusion as inf
from deepspeed_tpu_torch.models import diffusion as diff
from deepspeed_tpu_torch.ops.norms import group_norm

from torch_diffusion_ref import AutoencoderKLRef, UNet2DConditionRef

REPO = Path(__file__).resolve().parents[1]
TINY = dict(in_channels=4, out_channels=4, block_out_channels=(32, 64),
            layers_per_block=1, cross_attention_dim=32, attention_head_dim=4,
            down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"))
VAE_TINY = dict(in_channels=3, out_channels=3, latent_channels=4,
                block_out_channels=(32, 64), layers_per_block=1)
BLOCK_TOL = 1e-5
MODEL_TOL = 2e-5


def _perturbed(params, seed):
    """The JAX tree with N(0, 0.05^2) added to every leaf, as numpy."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a)))
        .astype(np.float32), params)


def _port(tree):
    """A numpy JAX block tree as the port's: tensors, conv kernels OIHW."""
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.ascontiguousarray(
            a.transpose(3, 2, 0, 1) if a.ndim == 4 else a)), tree)


def _err(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    return float(np.abs(got - np.asarray(want, np.float32)).max())


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# -- group_norm and the blocks ------------------------------------------------
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("groups", [8, 32])
def test_group_norm_matches_jax(eps, groups):
    rng = np.random.default_rng(groups)
    x = _randn(rng, 2, 5, 6, 64, scale=3.0) + 1.5
    w, b = _randn(rng, 64), _randn(rng, 64)
    got = group_norm(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(b), groups=groups, eps=eps)
    want = jax_group_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                          groups=groups, eps=eps)
    assert got.dtype == torch.float32
    assert _err(got, want) < 4e-6   # a few ulps at |y| ~ 4


def test_group_norm_keeps_the_input_dtype_and_checks_rank():
    x = torch.randn(1, 4, 4, 32).bfloat16()
    out = group_norm(x, torch.ones(32), torch.zeros(32), groups=8)
    assert out.dtype == torch.bfloat16
    with pytest.raises(AssertionError, match="NHWC"):
        group_norm(torch.randn(4, 32), torch.ones(32), torch.zeros(32))
    with pytest.raises(AssertionError):
        group_norm(torch.randn(1, 2, 2, 30), torch.ones(30), torch.zeros(30),
                   groups=8)


@pytest.fixture(scope="module")
def blocks(unet):
    """The tiny UNet's perturbed JAX tree: a source of block weights."""
    return unet[1]


@pytest.mark.parametrize("which", ["shortcut", "same"])
@pytest.mark.parametrize("with_temb", [True, False])
def test_resnet_block_matches_jax(blocks, which, with_temb):
    # up_blocks[0].resnets[0] takes 64 + 64 channels to 64 (a 1x1
    # shortcut); down_blocks[0].resnets[0] keeps 32
    p = (blocks["up_blocks"][0]["resnets"][0] if which == "shortcut"
         else blocks["down_blocks"][0]["resnets"][0])
    cin = p["conv1"]["kernel"].shape[2]
    rng = np.random.default_rng(5)
    x, temb = _randn(rng, 2, 6, 5, cin), _randn(rng, 2, 128)
    want = jax_diff.resnet_block(jnp.asarray(x),
                                 jnp.asarray(temb) if with_temb else None,
                                 p, groups=8)
    got = diff.resnet_block(torch.from_numpy(x),
                            torch.from_numpy(temb) if with_temb else None,
                            _port(p), groups=8)
    assert _err(got, want) < BLOCK_TOL


def test_transformer_2d_matches_jax(blocks):
    p = blocks["down_blocks"][0]["attentions"][0]
    rng = np.random.default_rng(6)
    x, ctx = _randn(rng, 2, 4, 6, 32), _randn(rng, 2, 7, 32)
    want = jax_diff.transformer_2d(jnp.asarray(x), jnp.asarray(ctx), p,
                                   heads=4, groups=8)
    got = diff.transformer_2d(torch.from_numpy(x), torch.from_numpy(ctx),
                              _port(p), heads=4, groups=8)
    assert _err(got, want) < BLOCK_TOL


@pytest.mark.parametrize("ctx_dtype", ["float32", "bfloat16"])
def test_attention_promotes_a_bf16_context_as_jax_does(blocks, ctx_dtype):
    """Cross-attention of fp32 queries over a bf16 text encoder's states:
    k and v are bf16 (the weight cast to the context's dtype), and the
    products promote to fp32, as ``jnp.einsum`` does; ``torch.matmul``
    alone would raise on the mixed dtypes."""
    p = blocks["down_blocks"][0]["attentions"][0]["blocks"][0]["attn2"]
    rng = np.random.default_rng(7)
    q_in, ctx = _randn(rng, 2, 24, 32), _randn(rng, 2, 7, 32)
    jctx = jnp.asarray(ctx, getattr(jnp, ctx_dtype))
    tctx = torch.from_numpy(ctx).to(getattr(torch, ctx_dtype))
    want = jax_diff._attention(jnp.asarray(q_in), jctx, p, heads=4)
    got = diff._attention(torch.from_numpy(q_in), tctx, _port(p), heads=4)
    assert str(want.dtype) == "float32" and got.dtype == torch.float32
    assert _err(got, want) < (BLOCK_TOL if ctx_dtype == "float32" else 1e-4)


def test_geglu_ff_and_layer_norm_match_jax(blocks):
    blk = blocks["down_blocks"][0]["attentions"][0]["blocks"][0]
    rng = np.random.default_rng(8)
    x = _randn(rng, 2, 9, 32, scale=2.0)
    assert _err(diff._geglu_ff(torch.from_numpy(x), _port(blk["ff"])),
                jax_diff._geglu_ff(jnp.asarray(x), blk["ff"])) < BLOCK_TOL
    assert _err(diff._layer_norm(torch.from_numpy(x), _port(blk["norm1"])),
                jax_diff._layer_norm(jnp.asarray(x), blk["norm1"])) < 1e-6


@pytest.mark.parametrize("fn", ["downsample", "downsample_asym", "upsample"])
def test_resampling_matches_jax(blocks, fn):
    p = (blocks["up_blocks"][0]["upsamplers"][0] if fn == "upsample"
         else blocks["down_blocks"][0]["downsamplers"][0])
    rng = np.random.default_rng(9)
    # odd height: the asymmetric pad shows
    x = _randn(rng, 2, 7, 6, p["conv"]["kernel"].shape[2])
    want = getattr(jax_diff, fn)(jnp.asarray(x), p)
    got = getattr(diff, fn)(torch.from_numpy(x), _port(p))
    assert tuple(got.shape) == tuple(want.shape)
    assert _err(got, want) < BLOCK_TOL


def test_timestep_embedding_matches_jax():
    """The frequencies' ``exp`` differs by up to one ulp between the two
    libraries; t up to 999 scales that to ~6e-5 in an argument, so the
    embedding is held within 1e-4 and the small timesteps within 1e-6."""
    t = np.array([0, 1, 2, 481, 999])
    got = diff.timestep_embedding(torch.from_numpy(t), 320)
    want = jax_diff.timestep_embedding(jnp.asarray(t), 320)
    assert _err(got, want) < 1e-4
    assert _err(got[:3], np.asarray(want)[:3]) < 1e-6


# -- whole models -------------------------------------------------------------
def _carried_unet(seed, **over):
    cfg_kw = {**TINY, **over}
    jcfg = jax_diff.UNetConfig(norm_num_groups=8, **cfg_kw)
    tree = _perturbed(jax_diff.UNet2DCondition(jcfg).init(
        jax.random.PRNGKey(seed)), seed)
    model = load_jax_params(diff.UNet2DCondition(
        diff.UNetConfig(norm_num_groups=8, **cfg_kw), device="cpu",
        seed=seed), tree)
    return jax_diff.UNet2DCondition(jcfg), tree, model


@pytest.fixture(scope="module")
def unet():
    return _carried_unet(0)


@pytest.fixture(scope="module")
def vae():
    jcfg = jax_diff.VAEConfig(norm_num_groups=8, **VAE_TINY)
    tree = _perturbed(jax_diff.AutoencoderKL(jcfg).init(
        jax.random.PRNGKey(1)), 1)
    model = load_jax_params(diff.AutoencoderKL(
        diff.VAEConfig(norm_num_groups=8, **VAE_TINY), device="cpu"), tree)
    return jax_diff.AutoencoderKL(jcfg), tree, model


def _unet_inputs(seed, b=2, hw=16, ctx_dim=32):
    rng = np.random.default_rng(seed)
    return (_randn(rng, b, hw, hw, 4), np.array([3, 977][:b]),
            _randn(rng, b, 7, ctx_dim))


@pytest.mark.parametrize("heads", [4, (2, 4)], ids=["int", "tuple"])
def test_unet_matches_jax(unet, heads):
    jm, tree, model = unet if heads == 4 else _carried_unet(
        2, attention_head_dim=heads)
    x, t, ctx = _unet_inputs(10)
    want = jax.jit(jm.apply)(tree, jnp.asarray(x), jnp.asarray(t),
                             jnp.asarray(ctx))
    got = model.apply(torch.from_numpy(x), torch.from_numpy(t),
                      torch.from_numpy(ctx))
    assert got.shape == (2, 16, 16, 4)
    assert _err(got, want) < MODEL_TOL
    # the scalar timestep broadcasts over the batch
    same = model.apply(torch.from_numpy(x), torch.tensor(5),
                       torch.from_numpy(ctx))
    assert torch.equal(same, model(torch.from_numpy(x),
                                   torch.tensor([5, 5]),
                                   torch.from_numpy(ctx)))


def test_unet_takes_a_params_mapping(unet):
    """``params`` (the names of ``named_parameters()``) replaces the
    model's own weights, as for CLIP."""
    _, _, model = unet
    x, t, ctx = (torch.from_numpy(a) for a in _unet_inputs(11))
    own = dict(model.named_parameters())
    doubled = {k: 2 * v for k, v in own.items()}
    other = diff.UNet2DCondition(model.config, device="cpu")
    with torch.no_grad():
        for k, v in other.named_parameters():
            v.copy_(doubled[k])
    assert torch.equal(model.apply(x, t, ctx, params=doubled),
                       other.apply(x, t, ctx))


def test_vae_matches_jax(vae):
    jm, tree, model = vae
    rng = np.random.default_rng(12)
    x, z = _randn(rng, 2, 16, 16, 3), _randn(rng, 2, 8, 8, 4)
    wm, wl = jax.jit(jm.encode)(tree, jnp.asarray(x))
    gm, gl = model.encode(torch.from_numpy(x))
    assert _err(gm, wm) < MODEL_TOL and _err(gl, wl) < MODEL_TOL
    want = jax.jit(jm.decode)(tree, jnp.asarray(z))
    got = model.decode(torch.from_numpy(z))
    assert tuple(got.shape) == tuple(want.shape) == (2, 16, 16, 3)
    assert _err(got, want) < MODEL_TOL
    # the posterior draw: mean + exp(logvar / 2) * eps, scaled
    gen = torch.Generator().manual_seed(0)
    lat = model.sample_latents(torch.from_numpy(x), gen)
    eps = torch.randn(gm.shape, generator=torch.Generator().manual_seed(0))
    assert torch.equal(lat, (gm + torch.exp(0.5 * gl) * eps) * 0.18215)


def test_param_counts_match_jax():
    sd = diff.UNetConfig()
    assert sd.param_count() == 859_520_964
    shapes = jax.eval_shape(jax_diff.UNet2DCondition(
        jax_diff.UNetConfig()).init, jax.random.PRNGKey(0))
    assert sd.param_count() == jax_diff.UNetConfig().param_count(shapes)
    tiny = diff.UNetConfig(norm_num_groups=8, **TINY)
    model = diff.UNet2DCondition(tiny, device="cpu")
    assert tiny.param_count(dict(model.named_parameters())) \
        == tiny.param_count() == sum(p.numel() for p in model.parameters())
    vshapes = jax.eval_shape(jax_diff.AutoencoderKL(jax_diff.VAEConfig())
                             .init, jax.random.PRNGKey(0))
    vae_count = diff._count(diff._vae_tree(
        diff.VAEConfig(), lambda kind, shape: torch.empty(shape,
                                                          device="meta")))
    assert vae_count == 83_653_863 == sum(
        int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(vshapes))


# -- the schedule and the pipeline --------------------------------------------
@pytest.mark.parametrize("kw", [{}, dict(num_inference_steps=7),
                                dict(set_alpha_to_one=True, steps_offset=0)])
def test_ddim_schedule_arrays_bitwise(kw):
    ts, at, ap = inf.DDIMSchedule(**kw).arrays("cpu")
    jts, jat, jap = jax_inf.DDIMSchedule(**kw).arrays()
    assert ts.dtype == torch.int32 and at.dtype == ap.dtype == torch.float32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(jts))
    np.testing.assert_array_equal(at.numpy(), np.asarray(jat))
    np.testing.assert_array_equal(ap.numpy(), np.asarray(jap))


class _ConstEps:
    class config:
        in_channels = 4

    @staticmethod
    def apply(lat, t, ctx, params=None):
        return torch.full_like(lat, 0.25)


def test_ddim_step_math():
    """The constant-eps step of ``tests/test_diffusion.py``: one step from
    JAX's draw, against the closed form and the JAX pipeline."""
    sched = inf.DDIMSchedule(num_inference_steps=1)
    pipe = inf.StableDiffusionPipeline(_ConstEps(), schedule=sched,
                                       guidance_scale=7.5)
    x0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (1, 4, 4, 4),
                                    jnp.float32))
    ctx = torch.zeros((1, 2, 8))
    lat = pipe.denoise(torch.from_numpy(x0), ctx, ctx)
    at = sched.alphas_cumprod[sched.timesteps[0]]
    pred_x0 = (x0 - np.sqrt(1 - at) * 0.25) / np.sqrt(at)
    ap = sched.alphas_cumprod[0]
    want = np.sqrt(ap) * pred_x0 + np.sqrt(1 - ap) * 0.25
    np.testing.assert_allclose(lat.numpy(), want, rtol=1e-5, atol=1e-5)

    class JaxConstEps:
        class config:
            in_channels = 4

        def apply(self, params, lat, t, ctx):
            return jnp.full_like(lat, 0.25)

    jpipe = jax_inf.StableDiffusionPipeline(
        JaxConstEps(), schedule=jax_inf.DDIMSchedule(num_inference_steps=1),
        guidance_scale=7.5)
    jlat = jpipe.sample_latents(None, jnp.zeros((1, 2, 8)),
                                jnp.zeros((1, 2, 8)), jax.random.PRNGKey(0),
                                height=4, width=4)
    assert _err(lat, jlat) < 1e-6


def test_pipeline_from_jax_draw_matches_jax(unet, vae):
    """3 DDIM steps at guidance 5 on the tiny UNet + VAE from JAX's own
    latent draw (the two packages' draws differ)."""
    jm, utree, model = unet
    jv, vtree, vmodel = vae
    sched = inf.DDIMSchedule(num_inference_steps=3)
    rng = np.random.default_rng(4)
    cond = _randn(rng, 1, 7, 32)
    uncond = np.zeros_like(cond)
    jpipe = jax_inf.StableDiffusionPipeline(
        jm, vae=jv, schedule=jax_inf.DDIMSchedule(num_inference_steps=3),
        guidance_scale=5.0)
    key = jax.random.PRNGKey(1)
    jlat = jpipe.sample_latents(utree, jnp.asarray(cond), jnp.asarray(uncond),
                                key, height=8, width=8)
    jimg = jpipe(utree, jnp.asarray(cond), jnp.asarray(uncond), key,
                 vae_params=vtree, height=8, width=8)
    draw = np.array(jax.random.normal(key, (1, 8, 8, 4), jnp.float32))
    pipe = inf.StableDiffusionPipeline(model, vae=vmodel, schedule=sched,
                                       guidance_scale=5.0)
    lat = pipe.denoise(torch.from_numpy(draw), torch.from_numpy(cond),
                       torch.from_numpy(uncond))
    # measured 3.8e-5 on latents up to 12.5 (the timestep embedding's
    # ulp, scaled by 1 / sqrt(alpha_t) ~ 15 at t 667), 5.6e-6 on the image
    assert _err(lat, jlat) < 1e-4
    img = vmodel.decode(lat)
    assert tuple(img.shape) == (1, 16, 16, 3)
    assert _err(img, jimg) < 2e-5
    # the port's own draw: seeded, and the image is its latents' decode
    gen = torch.Generator().manual_seed(3)
    a = pipe(torch.from_numpy(cond), torch.from_numpy(uncond), gen, 8, 8)
    gen.manual_seed(3)
    lat2 = pipe.sample_latents(torch.from_numpy(cond),
                               torch.from_numpy(uncond), gen, 8, 8)
    assert torch.equal(a, vmodel.decode(lat2))
    assert bool(torch.isfinite(a).all())


# -- diffusers names ----------------------------------------------------------
def _np_state(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _linear_projections(state):
    """The state dict as SD2's ``use_linear_projection`` UNet has it:
    proj_in / proj_out as Linear [out, in] weights."""
    return {k: (v[:, :, 0, 0] if k.endswith(("proj_in.weight",
                                             "proj_out.weight")) else v)
            for k, v in state.items()}


@pytest.mark.parametrize("linear_proj", [False, True])
def test_diffusers_unet_map_matches_the_reference_and_jax(linear_proj):
    torch.manual_seed(0)
    ref = UNet2DConditionRef(groups=8, **TINY).eval()
    state = _np_state(ref)
    if linear_proj:
        state = _linear_projections(state)
    tree = port_diffusers.map_diffusers_unet(state)
    jtree = jax_diffusers.map_diffusers_unet(state)
    assert jax.tree_util.tree_structure(tree) \
        == jax.tree_util.tree_structure(jtree)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(jtree)):
        np.testing.assert_array_equal(a, b)
    model = load_jax_params(diff.UNet2DCondition(
        diff.UNetConfig(norm_num_groups=8, **TINY), device="cpu"), tree)
    x, t, ctx = _unet_inputs(13)
    with torch.no_grad():
        want = ref(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(t), torch.from_numpy(ctx)) \
            .permute(0, 2, 3, 1)
    got = model.apply(torch.from_numpy(x), torch.from_numpy(t),
                      torch.from_numpy(ctx))
    jgot = jax.jit(jax_diff.UNet2DCondition(jax_diff.UNetConfig(
        norm_num_groups=8, **TINY)).apply)(jtree, jnp.asarray(x),
                                           jnp.asarray(t), jnp.asarray(ctx))
    assert _err(got, want.numpy()) < MODEL_TOL
    assert _err(got, jgot) < MODEL_TOL


def test_diffusers_vae_map_matches_the_reference_and_jax():
    torch.manual_seed(1)
    ref = AutoencoderKLRef(groups=8, **VAE_TINY).eval()
    state = _np_state(ref)
    # the pre-0.13 attention names map onto the same leaves
    old = {k.replace("to_q", "query").replace("to_k", "key")
           .replace("to_v", "value").replace("to_out.0", "proj_attn"): v
           for k, v in state.items()}
    tree = port_diffusers.map_diffusers_vae(old)
    jtree = jax_diffusers.map_diffusers_vae(state)
    model = load_jax_params(diff.AutoencoderKL(
        diff.VAEConfig(norm_num_groups=8, **VAE_TINY), device="cpu"), tree)
    jm = jax_diff.AutoencoderKL(jax_diff.VAEConfig(norm_num_groups=8,
                                                   **VAE_TINY))
    rng = np.random.default_rng(14)
    x, z = _randn(rng, 2, 16, 16, 3), _randn(rng, 2, 8, 8, 4)
    with torch.no_grad():
        rm, rl = ref.encode(torch.from_numpy(x).permute(0, 3, 1, 2))
        rd = ref.decode(torch.from_numpy(z).permute(0, 3, 1, 2))
    gm, gl = model.encode(torch.from_numpy(x))
    gd = model.decode(torch.from_numpy(z))
    jm_, jl = jax.jit(jm.encode)(jtree, jnp.asarray(x))
    jd = jax.jit(jm.decode)(jtree, jnp.asarray(z))
    for got, want, jwant in ((gm, rm, jm_), (gl, rl, jl), (gd, rd, jd)):
        assert _err(got, want.permute(0, 2, 3, 1).numpy()) < MODEL_TOL
        assert _err(got, jwant) < MODEL_TOL


def test_diffusers_configs_and_readers(tmp_path):
    import json

    (tmp_path / "config.json").write_text(json.dumps({
        "block_out_channels": [320, 640, 1280, 1280],
        "attention_head_dim": [5, 10, 20, 20], "cross_attention_dim": 1024,
        "scaling_factor": 0.13025, "latent_channels": 4}))
    for name in ("unet_config", "vae_config"):
        got = getattr(port_diffusers, name)(tmp_path)
        want = getattr(jax_diffusers, name)(tmp_path)
        assert vars(got) == vars(want)
    # the readers: a diffusers UNet directory (safetensors) and a VAE one
    # (torch pickle) written from the reference modules load into the
    # port's modules with the map's weights, bit for bit, the files'
    # tensors read back unchanged
    from safetensors.torch import save_file

    torch.manual_seed(0)
    refs = {"unet": UNet2DConditionRef(groups=8, **TINY).eval(),
            "vae": AutoencoderKLRef(groups=8, **VAE_TINY).eval()}
    for kind, ref in refs.items():
        d = tmp_path / kind
        d.mkdir()
        conf = dict(TINY if kind == "unet" else VAE_TINY,
                    norm_num_groups=8)
        (d / "config.json").write_text(json.dumps(conf))
        state = {k: v.detach().contiguous()
                 for k, v in ref.state_dict().items()}
        if kind == "unet":
            save_file(state, str(d / "diffusion_pytorch_model.safetensors"))
        else:
            torch.save(state, str(d / "diffusion_pytorch_model.bin"))
        read = port_diffusers.read_diffusers_state(d)
        assert set(read) == set(state)
        for k, v in state.items():
            assert read[k].dtype == v.dtype and torch.equal(read[k], v), k
        load = getattr(port_diffusers, f"load_{kind}")
        model, params = load(d, device="cpu")
        mapper = getattr(port_diffusers, f"map_diffusers_{kind}")
        want = load_jax_params(
            (diff.UNet2DCondition(diff.UNetConfig(norm_num_groups=8, **TINY),
                                  device="cpu") if kind == "unet" else
             diff.AutoencoderKL(diff.VAEConfig(norm_num_groups=8,
                                               **VAE_TINY), device="cpu")),
            mapper(_np_state(ref)))
        for n, p in want.named_parameters():
            assert torch.equal(params[n], p), (kind, n)


# -- the weight carry ---------------------------------------------------------
def test_weight_carry_round_trips_and_checks(unet, vae):
    for _, tree, model in (unet, vae):
        back = export_params(model)
        assert jax.tree_util.tree_structure(back) \
            == jax.tree_util.tree_structure(tree)
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(tree)):
            np.testing.assert_array_equal(a, b)
    _, tree, model = unet
    kernel = model.conv_in.kernel
    assert kernel.is_contiguous(memory_format=torch.channels_last)
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    del bad["conv_out"]["bias"]
    with pytest.raises(ValueError, match="missing.*conv_out.bias"):
        load_jax_params(model, bad)
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["extra"] = {"kernel": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="unexpected.*extra.kernel"):
        load_jax_params(model, bad)
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["conv_in"]["kernel"] = bad["conv_in"]["kernel"][:, :, :, :8]
    with pytest.raises(ValueError, match="conv_in.kernel"):
        load_jax_params(model, bad)


def test_bf16_weights_run_in_the_latents_dtype(unet):
    """bf16 weights under fp32 latents: the UNet computes in fp32 (each
    weight cast to the activation's dtype), as JAX does."""
    jm, tree, model = unet
    half = diff.UNet2DCondition(model.config, device="cpu",
                                dtype=torch.bfloat16)
    load_jax_params(half, tree)
    jhalf = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                   tree)
    x, t, ctx = _unet_inputs(15)
    got = half.apply(torch.from_numpy(x), torch.from_numpy(t),
                     torch.from_numpy(ctx).bfloat16())
    want = jax.jit(jm.apply)(jhalf, jnp.asarray(x), jnp.asarray(t),
                             jnp.asarray(ctx, jnp.bfloat16))
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    assert _err(got, want) < 1e-4


def test_new_modules_import_neither_jax_nor_the_jax_package():
    """The port's import scan (tests/test_torch_model.py) walks every file
    of the package; these are this slice's."""
    for rel in ("models/diffusion.py", "inference/diffusion.py",
                "checkpoint/diffusers.py", "models/api.py"):
        path = REPO / "deepspeed_tpu_torch" / rel
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) \
                and node.level == 0 else []
            assert not [n for n in names
                        if n.split(".")[0] in ("jax", "jaxlib",
                                               "deepspeed_tpu")], (rel, names)


def test_models_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        diff.UNet2DCondition(diff.UNetConfig(norm_num_groups=8, **TINY))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        diff.AutoencoderKL(diff.VAEConfig(norm_num_groups=8, **VAE_TINY))
