"""PyTorch port vs JAX package: pipeline A's scheduler, sampler, generation,
tokenizer and the generation CLI's per-image function, f32 unless stated.

* DDIM tables, timesteps, add_noise, velocity and `step` for both
  prediction types: the same float32 arithmetic, to 1e-6 relative;
* `cfg_sample` with an exact bf16 model: the scheduler's arithmetic in
  float32 (the JAX 0-d promotion; a bf16 scheduler misses by ~1e-2);
* `cfg_sample` with the tiny UNet in f32 and in bf16, and
  `generate_reference` end to end, against JAX with the same initial
  latents;
* the tokenizer's ids, the CLI's bilinear resize against cv2.resize, and
  `generate_one` over synthetic images on the CPU.
"""

import json

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from textualdegremoval_tpu.diffusion import ddim as jddim
from textualdegremoval_tpu.diffusion import pipeline as jpipe
from textualdegremoval_tpu.diffusion import tokenizer as jtok
from textualdegremoval_tpu.utils import image as jimage

from textualdegremoval_tpu_torch.cli import generate_reference as cli
from textualdegremoval_tpu_torch.convert import (
    load_reference_towers, mapper_reference_state_dict,
)
from textualdegremoval_tpu_torch.diffusion import ddim, pipeline
from textualdegremoval_tpu_torch.diffusion import tokenizer as tok
from textualdegremoval_tpu_torch.utils import image

from torch_port_util import assert_close, randn, t, tiny_guidance_modules


@pytest.fixture(scope="module")
def towers():
    return tiny_guidance_modules(seed=2)


@pytest.mark.parametrize("steps", [10, 50, 100])
def test_scheduler_tables_match_jax(steps):
    s, js = ddim.DDIMScheduler(), jddim.DDIMScheduler()
    assert np.array_equal(s.alphas_cumprod, js.alphas_cumprod)
    assert np.array_equal(s.timesteps(steps), js.timesteps(steps))


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_step_matches_jax(prediction_type):
    s = ddim.DDIMScheduler(prediction_type=prediction_type)
    js = jddim.DDIMScheduler(prediction_type=prediction_type)
    rng = np.random.default_rng(0)
    out, sample = randn(rng, 2, 4, 4, 3), randn(rng, 2, 4, 4, 3)
    for tt, tp in ((991, 981), (501, 401), (1, -9)):
        got = s.step(t(out), tt, tp, t(sample))
        want = js.step(jnp.asarray(out), tt, tp, jnp.asarray(sample))
        assert_close(got, want, atol=1e-6, rtol=1e-6)


def test_add_noise_and_velocity_match_jax():
    s, js = ddim.DDIMScheduler(), jddim.DDIMScheduler()
    rng = np.random.default_rng(1)
    x0, noise = randn(rng, 3, 4, 4, 2), randn(rng, 3, 4, 4, 2)
    ts = np.asarray([0, 500, 999], np.int32)
    for name in ("add_noise", "velocity"):
        got = getattr(s, name)(t(x0), t(noise), t(ts))
        want = getattr(js, name)(jnp.asarray(x0), jnp.asarray(noise),
                                 jnp.asarray(ts))
        assert_close(got, want, atol=1e-6, rtol=1e-6)


def test_cfg_sample_bf16_model_keeps_scheduler_in_f32():
    """A bf16 model output exact in both frameworks (one rounding of
    0.5 * latents, the same for both halves, so the guided sum is exact):
    what remains is the scheduler's arithmetic, float32 in JAX through its
    0-d promotion.  The port agrees to 1e-5 relative; the same loop with
    the scheduler in bf16 misses by more than 1e-3."""
    rng = np.random.default_rng(2)
    lat = randn(rng, 1, 4, 4, 2)
    cond, uncond = randn(rng, 1, 3, 8), randn(rng, 1, 3, 8)
    want = np.asarray(jddim.cfg_sample(
        lambda x, tt, c: (0.5 * x).astype(jnp.bfloat16),
        jddim.DDIMScheduler(), jnp.asarray(lat), jnp.asarray(cond),
        jnp.asarray(uncond), num_inference_steps=10))
    got = ddim.cfg_sample(lambda x, tt, c: (0.5 * x).bfloat16(),
                          ddim.DDIMScheduler(), t(lat), t(cond), t(uncond),
                          num_inference_steps=10)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())

    class Bf16Scheduler(ddim.DDIMScheduler):
        def step(self, model_out, t_, t_prev, sample):
            return super().step(model_out, t_, t_prev, sample).bfloat16()

    bad = ddim.cfg_sample(lambda x, tt, c: (0.5 * x).bfloat16(),
                          Bf16Scheduler(), t(lat), t(cond), t(uncond),
                          num_inference_steps=10)
    assert np.abs(bad.float().numpy() - want).max() > \
        1e-3 * np.abs(want).max()


def _cfg_pair(mods, jmods, params, steps, seed):
    rng = np.random.default_rng(seed)
    lat = randn(rng, 1, 8, 8, 4)
    cond, uncond = randn(rng, 1, 16, 64), randn(rng, 1, 16, 64)
    want = jddim.cfg_sample(
        lambda x, tt, c: jmods.unet.apply({"params": params["unet"]}, x, tt,
                                          c, use_global_kv=True),
        jddim.DDIMScheduler(), jnp.asarray(lat), jnp.asarray(cond),
        jnp.asarray(uncond), num_inference_steps=steps)
    with torch.no_grad():
        got = ddim.cfg_sample(
            lambda x, tt, c: mods.unet(x, tt, c, use_global_kv=True),
            mods.scheduler, t(lat), t(cond), t(uncond),
            num_inference_steps=steps)
    return got.numpy(), np.asarray(want)


def test_cfg_sample_tiny_unet_matches_jax(towers):
    """Three steps at guidance 5; the DDIM step divides by sqrt(acp) (0.07
    at t = 991), so latents of magnitude ~20 carry the UNet's f32 rounding
    differences amplified: 1e-4 relative to max|want|."""
    got, want = _cfg_pair(*towers, steps=3, seed=3)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_cfg_sample_tiny_unet_bf16_matches_jax_bf16():
    """The tiny UNet in bf16 (f32 parameters) on both sides, the latents
    float32 between steps in both.  bf16 rounds in other places in the two
    frameworks (XLA keeps excess precision inside fusions), amplified by
    1/sqrt(acp) as above: each framework's bf16 result lies 2.6-2.9e-2
    (L2, relative) from its own f32 result, and the two bf16 results 3.4e-2
    apart.  Bound: 6e-2 in L2 and 0.1 max|want| elementwise.  The
    promotion itself is pinned exactly by the test above."""
    got, want = _cfg_pair(*tiny_guidance_modules(seed=4,
                                                 dtype=torch.bfloat16),
                          steps=2, seed=4)
    assert got.dtype == np.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=0.1 * np.abs(want).max())
    assert np.linalg.norm(got - want) <= 6e-2 * np.linalg.norm(want)


def test_generate_reference_matches_jax(towers):
    """CLIP view -> mappers -> injection -> 3-step CFG -> VAE decode, the
    same initial latents given to both (JAX draws them from its key)."""
    mods, jmods, params = towers
    rng = np.random.default_rng(5)
    clip_view = randn(rng, 1, 28, 28, 3)
    ids = rng.integers(1, 100, (1, 16)).astype(np.int32)
    uids = rng.integers(1, 100, (1, 16)).astype(np.int32)
    inj = np.asarray([2], np.int32)
    key = jax.random.PRNGKey(6)
    want = jpipe.generate_reference(
        jmods, params, jnp.asarray(clip_view), jnp.asarray(ids),
        jnp.asarray(uids), jnp.asarray(inj), key, latent_hw=(8, 8),
        num_inference_steps=3)
    latents = np.asarray(jax.random.normal(key, (1, 8, 8, 4)))
    got = pipeline.generate_reference(
        mods, t(clip_view), t(ids), t(uids), t(inj), latent_hw=(8, 8),
        num_inference_steps=3, latents=t(latents))
    assert got.shape == (1, 16, 16, 3)
    assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_generate_reference_draws_latents_from_the_generator(towers):
    mods = towers[0]
    args = (torch.zeros(1, 28, 28, 3), torch.ones(1, 16, dtype=torch.long),
            torch.ones(1, 16, dtype=torch.long), torch.tensor([2]))
    a, b = (pipeline.generate_reference(
        mods, *args, torch.Generator().manual_seed(7), latent_hw=(8, 8),
        num_inference_steps=2) for _ in range(2))
    assert torch.equal(a, b) and torch.isfinite(a).all()


@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    """Mini CLIP BPE assets (tests/test_tokenizer.py's) for 'a photo of a s'."""
    d = tmp_path_factory.mktemp("tokenizer")
    vocab = {"<|startoftext|>": 49406, "<|endoftext|>": 49407, "!": 0,
             "a</w>": 320, "photo</w>": 1125, "of</w>": 539, "s</w>": 338,
             "p": 12, "h": 13, "o": 14, "t": 15, "f</w>": 16, "ph": 17,
             "pho": 18, "to</w>": 19, "o</w>": 20}
    merges = ["p h", "ph o", "t o</w>", "pho to</w>", "o f</w>"]
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges))
    return str(d)


@pytest.mark.parametrize("with_vocab", [False, True])
def test_tokenizer_matches_jax(tok_dir, with_vocab):
    path = tok_dir if with_vocab else None
    got = tok.tokenize_template("a photo of a S", tokenizer_path=path)
    want = jtok.tokenize_template("a photo of a S", tokenizer_path=path)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert got[2] == want[2] == 5


def test_tokenizer_fallback_refuses_unknown_words():
    with pytest.raises(ValueError):
        tok.tokenize_template("a sketch of a S")


@pytest.mark.parametrize("hw,size", [((300, 300), 224), ((97, 97), 224),
                                     ((512, 512), 224), ((40, 40), 16)])
def test_resize_matches_cv2(hw, size):
    """cv2.resize INTER_LINEAR on float32 (the JAX CLI's) against the
    port's F.interpolate bilinear, half-pixel centres, no antialias: the
    same interpolation, with weights rounded differently (cv2 differs by
    up to 3.8e-5 on values in [0, 1]); bound 1e-4."""
    img = np.random.default_rng(hw[0]).random((*hw, 3), dtype=np.float32)
    got = cli.resize_bilinear(t(img), size).numpy()
    want = cv2.resize(img, (size, size))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_tensor2img_matches_jax():
    img = np.random.default_rng(8).normal(0.5, 0.4, (1, 8, 6, 3)).astype(
        np.float32)
    assert np.array_equal(image.tensor2img(t(img)), jimage.tensor2img(img))
    assert np.array_equal(image.tensor2img(img, rgb2bgr=False),
                          jimage.tensor2img(img, rgb2bgr=False))


def test_clip_view_matches_the_jax_cli():
    img = np.random.default_rng(9).random((300, 300, 3), dtype=np.float32)
    want = (cv2.resize(img, (224, 224)) - cli.CLIP_MEAN) / cli.CLIP_STD
    got = cli.clip_view(img, 224, "cpu")
    assert got.shape == (1, 224, 224, 3)
    # the resize's 1e-4 divided by the smallest CLIP std (0.26)
    np.testing.assert_allclose(got[0].numpy(), want, atol=4e-4, rtol=0)


def test_generate_one_on_synthetic_images(towers):
    """The CLI's per-image function over two synthetic images of other
    shapes, small towers, on the CPU: uint8 HWC.  --size 64 gives an 8 x 8
    latent, which the small VAE (two levels) decodes to 16 x 16."""
    mods = towers[0]
    ids, uids, inj = tok.tokenize_template("a photo of a S", max_length=16)
    # the small text tower's vocabulary has 100 entries
    ids, uids = torch.from_numpy(ids % 100), torch.from_numpy(uids % 100)
    inj = torch.tensor([inj], dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(10)
    for hw in ((40, 60), (50, 50)):
        out = cli.generate_one(mods, rng.random((*hw, 3), dtype=np.float32),
                               ids, uids, inj, gen, size=64, steps=2)
        assert out.dtype == np.uint8 and out.shape == (16, 16, 3)


def test_random_init_is_seeded_with_unit_norms(towers):
    mods = pipeline.GuidanceModules.small_test_config()
    cli.random_init(mods, torch.Generator().manual_seed(0))
    again = pipeline.GuidanceModules.small_test_config()
    cli.random_init(again, torch.Generator().manual_seed(0))
    for name, mod in mods.towers().items():
        other = again.towers()[name].state_dict()
        for k, v in mod.state_dict().items():
            assert torch.equal(v, other[k]), k
    unet = mods.unet
    assert torch.equal(unet.conv_norm_out.weight,
                       torch.ones_like(unet.conv_norm_out.weight))
    assert not unet.conv_in.bias.any() and unet.conv_in.weight.std() > 0
    assert not mods.text_encoder.text_model.embeddings.position_embedding \
        .weight.any()


def test_load_reference_towers_from_a_directory(towers, tmp_path):
    """A directory of reference-format state dicts loads into every tower
    with strict=True; the UNet's global K/V come from the mapper artifact."""
    src = towers[0]
    path = "down_blocks.0.attentions.0.transformer_blocks.0.attn2"
    usd = src.unet.state_dict()
    files = {
        "text_encoder": src.text_encoder.state_dict(),
        "image_encoder": src.image_encoder.state_dict(),
        "vae": src.vae.state_dict(),
        "unet": {k: v for k, v in usd.items() if "_global" not in k},
        "mapper": {**mapper_reference_state_dict(src.mapper),
                   f"{path}_to_k.weight": usd[f"{path}.to_k_global.weight"],
                   f"{path}_to_v.weight": usd[f"{path}.to_v_global.weight"]},
        "clean_mapper": mapper_reference_state_dict(src.clean_mapper),
    }
    for name, sd in files.items():
        torch.save(sd, tmp_path / f"{name}.pt")
    dst = pipeline.GuidanceModules.small_test_config()
    load_reference_towers(dst, str(tmp_path))
    for name, mod in src.towers().items():
        got = dst.towers()[name].state_dict()
        for k, v in mod.state_dict().items():
            if name == "unet" and "_global" in k and path not in k:
                v = usd[k.replace("_global", "")]  # cloned from to_k/to_v
            assert torch.equal(got[k], v), (name, k)
