"""PyTorch port vs JAX package: pipeline A's training loss and gradients
(diffusion/pipeline.py training half), on the CPU.

* `diffusion_loss` and the trainable gradients of `guidance_loss_and_grads`
  against JAX `guidance_loss_and_grads` for the I2T and TR stages, on
  small_test_config towers with the same weights (`tiny_guidance_modules`)
  and JAX's own draws fed in (noise, t and the VAE's posterior eps
  reproduced from jax.random.split(rng, 3)): loss to 1e-5 relative, each
  gradient to 1e-4 in L2 (measured 1e-7 and 3e-6);
* remat (the UNet under activation checkpointing) equal to no remat,
  bitwise;
* the trainable mask against JAX `trainable_mask`, leaf for leaf;
* the loss of bf16 towers over bf16-stored frozen weights (the CLI's
  --mixed_precision bf16) against JAX's same configuration.
The update steps are in tests/test_torch_guidance_step.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import flax.traverse_util as traverse_util

from textualdegremoval_tpu.diffusion import pipeline as jpipe
from textualdegremoval_tpu.models.vae import AutoencoderKL as JaxVAE

from textualdegremoval_tpu_torch.convert import tower_key_to_jax_path
from textualdegremoval_tpu_torch.diffusion import pipeline

from torch_port_util import t, tiny_guidance_modules

B = 2


def guidance_batch(seed: int = 0, b: int = B) -> dict:
    """A numpy batch for the small_test_config towers: 16 px SD view (an
    8 x 8 latent), 28 px CLIP view, 16 token ids below the vocabulary of
    100, placeholder indices."""
    rng = np.random.default_rng(seed)
    return {
        "pixel_values": rng.uniform(-1, 1, (b, 16, 16, 3)).astype(np.float32),
        "pixel_values_clip": rng.standard_normal((b, 28, 28, 3)).astype(
            np.float32),
        "input_ids": rng.integers(0, 100, (b, 16)).astype(np.int32),
        "inj_index": np.asarray([3, 5, 1, 2][:b], np.int32),
    }


def jax_draws(jmods, params, batch, key) -> dict:
    """The noise, t and VAE eps that JAX `diffusion_loss` draws from `key`,
    as numpy arrays (the port's `diffusion_loss` keywords)."""
    rng_noise, rng_t, rng_vae = jax.random.split(key, 3)
    mean, _ = jmods.vae.apply({"params": params["vae"]},
                              jnp.asarray(batch["pixel_values"]),
                              method=JaxVAE.encode_moments)
    b = mean.shape[0]
    return {
        "noise": np.asarray(jax.random.normal(rng_noise, mean.shape,
                                              mean.dtype).astype(jnp.float32)),
        "t": np.asarray(jax.random.randint(
            rng_t, (b,), 0, jmods.scheduler.num_train_timesteps)),
        "vae_eps": np.asarray(jax.random.normal(rng_vae, mean.shape,
                                                mean.dtype).astype(
                                                    jnp.float32)),
    }


def torch_draws(draws: dict, dtype=torch.float32) -> dict:
    return {"noise": t(draws["noise"]).to(dtype), "t": t(draws["t"]),
            "vae_eps": t(draws["vae_eps"]).to(dtype)}


def jax_leaf(tree: dict, name: str, ndim: int) -> np.ndarray:
    """The leaf of a JAX tower tree (params or grads) for the port's
    '<tower>.<parameter>' name, in the port's layout."""
    tower, key = name.split(".", 1)
    path = tower_key_to_jax_path(key, ndim, tower)
    leaf = tree[tower]
    for p in path:
        leaf = leaf[p]
    leaf = np.asarray(leaf)
    return leaf.T if path[-1] == "kernel" and ndim == 2 else leaf


@pytest.fixture(scope="module")
def towers():
    return tiny_guidance_modules(seed=3)


@pytest.mark.parametrize("stage", ["i2t", "tr"])
def test_loss_and_grads_match_jax(towers, stage):
    mods, jmods, params = towers
    batch = guidance_batch(seed=1)
    key = jax.random.PRNGKey(7)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want = jax.jit(functools.partial(
        jpipe.guidance_loss_and_grads, jmods, stage=stage))(params, jb, key)
    loss, grads = pipeline.guidance_loss_and_grads(
        mods, {k: t(v) for k, v in batch.items()}, stage,
        **torch_draws(jax_draws(jmods, params, batch, key)))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    train, frozen = pipeline.partition(mods, stage)
    assert sorted(grads) == sorted(n for n, _ in train)
    assert all(not p.requires_grad for _, p in frozen)
    for name, g in grads.items():
        w = jax_leaf(want, name, g.ndim)
        assert g.shape == w.shape, name
        err = np.linalg.norm(g.numpy() - w) / np.linalg.norm(w)
        assert err <= 1e-4, (name, err)
    # JAX's frozen entries are zeros
    flat = traverse_util.flatten_dict(want)
    mask = traverse_util.flatten_dict(jpipe.trainable_mask(params, stage))
    assert all(not np.any(np.asarray(flat[k])) for k in flat if not mask[k])


def test_remat_equals_no_remat(towers):
    """The UNet under activation checkpointing recomputes the same forward
    in the backward: loss and gradients bitwise equal."""
    mods, jmods, params = towers
    batch = {k: t(v) for k, v in guidance_batch(seed=2).items()}
    draws = torch_draws(jax_draws(jmods, params, guidance_batch(seed=2),
                                  jax.random.PRNGKey(3)))
    out = {remat: pipeline.guidance_loss_and_grads(
        mods, batch, "i2t", remat=remat, **draws) for remat in (False, True)}
    assert torch.equal(out[False][0], out[True][0])
    for name, g in out[False][1].items():
        assert torch.equal(g, out[True][1][name]), name


@pytest.mark.parametrize("stage", ["i2t", "tr"])
def test_trainable_mask_matches_jax(towers, stage):
    mods, _, params = towers
    want = traverse_util.flatten_dict(jpipe.trainable_mask(params, stage))
    got = pipeline.trainable_mask(mods, stage)
    sd = {f"{tw}.{n}": p for tw, m in mods.towers().items()
          for n, p in m.named_parameters()}
    assert len(got) == len(want)
    for name, trains in got.items():
        tower, key = name.split(".", 1)
        path = (tower, *tower_key_to_jax_path(key, sd[name].ndim, tower))
        assert want[path] == trains, name
    n_train = sum(got.values())
    assert n_train == (36 if stage == "i2t" else 14)
    with pytest.raises(ValueError, match="stage"):
        pipeline.trainable_mask(mods, "restoration")


def _frozen_bf16(mods, stage):
    """The CLI's --mixed_precision bf16: frozen parameters stored bf16."""
    for _, p in pipeline.partition(mods, stage)[1]:
        p.data = p.data.to(torch.bfloat16)
    return mods


# bf16 towers over bf16-stored frozen weights, the port vs JAX in the same
# configuration and with the same (bf16) draws: both round every tower
# activation to bf16, XLA keeps excess precision inside its fusions
# (ROADMAP C3), so the losses differ by a few bf16 ulps of the loss:
# bound 2e-2 relative.
def test_bf16_loss_matches_jax_bf16():
    mods, jmods, params = tiny_guidance_modules(seed=4, dtype=torch.bfloat16)
    mask = jpipe.trainable_mask(params, "i2t")
    jparams = jax.tree_util.tree_map(
        lambda p, m: p if m else p.astype(jnp.bfloat16), params, mask)
    _frozen_bf16(mods, "i2t")
    batch = guidance_batch(seed=5)
    key = jax.random.PRNGKey(11)
    want = jax.jit(functools.partial(jpipe.diffusion_loss, jmods))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    draws = torch_draws(jax_draws(jmods, jparams, batch, key),
                        torch.bfloat16)
    with torch.no_grad():
        got = pipeline.diffusion_loss(mods, {k: t(v) for k, v in
                                             batch.items()}, **draws)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(float(got), float(want), rtol=2e-2)
