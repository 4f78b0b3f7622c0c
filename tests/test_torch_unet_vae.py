"""PyTorch port vs JAX package: the SD UNet and the VAE of pipeline A, at
small_test_config sizes, f32 unless stated.

Parameters are seeded port weights carried to JAX by the JAX package's own
tower_maps converters, the UNet's global K/V distinct from to_k/to_v.
Tolerance 2e-5 absolute and relative: the same f32 math in other sum
orders, over outputs of magnitude <= 3.  The weight tests show that
`load_jax_tower_params` inverts convert_unet / convert_vae bit for bit and
that the diffusers-shaped oracles load with strict=True.
"""

import flax.traverse_util as traverse_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from textualdegremoval_tpu.models import unet as junet
from textualdegremoval_tpu.models.vae import AutoencoderKL as JaxVAE

from textualdegremoval_tpu_torch.convert import (
    load_jax_tower_params, load_reference_tower,
)
from textualdegremoval_tpu_torch.diffusion.pipeline import GuidanceModules
from textualdegremoval_tpu_torch.models import unet

from torch_oracles import OUNet, OVAE
from torch_port_util import (
    assert_close, jax_tower_tree, randn, randomize, t, tiny_guidance_modules,
)

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def towers():
    return tiny_guidance_modules(seed=1)


def test_timestep_embedding_matches_jax():
    ts = np.asarray([0, 1, 37, 500, 999], np.int32)
    got = unet.timestep_embedding(t(ts), 320)
    want = junet.timestep_embedding(jnp.asarray(ts), 320)
    # f32 sin/cos of arguments up to 999, where one ulp of the argument is
    # 6e-5: the two libraries' results differ by up to that
    assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("use_global_kv", [False, True])
def test_unet_matches_jax(towers, use_global_kv):
    mods, jmods, params = towers
    rng = np.random.default_rng(2)
    lat = randn(rng, 2, 8, 8, 4)
    ctx = randn(rng, 2, 16, 64)
    ts = np.asarray([10, 500], np.int32)
    with torch.no_grad():
        got = mods.unet(t(lat), t(ts), t(ctx), use_global_kv=use_global_kv)
    want = jmods.unet.apply({"params": params["unet"]}, jnp.asarray(lat),
                            jnp.asarray(ts), jnp.asarray(ctx),
                            use_global_kv=use_global_kv)
    assert got.shape == lat.shape
    assert_close(got, want, **TOL)


def test_unet_global_kv_changes_the_output(towers):
    mods = towers[0]
    rng = np.random.default_rng(3)
    args = (t(randn(rng, 1, 8, 8, 4)), torch.tensor([10]),
            t(randn(rng, 1, 16, 64)))
    with torch.no_grad():
        assert not torch.allclose(mods.unet(*args, use_global_kv=False),
                                  mods.unet(*args, use_global_kv=True))


def test_unet_attn_impl_is_validated():
    with pytest.raises(ValueError, match="attn_impl"):
        unet.UNet2DCondition(block_out_channels=(32, 64), layers_per_block=1,
                             context_dim=64, head_dim=16, attn_impl="xla")


def test_unet_plain_equals_flash_route_on_cpu(towers):
    """On a CPU tensor the flash route takes the plain version inside the
    wrapper: 'flash' and 'plain' give the same output bit for bit."""
    mods = towers[0]
    plain = unet.UNet2DCondition(block_out_channels=(32, 64),
                                 layers_per_block=1, context_dim=64,
                                 head_dim=16, attn_impl="plain")
    plain.load_state_dict(mods.unet.state_dict())
    rng = np.random.default_rng(4)
    args = (t(randn(rng, 1, 8, 8, 4)), torch.tensor([10]),
            t(randn(rng, 1, 16, 64)))
    with torch.no_grad():
        assert torch.equal(plain(*args, use_global_kv=True),
                           mods.unet(*args, use_global_kv=True))


def test_vae_encode_moments_matches_jax(towers):
    mods, jmods, params = towers
    img = randn(np.random.default_rng(5), 1, 16, 16, 3)
    with torch.no_grad():
        mean, logvar = mods.vae.encode_moments(t(img))
    jm, jl = jmods.vae.apply({"params": params["vae"]}, jnp.asarray(img),
                             method=JaxVAE.encode_moments)
    assert mean.shape == logvar.shape == (1, 8, 8, 4)
    assert_close(mean, jm, **TOL)
    assert_close(logvar, jl, **TOL)


def test_vae_decode_matches_jax(towers):
    mods, jmods, params = towers
    z = randn(np.random.default_rng(6), 2, 8, 8, 4)
    with torch.no_grad():
        got = mods.vae.decode(t(z))
    want = jmods.vae.apply({"params": params["vae"]}, jnp.asarray(z),
                           method=JaxVAE.decode)
    assert got.shape == (2, 16, 16, 3)
    assert_close(got, want, **TOL)


def test_vae_encode_sample_draws_from_the_generator(towers):
    mods = towers[0]
    img = t(randn(np.random.default_rng(7), 1, 16, 16, 3))
    with torch.no_grad():
        a = mods.vae.encode_sample(img, torch.Generator().manual_seed(1))
        b = mods.vae.encode_sample(img, torch.Generator().manual_seed(1))
        mean, _ = mods.vae.encode_moments(img)
    assert torch.equal(a, b) and not torch.equal(a, mean)


def test_unet_bf16_matches_jax_bf16():
    """bf16 compute over f32 parameters on both sides (the JAX API's dtype):
    each layer rounds in bf16 in both frameworks, in other places (XLA keeps
    excess precision inside its fusions), so over the small UNet's ~20
    layers the outputs (|o| <= 3) agree to 0.1 absolute and 3e-2 in L2."""
    mods, jmods, params = tiny_guidance_modules(seed=8, dtype=torch.bfloat16)
    rng = np.random.default_rng(8)
    lat, ctx = randn(rng, 2, 8, 8, 4), randn(rng, 2, 16, 64)
    ts = np.asarray([10, 500], np.int32)
    with torch.no_grad():
        got = mods.unet(t(lat), t(ts), t(ctx), use_global_kv=True)
    want = jmods.unet.apply({"params": params["unet"]}, jnp.asarray(lat),
                            jnp.asarray(ts), jnp.asarray(ctx),
                            use_global_kv=True)
    assert got.dtype == torch.bfloat16
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got, want, atol=0.1, rtol=0)
    assert np.linalg.norm(got - want) <= 3e-2 * np.linalg.norm(want)


@pytest.mark.parametrize("tower", ["unet", "vae"])
def test_jax_tree_roundtrip(towers, tower):
    """JAX tree -> load_jax_tower_params -> port state_dict -> tower_maps'
    converter gives the JAX tree back bit for bit."""
    params = towers[2]
    fresh = getattr(GuidanceModules.small_test_config(), tower)
    load_jax_tower_params(fresh, params[tower], tower)
    flat_want = traverse_util.flatten_dict(params[tower])
    flat_got = traverse_util.flatten_dict(jax_tower_tree(fresh, tower))
    assert flat_got.keys() == flat_want.keys()
    for k, v in flat_want.items():
        assert np.array_equal(flat_got[k], v), k


def test_load_jax_tower_params_rejects_mis_shaped_leaf(towers):
    params = towers[2]
    tree = traverse_util.flatten_dict(params["vae"])
    key = ("decoder", "conv_out", "bias")
    tree[key] = np.zeros(5, np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_jax_tower_params(GuidanceModules.small_test_config().vae,
                              traverse_util.unflatten_dict(tree), "vae")


def test_diffusers_unet_state_dict_loads_strict_and_matches():
    """OUNet (diffusers names, no global K/V) loads with strict=True: the
    global projections are cloned from to_k/to_v, so the injected path
    equals the plain one, and both equal the oracle."""
    oracle = randomize(OUNet(chs=(32, 64), layers=1, ctx=64, head_dim=16),
                       seed=9).eval()
    port = GuidanceModules.small_test_config().unet
    load_reference_tower(port, oracle.state_dict(), "unet")
    g = torch.Generator().manual_seed(10)
    x = torch.randn(1, 4, 16, 16, generator=g)
    ts = torch.tensor([37])
    ctx = torch.randn(1, 8, 64, generator=g)
    with torch.no_grad():
        want = oracle(x, ts, ctx).permute(0, 2, 3, 1)
        got = port(x.permute(0, 2, 3, 1), ts, ctx)
        got_g = port(x.permute(0, 2, 3, 1), ts, ctx, use_global_kv=True)
    assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert torch.equal(got, got_g)


def test_mapper_artifact_supplies_unet_global_kv():
    oracle = randomize(OUNet(chs=(32, 64), layers=1, ctx=64, head_dim=16),
                       seed=11)
    path = "down_blocks.0.attentions.0.transformer_blocks.0.attn2"
    wk = torch.randn(32, 64, generator=torch.Generator().manual_seed(12))
    port = GuidanceModules.small_test_config().unet
    load_reference_tower(port, oracle.state_dict(), "unet",
                         global_kv={f"{path}_to_k.weight": wk})
    sd = port.state_dict()
    assert torch.equal(sd[f"{path}.to_k_global.weight"], wk)
    assert torch.equal(sd[f"{path}.to_v_global.weight"],
                       sd[f"{path}.to_v.weight"])


def test_diffusers_vae_state_dict_loads_strict_and_matches():
    """OVAE (diffusers 0.16 attention names query/key/value/proj_attn)
    loads with strict=True and equals the oracle."""
    oracle = randomize(OVAE(chs=(16, 32), layers=1), seed=13).eval()
    port = GuidanceModules.small_test_config().vae
    load_reference_tower(port, oracle.state_dict(), "vae")
    x = torch.randn(1, 3, 16, 16, generator=torch.Generator().manual_seed(14))
    with torch.no_grad():
        want_m = oracle.encode_moments(x)
        mean, _ = port.encode_moments(x.permute(0, 2, 3, 1))
        want_d = oracle.decode(want_m[:, :4])
        got_d = port.decode(want_m[:, :4].permute(0, 2, 3, 1))
    assert_close(mean, want_m[:, :4].permute(0, 2, 3, 1), atol=1e-4,
                 rtol=1e-4)
    assert_close(got_d, want_d.permute(0, 2, 3, 1), atol=1e-4, rtol=1e-4)
