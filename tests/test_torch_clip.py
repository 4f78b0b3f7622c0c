"""PyTorch port vs JAX package: the CLIP towers, the splice and the
mappers of pipeline A, at small_test_config sizes, f32 unless stated.

Parameters are seeded port weights carried to JAX by the JAX package's own
tower_maps converters (`torch_port_util.jax_tower_tree`); the weight tests
show that `load_jax_tower_params` is their exact inverse and that the
reference formats (HF CLIP, the per-word mapper artifact) load with
strict=True.  Tolerance 2e-5 absolute and relative: the same f32 math in
other sum orders, over outputs of magnitude <= 5.
"""

import flax.traverse_util as traverse_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from textualdegremoval_tpu.models import clip as jclip

from textualdegremoval_tpu_torch.convert import (
    load_jax_tower_params, load_reference_tower, mapper_reference_state_dict,
)
from textualdegremoval_tpu_torch.diffusion.pipeline import GuidanceModules
from textualdegremoval_tpu_torch.models import clip

from torch_oracles import OCLIPText, OMapper
from torch_port_util import (
    assert_close, jax_tower_tree, randn, randomize, t, tiny_guidance_modules,
)

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def towers():
    return tiny_guidance_modules(seed=0)


# placeholder at the start, in the middle, and where the L words overflow
# the fixed length (the tail is truncated)
@pytest.mark.parametrize("idx", [[0, 1], [2, 5], [8, 9]])
def test_splice_matches_jax(idx):
    rng = np.random.default_rng(sum(idx))
    tok = randn(rng, 2, 10, 4)
    inj = randn(rng, 2, 3, 4)
    idx = np.asarray(idx, np.int32)
    got = clip.splice_pseudo_words(t(tok), t(inj), t(idx))
    want = jclip.splice_pseudo_words(jnp.asarray(tok), jnp.asarray(inj),
                                     jnp.asarray(idx))
    assert torch.equal(got, torch.from_numpy(np.array(want)))


@pytest.mark.parametrize("inject", [False, True])
def test_text_encoder_matches_jax(towers, inject):
    mods, jmods, params = towers
    rng = np.random.default_rng(1)
    ids = rng.integers(1, 100, (2, 16)).astype(np.int32)
    kw, jkw = {}, {}
    if inject:
        inj = randn(rng, 2, 3, 64)
        idx = np.asarray([2, 14], np.int32)
        kw = dict(inj_embedding=t(inj), inj_index=t(idx))
        jkw = dict(inj_embedding=jnp.asarray(inj), inj_index=jnp.asarray(idx))
    with torch.no_grad():
        h, pooled = mods.text_encoder(t(ids), **kw)
    jh, jp = jmods.text_encoder.apply({"params": params["text_encoder"]},
                                      jnp.asarray(ids), **jkw)
    assert_close(h, jh, **TOL)
    assert_close(pooled, jp, **TOL)


def test_vision_encoder_matches_jax(towers):
    mods, jmods, params = towers
    x = randn(np.random.default_rng(2), 2, 28, 28, 3)
    with torch.no_grad():
        got = mods.image_encoder(t(x))
    want = jmods.image_encoder.apply({"params": params["image_encoder"]},
                                     jnp.asarray(x))
    assert got.shape == (2, 5, 32)
    assert_close(got, want, **TOL)


def test_mappers_match_jax(towers):
    mods, jmods, params = towers
    embs = randn(np.random.default_rng(3), 2, 5, 32)
    with torch.no_grad():
        words = mods.mapper(t(embs))
        clean = mods.clean_mapper(words)
    jw = jmods.mapper.apply({"params": params["mapper"]}, jnp.asarray(embs))
    jc = jmods.clean_mapper.apply({"params": params["clean_mapper"]}, jw)
    assert words.shape == clean.shape == (2, 4, 64)
    assert_close(words, jw, **TOL)
    assert_close(clean, jc, **TOL)


def test_text_encoder_bf16_matches_jax_bf16():
    """bf16 compute over f32 parameters on both sides: each layer rounds
    in bf16 in both frameworks, in other places (XLA keeps excess
    precision inside fusions); over 2 layers the states (|h| <= 4) agree
    to 0.1 absolute and 2e-2 in L2."""
    mods, jmods, params = tiny_guidance_modules(seed=4, dtype=torch.bfloat16)
    ids = np.random.default_rng(4).integers(1, 100, (2, 16)).astype(np.int32)
    with torch.no_grad():
        h, _ = mods.text_encoder(t(ids))
    jh, _ = jmods.text_encoder.apply({"params": params["text_encoder"]},
                                     jnp.asarray(ids))
    assert h.dtype == torch.bfloat16
    got, want = h.float().numpy(), np.asarray(jh.astype(jnp.float32))
    np.testing.assert_allclose(got, want, atol=0.1, rtol=0)
    assert np.linalg.norm(got - want) <= 2e-2 * np.linalg.norm(want)


# JAX tree -> load_jax_tower_params -> port state_dict -> tower_maps'
# converter gives the JAX tree back bit for bit
@pytest.mark.parametrize("tower", ["text_encoder", "image_encoder", "mapper",
                                   "clean_mapper"])
def test_jax_tree_roundtrip(towers, tower):
    mods, _, params = towers
    fresh = getattr(GuidanceModules.small_test_config(), tower)
    load_jax_tower_params(fresh, params[tower], tower)
    back = jax_tower_tree(fresh, tower)
    flat_want = traverse_util.flatten_dict(params[tower])
    flat_got = traverse_util.flatten_dict(back)
    assert flat_got.keys() == flat_want.keys()
    for k, v in flat_want.items():
        assert np.array_equal(flat_got[k], v), k


def test_load_jax_tower_params_rejects_surplus_leaf(towers):
    _, _, params = towers
    tree = dict(params["text_encoder"], stray={"kernel": np.zeros(2)})
    with pytest.raises(KeyError, match="stray"):
        load_jax_tower_params(GuidanceModules.small_test_config().text_encoder,
                              tree, "text_encoder")


def test_hf_text_state_dict_loads_strict_and_matches():
    """The HF-shaped oracle's state dict (no `text_model.` prefix) loads
    with strict=True and the tower equals the oracle."""
    oracle = randomize(OCLIPText(vocab=100, maxpos=16, dim=64, depth=2,
                                 heads=4), seed=5).eval()
    port = GuidanceModules.small_test_config().text_encoder
    load_reference_tower(port, oracle.state_dict(), "text_encoder")
    ids = torch.randint(0, 100, (2, 16),
                        generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want = oracle(ids)
        got, _ = port(ids)
    assert_close(got, want, **TOL)


def test_reference_mapper_artifact_loads_strict_and_matches():
    """The reference's per-word mapper (OMapper) folds into the stacked
    layout; the global K/V keys an I2T artifact carries are skipped."""
    oracle = randomize(OMapper(32, 64, 4, hidden=1280), seed=6).eval()
    sd = dict(oracle.state_dict())
    sd["down_blocks.0.attentions.0.transformer_blocks.0.attn2_to_k.weight"] \
        = torch.zeros(32, 64)
    port = GuidanceModules.small_test_config().mapper
    load_reference_tower(port, sd, "mapper")
    embs = torch.randn(2, 5, 32, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        assert_close(port(embs), oracle(embs), **TOL)
    back = mapper_reference_state_dict(port)
    assert back.keys() == oracle.state_dict().keys()
    for k, v in oracle.state_dict().items():
        assert torch.equal(back[k], v), k
