"""PyTorch port vs JAX package: NAFNetDynamicFusion (the DiffIR net).

Same numpy inputs, port weights carried to JAX by the JAX package's
`convert_state_dict` (and back by the port's `load_jax_params`), float32
on the CPU, JAX's apply jitted.  Bound: 1e-5 relative in L2 and
1e-4 * max|JAX| at each element.  Also the reference layout
(`tests/torch_oracles.py` ONAFNetDynamic) loaded with strict=True and
its forward, and the refusal of an embedding of another word count.
"""

import jax
import numpy as np
import pytest
import torch

from textualdegremoval_tpu.convert import convert_state_dict
from textualdegremoval_tpu.models.nafnet_dynamic import (
    NAFBlockDynamicFusion as JBlock, NAFNetDynamicFusion as JNet,
)

from textualdegremoval_tpu_torch.convert import (
    load_jax_params, load_reference_checkpoint,
)
from textualdegremoval_tpu_torch.models import define_network
from textualdegremoval_tpu_torch.models.nafnet_dynamic import (
    NAFBlockDynamicFusion, NAFNetDynamicFusion,
)

from torch_port_util import jax_tree, randn, randomize, t
from torch_oracles import ONAFNetDynamic

WORDS = 2
TINY = dict(width=8, middle_blk_num=1, enc_blk_nums=(1, 1),
            dec_blk_nums=(1, 1))


def assert_matches(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def embedding(seed, b=2, words=WORDS):
    return randn(np.random.default_rng(seed), b, words, 1024, scale=0.2)


def net(seed=0, **kw):
    """A TINY port net with every parameter random (beta and gamma too, so
    both halves of each block reach the output)."""
    return randomize(NAFNetDynamicFusion(**{**TINY, "num_words": WORDS,
                                            **kw}), seed, scale=0.05)


def test_block_matches_jax():
    blk = randomize(NAFBlockDynamicFusion(8, WORDS), 1, scale=0.1)
    x = randn(np.random.default_rng(2), 2, 7, 9, 8)
    kv = embedding(3)
    want = jax.jit(JBlock(8).apply)({"params": jax_tree(blk, "blk")}, x, kv)
    with torch.no_grad():
        assert_matches(blk(t(x), t(kv)), want)


@pytest.mark.parametrize("hw", [(16, 16), (13, 18)])
def test_net_matches_jax(hw):
    """(13, 18): padded to multiples of 4 and cropped back."""
    m = net()
    x = randn(np.random.default_rng(4), 2, *hw, 3)
    kv = embedding(5)
    params = convert_state_dict(m.state_dict())
    want = jax.jit(JNet(**TINY).apply)({"params": params}, x, kv)
    with torch.no_grad():
        assert_matches(m(t(x), t(kv)), want)


def test_load_jax_params_round_trip():
    """JAX's tree of a port net loads back into a fresh net exactly: the
    port's rewrite of the DiffIR keys inverts JAX's."""
    m = net(seed=6)
    params = jax.tree.map(np.asarray, convert_state_dict(m.state_dict()))
    fresh = load_jax_params(NAFNetDynamicFusion(**TINY, num_words=WORDS),
                            params)
    for k, v in m.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_reference_state_dict_loads_strict(tmp_path):
    """A randomised reference-layout state dict loads with strict=True and
    the port's forward equals the oracle's (NCHW, sizes a multiple of 4)."""
    oracle = randomize(ONAFNetDynamic(**TINY, num_words=WORDS), 7, 0.05)
    path = tmp_path / "net_g.pth"
    torch.save({"params": oracle.state_dict()}, path)
    m = load_reference_checkpoint(
        define_network({"type": "NAFNetDynamicFusion", "num_words": WORDS,
                        **{k: list(v) if isinstance(v, tuple) else v
                           for k, v in TINY.items()}}), str(path))
    x = randn(np.random.default_rng(8), 2, 16, 12, 3)
    kv = t(embedding(9))
    with torch.no_grad():
        want = oracle(t(x).permute(0, 3, 1, 2), kv).permute(0, 2, 3, 1)
        assert_matches(m(t(x), kv), want.numpy())


@pytest.mark.parametrize("shape", [(2, 3, 1024), (2, 1, 1024),
                                   (2, WORDS, 512), (2, WORDS * 1024)])
def test_embedding_of_another_shape_raises(shape):
    """An embedding whose word count (or width) the affine heads do not
    take raises, naming both counts; it is never reshaped to fit."""
    m = NAFNetDynamicFusion(**TINY, num_words=WORDS)
    with pytest.raises(ValueError, match=f"num_words {WORDS}" if len(shape)
                       == 3 else "must be"):
        m(torch.zeros(2, 8, 8, 3), torch.zeros(shape))


def test_parameter_count_of_the_default_net():
    """Width 64, enc (1, 1, 1, 28), 10 words: ~1.8 B parameters, 1.72 B
    of them in the affine heads (sum of 10 C over the 36 blocks' widths
    times 10 240 inputs), counted from the module tree on the meta
    device."""
    with torch.device("meta"):
        m = NAFNetDynamicFusion()
    heads = sum(p.numel() for n, p in m.named_parameters()
                if n.endswith("kernel.0.weight"))
    widths = [64, 128, 256] + [512] * 28 + [1024] + [512, 256, 128, 64]
    assert heads == 10 * 10240 * sum(widths) == 1_717_043_200
    assert 1.7e9 < sum(p.numel() for p in m.parameters()) < 1.9e9
