"""On-card checks of the bf16 NAFBlock pipeline `naf_pipeline` (marked
`cuda`; each skips without a CUDA device).  The file imports neither jax
nor the test helpers that do, so the card's machine runs it without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_nafblock_fwd_cuda.py
"""

import pytest
import torch

import textualdegremoval_tpu_torch.ops.pallas.nafblock as nb
from textualdegremoval_tpu_torch.models.layers import NAFBlock

from chip_smoke import _pair_call, randomize_nafblock

# the pipeline against csrc/nafblock.cu's pair: both round at the same
# points and differ only in the order of f32 sums (wgmma and mma.sync), so
# a value's rounding flips by an ulp here and there, the more the longer
# the sums: L2 over what the block adds to x, half the bound against the
# plain version (each reads 7.7e-3 to 8.1e-3 of it on an H100; the two
# kernels 3.2e-3 apart at C = 2048)
PAIR_BRANCH = 1e-2


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _block(c, dtype, seed, shape=(2, 37, 53)):
    gen = torch.Generator().manual_seed(seed)
    blk = NAFBlock(c)
    randomize_nafblock(blk, gen)
    x = torch.randn(*shape, c, generator=gen)
    return blk.to("cuda"), x.to("cuda", dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("c,shape", [
    (64, (2, 37, 53)),     # ragged tiles, batch 2
    (40, (1, 24, 40)),     # 24 padded gate channels
    (2048, (1, 32, 32)),   # the middle fusion block, eight tiles
])
def test_pipeline_matches_pair(c, shape):
    _cuda()
    blk, x = _block(c, torch.bfloat16, seed=c, shape=shape)
    kw = nb.prepare_nafblock_weights(blk.block_params(), torch.bfloat16)
    before = nb.naf_pipeline.launches
    with torch.inference_mode():
        got = blk(x)
        pair = _pair_call(x, kw)()
        want = nb.nafblock_ref(x, blk.block_params())
    assert nb.naf_pipeline.launches == before + 1
    added = (want.float() - x.float()).norm()
    assert (got.float() - pair.float()).norm() <= PAIR_BRANCH * added


@pytest.mark.cuda
@pytest.mark.parametrize("c,dtype", [(36, torch.bfloat16),
                                     (64, torch.float32)])
def test_other_widths_and_f32_take_the_pair(c, dtype):
    _cuda()
    blk, x = _block(c, dtype, seed=1)
    before = (nb.nafblock_fused.launches, nb.naf_pipeline.launches)
    with torch.inference_mode():
        blk(x)
    assert (nb.nafblock_fused.launches - before[0],
            nb.naf_pipeline.launches - before[1]) == (1, 0)


@pytest.mark.cuda
def test_pipeline_kernels_refuse_bad_arguments():
    """The C entries return an error, and the wrapper raises, on what the
    kernels cannot take."""
    _cuda()
    from textualdegremoval_tpu_torch.ops._build import load_library

    lib = load_library()
    assert lib.naf_gate_stencil(None, None, None, None, None, None, 1, 4, 4,
                                48, 1, 0, None) != 0  # cpad % 32
    assert lib.naf_gemm_gate(None, None, None, None, 64, 96, 64,
                             None) != 0  # N % 64
    with pytest.raises(RuntimeError, match="naf_sca_glue"):
        nb._check(lib.naf_sca_glue(None, None, None, None, 1, 16, 40, 32, 1,
                                   None), lib, "naf_sca_glue")
