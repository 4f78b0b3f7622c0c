"""On-card checks of the cross-block chain (in bf16 at C and C / heads
multiples of 8 `chain_pipeline` with csrc/bwd_gemm.cu's chain epilogue,
else csrc/tblock_chain.cu) and of the whole-block kernel at PromptIR's
widths (marked `cuda`; each skips without a CUDA device).  The file imports neither jax nor the test
helpers that do, so the card's machine runs it without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_tblock_chain_cuda.py
"""

import pytest
import torch

import textualdegremoval_tpu_torch.ops.pallas.tblock as tb
from textualdegremoval_tpu_torch.models.layers import (
    TBlockStage, TransformerBlock,
)

# kernel vs plain: |k - p| <= atol + rtol |p| at every element (TOL) and
# ||k - p|| <= branch ||p - x|| over what the blocks add (BRANCH_TOL), the
# bounds of chip_smoke.py and the reasons given there
from chip_smoke import BRANCH_TOL, TOL, randomize_block


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _check(got, want, x, dtype, depth=1):
    """Phase 3's bounds for one block, times sqrt(depth) against a plain
    chain of `depth` blocks (chip_smoke.py `chain_vs_plain`)."""
    got, want = got.float(), want.float()
    atol, rtol = TOL[dtype]
    scale = depth ** 0.5
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= scale * (atol + rtol * want.abs())).all(), \
        (got - want).abs().max().item()
    branch = (got - want).norm() / (want - x.float()).norm()
    assert branch <= scale * BRANCH_TOL[dtype], branch.item()


def _stage(c, heads, n, ln_type, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    stage = TBlockStage(c, heads, n, ln_type=ln_type, chain=True)
    for blk in stage:
        randomize_block(blk, gen)
    x = torch.randn(2, 37, 53, c, generator=gen)
    return stage.to("cuda", dtype), x.to("cuda", dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,heads,n,ln_type", [
    (48, 1, 3, "WithBias"),
    (96, 2, 2, "BiasFree"),
    (192, 4, 2, "WithBias"),   # bf16: one warpgroup holds a row (BN 192)
    (384, 8, 2, "WithBias"),   # f32: gram accumulators in device memory;
                               # bf16: two warpgroups share a row
    (48, 4, 2, "BiasFree"),    # bf16 at 12 channels a head:
                               # csrc/tblock_chain.cu
])
def test_chain_matches_plain_chain(c, heads, n, ln_type, dtype):
    _cuda()
    stage, x = _stage(c, heads, n, ln_type, dtype, seed=c + n)
    ps = [blk.block_params() for blk in stage]
    calls, launches = tb.tblock_chain_fused.calls, tb.tblock_chain_fused.launches
    pipe = tb.chain_pipeline.launches
    with torch.inference_mode():
        got = stage(x)
        again = stage(x)
        want = tb.tblock_chain_ref(x, ps, heads, ln_type)
        blocks = x
        for blk in stage:
            blocks = blk(blocks)
    assert tb.tblock_chain_fused.calls == calls + 2
    assert tb.tblock_chain_fused.launches == launches + 2 * (n - 1)
    on_pipeline = dtype == torch.bfloat16 and (c // heads) % 8 == 0
    assert tb.chain_pipeline.launches == pipe + 2 * (n - 1) * on_pipeline
    assert torch.equal(got, again)
    _check(got, blocks, x, dtype, depth=n)
    _check(got, want, x, dtype, depth=n)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [
    (262144, 48, 128),   # encoder level 1 of a 512 px forward
    (65536, 96, 256),
    (16384, 192, 512),
    (4096, 384, 1024),   # the latent: two warpgroups share a row
    (3921, 376, 96),     # ragged rows, the split ragged in N
])
@pytest.mark.parametrize("ln_type", ["WithBias", "BiasFree"])
def test_chain_epilogue_matches_residual_and_ln_rows(m, n, k, ln_type):
    """`fwd_gemm_residual_ln` on the card: out bitwise what
    `fwd_gemm_residual` writes, y within one bf16 ulp of `bwd_ln_rows` on
    that out, two calls bitwise equal."""
    _cuda()
    from textualdegremoval_tpu_torch.ops._build import load_library
    from textualdegremoval_tpu_torch.ops.pallas.tblock_bwd import (
        _EPS, _ln_rows)

    lib = load_library()
    gen = torch.Generator().manual_seed(n + k)
    bf, p = torch.bfloat16, tb._ptr
    a = (torch.randn(m, k, generator=gen) * k ** -0.25).to("cuda", bf)
    b = (torch.randn(n, k, generator=gen) * k ** -0.25).to("cuda", bf)
    res = (torch.randn(m, n, generator=gen)
           + torch.randn(m, 1, generator=gen)).to("cuda", bf)
    w = (1 + 0.3 * torch.randn(n, generator=gen)).cuda()
    bias = (0.2 * torch.randn(n, generator=gen)).cuda()
    bias_free = int(ln_type == "BiasFree")
    stream = torch.cuda.current_stream().cuda_stream
    outs = []
    for _ in range(2):
        out, y = (torch.empty(m, n, device="cuda", dtype=bf)
                  for _ in range(2))
        assert lib.fwd_gemm_residual_ln(
            p(a), p(b), p(res), p(w), p(bias), bias_free, _EPS, p(out), p(y),
            m, n, k, stream) == 0
        outs.append((out, y))
    want = torch.empty(m, n, device="cuda", dtype=bf)
    assert lib.fwd_gemm_residual(p(a), p(b), p(res), p(want), m, n, k,
                                 stream) == 0
    want_y = _ln_rows(lib, want, w, bias, bias_free, stream, _EPS)[0]
    (out, y), (out2, y2) = outs
    assert torch.equal(out, want)
    assert torch.equal(out, out2) and torch.equal(y, y2)
    diff = (y.float() - want_y.float()).abs()
    assert (diff <= 2 ** -7 * want_y.float().abs() + 1e-6).all(), diff.max()
    assert (y == want_y).float().mean() > 0.95


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [704, 320, 160])
def test_block_kernel_at_promptir_widths(c, dtype):
    _cuda()
    gen = torch.Generator().manual_seed(c)
    blk = TransformerBlock(c, 4)
    randomize_block(blk, gen)
    blk = blk.to("cuda", dtype)
    x = torch.randn(1, 19, 27, c, generator=gen).to("cuda", dtype)
    before = tb.tblock_fused.launches
    with torch.inference_mode():
        got = blk(x)
        want = tb.tblock_ref(x, blk.block_params(), 4)
    assert tb.tblock_fused.launches == before + 1
    _check(got, want, x, dtype)


@pytest.mark.cuda
def test_chain_gradients_match_plain_autograd():
    _cuda()
    stage, x = _stage(48, 2, 3, "WithBias", torch.float32, seed=7)
    x.requires_grad_(True)
    g = torch.randn(x.shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(8))
    launches = tb.tblock_chain_fused.launches
    got = torch.autograd.grad(stage(x), [x, *stage.parameters()], g)
    assert tb.tblock_chain_fused.launches == launches + 2
    ps = [blk.block_params() for blk in stage]
    want = torch.autograd.grad(tb.tblock_chain_ref(x, ps, 2), [
        x, *stage.parameters()], g)
    for a, b in zip(got, want):
        assert (a - b).norm() <= 1e-3 * b.norm().clamp_min(1e-30)
