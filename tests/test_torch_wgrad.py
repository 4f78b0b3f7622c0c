"""csrc/wgrad.cu, the weight-gradient products and the forward's gram
(out = A^T B summed over pixels, split over the pixel axis), compiled for
the host with tests/cuda_host_shim.h (TMA boxes and wgmma descriptors with
both operands MN-major emulated), against torch.matmul on the same
operands.

The operands are the ones the block hands it: pixel rows with channels
contiguous, at the widths of the products (M, N among 48, 96, 176, 3 C and
2 hpad), as strided and offset views (the k third of q | k | v at stride
3 C, per-head batches over (image, head)), at pixel counts that are not a
multiple of the kernel's 64-pixel step, split once and several times.
bf16 products are exact in f32, so the kernel differs from a float64
product of the same bf16 values only by the order of its f32 sums: atol
1e-4 at sums of O(10), rtol 1e-5.  A repeated call is bitwise equal (no
atomics; partials added in a fixed order).
"""

import numpy as np
import pytest
import torch

import textualdegremoval_tpu_torch.ops.pallas.tblock_bwd as gb

from torch_port_util import randn, t, build_host_library

BF = torch.bfloat16
ATOL, RTOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/wgrad.cu compiled for the CPU against tests/cuda_host_shim.h."""
    return build_host_library(tmp_path_factory.mktemp("host_wgrad"),
                              ("wgrad.cu",))


def _views(x, ld, s, npix, m, nb):
    """(nb1, nb2, npix, m) view of an operand as the kernel reads it."""
    return torch.as_strided(x, (nb[0], nb[1], npix, m),
                            (s[0], s[1], ld, 1), x.storage_offset())


def _product(lib, a, lda, sa, b, ldb, sb, npix, m, n, nb, nsplit):
    """The kernel's partials at an explicit split count, summed in split
    order: (nb1, nb2, m, n) f32."""
    out = torch.empty((nsplit, nb[0], nb[1], m, n))
    assert lib.tblock_wgrad(
        gb._ptr(a), lda, sa[0], sa[1], gb._ptr(b), ldb, sb[0], sb[1],
        gb._ptr(out), npix, m, n, nb[0], nb[1], nsplit,
        int(a.dtype == BF), None) == 0
    return out.sum(0)


def _want(a, lda, sa, b, ldb, sb, npix, m, n, nb):
    av = _views(a, lda, sa, npix, m, nb).double()
    bv = _views(b, ldb, sb, npix, n, nb).double()
    return (av.transpose(-1, -2) @ bv).float()


# (M, N, pixels): dW1 at C = 48 (48 x 2 hpad, hpad 128), dWqkv at C = 48
# (48 x 3 C), dW2 (hpad x C), dWproj at C = 96, dW1 at C = 96 (96 x 512,
# two column tiles of 256), PromptIR's dA (176 x 176: two row tiles, the
# second mostly past M)
@pytest.mark.parametrize("m,n,npix", [
    (48, 256, 70), (48, 144, 130), (128, 48, 64), (96, 96, 200),
    (96, 512, 75), (176, 176, 66)])
@pytest.mark.parametrize("nsplit", [1, 3])
def test_wgrad_matches_matmul(host_lib, m, n, npix, nsplit):
    rng = np.random.default_rng(m + n + npix)
    a = t(randn(rng, npix, m)).to(BF)
    b = t(randn(rng, npix, n)).to(BF)
    got = _product(host_lib, a, m, (0, 0), b, n, (0, 0), npix, m, n, (1, 1),
                   nsplit)
    want = _want(a, m, (0, 0), b, n, (0, 0), npix, m, n, (1, 1))
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("cph,heads", [(48, 2), (96, 1), (176, 1)])
def test_wgrad_per_head_strided_views(host_lib, cph, heads):
    """The forward's gram q_h^T k_h and the backward's dA = do_h^T v_h per
    (image, head): A and B are heads of pixel-major matrices, k and v at
    their offsets inside q | k | v (row stride 3 C), images hw rows
    apart; 100 pixels an image (a ragged last step)."""
    rng = np.random.default_rng(cph)
    bsz, hw = 2, 100
    c = heads * cph
    qkv = t(randn(rng, bsz * hw, 3 * c)).to(BF)
    dos = t(randn(rng, bsz * hw, c)).to(BF)
    nb = (bsz, heads)
    s3, s1 = (hw * 3 * c, cph), (hw * c, cph)
    for a, lda, sa, b in ((qkv, 3 * c, s3, qkv[:, c:]),
                          (dos, c, s1, qkv[:, 2 * c:])):
        want = _want(a, lda, sa, b, 3 * c, s3, hw, cph, cph, nb)
        for nsplit in (1, 2):
            got = _product(host_lib, a, lda, sa, b, 3 * c, s3, hw, cph, cph,
                           nb, nsplit)
            torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


def test_wgrad_wrapper_splits_and_repeats_bitwise(host_lib):
    """`_wgrad` picks its split count from the kernel's tiles and CTA slots
    (several splits here: 2 slots a tile on a 12-SM card), sums the
    partials in a fixed order, and a repeated call is bitwise equal; the
    float32 kernel gives the same product."""
    rng = np.random.default_rng(7)
    npix, m, n = 1000, 96, 288
    a, b = t(randn(rng, npix, m)), t(randn(rng, npix, n))
    sms = 12
    tiles = host_lib.tblock_wgrad_tiles(m, n)
    slots = host_lib.tblock_wgrad_ctas_per_sm(m, n) * sms
    assert tiles == 2 and slots // tiles > 1
    abf, bbf = a.to(BF), b.to(BF)
    first = gb._wgrad(host_lib, abf, m, (0, 0), bbf, n, (0, 0), npix, m, n,
                      (1, 1), sms, 0)
    again = gb._wgrad(host_lib, abf, m, (0, 0), bbf, n, (0, 0), npix, m, n,
                      (1, 1), sms, 0)
    assert torch.equal(first, again)
    want = _want(abf, m, (0, 0), bbf, n, (0, 0), npix, m, n, (1, 1))
    torch.testing.assert_close(first, want, atol=2 * ATOL, rtol=RTOL)
    f32 = gb._wgrad(host_lib, a, m, (0, 0), b, n, (0, 0), npix, m, n, (1, 1),
                    sms, 0)
    torch.testing.assert_close(
        f32, _want(a, m, (0, 0), b, n, (0, 0), npix, m, n, (1, 1)),
        atol=2 * ATOL, rtol=RTOL)


def test_wgrad_refuses_what_tma_cannot_read(host_lib):
    """The bf16 kernel reads rows through TMA: a row stride that is not a
    multiple of 16 bytes, or N not a multiple of 4 (its 16-byte stores),
    is refused, not read wrong."""
    a = torch.zeros(64, 20, dtype=BF)
    out = torch.empty(1, 1, 1, 20, 20)
    assert host_lib.tblock_wgrad(gb._ptr(a), 20, 0, 0, gb._ptr(a), 20, 0, 0,
                                 gb._ptr(out), 64, 20, 20, 1, 1, 1, 1,
                                 None) != 0
    b = torch.zeros(64, 24, dtype=BF)
    assert host_lib.tblock_wgrad(gb._ptr(b), 24, 0, 0, gb._ptr(b), 24, 0, 0,
                                 gb._ptr(out), 64, 24, 22, 1, 1, 1, 1,
                                 None) != 0


def test_reckoning_covers_the_products_and_pass_1(capsys):
    """`tools/bench_block_bwd.py --reckon` (no card) models each
    weight-gradient product and each pass of the bf16 pass 1 at every
    training shape, and sums them per step beside their bounds."""
    import json

    from textualdegremoval_tpu_torch.tools import bench_block_bwd as tool

    assert tool.main(["--reckon"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    kernels = {(r["group"], r["kernel"].split(" ")[0]) for r in lines
               if "kernel" in r}
    assert {("wgrad", "wgrad"), ("pass 1", "qkv_stencil"),
            ("pass 1", "heads_o"), ("pass 2", "dlin_stencil")} <= kernels
    products = {r["kernel"].split(" ")[1] for r in lines
                if r.get("group") == "wgrad"}
    assert products == {"dW1", "dW2", "dA", "dWproj", "dWqkv", "gram"}
    step = lines[-1]
    assert set(step["per_step_predicted_ms"]) == set(tool.GROUPS)
    assert 0 < step["per_step_bound_ms"]["wgrad"] \
        < step["per_step_predicted_ms"]["wgrad"]
