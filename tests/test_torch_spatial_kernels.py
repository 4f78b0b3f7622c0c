"""The statistics row window of B1's kernels, on the CPU: csrc/tblock.cu's
`tblock_stats_rows` (float32 pass A) and csrc/fwd_stencil.cu's
`fwd_qkv_stencil_rows` (the bf16 pipeline's square sums), with the
pipeline's gram over the same rows (csrc/wgrad.cu on the view from row
lo), compiled for the host against tests/cuda_host_shim.h and run through
the launch code the CUDA path uses.  With a window each equals the plain
sums over exactly those rows; without one (the entries `tblock_stats` and
`fwd_qkv_stencil`, the whole tensor), each output is bit-equal to the
windowed entry's over every row, which is what the unsharded routes run.
A row-sharded block passes its own rows, leaving its halo out
(ops/pallas/tblock.py `_sharded`)."""

import numpy as np
import pytest
import torch

from textualdegremoval_tpu_torch.models.layers import TransformerBlock
from textualdegremoval_tpu_torch.ops.dwconv import dwconv
from textualdegremoval_tpu_torch.ops.pallas import tblock as tb
from textualdegremoval_tpu_torch.ops.pallas.mdta import mdta_sums_ref
from textualdegremoval_tpu_torch.ops.pallas.tblock_bwd import _EPS, _ln_rows

from torch_port_util import assert_close, build_host_library, randn, t

BF = torch.bfloat16
WINDOWS = [(2, 9), (0, 11), (4, 4), (0, 3), (7, 11)]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_host_library(
        tmp_path_factory.mktemp("host_window"),
        ("tblock.cu", "fwd_stencil.cu", "wgrad.cu", "bwd_gemm.cu",
         "bwd_stencil.cu"))


def _block(c, heads, dtype, seed=0):
    """A block's parameters at a trained scale, its kernel weights in
    dtype, and an input (2, 11, 10, c) in dtype."""
    rng = np.random.default_rng(seed)
    blk = TransformerBlock(c, heads)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            scale = p[0].numel() ** -0.5 if p.dim() > 1 else 0.1
            p.copy_(t(randn(rng, *p.shape, scale=scale))
                    + (1.0 if name.endswith("weight") and p.dim() == 1
                       else 0.0))
    p = {k: v.detach() for k, v in blk.block_params().items()}
    x = t(randn(rng, 2, 11, 10, c)).to(dtype)
    return p, tb.prepare_tblock_weights(p, dtype, "WithBias"), x


def _plain_qk(x, p):
    """q and k of the block (f32): LN1, the 1x1, the depthwise stencil
    with zero padding."""
    c = x.shape[-1]
    y = tb._ln(x.float(), p["norm1_w"], p["norm1_b"], "WithBias")
    qkv = dwconv(y @ p["qkv"].reshape(c, 3 * c), p["qkv_dw"])
    return qkv[..., :c], qkv[..., c:2 * c]


def _stats(lib, x, kw, heads, rows):
    tiles = tb._block_tiles(lib, x, heads, sms=2)
    return tb._pass_a(lib, x, kw, heads, "WithBias", tiles[0], tiles[2], 0,
                      rows)


@pytest.mark.parametrize("rows", WINDOWS)
def test_tblock_stats_window_equals_plain_sums(host_lib, rows):
    p, kw, x = _block(32, 2, torch.float32)
    q, k = _plain_qk(x, p)
    got = _stats(host_lib, x, kw, 2, rows)
    want = mdta_sums_ref(q, k, 2, rows)
    for g, w in zip(got, want):
        assert_close(g, w, atol=1e-4, rtol=1e-5)


def test_tblock_stats_without_window_is_the_whole_tensor(host_lib):
    """The entry without a window (what the chain's pass A and every
    unsharded call ran before the window) bit-equal to the windowed entry
    over every row."""
    p, kw, x = _block(32, 2, torch.float32, seed=1)
    b, hgt, wdt, c = x.shape
    tiles = tb._block_tiles(host_lib, x, 2, sms=2)
    nsplit = tiles[2]
    parts = []
    for entry, extra in ((host_lib.tblock_stats, ()),
                         (host_lib.tblock_stats_rows, (0, hgt))):
        out = (torch.empty(b, nsplit, 2, 16, 16), torch.empty(b, nsplit, c),
               torch.empty(b, nsplit, c))
        assert entry(
            tb._ptr(x), tb._ptr(kw["ln1w"]), tb._ptr(kw["ln1b"]),
            tb._ptr(kw["wq"]), tb._ptr(kw["wk"]), tb._ptr(kw["dwqk"]),
            *map(tb._ptr, out), b, hgt, wdt, c, 2, 0, 0, *tiles[0], nsplit,
            *extra, None) == 0
        parts.append(out)
    assert all(torch.equal(u, v) for u, v in zip(*parts))
    assert host_lib.tblock_stats_rows(
        tb._ptr(x), *[None] * 8, b, hgt, wdt, c, 2, 0, 0, *tiles[0], nsplit,
        3, hgt + 1, None) != 0  # a window past the tensor is refused


def _qkv_stencil(lib, lins, dwall, nsplit, rows=None):
    b, hgt, wdt, c3 = lins.shape
    c = c3 // 3
    qkv = torch.empty(b, hgt, wdt, c3, dtype=BF)
    part = torch.empty(b, nsplit, 2 * c)
    args = (tb._ptr(lins), tb._ptr(dwall), tb._ptr(qkv), tb._ptr(part), b,
            hgt, wdt, c, nsplit)
    rc = (lib.fwd_qkv_stencil(*args, None) if rows is None
          else lib.fwd_qkv_stencil_rows(*args, *rows, None))
    assert rc == 0
    return qkv, part


@pytest.mark.parametrize("rows", WINDOWS)
def test_qkv_stencil_window_equals_plain_sums(host_lib, rows):
    rng = np.random.default_rng(3)
    c = 48
    lins = t(randn(rng, 2, 11, 21, 3 * c)).to(BF)
    dwall = t(randn(rng, 27, c, scale=1 / 3))
    qkv, part = _qkv_stencil(host_lib, lins, dwall, 3, rows)
    sq = qkv[:, rows[0]: rows[1], :, :2 * c].float()
    want = (sq * sq).sum((1, 2))
    assert_close(part.sum(1), want, atol=1e-6, rtol=1e-5)
    whole, whole_part = _qkv_stencil(host_lib, lins, dwall, 3)
    assert torch.equal(qkv, whole)  # the window moves no output value
    if rows == (0, 11):
        assert torch.equal(part, whole_part)


@pytest.mark.parametrize("rows", [(2, 9), (0, 11), (5, 5)])
def test_pipeline_attention_window(host_lib, rows):
    """`_pipeline_attn` with a window: the gram (csrc/wgrad.cu on the view
    from row lo) and the square sums over those rows of the pipeline's
    own q and k, as the glue hands them back; reduce sees them before the
    glue; no window equals the whole-tensor window bit for bit."""
    p, kw, x = _block(64, 2, BF, seed=2)
    c = x.shape[-1]
    ys = _ln_rows(host_lib, x, kw["ln1w"], kw["ln1b"], 0, 0, _EPS)[0]
    seen = []
    buf = {}
    x1, (gram, qssq, kssq) = tb._pipeline_attn(
        host_lib, x, ys, kw, 2, 3, 0, buf, rows,
        lambda *s: seen.append([v.clone() for v in s]))
    qkv = buf["qkv"].reshape(x.shape[:3] + (3 * c,))
    want = mdta_sums_ref(qkv[..., :c], qkv[..., c:2 * c], 2, rows)
    assert_close(gram, want[0], atol=1e-3, rtol=1e-5)
    assert_close(qssq, want[1], atol=1e-3, rtol=1e-5)
    assert_close(kssq, want[2], atol=1e-3, rtol=1e-5)
    assert len(seen) == 1 and torch.equal(seen[0][0], gram)
    if rows == (0, 11):
        x1_whole, stats = tb._pipeline_attn(host_lib, x, ys, kw, 2, 3, 0)
        assert torch.equal(x1_whole, x1)
        assert all(torch.equal(u, v) for u, v in zip(stats, (gram, qssq,
                                                             kssq)))
