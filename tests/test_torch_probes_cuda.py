"""On-card checks of the probe kernels (csrc/probe_qkv_form.cu,
csrc/probe_stencil.cu; marked `cuda`, each skips without a CUDA device).
The file imports neither jax nor the test helpers that do, so the card's
machine runs it without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_probes_cuda.py
"""

from unittest import mock

import pytest
import torch

import textualdegremoval_tpu_torch.ops.probes as pr
from textualdegremoval_tpu_torch.tools import bench_qkv_form, bench_stencil

# kernel vs plain: |k - p| <= a max|p| + r |p| at every element and
# ||k - p|| <= l2 ||p||, (a, r, l2) of chip_smoke.py's phases 23 and 24
# and the reasons given there
from chip_smoke import QKV_TOL, STENCIL_TOL, _err_use


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _qkv_inputs(c, co, shape, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(*shape, c, generator=gen)
    w = torch.randn(c, co, generator=gen) * c ** -0.5
    dw = torch.randn(9, co, generator=gen) / 3
    return x.cuda(), w.cuda(), dw.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["current", "composed"])
@pytest.mark.parametrize("c,co,shape", [
    (48, 48, (1, 64, 64)),
    (96, 256, (2, 37, 53)),   # ragged: no tile divides H or W
    (24, 40, (1, 19, 7)),     # co not a multiple of 16
])
def test_qkv_kernel_matches_plain(form, dtype, c, co, shape):
    _cuda()
    x, w, dw = _qkv_inputs(c, co, shape, seed=c + co)
    x = x.to(dtype)
    kw = pr.prepare_qkv_weights(w, dw, dtype)
    kernel = pr.qkv_current if form == "current" else pr.qkv_composed
    before = kernel.launches
    with torch.inference_mode():
        got = kernel(x, kw)
        want = (pr.qkv_current_ref(x, w, dw) if form == "current"
                else pr.qkv_composed_ref(x, pr.compose_w9(w, dw)))
        assert torch.equal(got, kernel(x, kw))
    assert kernel.launches == before + 2
    assert got.shape == (*shape, co) and torch.isfinite(got).all()
    _, use, l2_use = _err_use(got, want, *QKV_TOL[form][dtype])
    assert max(use, l2_use) <= 1.0, (use, l2_use)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", pr.VARIANTS)
@pytest.mark.parametrize("shape", [(10, 512, 128), (5, 37, 3)])
def test_stencil_kernel_matches_plain(variant, shape):
    _cuda()
    gen = torch.Generator().manual_seed(shape[1])
    x = torch.randn(*shape, generator=gen).to("cuda", torch.bfloat16)
    taps = torch.randn(9, shape[2], generator=gen).cuda()
    with torch.inference_mode():
        for iters in (1, 2, 3, 4):
            got = pr.stencil_loop(x, taps, variant, iters)
            want = pr.stencil_ref(x, taps, variant, iters)
            _, use, l2_use = _err_use(got, want, *STENCIL_TOL)
            assert max(use, l2_use) <= 1.0, (iters, use, l2_use)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take():
    _cuda()
    x, w, dw = _qkv_inputs(16, 16, (1, 8, 8), seed=1)
    kw = pr.prepare_qkv_weights(w, dw, torch.bfloat16)
    with pytest.raises(ValueError, match="prepared"):
        pr.qkv_current(x, kw)                 # f32 x, bf16 weights
    with pytest.raises(ValueError, match="contiguous"):
        pr.qkv_composed(x.bfloat16().transpose(1, 2), kw)
    with pytest.raises(ValueError, match="bfloat16"):
        pr.stencil_loop(torch.zeros(4, 8, 2, device="cuda"),
                        torch.zeros(9, 2, device="cuda"), "bf16acc", 1)


@pytest.mark.cuda
def test_tools_run_on_the_card(capsys):
    _cuda()
    with mock.patch.multiple(bench_qkv_form, PX=64, ITERS=2, REPEATS=1):
        rows = bench_qkv_form.main([])
    assert all(r["rel_err_current"] < 2e-2 and r["rel_err_composed"] < 2e-2
               for r in rows)
    res = bench_stencil.main(["64", "8", "4", "50"])
    assert all(r["peak_fraction"] > 0 for r in res["rows"])
    assert "device: " in capsys.readouterr().out
