"""On-card checks of the TransformerBlock backward kernels and the training
step (marked `cuda`; each skips without a CUDA device).  The file imports
neither jax nor the test helpers that do, so the card's machine runs it
without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_tblock_bwd_cuda.py
"""

import pytest
import torch

import textualdegremoval_tpu_torch.ops.pallas.tblock as tb
import textualdegremoval_tpu_torch.ops.pallas.tblock_attn_bwd as ab
import textualdegremoval_tpu_torch.ops.pallas.tblock_bwd as gb
from textualdegremoval_tpu_torch.losses import l1_loss
from textualdegremoval_tpu_torch.models.layers import TransformerBlock
from textualdegremoval_tpu_torch.models.restormer import RestormerRefFusion
from textualdegremoval_tpu_torch.tools.bench_block_bwd import TRAIN_SHAPES

# kernel vs plain autograd: ||k - p|| <= bound ||p|| per gradient, the
# bounds of chip_smoke.py phase 6 and the reasons given there
from chip_smoke import grad_l2_bound, randomize_block

TINY_REF = dict(dim=16, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
                heads=(1, 2, 2, 4), nf=16, ext_n_blocks=(1, 1, 1, 1),
                reffusion_n_blocks=(1, 1, 1, 1), lr_block_size=4)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _setup(shape, heads, ln_type, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    blk = TransformerBlock(shape[-1], heads, ln_type=ln_type)
    randomize_block(blk, gen)
    p = {k: v.detach().cuda() for k, v in blk.block_params().items()}
    x = torch.randn(*shape, generator=gen).to("cuda", dtype)
    g = torch.randn(*shape, generator=gen).to("cuda", dtype)
    kw = tb.prepare_tblock_weights(p, dtype, ln_type)
    with torch.no_grad():
        _, x1, stats = tb._forward_kernel(x, kw, heads, ln_type, want_x1=True)
    return p, x, g, x1, stats, kw


def _kernel_grads(p, x, g, x1, stats, kw, heads, ln_type):
    dx1, gg = gb.gdfn_half_bwd(x1, g, p, ln_type, kw)
    dx, ga = ab.attn_half_bwd(x, dx1, p, heads, ln_type, stats, kw)
    return {"dx1": dx1, "dx": dx, **gg, **ga}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,heads,ln_type", [
    ((2, 37, 53, 96), 2, "WithBias"),    # ragged tiles in H and W
    ((2, 24, 40, 48), 1, "BiasFree"),
    ((1, 16, 24, 384), 4, "WithBias"),   # a wide block: small tiles
    # C = 48 and 768 at ragged shapes: C below one 64-channel box, and
    # the widest block (hpad 2048, 96 channels per head)
    ((2, 21, 35, 48), 1, "WithBias"),
    ((1, 11, 19, 768), 8, "BiasFree"),
])
def test_backward_kernels_match_plain(shape, heads, ln_type, dtype):
    _cuda()
    p, x, g, x1, stats, kw = _setup(shape, heads, ln_type, dtype, seed=0)
    got = _kernel_grads(p, x, g, x1, stats, kw, heads, ln_type)
    want_dx1, want_gg = gb.gdfn_half_bwd_ref(x1, g, p, ln_type)
    want_dx, want_ga = ab.attn_half_bwd_ref(x, got["dx1"], p, heads, ln_type)
    want = {"dx1": want_dx1, "dx": want_dx, **want_gg, **want_ga}
    assert set(got) == set(want)
    for k, w in want.items():
        err = (got[k].float() - w.float()).norm() / w.float().norm()
        assert torch.isfinite(got[k]).all(), k
        assert err <= grad_l2_bound(k, dtype), (k, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weight_gradients_are_bitwise_repeatable(dtype):
    """Per-CTA partials and split-K partials are summed in a fixed order;
    no float atomics, so two runs give the same bits."""
    _cuda()
    p, x, g, x1, stats, kw = _setup((4, 48, 64, 96), 2, "WithBias", dtype, 1)
    a = _kernel_grads(p, x, g, x1, stats, kw, 2, "WithBias")
    b = _kernel_grads(p, x, g, x1, stats, kw, 2, "WithBias")
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("shape,heads", [
    *((s[:4], s[4]) for s in TRAIN_SHAPES),
    ((2, 64, 64, 704), 4),  # PromptIR's noise blocks: 176 channels a head
])
def test_bf16_backward_at_training_shapes(shape, heads):
    """bf16 at every block shape of the 384 px batch-8 step and at 176
    channels per head (pass 1 as the shared passes, the weight gradients
    on the TMA + wgmma products): every gradient within phase 6's bound
    of plain autograd, and a second call bitwise equal."""
    _cuda()
    p, x, g, x1, stats, kw = _setup(shape, heads, "WithBias", torch.bfloat16,
                                    3)
    got = _kernel_grads(p, x, g, x1, stats, kw, heads, "WithBias")
    again = _kernel_grads(p, x, g, x1, stats, kw, heads, "WithBias")
    want_dx1, want_gg = gb.gdfn_half_bwd_ref(x1, g, p, "WithBias")
    want_dx, want_ga = ab.attn_half_bwd_ref(x, got["dx1"], p, heads,
                                            "WithBias")
    want = {"dx1": want_dx1, "dx": want_dx, **want_gg, **want_ga}
    for k, w in want.items():
        err = (got[k].float() - w.float()).norm() / w.float().norm()
        assert torch.isfinite(got[k]).all(), k
        assert err <= grad_l2_bound(k, torch.bfloat16), (k, err)
        assert torch.equal(got[k], again[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("c", [704, 320, 160])
def test_float32_attention_backward_at_promptir_noise_widths(c):
    """The float32 passes (csrc/tblock_attn_bwd.cu) at PromptIR's noise
    blocks, 4 heads (176 / 80 / 40 channels a head): every gradient within
    phase 6's float32 bound of plain autograd, a second call bitwise
    equal (the refusal above 192 channels a head: tests/
    test_torch_tblock_bwd.py, on the host build)."""
    _cuda()
    p, x, g, x1, stats, kw = _setup((1, 24, 20, c), 4, "WithBias",
                                    torch.float32, 4)
    dx, got = ab.attn_half_bwd(x, g, p, 4, "WithBias", stats, kw)
    dx2, again = ab.attn_half_bwd(x, g, p, 4, "WithBias", stats, kw)
    want_dx, want = ab.attn_half_bwd_ref(x, g, p, 4, "WithBias")
    for k, w in {"dx": want_dx, **want}.items():
        v, v2 = (dx, dx2) if k == "dx" else (got[k], again[k])
        err = (v - w).norm() / w.norm()
        assert torch.isfinite(v).all(), k
        assert err <= grad_l2_bound(k, torch.float32), (k, err)
        assert torch.equal(v, v2), k


@pytest.mark.cuda
def test_bf16_width_not_a_multiple_of_8_is_refused():
    """The bf16 kernels read pixel rows through TMA (rows of 16-byte
    multiples): C = 44 is refused with a message, not run."""
    _cuda()
    p, x, g, x1, stats, kw = _setup((1, 8, 8, 44), 1, "WithBias",
                                    torch.bfloat16, 2)
    with pytest.raises(ValueError, match="multiples of 8"):
        gb.gdfn_half_bwd(x1, g, p, "WithBias", kw)
    with pytest.raises(ValueError, match="multiples of 8"):
        ab.attn_half_bwd(x, g, p, 1, "WithBias", stats, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("bwd_mode", ["save", "remat"])
def test_launches_per_step_at_full_width(bwd_mode):
    """One backward of the full-width RestormerRefFusion (52 blocks) in
    bf16 launches each backward wrapper 52 times, and the forward 52 times
    ('save') or 104 ('remat': the backward recomputes x1 and the
    statistics)."""
    _cuda()
    torch.manual_seed(0)
    model = RestormerRefFusion(dtype=torch.bfloat16,
                               bwd_mode=bwd_mode).cuda().train()
    gen = torch.Generator().manual_seed(3)
    lq, ref, gt = (torch.rand(1, 128, 128, 3, generator=gen).cuda()
                   for _ in range(3))
    counts = (tb.tblock_fused.launches, gb.gdfn_half_bwd.launches,
              ab.attn_half_bwd.launches)
    l1_loss(model(lq, ref), gt).backward()
    assert (tb.tblock_fused.launches - counts[0],
            gb.gdfn_half_bwd.launches - counts[1],
            ab.attn_half_bwd.launches - counts[2]) == (
        104 if bwd_mode == "remat" else 52, 52, 52)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_parameter_gets_a_gradient_on_cuda(dtype):
    """Through the kernels' backward, every parameter of a RestormerRefFusion
    gets a finite gradient, those upstream of the first block included:
    none is lost, none comes from plain autograd."""
    _cuda()
    torch.manual_seed(0)
    model = RestormerRefFusion(**TINY_REF, dtype=dtype).cuda().train()
    with torch.no_grad():
        for n, q in model.named_parameters():
            if n.endswith("alpha"):
                q.fill_(0.5)
    gen = torch.Generator().manual_seed(1)
    lq, ref, gt = (torch.rand(2, 32, 32, 3, generator=gen).cuda()
                   for _ in range(3))
    counts = (tb.tblock_fused.launches, gb.gdfn_half_bwd.launches,
              ab.attn_half_bwd.launches)
    l1_loss(model(lq, ref), gt).backward()
    blocks = sum(isinstance(m, TransformerBlock) for m in model.modules())
    assert (tb.tblock_fused.launches - counts[0],
            gb.gdfn_half_bwd.launches - counts[1],
            ab.attn_half_bwd.launches - counts[2]) == (blocks,) * 3
    missing = [n for n, q in model.named_parameters()
               if q.grad is None or not torch.isfinite(q.grad).all()]
    assert not missing, missing
    assert {q.dtype for q in model.parameters()} == {torch.float32}
