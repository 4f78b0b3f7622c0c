"""The DRSformer and NAFNetDynamicFusion ops whose form the port picks,
timed and checked on the card.

No kernel of the port serves DRSformer or NAFNetDynamicFusion: their
convolutions run through PyTorch.  `models/layers.py` `conv_form` picks
each conv's form, and this tool gives the readings behind the picks, at
the widths of a 512 px `drsformer_derain` forward and a 384 px training
step, and of NAFNetDynamicFusion's 256 px training step:

  grouped   MSFN's second-stage convs (two input channels a group, k 3
            and 5) as cuDNN's grouped conv against `_pair_grouped_conv`
            (one depthwise conv over the input's channels, then the sum
            of each pair), forward ms and the pair form's largest error
            against the grouped conv in float32;
  dw        depthwise convs (k 3, 5, 7; the dilated k 3, 5, 7 of MEFC)
            forward + backward ms on the channels_last view against the
            NCHW-contiguous copy, and the layout `layers.nchw_first` picks;
  dyndw     NAFNetDynamicFusion's depthwise 3x3 in float32 (its training
            dtype) at every level of a 256 px batch-8 step and of a
            512 px batch-1 pass (C = 2 x width x 2^level, 128 to 2048),
            forward + backward as `dw`;
  pw        1x1 convs at 512 px as cuDNN's conv against `conv_form`'s
            F.linear, bf16 and float32, forward and backward ms and the
            largest error of each gradient against float64 (over the
            gradient's largest element);
  masa      the MASA encoder's level-3 conv of a 512 px forward ((2, 192,
            128, 128) x (192, 192, 3, 3), lq and ref together), bf16 and
            float32, on the channels_last view (the port's layout) and on
            the NCHW copy: ms, and the kernel launches of one call with
            `fft` in their name (cuDNN's FFT algorithms);
  pool      the gradient of avg_pool2d(3, 1, 1, count_include_pad=False)
            on the card, channels_last and NCHW, and of `_AvgPool3x3`,
            against the CPU in float64 (largest abs difference).

Times are CUDA-event medians of single calls (`_card.median_ms`), TF32
off.  Each line names its part; the card's name and power limit come
first.

    python -m textualdegremoval_tpu_torch.tools.bench_family_ops [--parts grouped,dw,dyndw,pw,masa,pool]
"""

from __future__ import annotations

import argparse

import torch
import torch.nn as nn
import torch.nn.functional as F

from textualdegremoval_tpu_torch.models import drsformer as dm
from textualdegremoval_tpu_torch.models.layers import (
    conv_form, conv_nhwc, nchw_first,
)
from textualdegremoval_tpu_torch.tools._card import device_line, median_ms

# (H = W, hidden) of MSFN's second stage in a 512 px forward: the trunk's
# levels 1-4 and the fusion blocks at twice the width
GROUPED = [(512, 127), (512, 255), (256, 255), (256, 510), (128, 510),
           (128, 1021), (64, 1021), (64, 2042)]
# (H = W, C, k, dilation) of the depthwise convs of a 384 px training
# step at level 1: TKSA's qkv (3C), MSFN's first stage (2 hidden), MEFC's
# sep 5x5 / 7x7 and dilated 3 / 5 / 7
DEPTHWISE = [(384, 144, 3, 1), (384, 254, 3, 1), (384, 254, 5, 1),
             (384, 48, 5, 1), (384, 48, 7, 1), (384, 48, 3, 2),
             (384, 48, 5, 2), (384, 48, 7, 2)]
# (H = W, 2C, 3, 1) of NAFNetDynamicFusion's depthwise convs (width 64)
# in a 256 px training step: levels 0-3 and the middle block
DYNAMIC_DEPTHWISE = [(256, 128, 3, 1), (128, 256, 3, 1), (64, 512, 3, 1),
                     (32, 1024, 3, 1), (16, 2048, 3, 1)]
# (C_in, C_out) of 1x1 convs at 512 px: MSFN's project_in and
# project_out, MEFC's out (8 ops' concatenation), SFNet's Convs
POINTWISE = [(48, 254), (254, 48), (384, 48), (64, 32)]
POOL_SHAPES = [(1, 7, 9, 5), (2, 128, 128, 96)]


def grouped(dev, gen):
    for dtype in (torch.bfloat16, torch.float32):
        for hw, hid in GROUPED:
            for k in (3, 5):
                conv = nn.Conv2d(2 * hid, hid, k, padding=k // 2,
                                 groups=hid, bias=False).to(dev)
                x = torch.randn(1, hw, hw, 2 * hid, generator=gen).to(
                    dev, dtype)
                with torch.no_grad():
                    g_ms = median_ms(lambda: conv_nhwc(conv, x))
                    p_ms = median_ms(lambda: dm._pair_grouped_conv(conv, x))
                    err = ""
                    if dtype == torch.float32:
                        d = (dm._pair_grouped_conv(conv, x)
                             - conv_nhwc(conv, x)).abs().max()
                        err = f", pair max abs diff {d.item():.2e}"
                print(f"grouped {str(dtype)[6:]} k{k} {hw}x{hw} hidden "
                      f"{hid}: cuDNN grouped {g_ms:.3f} ms, pair form "
                      f"{p_ms:.3f} ms{err}", flush=True)


def depthwise(dev, gen, shapes=DEPTHWISE,
              dtypes=(torch.bfloat16, torch.float32), batch=1):
    for dtype in dtypes:
        for hw, c, k, d in shapes:
            w = (0.1 * torch.randn(c, 1, k, k, generator=gen)).to(dev, dtype)
            x0 = torch.randn(batch, hw, hw, c, generator=gen).to(dev, dtype)
            gy = torch.randn(batch, c, hw, hw, generator=gen).to(dev, dtype)
            ms = {}
            for name in ("channels_last", "nchw"):
                x = x0.permute(0, 3, 1, 2)
                if name == "nchw":
                    x = x.contiguous()
                x = x.detach().requires_grad_()
                wr = w.detach().requires_grad_()

                def step():
                    y = F.conv2d(x, wr, padding=(k - 1) * d // 2,
                                 dilation=d, groups=c)
                    torch.autograd.grad(y, [x, wr], gy)
                ms[name] = median_ms(step)
            pick = "NCHW" if nchw_first(dtype, c, k, d) else \
                "channels_last"
            print(f"dw {str(dtype)[6:]} k{k} dilation {d} batch {batch} "
                  f"{hw}x{hw} C {c}: "
                  f"forward + backward channels_last "
                  f"{ms['channels_last']:.3f} ms, NCHW {ms['nchw']:.3f} ms; "
                  f"conv_form takes {pick}", flush=True)


def pointwise(dev, gen):
    for cin, cout in POINTWISE:
        conv = nn.Conv2d(cin, cout, 1, bias=False)
        with torch.no_grad():
            conv.weight.normal_(0, cin ** -0.5, generator=gen)
        x0 = torch.randn(1, 512, 512, cin, generator=gen)
        gy = torch.randn(1, 512, 512, cout, generator=gen)
        xd = x0.double().requires_grad_()
        wd = conv.weight.detach().double().requires_grad_()
        yd = F.conv2d(xd.permute(0, 3, 1, 2), wd).permute(0, 2, 3, 1)
        ref = torch.autograd.grad(yd, [xd, wd], gy.double())
        conv = conv.to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            for name, fn in (("cuDNN conv", conv_nhwc),
                             ("F.linear", conv_form)):
                x = x0.to(dev, dtype).requires_grad_()
                g = gy.to(dev, dtype)

                def step():
                    torch.autograd.grad(fn(conv, x), [x, conv.weight], g)
                got = torch.autograd.grad(fn(conv, x), [x, conv.weight], g)
                errs = [((a.double().cpu() - b).abs().max()
                         / b.abs().max()).item() for a, b in zip(got, ref)]
                print(f"pw {str(dtype)[6:]} {cin} -> {cout} at 512x512 "
                      f"{name}: forward + backward {median_ms(step):.3f} "
                      f"ms; dx, dW largest error / max {errs[0]:.2e}, "
                      f"{errs[1]:.2e}", flush=True)


def pool(dev, gen):
    for shape in POOL_SHAPES:
        x0 = torch.randn(*shape, generator=gen, dtype=torch.float64)
        gy = torch.randn(*shape, generator=gen, dtype=torch.float64)

        def grad(x, fn):
            x = x.detach().requires_grad_()
            return torch.autograd.grad(fn(x), x, gy.to(x.device))[0].cpu()

        def nhwc_pool(x):
            return F.avg_pool2d(x.permute(0, 3, 1, 2), 3, 1, 1,
                                count_include_pad=False).permute(0, 2, 3, 1)

        want = grad(x0.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1),
                    nhwc_pool)
        rows = {
            "card channels_last": grad(x0.to(dev), nhwc_pool),
            "card NCHW": grad(x0.to(dev).permute(0, 3, 1, 2).contiguous()
                              .permute(0, 2, 3, 1), nhwc_pool),
            "card _AvgPool3x3": grad(x0.to(dev), dm._AvgPool3x3()),
        }
        print(f"pool {shape} float64, gradient max abs difference from the "
              "CPU: " + ", ".join(f"{k} {(v - want).abs().max().item():.2e}"
                                  for k, v in rows.items()), flush=True)


def masa(dev, gen):
    from torch.profiler import ProfilerActivity, profile

    w0 = torch.randn(192, 192, 3, 3, generator=gen) * 192 ** -0.5
    x0 = torch.randn(2, 128, 128, 192, generator=gen)
    for dtype in (torch.bfloat16, torch.float32):
        w = w0.to(dev, dtype)
        for name in ("channels_last", "nchw"):
            x = x0.to(dev, dtype).permute(0, 3, 1, 2)
            if name == "nchw":
                x = x.contiguous()
            with torch.no_grad():
                ms = median_ms(lambda: F.conv2d(x, w, padding=1))
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    F.conv2d(x, w, padding=1)
                    torch.cuda.synchronize()
            fft = sum(e.count for e in prof.key_averages()
                      if "fft" in e.key.lower())
            print(f"masa {str(dtype)[6:]} (2, 192, 128, 128) x (192, 192, 3, "
                  f"3) {name}: {ms:.3f} ms, {fft} FFT kernel launches",
                  flush=True)


def dynamic_depthwise(dev, gen):
    depthwise(dev, gen, DYNAMIC_DEPTHWISE, (torch.float32,), batch=8)
    depthwise(dev, gen, [(2 * hw, c, k, d) for hw, c, k, d in
                         DYNAMIC_DEPTHWISE], (torch.float32,), batch=1)


PARTS = {"grouped": grouped, "dw": depthwise, "dyndw": dynamic_depthwise,
         "pw": pointwise, "masa": masa, "pool": pool}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parts", default=",".join(PARTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_family_ops: no CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(device_line(dev), flush=True)
    gen = torch.Generator().manual_seed(0)
    for part in args.parts.split(","):
        PARTS[part](dev, gen)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
