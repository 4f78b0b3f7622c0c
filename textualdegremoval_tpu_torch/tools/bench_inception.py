"""FID's InceptionV3 feature extraction on the card, in both layouts.

`metrics/inception.py` runs its trunk NCHW-contiguous; this tool gives
the readings behind that pick: `extract_features` of N seeded 512 px
images at batch 32 (the antialiased resize to 299 included), with the
trunk on the NCHW-contiguous copy and on the channels_last view (the
NHWC input permuted, the weights in channels_last), in turns (nchw, cl,
cl, nchw); then the trunk alone on a batch of 32 at 299 in both layouts
and the resize of a batch, CUDA-event medians (`_card.median_ms`).
Float32 with TF32 off, as FID runs; seeded weights (`seeded_init`).  The
card's name and power limit come first.

    python -m textualdegremoval_tpu_torch.tools.bench_inception [--n 256]
"""

from __future__ import annotations

import argparse
import copy
import time

import torch

from textualdegremoval_tpu_torch.metrics.inception import (
    InceptionV3, extract_features, seeded_init)
from textualdegremoval_tpu_torch.ops.resize import image_resize
from textualdegremoval_tpu_torch.tools._card import device_line, median_ms


class _ChannelsLast(InceptionV3):
    """The trunk on the NHWC input's channels_last view, no copy."""

    def forward(self, x):
        return self.trunk(x.permute(0, 3, 1, 2))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=256)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_inception: no CUDA device")
    dev = torch.device("cuda")
    print(device_line(dev), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nchw = seeded_init(InceptionV3(), 0).to(dev)
    cl = copy.deepcopy(nchw).to(memory_format=torch.channels_last)
    cl.__class__ = _ChannelsLast
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand(args.n, 512, 512, 3, generator=gen, device=dev)
    a = extract_features(nchw, x[:64])
    b = extract_features(cl, x[:64])
    print(f"channels_last vs NCHW features: "
          f"{((a - b).abs().max() / a.abs().max()).item():.3e} of max|NCHW|",
          flush=True)
    for name, model in (("nchw", nchw), ("channels_last", cl),
                        ("channels_last", cl), ("nchw", nchw)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        extract_features(model, x, 32)
        torch.cuda.synchronize()
        print(f"extract_features {name}: "
              f"{args.n / (time.perf_counter() - t0):.1f} images/s "
              f"({args.n} of 512 px, batch 32)", flush=True)
    x299 = torch.rand(32, 299, 299, 3, generator=gen, device=dev)
    with torch.inference_mode():
        for name, model in (("nchw", nchw), ("channels_last", cl),
                            ("channels_last", cl), ("nchw", nchw)):
            print(f"trunk alone {name}, batch 32 at 299: "
                  f"{median_ms(lambda: model(x299), reps=5):.2f} ms",
                  flush=True)
        ms = median_ms(lambda: image_resize(x[:32], (32, 299, 299, 3),
                                            "bilinear"), reps=5)
        print(f"image_resize of 32 images 512 -> 299: {ms:.2f} ms",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
