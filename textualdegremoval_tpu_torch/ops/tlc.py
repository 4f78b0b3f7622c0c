"""TLC (test-time local converter) pooling on NHWC tensors.

Counterpart of textualdegremoval_tpu/ops/tlc.py: global average pooling
replaced by a sliding box average whose kernel is scaled by the test/train
size ratio, in the exact integral-image form with replicate `auto_pad`.
"""

import torch
import torch.nn.functional as F


def local_avg_pool(x: torch.Tensor, kernel_size) -> torch.Tensor:
    """Sliding-window box average over (N, H, W, C), replicate-padded back
    to the input's size.  The global mean when the kernel covers the image
    (the reference's adaptive_avg_pool2d(1) shortcut)."""
    _, h, w, _ = x.shape
    k1 = min(h, int(kernel_size[0]))
    k2 = min(w, int(kernel_size[1]))
    if k1 >= h and k2 >= w:
        return x.mean(dim=(1, 2), keepdim=True)

    s = x.float().cumsum(2).cumsum(1)
    s = F.pad(s, (0, 0, 1, 0, 1, 0))
    out = (s[:, k1:, k2:] + s[:, :-k1, :-k2] - s[:, :-k1, k2:]
           - s[:, k1:, :-k2]) / float(k1 * k2)

    # auto_pad: replicate-pad back to the input's size, centred
    oh, ow = out.shape[1], out.shape[2]
    pt, pb = (h - oh) // 2, (h - oh + 1) // 2
    pl, pr = (w - ow) // 2, (w - ow + 1) // 2
    out = F.pad(out.permute(0, 3, 1, 2), (pl, pr, pt, pb), mode="replicate")
    return out.permute(0, 2, 3, 1).to(x.dtype)


def tlc_kernel_size(base_size, train_size, test_size) -> tuple[int, int]:
    """The test-time kernel: base * test / train, per axis."""
    return (test_size[0] * base_size[0] // train_size[0],
            test_size[1] * base_size[1] // train_size[1])
