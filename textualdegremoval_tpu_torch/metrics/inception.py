"""InceptionV3 pool3 feature extractor for FID (counterpart of
textualdegremoval_tpu/metrics/inception.py).

The standard InceptionV3 trunk up to pool3 (2048-d) with torchvision's
layer names (`Conv2d_1a_3x3` ... `Mixed_7c`, children `conv` / `bn`), so
a torchvision or pytorch-fid state dict loads with `strict=True`.  As in
JAX, every branch pool of the A, C and E blocks (both E blocks) is the
3x3 stride-1 average with padding left out of the divisor
(count_include_pad=False), the stride-2 pools are 3x3 VALID max pools,
and BatchNorm (eps 1e-3) always uses its running statistics.  pytorch-fid
differs twice: its Mixed_7c pools with a max, and it resizes without
antialiasing; so neither package reproduces pytorch-fid's features from
its checkpoint.

Inputs are NHWC RGB in [0, 1]; `extract_features` resizes to 299 with
jax.image.resize's antialiased bilinear (`ops/resize.py` `image_resize`)
and maps to [-1, 1] (the TF Inception convention).  Inside, the network
runs NCHW-contiguous, the faster layout on the card in float32.  Without
weights, `seeded_init` gives seeded weights with O(1) activations
through depth: the FID pipeline runs everywhere, but scores compare only
across runs that share the weights.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from textualdegremoval_tpu_torch.ops.resize import image_resize


class BasicConv2d(nn.Module):
    """conv (no bias) + BatchNorm (eps 1e-3, running statistics) + relu."""

    def __init__(self, cin: int, cout: int, kernel=(3, 3), stride=1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        bn = self.bn
        x = F.batch_norm(self.conv(x), bn.running_mean, bn.running_var,
                         bn.weight, bn.bias, False, 0.0, bn.eps)
        return F.relu(x)


def _avg_pool_3x3_same(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _max_pool_3x3_s2(x):
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_3x3_same(x))
        return torch.cat([self.branch1x1(x), b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool_3x3_s2(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3,
                     self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = conv(bd)
        bp = self.branch_pool(_avg_pool_3x3_same(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for conv in (self.branch7x7x3_2, self.branch7x7x3_3,
                     self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([b3, b7, _max_pool_3x3_s2(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        bp = self.branch_pool(_avg_pool_3x3_same(x))
        return torch.cat([self.branch1x1(x), b3, bd, bp], 1)


class InceptionV3(nn.Module):
    """The trunk up to pool3: (N, H, W, 3) -> (N, 2048).  299 x 299 is
    the FID protocol's size; any size of at least 75 runs."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)

    def forward(self, x):
        return self.trunk(x.permute(0, 3, 1, 2).contiguous())

    def trunk(self, x):
        """(N, 3, H, W) -> (N, 2048), in x's memory format (the forward
        passes NCHW-contiguous: on an H100 in float32 it ran 1.19x
        channels_last's rate, `tools/bench_inception.py`)."""
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool_3x3_s2(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = _max_pool_3x3_s2(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


def seeded_init(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded weights with O(1) activations through depth: He-normal
    convs, BatchNorm scales near 1 and random running statistics (as
    tests/test_fid_inception.py randomises its oracle).  In place;
    returns the model."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                               * (2.0 / fan_in) ** 0.5)
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.copy_(1 + 0.1 * torch.randn(m.weight.shape,
                                                     generator=g))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
                m.running_mean.copy_(0.05 * torch.randn(
                    m.running_mean.shape, generator=g))
                m.running_var.copy_(1 + 0.1 * torch.rand(
                    m.running_var.shape, generator=g))
    return model


def load_torch_inception(path: str) -> InceptionV3:
    """An `InceptionV3` with a torch InceptionV3 state dict (torchvision or
    pytorch-fid naming; `AuxLogits.*` and `fc.*` dropped) loaded
    strictly."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {k: v for k, v in sd.items()
          if not k.startswith(("AuxLogits", "fc"))}
    with torch.device("meta"):  # no random init of what the file replaces
        model = InceptionV3()
    model.load_state_dict(sd, strict=True, assign=True)
    return model


def extract_features(model: InceptionV3, images,
                     batch_size: int = 32) -> torch.Tensor:
    """NHWC RGB images in [0, 1] -> (N, 2048) pool3 features, in batches
    on the images' device (where `model` must be): each batch resized to
    299 with `image_resize` (jax.image.resize's antialiased bilinear) and
    mapped to [-1, 1]."""
    images = torch.as_tensor(images)
    n, h, w, c = images.shape
    outs = []
    with torch.inference_mode():
        for i in range(0, n, batch_size):
            x = images[i:i + batch_size].float()
            if (h, w) != (299, 299):
                x = image_resize(x, (x.shape[0], 299, 299, c), "bilinear")
            outs.append(model(x * 2.0 - 1.0))
    return torch.cat(outs)
