"""FID (Frechet Inception Distance): the statistics math and InceptionV3
pool3 features (counterpart of textualdegremoval_tpu/metrics/fid.py).

The Frechet distance is JAX's numpy and scipy, `sqrtm` on the host;
`calculate_fid_from_images` extracts the features with
`metrics/inception.py` on the images' device.  Another extractor can be
used by computing features directly and calling `calculate_fid`.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import linalg


def compute_statistics(features: np.ndarray):
    """(N, D) activations -> (mu, sigma)."""
    mu = np.mean(features, axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6) -> float:
    """||mu1-mu2||^2 + Tr(s1 + s2 - 2 sqrt(s1 s2)).  JAX's math; sqrtm
    without JAX's `disp=False`, which newer SciPy no longer takes (the
    same array either way)."""
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def calculate_fid(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    mu1, s1 = compute_statistics(feats_a)
    mu2, s2 = compute_statistics(feats_b)
    return frechet_distance(mu1, s1, mu2, s2)


def calculate_fid_from_images(images_a, images_b, model=None,
                              weights_path: str | None = None,
                              batch_size: int = 32) -> float:
    """FID between two image sets (NHWC RGB in [0, 1], tensors or numpy)
    from InceptionV3 pool3 features computed on images_a's device.

    `model` (an `InceptionV3`) or `weights_path` (a torch InceptionV3
    state dict, torchvision / pytorch-fid naming) select the weights;
    without either the net has `seeded_init`'s seed-0 weights: the
    pipeline runs everywhere, but scores compare only across runs that
    share the weights.
    """
    from textualdegremoval_tpu_torch.metrics.inception import (
        InceptionV3, extract_features, load_torch_inception, seeded_init)

    images_a = torch.as_tensor(images_a)
    images_b = torch.as_tensor(images_b).to(images_a.device)
    if model is None:
        model = (load_torch_inception(weights_path) if weights_path
                 is not None else seeded_init(InceptionV3(), 0))
    model = model.to(images_a.device)
    fa = extract_features(model, images_a, batch_size).cpu().numpy()
    fb = extract_features(model, images_b, batch_size).cpu().numpy()
    return calculate_fid(fa, fb)
