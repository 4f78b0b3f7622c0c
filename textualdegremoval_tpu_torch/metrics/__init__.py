from textualdegremoval_tpu_torch.metrics.psnr_ssim import (
    calculate_psnr,
    calculate_ssim,
)

__all__ = ["calculate_psnr", "calculate_ssim"]
