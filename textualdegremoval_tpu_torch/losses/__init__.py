"""Restoration losses of the port (counterpart of
textualdegremoval_tpu/losses)."""

from textualdegremoval_tpu_torch.losses.losses import (  # noqa: F401
    build_loss, charbonnier_loss, l1_loss, mse_loss, psnr_loss,
)
