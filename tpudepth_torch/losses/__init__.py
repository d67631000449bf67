"""Depth losses of the port (``tpudepth/losses``)."""

from tpudepth_torch.losses.losses import (  # noqa: F401
    DepthLoss,
    depth_norm_minmax,
    gradient_loss,
    l1_loss,
    silog_loss_variance,
    ssim,
    ssim_gaussian,
)
