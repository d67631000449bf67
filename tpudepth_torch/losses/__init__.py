"""Depth losses of the port (``tpudepth/losses``)."""

from tpudepth_torch.losses.losses import (  # noqa: F401
    DepthLoss,
    gradient_loss,
    l1_loss,
    ssim_gaussian,
)
