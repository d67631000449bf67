"""Depth losses on NCHW tensors in plain tensor code, float32.

Counterpart of the jnp path of ``tpudepth/losses/losses.py`` for the
alhashim recipe: L1 (optionally masked), the 11x11-gaussian SSIM
(``src/GuideDepth/losses.py:41-79``), the forward-difference gradient loss
and their combination ``DepthLoss``. The root recipe's losses (3x3 box SSIM,
min-max normalization, SILog) are still to port. The fused CUDA counterpart
is ``ops/kernels/fused_loss.py``.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpudepth_torch.ops.image import image_gradients


def l1_loss(pred: torch.Tensor, target: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    diff = (pred.float() - target.float()).abs()
    if mask is None:
        return diff.mean()
    mask = mask.float()
    return (diff * mask).sum() / mask.sum().clamp(min=1.0)


@functools.lru_cache(maxsize=None)
def _gaussian_1d(window_size: int, sigma: float = 1.5) -> np.ndarray:
    g = np.array([math.exp(-((i - window_size // 2) ** 2) / (2.0 * sigma ** 2))
                  for i in range(window_size)], dtype=np.float32)
    return (g / g.sum()).astype(np.float32)


def ssim_gaussian(img1: torch.Tensor, img2: torch.Tensor, val_range: float,
                  window_size: int = 11) -> torch.Tensor:
    """Gaussian-window SSIM similarity (not loss): the mean of the SSIM map
    from depthwise gaussian statistics with zero padding ``window_size//2``.
    The 2-D gaussian is an outer product, so it runs as two 1-D convs."""
    _, c, h, w = img1.shape
    real_size = min(window_size, h, w)
    g1d = torch.from_numpy(_gaussian_1d(real_size)).to(img1.device)
    padd = window_size // 2
    kh = g1d.view(1, 1, -1, 1).expand(c, 1, -1, 1)
    kw = g1d.view(1, 1, 1, -1).expand(c, 1, 1, -1)

    def gconv(x):
        x = F.conv2d(x.float(), kh, padding=(padd, 0), groups=c)
        return F.conv2d(x, kw, padding=(0, padd), groups=c)

    img1, img2 = img1.float(), img2.float()
    mu1 = gconv(img1)
    mu2 = gconv(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = gconv(img1 * img1) - mu1_sq
    sigma2_sq = gconv(img2 * img2) - mu2_sq
    sigma12 = gconv(img1 * img2) - mu1_mu2
    c1 = (0.01 * val_range) ** 2
    c2 = (0.03 * val_range) ** 2
    v1 = 2.0 * sigma12 + c2
    v2 = sigma1_sq + sigma2_sq + c2
    ssim_map = ((2 * mu1_mu2 + c1) * v1) / ((mu1_sq + mu2_sq + c1) * v2)
    return ssim_map.mean()


def gradient_loss(pred: torch.Tensor, gt: torch.Tensor,
                  alpha: float = 1.0) -> torch.Tensor:
    """Forward-difference edge loss (``src/GuideDepth/losses.py:82-92``)."""
    pred_dx, pred_dy = image_gradients(pred.float())
    gt_dx, gt_dy = image_gradients(gt.float())
    diff_x = (gt_dx - pred_dx).abs()
    diff_y = (gt_dy - pred_dy).abs()
    if alpha != 1.0:
        diff_x = diff_x ** alpha
        diff_y = diff_y ** alpha
    return (diff_x + diff_y).mean()


class DepthLoss:
    """Alhashim combined loss (``src/GuideDepth/losses.py:15-38``):
    ``alpha * L1 + beta * clamp((1 - SSIM_gauss) * 0.5, 0, 1) + gamma *
    gradient_loss``. With ``beta == gamma == 0`` it is the validity-masked
    L1 (``depth > 0``)."""

    def __init__(self, alpha: float, beta: float, gamma: float,
                 max_depth: float = 10.0):
        self.alpha = alpha
        self.beta = beta
        self.gamma = gamma
        self.max_depth = max_depth

    def __call__(self, output: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        if self.beta == 0 and self.gamma == 0:
            return l1_loss(output, depth, mask=depth > 0.0)
        l_depth = l1_loss(output, depth)
        l_ssim = torch.clamp(
            (1 - ssim_gaussian(output, depth, self.max_depth)) * 0.5, 0, 1)
        l_grad = gradient_loss(output, depth)
        return self.alpha * l_depth + self.beta * l_ssim + self.gamma * l_grad
