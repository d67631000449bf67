"""Depth losses on NCHW tensors in plain tensor code, float32.

Counterpart of the jnp path of ``tpudepth/losses/losses.py``. The alhashim
recipe: L1 (optionally masked), the 11x11-gaussian SSIM
(``src/GuideDepth/losses.py:41-79``), the forward-difference gradient loss
and their combination ``DepthLoss``; its fused CUDA counterpart is
``ops/kernels/fused_loss.py``. The root recipe: the per-batch min-max
normalization (``src/utils.py:7-8``), the 3x3 avg-pool SSIM loss with
ReflectionPad(1) (``src/loss.py:57-88``) and the SILog loss
(``src/loss.py:116-129``); the fused CUDA counterpart of ``1.0 * ssim + 0.1
* l1_loss`` is ``ops/kernels/fused_root_loss.py``.

Under a data axis (``core/mesh.py::data_axis``, the train step of a process
group) the batch is the global one, as under JAX's data-sharded ``jit``:
the pixel means are each rank's own (with equal shards their mean over the
ranks is the global mean, so the fused kernels run on each rank's shard
unchanged); the min-max target's min and max and the masked L1's and
SILog's sums are all-reduced. The mean over the ranks of what each rank
returns is the global batch's loss.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpudepth_torch.core.mesh import (
    all_reduce_max,
    all_reduce_min,
    all_reduce_sum,
    current_axis,
)
from tpudepth_torch.ops.image import image_gradients, reflection_pad2d


def widen(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the dtype every loss computes in: float32, as the JAX
    package casts each loss term (``tpudepth/losses/losses.py:40,54,131,
    146``). The losses and the train step call it through this module, so
    one definition sets the dtype of all of them."""
    return x.float()


def depth_norm_minmax(depth: torch.Tensor) -> torch.Tensor:
    """Per-batch min-max normalization: min and max are global over the
    whole batch tensor, so the target depends on the batch's composition;
    under a data axis (``core/mesh.py::data_axis``) over the global batch,
    by MIN and MAX all-reduces."""
    mesh = current_axis()
    dmin = all_reduce_min(depth.min(), mesh)
    dmax = all_reduce_max(depth.max(), mesh)
    return (depth - dmin) / (dmax - dmin)


def l1_loss(pred: torch.Tensor, target: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean absolute difference, or with ``mask`` the masked sum over the
    mask's count (at least 1). The masked ratio is not a mean of per-rank
    ratios: under a data axis both sums are the global batch's (a SUM
    all-reduce with autograd), so every rank returns the global loss, and
    the average of the ranks' gradients is its gradient (the all-reduce's
    backward sums the ranks' cotangents)."""
    diff = (widen(pred) - widen(target)).abs()
    if mask is None:
        return diff.mean()
    mask = mask.to(diff.dtype)
    sums = _global_sums((diff * mask).sum(), mask.sum())
    return sums[0] / sums[1].clamp(min=1.0)


def _global_sums(*sums: torch.Tensor) -> torch.Tensor:
    """The scalars ``sums`` stacked, summed over the ranks under a data
    axis (with autograd)."""
    return all_reduce_sum(torch.stack(sums), current_axis())


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """monodepth2 SSIM loss ``mean(clamp((1 - SSIM) / 2, 0, 1))`` from
    ReflectionPad(1) and 3x3 average-pool statistics, C1 = 0.01^2,
    C2 = 0.03^2, in float32."""
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    x = reflection_pad2d(widen(x), 1)
    y = reflection_pad2d(widen(y), 1)

    def pool(t):
        return F.avg_pool2d(t, 3, 1)

    mu_x, mu_y = pool(x), pool(y)
    sigma_x = pool(x * x) - mu_x ** 2
    sigma_y = pool(y * y) - mu_y ** 2
    sigma_xy = pool(x * y) - mu_x * mu_y
    ssim_n = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    ssim_d = (mu_x ** 2 + mu_y ** 2 + c1) * (sigma_x + sigma_y + c2)
    return torch.clamp((1 - ssim_n / ssim_d) / 2, 0, 1).mean()


def silog_loss_variance(prediction: torch.Tensor, gt: torch.Tensor,
                        variance_focus: float = 0.85) -> torch.Tensor:
    """Scale-invariant log loss: mask ``gt > 1e-3``, clamp the prediction at
    1e-6, ``d = log(pred) - log(gt)``, ``sqrt(mean(d^2) - 0.85 mean(d)^2) *
    10`` over the masked pixels, in float32 (logs only where valid, so the
    masked pixels get no NaN gradient); under a data axis over the global
    batch's masked pixels, as :func:`l1_loss` with a mask."""
    pred = widen(prediction).clamp(min=1e-6)
    mask = (gt > 1e-3).to(pred.dtype)
    valid = mask > 0
    safe_gt = torch.where(valid, widen(gt), torch.ones_like(pred))
    safe_pred = torch.where(valid, pred, torch.ones_like(pred))
    d = torch.log(safe_pred) - torch.log(safe_gt)
    sums = _global_sums(mask.sum(), (d * mask).sum(), (d * d * mask).sum())
    n = sums[0].clamp(min=1.0)
    mean_d = sums[1] / n
    mean_d2 = sums[2] / n
    return torch.sqrt(mean_d2 - variance_focus * mean_d ** 2) * 10.0


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
    dt = torch.promote_types(widen(img1).dtype, widen(img2).dtype)
    img1, img2 = img1.to(dt), img2.to(dt)
    g1d = torch.from_numpy(_gaussian_1d(real_size)).to(img1.device, dt)
    padd = window_size // 2
    kh = g1d.view(1, 1, -1, 1).expand(c, 1, -1, 1)
    kw = g1d.view(1, 1, 1, -1).expand(c, 1, 1, -1)

    def gconv(x):
        x = F.conv2d(x, kh, padding=(padd, 0), groups=c)
        return F.conv2d(x, kw, padding=(0, padd), groups=c)

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
    pred_dx, pred_dy = image_gradients(widen(pred))
    gt_dx, gt_dy = image_gradients(widen(gt))
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
        # Under a data axis each rank clamps the SSIM term of its shard
        # where JAX clamps the global batch's. They cannot differ while the
        # SSIM index lies in [-1, 1] (it is at most 1 by construction):
        # (1 - SSIM) * 0.5 is then in [0, 1], the clamp is the identity on
        # every rank, and the mean of the ranks' terms is the global term.
        l_ssim = torch.clamp(
            (1 - ssim_gaussian(output, depth, self.max_depth)) * 0.5, 0, 1)
        l_grad = gradient_loss(output, depth)
        return self.alpha * l_depth + self.beta * l_ssim + self.gamma * l_grad
