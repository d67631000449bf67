"""Image primitives on NCHW tensors with PyTorch interpolation semantics.

Counterpart of ``tpudepth/ops/image.py``. The JAX
package wrote these as XLA ops outside Pallas (dense interpolation
contractions, strided slices, ``reduce_window``); here they are the matching
``torch.nn.functional`` calls.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """Contiguous NHWC view of an NCHW tensor (free when channels_last)."""
    return x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of ``x`` [B,C,H,W] to (H, W) = ``size``."""
    size = (int(size[0]), int(size[1]))
    if tuple(x.shape[2:]) == size:
        return x
    return F.interpolate(x, size=size, mode="bilinear",
                         align_corners=align_corners)


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """torch ``mode='nearest'`` resize: source index floor(i * in / out)."""
    size = (int(size[0]), int(size[1]))
    if tuple(x.shape[2:]) == size:
        return x
    return F.interpolate(x, size=size, mode="nearest")


def upsample(x: torch.Tensor, scale_factor: int = 2,
             align_corners: bool = False) -> torch.Tensor:
    """Scale-factor bilinear upsample."""
    h, w = x.shape[2:]
    return resize_bilinear(x, (h * scale_factor, w * scale_factor),
                           align_corners)


def pixel_shuffle(x: torch.Tensor, upscale_factor: int) -> torch.Tensor:
    """``nn.PixelShuffle``: out[b, c, h*r+i, w*r+j] = in[b, c*r*r + i*r + j, h, w]."""
    return F.pixel_shuffle(x, upscale_factor)


def reflection_pad2d(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``nn.ReflectionPad2d`` on H and W."""
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


def max_pool(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """``nn.MaxPool2d(window, stride)`` without padding."""
    return F.max_pool2d(x, window, stride)


def image_gradients(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``tf.image.image_gradients``-style forward differences ``(dx, dy)``:
    ``dx`` has zeros in its last column, ``dy`` in its last row."""
    dx = F.pad(x[:, :, :, 1:] - x[:, :, :, :-1], (0, 1))
    dy = F.pad(x[:, :, 1:, :] - x[:, :, :-1, :], (0, 0, 0, 1))
    return dx, dy


def avg_pool(x: torch.Tensor, window: int, stride: int = 1,
             padding: int = 0) -> torch.Tensor:
    """``nn.AvgPool2d`` with ``count_include_pad=True`` (DAPPM), summed in
    float32 and cast back to the input dtype."""
    out = F.avg_pool2d(x.float(), window, stride, padding,
                       count_include_pad=True)
    return out.to(x.dtype)


def global_avg_pool(x: torch.Tensor, keepdims: bool = False) -> torch.Tensor:
    """Mean over H and W."""
    return x.mean(dim=(2, 3), keepdim=keepdims)
