"""Image primitives on NCHW tensors with PyTorch interpolation semantics.

Counterpart of ``tpudepth/ops/image.py``. The JAX
package wrote these as XLA ops outside Pallas (dense interpolation
contractions, strided slices, ``reduce_window``); here they are the matching
``torch.nn.functional`` calls.

The resizes and :func:`global_avg_pool` also run on rows under a model axis
(``rows=mesh``, ``core/mesh.py``): ``x`` is this rank's rows of a map, the
size is the whole output's, and the result is this rank's rows of it
(``core/mesh.py::row_bounds``; the input's global height from the row
plan, ``global_rows``, the output's recorded in it). A resize reads the
source rows its output rows interpolate from, its neighbours' too, and
clamps at the image's edges alone (:func:`resize_plan`,
:func:`resize_strip`); a mean adds the rows' sums and counts over the model
ranks.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpudepth_torch.core.mesh import (
    Mesh,
    fetch_rows,
    global_rows,
    record_rows,
    row_bounds,
    sum_with_count,
)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """Contiguous NHWC view of an NCHW tensor (free when channels_last)."""
    return x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


def source_rows(h_in: int, h_out: int, rows: np.ndarray, mode: str,
                align_corners: bool = False, dtype=np.float64):
    """The source rows of output rows ``rows`` of a resize from ``h_in`` to
    ``h_out`` rows, as torch computes them (in ``dtype``, float32 for every
    dtype but float64): ``(lo, hi, frac)``, the output row being ``(1 -
    frac) row lo + frac row hi``; nearest gives ``hi == lo`` and ``frac``
    0."""
    i = rows.astype(dtype)
    if mode == "nearest":
        if h_out == h_in:
            lo = rows.copy()
        elif h_out == 2 * h_in:
            lo = rows >> 1
        else:
            scale = dtype(h_in) / dtype(h_out)
            lo = np.minimum(np.floor(i * scale).astype(np.int64), h_in - 1)
        return lo, lo, np.zeros(len(rows), dtype)
    if align_corners:
        scale = (dtype(h_in - 1) / dtype(h_out - 1) if h_out > 1
                 else dtype(0))
        src = scale * i
    else:
        scale = dtype(h_in) / dtype(h_out)
        src = np.maximum(scale * (i + dtype(0.5)) - dtype(0.5), dtype(0))
    lo = np.minimum(src.astype(np.int64), h_in - 1)
    hi = np.minimum(lo + 1, h_in - 1)
    return lo, hi, (src - lo.astype(dtype)).astype(dtype)


def resize_plan(h_in: int, h_out: int, num_model: int, mode: str,
                align_corners: bool = False) -> List[Tuple[int, int, int, int]]:
    """How a resize from ``h_in`` to ``h_out`` rows splits over
    ``num_model`` row shards: per rank ``(o0, o1, lo, hi)``, its output
    rows ``[o0, o1)`` (``core/mesh.py::row_bounds``) and the source rows
    ``[lo, hi)`` they interpolate from (none for no output rows)."""
    bounds = row_bounds(h_out, num_model)
    plan = []
    for o0, o1 in zip(bounds, bounds[1:]):
        if o1 == o0:
            plan.append((o0, o1, 0, 0))
            continue
        lo, hi, _ = source_rows(h_in, h_out, np.arange(o0, o1), mode,
                                align_corners)
        plan.append((o0, o1, int(lo.min()), int(hi.max()) + 1))
    return plan


def resize_strip(strip: torch.Tensor, h_in: int, size: Tuple[int, int],
                 rows: Tuple[int, int, int, int], mode: str,
                 align_corners: bool = False) -> torch.Tensor:
    """Output rows ``rows[0]:rows[1]`` of the resize of an ``h_in``-row map
    to ``size`` from its source rows ``[rows[2], rows[3])`` (``strip``):
    the columns resized by ``F.interpolate`` (whose rows then stay as they
    are), then each row interpolated from its two source rows in torch's
    order, ``(1 - frac) a + frac b``, in float32 (float64 for float64)."""
    o0, o1, lo0, _ = rows
    size = (int(size[0]), int(size[1]))
    if o1 == o0:
        return strip.new_zeros((strip.shape[0], strip.shape[1], 0, size[1]))
    if strip.shape[3] != size[1]:
        kw = {} if mode == "nearest" else {"align_corners": align_corners}
        strip = F.interpolate(strip, size=(strip.shape[2], size[1]),
                              mode=mode, **kw)
    wide = strip.dtype == torch.float64
    lo, hi, frac = source_rows(h_in, size[0], np.arange(o0, o1), mode,
                               align_corners,
                               np.float64 if wide else np.float32)
    dev = strip.device
    a = strip.index_select(2, torch.from_numpy(lo - lo0).to(dev))
    if mode == "nearest":
        return a
    ct = torch.float64 if wide else torch.float32
    b = strip.index_select(2, torch.from_numpy(hi - lo0).to(dev)).to(ct)
    f = torch.from_numpy(frac).to(dev, ct).view(1, 1, -1, 1)
    return (a.to(ct) * (1 - f) + b * f).to(strip.dtype)


def resize_rows(x: torch.Tensor, size: Tuple[int, int], mode: str,
                align_corners: bool, mesh: Mesh) -> torch.Tensor:
    """The resize to ``size`` (the whole output's) of a map of which this
    rank holds the rows ``x``: this rank's rows of the output."""
    h_in = global_rows(x, mesh)
    plan = resize_plan(h_in, int(size[0]), mesh.num_model, mode,
                       align_corners)
    strip = fetch_rows(x, [(lo, hi) for _, _, lo, hi in plan], mesh, h_in)
    record_rows(mesh, size[0], size[1])
    return resize_strip(strip, h_in, size, plan[mesh.model_rank], mode,
                        align_corners)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int],
                    align_corners: bool = False,
                    rows: Optional[Mesh] = None) -> torch.Tensor:
    """Bilinear resize of ``x`` [B,C,H,W] to (H, W) = ``size``; on rows
    with ``rows`` (module docstring)."""
    size = (int(size[0]), int(size[1]))
    if rows is not None:
        if (global_rows(x, rows), x.shape[3]) == size:
            return x
        return resize_rows(x, size, "bilinear", align_corners, rows)
    if tuple(x.shape[2:]) == size:
        return x
    return F.interpolate(x, size=size, mode="bilinear",
                         align_corners=align_corners)


def resize_nearest(x: torch.Tensor, size: Tuple[int, int],
                   rows: Optional[Mesh] = None) -> torch.Tensor:
    """torch ``mode='nearest'`` resize: source index floor(i * in / out);
    on rows with ``rows``."""
    size = (int(size[0]), int(size[1]))
    if rows is not None:
        if (global_rows(x, rows), x.shape[3]) == size:
            return x
        return resize_rows(x, size, "nearest", False, rows)
    if tuple(x.shape[2:]) == size:
        return x
    return F.interpolate(x, size=size, mode="nearest")


def upsample(x: torch.Tensor, scale_factor: int = 2,
             align_corners: bool = False,
             rows: Optional[Mesh] = None) -> torch.Tensor:
    """Scale-factor bilinear upsample; on rows with ``rows``."""
    h = x.shape[2] if rows is None else global_rows(x, rows)
    return resize_bilinear(x, (h * scale_factor, x.shape[3] * scale_factor),
                           align_corners, rows)


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


def global_avg_pool(x: torch.Tensor, keepdims: bool = False,
                    rows: Optional[Mesh] = None) -> torch.Tensor:
    """Mean over H and W; with ``rows``, over the whole image of which this
    rank holds the rows ``x`` (the rows' sums and counts added over the
    model ranks, with autograd: shards need not be equal)."""
    if rows is None:
        return x.mean(dim=(2, 3), keepdim=keepdims)
    s, n = sum_with_count(x.sum(dim=(2, 3), keepdim=keepdims),
                          x.shape[2] * x.shape[3], rows, "model")
    return s / n
