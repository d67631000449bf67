"""Visualization helpers, host-side numpy (``src/utils.py:26-108``).

Counterpart of ``tpudepth/utils/viz.py``: ``colorize`` and ``colorize_cpu``
need matplotlib (and Pillow), ``hconcat_resize`` uses OpenCV when it is
installed, ``make_grid`` needs neither.
"""

from __future__ import annotations

import numpy as np


def colorize(value: np.ndarray, vmin: float = 10, vmax: float = 1000, cmap: str = "plasma"):
    """CHW uint8 colorized depth (``src/utils.py:69-96``); input is the first
    channel of a (C, H, W) or (H, W) array."""
    import matplotlib

    value = np.asarray(value)
    if value.ndim == 3:
        value = value[0]
    vmin = value.min() if vmin is None else vmin
    vmax = value.max() if vmax is None else vmax
    if vmin != vmax:
        value = (value - vmin) / (vmax - vmin)
    else:
        value = value * 0.0
    cmapper = matplotlib.colormaps.get_cmap(cmap)
    img = cmapper(value, bytes=True)[:, :, :3]
    return img.transpose((2, 0, 1))


def colorize_cpu(value: np.ndarray, cmap: str = "plasma"):
    """PIL image colorization (``src/utils.py:98-108``)."""
    import matplotlib
    from PIL import Image

    image = np.asarray(value, dtype=np.float32)
    image = image - image.min()
    image = image / max(image.max(), 1e-12)
    cm = matplotlib.colormaps.get_cmap(cmap)
    return Image.fromarray(np.uint8(cm(image) * 255))


def hconcat_resize(img_list, interpolation=None):
    """Height-matched horizontal concat (``src/utils.py:26-41``); cv2 optional."""
    try:
        import cv2

        interpolation = interpolation or cv2.INTER_CUBIC
        h_min = max(img.shape[0] for img in img_list)
        resized = [
            cv2.resize(
                img, (int(img.shape[1] * h_min / img.shape[0]), h_min),
                interpolation=interpolation,
            )
            for img in img_list
        ]
        return cv2.hconcat(resized)
    except ImportError:  # pragma: no cover
        h_min = max(img.shape[0] for img in img_list)
        return np.concatenate(
            [np.asarray(img) for img in img_list if img.shape[0] == h_min], axis=1
        )


def make_grid(batch_nhwc: np.ndarray, nrow: int = 6, normalize: bool = False) -> np.ndarray:
    """CHW image grid from an NHWC batch (torchvision ``make_grid`` analogue
    used by the root trainer's TensorBoard logging, ``src/train.py:170-183``)."""
    import math as _math

    x = np.asarray(batch_nhwc, dtype=np.float32)
    if normalize:
        lo, hi = x.min(), x.max()
        x = (x - lo) / max(hi - lo, 1e-12)
    b, h, w, c = x.shape
    ncol = min(nrow, b)
    nrows = _math.ceil(b / ncol)
    pad = 2
    grid = np.zeros((nrows * (h + pad) + pad, ncol * (w + pad) + pad, c), np.float32)
    for i in range(b):
        r, col = divmod(i, ncol)
        y0 = r * (h + pad) + pad
        x0 = col * (w + pad) + pad
        grid[y0 : y0 + h, x0 : x0 + w] = x[i]
    return grid.transpose(2, 0, 1)
