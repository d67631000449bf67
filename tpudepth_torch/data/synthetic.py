"""Synthetic dataset zips in the reference layouts, made from a seed.

Counterpart of ``tpudepth/data/synthetic.py``, byte for byte the same
images: the Alhashim NYU-50K layout read by ``src/data.py:48-55``
(``data/nyu2_train.csv`` + ``data/nyu2_test.csv`` pair lists, JPEG RGB + PNG
depth) and the KITTI layout (``data/kitti_{train,test}.csv``, 16-bit depth
PNG in meters x 256). The tests, the ``synthetic[:HxW]`` data spec of the
command lines and ``chip_smoke.py`` use them; no NYU or KITTI file is
needed.
"""

from __future__ import annotations

import io
import os
import tempfile
import zipfile
from typing import Tuple

import numpy as np


def _jpeg(img: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img, "RGB").save(buf, "JPEG", quality=90)
    return buf.getvalue()


def _gradient_rgb(rng, h: int, w: int) -> bytes:
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx / w * 255), (yy / h * 255),
                    rng.uniform(0, 255, (h, w))], axis=-1).astype(np.uint8)
    return _jpeg(img)


def make_synthetic_zip(
    path: str,
    n_train: int = 16,
    n_test: int = 8,
    image_hw: Tuple[int, int] = (480, 640),
    depth_hw: Tuple[int, int] = None,
    depth_mode: str = "L",  # 'L' (8-bit /255) or 'I;16' (raw uint16)
    seed: int = 0,
) -> str:
    """Write a synthetic NYU-layout zip; returns ``path``.

    Depth maps are smooth gradients plus noise so losses and metrics are
    well-conditioned; 8-bit depth follows the reference's /255 convention
    (``src/data.py:132,153``)."""
    from PIL import Image

    depth_hw = depth_hw or image_hw
    rng = np.random.default_rng(seed)

    def encode_depth(h, w):
        yy, xx = np.mgrid[0:h, 0:w]
        d = 0.3 + 0.6 * (xx / w) * (yy / h) + rng.uniform(0, 0.05, (h, w))
        buf = io.BytesIO()
        if depth_mode == "L":
            Image.fromarray((d * 255).astype(np.uint8), "L").save(buf, "PNG")
        else:
            Image.fromarray((d * 1000).astype(np.uint16)).save(buf, "PNG")
        return buf.getvalue()

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    ih, iw = image_hw
    dh, dw = depth_hw
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        rows = {"train": [], "test": []}
        for split, n in (("train", n_train), ("test", n_test)):
            for i in range(n):
                rgb = f"data/nyu2_{split}/{i:05d}_rgb.jpg"
                dep = f"data/nyu2_{split}/{i:05d}_depth.png"
                zf.writestr(rgb, _gradient_rgb(rng, ih, iw))
                zf.writestr(dep, encode_depth(dh, dw))
                rows[split].append(f"{rgb},{dep}")
        for split, names in rows.items():
            zf.writestr(f"data/nyu2_{split}.csv", "\n".join(names) + "\n")
    return path


def make_synthetic_kitti_zip(
    path: str,
    n_train: int = 8,
    n_test: int = 4,
    image_hw: Tuple[int, int] = (384, 1280),
    max_depth: float = 80.0,
    seed: int = 0,
) -> str:
    """KITTI-layout zip: JPEG RGB + 16-bit PNG depth with meters = value /
    256, dense and >= 2 m so the logarithmic metrics stay finite."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = image_hw

    def encode_depth():
        yy, xx = np.mgrid[0:h, 0:w]
        meters = 2.0 + (max_depth * 0.9 - 2.0) * (xx / w) * (yy / h)
        meters = meters + rng.uniform(0, 0.5, (h, w))
        buf = io.BytesIO()
        Image.fromarray(np.round(meters * 256.0).astype(np.uint16)).save(
            buf, "PNG")
        return buf.getvalue()

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        for split, n in (("train", n_train), ("test", n_test)):
            rows = []
            for i in range(n):
                rgb = f"data/kitti_{split}/{i:05d}_rgb.jpg"
                dep = f"data/kitti_{split}/{i:05d}_depth.png"
                zf.writestr(rgb, _gradient_rgb(rng, h, w))
                zf.writestr(dep, encode_depth())
                rows.append(f"{rgb},{dep}")
            zf.writestr(f"data/kitti_{split}.csv", "\n".join(rows) + "\n")
    return path


def _ensure(make, path: str, **kw) -> str:
    """``path``, written by ``make`` first if it does not exist. The zip is
    written beside it and renamed, so a concurrent reader never opens half a
    file."""
    if not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}.tmp"
        make(tmp, **kw)
        os.replace(tmp, path)
    return path


def ensure_synthetic_zip(path: str = None, **kw) -> str:
    path = path or os.path.join(tempfile.gettempdir(),
                                "tpudepth_torch_synth.zip")
    return _ensure(make_synthetic_zip, path, **kw)


def ensure_synthetic_kitti_zip(path: str = None, **kw) -> str:
    path = path or os.path.join(tempfile.gettempdir(),
                                "tpudepth_torch_synth_kitti.zip")
    return _ensure(make_synthetic_kitti_zip, path, **kw)


def resolve_data(spec: str, n_train: int = 32, n_test: int = 8,
                 dataset: str = "nyu_reduced") -> str:
    """The command lines' data spec: ``'synthetic'`` or ``'synthetic:HxW'``
    becomes a seeded zip in the temporary directory (480x640 NYU, 384x1280
    KITTI by default); any other spec is a path and passes through (the JAX
    package's ``_resolve_data``, ``guidedepth_main.py:18-43``)."""
    spec = str(spec)
    if not spec.startswith("synthetic"):
        return spec
    kitti = dataset == "kitti"
    hw = (384, 1280) if kitti else (480, 640)
    if ":" in spec:
        h, w = spec.split(":", 1)[1].split("x")
        hw = (int(h), int(w))
    name = f"tpudepth_torch_synth{'_kitti' if kitti else ''}_{hw[0]}x{hw[1]}.zip"
    ensure = ensure_synthetic_kitti_zip if kitti else ensure_synthetic_zip
    return ensure(os.path.join(tempfile.gettempdir(), name),
                  n_train=n_train, n_test=n_test, image_hw=hw)
