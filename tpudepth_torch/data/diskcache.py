"""Memory-mapped raw-pixel cache shared across runs and across packages.

Counterpart of ``tpudepth/data/diskcache.py`` with the same key and the same
files, so a cache filled by either package reads back in the other. The
decode-once RAM cache (``nyu.py``) pays a full decode epoch per process;
backing it with ``np.memmap`` files keyed by the dataset's identity makes
that a one-time cost per machine: later runs open the memmaps and stream
batches at page-cache speed.

Layout under ``<dir>/<key>/``: ``images.npy`` ([N, H, W, C] uint8),
``depths.npy`` ([N, h, w, c] uint8|uint16), ``filled.npy`` ([N] uint8
bitmap marking decoded rows), ``meta.json``. The bitmap makes the fill
incremental and crash-safe (a partially-filled cache keeps its progress).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np


def dataset_cache_key(zip_path: str, pairs: Sequence[Sequence[str]]) -> str:
    """Stable identity for (zip file, pair list slice): file size+mtime and
    a digest of the pair names."""
    h = hashlib.sha256()
    try:
        st = os.stat(zip_path)
        h.update(f"{zip_path}:{st.st_size}:{int(st.st_mtime)}".encode())
    except OSError:
        h.update(zip_path.encode())
    for p in pairs:
        h.update(",".join(p).encode())
        h.update(b";")
    return h.hexdigest()[:24]


class RawDiskCache:
    """Incremental memmap store for raw decoded (rgb, depth) samples."""

    def __init__(self, root: str, key: str, n: int,
                 img_shape: Tuple[int, int, int],
                 dep_shape: Tuple[int, int, int], dep_dtype) -> None:
        self.dir = os.path.join(root, key)
        os.makedirs(self.dir, exist_ok=True)
        self._meta = {
            "n": n,
            "img_shape": list(img_shape),
            "dep_shape": list(dep_shape),
            "dep_dtype": np.dtype(dep_dtype).name,
        }
        meta_path = os.path.join(self.dir, "meta.json")
        fresh = True
        if os.path.exists(meta_path):
            try:
                with open(meta_path) as f:
                    fresh = json.load(f) != self._meta
            except (OSError, ValueError):
                fresh = True
        mode = "w+" if fresh else "r+"
        self.images = np.lib.format.open_memmap(
            os.path.join(self.dir, "images.npy"), mode=mode,
            dtype=np.uint8, shape=(n, *img_shape))
        self.depths = np.lib.format.open_memmap(
            os.path.join(self.dir, "depths.npy"), mode=mode,
            dtype=np.dtype(dep_dtype), shape=(n, *dep_shape))
        self.filled = np.lib.format.open_memmap(
            os.path.join(self.dir, "filled.npy"), mode=mode,
            dtype=np.uint8, shape=(n,))
        if fresh:
            self.filled[:] = 0
            with open(meta_path, "w") as f:
                json.dump(self._meta, f)

    def has(self, idx: int) -> bool:
        return bool(self.filled[idx])

    def get(self, idx: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        if not self.filled[idx]:
            return None
        return self.images[idx], self.depths[idx]

    def put(self, idx: int, img: np.ndarray, dep: np.ndarray) -> None:
        self.images[idx] = img
        self.depths[idx] = dep.reshape(self.depths.shape[1:])
        self.filled[idx] = 1

    @property
    def complete(self) -> bool:
        return bool(self.filled.all())
