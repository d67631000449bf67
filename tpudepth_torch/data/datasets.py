"""``datasets.get_dataloader``: split-aware loaders over the zip datasets.

Counterpart of ``tpudepth/data/datasets.py``. The reference's GuideDepth
stack imports ``data.datasets.get_dataloader`` (``src/GuideDepth/
training.py:42-55``, ``evaluate.py:60-66``, ``inference.py:111-123``) from a
package that was never vendored into the snapshot; its API is re-derived
from those call sites. The train split gets raw integer batches, a
decode-once cache (the memmap cache by default when the native decoder
knows the image size; ``cache_dir`` or ``TPUDEPTH_CACHE_DIR`` override it,
``TPUDEPTH_CACHE_DIR=""`` disables it) and decodes at the configured
resolution when that divides the files' size; val and test stay float, in
csv order. Covers NYU and KITTI (16-bit depth, meters = value / 256).
"""

from __future__ import annotations

import os
from typing import Optional

from tpudepth_torch.core.config import RESOLUTIONS
from tpudepth_torch.core.runtime import DeviceLike
from tpudepth_torch.data.diskcache import dataset_cache_key
from tpudepth_torch.data.nyu import (
    DATASET_LAYOUTS,
    DataLoader,
    NYUDepthDataset,
    _available_ram_gb,
    load_zip_to_mem,
)

# zip path -> ((size, mtime), loaded zip): the train and test loaders of one
# run read the zip once
_CACHE = {}


def _load(path: str, train_csv: str, test_csv: str):
    st = os.stat(path)
    ident = (st.st_size, st.st_mtime_ns, train_csv, test_csv)
    hit = _CACHE.get(path)
    if hit is None or hit[0] != ident:
        hit = _CACHE[path] = (ident, load_zip_to_mem(path, train_csv, test_csv))
    return hit[1]


def get_dataloader(
    dataset: str,
    path: str,
    split: str = "train",
    augmentation: str = "alhashim",
    batch_size: int = 8,
    resolution: str = "half",
    workers: int = 2,
    device: DeviceLike = None,
    shard: int = 0,
    num_shards: int = 1,
    raw: Optional[bool] = None,
    cache: Optional[bool] = None,
    cache_dir: Optional[str] = None,
    decode_hw: Optional[tuple] = None,
) -> DataLoader:
    """Call-site compatible with the reference's ``get_dataloader``
    (``src/GuideDepth/training.py:42-48``). ``split`` 'train' shuffles per
    epoch and drops the last partial batch; 'val' / 'test' keep csv order.
    There is no host augmentation: flip and channel swap run in the train
    step (``tpudepth_torch/data/augment.py``). ``device`` as in
    :class:`~tpudepth_torch.data.nyu.DataLoader`."""
    train_csv, test_csv, depth_scale = DATASET_LAYOUTS[dataset]
    data, train_pairs, test_pairs = _load(path, train_csv, test_csv)
    is_train = split == "train"
    pairs = train_pairs if is_train else test_pairs
    raw = is_train if raw is None else raw
    cache = is_train if cache is None else cache
    shard_pairs = list(pairs)[shard::num_shards] if num_shards > 1 else pairs
    if decode_hw is None and raw and is_train:
        # decode at the training resolution when it divides the files' dims
        decode_hw = RESOLUTIONS.get(dataset, {}).get(resolution)
    ds = NYUDepthDataset(data, pairs, shard=shard, num_shards=num_shards,
                         decode_workers=max(workers, 2),
                         depth_post_scale=depth_scale,
                         raw=raw, cache_decoded=cache,
                         max_cache_gb=_available_ram_gb() * 0.5,
                         cache_dir=cache_dir,
                         cache_key=dataset_cache_key(path, shard_pairs),
                         decode_hw=decode_hw if raw else None)
    return DataLoader(ds, batch_size, shuffle=is_train, drop_last=is_train,
                      device=device)
