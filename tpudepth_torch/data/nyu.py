"""NYU-Depth-V2 (Alhashim 50K layout) and KITTI zip-in-memory data feed.

Counterpart of ``tpudepth/data/nyu.py`` (``src/data.py``), with the same
pairs, the same batch order and the same pixels:

- The whole zip is read into a ``{name: bytes}`` dict up front
  (``src/data.py:48-53``); pair lists come from the split's csv and are
  shuffled with the ``sklearn.utils.shuffle(random_state=0)`` permutation
  (``src/data.py:69-71``).
- Decode semantics of ``ToTensor.to_tensor`` (``src/data.py:124-155``):
  8-bit images -> float/255; 16-bit and 'I' depth maps keep raw values.
- ``raw`` datasets keep the integer pixels (uint8 rgb, uint8 / uint16
  depth); the /255 and the depth scaling run in the train step on the
  device. A decode-once RAM cache, or the memmap cache of ``diskcache.py``
  shared across runs, stores them; a daemon thread fills it in the
  background.
- Batches decode through the C++ decoder of ``data/native`` when it builds,
  else with Pillow, on a thread pool; :meth:`NYUDepthDataset.decoder` says
  which one served.
- :class:`DataLoader` keeps the JAX loader's batch order
  (``RandomState(seed + epoch)``), ``drop_last`` and ``len``. With
  ``device=None`` it yields numpy dicts as the JAX loader does; with a CUDA
  ``device`` each batch is pinned by a prefetch thread and copied to the
  card one batch ahead on a stream of its own (the JAX loader's
  ``sharding=`` device prefetch, ``nyu.py:428-449``).
- ``shard`` / ``num_shards`` slice the pair list per process.
"""

from __future__ import annotations

import collections
import functools
import io
import os
import threading
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpudepth_torch.core.runtime import DeviceLike, resolve_device
from tpudepth_torch.data import native
from tpudepth_torch.data.diskcache import RawDiskCache, dataset_cache_key

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None


def reference_shuffle(items: List, seed: int = 0) -> List:
    """The ``sklearn.utils.shuffle(x, random_state=seed)`` permutation without
    the sklearn dependency."""
    perm = np.random.RandomState(seed).permutation(len(items))
    return [items[i] for i in perm]


def _pairs(data: Dict[str, bytes], csv_name: str) -> List[List[str]]:
    return [row.split(",") for row in data[csv_name].decode("utf-8").split("\n")
            if len(row) > 0]


def load_zip_to_mem(
    zip_path: str, csv_name: str = "data/nyu2_train.csv",
    test_csv: str = "data/nyu2_test.csv",
) -> Tuple[Dict[str, bytes], List[List[str]], List[List[str]]]:
    """Read the whole zip into memory and parse the train/test pair CSVs."""
    with zipfile.ZipFile(zip_path) as zf:
        data = {name: zf.read(name) for name in zf.namelist()}
    train = reference_shuffle(_pairs(data, csv_name), 0)
    test = reference_shuffle(_pairs(data, test_csv), 0)
    return data, train, test


def _decode(buf: bytes) -> np.ndarray:
    """Pillow decode with the reference's ToTensor dtypes
    (``src/data.py:124-155``)."""
    img = Image.open(io.BytesIO(buf))
    arr = np.asarray(img)
    if img.mode in ("I", "I;16"):
        out = arr.astype(np.float32)
    else:
        out = arr.astype(np.float32) / 255.0
    return out[:, :, None] if out.ndim == 2 else out


def _decode_raw(buf: bytes) -> np.ndarray:
    """Pillow decode keeping the integer pixels: uint8 for 8-bit sources,
    uint16 for 16-bit / 'I' depth maps."""
    img = Image.open(io.BytesIO(buf))
    arr = np.asarray(img)
    out = arr.astype(np.uint16 if img.mode in ("I", "I;16") else np.uint8)
    return out[:, :, None] if out.ndim == 2 else out


def _box_down(arr: np.ndarray, s: int) -> np.ndarray:
    """Exact s x s box average (integer, round-to-nearest): the Pillow path's
    equivalent of the native decoder's scaled decode."""
    h, w, c = arr.shape
    a = arr.reshape(h // s, s, w // s, s, c).astype(np.uint32).sum(axis=(1, 3))
    return ((a + s * s // 2) // (s * s)).astype(arr.dtype)


class NYUDepthDataset:
    """In-memory (rgb, depth) pair dataset (``depthDatasetMemory``,
    ``src/data.py:77-98``) with threaded batch decode.

    ``depth_post_scale`` converts depth to meters (KITTI's 16-bit maps:
    1/256); float samples carry it, raw samples leave it to the train step.
    ``decode_hw`` (raw only, native decoder only) decodes at 1/2, 1/4 or 1/8
    of the files' size when it divides them: JPEGs by DCT scaling, PNGs by
    box average, so the caches hold 1/s^2 the bytes."""

    def __init__(
        self,
        data: Dict[str, bytes],
        pairs: Sequence[Sequence[str]],
        shard: int = 0,
        num_shards: int = 1,
        decode_workers: int = 8,
        use_native: bool = True,
        cache_decoded: bool = False,
        max_cache_gb: float = 48.0,
        depth_post_scale: float = 1.0,
        raw: bool = False,
        cache_dir: Optional[str] = None,
        cache_key: Optional[str] = None,
        decode_hw: Optional[Tuple[int, int]] = None,
        background_fill: bool = True,
    ):
        if num_shards > 1:
            pairs = list(pairs)[shard::num_shards]
        self.data = data
        self.pairs = list(pairs)
        self.depth_post_scale = depth_post_scale
        self.raw = raw
        self._pool = ThreadPoolExecutor(max_workers=decode_workers)
        self._count_lock = threading.Lock()
        # samples decoded by each decoder (a sample is an rgb + depth pair)
        self.decoded = {"native": 0, "pillow": 0}
        self._native_shapes = None  # ((h,w,c), (h,w,c)) for (rgb, depth)
        self._native_bits = None  # (rgb_bit_depth, depth_bit_depth)
        self._scale = 1
        if use_native and self.pairs:
            self._probe_native()
        if decode_hw is not None and self._native_shapes is not None:
            if not raw:
                raise ValueError("decode_hw requires the raw pipeline")
            (ih, iw, ic), (dh, dw, dc) = self._native_shapes
            for s in (2, 4, 8):
                if (ih, iw) == (decode_hw[0] * s, decode_hw[1] * s) and (
                        dh, dw) == (decode_hw[0] * s, decode_hw[1] * s):
                    self._scale = s
                    self._native_shapes = (
                        (decode_hw[0], decode_hw[1], ic),
                        (decode_hw[0], decode_hw[1], dc))
                    break
        self._cache = None
        self._disk = None
        if cache_dir is None:
            cache_dir = os.environ.get("TPUDEPTH_CACHE_DIR")
        if cache_dir is None and cache_decoded and self._native_shapes is not None:
            # without a disk cache every new process pays a decode epoch:
            # default to a per-machine path when the decoded dataset fits
            # the budget; TPUDEPTH_CACHE_DIR="" opts out
            cache_dir = self._default_cache_dir()
        if cache_dir and self.pairs and self._native_shapes is not None:
            (ih, iw, ic), (dh, dw, dc) = self._native_shapes
            dep_dtype = np.uint16 if self._native_bits[1] == 16 else np.uint8
            key = cache_key or dataset_cache_key("", self.pairs)
            if self._scale > 1:  # scaled pixels live in their own cache dir
                key = f"{key}_s{self._scale}"
            try:
                self._disk = RawDiskCache(cache_dir, key, len(self.pairs),
                                          (ih, iw, ic), (dh, dw, dc), dep_dtype)
            except OSError:
                self._disk = None
        if self._disk is None and cache_decoded and self.pairs:
            if self._native_shapes is not None:
                (ih, iw, ic), (dh, dw, dc) = self._native_shapes
                dep_itemsize = 2 if self._native_bits[1] == 16 else 1
                first = None
                sample_bytes = ih * iw * ic + dh * dw * dc * dep_itemsize
            else:  # the size of a decoded sample is known only by decoding
                first = self.get_raw(0)
                sample_bytes = first[0].nbytes + first[1].nbytes
            if sample_bytes * len(self.pairs) / 1e9 <= max_cache_gb:
                self._cache = {} if first is None else {0: first}
            # else: stream, decoding every epoch
        # fill the decode-once cache while the process does other work (the
        # native decode releases the interpreter lock): a daemon thread
        # decodes unseen indices in order
        self._fill_stop = False
        if background_fill and (self._disk is not None or self._cache is not None):
            threading.Thread(target=self._background_fill, daemon=True).start()

    def _count(self, decoder: str, n: int = 1):
        with self._count_lock:
            self.decoded[decoder] += n

    def decoder(self) -> str:
        """Which decoder served this dataset so far: ``'native'``,
        ``'pillow'``, ``'native+pillow'``, or ``'none'`` when every sample
        came from a cache filled earlier."""
        used = [k for k in ("native", "pillow") if self.decoded[k]]
        return "+".join(used) or "none"

    def _default_cache_dir(self) -> Optional[str]:
        """``$XDG_CACHE_HOME/tpudepth_data`` (``~/.cache``) iff the decoded
        dataset fits the budget: min(half the free disk there,
        ``TPUDEPTH_CACHE_BUDGET_GB`` when set)."""
        import shutil

        (ih, iw, ic), (dh, dw, dc) = self._native_shapes
        dep_itemsize = 2 if self._native_bits[1] == 16 else 1
        need = len(self.pairs) * (ih * iw * ic + dh * dw * dc * dep_itemsize)
        root = os.path.join(
            os.path.expanduser(os.environ.get("XDG_CACHE_HOME", "~/.cache")),
            "tpudepth_data")
        try:
            os.makedirs(root, exist_ok=True)
            budget = shutil.disk_usage(root).free * 0.5
        except OSError:
            return None
        env_gb = os.environ.get("TPUDEPTH_CACHE_BUDGET_GB")
        if env_gb:
            budget = min(budget, float(env_gb) * 1e9)
        return root if need <= budget else None

    def _background_fill(self, chunk: int = 32):
        """Fill the raw cache front to back in chunks; cached rows are
        skipped. Best effort: the foreground decodes whatever is missing."""
        try:
            n = len(self.pairs)
            for start in range(0, n, chunk):
                if self._fill_stop:
                    return
                idx = [i for i in range(start, min(start + chunk, n))
                       if not self._has_cached(i)]
                if idx:
                    self.get_batch_raw(idx)
        except Exception:  # noqa: BLE001 - a daemon thread must not die loudly
            return

    def _has_cached(self, i: int) -> bool:
        if self._disk is not None:
            return self._disk.has(i)
        if self._cache is not None:
            return i in self._cache
        return True

    def _probe_native(self):
        """Learn the dataset's (uniform) image dims so batches can decode
        through the C++ decoder."""
        rgb = native.probe(self.data[self.pairs[0][0]])
        dep = native.probe(self.data[self.pairs[0][1]])
        if rgb and dep:
            self._native_shapes = (rgb[:3], dep[:3])
            self._native_bits = (rgb[3], dep[3])

    def __len__(self) -> int:
        return len(self.pairs)

    def get(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """Float sample with the reference's ToTensor and depth scaling."""
        if self._disk is not None or self._cache is not None:
            img_raw, dep_raw = self.get_raw(idx)  # the cache-filling path
            return self._to_float(img_raw), self._to_float(dep_raw, depth=True)
        rgb_name, depth_name = self.pairs[idx][0], self.pairs[idx][1]
        img = _decode(self.data[rgb_name])
        dep = _decode(self.data[depth_name])
        self._count("pillow")
        if self.depth_post_scale != 1.0:
            dep = dep * self.depth_post_scale
        return img, dep

    def get_raw(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """Integer sample (uint8 rgb, uint8 / uint16 depth), unscaled."""
        if self._disk is not None:
            hit = self._disk.get(idx)
            if hit is not None:
                return hit
        if self._cache is not None and idx in self._cache:
            return self._cache[idx]
        rgb_name, depth_name = self.pairs[idx][0], self.pairs[idx][1]
        img = _decode_raw(self.data[rgb_name])
        dep = _decode_raw(self.data[depth_name])
        self._count("pillow")
        if self._scale > 1:
            img = _box_down(img, self._scale)
            dep = _box_down(dep, self._scale)
        if self._disk is not None:
            self._disk.put(idx, img, dep)
        elif self._cache is not None:
            self._cache[idx] = (img, dep)
        return img, dep

    def _to_float(self, arr: np.ndarray, depth: bool = False) -> np.ndarray:
        out = arr.astype(np.float32)
        if arr.dtype == np.uint8:
            out /= 255.0
        if depth and self.depth_post_scale != 1.0:
            out *= np.float32(self.depth_post_scale)
        return out

    def _stack(self, fn, indices) -> Dict[str, np.ndarray]:
        outs = list(self._pool.map(fn, indices))
        return {"image": np.stack([o[0] for o in outs]),
                "depth": np.stack([o[1] for o in outs])}

    def _native_bufs(self, indices):
        return ([self.data[self.pairs[i][0]] for i in indices],
                [self.data[self.pairs[i][1]] for i in indices])

    def get_batch(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        if self.raw:
            return self.get_batch_raw(indices)
        if self._cache is None and self._native_shapes is not None:
            (ih, iw, ic), (dh, dw, dc) = self._native_shapes
            rgb_bufs, dep_bufs = self._native_bufs(indices)
            images = native.decode_batch(rgb_bufs, ih, iw, ic)
            depths = native.decode_batch(dep_bufs, dh, dw, dc)
            if images is not None and depths is not None:
                self._count("native", len(indices))
                if self.depth_post_scale != 1.0:
                    depths = depths * np.float32(self.depth_post_scale)
                return {"image": images, "depth": depths}
        return self._stack(self.get, indices)

    def get_batch_raw(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        """Batch of integer pixels. A cache hit costs one stack (a copy); the
        device does /255 and the depth scaling."""
        if self._disk is not None and all(self._disk.has(i) for i in indices):
            idx = np.asarray(list(indices))
            return {"image": self._disk.images[idx],
                    "depth": self._disk.depths[idx]}
        if self._cache is not None and all(i in self._cache for i in indices):
            return {"image": np.stack([self._cache[i][0] for i in indices]),
                    "depth": np.stack([self._cache[i][1] for i in indices])}
        if self._native_shapes is not None:
            (ih, iw, ic), (dh, dw, dc) = self._native_shapes
            ibits, dbits = self._native_bits
            rgb_bufs, dep_bufs = self._native_bufs(indices)
            images = native.decode_batch_raw(rgb_bufs, ih, iw, ic, ibits,
                                             scale_denom=self._scale)
            depths = native.decode_batch_raw(dep_bufs, dh, dw, dc, dbits,
                                             scale_denom=self._scale)
            if images is not None and depths is not None:
                self._count("native", len(indices))
                for j, i in enumerate(indices):
                    if self._disk is not None:
                        self._disk.put(i, images[j], depths[j])
                    elif self._cache is not None:
                        self._cache[i] = (images[j], depths[j])
                return {"image": images, "depth": depths}
        return self._stack(self.get_raw, indices)


def _pinned_batch(dataset: NYUDepthDataset,
                  indices: Sequence[int]) -> Dict[str, torch.Tensor]:
    """The batch in freshly allocated page-locked host memory."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
            for k, v in dataset.get_batch(indices).items()}


class DataLoader:
    """Batched iterator with per-epoch shuffling and prefetch.

    ``prefetch`` threads assemble the next batches while the current one is
    used. ``device=None`` yields numpy dicts. A CPU ``device`` yields
    tensors that share the numpy batch's memory. A CUDA ``device`` yields
    tensors on the card: each batch is pinned in its prefetch thread, into
    freshly allocated memory, and copied with ``non_blocking=True`` on a
    copy stream one batch ahead; the consumer's stream waits for the copy,
    and the pinned memory is kept until the copy has run."""

    def __init__(self, dataset: NYUDepthDataset, batch_size: int,
                 shuffle: bool = False, seed: int = 0, drop_last: bool = True,
                 device: DeviceLike = None, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.device = None if device is None else resolve_device(device)
        self.prefetch = max(1, prefetch)
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def _batch_indices(self) -> List[np.ndarray]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(idx)
        return [idx[i * self.batch_size:(i + 1) * self.batch_size]
                for i in range(len(self))]

    def __iter__(self) -> Iterator[Dict]:
        cuda = self.device is not None and self.device.type == "cuda"
        # a CUDA loader pins each batch in the prefetch thread
        load = (functools.partial(_pinned_batch, self.dataset) if cuda
                else self.dataset.get_batch)
        batches = self._batch_indices()
        pool = ThreadPoolExecutor(max_workers=self.prefetch)
        try:
            futures = [pool.submit(load, b)
                       for b in batches[:min(self.prefetch, len(batches))]]

            def result(i):
                if len(futures) < len(batches):
                    futures.append(pool.submit(load, batches[len(futures)]))
                return futures[i].result()

            if cuda:
                yield from self._to_card(result, len(batches))
                return
            for i in range(len(batches)):
                batch = result(i)
                if self.device is not None:
                    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
                             for k, v in batch.items()}
                yield batch
        finally:
            pool.shutdown(wait=False, cancel_futures=True)

    def _to_card(self, result, n: int) -> Iterator[Dict[str, torch.Tensor]]:
        stream = torch.cuda.Stream(self.device)
        pending = collections.deque()  # (event, pinned batch) of copies in flight

        def copy(pinned):
            with torch.cuda.stream(stream):
                out = {k: v.to(self.device, non_blocking=True)
                       for k, v in pinned.items()}
                done = torch.cuda.Event()
                done.record(stream)
            pending.append((done, pinned))
            return out, done

        try:
            staged = copy(result(0)) if n else None
            for i in range(n):
                batch, done = staged
                if i + 1 < n:
                    staged = copy(result(i + 1))
                while pending and pending[0][0].query():
                    pending.popleft()
                consumer = torch.cuda.current_stream(self.device)
                consumer.wait_event(done)
                for t in batch.values():
                    # allocated on the copy stream, used on the consumer's:
                    # the allocator must wait for both before reusing it
                    t.record_stream(consumer)
                yield batch
        finally:
            for done, _ in pending:
                done.synchronize()


#: csv pair-list names and depth scale per dataset family: NYU's 8-bit depth
#: is /255 by the decoder (``src/data.py:54-55,132,153``); KITTI's 16-bit
#: PNG is meters x 256
DATASET_LAYOUTS = {
    "nyu": ("data/nyu2_train.csv", "data/nyu2_test.csv", 1.0),
    "nyu_reduced": ("data/nyu2_train.csv", "data/nyu2_test.csv", 1.0),
    "kitti": ("data/kitti_train.csv", "data/kitti_test.csv", 1.0 / 256.0),
}


def _available_ram_gb() -> float:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) / 1e6
    except OSError:
        pass
    return 0.0


def get_training_testing_data(
    batch_size: int,
    zip_path: str = "CSVdata.zip",
    device: DeviceLike = None,
    shard: int = 0,
    num_shards: int = 1,
    dataset: str = "nyu_reduced",
    raw: Optional[bool] = None,
    cache: Optional[bool] = None,
    cache_dir: Optional[str] = None,
    decode_hw: Optional[Tuple[int, int]] = None,
) -> Tuple[DataLoader, DataLoader]:
    """``getTrainingTestingData`` (``src/data.py:171-179``): the train loader
    shuffled, raw integer batches and a decode-once cache by default; the
    test loader in csv order, float, every sample. ``device`` goes to the
    train loader only: the evaluators read host arrays."""
    train_csv, test_csv, depth_scale = DATASET_LAYOUTS[dataset]
    data, train_pairs, test_pairs = load_zip_to_mem(zip_path, train_csv,
                                                    test_csv)
    raw = True if raw is None else raw
    cache = True if cache is None else cache
    shard_pairs = (list(train_pairs)[shard::num_shards]
                   if num_shards > 1 else train_pairs)
    train = NYUDepthDataset(data, train_pairs, shard, num_shards,
                            depth_post_scale=depth_scale, raw=raw,
                            cache_decoded=cache,
                            max_cache_gb=_available_ram_gb() * 0.5,
                            cache_dir=cache_dir,
                            cache_key=dataset_cache_key(zip_path, shard_pairs),
                            decode_hw=decode_hw if raw else None)
    test = NYUDepthDataset(data, test_pairs, depth_post_scale=depth_scale)
    return (DataLoader(train, batch_size, shuffle=True, device=device),
            DataLoader(test, batch_size, shuffle=False, drop_last=False))


def get_testing_data(batch_size: int, zip_path: str = "testData.zip",
                     device: DeviceLike = None) -> DataLoader:
    """``getTestingData`` (``src/data.py:203-206``)."""
    with zipfile.ZipFile(zip_path) as zf:
        data = {name: zf.read(name) for name in zf.namelist()}
    pairs = reference_shuffle(_pairs(data, "data/nyu2_test.csv"), 0)
    return DataLoader(NYUDepthDataset(data, pairs), batch_size, shuffle=True,
                      drop_last=False, device=device)
