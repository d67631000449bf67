"""The port's data feed against the JAX package's, on the CPU.

Tiny seeded zips (8 train and 4 test pairs at 48x64) made by each package's
own ``make_synthetic_zip`` / ``make_synthetic_kitti_zip`` from one seed go
through both packages: the zips, ``load_zip_to_mem``, ``reference_shuffle``,
``dataset_cache_key``, ``NYUDepthDataset.get`` / ``get_raw`` /
``get_batch`` (float and raw, native decoder and Pillow, RAM cache,
``decode_hw`` box-down), ``DataLoader``'s batch order over two epochs with
``len`` and ``drop_last``, ``get_dataloader`` for every split, and a
``RawDiskCache`` written by one package and read by the other. Every
comparison is exact: both packages decode with the same code. Then the
port's native decoder against its Pillow decode (the intent of
``tests/test_native_decoder.py``), the KITTI conventions
(``tests/test_kitti_data.py``), the loader's tensor output and
``utils/viz.py`` against the JAX package's.
"""

import io
import os
import shutil
import time
import zipfile

import numpy as np
import pytest
import torch

from tpudepth import data as jdata
from tpudepth.data import datasets as jdatasets
from tpudepth.data import diskcache as jdiskcache
from tpudepth.data import nyu as jnyu
from tpudepth.utils import viz as jviz
from tpudepth_torch import data as pdata
from tpudepth_torch.data import datasets as pdatasets
from tpudepth_torch.data import diskcache as pdiskcache
from tpudepth_torch.data import native
from tpudepth_torch.data import nyu as pnyu
from tpudepth_torch.utils import viz as pviz

HW = (48, 64)
FAMILIES = ("nyu", "kitti")
LAYOUT = {"nyu": "nyu_reduced", "kitti": "kitti"}


def _make(pkg, family, path):
    if family == "nyu":
        return pkg.make_synthetic_zip(path, n_train=8, n_test=4, image_hw=HW,
                                      seed=3)
    return pkg.make_synthetic_kitti_zip(path, n_train=8, n_test=4,
                                        image_hw=HW, seed=3)


@pytest.fixture(scope="module")
def zips(tmp_path_factory):
    """(package, family) -> zip path; 'jax' and 'port' made by their own
    package from the same seed."""
    root = tmp_path_factory.mktemp("zips")
    return {(name, fam): _make(pkg, fam, str(root / f"{name}_{fam}.zip"))
            for name, pkg in (("jax", jdata), ("port", pdata))
            for fam in FAMILIES}


@pytest.fixture(scope="module")
def native_lib():
    if native.get_lib() is None:
        pytest.skip(f"native decoder unavailable: {native.build_error()}")
    return native.get_lib()


def _layout(family):
    return pnyu.DATASET_LAYOUTS[LAYOUT[family]]


def _loaded(pkg_nyu, path, family):
    train_csv, test_csv, _ = _layout(family)
    return pkg_nyu.load_zip_to_mem(path, train_csv, test_csv)


def _assert_batches_equal(a, b):
    assert set(a) == set(b) == {"image", "depth"}
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


@pytest.mark.parametrize("family", FAMILIES)
def test_both_packages_zips_hold_the_same_pairs_and_pixels(zips, family):
    members = []
    for name in ("jax", "port"):
        with zipfile.ZipFile(zips[(name, family)]) as zf:
            members.append({n: zf.read(n) for n in zf.namelist()})
    assert members[0] == members[1]
    for name, buf in members[0].items():
        if not name.endswith(".csv"):
            np.testing.assert_array_equal(jnyu._decode_raw(buf),
                                          pnyu._decode_raw(members[1][name]))


@pytest.mark.parametrize("seed", (0, 5))
def test_reference_shuffle_matches_jax(seed):
    """The JAX package's ``reference_shuffle`` is held to sklearn's
    ``shuffle(random_state=seed)`` by ``tests/test_data.py``."""
    items = [[f"rgb{i}", f"d{i}"] for i in range(137)]
    got = pnyu.reference_shuffle(items, seed)
    assert got == jnyu.reference_shuffle(items, seed) and got != items


@pytest.mark.parametrize("family", FAMILIES)
def test_load_zip_to_mem_matches_jax(zips, family):
    jd, jtrain, jtest = _loaded(jnyu, zips[("jax", family)], family)
    pd, ptrain, ptest = _loaded(pnyu, zips[("port", family)], family)
    assert (ptrain, ptest) == (jtrain, jtest)
    assert len(ptrain) == 8 and len(ptest) == 4 and jd == pd


def test_dataset_cache_key_matches_jax(zips):
    path = zips[("port", "nyu")]
    _, train, _ = _loaded(pnyu, path, "nyu")
    for p in (path, "/no/such/zip", ""):
        assert (pdiskcache.dataset_cache_key(p, train)
                == jdiskcache.dataset_cache_key(p, train))
    assert (pdiskcache.dataset_cache_key(path, train[:4])
            != pdiskcache.dataset_cache_key(path, train))


MODES = {  # NYUDepthDataset keyword arguments
    "float-native": dict(use_native=True),
    "float-pillow": dict(use_native=False),
    "raw-native": dict(raw=True, use_native=True),
    "raw-pillow": dict(raw=True, use_native=False),
    "raw-ram-cache": dict(raw=True, cache_decoded=True, background_fill=False),
    "float-ram-cache": dict(cache_decoded=True, use_native=False),
}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("family", FAMILIES)
def test_dataset_samples_and_batches_match_jax(zips, native_lib, family, mode):
    scale = _layout(family)[2]
    sets = []
    for pkg_nyu, name in ((jnyu, "jax"), (pnyu, "port")):
        data, train, _ = _loaded(pkg_nyu, zips[(name, family)], family)
        sets.append(pkg_nyu.NYUDepthDataset(
            data, train, depth_post_scale=scale, **MODES[mode]))
    jds, pds = sets
    assert len(pds) == len(jds) == 8
    for i in (0, 5):
        for a, b in zip(jds.get(i), pds.get(i)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(jds.get_raw(i), pds.get_raw(i)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    idx = [3, 0, 7, 1]
    _assert_batches_equal(jds.get_batch(idx), pds.get_batch(idx))
    # a second call is served by the RAM cache where there is one
    _assert_batches_equal(jds.get_batch(idx), pds.get_batch(idx))


@pytest.mark.parametrize("family", FAMILIES)
def test_decode_hw_box_down_matches_jax(zips, native_lib, family):
    half = (HW[0] // 2, HW[1] // 2)
    out = []
    for pkg_nyu, name in ((jnyu, "jax"), (pnyu, "port")):
        data, train, _ = _loaded(pkg_nyu, zips[(name, family)], family)
        ds = pkg_nyu.NYUDepthDataset(data, train, raw=True, decode_hw=half,
                                     background_fill=False)
        assert ds._scale == 2
        out.append(ds.get_batch(range(8)))
    assert out[1]["image"].shape == (8, *half, 3)
    _assert_batches_equal(*out)
    arr = np.random.default_rng(0).integers(0, 65535, (8, 12, 1), np.uint16)
    np.testing.assert_array_equal(pnyu._box_down(arr, 4),
                                  jnyu._box_down(arr, 4))


@pytest.mark.parametrize("split", ("train", "test"))
@pytest.mark.parametrize("family", FAMILIES)
def test_loader_batch_order_len_and_drop_last_match_jax(zips, family, split):
    """``get_training_testing_data``'s loaders, batch 3 over 8 train / 4
    test pairs: the train loader shuffles by ``RandomState(seed + epoch)``
    and drops the last partial batch, the test loader keeps csv order and
    keeps it."""
    loaders = []
    for pkg, name in ((jnyu, "jax"), (pnyu, "port")):
        tr, te = pkg.get_training_testing_data(3, zips[(name, family)],
                                               dataset=LAYOUT[family])
        loaders.append(tr if split == "train" else te)
    jl, pl = loaders
    assert len(pl) == len(jl) == 2
    assert (pl.shuffle, pl.drop_last) == (jl.shuffle, jl.drop_last) == (
        (True, True) if split == "train" else (False, False))
    epochs = []
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        jb, pb = list(jl), list(pl)
        assert len(pb) == len(jb) == 2
        for a, b in zip(jb, pb):
            _assert_batches_equal(a, b)
        epochs.append(pb)
    sizes = [b["image"].shape[0] for b in epochs[0]]
    assert sizes == ([3, 3] if split == "train" else [3, 1])
    first = [np.array_equal(a["image"], b["image"])
             for a, b in zip(*epochs)]
    assert first == ([False, False] if split == "train" else [True, True])


@pytest.mark.parametrize("split", ("train", "val", "test"))
@pytest.mark.parametrize("family", FAMILIES)
def test_get_dataloader_matches_jax(zips, family, split):
    jdatasets._CACHE.clear()
    loaders = [mod.get_dataloader(LAYOUT[family], zips[(name, family)], split,
                                  batch_size=3, resolution="half")
               for mod, name in ((jdatasets, "jax"), (pdatasets, "port"))]
    jl, pl = loaders
    assert len(pl) == len(jl)
    assert (pl.shuffle, pl.drop_last, pl.dataset.raw) == (
        jl.shuffle, jl.drop_last, jl.dataset.raw) == (
        (split == "train",) * 3)
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        jb, pb = list(jl), list(pl)
        assert len(pb) == len(jb) == len(pl)
        for a, b in zip(jb, pb):
            _assert_batches_equal(a, b)
    jdatasets._CACHE.clear()


@pytest.mark.parametrize("writer", ("jax", "port"))
def test_a_disk_cache_written_by_one_package_reads_back_in_the_other(
        zips, native_lib, tmp_path, writer):
    """The writer's dataset decodes and fills the memmaps; the reader's,
    built over an EMPTY zip dict (any decode would raise), serves the same
    batches from the files alone."""
    pkgs = {"jax": (jnyu, jdiskcache), "port": (pnyu, pdiskcache)}
    reader = "port" if writer == "jax" else "jax"
    path = zips[(writer, "nyu")]
    wnyu, _ = pkgs[writer]
    data, train, _ = _loaded(wnyu, path, "nyu")
    key = pdiskcache.dataset_cache_key(path, train)
    wds = wnyu.NYUDepthDataset(data, train, raw=True, cache_dir=str(tmp_path),
                               cache_key=key, background_fill=False)
    assert wds._disk is not None
    want = wds.get_batch(range(8))
    assert wds._disk.complete
    rnyu, rcache = pkgs[reader]
    rds = rnyu.NYUDepthDataset({}, train, raw=True, use_native=False,
                               background_fill=False)
    (ih, iw, ic), (dh, dw, dc) = wds._native_shapes
    rds._disk = rcache.RawDiskCache(str(tmp_path), key, len(train),
                                    (ih, iw, ic), (dh, dw, dc), np.uint8)
    assert rds._disk.complete
    _assert_batches_equal(rds.get_batch(range(8)), want)
    if reader == "port":
        assert rds.decoder() == "none"


def _jpeg(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr, "RGB").save(buf, "JPEG", quality=95)
    return buf.getvalue()


def _png(arr, mode):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "PNG")
    return buf.getvalue()


def test_native_decoder_builds_into_the_packages_build_dir(native_lib):
    assert os.path.dirname(native_lib._name).endswith(
        os.path.join("tpudepth_torch", "_build"))
    assert native.build_error() is None


def test_native_probe(native_lib, rng):
    img = (rng.random((32, 48, 3)) * 255).astype(np.uint8)
    assert native.probe(_jpeg(img)) == (32, 48, 3, 8)
    dep8 = (rng.random((24, 20)) * 255).astype(np.uint8)
    assert native.probe(_png(dep8, "L")) == (24, 20, 1, 8)
    dep16 = (rng.random((24, 20)) * 65535).astype(np.uint16)
    assert native.probe(_png(dep16, None)) == (24, 20, 1, 16)
    assert native.probe(b"not an image") is None


@pytest.mark.parametrize("kind", ("jpeg", "png8", "png16", "mixed"))
def test_native_batch_decode_matches_pillow(native_lib, rng, kind):
    if kind == "jpeg":
        arrs = [(rng.random((32, 48, 3)) * 255).astype(np.uint8)
                for _ in range(5)]
        bufs = [_jpeg(a) for a in arrs]
    elif kind == "png8":
        arrs = [(rng.random((16, 20)) * 255).astype(np.uint8) for _ in range(4)]
        bufs = [_png(a, "L") for a in arrs]
    elif kind == "png16":
        arrs = [(rng.random((16, 20)) * 65535).astype(np.uint16)
                for _ in range(3)]
        bufs = [_png(a, None) for a in arrs]
    else:  # JPEG sniffing routes each item of a mixed batch
        a = (rng.random((8, 8, 3)) * 255).astype(np.uint8)
        bufs = [_jpeg(a), _png(a, "RGB")]
    h, w, c = pnyu._decode(bufs[0]).shape
    got = native.decode_batch(bufs, h, w, c, nthreads=3)
    raw = native.decode_batch_raw(bufs, h, w, c,
                                  16 if kind == "png16" else 8)
    assert got is not None and got.shape == (len(bufs), h, w, c)
    for i, b in enumerate(bufs):
        # x * (1/255) in C against x / 255 in numpy: 1 ulp apart at most
        np.testing.assert_allclose(got[i], pnyu._decode(b), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(raw[i], pnyu._decode_raw(b))


def test_native_decode_refuses_wrong_dims_and_corrupt_buffers(native_lib, rng):
    img = (rng.random((32, 48, 3)) * 255).astype(np.uint8)
    assert native.decode_batch([_jpeg(img)], 16, 16, 3) is None
    assert native.decode_batch([b"\xff\xd8\xffgarbagegarbage"], 8, 8, 3) is None
    assert native.decode_batch_raw([_jpeg(img)], 16, 24, 3, 8,
                                   scale_denom=3) is None


@pytest.mark.parametrize("raw", (False, True))
def test_dataset_native_equals_pillow_and_says_which_served(zips, native_lib,
                                                            raw):
    data, train, _ = _loaded(pnyu, zips[("port", "nyu")], "nyu")
    nat = pnyu.NYUDepthDataset(data, train, raw=raw, use_native=True)
    pil = pnyu.NYUDepthDataset(data, train, raw=raw, use_native=False)
    assert nat._native_shapes is not None and pil._native_shapes is None
    assert nat.decoder() == pil.decoder() == "none"
    a, b = nat.get_batch(range(6)), pil.get_batch(range(6))
    for k in ("image", "depth"):
        assert a[k].dtype == b[k].dtype
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6)
    assert (nat.decoded, nat.decoder()) == ({"native": 6, "pillow": 0},
                                            "native")
    assert (pil.decoded, pil.decoder()) == ({"native": 0, "pillow": 6},
                                            "pillow")


def test_scaled_raw_decode_matches_box_average(zips, native_lib):
    """scale_denom 2: PNG depth equals the exact 2x2 integer box average;
    JPEG decodes by DCT scaling, close to the box average, not equal."""
    data, train, _ = _loaded(pnyu, zips[("port", "nyu")], "nyu")
    full = pnyu.NYUDepthDataset(data, train, raw=True, background_fill=False)
    (ih, iw, ic), (dh, dw, dc) = full._native_shapes
    half = pnyu.NYUDepthDataset(data, train, raw=True, background_fill=False,
                                decode_hw=(ih // 2, iw // 2))
    assert half._scale == 2
    b_full = full.get_batch_raw(range(3))
    b_half = half.get_batch_raw(range(3))
    assert b_half["image"].shape == (3, ih // 2, iw // 2, ic)
    for j in range(3):
        np.testing.assert_array_equal(b_half["depth"][j],
                                      pnyu._box_down(b_full["depth"][j], 2))
        diff = (b_half["image"][j].astype(np.int32)
                - pnyu._box_down(b_full["image"][j], 2).astype(np.int32))
        assert np.mean(np.abs(diff)) < 6.0
    with pytest.raises(ValueError, match="raw"):
        pnyu.NYUDepthDataset(data, train, decode_hw=(ih // 2, iw // 2))


def test_background_fill_populates_the_cache(zips):
    data, train, _ = _loaded(pnyu, zips[("port", "nyu")], "nyu")
    ds = pnyu.NYUDepthDataset(data, train, raw=True, cache_decoded=True)
    deadline = time.time() + 30
    while time.time() < deadline and len(ds._cache or ()) < len(ds.pairs):
        time.sleep(0.05)
    assert ds._cache is not None and len(ds._cache) == len(ds.pairs)
    # each sample decoded once, by the native decoder where it builds
    assert sum(ds.decoded.values()) == len(ds.pairs)
    assert ds.decoder() == ("native" if native.get_lib() else "pillow")


def test_cache_respects_the_budget(zips):
    data, train, _ = _loaded(pnyu, zips[("port", "nyu")], "nyu")
    ds = pnyu.NYUDepthDataset(data, train, cache_decoded=True,
                              max_cache_gb=1e-9)
    assert ds._cache is None  # streams


def test_get_dataloader_cache_key_tracks_zip_identity(zips, tmp_path,
                                                      monkeypatch):
    """A regenerated zip with the same pair names must not serve stale
    memmap pixels: the key holds the zip's size and mtime."""
    monkeypatch.setenv("TPUDEPTH_CACHE_DIR", str(tmp_path / "cache"))
    zip1 = zips[("port", "nyu")]
    zip2 = str(tmp_path / "copy.zip")
    shutil.copy(zip1, zip2)
    os.utime(zip2, (1, 1))
    t1 = pdatasets.get_dataloader("nyu_reduced", zip1, "train", batch_size=2)
    t2 = pdatasets.get_dataloader("nyu_reduced", zip2, "train", batch_size=2)
    assert t1.dataset._disk is not None and t2.dataset._disk is not None
    assert t1.dataset._disk.dir != t2.dataset._disk.dir


def test_loader_yields_tensors_on_a_device_and_needs_the_card_for_cuda(
        zips, monkeypatch):
    tr, _ = pnyu.get_training_testing_data(3, zips[("port", "nyu")])
    host = list(tr)
    on_cpu = pnyu.DataLoader(tr.dataset, 3, shuffle=True, device="cpu")
    got = list(on_cpu)
    assert len(got) == len(host) == 2
    for a, b in zip(host, got):
        assert isinstance(b["image"], torch.Tensor)
        assert b["image"].device.type == "cpu"
        _assert_batches_equal(a, {k: v.numpy() for k, v in b.items()})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pnyu.DataLoader(tr.dataset, 3, device="cuda")


def test_kitti_depth_reads_in_meters_and_16_bit_values_stay_raw(tmp_path):
    """A uint16 PNG value v reads back as v / 256 meters in a float batch
    and as v in a raw one (the /256 runs in the train step); 0 stays 0."""
    from PIL import Image

    raw = np.full((8, 16), 5120, np.uint16)  # 20.0 m
    raw[0, 0] = 0
    raw[2, 3] = 65535
    ibuf = io.BytesIO()
    Image.fromarray(np.zeros((8, 16, 3), np.uint8), "RGB").save(ibuf, "JPEG")
    zp = tmp_path / "one.zip"
    with zipfile.ZipFile(zp, "w") as zf:
        zf.writestr("data/kitti_train/a.jpg", ibuf.getvalue())
        zf.writestr("data/kitti_train/a.png", _png(raw, None))
        for split in ("train", "test"):
            zf.writestr(f"data/kitti_{split}.csv",
                        "data/kitti_train/a.jpg,data/kitti_train/a.png\n")
    fl, _ = pnyu.get_training_testing_data(1, str(zp), dataset="kitti",
                                           raw=False)
    dep = next(iter(fl))["depth"]
    assert dep.dtype == np.float32
    assert dep[0, 1, 1, 0] == pytest.approx(20.0) and dep[0, 0, 0, 0] == 0.0
    rl, _ = pnyu.get_training_testing_data(1, str(zp), dataset="kitti")
    b = next(iter(rl))
    assert b["depth"].dtype == np.uint16
    assert (b["depth"][0, 1, 1, 0], b["depth"][0, 2, 3, 0]) == (5120, 65535)
    assert rl.dataset.depth_post_scale == 1.0 / 256.0


def test_get_testing_data_matches_jax(zips):
    jl = jnyu.get_testing_data(3, zips[("jax", "nyu")])
    pl = pnyu.get_testing_data(3, zips[("port", "nyu")])
    assert len(pl) == len(jl) == 2
    for a, b in zip(jl, pl):
        _assert_batches_equal(a, b)


def test_viz_matches_jax(rng):
    depth = rng.random((3, 10, 12, 1)).astype(np.float32)
    grid = pviz.make_grid(depth)
    np.testing.assert_array_equal(grid, jviz.make_grid(depth))
    np.testing.assert_array_equal(pviz.make_grid(depth, nrow=2, normalize=True),
                                  jviz.make_grid(depth, nrow=2, normalize=True))
    np.testing.assert_array_equal(pviz.colorize(grid), jviz.colorize(grid))
    np.testing.assert_array_equal(pviz.colorize(grid, vmin=None, vmax=None),
                                  jviz.colorize(grid, vmin=None, vmax=None))
    np.testing.assert_array_equal(np.asarray(pviz.colorize_cpu(depth[0, ..., 0])),
                                  np.asarray(jviz.colorize_cpu(depth[0, ..., 0])))
    imgs = [rng.integers(0, 255, (h, 7, 3), dtype=np.uint8) for h in (8, 6)]
    np.testing.assert_array_equal(pviz.hconcat_resize(imgs),
                                  jviz.hconcat_resize(imgs))
