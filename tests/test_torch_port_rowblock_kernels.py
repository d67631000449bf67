"""The plain versions of the port's window-row block kernels against the JAX
package's Pallas kernels in interpret mode, on the CPU, and the build's
hashing of shared headers.

- ``crf_rowblock_infer_reference`` (``csrc/rowblock_infer.cu``) against
  ``tpudepth/ops/pallas/rowblock_infer.py::crf_rowblock_infer``, unshifted
  and shifted by 3 (inputs rolled, the shift mask, the rolled valid image);
- ``sam_rowblock_infer_reference`` (the same source) against
  ``::sam_rowblock_infer``;
- the wrappers on CPU tensors: they run the plain versions, count no
  launch, and refuse shapes and dtypes the kernels do not take.

Geometries: 2x10x13 padded to 14x14 with C 32 and 4 heads (the pad lies in
both H and W, and after the roll inside the map), and 1x9x16 padded to 14x21
with C 64 and 2 heads. The JAX kernels evaluate erf by a polynomial within
2.1e-7 of the exact erf that the port uses, and both sum in other orders:
f32, atol 1e-5 and rtol 1e-4 (as the other kernel tests).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tpudepth.ops.pallas.rowblock_infer import (
    crf_rowblock_infer as jax_crf_rowblock_infer,
    sam_rowblock_infer as jax_sam_rowblock_infer,
)
from tpudepth.ops.window import shifted_window_attention_mask as jax_shift_mask
from tpudepth_torch.ops.kernels import _build
from tpudepth_torch.ops.kernels import rowblock_infer as rbi

ATOL, RTOL = 1e-5, 1e-4
WS = 7

# (B, h, w, C, heads): the real map and the block's width
GEOMETRIES = [(2, 10, 13, 32, 4), (1, 9, 16, 64, 2)]


def _pad(h):
    return -(-h // WS) * WS


def _case(seed, b, h, w, c, heads, shift, sam=False):
    """Numpy inputs: raw x, v zero-padded (and rolled by -shift), the LN
    pairs, weights [in, out] and vectors, the bias and the mask."""
    rng = np.random.default_rng(seed)
    hp, wp = _pad(h), _pad(w)
    hidden = 4 * c

    def n(*shape, s=1.0, mean=0.0):
        return (mean + s * rng.standard_normal(shape)).astype(np.float32)

    x, v = (np.zeros((b, hp, wp, c), np.float32) for _ in range(2))
    x[:, :h, :w] = n(b, h, w, c)
    v[:, :h, :w] = n(b, h, w, c)
    if shift:
        x, v = (np.roll(t, (-shift, -shift), axis=(1, 2)) for t in (x, v))
    ln = lambda: (n(c, s=0.2, mean=1.0), n(c, s=0.1))  # noqa: E731
    a = dict(x=x, v=v, ln1=ln())
    if sam:
        a.update(lnv=ln(), wq=n(c, c, s=c ** -0.5), bq=n(c, s=0.1),
                 wkv=n(c, 2 * c, s=c ** -0.5), bkv=n(2 * c, s=0.1))
    else:
        a.update(wqk=n(c, 2 * c, s=c ** -0.5), bqk=n(2 * c, s=0.1))
    a.update(bias=n(heads, WS * WS, WS * WS, s=0.5), wproj=n(c, c, s=c ** -0.5),
             bproj=n(c, s=0.1), ln2=ln(), w1=n(c, hidden, s=c ** -0.5),
             b1=n(hidden, s=0.1), w2=n(hidden, c, s=hidden ** -0.5),
             b2=n(c, s=0.1))
    if not sam:
        a["mask"] = jax_shift_mask(h, w, WS, shift) if shift else None
    return a


def _as(fn, a):
    """The arguments of ``a`` converted by ``fn`` (pairs element-wise)."""
    out = {}
    for k, val in a.items():
        if val is None:
            out[k] = None
        elif isinstance(val, tuple):
            out[k] = tuple(fn(t) for t in val)
        else:
            out[k] = fn(val)
    return out


def _torch(a):
    return _as(lambda t: torch.from_numpy(np.ascontiguousarray(t)), a)


@pytest.mark.parametrize("shift", [0, 3], ids=["shift0", "shift3"])
@pytest.mark.parametrize("geom", GEOMETRIES, ids=["c32", "c64"])
def test_crf_rowblock_plain_matches_the_jax_kernel(geom, shift):
    b, h, w, c, heads = geom
    a = _case(c + shift, b, h, w, c, heads, shift)
    scale = (c // heads) ** -0.5
    want = jax_crf_rowblock_infer(**_as(jnp.asarray, a), scale=scale,
                                  window_size=WS, valid_hw=(h, w, shift),
                                  interpret=True)
    got = rbi.crf_rowblock_infer_reference(**_torch(a), scale=scale,
                                           window_size=WS,
                                           valid_hw=(h, w, shift))
    assert got.shape == a["x"].shape and got.dtype == torch.float32
    want = np.asarray(want)
    # compare the real pixels: the pad positions are garbage on both sides
    real = rbi._valid_image(h, w, _pad(h), _pad(w), shift).astype(bool)
    assert np.std(want[:, real]) > 0.1
    np.testing.assert_allclose(got.numpy()[:, real], want[:, real], atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("geom", GEOMETRIES, ids=["c32", "c64"])
def test_sam_rowblock_plain_matches_the_jax_kernel(geom):
    b, h, w, c, heads = geom
    a = _case(c + 7, b, h, w, c, heads, 0, sam=True)
    scale = (c // heads) ** -0.5
    want = np.asarray(jax_sam_rowblock_infer(
        **_as(jnp.asarray, a), scale=scale, window_size=WS, valid_hw=(h, w),
        interpret=True))
    got = rbi.sam_rowblock_infer_reference(**_torch(a), scale=scale,
                                           window_size=WS, valid_hw=(h, w))
    assert got.shape == a["x"].shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy()[:, :h, :w], want[:, :h, :w],
                               atol=ATOL, rtol=RTOL)


def test_pad_tokens_are_bias_only_keys():
    """The real pixels' output does not depend on what the pad holds in x
    (it is zeroed after LN1); the pad positions of the output do."""
    b, h, w, c, heads = GEOMETRIES[0]
    a = _torch(_case(3, b, h, w, c, heads, 3))
    kw = dict(scale=(c // heads) ** -0.5, valid_hw=(h, w, 3))
    base = rbi.crf_rowblock_infer(**a, **kw)
    real = torch.from_numpy(rbi._valid_image(h, w, _pad(h), _pad(w), 3)) > 0
    noisy = a["x"] + 5.0 * (~real)[None, :, :, None]
    got = rbi.crf_rowblock_infer(**dict(a, x=noisy), **kw)
    torch.testing.assert_close(got[:, real], base[:, real], atol=0, rtol=0)
    assert not torch.equal(got[:, ~real], base[:, ~real])


def test_wrappers_run_the_plain_versions_on_cpu_tensors():
    b, h, w, c, heads = GEOMETRIES[1]
    kw = dict(scale=(c // heads) ** -0.5, window_size=WS)
    crf = _torch(_case(1, b, h, w, c, heads, 3))
    sam = _torch(_case(2, b, h, w, c, heads, 0, sam=True))
    before = (rbi.crf_rowblock_infer.launches, rbi.sam_rowblock_infer.launches)
    for wrapper, ref, a, valid in (
            (rbi.crf_rowblock_infer, rbi.crf_rowblock_infer_reference, crf,
             (h, w, 3)),
            (rbi.sam_rowblock_infer, rbi.sam_rowblock_infer_reference, sam,
             (h, w))):
        torch.testing.assert_close(wrapper(**a, **kw, valid_hw=valid),
                                   ref(**a, **kw, valid_hw=valid), atol=0,
                                   rtol=0)
    bf = _as(lambda t: t.to(torch.bfloat16), {"x": crf["x"], "v": crf["v"]})
    got = rbi.crf_rowblock_infer(**dict(crf, **bf), **kw, valid_hw=(h, w, 3))
    assert got.dtype == torch.bfloat16 and got.shape == crf["x"].shape
    assert (rbi.crf_rowblock_infer.launches,
            rbi.sam_rowblock_infer.launches) == before


def test_wrappers_refuse_shapes_and_dtypes_they_do_not_take():
    b, h, w, c, heads = GEOMETRIES[0]
    kw = dict(scale=0.25, window_size=WS)
    a = _torch(_case(4, b, h, w, c, heads, 3))
    with pytest.raises(ValueError, match="multiples of the window"):
        rbi.crf_rowblock_infer(**dict(a, x=a["x"][:, :13], v=a["v"][:, :13]),
                               **kw)
    with pytest.raises(ValueError, match="one shape"):
        rbi.crf_rowblock_infer(**dict(a, v=a["v"][:1]), **kw)
    with pytest.raises(ValueError, match="mask"):
        rbi.crf_rowblock_infer(**dict(a, mask=a["mask"][:3]), **kw)
    with pytest.raises(ValueError, match="bias"):
        rbi.crf_rowblock_infer(**dict(a, bias=a["bias"][:, :48]), **kw)
    with pytest.raises(ValueError, match="weight shapes"):
        rbi.crf_rowblock_infer(**dict(a, wqk=a["wqk"][:, :c]), **kw)
    with pytest.raises(TypeError, match="one dtype"):
        rbi.crf_rowblock_infer(**dict(a, v=a["v"].bfloat16()), **kw)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rbi.crf_rowblock_infer(**dict(a, x=a["x"].half(), v=a["v"].half()),
                               **kw)
    with pytest.raises(TypeError, match="must be float32"):
        rbi.crf_rowblock_infer(**dict(a, w1=a["w1"].bfloat16()), **kw)
    s = _torch(_case(5, b, h, w, c, heads, 0, sam=True))
    with pytest.raises(ValueError, match="weight shapes"):
        rbi.sam_rowblock_infer(**dict(s, bkv=s["bkv"][:c]), **kw)


def test_build_target_hashes_the_headers_a_source_includes(tmp_path,
                                                            monkeypatch):
    """A library's name changes with every header its source includes with
    quotes, followed recursively, and with nothing else."""
    (tmp_path / "a.cu").write_text('#include "h.cuh"\nint a;\n')
    (tmp_path / "h.cuh").write_text('#pragma once\n  #include "g.cuh"\n')
    (tmp_path / "g.cuh").write_text("int g;\n")
    (tmp_path / "other.cuh").write_text("int o;\n")
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    assert [p.name for p in _build.inputs("a")] == ["a.cu", "h.cuh", "g.cuh"]
    first = _build._target("a")
    (tmp_path / "other.cuh").write_text("int o2;\n")
    assert _build._target("a") == first
    (tmp_path / "g.cuh").write_text("int g2;\n")
    second = _build._target("a")
    assert second != first and second.name.startswith("liba-")


def test_every_source_of_the_package_finds_its_headers():
    names = _build.sources()
    assert "rowblock_infer" in names
    for name in names:
        for path in _build.inputs(name):
            assert path.is_file(), path
    assert [p.name for p in _build.inputs("rowblock_infer")] == [
        "rowblock_infer.cu", "block_tail.cuh", "ln_proj.cuh",
        "tail_chain.cuh", "window_attn.cuh", "gemm_sm90.cuh"]
    # the kernels on the wgmma GEMM core rebuild when the core changes
    assert [p.name for p in _build.inputs("mlp_train")] == [
        "mlp_train.cu", "block_tail.cuh", "gemm_sm90.cuh"]
    assert [p.name for p in _build.inputs("epilogue_infer")] == [
        "epilogue_infer.cu", "block_tail.cuh", "gemm_sm90.cuh",
        "tail_chain.cuh"]
    # both directions of the GUB conv rebuild when their shared pieces change
    for name in ("gub_conv_fwd", "gub_conv_bwd"):
        assert [p.name for p in _build.inputs(name)] == [
            f"{name}.cu", "gub_conv_tc.cuh"]
