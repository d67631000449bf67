"""The plain versions of the port's whole-block kernels against the JAX
package's Pallas kernels in interpret mode, on the CPU.

- ``crf_block_infer_reference`` (``csrc/block_infer.cu``) against
  ``tpudepth/ops/pallas/block_infer.py::crf_block_infer``, unshifted and
  shifted by 3 (windows of the rolled map, the shift mask, the rolled valid
  table);
- ``sam_block_infer_reference`` (the same source) against
  ``::sam_block_infer``;
- one bf16 case each against the Pallas kernel in bf16, which holds the
  rounding order;
- the wrappers on CPU tensors: they run the plain versions, count no
  launch, and refuse shapes and dtypes the kernels do not take.

Geometries: 2x10x13 padded to 14x14 with C 32 and 4 heads (the pad lies in
both H and W, and after the roll inside the map), 1x9x16 padded to 14x21
with C 64 and 2 heads, and 1x14x14 with C 32 and 4 heads, which has no pad
(``valid`` None). The JAX kernels evaluate erf by a polynomial within
2.1e-7 of the exact erf that the port uses, and both sum in other orders:
f32, atol 1e-5 and rtol 1e-4 (as the other kernel tests).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tpudepth.ops.pallas.block_infer import (
    crf_block_infer as jax_crf_block_infer,
    sam_block_infer as jax_sam_block_infer,
)
from tpudepth.ops.window import shifted_window_attention_mask as jax_shift_mask
from tpudepth.ops.window import window_valid_mask as jax_valid_mask
from torch_port_helpers import torch_one_thread  # noqa: F401
from tpudepth_torch.ops.kernels import _build
from tpudepth_torch.ops.kernels import block_infer as bi
from tpudepth_torch.ops.kernels.epilogue_infer import (
    block_epilogue_infer_reference,
)

ATOL, RTOL = 1e-5, 1e-4
WS = 7
N = WS * WS

# (B, h, w, C, heads): the real map and the block's width
GEOMETRIES = [(2, 10, 13, 32, 4), (1, 9, 16, 64, 2), (1, 14, 14, 32, 4)]
GEOMETRY_IDS = ["c32", "c64", "nopad"]


def _pad(h):
    return -(-h // WS) * WS


def _windows(t):
    """[B, Hp, Wp, C] -> [B nW, N, C], windows row-major."""
    b, hp, wp, c = t.shape
    t = t.reshape(b, hp // WS, WS, wp // WS, WS, c).transpose(0, 1, 3, 2, 4, 5)
    return np.ascontiguousarray(t.reshape(-1, N, c))


def _case(seed, b, h, w, c, heads, shift, sam=False):
    """Numpy inputs: the raw windows of x, v zero-padded (and rolled by
    -shift), the LN pairs, weights [in, out] and vectors, the bias, the
    mask and the valid table."""
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
    a = dict(xw=_windows(x), vw=_windows(v), ln1=ln())
    if sam:
        a.update(lnv=ln(), wq=n(c, c, s=c ** -0.5), bq=n(c, s=0.1),
                 wkv=n(c, 2 * c, s=c ** -0.5), bkv=n(2 * c, s=0.1))
    else:
        a.update(wqk=n(c, 2 * c, s=c ** -0.5), bqk=n(2 * c, s=0.1))
    a.update(bias=n(heads, N, N, s=0.5), wproj=n(c, c, s=c ** -0.5),
             bproj=n(c, s=0.1), ln2=ln(), w1=n(c, hidden, s=c ** -0.5),
             b1=n(hidden, s=0.1), w2=n(hidden, c, s=hidden ** -0.5),
             b2=n(c, s=0.1))
    if not sam:
        a["mask"] = jax_shift_mask(h, w, WS, shift) if shift else None
    a["valid"] = jax_valid_mask(h, w, WS, shift)
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


def _real(a):
    """[BW, N] bool of the real tokens: the pad tokens' outputs are garbage
    on both sides."""
    bw = a["xw"].shape[0]
    if a["valid"] is None:
        return np.ones((bw, N), bool)
    return np.tile(a["valid"], (bw // a["valid"].shape[0], 1)) > 0


def _jax(a, sam, scale, dtype=jnp.float32):
    ja = _as(jnp.asarray, a)
    ja["xw"], ja["vw"] = (ja[k].astype(dtype) for k in ("xw", "vw"))
    fn = jax_sam_block_infer if sam else jax_crf_block_infer
    out = fn(**ja, scale=scale, interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("shift", [0, 3], ids=["shift0", "shift3"])
@pytest.mark.parametrize("geom", GEOMETRIES, ids=GEOMETRY_IDS)
def test_crf_block_plain_matches_the_jax_kernel(geom, shift):
    b, h, w, c, heads = geom
    a = _case(c + shift, b, h, w, c, heads, shift)
    scale = (c // heads) ** -0.5
    want = _jax(a, False, scale)
    got = bi.crf_block_infer_reference(**_torch(a), scale=scale)
    assert got.shape == a["xw"].shape and got.dtype == torch.float32
    real = _real(a)
    assert np.std(want[real]) > 0.1
    np.testing.assert_allclose(got.numpy()[real], want[real], atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("geom", GEOMETRIES, ids=GEOMETRY_IDS)
def test_sam_block_plain_matches_the_jax_kernel(geom):
    b, h, w, c, heads = geom
    a = _case(c + 7, b, h, w, c, heads, 0, sam=True)
    scale = (c // heads) ** -0.5
    want = _jax(a, True, scale)
    got = bi.sam_block_infer_reference(**_torch(a), scale=scale)
    assert got.shape == a["xw"].shape and got.dtype == torch.float32
    real = _real(a)
    np.testing.assert_allclose(got.numpy()[real], want[real], atol=ATOL,
                               rtol=RTOL)


def _rounded_y_tail(xw, o, wproj, bproj, ln2, w1, b1, w2, b2):
    """The row kernels' tail order (z, y and m rounded), for contrast."""
    bw, n, c = xw.shape
    return block_epilogue_infer_reference(
        o.reshape(-1, c), xw.reshape(-1, c), wproj, bproj, *ln2, w1, b1, w2,
        b2).reshape(bw, n, c)


@pytest.mark.parametrize("sam", [False, True], ids=["crf", "sam"])
def test_bf16_plain_versions_keep_the_kernels_rounding_order(sam,
                                                             monkeypatch):
    """bf16 against the Pallas kernel in bf16 interpret mode, on the real
    tokens. The bound is ``tolerance(bfloat16)``, (2^-6, 2^-6) of the
    largest output and of each: the two sum in other orders and the port's
    erf is exact, so a value near a bf16 boundary may round the other way.
    That bound does NOT tell y in f32 from y rounded: the row kernels'
    order (z, y, m rounded) stays within a third of it. The share of
    outputs that differ does: on these inputs the kernel's order differs
    from the Pallas kernel in under 4 % of them, each by a bf16 ulp or
    two, the rounded-y order in over half; the test requires under 10 %
    and shows the contrast."""
    b, h, w, c, heads = (2, 10, 13, 32, 4) if sam else (1, 9, 16, 64, 2)
    shift = 0 if sam else 3
    a = _case(c + shift + 100, b, h, w, c, heads, shift, sam=sam)
    scale = (c // heads) ** -0.5
    want = _jax(a, sam, scale, jnp.bfloat16)
    t = _torch(a)
    t["xw"], t["vw"] = t["xw"].bfloat16(), t["vw"].bfloat16()
    ref = bi.sam_block_infer_reference if sam else bi.crf_block_infer_reference
    got = ref(**t, scale=scale)
    assert got.dtype == torch.bfloat16
    real = _real(a)
    got, want = got.float().numpy()[real], want[real]
    frac, rtol = bi.tolerance(torch.bfloat16)
    top = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=frac * top, rtol=rtol)
    assert np.mean(got != want) < 0.1
    monkeypatch.setattr(bi, "_tail", _rounded_y_tail)
    other = ref(**t, scale=scale).float().numpy()[real]
    assert np.mean(other != want) > 0.3


def test_pad_tokens_are_bias_only_keys():
    """The real tokens' output does not depend on what the pad holds in x
    (it is zeroed after LN1); the pad tokens' outputs do."""
    b, h, w, c, heads = GEOMETRIES[0]
    a = _case(3, b, h, w, c, heads, 3)
    real = torch.from_numpy(_real(a))
    t = _torch(a)
    kw = dict(scale=(c // heads) ** -0.5)
    base = bi.crf_block_infer(**t, **kw)
    noisy = t["xw"] + 5.0 * (~real)[:, :, None]
    got = bi.crf_block_infer(**dict(t, xw=noisy), **kw)
    torch.testing.assert_close(got[real], base[real], atol=0, rtol=0)
    assert not torch.equal(got[~real], base[~real])


def test_wrappers_run_the_plain_versions_on_cpu_tensors():
    b, h, w, c, heads = GEOMETRIES[1]
    kw = dict(scale=(c // heads) ** -0.5)
    crf = _torch(_case(1, b, h, w, c, heads, 3))
    sam = _torch(_case(2, b, h, w, c, heads, 0, sam=True))
    before = (bi.crf_block_infer.launches, bi.sam_block_infer.launches)
    for wrapper, ref, a in (
            (bi.crf_block_infer, bi.crf_block_infer_reference, crf),
            (bi.sam_block_infer, bi.sam_block_infer_reference, sam)):
        torch.testing.assert_close(wrapper(**a, **kw), ref(**a, **kw),
                                   atol=0, rtol=0)
    bf = {k: crf[k].bfloat16() for k in ("xw", "vw")}
    got = bi.crf_block_infer(**dict(crf, **bf), **kw)
    assert got.dtype == torch.bfloat16 and got.shape == crf["xw"].shape
    assert (bi.crf_block_infer.launches,
            bi.sam_block_infer.launches) == before


def test_wrappers_refuse_shapes_and_dtypes_they_do_not_take():
    b, h, w, c, heads = GEOMETRIES[0]
    kw = dict(scale=0.25)
    a = _torch(_case(4, b, h, w, c, heads, 3))
    with pytest.raises(ValueError, match="multiple of the"):
        bi.crf_block_infer(**dict(a, xw=a["xw"][:7], vw=a["vw"][:7]), **kw)
    with pytest.raises(ValueError, match="one shape"):
        bi.crf_block_infer(**dict(a, vw=a["vw"][:4]), **kw)
    with pytest.raises(ValueError, match="mask"):
        bi.crf_block_infer(**dict(a, mask=a["mask"][:, :48]), **kw)
    with pytest.raises(ValueError, match="valid"):
        bi.crf_block_infer(**dict(a, valid=a["valid"][:3]), **kw)
    with pytest.raises(ValueError, match="bias"):
        bi.crf_block_infer(**dict(a, bias=a["bias"][:, :48]), **kw)
    with pytest.raises(ValueError, match="weight shapes"):
        bi.crf_block_infer(**dict(a, wqk=a["wqk"][:, :c]), **kw)
    with pytest.raises(TypeError, match="one dtype"):
        bi.crf_block_infer(**dict(a, vw=a["vw"].bfloat16()), **kw)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        bi.crf_block_infer(**dict(a, xw=a["xw"].half(), vw=a["vw"].half()),
                           **kw)
    with pytest.raises(TypeError, match="must be float32"):
        bi.crf_block_infer(**dict(a, w1=a["w1"].bfloat16()), **kw)
    with pytest.raises(TypeError, match="must be float32"):
        bi.crf_block_infer(**dict(a, valid=a["valid"].double()), **kw)
    s = _torch(_case(5, b, h, w, c, heads, 0, sam=True))
    with pytest.raises(ValueError, match="weight shapes"):
        bi.sam_block_infer(**dict(s, bkv=s["bkv"][:c]), **kw)
    with pytest.raises(ValueError, match="multiple of the"):
        bi.sam_block_infer(**dict(s, xw=s["xw"][:3], vw=s["vw"][:3]), **kw)


def test_the_block_source_is_built_from_its_shared_headers():
    """The library's name hashes every header of the device code it
    shares with the row kernels, the tail chain, the wgmma core and the
    mma.sync pieces of the attention among them."""
    assert "block_infer" in _build.sources()
    assert [p.name for p in _build.inputs("block_infer")] == [
        "block_infer.cu", "block_tail.cuh", "ln_proj.cuh", "tail_chain.cuh",
        "window_attn.cuh", "gemm_sm90.cuh", "gub_conv_tc.cuh"]
