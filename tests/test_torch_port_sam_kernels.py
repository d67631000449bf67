"""The plain versions of the port's SAM serving kernels against the JAX
package's Pallas kernels in interpret mode, on the CPU.

- ``window_attention_infer_reference`` (``csrc/window_attn_infer.cu``)
  against ``tpudepth/ops/pallas/window_attn_infer.py::window_attention_infer``,
  with and without the shift mask, and the CPU dispatch of the wrapper;
- ``block_epilogue_infer_reference`` (``csrc/epilogue_infer.cu``) against
  ``tpudepth/ops/pallas/epilogue_infer.py::block_epilogue_infer``;
- ``mlp_infer_reference`` (the same source) against
  ``tpudepth/ops/pallas/mlp_infer.py::mlp_infer``.

The JAX kernels evaluate erf by a polynomial within 2.1e-7 of the exact
erf that the port uses, and both sum in other orders: f32, atol 1e-5 and
rtol 1e-4. The JAX epilogue and FFN kernels cover rows in tiles of 8 and
leave a remainder unwritten, so a row count that is not a multiple of 8 is
held against the JAX package's own explicit composition of the block tail
(``tests/test_window_attention.py``'s, in f32 at HIGHEST precision).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tpudepth.ops.pallas.epilogue_infer import (
    block_epilogue_infer as jax_block_epilogue_infer,
)
from tpudepth.ops.pallas.mlp_infer import mlp_infer as jax_mlp_infer
from tpudepth.ops.pallas.window_attn_infer import (
    window_attention_infer as jax_window_attention_infer,
)
from tpudepth.ops.window import shifted_window_attention_mask as jax_shift_mask
from tpudepth_torch.ops.kernels import epilogue_infer as ei
from tpudepth_torch.ops.kernels import mlp_infer as mi
from tpudepth_torch.ops.kernels import window_attn_infer as wai

ATOL, RTOL = 1e-5, 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _attn_inputs(seed, bw, n, c, heads, nw, mask_kind):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((bw, n, c)).astype(np.float32)
               for _ in range(3))
    q *= (c // heads) ** -0.5
    bias = (0.5 * rng.standard_normal((heads, n, n))).astype(np.float32)
    mask = None
    if mask_kind == "random":
        mask = ((rng.random((nw, n, n)) > 0.5) * -100.0).astype(np.float32)
    elif mask_kind == "shift":
        mask = jax_shift_mask(14, 21, 7, 3)   # 6 windows of 49 tokens
    return q, k, v, bias, mask


@pytest.mark.parametrize("mask_kind", ["none", "random", "shift"])
@pytest.mark.parametrize("heads,c,bw,nw", [(2, 64, 12, 6), (4, 128, 6, 6),
                                           (2, 128, 18, 6), (4, 64, 12, 6)])
def test_window_attention_plain_matches_the_jax_kernel(heads, c, bw, nw,
                                                       mask_kind):
    q, k, v, bias, mask = _attn_inputs(heads * c + bw, bw, 49, c, heads, nw,
                                       mask_kind)
    want = jax_window_attention_infer(
        *(jnp.asarray(a) for a in (q, k, v, bias)),
        None if mask is None else jnp.asarray(mask), interpret=True)
    got = wai.window_attention_infer(
        *(_t(a) for a in (q, k, v, bias)), None if mask is None else _t(mask))
    assert got.shape == (bw, 49, c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_window_attention_wrapper_takes_views_of_one_kv_projection():
    """k and v as the halves of one [BW, N, 2C] tensor, as the SAM block
    hands them over (the kernel reads them through their row stride)."""
    q, k, v, bias, _ = _attn_inputs(5, 6, 49, 64, 2, 6, "none")
    kv = torch.cat([_t(k), _t(v)], dim=-1)
    kh, vh = kv.chunk(2, dim=-1)
    got = wai.window_attention_infer(_t(q), kh, vh, _t(bias))
    want = wai.window_attention_infer_reference(_t(q), _t(k), _t(v), _t(bias))
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_window_attention_plain_rounds_the_probabilities_in_bf16():
    """In bf16 the plain version rounds p to bf16 before p v, as the kernels
    do; a version that keeps p in f32 differs."""
    q, k, v, bias, _ = _attn_inputs(6, 6, 49, 64, 2, 6, "none")
    qb, kb, vb = (_t(a).bfloat16() for a in (q, k, v))
    got = wai.window_attention_infer_reference(qb, kb, vb, _t(bias))
    from tpudepth_torch.ops.attention import (
        from_heads,
        to_heads,
        window_cross_attention_xla,
    )

    f32p = from_heads(window_cross_attention_xla(
        to_heads(qb, 2), to_heads(kb, 2), to_heads(vb, 2), _t(bias)))
    assert got.dtype == torch.bfloat16
    assert not torch.equal(got, f32p)
    torch.testing.assert_close(got.float(), f32p.float(), atol=2e-2, rtol=2e-2)


def _epilogue_inputs(seed, m, c, hidden):
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0, mean=0.0):
        return (mean + s * rng.standard_normal(shape)).astype(np.float32)

    return dict(o=n(m, c), x=n(m, c), wproj=n(c, c, s=c ** -0.5),
                bproj=n(c, s=0.1), lns=n(c, s=0.2, mean=1.0), lnb=n(c, s=0.1),
                w1=n(c, hidden, s=c ** -0.5), b1=n(hidden, s=0.1),
                w2=n(hidden, c, s=hidden ** -0.5), b2=n(c, s=0.1))


def _jax_explicit_tail(a):
    hi = jax.lax.Precision.HIGHEST
    j = {k: jnp.asarray(v) for k, v in a.items()}
    y = j["x"] + jnp.dot(j["o"], j["wproj"], precision=hi) + j["bproj"]
    mu = jnp.mean(y, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(y - mu), axis=-1, keepdims=True)
    yn = (y - mu) * jax.lax.rsqrt(var + 1e-5) * j["lns"] + j["lnb"]
    h = jnp.dot(yn, j["w1"], precision=hi) + j["b1"]
    g = jax.nn.gelu(h, approximate=False)
    return y + jnp.dot(g, j["w2"], precision=hi) + j["b2"]


@pytest.mark.parametrize("m,c", [(64, 32), (96, 64), (37, 32), (61, 64)])
def test_block_epilogue_plain_matches_jax(m, c):
    a = _epilogue_inputs(m + c, m, c, 4 * c)
    if m % 8 == 0:
        want = jax_block_epilogue_infer(
            *(jnp.asarray(a[k]) for k in ("o", "x", "wproj", "bproj", "lns",
                                          "lnb", "w1", "b1", "w2", "b2")),
            interpret=True)
    else:
        want = _jax_explicit_tail(a)
    got = ei.block_epilogue_infer(**{k: _t(v) for k, v in a.items()})
    assert got.shape == (m, c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("m,c,c2", [(64, 64, 64), (40, 32, 96), (29, 64, 64)])
def test_mlp_plain_matches_jax(m, c, c2):
    rng = np.random.default_rng(m * c2)
    hidden = 4 * c
    x = rng.standard_normal((m, c)).astype(np.float32)
    w1 = (rng.standard_normal((c, hidden)) * c ** -0.5).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(hidden)).astype(np.float32)
    w2 = (rng.standard_normal((hidden, c2)) * hidden ** -0.5).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(c2)).astype(np.float32)
    if m % 8 == 0:
        want = jax_mlp_infer(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)),
                             interpret=True)
    else:
        hi = jax.lax.Precision.HIGHEST
        h = jax.nn.gelu(jnp.dot(x, w1, precision=hi) + b1, approximate=False)
        want = jnp.dot(h, w2, precision=hi) + b2
    got = mi.mlp_infer(*(_t(a) for a in (x, w1, b1, w2, b2)))
    assert got.shape == (m, c2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_epilogue_plain_rounds_each_stage_in_bf16():
    """The bf16 plain version rounds z, y, LN(y), h, gelu(h) and m: against
    the f32 composition of the same bf16 inputs it is a few bf16 ulps off,
    not equal and not far."""
    a = {k: _t(v) for k, v in _epilogue_inputs(9, 48, 64, 256).items()}
    got = ei.block_epilogue_infer(**dict(a, o=a["o"].bfloat16(),
                                         x=a["x"].bfloat16()))
    f32 = ei.block_epilogue_infer(**dict(a, o=a["o"].bfloat16().float(),
                                         x=a["x"].bfloat16().float(),
                                         wproj=a["wproj"].bfloat16().float(),
                                         w1=a["w1"].bfloat16().float(),
                                         w2=a["w2"].bfloat16().float()))
    assert got.dtype == torch.bfloat16
    assert not torch.equal(got.float(), f32)
    torch.testing.assert_close(got.float(), f32, atol=0.1, rtol=2 ** -5)


@pytest.mark.parametrize("fn", ["attn", "epilogue", "mlp"])
def test_wrappers_refuse_a_device_without_a_kernel(fn):
    """The wrappers take the plain version only for CPU tensors; on the meta
    device (no kernel, no plain fallback) they raise."""
    meta = torch.device("meta")
    if fn == "attn":
        q = torch.empty(6, 49, 64, device=meta)
        call = lambda: wai.window_attention_infer(
            q, q, q, torch.empty(2, 49, 49, device=meta))
    elif fn == "epilogue":
        o = torch.empty(8, 32, device=meta)
        w = torch.empty(32, 32, device=meta)
        v = torch.empty(32, device=meta)
        call = lambda: ei.block_epilogue_infer(
            o, o, w, v, v, v, torch.empty(32, 128, device=meta),
            torch.empty(128, device=meta), torch.empty(128, 32, device=meta), v)
    else:
        x = torch.empty(8, 32, device=meta)
        call = lambda: mi.mlp_infer(
            x, torch.empty(32, 128, device=meta), torch.empty(128, device=meta),
            torch.empty(128, 32, device=meta), torch.empty(32, device=meta))
    with pytest.raises(ValueError, match="no .* kernel for meta"):
        call()


def test_wrappers_check_shapes_first():
    q = torch.zeros(6, 49, 64)
    with pytest.raises(ValueError, match="bias"):
        wai.window_attention_infer(q, q, q, torch.zeros(2, 49, 48))
    with pytest.raises(ValueError, match="mask"):
        wai.window_attention_infer(q, q, q, torch.zeros(2, 49, 49),
                                   torch.zeros(4, 49, 49))
    x = torch.zeros(8, 32)
    with pytest.raises(ValueError, match="shapes"):
        mi.mlp_infer(x, torch.zeros(32, 128), torch.zeros(128),
                     torch.zeros(64, 32), torch.zeros(32))
