"""The plain versions of the port's training window attention
(``ops/kernels/window_attn.py``; kernels ``window_attn_train_fwd`` /
``window_attn_train_bwd`` in ``csrc/window_attn_train.cu``) against the JAX
package, on the CPU.

- forward and backward against the Pallas kernels in interpret mode
  (``window_attention_pallas``, ``window_attention_bwd_pallas``), with and
  without the shift mask, in f32 at JAX's own tolerances
  (``tests/test_window_attention.py``: rtol 1e-4, atol 1e-5; dbias atol
  1e-4), and in bf16 at the kernels' tolerance
  (``window_attn.fwd_tolerance`` / ``bwd_tolerance``: the same rounding
  order on both sides, a value within rounding of a bf16 boundary may round
  the other way);
- the other cases (odd window counts, more heads, the real NewCRF shift
  mask, pad tokens) against ``jax.vjp`` of the JAX package's jnp
  composition ``window_cross_attention_xla``;
- ``torch.autograd.gradcheck`` of the ``autograd.Function`` in float64.

The port's layout is channel-packed ``[BW, N, C]``; JAX's kernels take
``[BW, heads, N, D]``, so the tests transpose at the boundary.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tpudepth.ops.attention import window_cross_attention_xla
from tpudepth.ops.pallas.window_attn import (
    window_attention_bwd_pallas,
    window_attention_pallas,
)
from tpudepth.ops.window import shifted_window_attention_mask as jax_shift_mask
from tpudepth_torch.ops.attention import from_heads, to_heads
from torch_port_helpers import torch_one_thread  # noqa: F401 (autouse)
from tpudepth_torch.ops.kernels import window_attn as wa

ATOL, RTOL, DBIAS_ATOL = 1e-5, 1e-4, 1e-4


def _inputs(seed, bw, n, c, heads, mask_kind, nw=4):
    """Packed q (scaled), k, v, cotangent g [BW, N, C], bias, mask."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((bw, n, c)).astype(np.float32)
                  for _ in range(4))
    q *= (c // heads) ** -0.5
    bias = rng.standard_normal((heads, n, n)).astype(np.float32)
    mask = None
    if mask_kind == "random":
        mask = ((rng.random((nw, n, n)) > 0.5) * -100.0).astype(np.float32)
    elif mask_kind == "shift":
        mask = jax_shift_mask(14, 21, 7, 3)   # 6 windows of 49 tokens
    return q, k, v, g, bias, mask


def _heads(a, heads):
    return jnp.asarray(to_heads(torch.from_numpy(a), heads).numpy())


def _packed(a):
    return from_heads(torch.from_numpy(np.array(a, np.float32))).numpy()


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


@pytest.fixture(scope="module")
def pallas():
    """The Pallas kernels in interpret mode on 8 windows x 2 heads x 49
    tokens x 16 channels, f32 and bf16, with and without a random mask:
    ``{(dtype, mask_kind): (inputs, out, (dq, dk, dv, dbias))}``."""
    out = {}
    for dtype in (jnp.float32, jnp.bfloat16):
        for mask_kind in ("none", "random"):
            q, k, v, g, bias, mask = _inputs(1, 8, 49, 32, 2, mask_kind)
            hq, hk, hv, hg = (_heads(a, 2).astype(dtype) for a in (q, k, v, g))
            jm = None if mask is None else jnp.asarray(mask)
            o = window_attention_pallas(hq, hk, hv, jnp.asarray(bias), jm,
                                        interpret=True)
            grads = window_attention_bwd_pallas(hq, hk, hv, jnp.asarray(bias),
                                                jm, hg, interpret=True)
            out[(dtype, mask_kind)] = ((q, k, v, g, bias, mask), o, grads)
    return out


def _close(got, want, tol, what):
    frac, rtol = tol
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, atol=frac * scale, rtol=rtol,
                               err_msg=what)


@pytest.mark.parametrize("mask_kind", ["none", "random"])
def test_plain_forward_and_backward_match_the_pallas_kernels(pallas,
                                                             mask_kind):
    (q, k, v, g, bias, mask), o, (dq, dk, dv, dbias) = pallas[
        (jnp.float32, mask_kind)]
    args = (_t(q), _t(k), _t(v), _t(bias), _t(mask))
    got = wa.window_attention_fwd(*args)
    np.testing.assert_allclose(got.numpy(), _packed(o), atol=ATOL, rtol=RTOL)
    gq, gk, gv, gb = wa.window_attention_bwd(*args, _t(g))
    for name, a, b in (("dq", gq, dq), ("dk", gk, dk), ("dv", gv, dv)):
        np.testing.assert_allclose(a.numpy(), _packed(b), atol=ATOL,
                                   rtol=RTOL, err_msg=name)
    np.testing.assert_allclose(gb.numpy(), np.asarray(dbias),
                               atol=DBIAS_ATOL, rtol=RTOL)


@pytest.mark.parametrize("mask_kind", ["none", "random"])
def test_plain_bf16_matches_the_pallas_kernels_in_bf16(pallas, mask_kind):
    """bf16 in, products of bf16 values summed in f32, the probabilities and
    ds rounded to bf16 before their products, on both sides."""
    (q, k, v, g, bias, mask), o, (dq, dk, dv, dbias) = pallas[
        (jnp.bfloat16, mask_kind)]
    bf = torch.bfloat16
    args = (_t(q, bf), _t(k, bf), _t(v, bf), _t(bias), _t(mask))
    got = wa.window_attention_fwd(*args)
    assert got.dtype == bf
    _close(got, _packed(o), wa.fwd_tolerance(bf), "out")
    grads = wa.window_attention_bwd(*args, _t(g, bf))
    tol, dbias_tol = wa.bwd_tolerance(bf)
    for name, a, b in zip(("dq", "dk", "dv"), grads[:3], (dq, dk, dv)):
        assert a.dtype == bf
        _close(a, _packed(b), tol, name)
    assert grads[3].dtype == torch.float32
    _close(grads[3], dbias, dbias_tol, "dbias")


# (BW, N, C, heads, mask): odd window counts, more heads, the NewCRF shift
# mask on a 14x21 map (6 windows), a window of 9 tokens
CASES = [(5, 49, 32, 2, "none"), (12, 49, 64, 4, "shift"),
         (7, 9, 24, 3, "none"), (8, 49, 32, 1, "random")]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_versions_match_jax_vjp_of_the_jnp_composition(case):
    bw, n, c, heads, mask_kind = case
    q, k, v, g, bias, mask = _inputs(bw + c, bw, n, c, heads, mask_kind,
                                     nw=4 if mask_kind == "random" else 6)
    jm = None if mask is None else jnp.asarray(mask)
    hq, hk, hv, hg = (_heads(a, heads) for a in (q, k, v, g))
    want, vjp = jax.vjp(
        lambda q, k, v, b: window_cross_attention_xla(q, k, v, b, jm),
        hq, hk, hv, jnp.asarray(bias))
    wq, wk, wv, wb = vjp(hg)
    out = wa.window_attention(*(_t(a).requires_grad_() for a in (q, k, v)),
                              _t(bias).requires_grad_(), _t(mask))
    np.testing.assert_allclose(out.detach().numpy(), _packed(want),
                               atol=ATOL, rtol=RTOL)
    q_, k_, v_ = (_t(a).requires_grad_() for a in (q, k, v))
    b_ = _t(bias).requires_grad_()
    wa.window_attention(q_, k_, v_, b_, _t(mask)).backward(_t(g))
    for name, t, w in (("dq", q_, wq), ("dk", k_, wk), ("dv", v_, wv)):
        np.testing.assert_allclose(t.grad.numpy(), _packed(w), atol=ATOL,
                                   rtol=RTOL, err_msg=name)
    np.testing.assert_allclose(b_.grad.numpy(), np.asarray(wb),
                               atol=DBIAS_ATOL, rtol=RTOL)


@pytest.mark.parametrize("mask_kind", ["none", "random"])
def test_gradcheck_in_float64(mask_kind):
    q, k, v, _, bias, mask = _inputs(3, 4, 6, 8, 2, mask_kind, nw=2)
    if mask is not None:
        mask = np.where(mask < 0, -3.0, 0.0)   # a mask the softmax feels

    def t(a):
        return torch.from_numpy(a).double().requires_grad_()

    assert torch.autograd.gradcheck(
        lambda q, k, v, b: wa.window_attention(
            q, k, v, b, None if mask is None else torch.from_numpy(mask).double()),
        (t(q), t(k), t(v), t(bias)), eps=1e-6, atol=1e-6, rtol=1e-5)


def test_pad_tokens_take_part_in_the_softmax():
    """A window whose last tokens are pads (bias-only keys and values: the
    projection of a zero row) weighs them like any token; the plain version
    holds to the jnp composition there too."""
    q, k, v, g, bias, _ = _inputs(9, 2, 49, 32, 2, "none")
    kb, vb = np.float32(0.3), np.float32(-0.7)
    k[:, 40:], v[:, 40:] = kb, vb
    got = wa.window_attention_fwd(_t(q), _t(k), _t(v), _t(bias))
    want = window_cross_attention_xla(*(_heads(a, 2) for a in (q, k, v)),
                                      jnp.asarray(bias))
    np.testing.assert_allclose(got.numpy(), _packed(want), atol=ATOL,
                               rtol=RTOL)
    k2 = k.copy()
    k2[:, 40:] = 5.0   # the pads' keys change the softmax of every query
    other = wa.window_attention_fwd(_t(q), _t(k2), _t(v), _t(bias))
    assert float((other - got).abs().max()) > 1e-2


def test_wrappers_check_their_arguments():
    q, k, v, g, bias, mask = _inputs(4, 8, 49, 32, 2, "random")
    with pytest.raises(ValueError):
        wa.window_attention_fwd(_t(q), _t(k[:, :, :16]), _t(v), _t(bias))
    with pytest.raises(ValueError):
        wa.window_attention_bwd(_t(q), _t(k), _t(v), _t(bias), _t(mask),
                                _t(g[:4]))
    with pytest.raises(ValueError):
        wa.window_attention_fwd(_t(q), _t(k), _t(v), _t(bias), _t(mask[:3]))
    assert wa.bwd_chunk(3312, 4) * 1024 // 4 >= 3312
    assert wa.bwd_chunk(72, 32) == 3 and wa.bwd_chunk(5, 2) == 1
