"""The plain versions of the port's training FFN
(``ops/kernels/mlp_train.py``; kernels ``mlp_train_fwd`` / ``mlp_train_bwd``
in ``csrc/mlp_train.cu``) against the JAX package, on the CPU.

- forward and backward against the Pallas kernels in interpret mode
  (``_mlp_fwd_pallas``, ``_mlp_bwd_pallas``; their row tiles need a
  multiple of 8 rows) in f32 at JAX's own tolerances
  (``tests/test_models.py::test_mlp_train_kernel_fwd_and_grads_match_unfused``:
  forward 3e-6, gradients 2e-5; the JAX kernels evaluate erf by a rational
  function within 1.5e-7 of the exact erf that the port uses), and in bf16
  at the kernels' tolerance (``mlp_train.tolerance``);
- the other cases, odd row counts included, against ``jax.grad`` of the
  JAX package's jnp composition of the FFN (f32 at HIGHEST precision);
- ``torch.autograd.gradcheck`` of the ``autograd.Function`` in float64;
- the ``Mlp`` layer in train mode: ``kernel=True`` against ``kernel=False``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tpudepth.ops.pallas.mlp_train import _mlp_bwd_pallas, _mlp_fwd_pallas
from tpudepth_torch.models.layers import Mlp
from torch_port_helpers import torch_one_thread  # noqa: F401 (autouse)
from tpudepth_torch.ops.kernels import mlp_train as mt

FWD_TOL, GRAD_TOL = 3e-6, 2e-5


def _inputs(seed, m, c, h, c2):
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0):
        return (s * rng.standard_normal(shape)).astype(np.float32)

    return dict(x=n(m, c), w1=n(c, h, s=c ** -0.5), b1=n(h, s=0.1),
                w2=n(h, c2, s=h ** -0.5), b2=n(c2, s=0.1)), n(m, c2)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


@pytest.fixture(scope="module")
def pallas():
    """The Pallas kernels in interpret mode at 64 rows, C 64, H 256, in f32
    and bf16 (weights cast by the caller, as ``mlp_train`` does):
    ``{dtype: (inputs, g, out, (dx, dw1, db1, dw2, db2))}``."""
    out = {}
    p, g = _inputs(1, 64, 64, 256, 64)
    for dt in (jnp.float32, jnp.bfloat16):
        x, w1, b1, w2, b2 = (jnp.asarray(p[k]).astype(dt)
                             for k in ("x", "w1", "b1", "w2", "b2"))
        y = _mlp_fwd_pallas(x, w1, b1, w2, b2, interpret=True)
        grads = _mlp_bwd_pallas(x, jnp.asarray(g).astype(dt), w1, b1, w2,
                                interpret=True)
        out[dt] = (p, g, y, grads)
    return out


def _port(p, g, dtype=torch.float32):
    x = _t(p["x"], dtype)
    y = mt.mlp_train_fwd(x, *(_t(p[k]) for k in ("w1", "b1", "w2", "b2")))
    grads = mt.mlp_train_bwd(x, _t(g, dtype), _t(p["w1"]), _t(p["b1"]),
                             _t(p["w2"]))
    return y, grads


def test_plain_forward_and_backward_match_the_pallas_kernels(pallas):
    p, g, y, (dx, dw1, db1, dw2, db2) = pallas[jnp.float32]
    got, grads = _port(p, g)
    np.testing.assert_allclose(got.numpy(), np.asarray(y), rtol=FWD_TOL,
                               atol=FWD_TOL)
    for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"), grads,
                          (dx, dw1, db1[0], dw2, db2[0])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


def test_plain_bf16_matches_the_pallas_kernels_in_bf16(pallas):
    """bf16 in: h and gelu(h) rounded to bf16 in the forward; h, a and dh1d
    rounded in the backward, db1 from the unrounded dh1, on both sides (the
    gradients within ``mlp_train.flip_atol`` of roundings that go the other
    way)."""
    p, g, y, jgrads = pallas[jnp.bfloat16]
    got, grads = _port(p, g, torch.bfloat16)
    bf = torch.bfloat16
    out_tol, w_tol = mt.tolerance(bf)
    flips = mt.flip_atol(_t(p["x"], bf), _t(g, bf), _t(p["w1"]), _t(p["b1"]),
                         _t(p["w2"]))
    assert got.dtype == grads[0].dtype == bf
    b = np.asarray(y, np.float32)
    np.testing.assert_allclose(got.float().numpy(), b,
                               atol=out_tol[0] * np.abs(b).max(),
                               rtol=out_tol[1], err_msg="out")
    for name, a, b, tol, flip in zip(
            ("dx", "dw1", "db1", "dw2", "db2"), grads,
            (jgrads[0], jgrads[1], jgrads[2][0], jgrads[3], jgrads[4][0]),
            (out_tol,) + (w_tol,) * 4, flips):
        b = np.asarray(b, np.float32)
        err = np.abs(a.float().numpy() - b)
        bound = tol[0] * np.abs(b).max() + tol[1] * np.abs(b) + flip.numpy()
        assert (err <= bound).all(), (name, float((err - bound).max()))


def test_flip_bounds_are_zero_in_f32_and_small_in_bf16():
    p, g = _inputs(5, 40, 64, 256, 64)
    assert all(t is None for t in mt.flip_atol(
        _t(p["x"]), _t(g), _t(p["w1"]), _t(p["b1"]), _t(p["w2"])))
    bf = torch.bfloat16
    flips = mt.flip_atol(_t(p["x"], bf), _t(g, bf), _t(p["w1"]), _t(p["b1"]),
                         _t(p["w2"]))
    want = mt.mlp_train_bwd_reference(_t(p["x"], bf), _t(g, bf), _t(p["w1"]),
                                      _t(p["b1"]), _t(p["w2"]))
    for name, f, w in zip(("dx", "dw1", "db1", "dw2", "db2"), flips, want):
        assert f.shape == w.shape, name
        # a few bf16 ulps of the tensor's largest value, not a free pass
        assert float(f.max()) <= 2.0 ** -4 * float(w.float().abs().max()), name


def _jax_grads(p, g):
    hi = jax.lax.Precision.HIGHEST

    def ffn(x, w1, b1, w2, b2):
        h = jax.nn.gelu(jnp.dot(x, w1, precision=hi) + b1, approximate=False)
        return jnp.dot(h, w2, precision=hi) + b2

    args = tuple(jnp.asarray(p[k]) for k in ("x", "w1", "b1", "w2", "b2"))
    y = ffn(*args)
    grads = jax.grad(lambda *a: jnp.vdot(ffn(*a), jnp.asarray(g)),
                     argnums=(0, 1, 2, 3, 4))(*args)
    return y, grads


# (M, C, H, C2): odd row counts, one row, a narrower output, SAM's ratio
CASES = [(50, 64, 256, 64), (37, 32, 128, 32), (1, 64, 256, 64),
         (75, 128, 512, 96)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_versions_match_jax_grad_of_the_jnp_composition(case):
    p, g = _inputs(sum(case), *case)
    y, (dx, dw1, db1, dw2, db2) = _jax_grads(p, g)
    params = [_t(p[k]).requires_grad_() for k in ("w1", "b1", "w2", "b2")]
    x = _t(p["x"]).requires_grad_()
    out = mt.mlp_train(x, *params)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y),
                               rtol=FWD_TOL, atol=FWD_TOL)
    out.backward(_t(g))
    for name, t, w in zip(("dx", "dw1", "db1", "dw2", "db2"),
                          [x] + params, (dx, dw1, db1, dw2, db2)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=name)


def test_gradcheck_in_float64():
    p, _ = _inputs(2, 5, 4, 8, 6)
    args = tuple(torch.from_numpy(p[k]).double().requires_grad_()
                 for k in ("x", "w1", "b1", "w2", "b2"))
    assert torch.autograd.gradcheck(mt.mlp_train, args, eps=1e-6, atol=1e-6,
                                    rtol=1e-5)


def test_weight_gradients_flow_back_through_the_cast():
    """bf16 rows with f32 parameters: the parameters' gradients come back in
    f32, dx in bf16."""
    p, g = _inputs(3, 20, 32, 128, 32)
    params = [_t(p[k]).requires_grad_() for k in ("w1", "b1", "w2", "b2")]
    x = _t(p["x"], torch.bfloat16).requires_grad_()
    out = mt.mlp_train(x, *params)
    assert out.dtype == torch.bfloat16
    out.backward(_t(g, torch.bfloat16))
    assert x.grad.dtype == torch.bfloat16
    assert all(t.grad.dtype == torch.float32 for t in params)


def test_mlp_layer_trains_through_the_kernel_pair():
    torch.manual_seed(0)
    plain, kern = Mlp(32, 128), Mlp(32, 128, kernel=True)
    kern.load_state_dict(plain.state_dict())
    x = torch.randn(2, 5, 7, 32)
    outs = []
    for layer in (plain, kern):
        xi = x.clone().requires_grad_()
        y = layer.train()(xi)
        y.square().sum().backward()
        outs.append((y.detach(), xi.grad, [q.grad for q in layer.parameters()]))
    torch.testing.assert_close(outs[1][0], outs[0][0], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(outs[1][1], outs[0][1], atol=1e-5, rtol=1e-5)
    for a, b in zip(outs[1][2], outs[0][2]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_wrappers_check_shapes_and_chunk_the_rows():
    p, g = _inputs(4, 16, 32, 128, 32)
    with pytest.raises(ValueError):
        mt.mlp_train_fwd(_t(p["x"]), _t(p["w1"][:16]), _t(p["b1"]),
                         _t(p["w2"]), _t(p["b2"]))
    with pytest.raises(ValueError):
        mt.mlp_train_bwd(_t(p["x"]), _t(g[:, :16]), _t(p["w1"]), _t(p["b1"]),
                         _t(p["w2"]))
    # 153,600 rows of crf0 at B 8: 33 chunks for a 128 x 512 weight
    k = mt.wgrad_chunk(153600, 128, 512)
    assert k % 32 == 0 and -(-153600 // k) == 33
    assert mt.wgrad_chunk(2400, 1024, 4096) >= 2400
    assert mt.wgrad_chunk(1, 64, 256) == 32
