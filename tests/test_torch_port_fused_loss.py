"""Port fused depth loss on the CPU (the plain versions of its CUDA kernels,
which the wrappers run for CPU tensors) against the JAX package's Pallas
kernels in interpret mode and against ``DepthLoss`` in both packages.

Tolerances: per-image partials rtol 1e-5 (the same f32 operations in the
same order; only the sums over pixels differ) with an absolute floor on the
SSIM sum, whose terms cancel; the analytic backward against the Pallas
backward rtol 1e-4 / atol 1e-6 of the gradient's scale; the loss and its
gradient against ``DepthLoss`` at the JAX package's own tolerances (loss abs
2e-4, gradient rtol 1e-4 / atol 1e-6, ``tests/test_fused_loss.py``).
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl

from test_torch_port_cuda import loss_pair

from tpudepth.losses import DepthLoss as JaxDepthLoss
from tpudepth.ops.pallas import fused_loss as jfl
from tpudepth_torch.losses.losses import DepthLoss
from tpudepth_torch.ops.kernels import fused_loss as fl

MAX_DEPTH = 10.0


@pytest.fixture
def interpret(monkeypatch):
    """The JAX package's Pallas kernels in interpret mode, as its own tests
    run them on the CPU."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def pair(kind, bsz, h, w, seed=0):
    """The cases of the kernels' tests on the card, as numpy arrays."""
    p, t = loss_pair(kind, bsz, h, w, "cpu", seed)
    return p.numpy(), t.numpy()


# random values; depth_norm scale; ragged 33x47; zero targets; pred == target
# (gate closed, signs at 0); flat patches (signs of 0 differences)
CASES = [("random", 3, 48, 64), ("norm", 2, 40, 56), ("norm", 2, 33, 47),
         ("zeros", 2, 32, 48), ("equal", 2, 24, 24), ("smooth", 2, 34, 46)]
IDS = ["-".join(map(str, c)) for c in CASES]


def _j4(x):
    return jnp.asarray(x)[..., None]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_partials_match_pallas_interpret(interpret, case):
    p, t = pair(*case)
    want = np.asarray(jfl._fused_partials(_j4(p), _j4(t), MAX_DEPTH))
    got = fl.fused_partials(torch.from_numpy(p), torch.from_numpy(t),
                            MAX_DEPTH).numpy()
    assert got.shape == want.shape == (case[1], 3)
    n = case[2] * case[3]
    np.testing.assert_allclose(got[:, [0, 2]], want[:, [0, 2]], rtol=1e-5)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-5, atol=1e-5 * n)
    if case[0] == "equal":
        np.testing.assert_array_equal(got[:, 1], np.full(case[1], float(n)))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_analytic_backward_matches_pallas_interpret(interpret, case):
    p, t = pair(*case)
    n = p.size
    scales = np.array([[0.1 / n, -0.5 / n, 1.0 / n]], np.float32)
    want = np.asarray(jfl._fused_bwd(_j4(p), _j4(t), MAX_DEPTH,
                                     jnp.asarray(scales)))
    got = fl.fused_bwd(torch.from_numpy(p), torch.from_numpy(t), MAX_DEPTH,
                       torch.from_numpy(scales[0])).numpy()
    assert got.shape == want.shape == p.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 / n * 100)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fused_depth_loss_matches_jax_fused_and_both_depth_losses(interpret, case):
    p, t = pair(*case)
    jwant, jgrad = jax.value_and_grad(
        lambda q: jfl.fused_depth_loss(q, _j4(t), 0.1, 1.0, 1.0, MAX_DEPTH))(_j4(p))
    jref = float(JaxDepthLoss(0.1, 1.0, 1.0, MAX_DEPTH)(_j4(p), _j4(t)))

    pt = torch.from_numpy(p)[:, None].clone().requires_grad_(True)
    tt = torch.from_numpy(t)[:, None]
    got = fl.fused_depth_loss(pt, tt, 0.1, 1.0, 1.0, MAX_DEPTH)
    got.backward()
    assert abs(got.item() - float(jwant)) < 2e-4
    assert abs(got.item() - jref) < 2e-4
    np.testing.assert_allclose(pt.grad[:, 0].numpy(), np.asarray(jgrad)[..., 0],
                               rtol=1e-4, atol=1e-6)

    pr = torch.from_numpy(p)[:, None].clone().requires_grad_(True)
    ref = DepthLoss(0.1, 1.0, 1.0, MAX_DEPTH)(pr, tt)
    ref.backward()
    assert abs(got.item() - ref.item()) < 2e-4
    if case[0] not in ("equal", "smooth"):
        # where differences are exactly 0, autograd's abs'(0) = 0 and the
        # analytic sign(0) = 0 agree too, but the flat patches cancel to
        # rounding noise in the SSIM adjoint; checked below with its own atol
        np.testing.assert_allclose(pt.grad.numpy(), pr.grad.numpy(),
                                   rtol=1e-4, atol=1e-6)
    else:
        np.testing.assert_allclose(pt.grad.numpy(), pr.grad.numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_analytic_backward_agrees_with_float64_autograd():
    """gradcheck-style: the analytic backward (f32) against autograd through
    ``DepthLoss`` in float64 on the same values."""
    p, t = pair("random", 2, 20, 28, seed=3)
    pt = torch.from_numpy(p)[:, None].clone().requires_grad_(True)
    fl.fused_depth_loss(pt, torch.from_numpy(t)[:, None], 0.1, 1.0, 1.0,
                        MAX_DEPTH).backward()
    p64 = torch.from_numpy(p)[:, None].double().requires_grad_(True)
    # DepthLoss computes in float32 by design; redo its three terms in f64
    t64 = torch.from_numpy(t)[:, None].double()
    g = torch.tensor(fl._gauss_taps(), dtype=torch.float64)

    def gconv(x):
        x = torch.nn.functional.conv2d(x, g.view(1, 1, -1, 1), padding=(5, 0))
        return torch.nn.functional.conv2d(x, g.view(1, 1, 1, -1), padding=(0, 5))

    c1, c2 = (0.01 * MAX_DEPTH) ** 2, (0.03 * MAX_DEPTH) ** 2
    m1, m2 = gconv(p64), gconv(t64)
    s11, s22 = gconv(p64 * p64) - m1 * m1, gconv(t64 * t64) - m2 * m2
    s12 = gconv(p64 * t64) - m1 * m2
    ssim = (((2 * m1 * m2 + c1) * (2 * s12 + c2))
            / ((m1 * m1 + m2 * m2 + c1) * (s11 + s22 + c2))).mean()

    def dx(x):
        return x[..., 1:] - x[..., :-1]

    def dy(x):
        return x[..., 1:, :] - x[..., :-1, :]

    grad = ((dx(t64) - dx(p64)).abs().sum()
            + (dy(t64) - dy(p64)).abs().sum()) / p64.numel()
    loss = (0.1 * (p64 - t64).abs().mean()
            + torch.clamp((1 - ssim) * 0.5, 0, 1) + grad)
    loss.backward()
    np.testing.assert_allclose(pt.grad.numpy(), p64.grad.numpy(), rtol=1e-4,
                               atol=1e-7)


def test_adjoint_coefficients_are_zero_outside_the_image():
    """The adjoint convolution is zero-padded: coefficient maps taken from
    the formulas on a zero-extended image (where Ce12 = 2*C1/(C1*C2) != 0)
    give a gradient that is wrong on the 5-pixel border and nowhere else."""
    p, t = pair("norm", 1, 30, 36, seed=5)
    pt, tt = torch.from_numpy(p), torch.from_numpy(t)
    n = p.size
    scales = torch.tensor([0.0, -0.5 / n, 0.0])
    right = fl.fused_bwd(pt, tt, MAX_DEPTH, scales)
    pad = torch.nn.functional.pad
    wrong = fl.fused_bwd(pad(pt, (5, 5, 5, 5)), pad(tt, (5, 5, 5, 5)),
                         MAX_DEPTH, scales)[:, 5:-5, 5:-5]
    diff = (right - wrong).abs()
    assert float(diff[:, 5:-5, 5:-5].max()) <= 1e-6 * float(right.abs().max())
    assert float(diff.max()) > 1e-2 * float(right.abs().max())


def test_clip_gate_is_strict_and_scales_follow_the_upstream_gradient():
    n_pix, bsz = 100, 2
    total = bsz * n_pix
    g = torch.tensor(2.0)

    def scales(ssim_sum):
        partials = torch.tensor([[1.0, ssim_sum / bsz, 1.0]] * bsz)
        return fl._scales(partials, n_pix, 0.1, 1.0, 1.0, g).tolist()

    inside = scales(0.5 * total)
    np.testing.assert_allclose(inside, [0.1 * 2 / total, -0.5 * 2 / total,
                                        2 / total], rtol=1e-6)
    assert scales(1.0 * total)[1] == 0.0      # (1 - 1)/2 = 0: not inside
    assert scales(-1.0 * total)[1] == 0.0     # (1 + 1)/2 = 1: not inside
    assert scales(1.5 * total)[1] == 0.0
    assert scales(0.999 * total)[1] != 0.0


def test_pred_equal_target_gives_zero_loss_and_zero_gradient():
    p, t = pair("equal", 2, 24, 24)
    pt = torch.from_numpy(p)[:, None].clone().requires_grad_(True)
    loss = fl.fused_depth_loss(pt, torch.from_numpy(t)[:, None], 0.1, 1.0, 1.0,
                               MAX_DEPTH)
    loss.backward()
    assert loss.item() == 0.0
    assert float(pt.grad.abs().max()) == 0.0


def test_wrapper_refuses_wrong_shapes_and_types():
    p = torch.zeros(2, 8, 8)
    with pytest.raises(ValueError):
        fl.fused_partials(p, torch.zeros(2, 8, 9), MAX_DEPTH)
    with pytest.raises(TypeError):
        fl.fused_partials(p.double(), p.double(), MAX_DEPTH)
    with pytest.raises(ValueError):
        fl.fused_depth_loss(torch.zeros(2, 3, 8, 8), torch.zeros(2, 3, 8, 8),
                            0.1, 1.0, 1.0, MAX_DEPTH)


def test_taps_are_the_jax_package_taps():
    assert fl._gauss_taps() == jfl._gauss_taps()
