"""Port fused root-recipe loss on the CPU (the plain versions of its CUDA
kernels, which the wrappers run for CPU tensors) against the JAX package's
Pallas kernels in interpret mode, against the jnp composition ``1.0 * ssim
+ 0.1 * l1_loss`` in both packages, and ``gradcheck`` of the
``autograd.Function`` in float64.

Tolerances. Against the Pallas kernels: the same f32 operations in the same
order, but XLA's CPU code may fuse a multiply and an add that the plain
version rounds twice. Where an image is flat the variances are differences
of equal statistics, so that rounding stays absolute (~1e-8 against C2 =
9e-4) and moves a pixel's SSIM by up to ~1e-5; where the clip is active the
coefficient maps cancel. So the per-image partials rtol 1e-5 with a floor
of 1e-5 per pixel, and the analytic backward rtol 1e-4 / atol 1e-4 of the
gradient's largest value (the JAX test holds its kernel to rtol 1e-4 and
an absolute 1e-6, about 1e-2 of these gradients). Against the jnp
composition, the loss and its gradient at the JAX package's own tolerances
(loss rtol 1e-5 / atol 1e-6, gradient rtol 1e-4 / atol 1e-6,
``tests/test_fused_root_loss.py``).
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl

from torch_port_helpers import root_pair

from tpudepth.losses import l1_loss as jax_l1, ssim as jax_ssim
from tpudepth.ops.pallas import fused_root_loss as jfrl
from tpudepth_torch.losses.losses import l1_loss, ssim
from tpudepth_torch.ops.kernels import fused_root_loss as frl


@pytest.fixture
def interpret(monkeypatch):
    """The JAX package's Pallas kernels in interpret mode, as its own tests
    run them on the CPU."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


# the JAX test's shape; ragged (33x47: not a multiple of the 32x32 tile);
# the clip active; pred == target; flat patches; the smallest image
CASES = [("unit", 2, 24, 32), ("unit", 2, 33, 47), ("anti", 2, 24, 32),
         ("equal", 1, 16, 24), ("smooth", 2, 34, 46), ("unit", 1, 4, 5)]
IDS = ["-".join(map(str, c)) for c in CASES]


def pair(case):
    p, t = root_pair(*case[:4], "cpu")
    return p.numpy(), t.numpy()


def _j4(x):
    return jnp.asarray(x)[..., None]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_partials_match_pallas_interpret(interpret, case):
    p, t = pair(case)
    want = np.asarray(jfrl._fused_partials(_j4(p), _j4(t)))
    got = frl.root_partials(torch.from_numpy(p), torch.from_numpy(t)).numpy()
    assert got.shape == want.shape == (case[1], 2)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * case[2] * case[3])
    if case[0] == "equal":
        assert (got == 0).all()


# pred == target puts every pixel's loss map at the clip's bound 0, where the
# derivative is not defined: each implementation opens or closes a pixel's
# gate by the last bit of its own 1 - N1 N2 R (the card's kernel and the
# plain version by the same bit, tests/test_torch_port_cuda.py)
BWD_CASES = [c for c in CASES if c[0] != "equal"]


@pytest.mark.parametrize("case", BWD_CASES,
                         ids=["-".join(map(str, c)) for c in BWD_CASES])
def test_analytic_backward_matches_pallas_interpret(interpret, case):
    p, t = pair(case)
    n = p.size
    want = np.asarray(jfrl._frl_bwd(1.0, 0.1, (_j4(p), _j4(t)),
                                    jnp.float32(1.0))[0])[..., 0]
    scales = torch.tensor([1.0 / n, 0.1 / n])
    got = frl.root_bwd(torch.from_numpy(p), torch.from_numpy(t),
                       scales).numpy()
    assert got.shape == want.shape == p.shape
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("case", [CASES[0], CASES[1], CASES[2]],
                         ids=IDS[:3])
def test_fused_root_loss_matches_the_jnp_composition(case):
    """Loss and gradient of the ``autograd.Function`` against ``jax.grad``
    of JAX's plain root loss, and the loss against the port's plain
    ``ssim`` + ``l1_loss``."""
    p, t = pair(case)

    def jref(x):
        return 1.0 * jax_ssim(x, _j4(t)) + 0.1 * jax_l1(x, _j4(t))

    want_loss, want_grad = jax.value_and_grad(jref)(_j4(p))
    pt = torch.from_numpy(p)[:, None].requires_grad_(True)
    tt = torch.from_numpy(t)[:, None]
    loss = frl.fused_root_loss(pt, tt, 1.0, 0.1)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(pt.grad[:, 0].numpy(),
                               np.asarray(want_grad)[..., 0], rtol=1e-4,
                               atol=1e-6)
    plain = 1.0 * ssim(pt, tt) + 0.1 * l1_loss(pt, tt)
    np.testing.assert_allclose(loss.item(), plain.item(), rtol=1e-5)


def test_gradcheck_in_float64():
    p, t = root_pair("unit", 2, 5, 6, "cpu", seed=3)
    p = p.double().requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda x: frl.fused_root_loss(x, t.double(), 1.0, 0.1), (p,),
        eps=1e-6, atol=1e-7, rtol=1e-5)


def test_refuses_what_it_does_not_take():
    p, t = root_pair("unit", 1, 8, 8, "cpu")
    with pytest.raises(ValueError, match="must both be"):
        frl.root_partials(p, t[:, :7])
    with pytest.raises(ValueError, match="H, W >= 2"):
        frl.root_partials(p[:, :1], t[:, :1])
    with pytest.raises(ValueError, match="differ"):
        frl.root_bwd(p.double(), t, torch.ones(2))
    with pytest.raises(ValueError, match="no fused_root_loss_fwd kernel"):
        frl.root_partials(p.to("meta"), t.to("meta"))
