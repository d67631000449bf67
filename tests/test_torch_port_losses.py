"""Port losses (tpudepth_torch.losses, plain tensor code, NCHW) against the
JAX package's jnp losses (NHWC) on the same numpy inputs: values and
gradients (``jax.grad`` against autograd) of both recipes' losses (the
root recipe's min-max normalization, box SSIM and SILog too), and the rest
of the image ops.

Tolerance: atol 1e-5, rtol 1e-4 in f32 (the same operations, with the sums
of the gaussian and of the means taken in another order).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tpudepth import losses as jl
from tpudepth.ops import image as jimage
from tpudepth_torch.losses import losses as tl
from tpudepth_torch.ops import image as timage

ATOL, RTOL = 1e-5, 1e-4


def _pair(seed, shape=(2, 24, 40), zeros=False):
    rng = np.random.default_rng(seed)
    p = (rng.random(shape) * 10).astype(np.float32)
    t = (rng.random(shape) * 10).astype(np.float32)
    if zeros:
        t[rng.random(shape) < 0.3] = 0.0
    return p, t


def _j(x):
    return jnp.asarray(x)[..., None]      # [B,H,W] -> NHWC


def _t(x, grad=False):
    return torch.from_numpy(x)[:, None].clone().requires_grad_(grad)  # NCHW


LOSSES = {
    "l1": (lambda p, t: jl.l1_loss(p, t), lambda p, t: tl.l1_loss(p, t)),
    "l1_masked": (lambda p, t: jl.l1_loss(p, t, mask=t > 0.0),
                  lambda p, t: tl.l1_loss(p, t, mask=t > 0.0)),
    "ssim_gaussian": (lambda p, t: jl.ssim_gaussian(p, t, 10.0),
                      lambda p, t: tl.ssim_gaussian(p, t, 10.0)),
    "gradient": (lambda p, t: jl.gradient_loss(p, t),
                 lambda p, t: tl.gradient_loss(p, t)),
    "depth_loss": (lambda p, t: jl.DepthLoss(0.1, 1.0, 1.0, 10.0)(p, t),
                   lambda p, t: tl.DepthLoss(0.1, 1.0, 1.0, 10.0)(p, t)),
    "depth_loss_masked_l1": (
        lambda p, t: jl.DepthLoss(1.0, 0.0, 0.0, 10.0)(p, t),
        lambda p, t: tl.DepthLoss(1.0, 0.0, 0.0, 10.0)(p, t)),
    # the root recipe's parts: the 3x3 box SSIM with ReflectionPad(1), SILog
    "ssim_box": (lambda p, t: jl.ssim(p, t), lambda p, t: tl.ssim(p, t)),
    "silog": (lambda p, t: jl.silog_loss_variance(p, t),
              lambda p, t: tl.silog_loss_variance(p, t)),
    "depth_norm_minmax": (lambda p, t: jnp.sum(jl.depth_norm_minmax(p) * t),
                          lambda p, t: (tl.depth_norm_minmax(p) * t).sum()),
}


@pytest.mark.parametrize("zeros", [False, True], ids=["dense", "zero-targets"])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_value_and_gradient_match_jax(name, zeros):
    jfn, tfn = LOSSES[name]
    p, t = _pair(3, zeros=zeros)
    want, gwant = jax.value_and_grad(lambda q: jfn(q, _j(t)))(_j(p))
    pt = _t(p, grad=True)
    got = tfn(pt, _t(t))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(pt.grad[:, 0].numpy(),
                               np.asarray(gwant)[..., 0], atol=ATOL, rtol=RTOL)


def test_ssim_gaussian_of_an_image_smaller_than_the_window():
    p, t = _pair(4, shape=(1, 7, 9))
    want = float(jl.ssim_gaussian(_j(p), _j(t), 10.0))
    got = tl.ssim_gaussian(_t(p), _t(t), 10.0).item()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_depth_loss_of_bf16_prediction_is_taken_in_f32():
    p, t = _pair(5)
    pb = torch.from_numpy(p)[:, None].bfloat16()
    got = tl.DepthLoss(0.1, 1.0, 1.0, 10.0)(pb, _t(t))
    want = tl.DepthLoss(0.1, 1.0, 1.0, 10.0)(pb.float(), _t(t))
    assert got.dtype == torch.float32
    assert got.item() == want.item()


def _nhwc(x):
    return jnp.asarray(np.transpose(x, (0, 2, 3, 1)))


def _back(y):
    return np.transpose(np.asarray(y), (0, 3, 1, 2))


def test_image_gradients_match_jax():
    x = np.random.default_rng(0).standard_normal((2, 3, 9, 11)).astype(np.float32)
    jdx, jdy = jimage.image_gradients(_nhwc(x))
    tdx, tdy = timage.image_gradients(torch.from_numpy(x))
    np.testing.assert_array_equal(tdx.numpy(), _back(jdx))
    np.testing.assert_array_equal(tdy.numpy(), _back(jdy))
    assert not tdx[..., -1].any() and not tdy[..., -1, :].any()


IMAGE_OPS = {
    "upsample": (lambda x: jimage.upsample(x, 2),
                 lambda x: timage.upsample(x, 2)),
    "upsample_align_corners": (lambda x: jimage.upsample(x, 2, True),
                               lambda x: timage.upsample(x, 2, True)),
    "pixel_shuffle": (lambda x: jimage.pixel_shuffle(x, 2),
                      lambda x: timage.pixel_shuffle(x, 2)),
    "reflection_pad2d": (lambda x: jimage.reflection_pad2d(x, 1),
                         lambda x: timage.reflection_pad2d(x, 1)),
    "max_pool": (lambda x: jimage.max_pool(x, 2, 2),
                 lambda x: timage.max_pool(x, 2, 2)),
}


@pytest.mark.parametrize("name", sorted(IMAGE_OPS))
def test_image_op_matches_jax(name):
    jfn, tfn = IMAGE_OPS[name]
    x = np.random.default_rng(1).standard_normal((2, 8, 10, 14)).astype(np.float32)
    want = _back(jfn(_nhwc(x)))
    got = tfn(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
