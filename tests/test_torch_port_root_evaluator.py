"""``RootEvaluator`` of the port against the JAX package's over the same
seeded batches and the same numpy prediction function, run through both
(JAX takes and gives NHWC, the port NCHW): a prediction at the ground
truth's resolution and at others (2x and 2.5x below it, which take the
bilinear resize), inf, -inf and nan in the prediction, values outside the
clamp, and the fractional Garg crop. Every metric agrees to rtol 1e-5 (the
two resize in float32 on different libraries; the rest is the same float32
arithmetic and float64 numpy) and ``format_report`` gives the same text.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tpudepth.core import config as jcfg
from tpudepth.eval.evaluator import RootEvaluator as JaxRootEvaluator
from torch_port_helpers import torch_one_thread  # noqa: F401
from tpudepth_torch.core import config as tcfg
from tpudepth_torch.eval.evaluator import RootEvaluator
from tpudepth_torch.eval.metrics import METRIC_NAMES

HW = (96, 128)


def _loader(seed, n=2, bsz=2, hw=HW):
    rng = np.random.default_rng(seed)
    return [{"image": rng.random((bsz, *hw, 3), dtype=np.float32),
             "depth": rng.random((bsz, *hw, 1), dtype=np.float32) * 9.0 + 0.5}
            for _ in range(n)]


def _pair(fn):
    """``fn`` (numpy NHWC image -> numpy NHWC prediction) as the JAX
    package's forward and as the port's."""
    def jax_forward(image):
        return jnp.asarray(fn(np.asarray(image)))

    def port_forward(image):
        out = fn(image.permute(0, 2, 3, 1).numpy())
        return torch.from_numpy(out).permute(0, 3, 1, 2)

    return jax_forward, port_forward


def _smooth(image, hw=None):
    """A prediction in (0.05, 0.95), at ``hw`` (strided from the image)."""
    p = 0.05 + 0.3 * image.mean(axis=-1, keepdims=True) + 0.6 * image[..., 1:2]
    if hw is not None:
        p = p[:, :: image.shape[1] // hw[0], :: image.shape[2] // hw[1]]
        p = p[:, : hw[0], : hw[1]]
    return np.ascontiguousarray(p, np.float32)


def _compare(fn, loader, **cfg):
    jf, tf = _pair(fn)
    want = JaxRootEvaluator(jf, jcfg.EvalConfig(**cfg)).evaluate(loader)
    got = RootEvaluator(tf, tcfg.EvalConfig(**cfg), device="cpu").evaluate(
        loader)
    assert list(got) == list(want) == METRIC_NAMES
    for name in METRIC_NAMES:
        assert got[name] == pytest.approx(want[name], rel=1e-5), name
    assert (RootEvaluator.format_report(got, 4)
            == JaxRootEvaluator.format_report(want, 4))
    return got


@pytest.mark.parametrize("hw", [None, (48, 64), (38, 51)],
                         ids=["same", "half", "other"])
def test_metrics_match_jax(hw):
    """At the ground truth's resolution, and below it: 2x (JAX's separable
    2x path) and an uneven ratio (its interpolation matrices), both of
    which the port resizes with ``F.interpolate``."""
    got = _compare(lambda im: _smooth(im, hw), _loader(0))
    assert 0.0 < got["d1"] < 1.0 and got["rms"] > 0.0


def test_inf_nan_and_values_outside_the_clamp_match_jax():
    """inf goes to the clamp's top and nan to its bottom, after the clamp;
    -inf, negative values, 0 and values above max_depth_eval are clamped."""
    def fn(image):
        p = _smooth(image)
        p[:, 10:12, 20:40] = np.inf
        p[:, 30:31, :] = -np.inf
        p[:, 40:44, 50:60] = np.nan
        p[:, 50:52, 30:90] = -1.0
        p[:, 60, 40:100] = 0.0
        p[:, 70:72, 40:100] = 200.0
        return p

    got = _compare(fn, _loader(1), max_depth_eval=10.0)
    assert all(np.isfinite(v) for v in got.values())


def test_the_garg_crop_is_applied():
    """A prediction equal to the ground truth inside the fractional Garg
    crop and far off outside it scores perfectly, in both packages."""
    loader = _loader(2, n=1)
    gt = loader[0]["depth"]
    gt = (gt - gt.min()) / (gt.max() - gt.min())
    top, bottom, left, right = tcfg.garg_crop(*HW)
    assert (top, bottom, left, right) == (9, 94, 8, 120)
    far = np.full_like(gt, 0.9)
    far[:, top:bottom, left:right] = gt[:, top:bottom, left:right]
    got = _compare(lambda im: far, loader)
    assert got["abs_rel"] == pytest.approx(0.0, abs=1e-7)
    assert got["d1"] == 1.0
