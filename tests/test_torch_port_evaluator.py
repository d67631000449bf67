"""``AlhashimEvaluator`` of the port against the JAX package's over the same
seeded batches and the same forward: an oracle forward (a fixed function of
the image, written for both layouts) and GuideDepth-S on bridged weights;
the NYU fixed Eigen crop, the KITTI fractional crop, ``'tu'`` mode and
``forward_returns_meters``. Every metric of ``Result`` agrees to rtol 1e-4
(the two packages resize and normalize in float32 on different libraries;
the timings are not compared) and ``results.txt`` is byte-equal. The small
pieces (``compute_errors``, the crops, ``EvalConfig``) agree exactly.

The configurations override ``image_size`` with small model resolutions so
that the JAX model compiles in seconds; crops, depth ranges and protocol are
the datasets' own.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_port_guidedepth import _random_variables

from tpudepth.core import config as jcfg
from tpudepth.eval.evaluator import AlhashimEvaluator as JaxEvaluator
from tpudepth.eval.metrics import METRIC_NAMES as JAX_METRIC_NAMES
from tpudepth.eval.metrics import compute_errors as jax_compute_errors
from tpudepth.models import build_model as jax_build_model
from tpudepth_torch.core import config as tcfg
from tpudepth_torch.eval.evaluator import AlhashimEvaluator
from tpudepth_torch.eval.metrics import METRIC_NAMES, compute_errors
from tpudepth_torch.models.jax_weights import guidedepth_state_dict_from_flax
from tpudepth_torch.models.registry import build_model
from tpudepth_torch.train.trainer import make_eval_step

METRICS = ["irmse", "imae", "mse", "rmse", "mae", "absrel", "lg10", "rmse_log",
           "delta1", "delta2", "delta3"]


def _configs(model_hw, **kwargs):
    """The same ``EvalConfig`` of both packages, at a small model size."""
    out = []
    for mod in (jcfg, tcfg):
        cls = type("SmallEvalConfig", (mod.EvalConfig,),
                   {"image_size": property(lambda self: model_hw)})
        out.append(cls(**kwargs))
    return out


def _loader(seed, n, bsz, hw):
    rng = np.random.default_rng(seed)
    return [{"image": rng.random((bsz, *hw, 3), dtype=np.float32),
             "depth": rng.random((bsz, *hw, 1), dtype=np.float32) * 0.9 + 0.05}
            for _ in range(n)]


def _oracle(scale):
    """A normalized-depth 'model' (values in (1, 6) * scale) written for the
    JAX package's NHWC layout and the port's NCHW layout."""
    def jax_forward(image):
        return scale * (1.0 + 4.0 * jnp.mean(image, axis=-1, keepdims=True)
                        + image[..., :1])

    def port_forward(image):
        return scale * (1.0 + 4.0 * image.mean(dim=1, keepdim=True)
                        + image[:, :1])

    return jax_forward, port_forward


def _compare(jax_eval, port_eval, loader, tmp_path):
    want = jax_eval.evaluate(loader, save_results_to=str(tmp_path / "jax"))
    got = port_eval.evaluate(loader, save_results_to=str(tmp_path / "port"))
    for name in METRICS:
        assert getattr(got, name) == pytest.approx(getattr(want, name),
                                                   rel=1e-4), name
    assert 0.0 < want.delta1 < 1.0 and want.rmse > 0.0
    assert ((tmp_path / "port" / "results.txt").read_bytes()
            == (tmp_path / "jax" / "results.txt").read_bytes())
    assert port_eval.format_report(got) .splitlines()[:-1] == (
        jax_eval.format_report(want).splitlines()[:-1])  # all but t_GPU
    return got


def test_nyu_eigen_crop_with_an_oracle_forward(tmp_path):
    jc, tc = _configs((48, 64), dataset="nyu_reduced", resolution="half")
    assert tc.crop == (20, 460, 24, 616)
    jf, tf = _oracle(1.0)
    _compare(JaxEvaluator(jf, jc), AlhashimEvaluator(tf, tc, device="cpu"),
             _loader(0, 2, 2, (480, 640)), tmp_path)


def test_the_crop_and_the_flip_are_applied(tmp_path):
    """Ground truth that the forward reproduces inside the Eigen crop only,
    and only for the unflipped image: the flipped sample counts as an extra
    sample, so delta1 is 1 for one half of the samples and the mean is not."""
    _, tc = _configs((48, 64), dataset="nyu_reduced", resolution="half")
    rng = np.random.default_rng(1)
    image = rng.random((1, 480, 640, 3), dtype=np.float32)
    depth = np.full((1, 480, 640, 1), 0.5, np.float32)
    depth[:, :20] = depth[:, 460:] = 0.01      # outside the crop: far off
    depth[:, :, :24] = depth[:, :, 616:] = 0.01
    calls = []

    def forward(x):
        calls.append(tuple(x.shape))
        first = len(calls) % 2 == 1              # image, then its flip
        value = 2.0 if first else 4.0            # meters 5.0 / 2.5
        return torch.full((x.shape[0], 1, *x.shape[2:]), value)

    ev = AlhashimEvaluator(forward, tc, device="cpu")
    avg = ev.evaluate([{"image": image, "depth": depth}])
    assert calls == [(1, 3, 48, 64)] * 2
    assert avg.delta1 == pytest.approx(0.5)
    assert avg.absrel == pytest.approx(0.25, rel=1e-5)


def test_kitti_fractional_crop_with_an_oracle_forward(tmp_path):
    jc, tc = _configs((48, 160), dataset="kitti", resolution="half")
    jf, tf = _oracle(8.0)
    got = _compare(JaxEvaluator(jf, jc), AlhashimEvaluator(tf, tc, device="cpu"),
                   _loader(2, 2, 1, (96, 320)), tmp_path)
    assert tc.max_depth == 80.0 and got.rmse > 1.0


def test_tu_mode_evaluates_at_the_model_resolution(tmp_path):
    jc, tc = _configs((48, 64), dataset="nyu_reduced", resolution="half",
                      eval_mode="tu")
    jf, tf = _oracle(1.0)
    _compare(JaxEvaluator(jf, jc), AlhashimEvaluator(tf, tc, device="cpu"),
             _loader(3, 2, 2, (96, 128)), tmp_path)


def test_forward_returns_meters(tmp_path):
    jc, tc = _configs((48, 64), dataset="nyu_reduced", resolution="half")
    jf, tf = _oracle(1.0)
    loader = _loader(4, 1, 2, (480, 640))
    meters = _compare(
        JaxEvaluator(jf, jc, forward_returns_meters=True),
        AlhashimEvaluator(tf, tc, forward_returns_meters=True, device="cpu"),
        loader, tmp_path)
    normalized = AlhashimEvaluator(tf, tc, device="cpu").evaluate(loader)
    assert meters.rmse != pytest.approx(normalized.rmse, rel=1e-2)


def test_an_exact_zero_prediction_scores_as_in_the_jax_package(tmp_path):
    """A raw prediction of exactly 0 (a bf16 model gives some where its
    output crosses 0) is 0 m after ``inverse_depth_norm``, as in the
    reference, and the protocol does not mask predictions: the logarithmic
    and the inverse metrics are then infinite, in both packages alike, and
    ``results.txt`` says ``inf``."""
    jc, tc = _configs((48, 64), dataset="nyu_reduced", resolution="half")
    jf, tf = _oracle(1.0)

    def jax_forward(image):
        return jf(image).at[:, 10:20, 10:30, :].set(0.0)

    def port_forward(image):
        out = tf(image)
        out[:, :, 10:20, 10:30] = 0.0
        return out

    got = _compare(JaxEvaluator(jax_forward, jc),
                   AlhashimEvaluator(port_forward, tc, device="cpu"),
                   _loader(7, 1, 2, (480, 640)), tmp_path)
    assert np.isinf([got.rmse_log, got.lg10, got.irmse, got.imae]).all()
    assert np.isfinite([got.rmse, got.mae, got.absrel, got.delta1]).all()
    values = (tmp_path / "port" / "results.txt").read_text().split("\n")[1]
    assert values.split(",")[3:5] == ["inf", "inf"]


def test_bridged_guidedepth_s_through_both_evaluators(tmp_path):
    hw = (96, 128)
    variables = _random_variables("GuideDepth-S", 1)
    jmodel = jax_build_model("GuideDepth-S")
    jforward = jax.jit(lambda x: jmodel.apply(variables, x, train=False))
    port = build_model("GuideDepth-S", gub="fused")
    port.load_state_dict(guidedepth_state_dict_from_flax(variables))
    step = make_eval_step(port, torch.float32)
    jc, tc = _configs(hw, dataset="nyu_reduced", resolution="half")
    # a depth scale at which the random model's predictions are in range
    _compare(JaxEvaluator(jforward, jc, depth_scale=40.0),
             AlhashimEvaluator(step, tc, depth_scale=40.0, device="cpu"),
             _loader(5, 1, 2, (480, 640)), tmp_path)


def test_save_image_results_writes_the_four_pictures(tmp_path):
    pytest.importorskip("matplotlib")
    _, tc = _configs((48, 64), dataset="nyu_reduced", resolution="half")
    _, tf = _oracle(1.0)
    ev = AlhashimEvaluator(tf, tc, visualize_images=(0,), device="cpu")
    ev.evaluate(_loader(6, 1, 1, (480, 640)), save_results_to=str(tmp_path))
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["depth_0.png", "errors_0.png", "gt_0.png", "image_0.png",
                     "results.txt"]
    assert AlhashimEvaluator.DEFAULT_VISUALIZE == JaxEvaluator.DEFAULT_VISUALIZE


def test_the_card_is_the_evaluators_default_device():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AlhashimEvaluator(lambda x: x, tcfg.EvalConfig())


@pytest.mark.parametrize("seed", [0, 1])
def test_compute_errors_matches_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    gt = rng.random(1000) * 70 + 0.5
    pred = gt * rng.uniform(0.6, 1.6, 1000)
    assert METRIC_NAMES == JAX_METRIC_NAMES
    assert compute_errors(gt, pred) == jax_compute_errors(gt, pred)


@pytest.mark.parametrize("hw", [(480, 640), (375, 1242), (352, 1216),
                                (96, 320), (1, 1)])
def test_crops_match_the_jax_package(hw):
    assert tcfg.garg_crop(*hw) == jcfg.garg_crop(*hw)
    assert tcfg.kitti_alhashim_crop(*hw) == jcfg.kitti_alhashim_crop(*hw)
    assert all(isinstance(v, int) for v in tcfg.kitti_alhashim_crop(*hw))


def test_eval_config_keeps_the_jax_package_defaults():
    ours = {f.name: f.default for f in dataclasses.fields(tcfg.EvalConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(jcfg.EvalConfig)}
    assert ours == theirs
    assert tcfg.CROPS == jcfg.CROPS
    for dataset, res in (("nyu", "full"), ("nyu_reduced", "mini"),
                         ("kitti", "tu_big")):
        a = tcfg.EvalConfig(dataset=dataset, resolution=res)
        b = jcfg.EvalConfig(dataset=dataset, resolution=res)
        assert (a.max_depth, a.image_size, a.crop) == (
            b.max_depth, b.image_size, b.crop)
