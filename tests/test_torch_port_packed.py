"""Packed (space-to-depth) execution of the port, rematerialization, and
the debug and trace helpers.

- ``tpudepth_torch/ops/packed.py`` against ``tpudepth/ops/packed.py`` on
  inputs from a numpy seed: layouts and kernels exactly (NCHW against NHWC
  through a transpose, OIHW against HWIO), the upsampling within 1e-6 (as
  ``tests/test_packed.py``);
- the packed ``Conv`` and ``BatchNorm`` against the unpacked port modules
  on the same parameters, within ``tests/test_packed.py``'s tolerances (2e-5
  conv, 1e-5 BatchNorm);
- the per-stage blocks that the port's ``GuideDepth`` chooses against the
  JAX ``GuideDepth``'s choice (traced with its backbone and blocks stubbed:
  pure logic, no forward);
- the packed GUB in train mode against the unpacked one in float64, plain
  and fused (the fused stages through the plain versions of their kernels
  on the CPU): output, every gradient and the running statistics;
- rematerialized float64 train steps (the whole forward, or each GUB stage)
  against the plain step: the same loss and gradients, and the running
  statistics moved once;
- ``utils/debug.py`` and ``utils/profiling.py``'s ``trace`` / ``annotate`` /
  ``timed`` as ``tests/test_debug_profiling.py`` holds the JAX ones.
"""

import dataclasses
import os

import numpy as np
import pytest

import flax.linen as fnn
import jax
import jax.numpy as jnp
import torch

from tpudepth.models import build_model as jax_build_model
from tpudepth.ops import packed as jp
from tpudepth_torch.core.config import TrainConfig
from tpudepth_torch.models.guidedepth import GuidedUpsamplingBlock
from tpudepth_torch.models.layers import BatchNorm, Conv, init_random_
from tpudepth_torch.models.registry import build_model
from tpudepth_torch.ops import packed as tp
from tpudepth_torch.ops.image import resize_bilinear
from tpudepth_torch.train import trainer as ttr
from tpudepth_torch.utils.debug import checkify_nan_step, nan_debug_mode
from tpudepth_torch.utils.profiling import annotate, timed, trace

from torch_port_helpers import one_torch_thread, torch_one_thread  # noqa: F401

BLOCKS = [2, 4, (2, 4), (4, 8)]


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


# -- ops/packed.py against the JAX package -----------------------------------

@pytest.mark.parametrize("block", BLOCKS, ids=str)
def test_space_to_depth_layout_and_round_trip(block):
    x = np.random.default_rng(0).standard_normal((2, 16, 24, 5)).astype(
        np.float32)
    got = tp.space_to_depth(_nchw(x), block)
    want = np.asarray(jp.space_to_depth(jnp.asarray(x), block))
    np.testing.assert_array_equal(_nhwc(got), want)
    by, bx = tp.block_pair(block)
    xn = x.transpose(0, 3, 1, 2)
    for sy in range(by):   # packed channel (sy*bx + sx)*C + c
        for sx in range(bx):
            for c in range(5):
                np.testing.assert_array_equal(
                    got[:, (sy * bx + sx) * 5 + c].numpy(),
                    xn[:, c, sy::by, sx::bx])
    assert torch.equal(tp.depth_to_space(got, block), _nchw(x))
    np.testing.assert_array_equal(
        _nhwc(tp.depth_to_space(_nchw(want), block)),
        np.asarray(jp.depth_to_space(jnp.asarray(want), block)))


@pytest.mark.parametrize("block", BLOCKS, ids=str)
@pytest.mark.parametrize("k", [1, 3])
def test_pack_conv_kernel_equals_the_jax_packed_kernel(k, block):
    rng = np.random.default_rng(1)
    w = rng.standard_normal((k, k, 6, 4)).astype(np.float32)   # HWIO
    want, pads = jp.pack_conv_kernel(jnp.asarray(w), block)
    got, got_pads = tp.pack_conv_kernel(torch.from_numpy(w).permute(3, 2, 0, 1),
                                        block)
    assert got_pads == tuple(pads)
    np.testing.assert_array_equal(got.permute(2, 3, 1, 0).numpy(),
                                  np.asarray(want))
    # a plain concat of packed parts of 2 and 4 channels: the kernel's input
    # rows re-indexed as tpudepth/models/layers.py:105-108 does
    q = jp.concat_input_perm((2, 4), block)
    got, _ = tp.pack_conv_kernel(torch.from_numpy(w).permute(3, 2, 0, 1),
                                 block, input_splits=(2, 4))
    np.testing.assert_array_equal(got.permute(2, 3, 1, 0).numpy(),
                                  np.asarray(want)[:, :, np.argsort(q), :])


@pytest.mark.parametrize("block", BLOCKS, ids=str)
@pytest.mark.parametrize("k", [1, 3])
def test_pack_conv_kernel_indexes_each_weight_b2_times_and_no_zero(k, block):
    """The packed kernel puts ``b2`` copies of each weight in place and
    indexes none of its zeros: the gradient of the gather sums ``b2``
    entries an index. (Gathering the zeros from one extra slot gave that
    slot 15/16 of a 256-channel kernel's entries to sum in its backward:
    141 ms a train step on the H100.)"""
    b2 = tp.block_total(block)
    pos, src = tp._pack_pairs_on(k, *tp.block_pair(block), 6, 4, (2, 4),
                                 torch.device("cpu"))
    assert torch.equal(torch.bincount(src, minlength=6 * 4 * k * k),
                       torch.full((6 * 4 * k * k,), b2))
    assert len(set(pos.tolist())) == len(pos) == b2 * 6 * 4 * k * k


@pytest.mark.parametrize("block", BLOCKS, ids=str)
def test_concat_helpers_and_channel_mean_equal_the_jax_ones(block):
    rng = np.random.default_rng(2)
    a = rng.random((2, 8, 16, 4)).astype(np.float32)
    b = rng.random((2, 8, 16, 6)).astype(np.float32)
    np.testing.assert_array_equal(tp.concat_input_perm((4, 6), block),
                                  jp.concat_input_perm((4, 6), block))
    pa, pb = (tp.space_to_depth(_nchw(t), block) for t in (a, b))
    np.testing.assert_array_equal(
        _nhwc(tp.packed_concat([pa, pb], block)),
        np.asarray(jp.packed_concat(
            [jp.space_to_depth(jnp.asarray(t), block) for t in (a, b)],
            block)))
    np.testing.assert_allclose(
        tp.packed_channel_mean(pa, block).numpy(),
        np.asarray(jp.packed_channel_mean(jp.space_to_depth(
            jnp.asarray(a), block), block)), atol=1e-6)
    np.testing.assert_allclose(tp.packed_channel_mean(pa, block).numpy(),
                               a.mean(axis=(1, 2)), atol=1e-6)
    v = np.arange(4.0, dtype=np.float32)
    np.testing.assert_array_equal(
        tp.tile_channel(torch.from_numpy(v), block).numpy(),
        np.asarray(jp.tile_channel(jnp.asarray(v), block)))


@pytest.mark.parametrize("block", BLOCKS, ids=str)
def test_upsample2x_pack_matches_the_jax_one_and_the_resize(block):
    x = np.random.default_rng(3).random((2, 8, 16, 5)).astype(np.float32)
    got = tp.upsample2x_pack(_nchw(x), block)
    np.testing.assert_allclose(
        _nhwc(got), np.asarray(jp.upsample2x_pack(jnp.asarray(x), block)),
        atol=1e-6)
    ref = tp.space_to_depth(resize_bilinear(_nchw(x), (16, 32)), block)
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=0)


# -- Conv and BatchNorm, packed against unpacked ---------------------------

@pytest.mark.parametrize("block", [2, (2, 4)], ids=str)
@pytest.mark.parametrize("k", [1, 3])
def test_packed_conv_equals_the_unpacked_conv(k, block):
    torch.manual_seed(0)
    conv = init_random_(Conv(8, 6, k, padding=k // 2), 4)
    a, b = torch.rand(2, 3, 16, 24), torch.rand(2, 5, 16, 24)
    want = conv(torch.cat([a, b], 1))
    # a plain concat of the packed parts
    xp = torch.cat([tp.space_to_depth(a, block), tp.space_to_depth(b, block)],
                   1)
    got = tp.depth_to_space(conv(xp, block, input_splits=(3, 5)), block)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    got = tp.depth_to_space(conv(tp.space_to_depth(torch.cat([a, b], 1),
                                                   block), block), block)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    # the gradient reaches the unpacked weight
    got.square().sum().backward()
    assert conv.weight.grad is not None and conv.weight.grad.abs().max() > 0
    with pytest.raises(ValueError, match="stride 1"):
        Conv(8, 6, 3, stride=2, padding=1)(torch.rand(1, 32, 4, 4), block)


def _bn_pair(block):
    torch.manual_seed(0)
    plain, packed = (init_random_(BatchNorm(5), 6) for _ in range(2))
    x = torch.rand(2, 5, 16, 24) * 2.0 - 0.3
    return plain, packed, x, tp.space_to_depth(x, block)


@pytest.mark.parametrize("block", [2, (2, 4), 4], ids=str)
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_packed_batchnorm_equals_the_unpacked_one(block, train):
    plain, packed, x, xp = _bn_pair(block)
    plain.train(train)
    packed.train(train)
    want = plain(x)
    got = tp.depth_to_space(packed(xp, block), block)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    for name in ("running_mean", "running_var"):
        torch.testing.assert_close(getattr(packed, name),
                                   getattr(plain, name), atol=1e-5, rtol=0)
    assert {k: v.shape for k, v in packed.state_dict().items()} == {
        k: v.shape for k, v in plain.state_dict().items()}


@pytest.mark.parametrize("block", [2, (2, 4)], ids=str)
def test_train_affine_folds_the_packed_sums_and_tensors(block):
    plain, packed, x, xp = _bn_pair(block)
    n = float(x.shape[0] * x.shape[2] * x.shape[3])
    want = plain.train_affine(sums=(x.sum(dim=(0, 2, 3)),
                                    (x * x).sum(dim=(0, 2, 3)), n))
    got = packed.train_affine(sums=(xp.sum(dim=(0, 2, 3)),
                                    (xp * xp).sum(dim=(0, 2, 3)), n),
                              block=block)
    for g, w in zip(got, want):
        assert g.shape == (5,)
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
    again = packed.train_affine(xp, block=block)
    for g, w in zip(again, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
    for name in ("running_mean", "running_var"):
        # moved twice (two calls) against once: compare the first move
        assert not torch.equal(getattr(packed, name), getattr(plain, name))
    _, fresh, _, _ = _bn_pair(block)
    fresh.train_affine(sums=(xp.sum(dim=(0, 2, 3)),
                             (xp * xp).sum(dim=(0, 2, 3)), n), block=block)
    for name in ("running_mean", "running_var"):
        torch.testing.assert_close(getattr(fresh, name), getattr(plain, name),
                                   atol=1e-6, rtol=0)


# -- the per-stage blocks against the JAX GuideDepth ------------------------

def _jax_blocks(monkeypatch, name, hw, **options):
    """The block each GUB stage of the JAX ``GuideDepth`` gets, read from an
    abstract trace of its ``init`` with the backbone and the blocks
    stubbed (shapes only)."""
    import tpudepth.models.guidedepth as jgd

    seen = []

    class Backbone(fnn.Module):
        features: int
        dtype: object = None

        @fnn.compact
        def __call__(self, x, train):
            b, h, w, _ = x.shape
            return jnp.zeros((b, h // 8, w // 8, self.features), x.dtype)

    class Block(jgd.GuidedUpsamplingBlock):
        @fnn.compact
        def __call__(self, guide, depth, train=False, packed=0):
            seen.append(tuple(packed) if packed else None)
            b2 = jp.block_total(packed) if packed else 1
            return jnp.zeros((*depth.shape[:-1], b2 * self.out_features),
                             depth.dtype)

    monkeypatch.setattr(jgd, "DualResNetBackbone", Backbone)
    monkeypatch.setattr(jgd, "GuidedUpsamplingBlock", Block)
    model = jax_build_model(name, **options)
    jax.eval_shape(lambda x: model.init(jax.random.PRNGKey(0), x),
                   jnp.zeros((1, *hw, 3), jnp.float32))
    assert len(seen) == 3
    return seen


@pytest.mark.parametrize("hw", [(96, 128), (240, 320), (480, 640),
                                (100, 136)], ids=lambda hw: "x".join(map(str, hw)))
@pytest.mark.parametrize("name", ["GuideDepth", "GuideDepth-S"])
def test_stage_blocks_are_the_jax_package_choice(monkeypatch, name, hw):
    port = build_model(name, packed=True)
    assert port.stage_blocks(*hw) == _jax_blocks(monkeypatch, name, hw)
    assert build_model(name).stage_blocks(*hw) == [None] * 3


@pytest.mark.parametrize("options", [
    {"packed_blocks": ((8, 8), None, (4, 8))},     # stage 1's guide: 60x80
    {"packed_blocks": ((2, 4), (4, 8), (8, 8))},
    {"packed_max_channels": 64, "packed_block4_max_channels": 128}],
    ids=["override-undivided", "override", "thresholds"])
def test_stage_blocks_follow_the_overrides_as_jax_does(monkeypatch, options):
    port = build_model("GuideDepth-S", packed=True, **options)
    assert port.stage_blocks(240, 320) == _jax_blocks(
        monkeypatch, "GuideDepth-S", (240, 320), **options)


def test_build_model_takes_the_options_for_the_guidedepth_family_only():
    m = build_model("guidedepth_s", packed=True, remat_stages=True,
                    packed_blocks=((2, 4), None, None))
    assert m.packed and m.remat_stages and m.packed_blocks[0] == (2, 4)
    with pytest.raises(ValueError, match="GuideDepth family"):
        build_model("unet_interp_small", packed=True)
    with pytest.raises(TypeError, match="unknown build_model options"):
        build_model("GuideDepth", pack=True)


def test_packed_model_keeps_the_unpacked_parameters():
    plain = build_model("GuideDepth-S").state_dict()
    packed = build_model("GuideDepth-S", gub="fused", packed=True).state_dict()
    assert {k: v.shape for k, v in packed.items()} == {
        k: v.shape for k, v in plain.items()}


# -- train mode: packed against unpacked in float64 --------------------------

def _gub_train(fused, block):
    """Output, gradients (parameters, guide, depth) and running statistics
    of one float64 train-mode forward and backward of a seeded GUB."""
    gub = init_random_(GuidedUpsamplingBlock(16, 16, 8, fused=fused),
                       3).double().train()
    gen = torch.Generator().manual_seed(1)
    g = torch.rand(2, 3, 16, 24, dtype=torch.float64, generator=gen)
    d = torch.rand(2, 16, 16, 24, dtype=torch.float64, generator=gen)
    g.requires_grad_(True)
    d.requires_grad_(True)
    if block is None:
        out = gub(g, d)
    else:
        out = tp.depth_to_space(gub(tp.space_to_depth(g, block),
                                    tp.space_to_depth(d, block), block), block)
    (out.square().mean() + 0.1 * out.abs().mean()).backward()
    grads = {n: p.grad for n, p in gub.named_parameters()}
    grads.update(guide=g.grad, depth=d.grad)
    stats = {k: v for k, v in gub.state_dict().items() if "running" in k}
    return out.detach(), grads, stats


@pytest.fixture(scope="module")
def unpacked_gub_train():
    with one_torch_thread():
        return _gub_train(False, None)


@pytest.mark.parametrize("block", [(2, 2), (4, 4), (2, 4)], ids=str)
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_packed_gub_train_mode_equals_unpacked_in_float64(
        unpacked_gub_train, fused, block):
    """Relative 1e-10: packed and unpacked sum the same float64 products in
    other orders. A gradient is held against its tensor's largest, under a
    floor of 1e-4 of the largest of all (the conv biases in front of a
    BatchNorm have an analytic gradient of 0 and hold rounding noise of
    float64's eps times the largest gradient)."""
    y0, g0, s0 = unpacked_gub_train
    y, g, s = _gub_train(fused, block)
    assert float(y0.std()) > 1e-2
    assert float((y - y0).abs().max()) <= 1e-10 * float(y0.abs().max())
    assert set(g) == set(g0)
    floor = 1e-4 * max(float(t.abs().max()) for t in g0.values())
    for n, t in g.items():
        scale = max(float(g0[n].abs().max()), floor)
        assert float((t - g0[n]).abs().max()) <= 1e-10 * scale, n
    assert set(s) == set(s0) and len(s) == 12
    for k, v in s.items():
        assert float((v - s0[k]).abs().max()) <= 1e-10 * float(
            s0[k].abs().max()), k


# -- rematerialization -----------------------------------------------------

def _step(options, remat):
    """One float64 alhashim step of a seeded GuideDepth-S at 64x96, B 2:
    loss, every parameter gradient, and the BatchNorm statistics after it."""
    model = init_random_(build_model("GuideDepth-S", **options), 7).double()
    cfg = TrainConfig(learning_rate=1e-3)
    state = ttr.TrainState(model, ttr.make_optimizer(cfg, model.parameters()))
    recipe = ttr.LossRecipe(kind="alhashim", max_depth=10.0, depth_scale=10.0)
    step = ttr.make_train_step(model, recipe, ttr.step_lr(1e-3, 15, 0.1, 10),
                               compute_dtype=torch.float64, augment=False,
                               remat=remat)
    rng = np.random.default_rng(8)
    image = torch.from_numpy(rng.random((2, 64, 96, 3)))
    depth = torch.from_numpy(rng.uniform(0.05, 1.0, (2, 64, 96, 1)))
    loss = step(state, image, depth)
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if "running" in k}
    return loss, {n: p.grad for n, p in model.named_parameters()}, stats


REMAT_CASES = {
    "whole-forward": ({"packed": True}, True),
    "stages-plain": ({"packed": True, "remat_stages": True}, False),
    "stages-fused": ({"packed": True, "gub": "fused", "remat_stages": True},
                     False),
}


@pytest.fixture(scope="module")
def plain_steps():
    with one_torch_thread():
        return {gub: _step({"packed": True, "gub": gub}, False)
                for gub in ("plain", "fused")}


@pytest.mark.parametrize("case", list(REMAT_CASES))
def test_rematerialized_step_equals_the_plain_step(plain_steps, case):
    options, remat = REMAT_CASES[case]
    loss0, g0, s0 = plain_steps[options.get("gub", "plain")]
    loss, g, s = _step(options, remat)
    assert abs(float(loss) - float(loss0)) <= 1e-12 * abs(float(loss0))
    assert set(g) == set(g0)
    for n, t in g.items():
        torch.testing.assert_close(t, g0[n], rtol=1e-12, atol=0, msg=n)
    # the running statistics moved, and moved once: equal to the plain
    # step's, which the recomputation would have moved a second time
    before = init_random_(build_model("GuideDepth-S"), 7).state_dict()
    assert set(s) == set(s0)
    for k, v in s.items():
        assert torch.equal(v, s0[k]), k
    assert not torch.equal(s["up_3.feature_conv.1.running_mean"],
                           before["up_3.feature_conv.1.running_mean"].double())


def test_trainer_passes_the_remat_knobs(monkeypatch):
    seen = {}
    make = ttr.make_train_step

    def spy(*args, **kwargs):
        seen.update(kwargs)
        return make(*args, **kwargs)

    monkeypatch.setattr(ttr, "make_train_step", spy)
    cfg = TrainConfig(model="guidedepth_s", remat=True, remat_stages=True)
    tr = ttr.Trainer(cfg, device="cpu")
    assert tr.model.remat_stages and not tr.model.packed
    tr.init_state()
    assert seen["remat"] is True
    # outside the GuideDepth family remat_stages builds the model as it is
    other = ttr.Trainer(dataclasses.replace(cfg, model="unet_interp_small"),
                        device="cpu")
    assert not hasattr(other.model, "remat_stages")
    assert not ttr.Trainer(TrainConfig(model="GuideDepth-S"),
                           device="cpu").model.remat_stages


# -- debug and trace helpers ------------------------------------------------

def test_nan_debug_mode_restores_the_anomaly_flag():
    before = torch.is_anomaly_enabled()
    with nan_debug_mode():
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    assert torch.is_anomaly_enabled() == before


def test_checkify_nan_step_raises_on_a_non_finite_output():
    checked = checkify_nan_step(lambda x: (torch.log(x), {"n": x.sum()}))
    out = checked(torch.tensor([1.0, 2.0]))
    assert torch.isfinite(out[0]).all()
    with pytest.raises(FloatingPointError, match="nan"):
        checked(torch.tensor([-1.0]))
    with pytest.raises(FloatingPointError, match="output 1"):
        checked(torch.tensor([3e38, 3e38]))   # a finite log, an inf sum


def test_timed_trace_and_annotate(tmp_path):
    out, dt = timed(lambda x: x * 2, torch.ones(8, 8))
    assert dt > 0 and torch.equal(out, torch.full((8, 8), 2.0))
    with trace(str(tmp_path / "trace")) as prof:
        with annotate("packed-step"):
            torch.ones(4).add_(1)
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    assert (tmp_path / "trace" / files[0]).stat().st_size > 0
    assert "packed-step" in {e.key for e in prof.key_averages()}


def test_a_packed_conv_trains_after_serving_in_inference_mode():
    """The packed kernel's index is cached per shape; made during a served
    call (``torch.inference_mode``) it must still serve a train step's
    backward. A conv shape no other test packs, so the cache starts empty."""
    conv = init_random_(Conv(7, 5, 3, padding=1), 9)
    x = torch.rand(1, 7 * 8, 4, 6)
    with torch.inference_mode():
        served = conv(x, (2, 4))
    trained = conv(x, (2, 4))
    trained.square().sum().backward()
    assert torch.equal(served, trained.detach())
    assert conv.weight.grad.abs().max() > 0


@pytest.mark.parametrize("block", [(2, 2), (4, 4)], ids=str)
def test_upsample2x_pack_is_nhwc_in_memory_in_an_exported_program(block):
    """The fused GUB kernels take contiguous NHWC parts. ``nhwc`` makes a
    copy only where its input is not one, and an exported program keeps
    the copies its trace needed: the packed upsampling must be laid out
    alike in the trace and at run time (computed on NCHW lines it was not
    at (4, 4), and a deserialized packed fused engine refused its input)."""
    from tpudepth_torch.ops.image import nhwc

    class Stage(torch.nn.Module):
        def forward(self, y):
            return nhwc(tp.upsample2x_pack(tp.depth_to_space(y, 2), block))

    y = torch.rand(1, 64, 12, 16).contiguous(memory_format=torch.channels_last)
    want = Stage()(y)
    got = torch.export.export(Stage(), (y,), strict=False).module()(y)
    assert got.is_contiguous() and torch.equal(got, want)
