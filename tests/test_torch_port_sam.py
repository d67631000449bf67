"""Port MobileV3SAMDepth (tpudepth_torch) against the JAX package, on the CPU:
the window ops, ConvBNAct, MobileNetV3 Large and Small, the SAM block and
stage in the four block modes, the whole model, the JAX package's own fused
and row-kernel glue, the weight bridge, and the guards of what is not
ported.

The same weights feed both packages: the JAX model's own tree filled from a
numpy seed and carried to the port by ``sam_state_dict_from_flax``, or a
port module filled by ``init_random_`` and carried to JAX by
``tpudepth.models.torch_import``. On the CPU the port's kernel wrappers run
their plain versions, so the ``pair`` and ``fused`` modes hold the glue
around the kernels (padding, windows, crop, the order of the residuals).
Tolerance: rtol 1e-3, atol 1e-4 in f32 (what ``tests/test_models.py`` holds
the JAX model to against the reference PyTorch model).
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn as nn

import tpudepth.models.sam as jax_sam
import tpudepth.ops.pallas.epilogue_infer as jax_ei
import tpudepth.ops.pallas.rowblock_infer as jax_rbi
from tpudepth.models import build_model as jax_build_model
from tpudepth.models.layers import ConvBNAct as JaxConvBNAct
from tpudepth.models.mobilenetv3 import MobileNetV3Features as JaxMobileNetV3
from tpudepth.models.torch_import import (
    _Builder,
    _sam_stage,
    convert_attention_model,
    convert_mobilenetv3,
    state_dict_to_numpy,
)
from tpudepth.ops import window as jax_window
from torch_port_helpers import (
    check_train_mode_against_plain,
    train_plain_reference,
)
from tpudepth_torch.models.jax_weights import sam_state_dict_from_flax
from tpudepth_torch.models.layers import ConvBNAct, init_random_
from tpudepth_torch.models.mobilenetv3 import MobileNetV3Features
from tpudepth_torch.models.registry import build_model
from tpudepth_torch.models.sam import SAM
from tpudepth_torch.ops import window as port_window

RTOL, ATOL = 1e-3, 1e-4
HW = (64, 96)
MODES = ["plain", "pair", "fused", "row"]


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


# -- window ops ---------------------------------------------------------------

def test_window_partition_reverse_and_padding_match_jax(rng):
    x = rng.standard_normal((2, 10, 12, 8)).astype(np.float32)
    xp, hp, wp = port_window.pad_to_window_multiple(torch.from_numpy(x), 7)
    jp, jhp, jwp = jax_window.pad_to_window_multiple(jnp.asarray(x), 7)
    assert (hp, wp) == (jhp, jwp) == (14, 14)
    np.testing.assert_array_equal(xp.numpy(), np.asarray(jp))
    win = port_window.window_partition(xp, 7)
    np.testing.assert_array_equal(
        win.numpy(), np.asarray(jax_window.window_partition(jp, 7)))
    back = port_window.window_reverse(win, 7, hp, wp)
    np.testing.assert_array_equal(back.numpy(), xp.numpy())


@pytest.mark.parametrize("h,w,shift", [(14, 21, 3), (10, 12, 3), (15, 20, 0)])
def test_window_masks_and_index_match_jax(h, w, shift):
    np.testing.assert_array_equal(port_window.relative_position_index(7),
                                  jax_window.relative_position_index(7))
    for fn in ("shifted_window_attention_mask", "window_valid_mask"):
        got = getattr(port_window, fn)(h, w, 7, shift)
        want = getattr(jax_window, fn)(h, w, 7, shift)
        if want is None:
            assert got is None, fn
        else:
            np.testing.assert_array_equal(got, want, err_msg=fn)


# -- ConvBNAct and MobileNetV3 --------------------------------------------------

@pytest.mark.parametrize("cin,cout,k,stride,groups,act", [
    (8, 16, 3, 2, 1, "hardswish"), (16, 16, 5, 1, 16, "relu"),
    (16, 24, 1, 1, 1, None)])
def test_conv_bn_act_matches_jax(cin, cout, k, stride, groups, act):
    port = init_random_(ConvBNAct(cin, cout, k, stride, groups=groups, act=act,
                                  bn_eps=1e-3, bn_momentum=0.01), seed=cin + k)
    port.eval()
    b = _Builder(state_dict_to_numpy(port.state_dict()))
    b.conv("c/conv", "0")
    b.bn("c/bn", "1")
    v = b.variables()
    jv = {"params": v["params"]["c"], "batch_stats": v["batch_stats"]["c"]}
    x = np.random.default_rng(1).standard_normal((2, 13, 17, cin)).astype(np.float32)
    want = JaxConvBNAct(cout, k, stride, groups=groups, act=act, bn_eps=1e-3,
                        bn_momentum=0.01).apply(jv, jnp.asarray(x), False)
    with torch.no_grad():
        got = port(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("arch,n_taps", [("large", 18), ("small", 14)])
def test_mobilenetv3_features_match_jax_at_every_tap(arch, n_taps):
    port = init_random_(MobileNetV3Features(arch), seed=3).eval()
    variables = convert_mobilenetv3(state_dict_to_numpy(port.state_dict()),
                                    arch)
    x = np.random.default_rng(2).standard_normal((1, *HW, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: JaxMobileNetV3(arch).apply(v, x, False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(_nchw(x))
    assert len(got) == len(want) == n_taps
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape[2:] == w.shape[1:3], i
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=f"tap {i}")


# -- the SAM block and stage ----------------------------------------------------

STAGE = dict(input_dim=24, embed_dim=64, v_dim=32, num_heads=2)


class _Holder(nn.Module):
    def __init__(self, mode):
        super().__init__()
        self.s = SAM(**STAGE, mode=mode)


@pytest.fixture(scope="module")
def stage():
    """A seeded port SAM stage (C 64, 2 heads), its JAX variables, and
    inputs on a 10x12 map (padded to 14x14: 4 windows, 72 pad tokens)."""
    port = init_random_(_Holder("plain"), seed=11).eval()
    b = _Builder(state_dict_to_numpy(port.state_dict()))
    _sam_stage(b, "s", "s", True, True)
    params = b.variables()["params"]["s"]
    rng = np.random.default_rng(12)
    e = rng.standard_normal((2, 10, 12, STAGE["input_dim"])).astype(np.float32)
    q = rng.standard_normal((2, 10, 12, STAGE["v_dim"])).astype(np.float32)
    # the block's own inputs: what the stage hands it after the projections
    x = rng.standard_normal((2, 10, 12, 64)).astype(np.float32)
    v = rng.standard_normal((2, 10, 12, 64)).astype(np.float32)
    return port.state_dict(), params, (e, q), (x, v)


def _port_stage(state, mode):
    h = _Holder(mode)
    h.load_state_dict(state)
    return h.s.eval()


def _jax_block(params, x, v):
    blk = jax_sam.SAMBlock(64, 2, 7)
    return np.asarray(blk.apply({"params": params["sam_block"]},
                                jnp.asarray(x), jnp.asarray(v)))


@pytest.mark.parametrize("mode", MODES)
def test_sam_block_matches_jax(stage, mode):
    state, params, _, (x, v) = stage
    want = _jax_block(params, x, v)
    blk = _port_stage(state, mode).sam_block
    with torch.no_grad():
        got = blk(torch.from_numpy(x), torch.from_numpy(v)).numpy()
    assert np.std(want) > 1e-2
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_sam_block_fused_glue_matches_the_jax_fused_glue(stage, monkeypatch):
    """JAX's own fused tail (proj skipped in the attention, epilogue kernel
    in interpret mode on the cropped rows) against the port's."""
    state, params, _, (x, v) = stage
    monkeypatch.setattr(jax_sam.SAMBlock, "_use_fused_epilogue",
                        lambda self, m, c: True)
    monkeypatch.setattr(jax_ei, "block_epilogue_infer",
                        functools.partial(jax_ei.block_epilogue_infer,
                                          interpret=True))
    # 2*10*12 = 240 rows: a multiple of 8, which the JAX kernel's tiles need
    want = _jax_block(params, x, v)
    blk = _port_stage(state, "fused").sam_block
    with torch.no_grad():
        got = blk(torch.from_numpy(x), torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_sam_block_row_glue_matches_the_jax_row_glue(stage, monkeypatch):
    """JAX's own window-row path (pad, the row kernel in interpret mode,
    crop) against the port's ``row`` mode."""
    state, params, _, (x, v) = stage
    monkeypatch.setattr(jax_sam.SAMBlock, "_use_rowblock",
                        lambda self, c, w: True)
    monkeypatch.setattr(jax_rbi, "sam_rowblock_infer",
                        functools.partial(jax_rbi.sam_rowblock_infer,
                                          interpret=True))
    want = _jax_block(params, x, v)
    blk = _port_stage(state, "row").sam_block
    with torch.no_grad():
        got = blk(torch.from_numpy(x), torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", MODES)
def test_sam_stage_matches_jax(stage, mode):
    state, params, (e, q), _ = stage
    want = np.asarray(jax_sam.SAM(**STAGE).apply(
        {"params": params}, jnp.asarray(e), jnp.asarray(q)))
    with torch.no_grad():
        got = _port_stage(state, mode)(_nchw(e), _nchw(q))
    np.testing.assert_allclose(_nhwc(got), want, rtol=RTOL, atol=ATOL)


# -- the whole model and the bridge ----------------------------------------------

def _random_variables(seed):
    """JAX MobileV3SAMDepth variables of its own structure, filled from a
    numpy seed: lecun-normal kernels, BatchNorm statistics, scales and
    biases away from (0, 1), LayerNorm scales around 1, bias tables
    N(0, 0.02)."""
    model = jax_build_model("sam")
    shapes = jax.eval_shape(lambda k, x: model.init(k, x, train=False),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, *HW, 3), jnp.float32))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        key = jax.tree_util.keystr(path)
        shape = leaf.shape
        if key.endswith("['kernel']"):
            arr = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif key.endswith("['relative_position_bias_table']"):
            arr = 0.02 * rng.standard_normal(shape)
        elif key.endswith("['mean']"):
            arr = 0.1 * rng.standard_normal(shape)
        elif key.endswith("['var']") or key.endswith("['scale']"):
            arr = rng.uniform(0.5, 1.5, shape)
        else:
            assert key.endswith("['bias']"), key
            arr = 0.05 * rng.standard_normal(shape)
        return arr.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def whole():
    """JAX variables, a 1x64x96 image and JAX's eval output (every stage
    pads: 2x3, 4x6, 8x12 and 16x24 maps)."""
    variables = _random_variables(21)
    x = np.random.default_rng(22).random((1, *HW, 3), dtype=np.float32)
    model = jax_build_model("sam")
    want = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(
        variables, jnp.asarray(x)))
    return variables, x, want


@pytest.mark.parametrize("mode", MODES)
def test_whole_model_matches_jax(whole, mode):
    variables, x, want = whole
    port = build_model("sam", attn=mode)
    port.load_state_dict(sam_state_dict_from_flax(variables))
    with torch.no_grad():
        got = port.eval()(_nchw(x))
    assert got.shape == (1, 1, *HW) and got.dtype == torch.float32
    assert np.std(want) > 1e-2  # the comparison is not of a constant
    np.testing.assert_allclose(_nhwc(got), want, rtol=RTOL, atol=ATOL)


def test_bridge_covers_every_leaf_and_entry(whole):
    variables = whole[0]
    sd = sam_state_dict_from_flax(variables)
    want = build_model("sam").state_dict()
    assert set(sd) == set(want)
    for k, v in want.items():
        assert sd[k].shape == v.shape, k
    n_flax = sum(a.size for a in jax.tree_util.tree_leaves(variables))
    n_port = sum(v.numel() for k, v in sd.items()
                 if not k.endswith("num_batches_tracked"))
    assert n_flax == n_port


def test_bridge_rejects_a_leaf_it_does_not_consume(whole):
    variables = jax.tree_util.tree_map(lambda a: a, whole[0])
    variables["params"]["decoder"]["crf2"]["stray"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="stray"):
        sam_state_dict_from_flax(variables)


def test_bridge_round_trip_through_convert_attention_model(whole):
    variables = whole[0]
    port = build_model("sam")
    port.load_state_dict(sam_state_dict_from_flax(variables))
    back = convert_attention_model(state_dict_to_numpy(port.state_dict()),
                                   "sam")
    want = {jax.tree_util.keystr(k): v
            for k, v in jax.tree_util.tree_leaves_with_path(variables)}
    got = {jax.tree_util.keystr(k): v
           for k, v in jax.tree_util.tree_leaves_with_path(back)}
    assert set(want) == set(got)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)


def test_bias_follows_load_state_dict():
    """The block gathers its bias from the table on every call: loading new
    weights changes it (no stale cache)."""
    port = build_model("sam")
    attn = port.Unet[1].crf0.sam_block.attn
    before = attn.bias().clone()
    sd = port.state_dict()
    key = "Unet.1.crf0.sam_block.attn.relative_position_bias_table"
    sd[key] = torch.randn_like(sd[key])
    port.load_state_dict(sd)
    after = attn.bias()
    assert not torch.equal(before, after)
    idx = torch.from_numpy(port_window.relative_position_index(7)).reshape(-1)
    torch.testing.assert_close(after, sd[key][idx].reshape(49, 49, 4)
                               .permute(2, 0, 1))


def test_seeded_model_is_not_degenerate():
    port = init_random_(build_model("sam"), seed=0).eval()
    blk = port.Unet[1].crf3.sam_block
    assert float(blk.norm1.weight.detach().std()) > 0.1
    table = blk.attn.relative_position_bias_table.detach()
    assert 0.01 < float(table.std()) < 0.03 and float(table.abs().max()) <= 0.04
    with torch.no_grad():
        y = port(torch.rand(1, 3, *HW, generator=torch.Generator().manual_seed(0)))
    assert float(y.std()) > 1e-2 and bool(((y > 0) & (y < 1)).all())


# -- guards -------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained_plain():
    return train_plain_reference("sam")


@pytest.mark.parametrize("mode", MODES)
def test_sam_does_not_train(trained_plain, mode):
    """Once a guard that the blocks raised in train mode: now every mode
    trains, and its train-mode forward and backward match the ``plain``
    mode's."""
    check_train_mode_against_plain(trained_plain, mode)


def test_newcrf_is_not_ported_and_modes_are_checked():
    """Once a guard that NewCRF raised: NewCRF now builds in each of its
    modes, a name still to port raises with ROADMAP, and a mode a model
    lacks raises ``ValueError``."""
    for mode in ("row", "fused", "pair", "plain"):
        model = build_model("newcrf", attn=mode)
        assert type(model).__name__ == "MobileV3NewCRFDepth"
        assert model.Unet[1].crf3.crf_layer.blocks[0].mode == mode
    assert build_model("newcrf").Unet[1].crf0.crf_layer.blocks[1].mode == "row"
    assert build_model("sam").Unet[1].crf0.sam_block.mode == "fused"
    assert build_model("sam", attn="row").Unet[1].crf0.sam_block.mode == "row"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model("densedepth")
    with pytest.raises(ValueError, match="attn"):
        build_model("sam", attn="packed")
    with pytest.raises(ValueError, match="attn"):
        build_model("GuideDepth", attn="row")
    for alias in ("mobilev3_sam", "MobileV3_Large_SAM"):
        assert type(build_model(alias)).__name__ == "MobileV3SAMDepth"


def test_cli_parses_sam_and_attn():
    from tpudepth_torch.inference import get_args

    args = get_args(["--model", "sam", "--attn", "pair", "--resolution",
                     "full"])
    assert (args.model, args.attn, args.resolution) == ("sam", "pair", "full")
    assert get_args([]).attn is None   # each model's own default
    assert get_args(["--model", "sam", "--attn", "row"]).attn == "row"
    with pytest.raises(SystemExit):
        get_args(["--attn", "packed"])
