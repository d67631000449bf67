"""Port MobileV3NewCRFDepth (tpudepth_torch) against the JAX package, on the
CPU: the CRF block (unshifted and shifted) and the NewCRF stage in the five
block modes, the whole model, the JAX package's own row-kernel, fused and
whole-block glue, the weight bridge, the guards, the registry and the CLI.

The same weights feed both packages: a port module filled by
``init_random_`` and carried to JAX by ``tpudepth.models.torch_import``, or
the JAX model's own tree filled from a numpy seed and carried to the port by
``newcrf_state_dict_from_flax``. On the CPU the port's kernel wrappers run
their plain versions, so the ``row``, ``fused``, ``pair`` and ``block``
modes hold the glue around the kernels (padding, the roll and its mask,
windows, the crop, the order of the residuals). Tolerance: rtol 1e-3, atol 1e-4 in f32 (what
``tests/test_models.py`` holds the JAX model to against the reference
PyTorch model).
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn as nn

import tpudepth.models.newcrf as jax_newcrf
import tpudepth.ops.pallas.block_infer as jax_bi
import tpudepth.ops.pallas.epilogue_infer as jax_ei
import tpudepth.ops.pallas.rowblock_infer as jax_rbi
from tpudepth.models import build_model as jax_build_model
from tpudepth.models.torch_import import (
    _Builder,
    _newcrf_stage,
    convert_attention_model,
    state_dict_to_numpy,
)
from torch_port_helpers import (
    check_train_mode_against_plain,
    train_plain_reference,
)
from tpudepth_torch.models.jax_weights import newcrf_state_dict_from_flax
from tpudepth_torch.models.layers import init_random_
from tpudepth_torch.models.newcrf import NewCRF
from tpudepth_torch.models.registry import build_model
from tpudepth_torch.ops import window as port_window

RTOL, ATOL = 1e-3, 1e-4
HW = (64, 96)
MODES = ["plain", "pair", "fused", "row", "block"]
SHIFTS = [0, 3]


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


# -- the CRF block and the stage ------------------------------------------------

STAGE = dict(input_dim=24, embed_dim=64, v_dim=32, num_heads=2)


class _Holder(nn.Module):
    def __init__(self, mode):
        super().__init__()
        self.s = NewCRF(**STAGE, mode=mode)


@pytest.fixture(scope="module")
def stage():
    """A seeded port NewCRF stage (C 64, 2 heads), its JAX variables, and
    inputs on a 10x12 map (padded to 14x14: 4 windows, 72 pad tokens, which
    the shifted block's roll moves inside the map)."""
    port = init_random_(_Holder("plain"), seed=31).eval()
    b = _Builder(state_dict_to_numpy(port.state_dict()))
    _newcrf_stage(b, "s", "s", True, True)
    params = b.variables()["params"]["s"]
    rng = np.random.default_rng(32)
    e = rng.standard_normal((2, 10, 12, STAGE["input_dim"])).astype(np.float32)
    q = rng.standard_normal((2, 10, 12, STAGE["v_dim"])).astype(np.float32)
    # the blocks' own inputs: the unary and the values after the projections
    x = rng.standard_normal((2, 10, 12, 64)).astype(np.float32)
    v = rng.standard_normal((2, 10, 12, 64)).astype(np.float32)
    return port.state_dict(), params, (e, q), (x, v)


def _port_stage(state, mode):
    h = _Holder(mode)
    h.load_state_dict(state)
    return h.s.eval()


def _jax_block(params, shift, x, v):
    blk = jax_newcrf.CRFBlock(64, 2, 7, shift_size=shift)
    i = 1 if shift else 0
    return np.asarray(blk.apply({"params": params[f"block{i}"]},
                                jnp.asarray(x), jnp.asarray(v)))


def _port_block(state, mode, shift, x, v):
    blk = _port_stage(state, mode).crf_layer.blocks[1 if shift else 0]
    assert blk.shift_size == shift
    with torch.no_grad():
        return blk(torch.from_numpy(x), torch.from_numpy(v)).numpy()


@pytest.mark.parametrize("shift", SHIFTS, ids=["shift0", "shift3"])
@pytest.mark.parametrize("mode", MODES)
def test_crf_block_matches_jax(stage, mode, shift):
    state, params, _, (x, v) = stage
    want = _jax_block(params, shift, x, v)
    got = _port_block(state, mode, shift, x, v)
    assert np.std(want) > 1e-2
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shift", SHIFTS, ids=["shift0", "shift3"])
def test_crf_block_row_glue_matches_the_jax_row_glue(stage, shift,
                                                     monkeypatch):
    """JAX's own window-row path (pad, roll, the row kernel in interpret
    mode, unroll, crop) against the port's ``row`` mode."""
    state, params, _, (x, v) = stage
    monkeypatch.setattr(jax_newcrf.CRFBlock, "_use_rowblock",
                        lambda self, c, w: True)
    monkeypatch.setattr(jax_rbi, "crf_rowblock_infer",
                        functools.partial(jax_rbi.crf_rowblock_infer,
                                          interpret=True))
    want = _jax_block(params, shift, x, v)
    got = _port_block(state, "row", shift, x, v)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shift", SHIFTS, ids=["shift0", "shift3"])
def test_crf_block_fused_glue_matches_the_jax_fused_glue(stage, shift,
                                                         monkeypatch):
    """JAX's own fused tail (proj skipped in the attention, epilogue kernel
    in interpret mode on the unrolled, cropped rows) against the port's."""
    state, params, _, (x, v) = stage
    monkeypatch.setattr(jax_newcrf.CRFBlock, "_use_fused_epilogue",
                        lambda self, m, c: True)
    monkeypatch.setattr(jax_ei, "block_epilogue_infer",
                        functools.partial(jax_ei.block_epilogue_infer,
                                          interpret=True))
    # 2*10*12 = 240 rows: a multiple of 8, which the JAX kernel's tiles need
    want = _jax_block(params, shift, x, v)
    got = _port_block(state, "fused", shift, x, v)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shift", SHIFTS, ids=["shift0", "shift3"])
def test_crf_block_whole_block_glue_matches_the_jax_fused_block_glue(
        stage, shift, monkeypatch):
    """JAX's own whole-block path (``TPUDEPTH_BLOCK=fused``: pad, roll, the
    shift mask and the rolled valid table, windows, the block kernel in
    interpret mode, reverse, unroll, crop) against the port's ``block``
    mode."""
    state, params, _, (x, v) = stage
    monkeypatch.setattr(jax_newcrf.CRFBlock, "_use_fused_block",
                        lambda self, c: True)
    monkeypatch.setattr(jax_bi, "crf_block_infer",
                        functools.partial(jax_bi.crf_block_infer,
                                          interpret=True))
    want = _jax_block(params, shift, x, v)
    got = _port_block(state, "block", shift, x, v)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", MODES)
def test_newcrf_stage_matches_jax(stage, mode):
    state, params, (e, q), _ = stage
    want = np.asarray(jax_newcrf.NewCRF(**STAGE).apply(
        {"params": params}, jnp.asarray(e), jnp.asarray(q)))
    with torch.no_grad():
        got = _port_stage(state, mode)(_nchw(e), _nchw(q))
    assert got.shape == (2, 64, 10, 12)
    np.testing.assert_allclose(_nhwc(got), want, rtol=RTOL, atol=ATOL)


# -- the whole model and the bridge ----------------------------------------------

def _random_variables(seed):
    """JAX MobileV3NewCRFDepth variables of its own structure, filled from a
    numpy seed: lecun-normal kernels, BatchNorm statistics, scales and
    biases away from (0, 1), LayerNorm scales around 1, bias tables
    N(0, 0.02)."""
    model = jax_build_model("newcrf")
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
    variables = _random_variables(41)
    x = np.random.default_rng(42).random((1, *HW, 3), dtype=np.float32)
    model = jax_build_model("newcrf")
    want = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(
        variables, jnp.asarray(x)))
    return variables, x, want


@pytest.mark.parametrize("mode", MODES)
def test_whole_model_matches_jax(whole, mode):
    variables, x, want = whole
    port = build_model("newcrf", attn=mode)
    port.load_state_dict(newcrf_state_dict_from_flax(variables))
    with torch.no_grad():
        got = port.eval()(_nchw(x))
    assert got.shape == (1, 1, *HW) and got.dtype == torch.float32
    assert np.std(want) > 1e-2  # the comparison is not of a constant
    np.testing.assert_allclose(_nhwc(got), want, rtol=RTOL, atol=ATOL)


def test_bridge_covers_every_leaf_and_entry(whole):
    variables = whole[0]
    sd = newcrf_state_dict_from_flax(variables)
    want = build_model("newcrf").state_dict()
    assert set(sd) == set(want)
    for k, v in want.items():
        assert sd[k].shape == v.shape, k
    n_flax = sum(a.size for a in jax.tree_util.tree_leaves(variables))
    n_port = sum(v.numel() for k, v in sd.items()
                 if not k.endswith("num_batches_tracked"))
    assert n_flax == n_port


def test_bridge_rejects_a_leaf_it_does_not_consume(whole):
    variables = jax.tree_util.tree_map(lambda a: a, whole[0])
    variables["params"]["decoder"]["crf1"]["block1"]["stray"] = np.zeros(
        3, np.float32)
    with pytest.raises(ValueError, match="stray"):
        newcrf_state_dict_from_flax(variables)


def test_bridge_round_trip_through_convert_attention_model(whole):
    variables = whole[0]
    port = build_model("newcrf")
    port.load_state_dict(newcrf_state_dict_from_flax(variables))
    back = convert_attention_model(state_dict_to_numpy(port.state_dict()),
                                   "newcrf")
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
    port = build_model("newcrf")
    attn = port.Unet[1].crf0.crf_layer.blocks[1].attn
    before = attn.bias().clone()
    sd = port.state_dict()
    key = "Unet.1.crf0.crf_layer.blocks.1.attn.relative_position_bias_table"
    sd[key] = torch.randn_like(sd[key])
    port.load_state_dict(sd)
    after = attn.bias()
    assert not torch.equal(before, after)
    idx = torch.from_numpy(port_window.relative_position_index(7)).reshape(-1)
    torch.testing.assert_close(after, sd[key][idx].reshape(49, 49, 4)
                               .permute(2, 0, 1))


def test_model_has_the_published_widths():
    port = build_model("newcrf")
    dec = port.Unet[1]
    assert (dec.conv0.in_channels, dec.conv0.out_channels) == (960, 512)
    for i, (cin, embed, vdim, heads) in enumerate(
            [(24, 128, 64, 4), (40, 256, 128, 8), (112, 512, 256, 16),
             (160, 1024, 512, 32)]):
        s = getattr(dec, f"crf{i}")
        assert (s.proj_x.in_channels, s.proj_x.out_channels) == (cin, embed)
        assert (s.proj_v.in_channels, s.proj_v.out_channels) == (vdim, embed)
        blocks = s.crf_layer.blocks
        assert [b.shift_size for b in blocks] == [0, 3]
        assert blocks[0].attn.num_heads == heads
        assert blocks[0].mlp.fc1.out_features == 4 * embed
        assert all(b.mode == "row" for b in blocks)


# -- guards, the registry and the CLI -----------------------------------------

@pytest.fixture(scope="module")
def trained_plain():
    return train_plain_reference("newcrf")


@pytest.mark.parametrize("mode", MODES)
def test_newcrf_does_not_train(trained_plain, mode):
    """Once a guard that the blocks raised in train mode: now every mode
    trains (both blocks of a stage, the second with the shift mask), and its
    train-mode forward and backward match the ``plain`` mode's."""
    check_train_mode_against_plain(trained_plain, mode)


def test_registry_aliases_and_modes():
    for alias in ("newcrf", "NewCRFs", "mobilev3_newcrf",
                  "MobileV3_Large_NewCRFs"):
        assert type(build_model(alias)).__name__ == "MobileV3NewCRFDepth"
    for mode in MODES:
        blk = build_model("newcrf", attn=mode).Unet[1].crf2.crf_layer.blocks[1]
        assert blk.mode == mode and blk.mlp.kernel == (mode != "plain")
    with pytest.raises(ValueError, match="attn"):
        build_model("newcrf", attn="packed")


def test_cli_parses_newcrf_and_checks_the_mode_against_the_model():
    from tpudepth_torch.inference import get_args, main

    args = get_args(["--model", "newcrf", "--resolution", "full"])
    assert (args.model, args.attn) == ("newcrf", None)
    assert get_args(["--model", "newcrf", "--attn", "fused"]).attn == "fused"
    with pytest.raises(SystemExit):
        get_args(["--attn", "packed"])
    with pytest.raises(SystemExit, match="attn"):
        main(["--model", "GuideDepth", "--attn", "row"])
