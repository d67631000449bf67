"""NewCRF's padded stage chain (the port's ``row`` mode in eval; JAX's
``TPUDEPTH_STAGE_CHAIN=on``, ``tpudepth/models/newcrf.py:357-373``) on the
CPU, where the row kernel runs its plain version in f32.

The chained stage pads x and v once, hands each block the previous block's
padded output (its pad positions no longer zero) and crops once; the row
kernel zeroes LN(x) at the pad tokens by select, so the chained stage equals
its blocks run one by one, each padded and cropped on its own, bit for bit.
Off the TPU the JAX package never chains (its row path is gated on
``default_backend() == 'tpu'``, ``tpudepth/models/newcrf.py:214-215``), so
the JAX side here is its unchained stage, at the bridge's rtol 1e-3 /
atol 1e-4.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch
import torch.nn as nn

import tpudepth.models.newcrf as jax_newcrf
from tpudepth.models.torch_import import (
    _Builder,
    _newcrf_stage,
    state_dict_to_numpy,
)
from torch_port_helpers import (  # noqa: F401
    blocks_one_by_one,
    chained_blocks,
    torch_one_thread,
)
from tpudepth_torch.models.layers import init_random_
from tpudepth_torch.models.newcrf import NewCRF
from tpudepth_torch.models.registry import build_model
from tpudepth_torch.ops.kernels import rowblock_infer as rbi

RTOL, ATOL = 1e-3, 1e-4
STAGE = dict(input_dim=24, embed_dim=64, v_dim=32, num_heads=2)
# a map the window pads (10x12 -> 14x14: 72 pad tokens, which the shifted
# block's roll moves inside the map) and one it does not (14x21)
MAPS = [(10, 12), (14, 21)]


class _Holder(nn.Module):
    def __init__(self, **kw):
        super().__init__()
        self.s = NewCRF(**STAGE, **kw)


@pytest.fixture(scope="module")
def stage():
    """A seeded port NewCRF stage (C 64, 2 heads) and its JAX parameters."""
    port = init_random_(_Holder(mode="plain"), seed=41).eval()
    b = _Builder(state_dict_to_numpy(port.state_dict()))
    _newcrf_stage(b, "s", "s", True, True)
    return port.state_dict(), b.variables()["params"]["s"]


def _port(state, **kw):
    h = _Holder(**kw)
    h.load_state_dict(state)
    return h.s.eval()


def _inputs(hw, seed=42):
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((2, *hw, STAGE["input_dim"])).astype(np.float32)
    q = rng.standard_normal((2, *hw, STAGE["v_dim"])).astype(np.float32)
    return e, q


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


@pytest.mark.parametrize("hw", MAPS, ids=["padded", "unpadded"])
def test_chained_stage_equals_the_unchained_row_stage_bit_for_bit(stage, hw):
    state, _ = stage
    e, q = _inputs(hw)
    model = _port(state, mode="row")
    with torch.no_grad():
        chained = model(_nchw(e), _nchw(q))
        with blocks_one_by_one(model):
            plain = model(_nchw(e), _nchw(q))
    assert chained.shape == (2, 64, *hw)
    assert torch.equal(chained, plain)


@pytest.mark.parametrize("hw", MAPS, ids=["padded", "unpadded"])
def test_chained_stage_matches_the_jax_stage(stage, hw):
    state, params = stage
    e, q = _inputs(hw, seed=43)
    want = np.asarray(jax_newcrf.NewCRF(**STAGE).apply(
        {"params": params}, jnp.asarray(e), jnp.asarray(q)))
    with torch.no_grad():
        got = _port(state, mode="row")(_nchw(e), _nchw(q))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=RTOL, atol=ATOL)


def test_chained_blocks_see_the_previous_output_at_the_pad(stage):
    """The chain does hand block 1 a padded x whose pad positions hold
    block 0's output there (not zeros), and every chained output is
    finite."""
    state, _ = stage
    e, q = _inputs((10, 12), seed=44)
    model = _port(state, mode="row")
    with torch.no_grad(), chained_blocks(model) as seen:
        model(_nchw(e), _nchw(q))
    (x0, y0), (x1, y1) = seen
    assert x0.shape == y0.shape == x1.shape == (2, 14, 14, 64)
    assert torch.equal(x1, y0)
    assert float(x0[:, 10:].abs().max()) == 0.0
    assert float(y0[:, 10:].abs().max()) > 0.0
    assert bool(torch.isfinite(y0).all() and torch.isfinite(y1).all())


@pytest.mark.parametrize("mode", ["plain", "pair", "fused", "block"])
def test_chain_changes_nothing_off_the_row_mode(stage, mode):
    """Off the row mode the stage runs its blocks one by one and never
    chains."""
    state, _ = stage
    e, q = _inputs((10, 12), seed=45)
    model = _port(state, mode=mode)
    with torch.no_grad():
        with chained_blocks(model) as seen:
            got = model(_nchw(e), _nchw(q))
        with blocks_one_by_one(model):
            want = model(_nchw(e), _nchw(q))
    assert not seen
    assert torch.equal(got, want)


def test_chain_changes_nothing_in_training(stage):
    """A row stage in training runs the unfused blocks one by one and
    never chains: the same output and gradients as the blocks called on
    their own."""
    state, _ = stage
    e, q = _inputs((10, 12), seed=46)
    model = _port(state, mode="row").train()
    outs = []
    for one_by_one in (False, True):
        model.zero_grad()
        with chained_blocks(model) as seen:
            if one_by_one:
                with blocks_one_by_one(model):
                    out = model(_nchw(e), _nchw(q))
            else:
                out = model(_nchw(e), _nchw(q))
        out.square().mean().backward()
        assert not seen
        outs.append((out.detach(), [p.grad.clone()
                                    for p in model.parameters()]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


@pytest.mark.parametrize("shift", [0, 3], ids=["shift0", "shift3"])
def test_row_plain_version_ignores_what_the_pad_holds(shift):
    """``crf_rowblock_infer``'s plain version on a padded, rolled map whose
    pad positions hold large values, infinities and NaN: the real tokens'
    outputs keep the bits of the zero-padded call (validity by select)."""
    rng = np.random.default_rng(47 + shift)
    b, h, w, c, heads, ws = 2, 10, 12, 64, 2, 7
    hp = wp = 14

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32))

    x = torch.zeros(b, hp, wp, c)
    v = torch.zeros(b, hp, wp, c)
    x[:, :h, :w], v[:, :h, :w] = t(b, h, w, c), t(b, h, w, c)
    if shift:
        x, v = (torch.roll(a, (-shift, -shift), dims=(1, 2)) for a in (x, v))
    real = torch.from_numpy(rbi._valid_image(h, w, hp, wp, shift) > 0)
    args = ((t(c, scale=0.1) + 1, t(c, scale=0.1)), t(c, 2 * c, scale=0.1),
            t(2 * c, scale=0.1), t(heads, ws * ws, ws * ws, scale=0.02),
            t(c, c, scale=0.1), t(c, scale=0.1),
            (t(c, scale=0.1) + 1, t(c, scale=0.1)), t(c, 4 * c, scale=0.1),
            t(4 * c, scale=0.1), t(4 * c, c, scale=0.1), t(c, scale=0.1))
    mask = None
    if shift:
        from tpudepth_torch.ops.window import shifted_window_attention_mask

        mask = torch.from_numpy(shifted_window_attention_mask(h, w, ws, shift))
    kw = dict(scale=(c // heads) ** -0.5, window_size=ws,
              valid_hw=(h, w, shift))
    fresh = rbi.crf_rowblock_infer(x, v, *args, mask, **kw)
    garbage = x.clone()
    pad = ~real
    garbage[:, pad] = t(b, int(pad.sum()), c, scale=1e4)
    garbage[0, pad.nonzero()[0][0], pad.nonzero()[0][1], :2] = torch.tensor(
        [float("inf"), float("nan")])
    got = rbi.crf_rowblock_infer(garbage, v, *args, mask, **kw)
    assert torch.equal(got[:, real], fresh[:, real])
    assert bool(torch.isfinite(fresh).all())


@pytest.mark.parametrize("shift", [0, 3], ids=["shift0", "shift3"])
def test_block_plain_version_ignores_what_the_pad_holds(shift):
    """``crf_block_infer``'s plain version zeroes LN(x) at the pad tokens
    by the same select as the row kernel's (``layer_norm_f32_valid``): pad
    tokens of the windows holding large values, infinities and NaN leave
    the real tokens' outputs with the bits of the zero-padded call."""
    from tpudepth_torch.ops.kernels import block_infer as bi
    from tpudepth_torch.ops.window import (
        shifted_window_attention_mask,
        window_valid_mask_on,
    )

    rng = np.random.default_rng(57 + shift)
    b, h, w, c, heads, ws = 2, 10, 12, 64, 2, 7
    n = ws * ws

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32))

    valid = window_valid_mask_on(h, w, ws, shift, torch.device("cpu"))
    real = valid.repeat(b, 1).bool()
    xw = torch.where(real[..., None], t(b * valid.shape[0], n, c), 0.0)
    vw = torch.where(real[..., None], t(b * valid.shape[0], n, c), 0.0)
    mask = (torch.from_numpy(shifted_window_attention_mask(h, w, ws, shift))
            if shift else None)
    args = ((t(c, scale=0.1) + 1, t(c, scale=0.1)), t(c, 2 * c, scale=0.1),
            t(2 * c, scale=0.1), t(heads, n, n, scale=0.02),
            t(c, c, scale=0.1), t(c, scale=0.1),
            (t(c, scale=0.1) + 1, t(c, scale=0.1)), t(c, 4 * c, scale=0.1),
            t(4 * c, scale=0.1), t(4 * c, c, scale=0.1), t(c, scale=0.1))
    kw = dict(scale=(c // heads) ** -0.5)
    fresh = bi.crf_block_infer(xw, vw, *args, mask, valid, **kw)
    garbage = xw.clone()
    garbage[~real] = t(int((~real).sum()), c, scale=1e4)
    first = (~real).nonzero()[0]
    garbage[first[0], first[1], :2] = torch.tensor([float("inf"),
                                                    float("nan")])
    got = bi.crf_block_infer(garbage, vw, *args, mask, valid, **kw)
    assert torch.equal(got[real], fresh[real])
    assert bool(torch.isfinite(fresh).all())


def test_newcrf_model_chains_its_row_stages():
    """``build_model('newcrf')`` (row mode) chains all four stages, two
    blocks each on window-multiple maps, and equals its blocks one by one
    bit for bit; the chain is no option of ``build_model``."""
    model = init_random_(build_model("newcrf", attn="row"), seed=48).eval()
    x = torch.from_numpy(np.random.default_rng(49).random(
        (1, 3, 64, 96), dtype=np.float32)).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        with chained_blocks(model) as seen:
            chained = model(x)
        with blocks_one_by_one(model):
            plain = model(x)
    assert len(seen) == 8
    assert all(xp.shape[1] % 7 == 0 and xp.shape[2] % 7 == 0
               for xp, _ in seen)
    assert torch.equal(chained, plain)
    with pytest.raises(TypeError, match="stage_chain"):
        build_model("newcrf", stage_chain=True)
