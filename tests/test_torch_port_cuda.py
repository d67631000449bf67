"""CUDA kernels of the port against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a card. The file
imports no JAX, so on a machine with a card and no JAX it runs without the
suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py -q
"""

import numpy as np
import pytest
import torch

from tpudepth_torch.ops.kernels import fused_loss as fl
from tpudepth_torch.ops.kernels import gub_conv as gc
from tpudepth_torch.ops.kernels.gub_conv import (
    conv_bn_act,
    conv_bn_act_reference,
    tolerance,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(seed, bsz, h, w, cins, cout, k, prelude, skip, dtype, device):
    rng = np.random.default_rng(seed)

    def t(arr, dt=torch.float32):
        return torch.from_numpy(np.asarray(arr, np.float32)).to(device, dt)

    parts = [t(rng.standard_normal((bsz, h, w, c)), dtype) for c in cins]
    wt = t(rng.standard_normal((k, k, sum(cins), cout))
           / np.sqrt(k * k * sum(cins)))
    b = t(0.1 * rng.standard_normal(cout))
    pre = None
    if prelude:
        # C takes both signs, so a zero-padded halo differs from relu(C)
        pre = [(t(rng.uniform(0.5, 1.5, (bsz, c))),
                t(rng.standard_normal((bsz, c)))) for c in cins]
    sk = t(rng.standard_normal((bsz, h, w, cins[0])), dtype) if skip else None
    return parts, wt, b, pre, sk


# (B, H, W, cins, cout, k, prelude, skip): GuideDepth's GUB conv shapes at a
# quarter of their area, ragged tiles, k=1, several images per batch, and
# GuideDepth-S's narrowest conv
CASES = [
    (1, 60, 80, (64,), 64, 3, False, False),
    (1, 60, 80, (3,), 64, 3, False, False),
    (1, 60, 80, (32, 32), 64, 3, True, False),
    (1, 120, 160, (32,), 32, 3, False, False),
    (1, 120, 160, (16, 16), 32, 3, True, False),
    (1, 240, 320, (3,), 16, 3, False, False),
    (1, 240, 320, (8, 8), 16, 3, True, False),
    (2, 33, 47, (16,), 8, 3, True, True),
    (2, 17, 29, (5, 7), 12, 1, True, True),
    (3, 9, 18, (4, 2, 3), 40, 3, True, False),
    (1, 40, 48, (2, 2), 4, 3, True, False),  # GuideDepth-S up_3 comb conv
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=[str(i) for i in range(len(CASES))])
def test_gub_conv_fwd_matches_plain(cuda, case, dtype):
    _fwd_against_plain(case, dtype, cuda)


def _fwd_against_plain(case, dtype, device):
    """``gub_conv_fwd`` with statistics on ``case`` against its plain
    version: one counted launch, the output within :func:`tolerance`, the
    statistics as :func:`_check_statistics` holds them."""
    bsz, h, w, cins, cout, k, prelude, skip = case
    parts, wt, b, pre, sk = _case(0, bsz, h, w, cins, cout, k, prelude, skip,
                                  dtype, device)
    before = conv_bn_act.launches
    y, s, q = conv_bn_act(parts, wt, b, preludes=pre, skip=sk, stats=True)
    torch.cuda.synchronize()
    assert conv_bn_act.launches == before + 1
    ry = conv_bn_act_reference(parts, wt, b, preludes=pre, skip=sk)
    atol, rtol = tolerance(dtype)
    assert y.dtype == dtype and y.shape == (bsz, h, w, cout)
    torch.testing.assert_close(y.float(), ry.float(), atol=atol, rtol=rtol)
    _check_statistics(y, s, q)


def _check_statistics(y, s, q):
    """``s`` and ``q`` against f64 sums of the kernel's own (rounded) output,
    per channel, to 1e-6 of sum|y| and sum(y^2): the blocks sum 128 values in
    f32 (a few ulps each), the block sums add up in f64 and round once."""
    assert s.dtype == q.dtype == torch.float32
    yd = y.double()
    abs_s, sum_q = yd.abs().sum(dim=(0, 1, 2)), (yd * yd).sum(dim=(0, 1, 2))
    assert bool(((s.double() - yd.sum(dim=(0, 1, 2))).abs()
                 <= 1e-6 * abs_s + 1e-30).all())
    assert bool(((q.double() - sum_q).abs() <= 1e-6 * sum_q + 1e-30).all())


def test_gub_conv_fwd_statistics_keep_f32_accuracy_over_a_large_batch(cuda):
    """1.2 M pixels per channel: sums added in f32 in run order lose about
    6e-6 of their size there, and the BatchNorm variance behind them twice
    that; the f64 accumulators keep them to an f32 rounding."""
    parts, wt, b, pre, _ = _case(4, 4, 480, 640, (8,), 16, 3, True, False,
                                 torch.float32, cuda)
    y, s, q = conv_bn_act(parts, wt, b, preludes=pre, stats=True)
    _check_statistics(y, s, q)


# The bf16 k=3 forward on the tensor cores: GuideDepth's nine GUB convs at
# full size, batch 1 (a served forward, no statistics; up_1's 150 tiles of
# 8 rows run as 300 of 4) and batch 8 (a train step, statistics), each the
# other way too; then a ragged map with part 0's skip, the RGB guide with a
# prelude, two parts of 8 channels with the skip, three parts of 4, 2, 3
# channels, and widths that are no multiple of 8 on either side
FWD_TC_CASES = [(bsz, h, w, cins, cout, 3, prelude, False, stats)
                for bsz in (1, 8) for stats in (False, True)
                for cins, cout, h, w, prelude in (
                    ((64,), 64, 120, 160, False), ((3,), 64, 120, 160, False),
                    ((32, 32), 64, 120, 160, True),
                    ((32,), 32, 240, 320, False), ((3,), 32, 240, 320, False),
                    ((16, 16), 32, 240, 320, True),
                    ((16,), 16, 480, 640, False), ((3,), 16, 480, 640, False),
                    ((8, 8), 16, 480, 640, True))] + [
    (2, 33, 47, (16,), 8, 3, True, True, True),
    (2, 37, 45, (3,), 16, 3, True, True, True),
    (2, 29, 50, (8, 8), 16, 3, True, True, True),
    (3, 9, 18, (4, 2, 3), 40, 3, True, False, True),
    (1, 40, 48, (2, 2), 4, 3, True, False, False),
    (2, 21, 35, (24, 36), 60, 3, True, True, True)]
FWD_TC_IDS = [f"B{bsz}-{'stats' if stats else 'y'}-up_{s}.{conv}"
              for bsz in (1, 8) for stats in (False, True)
              for s in (1, 2, 3) for conv in ("feature", "guide", "comb")] + [
    "ragged-skip", "rgb-pre-skip", "8+8-skip", "4+2+3", "2+2->4", "24+36->60"]


@pytest.mark.parametrize("case", FWD_TC_CASES, ids=FWD_TC_IDS)
def test_gub_conv_fwd_bf16_on_the_tensor_cores(cuda, case):
    """One counted launch, the output within :func:`tolerance` of the plain
    version, the statistics against f64 sums of the kernel's own output."""
    bsz, h, w, cins, cout, k, prelude, skip, stats = case
    parts, wt, b, pre, sk = _case(5, bsz, h, w, cins, cout, k, prelude, skip,
                                  torch.bfloat16, cuda)
    before = conv_bn_act.launches
    out = conv_bn_act(parts, wt, b, preludes=pre, skip=sk, stats=stats)
    torch.cuda.synchronize()
    assert conv_bn_act.launches == before + 1
    y = out[0] if stats else out
    ry = conv_bn_act_reference(parts, wt, b, preludes=pre, skip=sk)
    atol, rtol = tolerance(torch.bfloat16)
    assert y.dtype == torch.bfloat16 and y.shape == (bsz, h, w, cout)
    torch.testing.assert_close(y.float(), ry.float(), atol=atol, rtol=rtol)
    if stats:
        _check_statistics(*out)
    else:
        # the same output with and without statistics
        assert torch.equal(y, conv_bn_act(parts, wt, b, preludes=pre, skip=sk,
                                          stats=True)[0])


@pytest.mark.parametrize("cins,cout", [((64,), 64), ((3,), 32), ((8, 8), 16)],
                         ids=["64->64", "rgb", "8+8->16"])
def test_gub_conv_fwd_bf16_gives_the_same_bits_for_every_weight_layout(
        cuda, cins, cout):
    """The tensor-core kernel stages the weights along whichever index lies
    contiguous (HWIO: n; a served OIHW parameter: the tap; a trained
    channels_last one: k); the staged values, and so the output, are the
    same bits."""
    parts, wt, b, pre, _ = _case(6, 2, 24, 40, cins, cout, 3, True, False,
                                 torch.bfloat16, cuda)
    oihw = wt.permute(3, 2, 0, 1).contiguous()
    views = [wt, oihw.permute(2, 3, 1, 0),
             oihw.contiguous(memory_format=torch.channels_last)
             .permute(2, 3, 1, 0)]
    ys = [conv_bn_act(parts, w, b, preludes=pre) for w in views]
    torch.testing.assert_close(
        ys[0].float(), conv_bn_act_reference(parts, wt, b, preludes=pre)
        .float(), atol=tolerance(torch.bfloat16)[0],
        rtol=tolerance(torch.bfloat16)[1])
    assert all(torch.equal(ys[0], y) for y in ys[1:])


def test_gub_conv_fwd_accepts_an_oihw_weight_view(cuda):
    parts, wt, b, pre, _ = _case(1, 1, 20, 24, (8,), 16, 3, True, False,
                                 torch.float32, cuda)
    oihw = wt.permute(3, 2, 0, 1).contiguous()
    got = conv_bn_act(parts, oihw.permute(2, 3, 1, 0), b, preludes=pre)
    want = conv_bn_act_reference(parts, wt, b, preludes=pre)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_gub_conv_fwd_refuses_what_it_does_not_take(cuda):
    parts, wt, b, _, _ = _case(2, 1, 8, 8, (4,), 8, 3, False, False,
                               torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        conv_bn_act([parts[0].permute(0, 2, 1, 3)], wt, b)
    with pytest.raises(TypeError):
        conv_bn_act([parts[0].half()], wt, b)
    with pytest.raises(ValueError):
        conv_bn_act(parts, wt.new_zeros(5, 5, 4, 8), b)


def _cotangents(seed, y, stats):
    """``dy`` of unit scale in ``y``'s dtype and, with statistics, ``ds`` and
    ``dq`` of scale 0.1 (so ``g = dy + ds + 2*dq*y`` stays of unit scale)."""
    rng = np.random.default_rng(1000 + seed)
    dy = torch.from_numpy(rng.standard_normal(tuple(y.shape)).astype(np.float32)
                          ).to(y.device, y.dtype)
    if not stats:
        return dy, {}
    ds, dq = (torch.from_numpy((0.1 * rng.standard_normal(y.shape[-1]))
                               .astype(np.float32)).to(y.device)
              for _ in range(2))
    return dy, {"y": y, "ds": ds, "dq": dq}


def _rms(t):
    """The largest per-channel root mean square of ``t`` ``[..., C]``."""
    return float(t.float().square().mean(dim=tuple(range(t.dim() - 1)))
                 .sqrt().max())


# the forward's cases, each with and without statistics in the backward
BWD_CASES = [c + (i % 2 == 0,) for i, c in enumerate(CASES)] + [
    (2, 33, 47, (16,), 8, 3, True, True, False),
    (8, 60, 80, (8, 8), 16, 3, True, False, True),  # more tiles than blocks
]


def _dw_against_plain(case, dtype, device):
    """``gub_conv_dw`` on ``case`` against its plain version: one counted
    launch a call, the f32 sums within :func:`gc.sum_tolerance`, a rerun
    bit-equal."""
    bsz, h, w, cins, cout, k, prelude, skip, stats = case
    parts, wt, b, pre, sk = _case(0, bsz, h, w, cins, cout, k, prelude, skip,
                                  dtype, device)
    y = conv_bn_act(parts, wt, b, preludes=pre, skip=sk)
    dy, cot = _cotangents(0, y, stats)
    before = gc.conv_bn_act_dw.launches
    dw, db = gc.conv_bn_act_dw(parts, dy, wt, preludes=pre, skip=sk, **cot)
    torch.cuda.synchronize()
    assert gc.conv_bn_act_dw.launches == before + 1
    rdw, rdb = gc.conv_bn_act_dw_reference(parts, dy, k, preludes=pre,
                                           skip=sk, **cot)
    assert dw.dtype == db.dtype == torch.float32
    assert dw.shape == wt.shape and db.shape == b.shape
    n = bsz * h * w
    g_rms = _rms(gc._cotangent(dy, cot.get("y"), cot.get("ds"), cot.get("dq")))
    xa_rms = _rms(torch.cat(gc._activate(parts, pre, sk), dim=-1))
    torch.testing.assert_close(dw, rdw, rtol=gc.SUM_RTOL,
                               atol=gc.sum_tolerance(n, xa_rms * g_rms))
    torch.testing.assert_close(db, rdb, rtol=gc.SUM_RTOL,
                               atol=gc.sum_tolerance(n, g_rms))
    # partial sums are added in a fixed order: the same bits every time
    dw2, db2 = gc.conv_bn_act_dw(parts, dy, wt, preludes=pre, skip=sk, **cot)
    assert gc.conv_bn_act_dw.launches == before + 2
    assert torch.equal(dw, dw2) and torch.equal(db, db2)


def _dx_against_plain(case, dtype, device):
    """``gub_conv_dx`` on each part of ``case`` against its plain version:
    one counted launch a call, ``dx`` and ``dskip`` within
    :func:`tolerance`, ``dA`` and ``dC`` within :func:`gc.sum_tolerance`, a
    rerun bit-equal."""
    bsz, h, w, cins, cout, k, prelude, skip, stats = case
    parts, wt, b, pre, sk = _case(0, bsz, h, w, cins, cout, k, prelude, skip,
                                  dtype, device)
    y = conv_bn_act(parts, wt, b, preludes=pre, skip=sk)
    dy, cot = _cotangents(0, y, stats)
    atol, rtol = tolerance(dtype)
    off = 0
    for j, x in enumerate(parts):
        kw = dict(prelude=pre[j] if prelude else None,
                  want_skip=skip and j == 0, **cot)
        before = gc.conv_bn_act_dx.launches
        got = gc.conv_bn_act_dx(x, wt, off, dy, **kw)
        torch.cuda.synchronize()
        assert gc.conv_bn_act_dx.launches == before + 1
        cin = x.shape[-1]
        want = gc.conv_bn_act_dx_reference(x, wt[:, :, off:off + cin], dy, **kw)
        again = gc.conv_bn_act_dx(x, wt, off, dy, **kw)
        assert gc.conv_bn_act_dx.launches == before + 2
        for name, g, r, g2 in zip(("dx", "dA", "dC", "dskip"), got, want,
                                  again):
            assert (g is None) == (r is None), name
            if g is None:
                continue
            assert g.shape == r.shape and torch.equal(g, g2), name
            if name in ("dx", "dskip"):
                assert g.dtype == dtype
                torch.testing.assert_close(g.float(), r.float(), atol=atol,
                                           rtol=rtol, msg=name)
            else:
                # sums over H*W of dp (dC) and dp * x (dA), |dp| <= |dxa|
                dxa_rms = _rms(want[3] if want[3] is not None else want[0]
                               / pre[j][0][:, None, None, :])
                term = dxa_rms * (_rms(x) if name == "dA" else 1.0)
                torch.testing.assert_close(
                    g, r, rtol=gc.SUM_RTOL,
                    atol=gc.sum_tolerance(h * w, term),
                    msg=name)
        off += cin


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", BWD_CASES,
                         ids=[str(i) for i in range(len(BWD_CASES))])
def test_gub_conv_dw_matches_plain(cuda, case, dtype):
    _dw_against_plain(case, dtype, cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", BWD_CASES,
                         ids=[str(i) for i in range(len(BWD_CASES))])
def test_gub_conv_dx_matches_plain(cuda, case, dtype):
    _dx_against_plain(case, dtype, cuda)


# The bf16 k=3 kernels on the tensor cores: GuideDepth's nine GUB convs at
# full size, B 2, with statistics (as a train step launches them), then the
# k=3 backward cases (a ragged 33x47 tile edge, more tiles than blocks,
# three parts of 4, 2, 3 channels into 40, widths below 8 and the RGB guide)
# and one wider than 64 both ways (dx walks Cout in two K chunks and splits
# Cin over two blocks; dw takes three channel chunks and two slabs)
TC_CASES = [(2, h, w, cins, cout, 3, prelude, False, True)
            for cins, cout, h, w, prelude in (
                ((64,), 64, 120, 160, False), ((3,), 64, 120, 160, False),
                ((32, 32), 64, 120, 160, True), ((32,), 32, 240, 320, False),
                ((3,), 32, 240, 320, False), ((16, 16), 32, 240, 320, True),
                ((16,), 16, 480, 640, False), ((3,), 16, 480, 640, False),
                ((8, 8), 16, 480, 640, True))] + [
    c for c in BWD_CASES if c[5] == 3] + [
    (1, 17, 33, (80,), 72, 3, True, False, True)]
TC_IDS = [f"up_{s}.{conv}" for s in (1, 2, 3)
          for conv in ("feature", "guide", "comb")] + [
    f"bwd{i}" for i, c in enumerate(BWD_CASES) if c[5] == 3] + ["wide"]


@pytest.mark.parametrize("case", TC_CASES, ids=TC_IDS)
def test_gub_conv_dx_bf16_on_the_tensor_cores(cuda, case):
    _dx_against_plain(case, torch.bfloat16, cuda)


@pytest.mark.parametrize("case", TC_CASES, ids=TC_IDS)
def test_gub_conv_dw_bf16_on_the_tensor_cores(cuda, case):
    _dw_against_plain(case, torch.bfloat16, cuda)


# The k=3 GUB convs of GuideDepth's packed (space-to-depth) stages at
# 480x640 (models/guidedepth.py, packed=True), on a quarter of their 120x160
# grid, B 2, with statistics: up_2 folded (2,2) at 128 channels, up_3 (4,4)
# at 256, the RGB guide at 12 and 48 channels, the comb conv's two parts
PACKED_CASES = [(2, 60, 80, cins, cout, 3, prelude, False, True)
                for cins, cout, prelude in (
                    ((128,), 128, False), ((12,), 128, False),
                    ((64, 64), 128, True), ((256,), 256, False),
                    ((48,), 256, False), ((128, 128), 256, True))]
PACKED_IDS = [f"up_{s}.{conv}" for s in (2, 3)
              for conv in ("feature", "guide", "comb")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", PACKED_CASES, ids=PACKED_IDS)
def test_gub_conv_fwd_at_packed_widths(cuda, case, dtype):
    _fwd_against_plain(case[:8], dtype, cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", PACKED_CASES, ids=PACKED_IDS)
def test_gub_conv_dw_at_packed_widths(cuda, case, dtype):
    _dw_against_plain(case, dtype, cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", PACKED_CASES, ids=PACKED_IDS)
def test_gub_conv_dx_at_packed_widths(cuda, case, dtype):
    _dx_against_plain(case, dtype, cuda)


def test_gub_conv_dw_f32_sums_stay_short_at_the_full_packed_size(cuda):
    """up_3's packed comb conv at its full 120x160 grid, B 8, f32: a 256 x
    256 conv has 8 dw blocks a channel slab, each over 150 tiles; one chain
    over all of a block's pixels drifted beyond the sum tolerance."""
    _dw_against_plain((8, 120, 160, (128, 128), 256, 3, True, False, True),
                      torch.float32, cuda)


@pytest.mark.parametrize("gub,fwd", [("plain", 0), ("fused", 9)])
def test_packed_guidedepth_on_the_card_matches_the_unpacked_model(cuda, gub,
                                                                 fwd):
    """GuideDepth at 1x3x96x128 f32, packed (up_2 (2,2), up_3 (4,4)) in
    both GUB modes against the unpacked plain model on the card (summation
    order only), and the ``gub_conv_fwd`` launches of a forward."""
    from tpudepth_torch.models.layers import init_random_
    from tpudepth_torch.models.registry import build_model

    plain = init_random_(build_model("GuideDepth"), seed=0).to(cuda).eval()
    model = build_model("GuideDepth", gub=gub, packed=True)
    model.load_state_dict(plain.state_dict())
    model.to(cuda).eval()
    assert model.stage_blocks(96, 128) == [None, (2, 2), (4, 4)]
    x = torch.rand(1, 3, 96, 128, generator=torch.Generator().manual_seed(1))
    x = x.to(cuda).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        want = plain(x)
        before = conv_bn_act.launches
        got = model(x)
    torch.cuda.synchronize()
    assert conv_bn_act.launches - before == fwd
    assert float((got - want).norm() / want.norm()) < 1e-4


def test_rematerialized_packed_fused_stages_launch_the_forward_twice(cuda):
    """A train-mode forward and backward of packed fused GuideDepth-S with
    ``remat_stages``: ``gub_conv_fwd`` runs once in the forward and once
    more in the backward a conv, ``gub_conv_dw`` once a conv, ``gub_conv_dx``
    once a part that needs a gradient (not the RGB guide); the gradients
    and the running statistics equal the step without rematerialization
    (the GUB kernels repeat bit for bit, cuDNN's backward may not: 1e-5 of
    each gradient's largest, under a floor of 1e-5 of the largest of all,
    since a conv bias in front of a BatchNorm has a gradient of 0 and holds
    noise; a second move of the statistics would be off by a tenth of the
    first)."""
    from tpudepth_torch.models.layers import init_random_
    from tpudepth_torch.models.registry import build_model

    x = torch.rand(2, 3, 64, 96, generator=torch.Generator().manual_seed(2))
    x = x.to(cuda).contiguous(memory_format=torch.channels_last)
    runs = []
    for remat in (False, True):
        model = init_random_(build_model("GuideDepth-S", gub="fused",
                                         packed=True, remat_stages=remat),
                             seed=3).to(cuda).train()
        counts = (conv_bn_act.launches, gc.conv_bn_act_dw.launches,
                  gc.conv_bn_act_dx.launches)
        model(x).square().mean().backward()
        torch.cuda.synchronize()
        runs.append(([conv_bn_act.launches - counts[0],
                      gc.conv_bn_act_dw.launches - counts[1],
                      gc.conv_bn_act_dx.launches - counts[2]],
                     {n: p.grad for n, p in model.named_parameters()},
                     {k: v for k, v in model.state_dict().items()
                      if "running" in k}))
    (c0, g0, s0), (c1, g1, s1) = runs
    assert c0 == [9, 9, 9] and c1 == [18, 9, 9]
    floor = 1e-5 * max(float(g.abs().max()) for g in g0.values())
    for n, g in g1.items():
        torch.testing.assert_close(
            g, g0[n], rtol=1e-5,
            atol=max(1e-5 * float(g0[n].abs().max()), floor), msg=n)
    for k, v in s1.items():
        torch.testing.assert_close(v, s0[k], rtol=1e-6, atol=1e-6, msg=k)


def test_conv_bn_act_backward_on_the_card_matches_the_plain_backward(cuda):
    """The whole ``autograd.Function`` on the card (three kernels) against
    the same Function on the CPU (three plain versions), with the weight as
    the ``permute(2,3,1,0)`` view of a channels_last OIHW parameter."""
    parts, wt, b, pre, sk = _case(3, 2, 33, 47, (8, 8), 16, 3, True, True,
                                  torch.float32, cuda)

    def run(dev):
        leaves = [t.detach().to(dev).requires_grad_(True)
                  for t in (*parts, *[a for a, _ in pre], *[c for _, c in pre],
                            sk, b)]
        p2, a2, c2 = leaves[:2], leaves[2:4], leaves[4:6]
        conv_w = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last).detach().to(dev)
        conv_w.requires_grad_(True)
        y, s, q = conv_bn_act(p2, conv_w.permute(2, 3, 1, 0), leaves[7],
                              preludes=list(zip(a2, c2)), skip=leaves[6],
                              stats=True)
        n = y.numel() / y.shape[-1]
        (torch.sin(y).sum() + 0.1 * (s * s).sum() / n
         + 0.05 * q.abs().sqrt().sum()).backward()
        assert conv_w.grad.shape == conv_w.shape
        assert conv_w.grad.stride() == conv_w.stride()
        return [t.grad.cpu() for t in (*leaves, conv_w)]

    counts = (conv_bn_act.launches, gc.conv_bn_act_dw.launches,
              gc.conv_bn_act_dx.launches)
    got = run(cuda)
    assert (conv_bn_act.launches, gc.conv_bn_act_dw.launches,
            gc.conv_bn_act_dx.launches) == (counts[0] + 1, counts[1] + 1,
                                            counts[2] + 2)
    want = run("cpu")
    for g, r in zip(got, want):
        scale = float(r.abs().max())
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-5 * scale)


def test_gub_conv_backward_refuses_what_it_does_not_take(cuda):
    parts, wt, b, _, _ = _case(2, 1, 8, 8, (4,), 8, 3, False, False,
                               torch.float32, cuda)
    dy = torch.zeros(1, 8, 8, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        gc.conv_bn_act_dw(parts, dy.permute(0, 2, 1, 3), wt)
    with pytest.raises(ValueError):
        gc.conv_bn_act_dw(parts, dy, wt.new_zeros(3, 3, 5, 8))
    with pytest.raises(ValueError):
        gc.conv_bn_act_dx(parts[0], wt, 2, dy)
    with pytest.raises(ValueError):
        gc.conv_bn_act_dx(parts[0], wt, 0, dy.bfloat16())


def loss_pair(kind, bsz, h, w, device, seed=0):
    """``(pred, target)`` ``[B,H,W]`` float32. ``random``: both uniform in
    [0, 10); ``norm``: a target of ``depth_norm`` scale (uniform in [1, 100])
    with a prediction around it; ``zeros``: the same with a third of the
    target pixels 0 (masked depth); ``equal``: pred == target; ``smooth``:
    piecewise-constant images, so differences and their signs hit 0."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        p = rng.random((bsz, h, w)) * 10
        t = rng.random((bsz, h, w)) * 10
    elif kind == "smooth":
        t = np.repeat(np.repeat(rng.integers(1, 9, (bsz, -(-h // 8), -(-w // 8))),
                                8, axis=1), 8, axis=2)[:, :h, :w].astype(float)
        p = t.copy()
        p[:, : h // 2] += 1.0
    else:
        t = rng.uniform(1.0, 100.0, (bsz, h, w))
        p = t * rng.uniform(0.5, 1.5, (bsz, h, w))
        if kind == "zeros":
            t[rng.random((bsz, h, w)) < 0.33] = 0.0
        if kind == "equal":
            p = t.copy()

    def dev(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    return dev(p), dev(t)


# the backward's 32x64 output tile and the forward's 40x64: exactly one,
# one row and column below and above one and two tiles, images narrower
# than the backward's 10-pixel halo on one axis, a width that is even but
# not a multiple of 4 (no 16-byte loads)
LOSS_CASES = [("random", 3, 48, 64), ("norm", 8, 240, 320),
              ("norm", 2, 33, 47), ("zeros", 2, 64, 96), ("equal", 2, 40, 40),
              ("smooth", 2, 50, 70), ("norm", 1, 7, 5), ("norm", 8, 480, 640),
              ("norm", 2, 31, 63), ("norm", 2, 33, 65), ("norm", 1, 63, 129),
              ("zeros", 1, 65, 127), ("norm", 1, 11, 70), ("norm", 1, 70, 11),
              ("random", 2, 32, 66), ("norm", 3, 32, 64), ("norm", 3, 40, 64),
              ("norm", 2, 39, 65), ("norm", 2, 41, 63), ("zeros", 1, 81, 129)]


@pytest.mark.parametrize("case", LOSS_CASES, ids=lambda c: "-".join(map(str, c)))
def test_fused_loss_fwd_matches_plain(cuda, case):
    p, t = loss_pair(*case, cuda)
    before = fl.fused_partials.launches
    got = fl.fused_partials(p, t, 10.0)
    torch.cuda.synchronize()
    assert fl.fused_partials.launches == before + 1
    want = fl.fused_partials_reference(p, t, 10.0)
    tol = fl.tolerance(p, t, 10.0)
    assert got.shape == want.shape == (p.shape[0], 3)
    torch.testing.assert_close(got[:, [0, 2]], want[:, [0, 2]], atol=0,
                               rtol=tol["partials_rtol"])
    assert bool(((got[:, 1] - want[:, 1]).abs() <= tol["ssim_atol"]).all())
    # the block sums are added in a fixed order: the same bits every time
    assert torch.equal(got, fl.fused_partials(p, t, 10.0))
    if case[0] == "equal":
        n = float(p.shape[1] * p.shape[2])
        assert torch.equal(got[:, 1], torch.full_like(got[:, 1], n))
        assert float(got[:, [0, 2]].abs().max()) == 0.0


@pytest.mark.parametrize("case", LOSS_CASES, ids=lambda c: "-".join(map(str, c)))
def test_fused_loss_bwd_matches_plain(cuda, case):
    p, t = loss_pair(*case, cuda)
    n = p.numel()
    scales = torch.tensor([0.1 / n, -0.5 / n, 1.0 / n], device=cuda)
    before = fl.fused_bwd.launches
    got = fl.fused_bwd(p, t, 10.0, scales)
    torch.cuda.synchronize()
    assert fl.fused_bwd.launches == before + 1
    want = fl.fused_bwd_reference(p, t, 10.0, scales)
    tol = fl.tolerance(p, t, 10.0)
    bound = (0.5 / n) * tol["grad_atol"] + tol["grad_rtol"] * want.abs()
    assert got.shape == want.shape
    assert bool(((got - want).abs() <= bound).all()), float(
        ((got - want).abs() - bound).max())
    assert float(want.abs().max()) > 0 or case[0] == "equal"
    # without the SSIM term only signs are left, and those are exact
    scales[1] = 0.0
    assert torch.equal(fl.fused_bwd(p, t, 10.0, scales),
                       fl.fused_bwd_reference(p, t, 10.0, scales))


def test_fused_depth_loss_on_the_card_matches_autograd_of_depth_loss(cuda):
    from tpudepth_torch.losses.losses import DepthLoss

    p, t = loss_pair("random", 3, 48, 64, cuda)
    pk = p[:, None].clone().requires_grad_(True)
    pr = p[:, None].clone().requires_grad_(True)
    lk = fl.fused_depth_loss(pk, t[:, None], 0.1, 1.0, 1.0, 10.0)
    lr = DepthLoss(0.1, 1.0, 1.0, 10.0)(pr, t[:, None])
    lk.backward()
    lr.backward()
    # the tolerances of the JAX package's own fused-loss tests
    assert abs(float(lk) - float(lr)) < 2e-4
    torch.testing.assert_close(pk.grad, pr.grad, rtol=1e-4, atol=1e-6)


def test_fused_loss_refuses_what_it_does_not_take(cuda):
    p, t = loss_pair("random", 1, 16, 16, cuda)
    with pytest.raises(TypeError):
        fl.fused_partials(p.double(), t.double(), 10.0)
    with pytest.raises(ValueError, match="contiguous"):
        fl.fused_partials(p.transpose(1, 2), t.transpose(1, 2), 10.0)
    with pytest.raises(ValueError):
        fl.fused_bwd(p, t, 10.0, torch.zeros(3))


# -- the root recipe's loss: fused_root_loss_fwd / _bwd ----------------------

from torch_port_helpers import root_pair  # noqa: E402
from tpudepth_torch.ops.kernels import fused_root_loss as frl  # noqa: E402

# the SAM / NewCRF training shape; ragged strips; the clip active; pred ==
# target (the clip's bound); flat patches; the smallest image; the
# backward's warp strip of 16 rows x 60 columns one below and above one and
# two strips, images of 2 rows or columns (narrower than its 2-pixel halo);
# the forward's strip of 8 rows x 62 columns (from column -1, so 61 in the
# first) one below, at and above one, two and four strips; the zoo's
# half-size predictions of a B 8 step (480x640 and KITTI's 384x1280 halved)
ROOT_CASES = [("unit", 8, 480, 640), ("unit", 2, 33, 47), ("anti", 2, 64, 96),
              ("equal", 2, 40, 40), ("smooth", 2, 34, 46), ("unit", 1, 2, 3),
              ("unit", 2, 15, 59), ("anti", 2, 17, 61), ("unit", 1, 31, 121),
              ("unit", 1, 33, 119), ("unit", 1, 2, 65), ("anti", 1, 65, 2),
              ("unit", 2, 15, 61), ("anti", 2, 17, 63), ("unit", 1, 16, 62),
              ("unit", 1, 33, 123), ("anti", 1, 32, 124),
              ("unit", 8, 240, 320), ("anti", 8, 192, 640)]


@pytest.mark.parametrize("case", ROOT_CASES, ids=lambda c: "-".join(map(str, c)))
def test_fused_root_loss_fwd_matches_plain(cuda, case):
    p, t = root_pair(*case, cuda)
    before = frl.root_partials.launches
    got = frl.root_partials(p, t)
    torch.cuda.synchronize()
    assert frl.root_partials.launches == before + 1
    want = frl.root_partials_reference(p, t)
    assert got.shape == want.shape == (p.shape[0], 2)
    torch.testing.assert_close(got, want, atol=0, rtol=frl.PARTIALS_RTOL)
    # the block sums are added in a fixed order: the same bits every time
    assert torch.equal(got, frl.root_partials(p, t))
    if case[0] == "equal":
        assert float(got.abs().max()) == 0.0


@pytest.mark.parametrize("case", ROOT_CASES, ids=lambda c: "-".join(map(str, c)))
def test_fused_root_loss_bwd_matches_plain(cuda, case):
    """The kernels and the plain version do the same f32 operations per pixel
    in the same order (the loss map's clip gate included), so the gradient
    is bit-equal."""
    p, t = root_pair(*case, cuda)
    n = p.numel()
    scales = torch.tensor([1.0 / n, 0.1 / n], device=cuda)
    before = frl.root_bwd.launches
    got = frl.root_bwd(p, t, scales)
    torch.cuda.synchronize()
    assert frl.root_bwd.launches == before + 1
    want = frl.root_bwd_reference(p, t, scales)
    assert got.shape == want.shape == p.shape
    assert torch.equal(got, want), float((got - want).abs().max())
    assert float(want.abs().max()) > 0 or case[0] == "equal"


def _loss_call(name, device):
    """``(wrapper, its launch counter, a call of it)`` of a loss kernel at
    B 2 96x128."""
    if name.startswith("fused_loss"):
        p, t = loss_pair("norm", 2, 96, 128, device)
        scales = torch.tensor([0.1, -0.5, 1.0], device=device) / p.numel()
        if name == "fused_loss_fwd":
            return fl.fused_partials, lambda: fl.fused_partials(p, t, 10.0)
        return fl.fused_bwd, lambda: fl.fused_bwd(p, t, 10.0, scales)
    p, t = root_pair("unit", 2, 96, 128, device)
    scales = torch.tensor([1.0, 0.1], device=device) / p.numel()
    if name == "fused_root_loss_fwd":
        return frl.root_partials, lambda: frl.root_partials(p, t)
    return frl.root_bwd, lambda: frl.root_bwd(p, t, scales)


@pytest.mark.parametrize("name", ["fused_loss_fwd", "fused_loss_bwd",
                                  "fused_root_loss_fwd", "fused_root_loss_bwd"])
def test_loss_kernel_is_one_cuda_kernel(cuda, name):
    """Each loss kernel is one CUDA kernel a call, counted from the kernel
    nodes of a CUDA graph of one call: the backwards keep the coefficient
    maps on the chip, the forwards add each image's block sums in the
    image's last block (the counters' memset is a node of another type)."""
    from tpudepth_torch.utils.profiling import graph_kernels

    wrapper, call = _loss_call(name, cuda)
    before = wrapper.launches
    assert graph_kernels(call) == 1
    assert wrapper.launches == before + 2


@pytest.mark.parametrize("name", ["fused_loss_fwd", "fused_root_loss_fwd"])
def test_loss_forward_on_two_streams_gives_the_single_stream_bits(cuda, name):
    """Two calls at once on two streams, each with its own scratch and
    per-image tickets, give the bits of the same calls on one stream."""
    if name == "fused_loss_fwd":
        pairs = [loss_pair("norm", 2, 480, 640, cuda, seed=s) for s in (0, 1)]
        fwd = lambda p, t: fl.fused_partials(p, t, 10.0)  # noqa: E731
    else:
        pairs = [root_pair("unit", 2, 480, 640, cuda, seed=s) for s in (0, 1)]
        fwd = frl.root_partials
    want = [fwd(p, t) for p, t in pairs]
    streams = [torch.cuda.Stream() for _ in pairs]
    main = torch.cuda.current_stream()
    for _ in range(10):
        got = []
        for s, (p, t) in zip(streams, pairs):
            s.wait_stream(main)
            with torch.cuda.stream(s):
                got.append(fwd(p, t))
        for s in streams:
            main.wait_stream(s)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_fused_root_loss_on_the_card_matches_the_plain_composition(cuda):
    from tpudepth_torch.losses.losses import l1_loss, ssim

    p, t = root_pair("anti", 3, 48, 64, cuda)
    pk = p[:, None].clone().requires_grad_(True)
    pr = p[:, None].clone().requires_grad_(True)
    lk = frl.fused_root_loss(pk, t[:, None], 1.0, 0.1)
    lr = 1.0 * ssim(pr, t[:, None]) + 0.1 * l1_loss(pr, t[:, None])
    lk.backward()
    lr.backward()
    # the tolerances of the JAX package's own fused root-loss tests
    torch.testing.assert_close(lk, lr, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(pk.grad, pr.grad, rtol=1e-4, atol=1e-6)


def test_fused_root_loss_refuses_what_it_does_not_take(cuda):
    p, t = root_pair("unit", 1, 16, 16, cuda)
    with pytest.raises(TypeError):
        frl.root_partials(p.double(), t.double())
    with pytest.raises(ValueError, match="contiguous"):
        frl.root_partials(p.transpose(1, 2), t.transpose(1, 2))
    with pytest.raises(ValueError, match="H, W >= 2"):
        frl.root_partials(p[:, :1], t[:, :1])
    with pytest.raises(ValueError):
        frl.root_bwd(p, t, torch.zeros(2))


# -- SAM serving: window_attn_infer, block_epilogue_infer, mlp_infer ---------

from tpudepth_torch.ops.kernels import epilogue_infer as ei  # noqa: E402
from tpudepth_torch.ops.kernels import mlp_infer as mi  # noqa: E402
from tpudepth_torch.ops.kernels import window_attn_infer as wai  # noqa: E402
from tpudepth_torch.ops.window import (  # noqa: E402
    shifted_window_attention_mask,
)

# (windows, C, heads, padded map or None): the four SAM stages at 480x640
# batch 1 (crf3..crf0) and sizes off the path (N = 16 with head_dim 8,
# N = 64 with head_dim 64)
ATTN_CASES = [(9, 1024, 32, (21, 21)), (30, 512, 16, (35, 42)),
              (108, 256, 8, (63, 84)), (414, 128, 4, (126, 161))]


def _close(got, want, tol, extra=None):
    """``|got - want| <= atol * max|want| + rtol * |want| [+ extra]``
    elementwise (``extra``: an elementwise atol)."""
    frac, rtol = tol
    g, w = got.float(), want.float()
    bound = frac * float(w.abs().max()) + rtol * w.abs()
    if extra is not None:
        bound = bound + extra
    assert bool(((g - w).abs() <= bound).all()), (
        float((g - w).abs().max()), float(((g - w).abs() - bound).max()))


def _attn_case(seed, bw, n, c, heads, dtype, device):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(bw, n, c, generator=g) for _ in range(3))
    q = q * (c // heads) ** -0.5
    bias = 0.5 * torch.randn(heads, n, n, generator=g)
    return [t.to(device, dtype) for t in (q, k, v)] + [bias.to(device)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "shift"])
@pytest.mark.parametrize("case", ATTN_CASES, ids=["crf3", "crf2", "crf1", "crf0"])
def test_window_attn_infer_matches_plain(cuda, case, masked, dtype):
    bw, c, heads, hw = case
    q, k, v, bias = _attn_case(bw, bw, 49, c, heads, dtype, cuda)
    mask = None
    if masked:
        mask = torch.from_numpy(shifted_window_attention_mask(*hw, 7, 3)).to(cuda)
        assert mask.shape[0] == bw
    before = wai.window_attention_infer.launches
    got = wai.window_attention_infer(q, k, v, bias, mask)
    torch.cuda.synchronize()
    assert wai.window_attention_infer.launches == before + 1
    want = wai.window_attention_infer_reference(q, k, v, bias, mask)
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, want, wai.tolerance(dtype))
    assert torch.equal(got, wai.window_attention_infer(q, k, v, bias, mask))


@pytest.mark.parametrize("n,c,heads", [(16, 16, 2), (64, 128, 2), (49, 96, 3)])
def test_window_attn_infer_off_the_path_shapes(cuda, n, c, heads):
    q, k, v, bias = _attn_case(n, 6, n, c, heads, torch.float32, cuda)
    mask = (torch.rand(3, n, n, device=cuda) > 0.5).float() * -100.0
    got = wai.window_attention_infer(q, k, v, bias, mask)
    want = wai.window_attention_infer_reference(q, k, v, bias, mask)
    _close(got, want, wai.tolerance(torch.float32))


def test_window_attn_infer_reads_k_and_v_through_their_row_stride(cuda):
    q, k, v, bias = _attn_case(3, 12, 49, 128, 4, torch.bfloat16, cuda)
    kh, vh = torch.cat([k, v], dim=-1).chunk(2, dim=-1)
    assert not kh.is_contiguous()
    torch.testing.assert_close(wai.window_attention_infer(q, kh, vh, bias),
                               wai.window_attention_infer(q, k, v, bias),
                               atol=0, rtol=0)


def test_window_attn_infer_refuses_what_it_does_not_take(cuda):
    q, k, v, bias = _attn_case(4, 4, 49, 60, 3, torch.float32, cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        wai.window_attention_infer(q, k, v, bias)    # head_dim 20
    q, k, v, bias = _attn_case(4, 4, 81, 64, 2, torch.float32, cuda)
    with pytest.raises(ValueError, match="N <= 64"):
        wai.window_attention_infer(q, k, v, bias)
    q, k, v, bias = _attn_case(4, 4, 49, 64, 2, torch.float16, cuda)
    with pytest.raises(TypeError):
        wai.window_attention_infer(q, k, v, bias)


def _epilogue_case(seed, m, c, hidden, dtype, device, c2=None):
    g = torch.Generator().manual_seed(seed)
    c2 = c2 or c

    def n(*shape, s=1.0, mean=0.0):
        return (mean + s * torch.randn(*shape, generator=g)).to(device)

    return dict(o=n(m, c).to(dtype), x=n(m, c).to(dtype),
                wproj=n(c, c, s=c ** -0.5), bproj=n(c, s=0.1),
                lns=n(c, s=0.2, mean=1.0), lnb=n(c, s=0.1),
                w1=n(c, hidden, s=c ** -0.5), b1=n(hidden, s=0.1),
                w2=n(hidden, c2, s=hidden ** -0.5), b2=n(c2, s=0.1))


# (M, C): the four stages' rows at 480x640 batch 1, a row count that is no
# multiple of a tile, and widths of 32 and 96
EPI_CASES = [(300, 1024), (1200, 512), (4800, 256), (19200, 128), (37, 32),
             (200, 96)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", EPI_CASES, ids=lambda c: f"{c[0]}x{c[1]}")
def test_block_epilogue_infer_matches_plain(cuda, case, dtype):
    m, c = case
    a = _epilogue_case(m, m, c, 4 * c, dtype, cuda)
    before = ei.block_epilogue_infer.launches
    got = ei.block_epilogue_infer(**a)
    torch.cuda.synchronize()
    assert ei.block_epilogue_infer.launches == before + 1
    want = ei.block_epilogue_infer_reference(**a)
    assert got.dtype == dtype and got.shape == (m, c)
    _close(got, want, ei.tolerance(dtype))
    assert torch.equal(got, ei.block_epilogue_infer(**a))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", EPI_CASES + [(50, 64, 96), (64, 128, 32)],
                         ids=lambda c: "x".join(map(str, c)))
def test_mlp_infer_matches_plain(cuda, case, dtype):
    m, c = case[:2]
    c2 = case[2] if len(case) > 2 else c
    a = _epilogue_case(m + 1, m, c, 4 * c, dtype, cuda, c2)
    args = (a["o"], a["w1"], a["b1"], a["w2"], a["b2"])
    before = mi.mlp_infer.launches
    got = mi.mlp_infer(*args)
    torch.cuda.synchronize()
    assert mi.mlp_infer.launches == before + 1
    want = mi.mlp_infer_reference(*args)
    assert got.dtype == dtype and got.shape == (m, c2)
    _close(got, want, mi.tolerance(dtype))


# (M, C, H) of the bf16 chain on the wgmma core (csrc/gemm_sm90.cuh): the four
# stages of a 480x640 batch-8 forward, row counts below one 128-row tile,
# ragged row counts, widths of 32 and 96, and a hidden that is no multiple
# of the 64-wide k-block
CORE_EPI_CASES = [(2400, 1024, 4096), (9600, 512, 2048), (38400, 256, 1024),
                  (153600, 128, 512), (37, 128, 512), (37, 512, 2048),
                  (1000, 256, 1024), (77, 32, 128), (333, 96, 384),
                  (130, 128, 96)]


@pytest.mark.parametrize("case", CORE_EPI_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_block_epilogue_infer_bf16_on_the_gemm_core(cuda, case):
    """The bf16 chain against the plain version at the unchanged tolerance;
    a rerun bit-equal; one counted launch a call."""
    m, c, hidden = case
    a = _epilogue_case(m + c, m, c, hidden, torch.bfloat16, cuda)
    before = ei.block_epilogue_infer.launches
    got = ei.block_epilogue_infer(**a)
    again = ei.block_epilogue_infer(**a)
    torch.cuda.synchronize()
    assert ei.block_epilogue_infer.launches == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == (m, c)
    _close(got, ei.block_epilogue_infer_reference(**a),
           ei.tolerance(torch.bfloat16))
    assert torch.equal(got, again)


@pytest.mark.parametrize("case", CORE_EPI_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_mlp_infer_bf16_on_the_gemm_core(cuda, case):
    """The bf16 FFN chain (two products through the bf16 hidden) against
    the plain version at the unchanged tolerance; a rerun bit-equal; one
    counted launch a call."""
    m, c, hidden = case
    a = _epilogue_case(m + hidden, m, c, hidden, torch.bfloat16, cuda)
    args = (a["o"], a["w1"], a["b1"], a["w2"], a["b2"])
    before = mi.mlp_infer.launches
    got = mi.mlp_infer(*args)
    again = mi.mlp_infer(*args)
    torch.cuda.synchronize()
    assert mi.mlp_infer.launches == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == (m, c)
    _close(got, mi.mlp_infer_reference(*args), mi.tolerance(torch.bfloat16))
    assert torch.equal(got, again)


def test_block_epilogue_infer_takes_unaligned_layer_norm_vectors(cuda):
    """LayerNorm scale and bias one float off a 16-byte boundary: the bf16
    chain's LayerNorm reads them one at a time, with the same result."""
    a = _epilogue_case(11, 300, 256, 1024, torch.bfloat16, cuda)
    views = {}
    for k in ("lns", "lnb"):
        buf = torch.empty(257, device=cuda)
        buf[1:] = a[k]
        views[k] = buf[1:]
    assert views["lns"].data_ptr() % 16
    torch.testing.assert_close(ei.block_epilogue_infer(**dict(a, **views)),
                               ei.block_epilogue_infer(**a), atol=0, rtol=0)


def test_epilogue_kernels_take_linear_weights_without_a_copy(cuda):
    """The ``.t()`` view of a Linear weight [out, in] is the JAX [in, out]
    layout; a contiguous [in, out] tensor gives the same answer."""
    a = _epilogue_case(5, 64, 128, 512, torch.bfloat16, cuda)
    views = {k: a[k].t().contiguous().t() for k in ("wproj", "w1", "w2")}
    torch.testing.assert_close(ei.block_epilogue_infer(**dict(a, **views)),
                               ei.block_epilogue_infer(**a), atol=0, rtol=0)


def test_epilogue_kernels_refuse_what_they_do_not_take(cuda):
    a = _epilogue_case(6, 16, 48, 192, torch.float32, cuda)
    with pytest.raises(ValueError, match="multiples of 32"):
        ei.block_epilogue_infer(**a)
    a = _epilogue_case(6, 16, 64, 256, torch.float32, cuda)
    with pytest.raises(TypeError):
        ei.block_epilogue_infer(**dict(a, w1=a["w1"].bfloat16()))
    with pytest.raises(ValueError, match="contiguous"):
        mi.mlp_infer(a["o"].t().contiguous().t(), a["w1"], a["b1"], a["w2"],
                     a["b2"])
    # contiguous rows one element off a 16-byte boundary
    o = torch.zeros(16 * 64 + 1, dtype=torch.bfloat16, device=cuda)[1:]
    with pytest.raises(ValueError, match="aligned"):
        mi.mlp_infer(o.view(16, 64), a["w1"], a["b1"], a["w2"], a["b2"])


@pytest.mark.parametrize("mode,counts", [("fused", (4, 4, 0)),
                                         ("pair", (4, 0, 4)),
                                         ("plain", (0, 0, 0))])
def test_sam_model_on_the_card_matches_the_plain_model(cuda, mode, counts):
    """MobileV3SAMDepth at 1x3x64x96 f32, each mode against the plain model on
    the card (summation order only), and the kernels each forward launches."""
    from tpudepth_torch.models.layers import init_random_
    from tpudepth_torch.models.registry import build_model

    plain = init_random_(build_model("sam", attn="plain"), seed=0)
    model = build_model("sam", attn=mode)
    model.load_state_dict(plain.state_dict())
    x = torch.rand(1, 3, 64, 96, generator=torch.Generator().manual_seed(1))
    x = x.to(cuda).contiguous(memory_format=torch.channels_last)
    fns = (wai.window_attention_infer, ei.block_epilogue_infer, mi.mlp_infer)
    with torch.no_grad():
        want = plain.to(cuda).eval()(x)
        before = [f.launches for f in fns]
        got = model.to(cuda).eval()(x)
    torch.cuda.synchronize()
    assert tuple(f.launches - b for f, b in zip(fns, before)) == counts
    assert float((got - want).norm() / want.norm()) < 1e-5


# -- NewCRF serving and SAM's row mode: crf_rowblock_infer, sam_rowblock_infer

from tpudepth_torch.ops.kernels import rowblock_infer as rbi  # noqa: E402


def _rowblock_case(seed, bsz, h, w, c, heads, shift, dtype, device, sam=False,
                   ws=7):
    """Keyword arguments of one block call: raw x, v zero-padded to window
    multiples (and rolled by -shift), weights [in, out], vectors, bias, the
    shift mask and the valid extent."""
    g = torch.Generator().manual_seed(seed)
    hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
    hidden = 4 * c

    def n(*shape, s=1.0, mean=0.0):
        return (mean + s * torch.randn(*shape, generator=g)).to(device)

    x = torch.zeros(bsz, hp, wp, c, device=device)
    v = torch.zeros(bsz, hp, wp, c, device=device)
    x[:, :h, :w] = n(bsz, h, w, c)
    v[:, :h, :w] = n(bsz, h, w, c)
    if shift:
        x, v = (torch.roll(t, (-shift, -shift), dims=(1, 2)) for t in (x, v))
    ln = lambda: (n(c, s=0.2, mean=1.0), n(c, s=0.1))  # noqa: E731
    a = dict(x=x.to(dtype).contiguous(), v=v.to(dtype).contiguous(), ln1=ln())
    if sam:
        a.update(lnv=ln(), wq=n(c, c, s=c ** -0.5), bq=n(c, s=0.1),
                 wkv=n(c, 2 * c, s=c ** -0.5), bkv=n(2 * c, s=0.1))
    else:
        a.update(wqk=n(c, 2 * c, s=c ** -0.5), bqk=n(2 * c, s=0.1))
    a.update(bias=n(heads, ws * ws, ws * ws, s=0.5),
             wproj=n(c, c, s=c ** -0.5), bproj=n(c, s=0.1), ln2=ln(),
             w1=n(c, hidden, s=c ** -0.5), b1=n(hidden, s=0.1),
             w2=n(hidden, c, s=hidden ** -0.5), b2=n(c, s=0.1))
    kw = dict(scale=(c // heads) ** -0.5, window_size=ws)
    if sam:
        kw["valid_hw"] = (h, w)
    else:
        a["mask"] = (torch.from_numpy(shifted_window_attention_mask(
            h, w, ws, shift)).to(device) if shift else None)
        kw["valid_hw"] = (h, w, shift)
    return a, kw


# (B, h, w, C, heads): an odd geometry padded in H and W (14x14, C 32 with
# head width 8), NewCRF's crf1 and crf3 stages at 480x640 batch 1
ROW_CASES = [(2, 10, 13, 32, 4), (1, 60, 80, 256, 8), (1, 15, 20, 1024, 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shift", [0, 3], ids=["shift0", "shift3"])
@pytest.mark.parametrize("case", ROW_CASES, ids=["odd", "crf1", "crf3"])
def test_crf_rowblock_infer_matches_plain(cuda, case, shift, dtype):
    a, kw = _rowblock_case(sum(case) + shift, *case, shift, dtype, cuda)
    before = rbi.crf_rowblock_infer.launches
    got = rbi.crf_rowblock_infer(**a, **kw)
    torch.cuda.synchronize()
    assert rbi.crf_rowblock_infer.launches == before + 1
    want = rbi.crf_rowblock_infer_reference(**a, **kw)
    assert got.dtype == dtype and got.shape == a["x"].shape
    _close(got, want, rbi.tolerance(dtype))
    assert torch.equal(got, rbi.crf_rowblock_infer(**a, **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ROW_CASES, ids=["odd", "crf1", "crf3"])
def test_sam_rowblock_infer_matches_plain(cuda, case, dtype):
    a, kw = _rowblock_case(sum(case) + 1, *case, 0, dtype, cuda, sam=True)
    before = rbi.sam_rowblock_infer.launches
    got = rbi.sam_rowblock_infer(**a, **kw)
    torch.cuda.synchronize()
    assert rbi.sam_rowblock_infer.launches == before + 1
    want = rbi.sam_rowblock_infer_reference(**a, **kw)
    assert got.dtype == dtype and got.shape == a["x"].shape
    _close(got, want, rbi.tolerance(dtype))
    assert torch.equal(got, rbi.sam_rowblock_infer(**a, **kw))


# (B, h, w, C, heads) of SAM's four stages at 480x640, batch 1 and 8: every
# map pads (21x21 .. 126x161)
SAM_STAGE_CASES = [(bsz, *hw, c, heads) for bsz in (1, 8)
                   for c, heads, hw in ((1024, 32, (15, 20)),
                                        (512, 16, (30, 40)),
                                        (256, 8, (60, 80)),
                                        (128, 4, (120, 160)))]
SAM_STAGE_IDS = [f"{s}-B{b}" for b in (1, 8)
                 for s in ("crf3", "crf2", "crf1", "crf0")]


@pytest.mark.parametrize("case", SAM_STAGE_CASES, ids=SAM_STAGE_IDS)
def test_sam_rowblock_infer_bf16_on_the_gemm_core(cuda, case):
    """The bf16 route (projections and tail on the wgmma core, the tail's
    GELU by table) against the plain version at the stage shapes, one
    counted call, a rerun bit-equal."""
    a, kw = _rowblock_case(sum(case) + 7, *case, 0, torch.bfloat16, cuda,
                           sam=True)
    before = rbi.sam_rowblock_infer.launches
    got = rbi.sam_rowblock_infer(**a, **kw)
    torch.cuda.synchronize()
    assert rbi.sam_rowblock_infer.launches == before + 1
    want = rbi.sam_rowblock_infer_reference(**a, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == a["x"].shape
    _close(got, want, rbi.tolerance(torch.bfloat16))
    assert torch.equal(got, rbi.sam_rowblock_infer(**a, **kw))


@pytest.mark.parametrize("shift", [0, 3], ids=["shift0", "shift3"])
@pytest.mark.parametrize("case", SAM_STAGE_CASES, ids=SAM_STAGE_IDS)
def test_crf_rowblock_infer_bf16_on_the_gemm_core(cuda, case, shift):
    """NewCRF's bf16 route (LN + qk product and the tail chain on the wgmma
    core, the shifted block's rolled validity) against the plain version at
    the stage shapes, one counted call, a rerun bit-equal."""
    a, kw = _rowblock_case(sum(case) + 11 + shift, *case, shift,
                           torch.bfloat16, cuda)
    before = rbi.crf_rowblock_infer.launches
    got = rbi.crf_rowblock_infer(**a, **kw)
    torch.cuda.synchronize()
    assert rbi.crf_rowblock_infer.launches == before + 1
    want = rbi.crf_rowblock_infer_reference(**a, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == a["x"].shape
    _close(got, want, rbi.tolerance(torch.bfloat16))
    assert torch.equal(got, rbi.crf_rowblock_infer(**a, **kw))


def test_rowblock_kernels_take_x_and_v_only_as_whole_rows(cuda):
    """The kernels read x and v as contiguous rows (the strides live inside,
    on the q, k, v scratch): x and v as the two halves of one [B, Hp, Wp,
    2C] tensor are refused, and their contiguous copies give the answer of
    separate tensors bit for bit."""
    a, kw = _rowblock_case(9, 2, 10, 13, 64, 2, 3, torch.bfloat16, cuda)
    xh, vh = torch.cat([a["x"], a["v"]], dim=-1).chunk(2, dim=-1)
    assert not xh.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        rbi.crf_rowblock_infer(**dict(a, x=xh, v=vh), **kw)
    torch.testing.assert_close(
        rbi.crf_rowblock_infer(**dict(a, x=xh.contiguous(),
                                      v=vh.contiguous()), **kw),
        rbi.crf_rowblock_infer(**a, **kw), atol=0, rtol=0)


def test_rowblock_kernels_refuse_what_they_do_not_take(cuda):
    before = (rbi.crf_rowblock_infer.launches, rbi.sam_rowblock_infer.launches)
    a, kw = _rowblock_case(10, 1, 10, 13, 48, 2, 0, torch.float32, cuda)
    with pytest.raises(ValueError, match="multiples of 32"):
        rbi.crf_rowblock_infer(**a, **kw)           # C 48
    a, kw = _rowblock_case(11, 1, 10, 13, 96, 8, 0, torch.float32, cuda)
    with pytest.raises(ValueError, match="head width"):
        rbi.crf_rowblock_infer(**a, **kw)           # head width 12
    a, kw = _rowblock_case(12, 1, 10, 13, 64, 2, 0, torch.float32, cuda,
                           sam=True, ws=9)
    with pytest.raises(ValueError, match="64 tokens"):
        rbi.sam_rowblock_infer(**a, **kw)           # 81 tokens a window
    a, kw = _rowblock_case(13, 1, 10, 13, 64, 2, 0, torch.bfloat16, cuda)
    x = torch.zeros(a["x"].numel() + 1, dtype=torch.bfloat16, device=cuda)[1:]
    with pytest.raises(ValueError, match="aligned"):
        rbi.crf_rowblock_infer(**dict(a, x=x.view(a["x"].shape)), **kw)
    with pytest.raises(TypeError):
        rbi.crf_rowblock_infer(**dict(a, x=a["x"].half(), v=a["v"].half()),
                               **kw)
    assert (rbi.crf_rowblock_infer.launches,
            rbi.sam_rowblock_infer.launches) == before   # nothing fell back


@pytest.mark.parametrize("mode,counts", [("row", (8, 0, 0, 0)),
                                         ("fused", (0, 8, 8, 0)),
                                         ("pair", (0, 8, 0, 8)),
                                         ("plain", (0, 0, 0, 0))])
def test_newcrf_model_on_the_card_matches_the_plain_model(cuda, mode, counts):
    """MobileV3NewCRFDepth at 1x3x64x96 f32, each mode against the plain
    model on the card (summation order only), and the kernels each forward
    launches (two blocks a stage)."""
    from tpudepth_torch.models.layers import init_random_
    from tpudepth_torch.models.registry import build_model

    plain = init_random_(build_model("newcrf", attn="plain"), seed=0)
    model = build_model("newcrf", attn=mode)
    model.load_state_dict(plain.state_dict())
    x = torch.rand(1, 3, 64, 96, generator=torch.Generator().manual_seed(2))
    x = x.to(cuda).contiguous(memory_format=torch.channels_last)
    fns = (rbi.crf_rowblock_infer, wai.window_attention_infer,
           ei.block_epilogue_infer, mi.mlp_infer)
    with torch.no_grad():
        want = plain.to(cuda).eval()(x)
        before = [f.launches for f in fns]
        got = model.to(cuda).eval()(x)
    torch.cuda.synchronize()
    assert tuple(f.launches - b for f, b in zip(fns, before)) == counts
    assert float((got - want).norm() / want.norm()) < 1e-5


def test_sam_row_model_on_the_card_matches_the_plain_model(cuda):
    from tpudepth_torch.models.layers import init_random_
    from tpudepth_torch.models.registry import build_model

    plain = init_random_(build_model("sam", attn="plain"), seed=0)
    model = build_model("sam", attn="row")
    model.load_state_dict(plain.state_dict())
    x = torch.rand(1, 3, 64, 96, generator=torch.Generator().manual_seed(3))
    x = x.to(cuda).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        want = plain.to(cuda).eval()(x)
        before = rbi.sam_rowblock_infer.launches
        got = model.to(cuda).eval()(x)
    torch.cuda.synchronize()
    assert rbi.sam_rowblock_infer.launches - before == 4
    assert float((got - want).norm() / want.norm()) < 1e-5


# -- SAM / NewCRF training: window_attn_train_fwd / _bwd, mlp_train_fwd / _bwd

from tpudepth_torch.ops.kernels import mlp_train as mt  # noqa: E402
from tpudepth_torch.ops.kernels import window_attn as wat  # noqa: E402


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "shift"])
@pytest.mark.parametrize("case", ATTN_CASES, ids=["crf3", "crf2", "crf1", "crf0"])
def test_window_attn_train_matches_plain(cuda, case, masked, dtype):
    """Forward and backward at the four stage shapes of batch 1; a rerun of
    the backward is bit-equal (dbias adds its partial sums in a fixed
    order)."""
    bw, c, heads, hw = case
    q, k, v, bias = _attn_case(bw + 1, bw, 49, c, heads, dtype, cuda)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(bw)).to(
        cuda, dtype)
    mask = None
    if masked:
        mask = torch.from_numpy(shifted_window_attention_mask(*hw, 7, 3)).to(cuda)
    before = (wat.window_attention_fwd.launches,
              wat.window_attention_bwd.launches)
    out = wat.window_attention_fwd(q, k, v, bias, mask)
    grads = wat.window_attention_bwd(q, k, v, bias, mask, g)
    torch.cuda.synchronize()
    assert (wat.window_attention_fwd.launches,
            wat.window_attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    _close(out, wat.window_attention_fwd_reference(q, k, v, bias, mask),
           wat.fwd_tolerance(dtype))
    want = wat.window_attention_bwd_reference(q, k, v, bias, mask, g)
    tol, dbias_tol = wat.bwd_tolerance(dtype)
    for got, ref in zip(grads[:3], want[:3]):
        assert got.dtype == dtype and got.shape == q.shape
        _close(got, ref, tol)
    assert grads[3].dtype == torch.float32
    _close(grads[3], want[3], dbias_tol)
    again = wat.window_attention_bwd(q, k, v, bias, mask, g)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


def test_window_attn_train_takes_odd_shapes_and_strided_k_v(cuda):
    """7 windows of 16 tokens, head width 8, a random mask of 7 windows; k
    and v as the halves of one projection."""
    q, k, v, bias = _attn_case(5, 7, 16, 16, 2, torch.float32, cuda)
    kh, vh = torch.cat([k, v], dim=-1).chunk(2, dim=-1)
    mask = (torch.rand(7, 16, 16, device=cuda) > 0.5).float() * -100.0
    g = torch.randn_like(q)
    got = wat.window_attention_bwd(q, kh, vh, bias, mask, g)
    want = wat.window_attention_bwd_reference(q, k, v, bias, mask, g)
    tol, dbias_tol = wat.bwd_tolerance(torch.float32)
    for a, b in zip(got[:3], want[:3]):
        _close(a, b, tol)
    _close(got[3], want[3], dbias_tol)


def test_window_attention_function_on_the_card(cuda):
    """The autograd.Function launches one forward and one backward, and its
    gradients are the backward kernel's."""
    q, k, v, bias = _attn_case(6, 12, 49, 64, 2, torch.bfloat16, cuda)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    b = bias.clone().requires_grad_()
    g = torch.randn_like(q)
    before = (wat.window_attention_fwd.launches,
              wat.window_attention_bwd.launches)
    wat.window_attention(q, k, v, b).backward(g)
    assert (wat.window_attention_fwd.launches - before[0],
            wat.window_attention_bwd.launches - before[1]) == (1, 1)
    want = wat.window_attention_bwd(q.detach(), k.detach(), v.detach(),
                                    bias, None, g)
    for t, w in zip((q, k, v, b), want):
        assert torch.equal(t.grad, w)


def _bwd_holds(q, k, v, bias, mask, g):
    """One counted backward against the plain version within the unchanged
    ``bwd_tolerance`` (dq, dk, dv in q's dtype; dbias f32), a rerun
    bit-equal, dbias included."""
    before = wat.window_attention_bwd.launches
    grads = wat.window_attention_bwd(q, k, v, bias, mask, g)
    torch.cuda.synchronize()
    assert wat.window_attention_bwd.launches == before + 1
    want = wat.window_attention_bwd_reference(q, k, v, bias, mask, g)
    tol, dbias_tol = wat.bwd_tolerance(q.dtype)
    for got, ref in zip(grads[:3], want[:3]):
        assert got.dtype == q.dtype and got.shape == q.shape
        _close(got, ref, tol)
    assert grads[3].dtype == torch.float32
    _close(grads[3], want[3], dbias_tol)
    again = wat.window_attention_bwd(q, k, v, bias, mask, g)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


# 259 windows (7 an image) of 8 heads: bwd_chunk gives chunks of 3 windows,
# the last one of 1
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "mask"])
@pytest.mark.parametrize("d", [8, 16, 24, 32, 64])
@pytest.mark.parametrize("n", [16, 33, 49, 64])
def test_window_attn_train_bwd_bf16_on_the_tensor_cores(cuda, n, d, masked):
    """The bf16 backward at every token count and head width class the
    kernel takes (d rounded up to 16, 16 .. 64 tokens), with and without a
    mask of 7 windows, over a chunking whose last chunk is short."""
    bw, heads = 259, 8
    chunk = wat.bwd_chunk(bw, heads)
    assert bw % chunk
    q, k, v, bias = _attn_case(n + d, bw, n, heads * d, heads,
                               torch.bfloat16, cuda)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(n)).to(
        cuda, torch.bfloat16)
    mask = None
    if masked:
        gen = torch.Generator().manual_seed(d)
        mask = ((torch.rand(7, n, n, generator=gen) > 0.6).float()
                * -100.0).to(cuda)
    _bwd_holds(q, k, v, bias, mask, g)


def test_window_attn_train_bwd_bf16_reads_strided_and_unaligned_rows(cuda):
    """k and v as the halves of one projection (rows 2C apart, 16-byte
    aligned: copied by cp.async) and q as C of C + 4 columns (rows not
    16-byte aligned: copied by plain loads)."""
    bw, n, c, heads = 21, 49, 64, 2
    q, k, v, bias = _attn_case(3, bw, n, c, heads, torch.bfloat16, cuda)
    kh, vh = torch.cat([k, v], dim=-1).chunk(2, dim=-1)
    wide = torch.zeros(bw, n, c + 4, dtype=torch.bfloat16, device=cuda)
    wide[..., :c] = q
    qw = wide[..., :c]
    assert qw.stride(1) == c + 4
    g = torch.randn_like(q)
    _bwd_holds(qw, kh, vh, bias, None, g)
    want = wat.window_attention_bwd(q, k, v, bias, None, g)
    got = wat.window_attention_bwd(qw, kh, vh, bias, None, g)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# the two C entries of the bf16 forward on the tensor cores (window_attn.cuh):
# (wrapper, plain version, tolerance)
FWD_ENTRIES = {
    "infer": (wai.window_attention_infer,
              wai.window_attention_infer_reference, wai.tolerance),
    "train": (wat.window_attention_fwd, wat.window_attention_fwd_reference,
              wat.fwd_tolerance),
}


def _fwd_holds(entry, q, k, v, bias, mask):
    """One counted bf16 forward of ``entry`` against its plain version
    within the unchanged tolerance, a rerun bit-equal; returns the
    output."""
    fn, plain, tol = FWD_ENTRIES[entry]
    before = fn.launches
    got = fn(q, k, v, bias, mask)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, plain(q, k, v, bias, mask), tol(q.dtype))
    assert torch.equal(got, fn(q, k, v, bias, mask))
    return got


# 259 windows (7 an image) of 8 heads: fwd_chunk gives chunks of 2 windows,
# the last one of 1
@pytest.mark.parametrize("entry", sorted(FWD_ENTRIES))
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "mask"])
@pytest.mark.parametrize("d", [8, 16, 24, 32, 64])
@pytest.mark.parametrize("n", [16, 33, 49, 64])
def test_window_attn_fwd_bf16_on_the_tensor_cores(cuda, n, d, masked, entry):
    """Both bf16 forwards at every token count and head width class the
    kernel takes (d rounded up to 16, 16 .. 64 tokens), with and without a
    mask of 7 windows, over a chunking whose last chunk is short."""
    bw, heads = 259, 8
    assert bw % wai.fwd_chunk(bw, heads)
    q, k, v, bias = _attn_case(n + d + 1, bw, n, heads * d, heads,
                               torch.bfloat16, cuda)
    mask = None
    if masked:
        gen = torch.Generator().manual_seed(d + 1)
        mask = ((torch.rand(7, n, n, generator=gen) > 0.6).float()
                * -100.0).to(cuda)
    _fwd_holds(entry, q, k, v, bias, mask)


@pytest.mark.parametrize("entry", sorted(FWD_ENTRIES))
def test_window_attn_fwd_bf16_reads_strided_and_unaligned_rows(cuda, entry):
    """k and v as the halves of one projection (rows 2C apart, 16-byte
    aligned: copied by cp.async) and q as C of C + 4 columns (rows not
    16-byte aligned: copied by plain loads) give the bits of contiguous
    inputs."""
    bw, n, c, heads = 21, 49, 64, 2
    q, k, v, bias = _attn_case(4, bw, n, c, heads, torch.bfloat16, cuda)
    kh, vh = torch.cat([k, v], dim=-1).chunk(2, dim=-1)
    wide = torch.zeros(bw, n, c + 4, dtype=torch.bfloat16, device=cuda)
    wide[..., :c] = q
    qw = wide[..., :c]
    assert qw.stride(1) == c + 4
    want = _fwd_holds(entry, q, k, v, bias, None)
    assert torch.equal(_fwd_holds(entry, q, kh, vh, bias, None), want)
    assert torch.equal(_fwd_holds(entry, qw, kh, vh, bias, None), want)


def test_window_attention_function_with_the_mask_on_the_card(cuda):
    """One bf16 step through ``window_attention`` with the shift-3 mask of
    the crf1 map: the gradients autograd hands back are the backward
    kernel's, the mask gets none."""
    from tpudepth_torch.ops.window import shifted_window_attention_mask

    q, k, v, bias = _attn_case(7, 108, 49, 256, 8, torch.bfloat16, cuda)
    mask = torch.from_numpy(shifted_window_attention_mask(63, 84, 7, 3)).to(
        cuda)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    b = bias.clone().requires_grad_()
    g = torch.randn_like(q)
    before = (wat.window_attention_fwd.launches,
              wat.window_attention_bwd.launches)
    wat.window_attention(q, k, v, b, mask).backward(g)
    assert (wat.window_attention_fwd.launches - before[0],
            wat.window_attention_bwd.launches - before[1]) == (1, 1)
    want = wat.window_attention_bwd(q.detach(), k.detach(), v.detach(),
                                    bias, mask, g)
    for t, w in zip((q, k, v, b), want):
        assert torch.equal(t.grad, w)


def test_window_attn_train_refuses_what_it_does_not_take(cuda):
    q, k, v, bias = _attn_case(4, 4, 49, 60, 3, torch.float32, cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        wat.window_attention_fwd(q, k, v, bias)    # head_dim 20
    with pytest.raises(ValueError, match="multiple of 8"):
        wat.window_attention_bwd(q, k, v, bias, None, q)
    q, k, v, bias = _attn_case(4, 4, 81, 64, 2, torch.float32, cuda)
    with pytest.raises(ValueError, match="N <= 64"):
        wat.window_attention_bwd(q, k, v, bias, None, q)
    q, k, v, bias = _attn_case(4, 4, 49, 64, 2, torch.float16, cuda)
    with pytest.raises(TypeError):
        wat.window_attention_fwd(q, k, v, bias)
    q, k, v, bias = _attn_case(4, 4, 49, 64, 2, torch.bfloat16, cuda)
    with pytest.raises(TypeError):
        wat.window_attention_bwd(q, k, v, bias, None, q.float())


def _mlp_case(seed, m, c, hidden, dtype, device, c2=None):
    g = torch.Generator().manual_seed(seed)
    c2 = c2 or c

    def n(*shape, s=1.0):
        return (s * torch.randn(*shape, generator=g)).to(device)

    return (n(m, c).to(dtype), n(c, hidden, s=c ** -0.5), n(hidden, s=0.1),
            n(hidden, c2, s=hidden ** -0.5), n(c2, s=0.1),
            n(m, c2).to(dtype))


# (M, C): the four stages' rows at 480x640 batch 1, odd row counts, widths
# of 32 and 96
MLP_CASES = [(300, 1024), (1200, 512), (4800, 256), (19200, 128), (37, 32),
             (201, 96)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", MLP_CASES, ids=lambda c: f"{c[0]}x{c[1]}")
def test_mlp_train_matches_plain(cuda, case, dtype):
    """Forward and backward; a rerun of the backward is bit-equal (the
    weight gradients add their partial sums in a fixed order)."""
    m, c = case
    x, w1, b1, w2, b2, g = _mlp_case(m + c, m, c, 4 * c, dtype, cuda)
    before = (mt.mlp_train_fwd.launches, mt.mlp_train_bwd.launches)
    out = mt.mlp_train_fwd(x, w1, b1, w2, b2)
    grads = mt.mlp_train_bwd(x, g, w1, b1, w2)
    torch.cuda.synchronize()
    assert (mt.mlp_train_fwd.launches,
            mt.mlp_train_bwd.launches) == (before[0] + 1, before[1] + 1)
    out_tol, w_tol = mt.tolerance(dtype)
    _close(out, mt.mlp_train_fwd_reference(x, w1, b1, w2, b2), out_tol)
    want = mt.mlp_train_bwd_reference(x, g, w1, b1, w2)
    flips = mt.flip_atol(x, g, w1, b1, w2)
    assert grads[0].dtype == dtype
    _close(grads[0], want[0], out_tol, flips[0])
    for got, ref, flip in zip(grads[1:], want[1:], flips[1:]):
        assert got.dtype == torch.float32 and got.shape == ref.shape
        _close(got, ref, w_tol, flip)
    again = mt.mlp_train_bwd(x, g, w1, b1, w2)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


# (M, C, H, C2) of the bf16 backward on the wgmma core: the four stages of a
# 480x640 batch-8 step, a row count below one 128-row tile, ragged row
# counts (also past one 64-row k-block of the weight-gradient chunks),
# widths of 32 and 96 and a narrower output
CORE_MLP_CASES = [(2400, 1024, 4096, 1024), (9600, 512, 2048, 512),
                  (38400, 256, 1024, 256), (153600, 128, 512, 128),
                  (37, 128, 512, 128), (1000, 256, 1024, 256),
                  (77, 32, 128, 32), (333, 96, 384, 96),
                  (4999, 128, 512, 96)]


@pytest.mark.parametrize("case", CORE_MLP_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_mlp_train_bwd_bf16_on_the_gemm_core(cuda, case):
    """The bf16 backward against the plain version at the unchanged
    tolerance and flip_atol; a rerun bit-equal; one counted launch a
    call."""
    m, c, hidden, c2 = case
    x, w1, b1, w2, _, g = _mlp_case(m + hidden, m, c, hidden, torch.bfloat16,
                                    cuda, c2=c2)
    before = mt.mlp_train_bwd.launches
    grads = mt.mlp_train_bwd(x, g, w1, b1, w2)
    again = mt.mlp_train_bwd(x, g, w1, b1, w2)
    torch.cuda.synchronize()
    assert mt.mlp_train_bwd.launches == before + 2
    out_tol, w_tol = mt.tolerance(torch.bfloat16)
    want = mt.mlp_train_bwd_reference(x, g, w1, b1, w2)
    flips = mt.flip_atol(x, g, w1, b1, w2)
    assert grads[0].dtype == torch.bfloat16 and grads[0].shape == (m, c)
    _close(grads[0], want[0], out_tol, flips[0])
    for got, ref, flip in zip(grads[1:], want[1:], flips[1:]):
        assert got.dtype == torch.float32 and got.shape == ref.shape
        _close(got, ref, w_tol, flip)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.parametrize("case", CORE_MLP_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_mlp_train_fwd_bf16_on_the_gemm_core(cuda, case):
    """The bf16 forward (mlp_infer's chain, the biases rounded to bf16)
    against the plain version at the unchanged tolerance, also where
    C2 != C; a rerun bit-equal; one counted launch a call."""
    m, c, hidden, c2 = case
    x, w1, b1, w2, b2, _ = _mlp_case(m + c2, m, c, hidden, torch.bfloat16,
                                     cuda, c2=c2)
    before = mt.mlp_train_fwd.launches
    got = mt.mlp_train_fwd(x, w1, b1, w2, b2)
    again = mt.mlp_train_fwd(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert mt.mlp_train_fwd.launches == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == (m, c2)
    _close(got, mt.mlp_train_fwd_reference(x, w1, b1, w2, b2),
           mt.tolerance(torch.bfloat16)[0])
    assert torch.equal(got, again)


_FRESH_FORWARD = """
import torch
from tpudepth_torch.ops.kernels import mlp_train as mt
g = torch.Generator().manual_seed(3)
x = torch.randn(300, 256, generator=g).cuda().bfloat16()
w1 = (torch.randn(256, 1024, generator=g) / 16).cuda()
b1 = (0.1 * torch.randn(1024, generator=g)).cuda()
w2 = (torch.randn(1024, 256, generator=g) / 32).cuda()
b2 = (0.1 * torch.randn(256, generator=g)).cuda()
got = mt.mlp_train_fwd(x, w1, b1, w2, b2)
torch.cuda.synchronize()
want = mt.mlp_train_fwd_reference(x, w1, b1, w2, b2)
frac, rtol = mt.tolerance(torch.bfloat16)[0]
d = (got.float() - want.float()).abs()
ok = bool((d <= frac * want.float().abs().max() + rtol * want.float().abs())
          .all())
print("fresh forward", "ok" if ok else "FAILED", float(d.max()))
"""


def test_mlp_train_fwd_bf16_fills_its_own_gelu_table(cuda):
    """Each library holds its own GELU table: a bf16 mlp_train_fwd in a
    fresh process, before any other bf16 kernel of the package, fills its
    table before its first product reads it."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    run = subprocess.run([sys.executable, "-c", _FRESH_FORWARD], cwd=root,
                         env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    assert "fresh forward ok" in run.stdout, run.stdout


def test_mlp_train_takes_a_narrower_output_and_linear_weights(cuda):
    """C2 != C, and the .t() views of Linear weights as the Mlp layer passes
    them, through the autograd.Function."""
    x, w1, b1, w2, b2, g = _mlp_case(7, 150, 64, 256, torch.bfloat16, cuda,
                                     c2=96)
    fc1, fc2 = w1.t().contiguous(), w2.t().contiguous()
    params = [fc1.requires_grad_(), b1.requires_grad_(),
              fc2.requires_grad_(), b2.requires_grad_()]
    xr = x.clone().requires_grad_()
    mt.mlp_train(xr, fc1.t(), b1, fc2.t(), b2).backward(g)
    want = mt.mlp_train_bwd(x, g, w1, b1.detach(), w2)
    assert torch.equal(xr.grad, want[0])
    assert torch.equal(fc1.grad, want[1].t()) and torch.equal(b1.grad, want[2])
    assert torch.equal(fc2.grad, want[3].t()) and torch.equal(b2.grad, want[4])


def test_mlp_train_refuses_what_it_does_not_take(cuda):
    x, w1, b1, w2, b2, g = _mlp_case(8, 16, 48, 192, torch.float32, cuda)
    with pytest.raises(ValueError, match="multiples of 32"):
        mt.mlp_train_fwd(x, w1, b1, w2, b2)
    with pytest.raises(ValueError, match="multiples of 32"):
        mt.mlp_train_bwd(x, g, w1, b1, w2)
    x, w1, b1, w2, b2, g = _mlp_case(8, 16, 64, 256, torch.float16, cuda)
    with pytest.raises(TypeError):
        mt.mlp_train_bwd(x, g, w1, b1, w2)
    x, w1, b1, w2, b2, g = _mlp_case(8, 16, 64, 256, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        mt.mlp_train_bwd(x, g.float(), w1, b1, w2)


@pytest.mark.parametrize("name,mode,per_step", [
    ("sam", "fused", (4, 4, 4, 4)), ("sam", "row", (4, 4, 4, 4)),
    ("newcrf", "row", (8, 8, 8, 8)), ("newcrf", "pair", (8, 8, 8, 8))])
def test_attention_models_train_on_the_card_like_the_plain_model(
        cuda, name, mode, per_step):
    """One f32 train-mode forward and backward at 2x3x64x96 in a kernel mode
    against the plain mode on the card, and the training kernels' launches
    (attention forward, backward, FFN forward, backward)."""
    from tpudepth_torch.models.layers import init_random_
    from tpudepth_torch.models.registry import build_model

    weights = init_random_(build_model(name, attn="plain"), seed=0).state_dict()
    x = torch.rand(2, 3, 64, 96, generator=torch.Generator().manual_seed(1))
    x = x.to(cuda).contiguous(memory_format=torch.channels_last)
    fns = (wat.window_attention_fwd, wat.window_attention_bwd,
           mt.mlp_train_fwd, mt.mlp_train_bwd)
    res = {}
    for m in ("plain", mode):
        model = build_model(name, attn=m)
        model.load_state_dict(weights)
        model.to(cuda).train()
        before = [f.launches for f in fns]
        y = model(x)
        y.square().mean().backward()
        torch.cuda.synchronize()
        counts = tuple(f.launches - b for f, b in zip(fns, before))
        assert counts == (per_step if m == mode else (0, 0, 0, 0)), (m, counts)
        res[m] = (y.detach(), {n: p.grad for n, p in model.named_parameters()})
    (y, g), (y0, g0) = res[mode], res["plain"]
    assert float((y - y0).norm() / y0.norm()) < 1e-5
    floor = 1e-6 * max(float(t.abs().max()) for t in g0.values())
    for n, t in g.items():
        assert float((t - g0[n]).abs().max()) <= max(
            1e-3 * float(g0[n].abs().max()), floor), n


# -- the whole-block mode of SAM and NewCRF: crf_block_infer, sam_block_infer

from tpudepth_torch.ops.kernels import block_infer as bi  # noqa: E402
from tpudepth_torch.ops.window import (  # noqa: E402
    window_partition,
    window_valid_mask_on,
)


def _block_case(seed, bsz, h, w, c, heads, shift, dtype, device, sam=False,
                ws=7):
    """Keyword arguments of one whole-block call: the raw windows of
    ``_rowblock_case``'s padded (and rolled) x and v, its weights, bias and
    mask, and the valid table of the map (None without pad)."""
    a, kw = _rowblock_case(seed, bsz, h, w, c, heads, shift, dtype, device,
                           sam=sam, ws=ws)
    n = ws * ws
    a["xw"], a["vw"] = (window_partition(a.pop(k), ws).reshape(-1, n, c)
                        .contiguous() for k in ("x", "v"))
    a["valid"] = window_valid_mask_on(h, w, ws, shift, device)
    return a, dict(scale=kw["scale"])


# (B, h, w, C, heads): the four stages at 480x640, B 1 and 8, every one
# padded; an odd geometry padded in H and W (C 32, head width 8); and a map
# without pad (valid None)
BLOCK_CASES = [(bsz, *hw, c, heads) for c, heads, hw in
               ((1024, 32, (15, 20)), (512, 16, (30, 40)), (256, 8, (60, 80)),
                (128, 4, (120, 160))) for bsz in (1, 8)] + [
                   (2, 10, 13, 32, 4), (1, 14, 21, 64, 2)]
BLOCK_IDS = [f"{s}-B{b}" for s in ("crf3", "crf2", "crf1", "crf0")
             for b in (1, 8)] + ["odd", "nopad"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shift", [0, 3], ids=["shift0", "shift3"])
@pytest.mark.parametrize("case", BLOCK_CASES, ids=BLOCK_IDS)
def test_crf_block_infer_matches_plain(cuda, case, shift, dtype):
    a, kw = _block_case(sum(case) + shift, *case, shift, dtype, cuda)
    before = bi.crf_block_infer.launches
    got = bi.crf_block_infer(**a, **kw)
    torch.cuda.synchronize()
    assert bi.crf_block_infer.launches == before + 1
    want = bi.crf_block_infer_reference(**a, **kw)
    assert got.dtype == dtype and got.shape == a["xw"].shape
    _close(got, want, bi.tolerance(dtype))
    assert torch.equal(got, bi.crf_block_infer(**a, **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", BLOCK_CASES, ids=BLOCK_IDS)
def test_sam_block_infer_matches_plain(cuda, case, dtype):
    a, kw = _block_case(sum(case) + 1, *case, 0, dtype, cuda, sam=True)
    before = bi.sam_block_infer.launches
    got = bi.sam_block_infer(**a, **kw)
    torch.cuda.synchronize()
    assert bi.sam_block_infer.launches == before + 1
    want = bi.sam_block_infer_reference(**a, **kw)
    assert got.dtype == dtype and got.shape == a["xw"].shape
    _close(got, want, bi.tolerance(dtype))
    assert torch.equal(got, bi.sam_block_infer(**a, **kw))


def _sam_block_bf16_holds(a, kw):
    """One counted bf16 ``sam_block_infer`` call against the plain version
    within the unchanged tolerance, a rerun bit-equal."""
    before = bi.sam_block_infer.launches
    got = bi.sam_block_infer(**a, **kw)
    torch.cuda.synchronize()
    assert bi.sam_block_infer.launches == before + 1
    want = bi.sam_block_infer_reference(**a, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == a["xw"].shape
    _close(got, want, bi.tolerance(torch.bfloat16))
    assert torch.equal(got, bi.sam_block_infer(**a, **kw))


@pytest.mark.parametrize("table", [True, False], ids=["valid", "novalid"])
@pytest.mark.parametrize("case", SAM_STAGE_CASES, ids=SAM_STAGE_IDS)
def test_sam_block_infer_bf16_on_the_gemm_core(cuda, case, table):
    """SAM's bf16 whole-block route (projections and the f32-y tail chain on
    the wgmma core) at the stage shapes, with the valid table of the padded
    map and without one (every token real)."""
    a, kw = _block_case(sum(case) + 13, *case, 0, torch.bfloat16, cuda,
                        sam=True)
    if not table:
        a["valid"] = None
    _sam_block_bf16_holds(a, kw)


# (B, h, w, C, heads): row counts that are not multiples of the core's 128-row
# tile (392, 196, 147 rows) at C 32, 96 and 64
@pytest.mark.parametrize("case", [(2, 10, 13, 32, 4), (1, 10, 13, 96, 3),
                                  (3, 7, 7, 64, 2)],
                         ids=["C32", "C96", "C64"])
def test_sam_block_infer_bf16_ragged_rows_and_narrow_widths(cuda, case):
    a, kw = _block_case(sum(case) + 17, *case, 0, torch.bfloat16, cuda,
                        sam=True)
    assert a["xw"].shape[0] * a["xw"].shape[1] % 128
    _sam_block_bf16_holds(a, kw)


def _crf_block_bf16_holds(a, kw):
    """One counted bf16 ``crf_block_infer`` call against the plain version
    within the unchanged tolerance, a rerun bit-equal."""
    before = bi.crf_block_infer.launches
    got = bi.crf_block_infer(**a, **kw)
    torch.cuda.synchronize()
    assert bi.crf_block_infer.launches == before + 1
    want = bi.crf_block_infer_reference(**a, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == a["xw"].shape
    _close(got, want, bi.tolerance(torch.bfloat16))
    assert torch.equal(got, bi.crf_block_infer(**a, **kw))


@pytest.mark.parametrize("table", [True, False], ids=["valid", "novalid"])
@pytest.mark.parametrize("shift", [0, 3], ids=["shift0", "shift3"])
@pytest.mark.parametrize("case", SAM_STAGE_CASES, ids=SAM_STAGE_IDS)
def test_crf_block_infer_bf16_on_the_gemm_core(cuda, case, shift, table):
    """NewCRF's bf16 whole-block route (LN + qk product and the f32-y tail
    chain on the wgmma core, its yn in the output buffer) at the stage
    shapes, both shifts, with the valid table of the padded map and without
    one (every token real)."""
    a, kw = _block_case(sum(case) + 19 + shift, *case, shift, torch.bfloat16,
                        cuda)
    if not table:
        a["valid"] = None
    _crf_block_bf16_holds(a, kw)


# (B, h, w, C, heads): row counts that are not multiples of the core's
# 128-row tile (392, 196, 147 rows) at C 32, 96 and 64, and a map without
# pad (14x21, valid None)
@pytest.mark.parametrize("shift", [0, 3], ids=["shift0", "shift3"])
@pytest.mark.parametrize("case", [(2, 10, 13, 32, 4), (1, 10, 13, 96, 3),
                                  (3, 7, 7, 64, 2), (1, 14, 21, 64, 2)],
                         ids=["C32", "C96", "C64", "nopad"])
def test_crf_block_infer_bf16_ragged_rows_and_narrow_widths(cuda, case,
                                                            shift):
    a, kw = _block_case(sum(case) + 23 + shift, *case, shift, torch.bfloat16,
                        cuda)
    assert a["xw"].shape[0] * a["xw"].shape[1] % 128
    _crf_block_bf16_holds(a, kw)


def test_block_kernels_refuse_what_they_do_not_take(cuda):
    before = (bi.crf_block_infer.launches, bi.sam_block_infer.launches)
    a, kw = _block_case(10, 1, 10, 13, 48, 2, 0, torch.float32, cuda)
    with pytest.raises(ValueError, match="multiples of 32"):
        bi.crf_block_infer(**a, **kw)           # C 48
    a, kw = _block_case(11, 1, 10, 13, 96, 8, 0, torch.float32, cuda)
    with pytest.raises(ValueError, match="head width"):
        bi.crf_block_infer(**a, **kw)           # head width 12
    a, kw = _block_case(12, 1, 10, 13, 64, 2, 0, torch.float32, cuda,
                        sam=True, ws=9)
    with pytest.raises(ValueError, match="64 tokens"):
        bi.sam_block_infer(**a, **kw)           # 81 tokens a window
    a, kw = _block_case(13, 1, 10, 13, 64, 2, 3, torch.bfloat16, cuda)
    x = torch.zeros(a["xw"].numel() + 1, dtype=torch.bfloat16, device=cuda)[1:]
    with pytest.raises(ValueError, match="aligned"):
        bi.crf_block_infer(**dict(a, xw=x.view(a["xw"].shape)), **kw)
    xh, vh = torch.cat([a["xw"], a["vw"]], dim=-1).chunk(2, dim=-1)
    with pytest.raises(ValueError, match="contiguous"):
        bi.crf_block_infer(**dict(a, xw=xh, vw=vh), **kw)
    valid = torch.cat([a["valid"], a["valid"]], dim=-1)[:, ::2]
    with pytest.raises(ValueError, match="valid"):
        bi.crf_block_infer(**dict(a, valid=valid), **kw)
    with pytest.raises(ValueError, match="valid"):
        bi.crf_block_infer(**dict(a, valid=a["valid"].cpu()), **kw)
    with pytest.raises(TypeError):
        bi.crf_block_infer(**dict(a, xw=a["xw"].half(), vw=a["vw"].half()),
                           **kw)
    assert (bi.crf_block_infer.launches,
            bi.sam_block_infer.launches) == before   # nothing fell back


@pytest.mark.parametrize("name,blocks", [("sam", 4), ("newcrf", 8)])
def test_block_mode_model_on_the_card_matches_the_plain_model(cuda, name,
                                                              blocks):
    """SAM and NewCRF at 1x3x64x96 f32 in ``block`` mode against the plain
    model on the card (summation order only): one whole-block call a block
    and no other attention kernel."""
    from tpudepth_torch.models.layers import init_random_
    from tpudepth_torch.models.registry import build_model

    plain = init_random_(build_model(name, attn="plain"), seed=0)
    model = build_model(name, attn="block")
    model.load_state_dict(plain.state_dict())
    x = torch.rand(1, 3, 64, 96, generator=torch.Generator().manual_seed(4))
    x = x.to(cuda).contiguous(memory_format=torch.channels_last)
    fns = (bi.sam_block_infer if name == "sam" else bi.crf_block_infer,
           rbi.crf_rowblock_infer, rbi.sam_rowblock_infer,
           wai.window_attention_infer, ei.block_epilogue_infer, mi.mlp_infer)
    with torch.no_grad():
        want = plain.to(cuda).eval()(x)
        before = [f.launches for f in fns]
        got = model.to(cuda).eval()(x)
    torch.cuda.synchronize()
    assert tuple(f.launches - b for f, b in zip(fns, before)) == (
        blocks, 0, 0, 0, 0, 0)
    assert float((got - want).norm() / want.norm()) < 1e-5


# -- the data feed and the command lines on the card ------------------------

from tpudepth_torch.data import nyu as feed  # noqa: E402
from tpudepth_torch.data import synthetic  # noqa: E402


@pytest.mark.parametrize("prefetch", [1, 2])
@pytest.mark.parametrize("family", ["nyu", "kitti"])
def test_loader_copies_every_batch_to_the_card_as_its_host_batch(
        cuda, tmp_path, family, prefetch):
    """The train loader pinned and copied one batch ahead (uint8 images,
    uint8 NYU or uint16 KITTI depth) over 3 epochs: each device batch equals
    the host batch of the same epoch, both as kept and as summed on the
    consumer's stream the moment it is yielded."""
    make = (synthetic.make_synthetic_zip if family == "nyu"
            else synthetic.make_synthetic_kitti_zip)
    path = make(str(tmp_path / "z.zip"), n_train=20, n_test=4,
                image_hw=(48, 64), seed=1)
    train, _ = feed.get_training_testing_data(
        4, path, dataset="nyu" if family == "nyu" else "kitti")
    host = feed.DataLoader(train.dataset, 4, shuffle=True)
    dev = feed.DataLoader(train.dataset, 4, shuffle=True, device=cuda,
                          prefetch=prefetch)
    for epoch in range(3):
        host.set_epoch(epoch)
        dev.set_epoch(epoch)
        sums, got = [], []
        for batch in dev:
            assert batch["image"].is_cuda and batch["image"].dtype == torch.uint8
            # read on the consumer's stream at once, without a host sync
            sums.append({k: v.to(torch.int64).sum() for k, v in batch.items()})
            got.append(batch)
        want = list(host)
        assert len(got) == len(want) == 5
        for g, s, w in zip(got, sums, want):
            for k in ("image", "depth"):
                ref = torch.from_numpy(w[k])
                assert g[k].dtype == ref.dtype and g[k].shape == ref.shape
                assert torch.equal(g[k].cpu(), ref)
                assert int(s[k]) == int(ref.to(torch.int64).sum())


@pytest.mark.parametrize("gub", ["plain", "fused"])
def test_guidedepth_main_trains_a_step_on_the_card_through_the_loader(
        cuda, tmp_path, gub):
    """One ``--train`` step of the command line on the card, fed by the
    pinned loader: the loss kernels (and with ``--gub fused`` the GUB
    kernels) launched, a finite validation loss, the epoch's checkpoint."""
    from tpudepth_torch.cli import guidedepth_main

    path = synthetic.make_synthetic_zip(str(tmp_path / "z.zip"), n_train=8,
                                        n_test=4, image_hw=(96, 128), seed=2)
    counters = (fl.fused_partials, fl.fused_bwd, gc.conv_bn_act,
                gc.conv_bn_act_dw, gc.conv_bn_act_dx)
    before = [f.launches for f in counters]
    out = guidedepth_main.main([
        "--train", "--data_path", path, "--resolution", "mini",
        "--batch_size", "4", "--num_epochs", "1", "--steps-per-epoch", "1",
        "--save_checkpoint", str(tmp_path / "ck"),
        "--save_results", str(tmp_path / "res"), "--gub", gub])
    torch.cuda.synchronize()
    got = tuple(f.launches - b for f, b in zip(counters, before))
    # one train step and one validation batch
    assert got == ((2, 1, 18, 9, 9) if gub == "fused" else (2, 1, 0, 0, 0))
    assert np.isfinite(out["val_losses"]).all() and len(out["val_losses"]) == 1
    assert (tmp_path / "ck" / "checkpoint_0").is_file()
    assert (tmp_path / "res" / "best_model").is_file()


# -- the serving kernels as tpudepth::* custom ops, and exported engines -------

from torch_port_helpers import op_counts, round_trip, serving_op_cases  # noqa: E402
from tpudepth_torch.ops.kernels import _op  # noqa: E402


def _serving_counters():
    return {"gub_conv_fwd": gc.conv_bn_act,
            "window_attn_infer": wai.window_attention_infer,
            "block_epilogue_infer": ei.block_epilogue_infer,
            "mlp_infer": mi.mlp_infer,
            "crf_rowblock_infer": rbi.crf_rowblock_infer,
            "sam_rowblock_infer": rbi.sam_rowblock_infer,
            "sam_block_infer": bi.sam_block_infer,
            "crf_block_infer": bi.crf_block_infer}


@pytest.mark.parametrize("name", sorted(_serving_counters()))
def test_serving_op_gives_the_bits_of_its_direct_launch(cuda, name):
    """bf16, the widths of ``serving_op_cases``: the op's CUDA kernel is the
    wrapper's launch, one counted launch a call either way."""
    op, run, args = serving_op_cases(cuda, dtype=torch.bfloat16)[name]
    counter = _serving_counters()[name]
    before = counter.launches
    got = op(*args)
    want = run(*args)
    torch.cuda.synchronize()
    assert counter.launches == before + 2
    got, want = ((got[0], want[0]) if isinstance(got, tuple)
                 else (got, want))
    assert got.is_cuda and got.dtype == torch.bfloat16
    assert torch.equal(got, want)


def test_deserialized_packed_guidedepth_engine_gives_the_live_bits(
        cuda, tmp_path):
    """Packed fused GuideDepth's bf16 flip-TTA engine at 1x3x64x96 (up_2
    folded (2,2), up_3 (4,4)) serialized and deserialized on the card: the
    same bits as the live engine, 9 ``gub_conv_fwd`` ops a forward; the
    kernel refuses a part that is not contiguous NHWC, so the program must
    lay the packed tensors out as the eager call does."""
    from tpudepth_torch.models.layers import init_random_
    from tpudepth_torch.models.registry import build_model

    model = init_random_(build_model("GuideDepth", gub="fused", packed=True),
                         seed=3)
    assert round_trip(tmp_path, model, (64, 96), tta=True, meters=True,
                      device=cuda) == {"gub_conv_fwd": 18}


@pytest.mark.parametrize("name,mode,per_call", [
    ("sam", "block", {"sam_block_infer": 4}),
    ("newcrf", "row", {"crf_rowblock_infer": 8})])
def test_deserialized_engine_launches_what_the_live_one_launches(
        cuda, tmp_path, name, mode, per_call):
    """A bf16 engine at 1x3x64x96 serialized and deserialized on the card:
    the same bits as the live engine (``round_trip``), its program's ops,
    and each kernel's launches a call, live and deserialized."""
    from tpudepth_torch.infer.engine import InferenceEngine
    from tpudepth_torch.models.layers import init_random_
    from tpudepth_torch.models.registry import build_model

    model = init_random_(build_model(name, attn=mode), seed=3)
    assert round_trip(tmp_path, model, (64, 96), tta=False, meters=False,
                      device=cuda) == per_call
    live = InferenceEngine(model, (1, 3, 64, 96), device=cuda)
    loaded = InferenceEngine.deserialize(str(tmp_path / "engine.pt2"),
                                         device=cuda)
    assert op_counts(loaded) == per_call
    x = torch.rand(1, 3, 64, 96, device=cuda)
    counters = _serving_counters()
    for engine in (live, loaded):
        before = {k: f.launches for k, f in counters.items()}
        engine(x)
        torch.cuda.synchronize()
        got = {k: f.launches - before[k] for k, f in counters.items()}
        assert {k: v for k, v in got.items() if v} == per_call
    with pytest.raises(ValueError, match="is not moved"):
        InferenceEngine.deserialize(str(tmp_path / "engine.pt2"), device="cpu")


def test_direct_route_launches_the_same_kernels(cuda, monkeypatch):
    """Eager calls skip the dispatcher and give the bits and launches of
    calls through the ops."""
    from tpudepth_torch.infer.engine import InferenceEngine
    from tpudepth_torch.models.layers import init_random_
    from tpudepth_torch.models.registry import build_model

    model = init_random_(build_model("sam", attn="fused"), seed=4)
    eng = InferenceEngine(model, (1, 3, 64, 96), device=cuda)
    x = torch.rand(1, 3, 64, 96, device=cuda)
    outs, launches = [], []
    for forced in (True, False):
        monkeypatch.setattr(_op, "through_op", lambda: forced)
        before = wai.window_attention_infer.launches
        outs.append(eng(x))
        torch.cuda.synchronize()
        launches.append(wai.window_attention_infer.launches - before)
    assert torch.equal(*outs) and launches == [4, 4]


# -- NewCRF's padded stage chain: the row kernel on a chained input ------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shift", [0, 3], ids=["shift0", "shift3"])
@pytest.mark.parametrize("case", ROW_CASES + [(8, 15, 20, 1024, 32)],
                         ids=["odd", "crf1", "crf3", "crf3-B8"])
def test_crf_rowblock_infer_on_a_chained_padded_input(cuda, case, shift,
                                                       dtype):
    """A chained block's x holds the previous block's output at the pad
    positions: with large finite values there, every real token's output
    keeps the bits of the zero-padded call (LN(x) zeroed by select), and
    the whole output, pad rows included, is written and finite."""
    a, kw = _rowblock_case(sum(case) + 11 + shift, *case, shift, dtype, cuda)
    b, h, w, c, _ = case
    hp, wp = a["x"].shape[1:3]
    real = (torch.from_numpy(rbi._valid_image(h, w, hp, wp, shift)) > 0
            ).to(cuda)
    fresh = rbi.crf_rowblock_infer(**a, **kw)
    g = torch.Generator(device=cuda).manual_seed(sum(case) + shift)
    junk = 3e4 * torch.randn(a["x"].shape, generator=g, device=cuda)
    x = torch.where(real[None, :, :, None], a["x"], junk.to(dtype))
    before = rbi.crf_rowblock_infer.launches
    got = rbi.crf_rowblock_infer(**dict(a, x=x.contiguous()), **kw)
    torch.cuda.synchronize()
    assert rbi.crf_rowblock_infer.launches == before + 1
    assert torch.equal(got[:, real], fresh[:, real])
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(fresh).all())
    # every row written: the output of the next call takes the freed block
    # of this NaN tensor (the caching allocator's best fit), and a row left
    # unwritten would stay NaN
    poison = torch.full_like(got, float("nan"))
    del poison
    again = rbi.crf_rowblock_infer(**dict(a, x=x.contiguous()), **kw)
    assert torch.equal(again, got)


@pytest.mark.parametrize("bsz", [1, 8])
def test_newcrf_stage_chain_is_bit_equal_on_the_card(cuda, bsz):
    """``build_model('newcrf', attn='row')`` served in bf16 at 480x640,
    its stages chained, against its blocks run one by one: the same bits,
    8 row-kernel launches a forward either way, and every chained block's
    whole padded output finite."""
    from torch_port_helpers import blocks_one_by_one, chained_blocks
    from tpudepth_torch.models.layers import init_random_
    from tpudepth_torch.models.registry import build_model

    model = init_random_(build_model("newcrf", attn="row"), seed=3)
    model = model.to(cuda, memory_format=torch.channels_last).eval()
    x = torch.rand(bsz, 3, 480, 640, generator=torch.Generator().manual_seed(4))
    x = x.to(cuda, torch.bfloat16).contiguous(memory_format=torch.channels_last)
    outs = []
    for one_by_one in (False, True):
        before = rbi.crf_rowblock_infer.launches
        with torch.no_grad(), chained_blocks(model) as seen:
            if one_by_one:
                with blocks_one_by_one(model):
                    outs.append(model(x))
            else:
                outs.append(model(x))
        torch.cuda.synchronize()
        assert rbi.crf_rowblock_infer.launches == before + 8
        if not one_by_one:
            assert len(seen) == 8
            assert all(bool(torch.isfinite(y).all()) for _, y in seen)
    assert torch.equal(outs[0], outs[1])


# -- data parallel -----------------------------------------------------------


@pytest.fixture
def nccl_world_1(cuda, tmp_path):
    """A process group of one under NCCL, and its data axis."""
    from tpudepth_torch.core import mesh as mesh_lib

    torch.distributed.init_process_group(
        "nccl", init_method=f"file://{tmp_path}/rdzv", world_size=1, rank=0)
    try:
        yield mesh_lib.create_mesh(device=cuda)
    finally:
        torch.distributed.destroy_process_group()


def test_fused_gub_batchnorm_with_world_1_nccl_sums_is_bit_equal(
        cuda, nccl_world_1):
    """``BatchNorm.train_affine`` on one ``gub_conv_fwd`` launch's f32 sums,
    inside the world-1 NCCL group's data axis (the sums SUM-all-reduced with
    autograd, the count times the world) and outside it: the affine, the
    running statistics and the sums' cotangents, which the backward kernels
    receive, are the same bits."""
    from tpudepth_torch.core import mesh as mesh_lib
    from tpudepth_torch.models.layers import BatchNorm

    g = torch.Generator().manual_seed(7)
    x = torch.randn(4, 60, 80, 16, generator=g).to(cuda)
    w = (torch.randn(3, 3, 16, 32, generator=g) * 0.1).to(cuda)
    b = torch.randn(32, generator=g).to(cuda)
    before = conv_bn_act.launches
    _, s, q = conv_bn_act([x], w, b, stats=True)
    assert conv_bn_act.launches == before + 1
    n = float(4 * 60 * 80)
    out = []
    for axis in (None, nccl_world_1):
        bn = BatchNorm(32).to(cuda).train()
        ss, qq = s.clone().requires_grad_(), q.clone().requires_grad_()
        with mesh_lib.data_axis(axis):
            a, c = bn.train_affine(sums=(ss, qq, n))
            (a * torch.linspace(-1, 1, 32, device=cuda)).sum().backward(
                retain_graph=True)
            c.square().sum().backward()
        out.append((a.detach(), c.detach(), ss.grad, qq.grad,
                    bn.running_mean.clone(), bn.running_var.clone()))
    for got, want in zip(out[1], out[0]):
        assert torch.equal(got, want)


def test_fused_step_under_a_world_1_nccl_group_launches_as_without(
        cuda, nccl_world_1):
    """A fused GuideDepth-S f32 train step under the world-1 NCCL group
    launches the kernels as often as without a group (9 + 9 + 9 GUB, 1 + 1
    loss) and lands within 4x the spread of two repeats of the step without
    (the f32 step does not repeat bit for bit on the card: the GUB
    statistics' and cuDNN's atomics)."""
    from tpudepth_torch.core.config import TrainConfig
    from tpudepth_torch.models.layers import init_random_
    from tpudepth_torch.models.registry import build_model
    from tpudepth_torch.train import trainer as ttr

    rng = np.random.default_rng(5)
    image = torch.from_numpy(rng.integers(0, 256, (4, 96, 128, 3),
                                          dtype=np.uint8)).to(cuda)
    depth = torch.from_numpy(rng.random((4, 96, 128, 1), dtype=np.float32)
                             * 0.9 + 0.05).to(cuda)
    weights = init_random_(build_model("GuideDepth-S", gub="fused"),
                           seed=6).state_dict()
    counters = (conv_bn_act, gc.conv_bn_act_dw, gc.conv_bn_act_dx,
                fl.fused_partials, fl.fused_bwd)
    runs = []
    for mesh in (nccl_world_1, None, None):
        model = build_model("GuideDepth-S", gub="fused")
        model.load_state_dict(weights)
        model = model.to(cuda, memory_format=torch.channels_last)
        state = ttr.TrainState(model, ttr.make_optimizer(
            TrainConfig(), model.parameters()))
        step = ttr.make_train_step(
            model, ttr.LossRecipe(), ttr.step_lr(1e-4, 15, 0.1, 10),
            compute_dtype=torch.float32, mesh=mesh)
        before = [f.launches for f in counters]
        loss = step(state, image, depth,
                    torch.Generator(device=cuda).manual_seed(0))
        torch.cuda.synchronize()
        runs.append((float(loss), [f.launches - b for f, b in
                                   zip(counters, before)],
                     model.state_dict()))
    (lg, cg, sg), (l0, c0, s0), (l1, _, s1) = runs
    assert cg == c0 == [9, 9, 9, 1, 1]
    assert np.isfinite(lg)

    def diff(a, b):
        return max(float((a[k].double() - b[k].double()).abs().max())
                   for k in a if a[k].is_floating_point())

    spread = diff(s0, s1)
    assert diff(sg, s0) <= 4 * spread
    assert abs(lg - l0) <= max(4 * abs(l0 - l1), 1e-6 * abs(l0))
