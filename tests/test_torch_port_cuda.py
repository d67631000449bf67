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
    bsz, h, w, cins, cout, k, prelude, skip = case
    parts, wt, b, pre, sk = _case(0, bsz, h, w, cins, cout, k, prelude, skip,
                                  dtype, cuda)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", BWD_CASES,
                         ids=[str(i) for i in range(len(BWD_CASES))])
def test_gub_conv_dw_matches_plain(cuda, case, dtype):
    bsz, h, w, cins, cout, k, prelude, skip, stats = case
    parts, wt, b, pre, sk = _case(0, bsz, h, w, cins, cout, k, prelude, skip,
                                  dtype, cuda)
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
    assert torch.equal(dw, dw2) and torch.equal(db, db2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", BWD_CASES,
                         ids=[str(i) for i in range(len(BWD_CASES))])
def test_gub_conv_dx_matches_plain(cuda, case, dtype):
    bsz, h, w, cins, cout, k, prelude, skip, stats = case
    parts, wt, b, pre, sk = _case(0, bsz, h, w, cins, cout, k, prelude, skip,
                                  dtype, cuda)
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


LOSS_CASES = [("random", 3, 48, 64), ("norm", 8, 240, 320),
              ("norm", 2, 33, 47), ("zeros", 2, 64, 96), ("equal", 2, 40, 40),
              ("smooth", 2, 50, 70), ("norm", 1, 7, 5), ("norm", 8, 480, 640)]


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
    # the tile sums are added in a fixed order: the same bits every time
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
