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
    # the statistics are f32 sums of the kernel's own (rounded) output, in
    # another order than torch's
    yk = y.float()
    torch.testing.assert_close(s, yk.sum(dim=(0, 1, 2)), rtol=0,
                               atol=1e-4 + 1e-5 * float(yk.abs().sum()))
    torch.testing.assert_close(q, (yk * yk).sum(dim=(0, 1, 2)), rtol=0,
                               atol=1e-4 + 1e-5 * float((yk * yk).sum()))


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
