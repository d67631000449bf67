"""Gradients of the port's ``conv_bn_act`` (its ``autograd.Function`` with
the plain versions of the ``gub_conv_dw`` / ``gub_conv_dx`` kernels
underneath, which the wrappers run for CPU tensors) against ``jax.grad`` of
the JAX ``conv_bn_act`` with its Pallas kernels in interpret mode, as
``tests/test_gub_fused.py::test_conv_bn_act_op_grads`` runs it, and against
``torch.autograd`` of the forward's plain version.

Tolerance against JAX: atol 2e-5, rtol 1e-4 in f32 (that test's); in bf16 the
IO-dtype gradients (x, skip) one bf16 ulp (rtol 2**-7, atol 1e-2 of the
tensor's largest value: a sum near a rounding boundary rounds the other way)
and the f32 ones (w, b, A, C), which sum up to 96 bf16-rounded terms that may
each differ by one ulp, 2e-2 of the tensor's largest value.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tpudepth.ops.pallas.gub_conv import conv_bn_act as jax_conv_bn_act
from tpudepth_torch.ops.kernels import gub_conv as gc
from tpudepth_torch.ops.kernels.gub_conv import conv_bn_act

COUT = 7


def _inputs(seed, cins, k, prelude, skip, bsz=2, hw=(6, 8)):
    rng = np.random.default_rng(seed)
    f = np.float32
    case = {
        "parts": [rng.standard_normal((bsz, *hw, c)).astype(f) for c in cins],
        "w": (rng.standard_normal((k, k, sum(cins), COUT)) * 0.2).astype(f),
        "b": (0.1 * rng.standard_normal(COUT)).astype(f),
        "A": [], "C": [], "skip": None,
    }
    if prelude:
        case["A"] = [rng.uniform(0.5, 1.5, (bsz, c)).astype(f) for c in cins]
        case["C"] = [rng.standard_normal((bsz, c)).astype(f) for c in cins]
    if skip:
        case["skip"] = rng.standard_normal((bsz, *hw, cins[0])).astype(f)
    return case


def _names(case):
    n = len(case["parts"])
    names = [f"x{j}" for j in range(n)]
    if case["A"]:
        names += [f"A{j}" for j in range(n)] + [f"C{j}" for j in range(n)]
    if case["skip"] is not None:
        names.append("skip")
    return names + ["w", "b"]


def _flat(case):
    out = list(case["parts"]) + case["A"] + case["C"]
    if case["skip"] is not None:
        out.append(case["skip"])
    return out + [case["w"], case["b"]]


def _unflat(case, flat):
    n = len(case["parts"])
    parts = list(flat[:n])
    pre = None
    if case["A"]:
        pre = list(zip(flat[n:2 * n], flat[2 * n:3 * n]))
    skip = flat[3 * n if pre else n] if case["skip"] is not None else None
    return parts, pre, skip, flat[-2], flat[-1]


def _loss(xp, out, stats):
    """Uses ``y``, ``s`` and ``q`` (``tests/test_gub_fused.py``'s loss)."""
    if not stats:
        return xp.sum(xp.sin(out))
    y, s, q = out
    return (xp.sum(xp.sin(y)) + 0.1 * xp.sum(s * s)
            + 0.05 * xp.sum(xp.sqrt(xp.abs(q))))


def _jax_grads(case, stats, io=jnp.float32, loss=_loss):
    def f(*flat):
        parts, pre, skip, w, b = _unflat(case, flat)
        out = jax_conv_bn_act(parts, w, b, preludes=pre, skip=skip,
                              stats=stats, interpret=True)
        if stats:
            out = (out[0].astype(jnp.float32), out[1], out[2])
        else:
            out = out.astype(jnp.float32)
        return loss(jnp, out, stats)

    names = _names(case)
    flat = [jnp.asarray(a, io if (nm.startswith("x") or nm == "skip")
                        else jnp.float32)
            for nm, a in zip(names, _flat(case))]
    grads = jax.grad(f, argnums=tuple(range(len(flat))))(*flat)
    return {nm: np.asarray(g.astype(jnp.float32))
            for nm, g in zip(names, grads)}


def _port_grads(case, stats, io=torch.float32, fn=conv_bn_act, wdt=None,
                loss=_loss):
    names = _names(case)
    flat = []
    for nm, a in zip(names, _flat(case)):
        is_io = nm.startswith("x") or nm == "skip"
        t = torch.from_numpy(a).to(io if is_io else (wdt or torch.float32))
        flat.append(t.requires_grad_(True))
    parts, pre, skip, w, b = _unflat(case, flat)
    out = fn(parts, w, b, preludes=pre, skip=skip, stats=stats)
    ct = gc._ct(io)
    out = tuple(o.to(ct) for o in out) if stats else out.to(ct)
    loss(torch, out, stats).backward()
    return {nm: t.grad.double().numpy() for nm, t in zip(names, flat)}


# (k, cins, prelude, skip, stats, hw)
CASES = {
    "k3-raw": (3, (6,), False, False, False, (6, 8)),
    "k3-raw-stats": (3, (6,), False, False, True, (6, 8)),
    "k3-prelude": (3, (6,), True, False, False, (6, 8)),
    "k3-prelude-stats": (3, (6,), True, False, True, (6, 8)),
    "k3-prelude-skip-stats": (3, (12,), True, True, True, (8, 10)),
    "k3-2parts-prelude-stats": (3, (3, 5), True, False, True, (6, 8)),
    "k3-2parts-skip": (3, (4, 4), True, True, False, (6, 8)),
    "k3-rgb-raw-stats": (3, (3,), False, False, True, (6, 8)),
    "k3-ragged-9x19": (3, (5,), True, True, True, (9, 19)),
    "k1-raw": (1, (6,), False, False, False, (6, 8)),
    "k1-2parts-prelude-skip-stats": (1, (5, 7), True, True, True, (5, 9)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_conv_bn_act_grads_match_jax(name):
    k, cins, prelude, skip, stats, hw = CASES[name]
    case = _inputs(0, cins, k, prelude, skip, hw=hw)
    want = _jax_grads(case, stats)
    got = _port_grads(case, stats)
    assert set(want) == set(got)
    for nm in want:
        assert got[nm].shape == want[nm].shape
        np.testing.assert_allclose(got[nm], want[nm], atol=2e-5, rtol=1e-4,
                                   err_msg=nm)


@pytest.mark.parametrize("name", ["k3-prelude-skip-stats",
                                  "k3-2parts-prelude-stats", "k3-rgb-raw-stats"])
def test_conv_bn_act_grads_bf16_match_jax(name):
    k, cins, prelude, skip, stats, hw = CASES[name]
    case = _inputs(1, cins, k, prelude, skip, hw=hw)
    want = _jax_grads(case, stats, io=jnp.bfloat16)
    got = _port_grads(case, stats, io=torch.bfloat16)
    for nm in want:
        scale = np.abs(want[nm]).max()
        if nm.startswith("x") or nm == "skip":
            np.testing.assert_allclose(got[nm], want[nm], atol=1e-2 * scale,
                                       rtol=2.0 ** -7, err_msg=nm)
        else:
            assert np.abs(got[nm] - want[nm]).max() <= 2e-2 * scale, nm


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.float64, 1e-12)],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", ["k3-prelude-skip-stats",
                                  "k3-2parts-prelude-stats",
                                  "k3-rgb-raw-stats", "k3-ragged-9x19",
                                  "k1-2parts-prelude-skip-stats", "k3-raw"])
def test_plain_backward_versions_match_autograd_of_the_plain_forward(
        name, dtype, tol):
    """``conv_bn_act_dw_reference`` / ``_dx_reference`` (through the
    Function) against ``torch.autograd`` of ``conv_bn_act_reference``;
    tolerance relative to each tensor's largest gradient."""
    k, cins, prelude, skip, stats, hw = CASES[name]
    case = _inputs(2, cins, k, prelude, skip, hw=hw)
    got = _port_grads(case, stats, io=dtype, wdt=dtype)
    want = _port_grads(case, stats, io=dtype, wdt=dtype,
                       fn=gc.conv_bn_act_reference)
    for nm in want:
        scale = max(np.abs(want[nm]).max(), 1.0)
        assert np.abs(got[nm] - want[nm]).max() <= tol * scale, nm


def test_the_halo_of_g_is_zero_not_ds():
    """``ds != 0`` with ``dy == 0``: every output pixel of the image has
    ``g = ds``, and a halo that held ``ds`` too would make ``dx`` the same at
    the border as inside. With a zero halo the border sees fewer taps."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 5, 6, 2)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.5, 1.0, (3, 3, 2, 3)).astype(np.float32))
    dy = torch.zeros(1, 5, 6, 3)
    y = torch.zeros(1, 5, 6, 3)
    ds = torch.ones(3)
    dq = torch.zeros(3)
    dx, _, _, _ = gc.conv_bn_act_dx(x, w, 0, dy, y=y, ds=ds, dq=dq)
    inner = w.sum(dim=(0, 1, 3))           # all nine taps
    corner = w[:2, :2].sum(dim=(0, 1, 3))  # dx[0,0] <- g[0..1, 0..1]
    torch.testing.assert_close(dx[0, 2, 3], inner, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(dx[0, 0, 0], corner, atol=1e-6, rtol=1e-6)
    assert float((dx[0, 0, 0] - inner).abs().min()) > 0.5
    # and through the whole op against JAX, with a loss of s alone
    case = _inputs(4, (4,), 3, True, False)

    def only_s(xp, out, stats):
        return xp.sum(out[1] * xp.arange(1, COUT + 1))

    want = _jax_grads(case, True, loss=only_s)
    got = _port_grads(case, True, loss=only_s)
    for nm in want:
        np.testing.assert_allclose(got[nm], want[nm], atol=2e-5, rtol=1e-4,
                                   err_msg=nm)


def test_dw_comes_back_in_the_layout_of_an_oihw_parameter_view():
    """The gradient of the ``permute(2,3,1,0)`` view reaches the OIHW
    parameter with the parameter's shape."""
    case = _inputs(5, (4,), 3, False, False)
    conv_w = torch.from_numpy(case["w"]).permute(3, 2, 0, 1).contiguous()
    conv_w.requires_grad_(True)
    b = torch.from_numpy(case["b"]).requires_grad_(True)
    x = torch.from_numpy(case["parts"][0])
    y, s, q = conv_bn_act([x], conv_w.permute(2, 3, 1, 0), b, stats=True)
    (y.sum() + s.sum() + 0.1 * q.sum()).backward()
    assert conv_w.grad.shape == conv_w.shape and b.grad.shape == b.shape
    w2 = torch.from_numpy(case["w"]).requires_grad_(True)
    y2, s2, q2 = gc.conv_bn_act_reference([x], w2, b.detach(), stats=True)
    (y2.sum() + s2.sum() + 0.1 * q2.sum()).backward()
    torch.testing.assert_close(conv_w.grad.permute(2, 3, 1, 0), w2.grad,
                               atol=1e-3, rtol=1e-5)


def test_no_dx_work_for_an_input_that_needs_no_gradient(monkeypatch):
    """The RGB guide of ``guide_conv.0`` needs no gradient: the backward
    skips the part's ``dx`` and still gives ``dw`` and ``db``."""
    calls = []
    real = gc.conv_bn_act_dx
    monkeypatch.setattr(gc, "conv_bn_act_dx",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    case = _inputs(6, (3,), 3, False, False)
    x = torch.from_numpy(case["parts"][0])
    w = torch.from_numpy(case["w"]).requires_grad_(True)
    b = torch.from_numpy(case["b"]).requires_grad_(True)
    conv_bn_act([x], w, b).sum().backward()
    assert not calls and w.grad is not None and b.grad is not None
    conv_bn_act([x.requires_grad_(True)], w, b).sum().backward()
    assert len(calls) == 1 and x.grad is not None


def test_unused_statistics_get_zero_cotangents():
    case = _inputs(7, (4,), 3, True, False)
    got = _port_grads(case, False)
    names = _names(case)
    flat = [torch.from_numpy(a).requires_grad_(True) for a in _flat(case)]
    parts, pre, skip, w, b = _unflat(case, flat)
    y, _, _ = conv_bn_act(parts, w, b, preludes=pre, stats=True)
    torch.sin(y).sum().backward()
    for nm, t in zip(names, flat):
        np.testing.assert_allclose(t.grad.numpy(), got[nm], atol=1e-6,
                                   err_msg=nm)


def test_backward_wrappers_have_no_fallback_off_cpu():
    x = torch.empty(1, 4, 4, 2, device="meta")
    w = torch.empty(3, 3, 2, 3, device="meta")
    dy = torch.empty(1, 4, 4, 3, device="meta")
    with pytest.raises(ValueError, match="no gub_conv_dw kernel"):
        gc.conv_bn_act_dw([x], dy, w)
    with pytest.raises(ValueError, match="no gub_conv_dx kernel"):
        gc.conv_bn_act_dx(x, w, 0, dy)
