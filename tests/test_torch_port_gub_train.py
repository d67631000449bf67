"""The port's fused ``GuidedUpsamplingBlock`` in TRAIN mode against the JAX
block on the same weights (through the bridge) and inputs: against the plain
unpacked JAX block, and against the JAX fused block in space-to-depth layout
with its Pallas kernels in interpret mode, run as ``tests/test_gub_fused.py``
runs it (``space_to_depth`` at the boundary). On the CPU the port's fused
stages run the plain versions of their three CUDA kernels under the same
``autograd.Function``.

Tolerances, float32 (those of ``tests/test_gub_fused.py``): output atol 1e-4;
running statistics atol 1e-5; gradients of the parameters, the guide and the
depth within 1e-5 of the GLOBAL gradient scale (the conv biases' gradients
under train-mode BatchNorm are analytically zero, so both sides hold only
rounding noise there and a per-tensor scale would compare noise to noise).
The port's block also runs packed at the JAX run's block, against the JAX
fused packed block, with the same tolerances.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tpudepth.models.guidedepth import GuidedUpsamplingBlock as JaxGUB
from tpudepth.ops.packed import depth_to_space, space_to_depth
from tpudepth_torch.models.guidedepth import GuidedUpsamplingBlock
from tpudepth_torch.models.jax_weights import _flatten, _gub
from tpudepth_torch.models.layers import BatchNorm
from tpudepth_torch.ops import packed as tp

IN, EXPAND, OUT = 16, 16, 8
BLOCK = (4, 4)


def _fill(shapes, seed):
    """The block's own variable tree filled from a numpy seed, BatchNorm
    statistics, scales and biases away from (0, 1)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        key = jax.tree_util.keystr(path)
        if key.endswith("['kernel']"):
            arr = rng.standard_normal(leaf.shape) / np.sqrt(
                np.prod(leaf.shape[:-1]))
        elif key.endswith("['mean']"):
            arr = 0.1 * rng.standard_normal(leaf.shape)
        elif key.endswith("['var']") or key.endswith("['scale']"):
            arr = rng.uniform(0.5, 1.5, leaf.shape)
        else:
            arr = 0.05 * rng.standard_normal(leaf.shape)
        return jnp.asarray(arr, jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _gub_from_flax(params, stats=None):
    """One JAX block's leaves under the port's names, through the bridge's
    ``_gub`` name table and its layout changes (conv HWIO -> OIHW, dense
    ``[in, out]`` -> ``[out, in]``); ``stats=None`` maps a gradient tree."""
    p, out = _flatten(params), {}
    for kind, fp, tp in _gub("", ""):
        fp, tp = fp[1:], tp[1:]
        if kind == "conv":
            out[f"{tp}.weight"] = p[f"{fp}/Conv_0/kernel"].transpose(3, 2, 0, 1)
            out[f"{tp}.bias"] = p[f"{fp}/Conv_0/bias"]
        elif kind == "bn":
            out[f"{tp}.weight"] = p[f"{fp}/BatchNorm_0/scale"]
            out[f"{tp}.bias"] = p[f"{fp}/BatchNorm_0/bias"]
            if stats is not None:
                s = _flatten(stats)
                out[f"{tp}.running_mean"] = s[f"{fp}/BatchNorm_0/mean"]
                out[f"{tp}.running_var"] = s[f"{fp}/BatchNorm_0/var"]
        else:
            out[f"{tp}.weight"] = p[f"{fp}/kernel"].T
    assert len(out) == len(p) + (len(s) if stats is not None else 0)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def _loss(xp, out):
    return xp.mean(out * out) + 0.1 * xp.mean(xp.abs(out))


@pytest.fixture(scope="module")
def inputs():
    """The guide, the depth and the JAX block's variables."""
    rng = np.random.default_rng(0)
    guide = rng.random((2, 16, 24, 3), dtype=np.float32)
    depth = rng.random((2, 16, 24, IN), dtype=np.float32)
    plain = JaxGUB(IN, EXPAND, OUT, fused=False)
    shapes = jax.eval_shape(
        lambda k, g, d: plain.init(k, g, d, train=False),
        jax.random.PRNGKey(0), jnp.asarray(guide), jnp.asarray(depth))
    return guide, depth, _fill(shapes, 1)


def _port_run(inputs, block=None):
    """The port's fused block in train mode on ``inputs``, unpacked or
    packed with ``block``: output, state dict and gradients, NHWC."""
    guide, depth, variables = inputs
    port = GuidedUpsamplingBlock(IN, EXPAND, OUT, fused=True)
    loaded = port.load_state_dict(
        _gub_from_flax(variables["params"], variables["batch_stats"]),
        strict=False)
    assert not loaded.unexpected_keys and all(
        k.endswith("num_batches_tracked") for k in loaded.missing_keys)
    port.train()
    g = torch.from_numpy(guide).permute(0, 3, 1, 2).requires_grad_(True)
    d = torch.from_numpy(depth).permute(0, 3, 1, 2).requires_grad_(True)
    if block is None:
        out = port(g, d)
    else:
        out = tp.depth_to_space(port(tp.space_to_depth(g, block),
                                     tp.space_to_depth(d, block), block),
                                block)
    _loss(torch, out).backward()
    return {
        "out": out.detach().permute(0, 2, 3, 1).numpy(),
        "stats": port.state_dict(),
        "grads": {**{n: p.grad for n, p in port.named_parameters()},
                  "guide": g.grad.permute(0, 2, 3, 1),
                  "depth": d.grad.permute(0, 2, 3, 1)},
    }


@pytest.fixture(scope="module")
def setup(inputs):
    guide, depth, variables = inputs

    def run(module, packed):
        def f(params, g, d):
            if packed:
                g, d = space_to_depth(g, packed), space_to_depth(d, packed)
            out, mutated = module.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                g, d, train=True, packed=packed, mutable=["batch_stats"])
            if packed:
                out = depth_to_space(out, packed)
            return _loss(jnp, out), (out, mutated["batch_stats"])

        (_, (out, stats)), grads = jax.value_and_grad(
            f, argnums=(0, 1, 2), has_aux=True)(
                variables["params"], jnp.asarray(guide), jnp.asarray(depth))
        return {
            "out": np.asarray(out),
            "stats": _gub_from_flax(variables["params"], stats),
            "grads": {**_gub_from_flax(grads[0]),
                      "guide": torch.from_numpy(np.array(grads[1])),
                      "depth": torch.from_numpy(np.array(grads[2]))},
        }

    want = {"jax-plain": run(JaxGUB(IN, EXPAND, OUT, fused=False), 0),
            "jax-fused-packed": run(JaxGUB(IN, EXPAND, OUT, fused=True), BLOCK)}
    return want, _port_run(inputs)


@pytest.fixture(scope="module")
def packed_port(inputs):
    """The port's fused block run packed with the JAX run's ``BLOCK``."""
    return _port_run(inputs, BLOCK)


REFS = ["jax-plain", "jax-fused-packed"]


def _check_output(want, got):
    assert got["out"].shape == want["out"].shape == (2, 16, 24, OUT)
    assert np.std(want["out"]) > 1e-2
    np.testing.assert_allclose(got["out"], want["out"], atol=1e-4)


def _check_running_statistics(want, got):
    keys = [k for k in got["stats"]
            if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 12
    for k in keys:
        np.testing.assert_allclose(got["stats"][k].numpy(),
                                   want["stats"][k].numpy(), atol=1e-5,
                                   err_msg=k)


def _check_gradients(want, got):
    wg, gg = want["grads"], got["grads"]
    assert set(wg) == set(gg)
    gscale = max(float(v.abs().max()) for v in wg.values())
    # not everything is noise: weights, guide and depth have real gradients
    for k in ("comb_conv.0.weight", "guide_conv.0.weight", "guide", "depth"):
        assert float(wg[k].abs().max()) > 1e-3 * gscale, k
    for k in wg:
        assert gg[k].shape == wg[k].shape, k
        d = float((gg[k] - wg[k]).abs().max()) / gscale
        assert d < 1e-5, (k, d)


CHECKS = {"output": _check_output, "stats": _check_running_statistics,
          "grads": _check_gradients}


@pytest.mark.parametrize("ref", REFS)
def test_train_output_matches_jax(setup, ref):
    want, got = setup
    _check_output(want[ref], got)


@pytest.mark.parametrize("ref", REFS)
def test_train_running_statistics_match_jax(setup, ref):
    want, got = setup
    _check_running_statistics(want[ref], got)


@pytest.mark.parametrize("ref", REFS)
def test_train_gradients_match_jax(setup, ref):
    want, got = setup
    _check_gradients(want[ref], got)


@pytest.mark.parametrize("check", list(CHECKS))
def test_packed_train_mode_matches_the_jax_fused_packed_block(
        setup, packed_port, check):
    """The port's fused block run packed at ``BLOCK`` (the packed weights,
    the affines tiled, the statistics folded) against the JAX fused packed
    block, with the same tolerances."""
    want, _ = setup
    CHECKS[check](want["jax-fused-packed"], packed_port)


def test_train_affine_from_sums_and_from_the_tensor_agree_with_forward():
    """``BatchNorm.train_affine``: ``y*A + C`` is the train-mode forward, from
    the kernel's sums or from ``y`` itself; the running statistics move once
    per call, as in the forward; gradients reach ``s`` and ``q``."""
    rng = np.random.default_rng(2)
    y = torch.from_numpy(rng.standard_normal((3, 5, 6, 7)).astype(np.float32))

    def bn():
        m = BatchNorm(5).train()
        with torch.no_grad():
            m.weight.copy_(torch.linspace(0.5, 1.5, 5))
            m.bias.copy_(torch.linspace(-0.2, 0.2, 5))
        return m

    ref = bn()
    want = ref(y)
    s = y.sum(dim=(0, 2, 3)).requires_grad_(True)
    q = (y * y).sum(dim=(0, 2, 3)).requires_grad_(True)
    for kwargs in ({"y": y}, {"sums": (s, q, float(3 * 6 * 7))}):
        m = bn()
        a, c = m.train_affine(**kwargs)
        assert a.dtype == c.dtype == torch.float32 and a.shape == (5,)
        torch.testing.assert_close(
            y * a[None, :, None, None] + c[None, :, None, None], want,
            atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(m.running_mean, ref.running_mean,
                                   atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(m.running_var, ref.running_var,
                                   atol=1e-6, rtol=1e-6)
    (a.sum() + c.sum()).backward()
    assert s.grad is not None and q.grad is not None
    assert float(q.grad.abs().min()) > 0


def test_eval_mode_leaves_the_running_statistics_alone():
    gub = GuidedUpsamplingBlock(4, 4, 1, fused=True).eval()
    before = {k: v.clone() for k, v in gub.state_dict().items()}
    with torch.no_grad():
        gub(torch.rand(1, 3, 8, 8), torch.rand(1, 4, 8, 8))
    for k, v in gub.state_dict().items():
        assert torch.equal(v, before[k]), k
