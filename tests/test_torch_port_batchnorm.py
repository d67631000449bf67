"""Port BatchNorm in train mode against ``tpudepth.models.layers.BatchNorm``
(flax ``nn.BatchNorm``, torch momentum 0.1): the normalized output and the
running statistics after one and two calls.

The running variance takes the BIASED batch variance. ``nn.BatchNorm2d``
would take the unbiased one, n/(n-1) larger: 4/3 on a ``[2,C,1,2]`` input,
the kind of shape the DAPPM branches see. Tolerance: atol 1e-5, rtol 1e-5
in f32.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tpudepth.models.layers import BatchNorm as JaxBatchNorm
from tpudepth_torch.models.layers import BatchNorm

ATOL = RTOL = 1e-5


def _setup(seed, c):
    rng = np.random.default_rng(seed)
    f = np.float32
    return {"scale": rng.uniform(0.5, 1.5, c).astype(f),
            "bias": (0.1 * rng.standard_normal(c)).astype(f),
            "mean": (0.1 * rng.standard_normal(c)).astype(f),
            "var": rng.uniform(0.5, 1.5, c).astype(f)}


def _jax_variables(v):
    return {"params": {"BatchNorm_0": {"scale": jnp.asarray(v["scale"]),
                                       "bias": jnp.asarray(v["bias"])}},
            "batch_stats": {"BatchNorm_0": {"mean": jnp.asarray(v["mean"]),
                                            "var": jnp.asarray(v["var"])}}}


def _port(v):
    bn = BatchNorm(len(v["scale"]))
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(v["scale"]))
        bn.bias.copy_(torch.from_numpy(v["bias"]))
        bn.running_mean.copy_(torch.from_numpy(v["mean"]))
        bn.running_var.copy_(torch.from_numpy(v["var"]))
    return bn.train()


@pytest.mark.parametrize("shape", [(2, 5, 1, 2), (3, 4, 6, 8), (1, 3, 1, 1)],
                         ids=["2x1x2", "3x6x8", "one-pixel"])
def test_train_mode_output_and_running_stats_match_jax(shape):
    c = shape[1]
    v = _setup(0, c)
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal(shape).astype(np.float32) * 2 + 1
          for _ in range(2)]
    jbn = JaxBatchNorm()
    variables = _jax_variables(v)
    bn = _port(v)
    for x in xs:  # one call, then a second on the updated statistics
        want, mutated = jbn.apply(
            variables, jnp.asarray(np.transpose(x, (0, 2, 3, 1))), train=True,
            mutable=["batch_stats"])
        variables = {"params": variables["params"], **mutated}
        got = bn(torch.from_numpy(x))
        np.testing.assert_allclose(
            got.detach().numpy(), np.transpose(np.asarray(want), (0, 3, 1, 2)),
            atol=ATOL, rtol=RTOL)
        stats = variables["batch_stats"]["BatchNorm_0"]
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(stats["mean"]), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(stats["var"]), atol=ATOL, rtol=RTOL)


def test_running_var_takes_the_biased_variance():
    """[2,C,1,2]: n = 4, so the unbiased variance is 4/3 of the biased."""
    v = _setup(2, 3)
    x = np.random.default_rng(3).standard_normal((2, 3, 1, 2)).astype(np.float32)
    bn = _port(v)
    bn(torch.from_numpy(x))
    biased = x.var(axis=(0, 2, 3))
    np.testing.assert_allclose(bn.running_var.numpy(),
                               0.9 * v["var"] + 0.1 * biased, rtol=1e-5)
    torch_bn = torch.nn.BatchNorm2d(3).train()
    torch_bn.running_var.copy_(torch.from_numpy(v["var"]))
    torch_bn(torch.from_numpy(x))
    np.testing.assert_allclose(torch_bn.running_var.numpy(),
                               0.9 * v["var"] + 0.1 * biased * 4 / 3, rtol=1e-5)


def test_gradients_flow_through_the_batch_statistics():
    v = _setup(4, 4)
    x = torch.randn(2, 4, 3, 5, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    w = torch.randn(2, 4, 3, 5, generator=torch.Generator().manual_seed(1))
    bn = _port(v)
    (bn(x) * w).sum().backward()
    ref = torch.nn.BatchNorm2d(4).train()
    with torch.no_grad():
        ref.weight.copy_(bn.weight)
        ref.bias.copy_(bn.bias)
    x2 = x.detach().clone().requires_grad_(True)
    (ref(x2) * w).sum().backward()
    torch.testing.assert_close(x.grad, x2.grad, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(bn.weight.grad, ref.weight.grad, atol=1e-5, rtol=1e-4)


def test_bf16_statistics_are_reduced_in_f32_and_stay_f32():
    v = _setup(5, 4)
    bn = _port(v)
    x = (torch.randn(2, 4, 8, 8, generator=torch.Generator().manual_seed(2))
         .bfloat16())
    y = bn(x)
    assert y.dtype == torch.bfloat16
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
    xf = x.float()
    np.testing.assert_allclose(
        bn.running_mean.numpy(),
        0.9 * v["mean"] + 0.1 * xf.mean(dim=(0, 2, 3)).numpy(), rtol=1e-5,
        atol=1e-6)


def test_eval_mode_uses_the_running_statistics():
    v = _setup(6, 3)
    bn = _port(v).eval()
    x = np.random.default_rng(7).standard_normal((2, 3, 4, 4)).astype(np.float32)
    want = JaxBatchNorm().apply(
        _jax_variables(v), jnp.asarray(np.transpose(x, (0, 2, 3, 1))),
        train=False)
    np.testing.assert_allclose(
        bn(torch.from_numpy(x)).detach().numpy(),
        np.transpose(np.asarray(want), (0, 3, 1, 2)), atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(bn.running_var.numpy(), v["var"])
