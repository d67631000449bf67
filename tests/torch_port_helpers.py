"""Helpers shared by the port's test files; imports no JAX, so
``tests/test_torch_port_cuda.py`` can use it on a machine without JAX.

- :func:`one_torch_thread` and the module fixture :func:`torch_one_thread`;
- the train-mode check of every block mode against ``plain``
  (:func:`train_plain_reference`, :func:`check_train_mode_against_plain`);
- :func:`root_pair`, the inputs of the root-loss kernel tests.
"""

import contextlib

import numpy as np
import pytest
import torch

from tpudepth_torch.models.layers import init_random_
from tpudepth_torch.models.registry import build_model

HW = (64, 96)


@contextlib.contextmanager
def one_torch_thread():
    """torch on one intra-op thread for the block: the tier-1 gate runs six
    workers on eight cores, where each worker's eight OpenMP threads fight
    over them (a float64 train step took 640 s there against 2 s alone)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    """:func:`one_torch_thread` around every test of a module that imports
    this fixture."""
    with one_torch_thread():
        yield


def train_step_grads(name, mode, weights, x):
    """Output and parameter gradients of one train-mode forward and
    backward (loss: the mean square of the map) of ``name`` in ``mode``."""
    port = build_model(name, attn=mode)
    port.load_state_dict(weights)
    y = port.train()(x)
    y.square().mean().backward()
    return y.detach(), {n: p.grad for n, p in port.named_parameters()}


def train_plain_reference(name):
    """Seeded weights of ``name``, a 2x3x64x96 batch, and the ``plain``
    mode's train-mode output and gradients."""
    weights = init_random_(build_model(name, attn="plain"), seed=5).state_dict()
    x = torch.rand(2, 3, *HW, generator=torch.Generator().manual_seed(6))
    with one_torch_thread():
        return name, weights, x, train_step_grads(name, "plain", weights, x)


def check_train_mode_against_plain(reference, mode):
    """Every mode trains through the unfused block: the kernel modes through
    the training kernels' plain versions (f32 here, so their roundings are
    exact), ``plain`` through the f32 compositions; the two differ by the
    order of f32 sums: output 1e-5, each gradient 1e-4 of its tensor's
    largest, under a floor of 1e-6 of the largest gradient of all (the
    BatchNorm biases behind a BatchNorm hold noise of 1e-9)."""
    name, weights, x, (y0, g0) = reference
    with one_torch_thread():
        y, g = train_step_grads(name, mode, weights, x)
    assert y.shape == (2, 1, *HW) and float(y0.std()) > 1e-3
    torch.testing.assert_close(y, y0, atol=1e-5, rtol=1e-5)
    floor = 1e-6 * max(float(t.abs().max()) for t in g0.values())
    assert set(g) == set(g0)
    for n, t in g.items():
        scale = float(g0[n].abs().max())
        assert float((t - g0[n]).abs().max()) <= max(1e-4 * scale, floor), n


def root_pair(kind, bsz, h, w, device, seed=0):
    """``(pred, target)`` ``[B,H,W]`` float32 at the root recipe's scale.
    ``unit``: both uniform in [0.05, 0.95] (a min-max target and a sigmoid
    prediction); ``anti``: a prediction strongly anticorrelated with the
    target, which pushes ``(1 - SSIM) / 2`` towards the clip's bounds;
    ``equal``: pred == target (SSIM 1, the loss map at the clip's bound,
    signs at 0); ``smooth``: piecewise-constant images, the prediction off
    by a constant in each half, so variances and differences of
    neighbours hit 0 while the loss map stays inside the clip."""
    rng = np.random.default_rng(seed)
    t = rng.random((bsz, h, w)) * 0.9 + 0.05
    p = rng.random((bsz, h, w)) * 0.9 + 0.05
    if kind == "anti":
        p = 1.0 - t + 0.05 * p
    elif kind == "equal":
        p = t.copy()
    elif kind == "smooth":
        t = np.repeat(np.repeat(rng.integers(1, 9, (bsz, -(-h // 8), -(-w // 8))),
                                8, axis=1), 8, axis=2)[:, :h, :w] / 10.0
        p = t.copy()
        p[:, : h // 2] += 0.05
        p[:, h // 2:] -= 0.03

    def dev(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    return dev(p), dev(t)
