"""Helpers shared by the port's test files; imports no JAX, so
``tests/test_torch_port_cuda.py`` can use it on a machine without JAX.

- :func:`one_torch_thread` and the module fixture :func:`torch_one_thread`;
- the train-mode check of every block mode against ``plain``
  (:func:`train_plain_reference`, :func:`check_train_mode_against_plain`);
- :func:`root_pair`, the inputs of the root-loss kernel tests;
- :func:`serving_op_cases`, small inputs of the eight serving kernels'
  ``tpudepth::*`` custom ops; :func:`round_trip` and
  :func:`same_bits_deserialized`, an engine serialized and deserialized
  against the live one, and :func:`op_counts`;
- NewCRF's row stage chain: :func:`blocks_one_by_one` (each block padded
  and cropped on its own, what the chain must equal bit for bit) and
  :func:`chained_blocks` (what each chained block takes and gives).
"""

import collections
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


def serving_op_cases(device, dtype=torch.float32, seed=0):
    """``{name: (op, kernel, args)}`` for each serving kernel's custom op:
    ``op`` its default overload, ``kernel`` the function that its CPU and
    CUDA kernels run (the wrapper's plain version or launch), ``args``
    small inputs in its schema's order on ``device``, rows in ``dtype``
    and parameters in float32, at widths every kernel takes: C 64, two
    heads of 32, H 256, 7x7 windows of a 10x12 map padded to 14x14 (shift 3
    where a mask applies), so pads, masks and valid tables are all used. k
    and v of ``window_attn_infer`` are the two halves of one projection,
    weights are ``.t()`` views of ``Linear`` weights and the GUB conv's an
    HWIO view of an OIHW weight, as the models pass them."""
    from tpudepth_torch.ops.kernels import (
        block_infer,
        epilogue_infer,
        gub_conv,
        mlp_infer,
        rowblock_infer,
        window_attn_infer,
    )
    from tpudepth_torch.ops.window import (
        shifted_window_attention_mask,
        window_valid_mask,
    )

    rng = np.random.default_rng(seed)
    c, hidden, heads, ws, h, w, shift = 64, 256, 2, 7, 10, 12, 3
    n = ws * ws

    def t(*shape, s=1.0, mean=0.0, dt=torch.float32):
        a = mean + s * rng.standard_normal(shape)
        return torch.from_numpy(a.astype(np.float32)).to(device, dt)

    def linear(cin, cout):   # a Linear weight's [in, out] view and its bias
        return t(cout, cin, s=cin ** -0.5).t(), t(cout, s=0.05)

    def ln():
        return t(c, s=0.1, mean=1.0), t(c, s=0.1)

    def table(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    bias = t(heads, n, n)
    mask = table(shifted_window_attention_mask(h, w, ws, shift))
    valid = table(window_valid_mask(h, w, ws, shift))
    scale = (c // heads) ** -0.5
    wp, bp = linear(c, c)
    w1, b1 = linear(c, hidden)
    w2, b2 = linear(hidden, c)
    tail = (wp, bp, *ln(), w1, b1, w2, b2)
    rows = (t(1, 14, 14, c, dt=dtype), t(1, 14, 14, c, dt=dtype))
    windows = (t(4, n, c, dt=dtype), t(4, n, c, dt=dtype))
    wqk, bqk = linear(c, 2 * c)
    wq, bq = linear(c, c)
    kv = t(4, n, 2 * c, dt=dtype)
    gub_w = t(32, 32, 3, 3, s=1 / 17).permute(2, 3, 1, 0)
    parts = [t(1, 8, 10, 16, dt=dtype), t(1, 8, 10, 16, dt=dtype)]
    a = [t(1, 16, s=0.2, mean=1.0), t(1, 16, s=0.2, mean=1.0)]
    cc = [t(1, 16), t(1, 16)]
    return {
        "gub_conv_fwd": (gub_conv.FWD_OP, gub_conv._fwd_run, (
            parts, gub_w, t(32, s=0.1), a, cc, t(1, 8, 10, 16, dt=dtype),
            False)),
        "window_attn_infer": (
            window_attn_infer.OP, window_attn_infer._run,
            (t(4, n, c, dt=dtype), kv[..., :c], kv[..., c:], bias, mask)),
        "block_epilogue_infer": (
            epilogue_infer.OP, epilogue_infer._run,
            (t(100, c, dt=dtype), t(100, c, dt=dtype), *tail)),
        "mlp_infer": (mlp_infer.OP, mlp_infer._run,
                      (t(100, c, dt=dtype), w1, b1, w2, b2)),
        "crf_rowblock_infer": (
            rowblock_infer.CRF_OP, rowblock_infer._crf_run,
            (*rows, *ln(), wqk, bqk, bias, *tail, mask, scale, ws, h, w,
             shift)),
        "sam_rowblock_infer": (
            rowblock_infer.SAM_OP, rowblock_infer._sam_run,
            (*rows, *ln(), *ln(), wq, bq, *linear(c, 2 * c), bias, *tail,
             scale, ws, h, w)),
        "sam_block_infer": (
            block_infer.SAM_OP, block_infer._sam_run,
            (*windows, *ln(), *ln(), wq, bq, *linear(c, 2 * c), bias, *tail,
             valid, scale)),
        "crf_block_infer": (
            block_infer.CRF_OP, block_infer._crf_run,
            (*windows, *ln(), wqk, bqk, bias, *tail, mask, valid, scale)),
    }


def op_counts(exported):
    """``{op name: calls}`` of the ``tpudepth::*`` nodes of a deserialized
    engine's program."""
    return collections.Counter(
        str(n.target).split(".")[1] for n in exported.program.graph.nodes
        if str(n.target).startswith("tpudepth."))


def round_trip(tmp_path, model, hw, tta, meters, seed=0, device="cpu"):
    """A bf16 engine of ``model`` at ``(1, 3, *hw)`` (flip-TTA when ``tta``,
    the meters conversion at 10 m when ``meters``) serialized, then held
    against its deserialized engine (:func:`same_bits_deserialized`)."""
    from tpudepth_torch.infer.engine import InferenceEngine

    live = InferenceEngine(model, (1, 3, *hw), compute_dtype=torch.bfloat16,
                           flip_tta=tta, max_depth=10.0 if meters else None,
                           device=device)
    path = str(tmp_path / "engine.pt2")
    live.serialize(path)
    return same_bits_deserialized(live, path, seed)


def same_bits_deserialized(live, path, seed=0):
    """The engine that ``live`` serialized to ``path``, deserialized: both
    answer two images with the same bits. Returns the deserialized
    engine's :func:`op_counts`."""
    from tpudepth_torch.infer.engine import InferenceEngine

    loaded = InferenceEngine.deserialize(path)
    assert loaded.input_shape == live.input_shape
    rng = np.random.default_rng(seed)
    for _ in range(2):
        x = rng.random(live.input_shape, dtype=np.float32)
        want, got = live(x), loaded(x)
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert float(want.std()) > 1e-3
        assert torch.equal(got, want)
    return op_counts(loaded)


def _crf_layers(model):
    from tpudepth_torch.models.newcrf import CRFLayer

    return [m for m in model.modules() if isinstance(m, CRFLayer)]


@contextlib.contextmanager
def blocks_one_by_one(model):
    """Every NewCRF stage of ``model`` runs its blocks one by one through
    ``CRFBlock.forward``, each padding and cropping its own maps, instead of
    the row mode's padded chain."""
    layers = _crf_layers(model)

    def one_by_one(layer):
        def forward(x, v):
            for blk in layer.blocks:
                x = blk(x, v)
            return x
        return forward

    for layer in layers:
        layer.forward = one_by_one(layer)
    try:
        yield
    finally:
        for layer in layers:
            del layer.forward


@contextlib.contextmanager
def chained_blocks(model):
    """Records ``(x, output)`` of every ``CRFBlock.rowblock`` call of
    ``model``'s NewCRF stages, in order, into the yielded list."""
    seen = []
    blocks = [b for layer in _crf_layers(model) for b in layer.blocks]

    def recording(blk):
        rowblock = blk.rowblock

        def call(xp, vp, h, w):
            y = rowblock(xp, vp, h, w)
            seen.append((xp, y))
            return y
        return call

    for blk in blocks:
        blk.rowblock = recording(blk)
    try:
        yield seen
    finally:
        for blk in blocks:
            del blk.rowblock
