"""Transformer FFN for training over rows, differentiable:
``fc2(gelu(fc1(x)))`` with gradients for x and the four parameters.

Counterpart of ``tpudepth/ops/pallas/mlp_train.py::mlp_train``, the custom
VJP over the forward ``_mlp_fwd_pallas`` and the backward
``_mlp_bwd_pallas``. The kernels are the two C entries of
``tpudepth_torch/csrc/mlp_train.cu``, ``mlp_train_fwd`` and
``mlp_train_bwd``, CUDA C++ for ``sm_90a`` built by ``_build``; the source's
header says what bounds them and how they are laid out. The wrappers
:func:`mlp_train_fwd` and :func:`mlp_train_bwd` count their launches; the
plain versions :func:`mlp_train_fwd_reference` and
:func:`mlp_train_bwd_reference` have the kernels' rounding order. CPU
tensors run the plain versions; CUDA tensors launch the kernels or raise.
:func:`mlp_train` is the ``torch.autograd.Function`` over the two.

The boundary keeps the JAX layout: ``x`` ``[M, C]``; ``w1`` ``[C, H]`` and
``w2`` ``[H, C2]`` ``[in, out]`` (the ``.t()`` view of a ``Linear`` weight),
``b1``, ``b2`` vectors, cast to x's dtype at use (as the JAX package's
``.astype(dt)``; on the card float32, as the layers hold them), their
gradients f32 sums returned in the parameters' dtype. Any row count; on the
card contiguous 16-byte aligned rows, C,
H and C2 multiples of 32 that are at most 128 or multiples of 128, C2 at
most 1024 (SAM and NewCRF: C 128-1024, H = 4C), float32 or bfloat16.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from tpudepth_torch.ops.kernels import _build
from tpudepth_torch.ops.kernels import epilogue_infer as _epi
from tpudepth_torch.ops.kernels import mlp_infer as _mi

_VP, _I32 = ctypes.c_void_p, ctypes.c_int

INV_SQRT2 = 0.7071067811865476
INV_SQRT_2PI = 0.3989422804014327
#: the backward's row tile (db1 partials) and column-sum chunk (db2)
ROW_TILE, COLSUM_ROWS = 128, 256
#: blocks a weight-gradient product aims at: the card's 132 SMs twice
WGRAD_BLOCKS = 264


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The type sums are taken in: float32, or float64 for float64."""
    return torch.promote_types(dtype, torch.float32)


def _io(t: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``t`` rounded to the IO dtype, in the sum type."""
    return t.to(dt).to(_acc(dt))


def gelu_and_grad(h: torch.Tensor):
    """``gelu(h)`` and ``gelu'(h)`` with the exact erf:
    ``0.5 h (1 + erf(h / sqrt 2))`` and ``0.5 (1 + erf(h / sqrt 2)) + h
    exp(-h^2 / 2) / sqrt(2 pi)``."""
    cdf = 0.5 * (1.0 + torch.erf(h * INV_SQRT2))
    return h * cdf, cdf + h * (torch.exp(-0.5 * h * h) * INV_SQRT_2PI)


def _hidden(x, w1, b1):
    """``h = round(x W1 + b1)`` in the sum type."""
    dt = x.dtype
    return _io(x.to(_acc(dt)) @ _io(w1, dt) + _io(b1, dt), dt)


def mlp_train_fwd_reference(x, w1, b1, w2, b2) -> torch.Tensor:
    """Plain PyTorch forward in the kernel's rounding order: ``h`` and
    ``a = gelu(h)`` rounded to x's dtype, the output rounded."""
    dt = x.dtype
    a, _ = gelu_and_grad(_hidden(x, w1, b1))
    return (_io(a, dt) @ _io(w2, dt) + _io(b2, dt)).to(dt)


def mlp_train_bwd_reference(x, g, w1, b1, w2):
    """Plain PyTorch backward in the kernel's rounding order (JAX's
    ``_bwd_kernel``): ``(dx, dw1, db1, dw2, db2)``, dx in x's dtype, the
    rest in the sum type (f32, or f64 for f64 inputs)."""
    dt = x.dtype
    a, dgelu = gelu_and_grad(_hidden(x, w1, b1))
    ga = _io(g, dt)
    ad = _io(a, dt)
    dw2 = ad.t() @ ga
    db2 = ga.sum(dim=0)
    dh1 = (ga @ _io(w2, dt).t()) * dgelu
    dh1d = _io(dh1, dt)
    dx = (dh1d @ _io(w1, dt).t()).to(dt)
    dw1 = x.to(_acc(dt)).t() @ dh1d
    return dx, dw1, dh1.sum(dim=0), dw2, db2


def tolerance(dtype: torch.dtype) -> Tuple[Tuple[float, float],
                                           Tuple[float, float]]:
    """``((atol, rtol) of the output and dx; (atol, rtol) of dw1, db1, dw2,
    db2)`` of the kernels against their plain versions on the same inputs,
    atol a fraction of the tensor's largest value; the backward adds
    :func:`flip_atol` elementwise.

    Output and dx are ``mlp_infer``'s (``epilogue_infer.tolerance``): sums
    in other orders and another erf in f32; in bf16 a value within rounding
    of a bf16 boundary rounds the other way on one side, and the output's
    own rounding can land on the neighbouring value. The parameter
    gradients are f32 sums over up to 153,600 rows in other orders: 1e-5 of
    the largest, 1e-4 relative, in both dtypes (products of bf16 values are
    exact in f32)."""
    return _epi.tolerance(dtype), (1e-5, 1e-4)


def _ulp(t: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """One unit in the last place of ``dt`` at each value of ``t``."""
    info = torch.finfo(dt)
    e = torch.floor(torch.log2(t.abs().clamp(min=info.tiny)))
    return torch.exp2(e) * info.eps


def flip_atol(x, g, w1, b1, w2):
    """Elementwise atol of ``(dx, dw1, db1, dw2, db2)`` of the backward
    kernel for the roundings that may go the other way: zeros in f32; in
    bf16, where the kernel and the plain version sum ``h = x W1`` in other
    orders, an ``h`` within rounding of a bf16 boundary rounds to the
    neighbouring value on one side (about 5e-4 of them), and ``a``, ``dh1``
    round once more. Per row such a flip moves ``a`` by at most
    ``ulp(a) + |gelu'(h)| ulp(h)`` and ``dh1`` by ``ulp(dh1) + |da gelu''(h)|
    ulp(h)``; a gradient element is allowed two flips at the largest of
    these times the largest other factor of its sum (over 153,600 rows the
    ~80 flips of random sign add up to well under that)."""
    dt = x.dtype
    if dt != torch.bfloat16:
        return (None,) * 5
    with torch.no_grad():
        h = _hidden(x, w1, b1)
        a, dgelu = gelu_and_grad(h)
        da = _io(g, dt) @ _io(w2, dt).t()
        dh1 = da * dgelu
        d2 = torch.exp(-0.5 * h * h) * INV_SQRT_2PI * (2.0 - h * h)
        uh = _ulp(h, dt)
        d_a = _ulp(a, dt) + dgelu.abs() * uh
        d_dh_pre = (da * d2).abs() * uh
        d_dh = _ulp(dh1, dt) + d_dh_pre
        xm = x.float().abs().amax(dim=0)
        gm = g.float().abs().amax(dim=0)
        w1m = w1.float().abs().amax(dim=1)
        return (2 * torch.outer(d_dh.amax(dim=1), w1m),
                2 * torch.outer(xm, d_dh.amax(dim=0)),
                2 * d_dh_pre.amax(dim=0),
                2 * torch.outer(d_a.amax(dim=0), gm),
                torch.zeros_like(gm))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("mlp_train")
    lib.mlp_train_fwd.argtypes = [_VP] * 6 + [_I32] * 5 + [_VP]
    lib.mlp_train_bwd.argtypes = [_VP] * 17 + [_I32] * 7 + [_VP]
    for fn in (lib.mlp_train_fwd, lib.mlp_train_bwd):
        fn.restype = _I32
    return lib


def wgrad_chunk(m: int, rows: int, cols: int) -> int:
    """Rows of x a block of a weight-gradient product (``rows x cols``)
    sums: enough chunks for about :data:`WGRAD_BLOCKS` blocks, in multiples
    of 32 (a function of the shape alone, so the partial sums add up in the
    same order on every run)."""
    tiles = -(-rows // 128) * -(-cols // 64)
    chunks = max(1, min(-(-WGRAD_BLOCKS // tiles), -(-m // 32)))
    return -(-(-(-m // chunks)) // 32) * 32


def _shapes(x, w1, b1, w2, b2=None):
    m, c = x.shape
    hidden, c2 = w2.shape
    if (w1.shape != (c, hidden) or b1.shape != (hidden,)
            or (b2 is not None and b2.shape != (c2,))):
        raise ValueError(f"mlp_train: shapes do not fit x {tuple(x.shape)}, "
                         f"w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    return m, c, hidden, c2


def mlp_train_fwd(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """``[M, C2]`` in x's dtype. CPU tensors run
    :func:`mlp_train_fwd_reference`; CUDA tensors launch the
    ``mlp_train_fwd`` kernel (counted in ``mlp_train_fwd.launches``)."""
    _shapes(x, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return mlp_train_fwd_reference(x, w1, b1, w2, b2)
    out = _mi.launch_ffn(_lib, "mlp_train_fwd", x, w1, b1, w2, b2,
                         round_vectors=True)
    mlp_train_fwd.launches += 1
    return out


mlp_train_fwd.launches = 0


def mlp_train_bwd(x: torch.Tensor, g: torch.Tensor, w1: torch.Tensor,
                  b1: torch.Tensor, w2: torch.Tensor):
    """``(dx, dw1, db1, dw2, db2)``: dx ``[M, C]`` in x's dtype, the rest
    float32 (``[C, H]``, ``[H]``, ``[H, C2]``, ``[C2]``). CPU tensors run
    :func:`mlp_train_bwd_reference`; CUDA tensors launch the
    ``mlp_train_bwd`` kernels (counted in ``mlp_train_bwd.launches``)."""
    m, c, hidden, c2 = _shapes(x, w1, b1, w2)
    if g.shape != (m, c2):
        raise ValueError(f"g {tuple(g.shape)} does not fit ({m}, {c2})")
    if x.device.type == "cpu":
        return mlp_train_bwd_reference(x, g, w1, b1, w2)
    if x.device.type != "cuda":
        raise ValueError(f"no mlp_train_bwd kernel for {x.device}")
    g = g.contiguous()
    _mi.check_widths("mlp_train_bwd", c, hidden, c2)
    dev, dt = x.device, x.dtype
    # the products take W1 in both layouts and W2 as [H, C2]
    w1t, _ = _epi.check_cuda("mlp_train_bwd", (x, g), (w1, w2), (b1,))
    w1c, w2c = (w.to(dt).contiguous() for w in (w1, w2))
    b1f = b1.to(dt).float()

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    k1, k2 = wgrad_chunk(m, c, hidden), wgrad_chunk(m, hidden, c2)
    n1, n2 = -(-m // k1), -(-m // k2)
    dx = torch.empty((m, c), dtype=dt, device=dev)
    dw1, db1, dw2, db2 = f32(c, hidden), f32(hidden), f32(hidden, c2), f32(c2)
    a, dh = (torch.empty((m, hidden), dtype=dt, device=dev) for _ in range(2))
    db1_part = f32(-(-m // ROW_TILE), hidden)
    db2_part = f32(-(-m // COLSUM_ROWS), c2)
    dw1_part = f32(n1, c, hidden) if n1 > 1 else dw1
    dw2_part = f32(n2, hidden, c2) if n2 > 1 else dw2
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().mlp_train_bwd(
            x.data_ptr(), g.data_ptr(), w1t.data_ptr(), w1c.data_ptr(),
            b1f.data_ptr(), w2c.data_ptr(),
            dx.data_ptr(), dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(),
            db2.data_ptr(), a.data_ptr(), dh.data_ptr(), db1_part.data_ptr(),
            db2_part.data_ptr(), dw1_part.data_ptr(), dw2_part.data_ptr(),
            m, c, hidden, c2, k1, k2, int(dt == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"mlp_train_bwd launch failed: CUDA error {rc}")
    mlp_train_bwd.launches += 1
    return dx, dw1, db1, dw2, db2


mlp_train_bwd.launches = 0


class MlpTrain(torch.autograd.Function):
    """The differentiable FFN: the forward and backward kernels (on CPU
    tensors their plain versions)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return mlp_train_fwd(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2, b2 = ctx.saved_tensors
        dx, dw1, db1, dw2, db2 = mlp_train_bwd(x, g, w1, b1, w2)
        return (dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
                db2.to(b2.dtype))


def mlp_train(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Differentiable ``fc2(gelu(fc1(x)))`` (module doc): x ``[M, C]``, w1
    ``[C, H]``, w2 ``[H, C2]``; ``[M, C2]`` in x's dtype."""
    return MlpTrain.apply(x, w1, b1, w2, b2)
