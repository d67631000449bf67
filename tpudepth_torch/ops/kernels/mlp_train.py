"""Transformer FFN for training over rows, differentiable:
``fc2(gelu(fc1(x)))`` with gradients for x and the four parameters.

Counterpart of ``tpudepth/ops/pallas/mlp_train.py::mlp_train``, the custom
VJP over the forward ``_mlp_fwd_pallas`` and the backward
``_mlp_bwd_pallas``. The kernels are the two C entries of
``tpudepth_torch/csrc/mlp_train.cu``, ``mlp_train_fwd`` and
``mlp_train_bwd``, CUDA C++ for ``sm_90a`` built by ``_build``; the source's
header says what bounds them and how they are laid out. In bf16 both run
their products on the pipelined ``wgmma`` core of ``csrc/gemm_sm90.cuh``:
the forward is ``mlp_infer``'s chain of two products through the rounded
hidden ``a = gelu(h)`` ``[M, H]`` (scratch from
``epilogue_infer.ffn_scratch_shapes``, not kept: the backward recomputes
it); the backward spills ``a`` and ``dh1`` to ``[M, H]`` scratch that the
wrapper allocates (:func:`bwd_scratch_shapes`), with the f32 partial sums
of the bias and weight gradients. f32 runs on the CUDA cores. The wrappers
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
#: the backward's row tile (db1 partials), column-sum chunk (db2) and the
#: depth of a k-block of its bf16 products (weight-gradient chunks are
#: whole k-blocks)
ROW_TILE, COLSUM_ROWS, K_BLOCK = 128, 256, 64
#: the H100's SMs: a weight-gradient product with fewer tiles of 128 x 128
#: is split over chunks of rows until it has about one tile an SM
SMS = 132


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


#: ctypes signature of each C entry of ``csrc/mlp_train.cu``
ARGTYPES = {"mlp_train_fwd": _epi.FFN_ARGTYPES,
            "mlp_train_bwd": (_VP,) * 17 + (_I32,) * 7 + (_VP,)}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _epi.bind(_build.load("mlp_train"), ARGTYPES)


def wgrad_chunk(m: int, rows: int, cols: int) -> int:
    """Rows of x a block of a weight-gradient product (``rows x cols``)
    sums: all of them when the product has at least :data:`SMS` tiles of
    128 x 128, else as many chunks as fit :data:`SMS` tiles, in multiples of
    :data:`K_BLOCK` (a function of the shape alone, so the partial sums add
    up in the same order on every run)."""
    tiles = -(-rows // 128) * -(-cols // 128)
    chunks = max(1, min(SMS // tiles, -(-m // K_BLOCK)))
    return -(-(-(-m // chunks)) // K_BLOCK) * K_BLOCK


def bwd_scratch_shapes(m: int, c: int, hidden: int, c2: int) -> dict:
    """Shapes of the backward's scratch: ``a`` and ``dh`` ``[M, H]`` in the
    IO dtype; f32 partials ``db1_part`` (one row a row tile of
    :data:`ROW_TILE`), ``db2_part`` (a chunk of :data:`COLSUM_ROWS`),
    ``dw1_part`` and ``dw2_part`` (a chunk of :func:`wgrad_chunk` rows; None
    for one chunk, which the kernel sums straight into the gradient)."""
    n1 = -(-m // wgrad_chunk(m, c, hidden))
    n2 = -(-m // wgrad_chunk(m, hidden, c2))
    return {"a": (m, hidden), "dh": (m, hidden),
            "db1_part": (-(-m // ROW_TILE), hidden),
            "db2_part": (-(-m // COLSUM_ROWS), c2),
            "dw1_part": (n1, c, hidden) if n1 > 1 else None,
            "dw2_part": (n2, hidden, c2) if n2 > 1 else None}


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
    shapes = bwd_scratch_shapes(m, c, hidden, c2)
    dx = torch.empty((m, c), dtype=dt, device=dev)
    dw1, db1, dw2, db2 = f32(c, hidden), f32(hidden), f32(hidden, c2), f32(c2)
    a, dh = (torch.empty(shapes[k], dtype=dt, device=dev) for k in ("a", "dh"))
    db1_part, db2_part = f32(*shapes["db1_part"]), f32(*shapes["db2_part"])
    dw1_part = f32(*shapes["dw1_part"]) if shapes["dw1_part"] else dw1
    dw2_part = f32(*shapes["dw2_part"]) if shapes["dw2_part"] else dw2
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
