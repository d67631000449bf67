"""Transformer block tail for inference over rows:
``y = x + o Wp + bp``; ``out = y + fc2(gelu(fc1(LN(y))))``.

Counterpart of ``tpudepth/ops/pallas/epilogue_infer.py::block_epilogue_infer``.
The kernel is ``tpudepth_torch/csrc/epilogue_infer.cu``
(``block_epilogue_infer``), CUDA C++ for ``sm_90a`` built by ``_build``; its
header says what bounds it and how it is laid out. It shares its f32 device
code and its bf16 FFN products with ``mlp_infer``
(``ops/kernels/mlp_infer.py``), which is why both live in one source. In
bf16 one call runs a chain of four CUDA kernels, three products on the
pipelined ``wgmma`` core of ``csrc/gemm_sm90.cuh`` and a LayerNorm,
through bf16 scratch that the wrapper allocates
(:func:`epilogue_scratch_shapes`): ``y`` and ``LN(y)`` ``[M, C]`` and the
hidden ``gelu(h)`` ``[M, H]``, each a tensor the kernel rounds to bf16
anyway. The wrapper :func:`block_epilogue_infer` counts its launches; the
plain version :func:`block_epilogue_infer_reference` has the kernel's
rounding order. CPU tensors run the plain version; CUDA tensors
launch the kernel or raise. The boundary keeps the JAX layout:

- ``o``, ``x``: ``[M, C]`` in one dtype (float32 or bfloat16);
- ``wproj`` ``[C, C]``, ``w1`` ``[C, H]``, ``w2`` ``[H, C]``: float32
  ``[in, out]`` (the ``.t()`` view of a ``Linear`` weight is taken without a
  copy); biases and the LayerNorm's ``lns``, ``lnb`` float32 vectors.

The kernel takes C and H multiples of 32 that are at most 128 or multiples
of 128, and C <= 1024 (SAM and NewCRF: C 128-1024, H = 4C). bf16 runs on
the tensor cores, f32 on the CUDA cores in full f32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from tpudepth_torch.ops.kernels import _build, _op

_VP, _I32 = ctypes.c_void_p, ctypes.c_int

INV_SQRT2 = 0.7071067811865476
LN_EPS = 1e-5


def gelu_exact(h: torch.Tensor) -> torch.Tensor:
    """``0.5 h (1 + erf(h / sqrt 2))`` in f32, rounded to ``h``'s dtype."""
    hf = h.float()
    return (0.5 * hf * (1.0 + torch.erf(hf * INV_SQRT2))).to(h.dtype)


def layer_norm_f32(y: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """flax's LayerNorm over the last dim in f32 (fast variance, eps 1e-5)."""
    yf = y.float()
    mean = yf.mean(dim=-1, keepdim=True)
    var = torch.clamp((yf * yf).mean(dim=-1, keepdim=True) - mean * mean,
                      min=0.0)
    return (yf - mean) * (torch.rsqrt(var + LN_EPS) * scale.float()) + bias.float()


def linear_f32(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a w + b`` in f32 of ``a`` (IO dtype) and ``w`` [in, out] rounded to
    ``a``'s dtype."""
    return a.float() @ w.to(a.dtype).float() + b.float()


def ffn_reference(a, w1, b1, w2, b2) -> torch.Tensor:
    """``fc2(gelu(fc1(a)))`` in the kernels' rounding order, in f32 before
    its last rounding: ``h`` and ``gelu(h)`` are rounded to ``a``'s dtype."""
    g = gelu_exact(linear_f32(a, w1, b1).to(a.dtype))
    return linear_f32(g, w2, b2)


def block_epilogue_infer_reference(o, x, wproj, bproj, lns, lnb, w1, b1, w2,
                                   b2) -> torch.Tensor:
    """Plain PyTorch version in the kernel's rounding order (module doc of
    ``csrc/epilogue_infer.cu``)."""
    dt = o.dtype
    z = linear_f32(o, wproj, bproj).to(dt)
    y = (x.to(dt).float() + z.float()).to(dt)
    yn = layer_norm_f32(y, lns, lnb).to(dt)
    m = ffn_reference(yn, w1, b1, w2, b2).to(dt)
    return (y.float() + m.float()).to(dt)


def tolerance(dtype: torch.dtype) -> Tuple[float, float]:
    """``(atol, rtol)`` of ``block_epilogue_infer`` and ``mlp_infer``
    against their plain versions on the same inputs; atol is a fraction of
    the output's largest value.

    f32: the products are the same; sums of up to 4C terms run in other
    orders, and erf, rsqrt come from other libraries: a few ulps of f32
    carried through three products. bf16: the products of bf16 values are
    exact in f32 on both sides, only their sums run in other orders; each of
    z, y, LN(y), h, gelu(h) and m is rounded once to bf16, and a value
    within rounding of a bf16 boundary rounds the other way on one side; the
    output then differs by up to one bf16 ulp of m plus the ulp of its own
    rounding (2 x 2^-7 relative), and the flips upstream move it by less
    than an ulp of the output's largest value."""
    if dtype == torch.bfloat16:
        return 2.0 ** -7, 2.0 ** -6
    return 1e-5, 1e-5


#: ctypes signature of the FFN entries (``mlp_infer`` here,
#: ``mlp_train_fwd`` in ``mlp_train.py``): x, w1, b1, w2, b2, out, the bf16
#: scratch g; M, C, H, C2, is_bf16; the stream
FFN_ARGTYPES = (_VP,) * 7 + (_I32,) * 5 + (_VP,)
#: ctypes signature of each C entry of ``csrc/epilogue_infer.cu``
ARGTYPES = {"block_epilogue_infer": (_VP,) * 14 + (_I32,) * 4 + (_VP,),
            "mlp_infer": FFN_ARGTYPES}


def bind(so: ctypes.CDLL, argtypes: dict) -> ctypes.CDLL:
    """Set the signature of each named entry of ``so`` (each returns a
    ``cudaError_t`` as an int)."""
    for name, types in argtypes.items():
        fn = getattr(so, name)
        fn.argtypes = list(types)
        fn.restype = _I32
    return so


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The loaded ``epilogue_infer`` library (both entry points)."""
    return bind(_build.load("epilogue_infer"), ARGTYPES)


def width_ok(n: int, out: bool = False) -> bool:
    """A width (C, H; ``out``: an output width, at most 1024) the kernels
    take."""
    return (n >= 32 and n % 32 == 0 and (n <= 128 or n % 128 == 0)
            and (not out or n <= 1024))


def epilogue_scratch_shapes(m: int, c: int, hidden: int) -> dict:
    """Shapes of the bf16 chain's scratch (bf16): ``y`` and ``yn`` (LN(y))
    ``[M, C]``, ``g`` (gelu(h)) ``[M, H]``. f32 runs one kernel and needs
    none."""
    return {"y": (m, c), "yn": (m, c), **ffn_scratch_shapes(m, hidden)}


def ffn_scratch_shapes(m: int, hidden: int) -> dict:
    """Shapes of the bf16 FFN chain's scratch (bf16) in ``mlp_infer`` and
    ``mlp_train_fwd``: the rounded hidden ``g`` (gelu(h)) ``[M, H]``. f32
    runs one kernel and needs none."""
    return {"g": (m, hidden)}


def check_cuda(name, rows, weights, vectors):
    """Device, dtype and contiguity of the arguments of a launch; returns
    the weights in the kernel's layout: ``[out, in]`` contiguous in the IO
    dtype (for f32 the ``.t()`` view of a Linear weight as it is; bf16
    weights are cast here, as the JAX wrappers do with ``.astype(dt)``)."""
    dev, dt = rows[0].device, rows[0].dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes float32 or bfloat16, not {dt}")
    for t in rows:
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: row inputs must be contiguous {dt}")
        if t.data_ptr() % 16:
            # the bf16 kernel reads rows in 16-byte pieces
            raise ValueError(f"{name}: row inputs must be 16-byte aligned")
    out = []
    for t in list(weights) + list(vectors):
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, expected {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: weights and vectors must be float32")
    for w in weights:
        out.append(w.t().to(dt).contiguous())
    for v in vectors:
        if not v.is_contiguous():
            raise ValueError(f"{name}: vectors must be contiguous")
    return out


def block_epilogue_infer(o: torch.Tensor, x: torch.Tensor,
                         wproj: torch.Tensor, bproj: torch.Tensor,
                         lns: torch.Tensor, lnb: torch.Tensor,
                         w1: torch.Tensor, b1: torch.Tensor,
                         w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """``[M, C]`` block output in ``o``'s dtype. CPU tensors run
    :func:`block_epilogue_infer_reference`; CUDA tensors launch the
    ``block_epilogue_infer`` kernel (counted in
    ``block_epilogue_infer.launches``); through :data:`OP` only while
    ``torch.export`` traces."""
    m, c = o.shape
    hidden = w1.shape[1]
    if (x.shape != o.shape or wproj.shape != (c, c) or w1.shape[0] != c
            or w2.shape != (hidden, c)
            or any(t.shape != (c,) for t in (bproj, lns, lnb, b2))
            or b1.shape != (hidden,)):
        raise ValueError("block_epilogue_infer: shapes do not fit "
                         f"o {tuple(o.shape)}, w1 {tuple(w1.shape)}")
    _op.check_device("block_epilogue_infer", o)
    args = (o, x, wproj, bproj, lns, lnb, w1, b1, w2, b2)
    return OP(*args) if _op.through_op() else _run(*args)


def _run(o, x, wproj, bproj, lns, lnb, w1, b1, w2, b2):
    """The kernel of a call on o's device: the plain version on the CPU, the
    launch on the card (counted)."""
    m, c = o.shape
    hidden = w1.shape[1]
    if o.device.type == "cpu":
        return block_epilogue_infer_reference(o, x, wproj, bproj, lns, lnb,
                                              w1, b1, w2, b2).contiguous()
    if o.device.type != "cuda":
        raise ValueError(f"no block_epilogue_infer kernel for {o.device}")
    if not (width_ok(c, out=True) and width_ok(hidden)):
        raise ValueError(f"block_epilogue_infer takes widths that are "
                         f"multiples of 32, at most 128 or multiples of 128, "
                         f"and C <= 1024, not C={c}, H={hidden}")
    wp, w1t, w2t = check_cuda("block_epilogue_infer", (o, x),
                              (wproj, w1, w2), (bproj, lns, lnb, b1, b2))
    out = torch.empty_like(o)
    bf16 = o.dtype == torch.bfloat16
    # kept alive until the launch is queued (the allocator reuses freed
    # memory in stream order)
    scratch = [torch.empty(shape, dtype=o.dtype, device=o.device)
               if bf16 else None
               for shape in epilogue_scratch_shapes(m, c, hidden).values()]
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        rc = lib().block_epilogue_infer(
            o.data_ptr(), x.data_ptr(), wp.data_ptr(), bproj.data_ptr(),
            lns.data_ptr(), lnb.data_ptr(), w1t.data_ptr(), b1.data_ptr(),
            w2t.data_ptr(), b2.data_ptr(), out.data_ptr(),
            *(t if t is None else t.data_ptr() for t in scratch), m, c,
            hidden, int(bf16), stream)
    if rc != 0:
        raise RuntimeError(f"block_epilogue_infer launch failed: CUDA error {rc}")
    block_epilogue_infer.launches += 1
    return out


block_epilogue_infer.launches = 0

#: ``tpudepth::block_epilogue_infer``
OP = _op.define(
    "block_epilogue_infer",
    "(Tensor o, Tensor x, Tensor wproj, Tensor bproj, Tensor lns, Tensor lnb, "
    "Tensor w1, Tensor b1, Tensor w2, Tensor b2) -> Tensor",
    _run, _run, lambda o, *rest: o.new_empty(o.shape))
