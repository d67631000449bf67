"""Channel-packed window attention for training, differentiable:
``out[w, :, h] = softmax(q_h k_h^T + bias[h] [+ mask[w % nW]]) v_h`` with
gradients for q, k, v and bias (the mask gets none).

Counterpart of ``tpudepth/ops/pallas/window_attn.py::window_attention``, the
custom VJP over the forward ``window_attention_pallas`` and the backward
``window_attention_bwd_pallas``. The kernels are the two C entries of
``tpudepth_torch/csrc/window_attn_train.cu``, ``window_attn_train_fwd`` and
``window_attn_train_bwd``, CUDA C++ for ``sm_90a`` built by ``_build`` (the
bf16 backward runs its five products on the tensor cores); the source's
header says what bounds them and how they are laid out. The
wrappers :func:`window_attention_fwd` and :func:`window_attention_bwd`
count their launches; the plain versions
:func:`window_attention_fwd_reference` and
:func:`window_attention_bwd_reference` have the kernels' rounding order.
CPU tensors run the plain versions; CUDA tensors launch the kernels or
raise. :func:`window_attention` is the ``torch.autograd.Function`` over the
two.

The boundary keeps the port's channel-packed layout (the JAX kernels take
the head-split ``[BW, heads, N, D]``; the packed one saves four head-split
transposes a direction):

- ``q``, ``k``, ``v``: ``[BW, N, C]``, C = heads * head_dim, q pre-scaled;
  on the card each needs contiguous channels and token rows a fixed stride
  apart (``k`` and ``v`` may be the two halves of one ``[BW, N, 2C]``);
- ``bias``: ``[heads, N, N]`` float32; ``mask``: None or ``[nW, N, N]``
  float32, BW a multiple of nW, windows ``[B, nW]``-major;
- the cotangent ``g`` and ``dq``, ``dk``, ``dv``: ``[BW, N, C]``;
  ``dbias``: ``[heads, N, N]`` float32.

The kernels take N <= 64 and a head_dim that is a multiple of 8 up to 64
(SAM and NewCRF: N = 49, head_dim 32), float32 or bfloat16.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from tpudepth_torch.ops.attention import from_heads, to_heads
from tpudepth_torch.ops.kernels import _build
from tpudepth_torch.ops.kernels import window_attn_infer as _wai

_VP, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

#: ``(atol, rtol)`` of the forward kernel against its plain version: the
#: forward's arithmetic is ``window_attn_infer``'s, and so is its tolerance
fwd_tolerance = _wai.tolerance

#: the backward kernel's blocks: about this many (chunk of windows, head)
#: blocks a call, each walking its chunk's windows in order (two rounds of
#: the bf16 kernel's 3 blocks an SM on the H100's 132 SMs)
BWD_BLOCKS = 792


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The type sums are taken in: float32, or float64 for float64."""
    return torch.promote_types(dtype, torch.float32)


def _probs(q, k, bias, mask):
    """Unrounded softmax of ``q k^T + bias [+ mask]`` over head-split q, k,
    in the sum type."""
    acc = _acc(q.dtype)
    bw, heads, n, _ = q.shape
    s = torch.einsum("bhnd,bhmd->bhnm", q.to(acc), k.to(acc))
    s = s + bias.to(acc)[None]
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(bw // nw, nw, heads, n, n)
             + mask.to(acc)[None, :, None]).reshape(bw, heads, n, n)
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    return e / e.sum(dim=-1, keepdim=True)


def window_attention_fwd_reference(q, k, v, bias, mask=None) -> torch.Tensor:
    """Plain PyTorch forward in the kernel's rounding order: sums of IO-dtype
    products, softmax in f32, the probabilities rounded to the IO dtype
    before ``p v``, the output rounded."""
    heads, dt = bias.shape[0], q.dtype
    qh, kh, vh = (to_heads(t, heads) for t in (q, k, v))
    p = _probs(qh, kh, bias, mask).to(dt).to(_acc(dt))
    return from_heads(torch.einsum("bhnm,bhmd->bhnd", p,
                                   vh.to(_acc(dt))).to(dt))


def window_attention_bwd_reference(q, k, v, bias, mask, g):
    """Plain PyTorch backward in the kernel's rounding order (JAX's
    ``_bwd_body``): P recomputed and kept in f32; ``dv = Pd^T g`` with Pd
    rounded to the IO dtype; ``dp = g v^T``; ``ds = P (dp - rowsum(dp P))``;
    ``dq = dsd k``, ``dk = dsd^T q`` with dsd rounded; dq, dk, dv in the IO
    dtype, ``dbias`` the sum of the unrounded ds over windows in the sum
    type (f32, or f64 for f64 inputs)."""
    heads, dt = bias.shape[0], q.dtype
    acc = _acc(dt)
    qh, kh, vh, gh = (to_heads(t, heads).to(acc) for t in (q, k, v, g))
    p = _probs(qh, kh, bias, mask)
    pd = p.to(dt).to(acc)
    dv = torch.einsum("bhnm,bhnd->bhmd", pd, gh)
    dp = torch.einsum("bhnd,bhmd->bhnm", gh, vh)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dsd = ds.to(dt).to(acc)
    dq = torch.einsum("bhnm,bhmd->bhnd", dsd, kh)
    dk = torch.einsum("bhnm,bhnd->bhmd", dsd, qh)
    return (from_heads(dq).to(dt), from_heads(dk).to(dt),
            from_heads(dv).to(dt), ds.sum(dim=0))


def bwd_tolerance(dtype: torch.dtype) -> Tuple[Tuple[float, float],
                                                Tuple[float, float]]:
    """``((atol, rtol) of dq, dk, dv; (atol, rtol) of dbias)`` of the
    backward kernel against its plain version on the same inputs; atol is a
    fraction of the output's largest value.

    f32: the two sum the 32 and 49 terms of each product and the rows of
    ``dp P`` in other orders and take ``exp`` from other libraries, a few
    ulps of f32 through ``ds``, whose terms cancel in the row sum, and dbias
    adds up to 3312 windows of it in another order: 1e-5 for dq, dk, dv and
    1e-4 of the largest dbias. bf16: products of bf16 values are exact in f32
    on both sides; a probability or an element of ds within rounding of a
    bf16 boundary rounds the other way on one side, moving one of 49 terms
    by a bf16 ulp of itself, and the output's own rounding can then land on
    the neighbouring bf16 value: 2^-8 of the largest value and 2^-7
    relative, as the forward (the bf16 kernel sums on the tensor cores,
    whose f32 sums are not rounded to nearest, in chains of at most four
    k16 steps: a few ulps of f32, far inside it); dbias is summed from the
    unrounded f32 ds on both sides and keeps the f32 bound."""
    if dtype == torch.bfloat16:
        return (2.0 ** -8, 2.0 ** -7), (1e-4, 1e-4)
    return (1e-5, 1e-5), (1e-4, 1e-4)


#: ctypes signature of each C entry of ``csrc/window_attn_train.cu``
ARGTYPES = {
    "window_attn_train_fwd": (_VP,) * 3 + (_I64,) * 3 + (_VP,) * 3
                             + (_I32,) * 6 + (_VP,),
    "window_attn_train_bwd": (_VP,) * 3 + (_I64,) * 3 + (_VP,) * 8
                             + (_I32,) * 7 + (_VP,),
}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("window_attn_train")
    for fn, types in ARGTYPES.items():
        getattr(lib, fn).argtypes = list(types)
        getattr(lib, fn).restype = _I32
    return lib


def bwd_chunk(bw: int, heads: int) -> int:
    """Windows a backward block walks: about :data:`BWD_BLOCKS` blocks a
    call, whatever the shape (a function of the shape alone, so the dbias
    partial sums add up in the same order on every run)."""
    want = max(1, -(-BWD_BLOCKS // heads))
    return -(-bw // min(bw, want))


def window_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[BW, N, C]`` attention output in q's dtype. CPU tensors run
    :func:`window_attention_fwd_reference`; CUDA tensors launch the
    ``window_attn_train_fwd`` kernel (counted in
    ``window_attention_fwd.launches``)."""
    _wai._check(q, k, v, bias, mask)
    if q.device.type == "cpu":
        return window_attention_fwd_reference(q, k, v, bias, mask)
    out = _wai.launch_forward(_lib, "window_attn_train_fwd", q, k, v, bias,
                              mask)
    window_attention_fwd.launches += 1
    return out


window_attention_fwd.launches = 0


def window_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor, mask: Optional[torch.Tensor],
                         g: torch.Tensor):
    """``(dq, dk, dv, dbias)``: ``[BW, N, C]`` in q's dtype and
    ``[heads, N, N]`` float32. CPU tensors run
    :func:`window_attention_bwd_reference`; CUDA tensors launch the
    ``window_attn_train_bwd`` kernels (counted in
    ``window_attention_bwd.launches``)."""
    _wai._check(q, k, v, bias, mask)
    if g.shape != q.shape:
        raise ValueError(f"g {tuple(g.shape)} does not fit q {tuple(q.shape)}")
    if q.device.type == "cpu":
        return window_attention_bwd_reference(q, k, v, bias, mask, g)
    if q.device.type != "cuda":
        raise ValueError(f"no window_attn_train_bwd kernel for {q.device}")
    g = g.contiguous()
    lds = _wai.check_cuda("window_attn_train_bwd", q, k, v, bias, mask,
                           (g,))
    bw, n, c = q.shape
    heads = bias.shape[0]
    chunk = bwd_chunk(bw, heads)
    chunks = -(-bw // chunk)
    dq, dk, dv = (torch.empty((bw, n, c), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    dbias = torch.empty((heads, n, n), dtype=torch.float32, device=q.device)
    partial = torch.empty((chunks, heads, n, n), dtype=torch.float32,
                          device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _lib().window_attn_train_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *lds, g.data_ptr(),
            bias.data_ptr(), None if mask is None else mask.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dbias.data_ptr(),
            partial.data_ptr(), bw, n, c, heads,
            0 if mask is None else mask.shape[0], chunk,
            int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"window_attn_train_bwd launch failed: CUDA error {rc}")
    window_attention_bwd.launches += 1
    return dq, dk, dv, dbias


window_attention_bwd.launches = 0


class WindowAttention(torch.autograd.Function):
    """The differentiable window attention: the forward and backward
    kernels (on CPU tensors their plain versions)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask):
        ctx.save_for_backward(q, k, v, bias)
        ctx.mask = mask
        return window_attention_fwd(q, k, v, bias, mask)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv, dbias = window_attention_bwd(q, k, v, bias, ctx.mask, g)
        return dq, dk, dv, dbias.to(bias.dtype), None


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable channel-packed window attention (module doc): q, k, v
    ``[BW, N, C]`` (q pre-scaled), bias ``[heads, N, N]``, mask None or
    ``[nW, N, N]`` without gradient."""
    if mask is not None:
        mask = mask.detach()
    return WindowAttention.apply(q, k, v, bias, mask)
