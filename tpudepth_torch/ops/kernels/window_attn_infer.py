"""Channel-packed window attention for inference:
``out[w, :, h] = softmax(q_h k_h^T + bias[h] [+ mask[w % nW]]) v_h``.

Counterpart of ``tpudepth/ops/pallas/window_attn_infer.py::
window_attention_infer``. The kernel is ``tpudepth_torch/csrc/
window_attn_infer.cu`` (``window_attn_infer``), CUDA C++ for ``sm_90a`` built
by ``_build``; its header says what bounds it and how it is laid out. The
wrapper :func:`window_attention_infer` counts its launches; the plain
version :func:`window_attention_infer_reference` has the kernel's rounding
order. CPU tensors run the plain version; CUDA tensors launch the kernel or
raise. The boundary keeps the JAX layout:

- ``q``, ``k``, ``v``: ``[BW, N, C]``, C = heads * head_dim, q pre-scaled;
  on the card each needs contiguous channels and token rows a fixed stride
  apart (``k`` and ``v`` may be the two halves of one ``[BW, N, 2C]``);
- ``bias``: ``[heads, N, N]`` float32;
- ``mask``: None or ``[nW, N, N]`` float32, BW a multiple of nW, windows
  ``[B, nW]``-major.

The kernel takes N <= 64 and a head_dim that is a multiple of 8 up to 64
(SAM and NewCRF: N = 49, head_dim 32), float32 or bfloat16.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from tpudepth_torch.ops.attention import (
    from_heads,
    to_heads,
    window_cross_attention_fast,
)
from tpudepth_torch.ops.kernels import _build

_VP, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def window_attention_infer_reference(q, k, v, bias, mask=None):
    """Plain PyTorch version in the kernel's rounding order: f32 scores of
    IO-dtype products, f32 softmax, probabilities rounded to the IO dtype,
    ``p v`` summed in f32, the output rounded."""
    heads = bias.shape[0]
    return from_heads(window_cross_attention_fast(
        to_heads(q, heads), to_heads(k, heads), to_heads(v, heads), bias,
        mask))


def tolerance(dtype: torch.dtype) -> Tuple[float, float]:
    """``(atol, rtol)`` of the kernel against the plain version on the same
    inputs; atol is a fraction of ``max|v|``, the largest an output can be.

    f32: the two sum the 32 products of a score and the 49 of an output in
    other orders and take ``exp`` from other libraries, a few ulps of f32.
    bf16: a probability within rounding of a bf16 boundary rounds the other
    way on one side, moving the output by one bf16 ulp of that probability
    times a value (at most 2^-8 of max|v| in all), and the output's own
    rounding can then land on the neighbouring bf16 value (2^-7 relative)."""
    if dtype == torch.bfloat16:
        return 2.0 ** -8, 2.0 ** -7
    return 1e-5, 1e-5


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("window_attn_infer")
    lib.window_attn_infer.argtypes = (
        [_VP] * 3 + [_I64] * 3 + [_VP] * 3 + [_I32] * 6 + [_VP])
    lib.window_attn_infer.restype = _I32
    return lib


def _row_stride(t: torch.Tensor, n: int) -> int:
    """Element stride of a token row of ``t`` [BW, N, C], or raise."""
    ld = t.stride(1)
    if t.stride(2) != 1 or (t.shape[0] > 1 and t.stride(0) != n * ld):
        raise ValueError("q, k, v need contiguous channels and token rows a "
                         f"fixed stride apart, got strides {t.stride()}")
    return ld


def _check(q, k, v, bias, mask):
    bw, n, c = q.shape
    heads = bias.shape[0]
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)} differ")
    if tuple(bias.shape) != (heads, n, n) or c % heads:
        raise ValueError(f"bias {tuple(bias.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    if mask is not None and (tuple(mask.shape[1:]) != (n, n)
                             or bw % mask.shape[0]):
        raise ValueError(f"mask {tuple(mask.shape)} does not fit {bw} windows "
                         f"of {n} tokens")


def check_cuda(name, q, k, v, bias, mask, extra=()):
    """Device, dtype and shape checks of a launch of ``name`` on q, k, v
    (and the ``extra`` row tensors of the same shape, e.g. a cotangent);
    returns the row strides of q, k, v."""
    bw, n, c = q.shape
    heads = bias.shape[0]
    dt = q.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes float32 or bfloat16, not {dt}")
    if any(t.dtype != dt for t in (k, v) + tuple(extra)):
        raise TypeError(f"{name}: q, k, v{', g' if extra else ''} must "
                        "share one dtype")
    if n > 64 or (c // heads) % 8 or c // heads > 64:
        raise ValueError(f"{name} takes N <= 64 and a head_dim that is a "
                         f"multiple of 8 up to 64, not N={n}, "
                         f"head_dim={c // heads}")
    for t in (k, v, bias) + tuple(extra) + ((mask,) if mask is not None else ()):
        if t.device != q.device:
            raise ValueError(f"tensor on {t.device}, expected {q.device}")
    for label, t in (("bias", bias), ("mask", mask)):
        if t is not None and (t.dtype != torch.float32 or not t.is_contiguous()):
            raise TypeError(f"{label} must be contiguous float32")
    return [_row_stride(t, n) for t in (q, k, v)]


def launch_forward(lib, name, q, k, v, bias, mask) -> torch.Tensor:
    """Launch the C entry ``name`` of ``lib()``, a forward of the
    ``window_attn.cuh`` device code (``window_attn_infer`` here,
    ``window_attn_train_fwd`` in ``window_attn.py``: one C signature), on
    CUDA tensors and return its ``[BW, N, C]`` output in q's dtype; raises
    on a refused input or a failed launch. The caller counts the launch."""
    if q.device.type != "cuda":
        raise ValueError(f"no {name} kernel for {q.device}")
    lds = check_cuda(name, q, k, v, bias, mask)
    bw, n, c = q.shape
    heads = bias.shape[0]
    out = torch.empty((bw, n, c), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib(), name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *lds, bias.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            bw, n, c, heads, 0 if mask is None else mask.shape[0],
            int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    return out


def window_attention_infer(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor,
                           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[BW, N, C]`` attention output in q's dtype. CPU tensors run
    :func:`window_attention_infer_reference`; CUDA tensors launch the
    ``window_attn_infer`` kernel (counted in
    ``window_attention_infer.launches``)."""
    _check(q, k, v, bias, mask)
    if q.device.type == "cpu":
        return window_attention_infer_reference(q, k, v, bias, mask)
    out = launch_forward(_lib, "window_attn_infer", q, k, v, bias, mask)
    window_attention_infer.launches += 1
    return out


window_attention_infer.launches = 0
