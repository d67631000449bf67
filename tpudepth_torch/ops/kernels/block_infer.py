"""Whole SAM and NewCRF blocks for inference over raw padded windows:
LayerNorm and projections, window attention, and the block tail, one call
per block on window-major ``[BW, N, C]`` rows.

Counterpart of ``tpudepth/ops/pallas/block_infer.py::sam_block_infer`` and
``::crf_block_infer`` (``TPUDEPTH_BLOCK=fused`` in JAX). The kernels are
``tpudepth_torch/csrc/block_infer.cu``, CUDA C++ for ``sm_90a`` built by
``_build``: in bf16 both run their LayerNorm and projections and their
tail on the ``wgmma`` core (``csrc/tail_chain.cuh``, the tail the chain
that keeps ``y`` in f32) and the attention of ``window_attn_infer``
(``csrc/window_attn.cuh``); in f32 the LayerNorm and projections of
``csrc/ln_proj.cuh`` and the tail of ``csrc/block_tail.cuh`` on the CUDA
cores. The source's header says what bounds them, how they are laid out
and how many launches a call takes; :func:`crf_scratch_shapes` and
:func:`sam_scratch_shapes` give the scratch. The wrappers
:func:`sam_block_infer` and :func:`crf_block_infer` count their calls; the
plain versions :func:`sam_block_infer_reference` and
:func:`crf_block_infer_reference` have the kernels' rounding order, which is
the TPU kernels' and not the row kernels': ``y = x + o Wp + bp`` and ``z =
g W2 + b2`` stay f32 and the output is rounded once. CPU tensors run the plain version; CUDA tensors
launch the kernels or raise. The boundary keeps the JAX layout:

- ``xw``, ``vw``: ``[BW, N, C]`` RAW (not normalized) windows in one dtype
  (float32 or bfloat16), ``x`` the query (unary) stream and ``v`` the
  encoder stream (SAM) or the raw values (NewCRF); zero-padded to window
  multiples before the partition and, for a shifted NewCRF block, rolled by
  ``(-shift, -shift)``;
- ``valid``: None (the map has no pad) or the ``[nW, N]`` 1/0 table of
  real tokens (``ops/window.py::window_valid_mask``); windows are
  ``[B, nW]``-major, so window ``i`` takes row ``i % nW``; pad tokens are
  made zero after the LayerNorm, so their queries, keys and values are the
  projections' biases alone;
- ``mask`` (NewCRF): None or the ``[nW, N, N]`` float32 shift mask;
  ``bias`` ``[heads, N, N]`` float32;
- weights float32 ``[in, out]`` (the ``.t()`` view of a ``Linear`` weight),
  biases and LayerNorm ``(scale, bias)`` pairs float32;
- the output ``[BW, N, C]`` in x's dtype; its pad tokens hold garbage that
  the caller crops.

The kernels take windows of at most 64 tokens, heads of a width that is a
multiple of 8 up to 64, and C, H = 4C widths of ``block_epilogue_infer``
(SAM and NewCRF: 49 tokens, head width 32, C 128-1024).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from tpudepth_torch.ops.kernels import _build, _op
from tpudepth_torch.ops.kernels.epilogue_infer import (
    ffn_reference,
    layer_norm_f32,
    linear_f32,
)
from tpudepth_torch.ops.kernels.rowblock_infer import (
    alloc_scratch,
    check_weights,
    cuda_args,
)
from tpudepth_torch.ops.kernels.window_attn_infer import (
    window_attention_infer_reference,
)

_VP, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _ln_valid(t, ln, valid):
    """LN(t) in f32 times the valid table of t's windows, rounded to t's
    dtype."""
    tn = layer_norm_f32(t, *ln)
    if valid is not None:
        reps = t.shape[0] // valid.shape[0]
        tn = tn * valid.float().repeat(reps, 1)[..., None]
    return tn.to(t.dtype)


def _tail(xw, o, wproj, bproj, ln2, w1, b1, w2, b2):
    """``y = x + o Wp + bp`` and ``z = g W2 + b2`` in f32 (the TPU kernel's
    ``_ffn_residual``); LN2(y), h and gelu(h) rounded; ``y + z`` rounded
    once."""
    dt = xw.dtype
    y = xw.float() + linear_f32(o, wproj, bproj)
    z = ffn_reference(layer_norm_f32(y, *ln2).to(dt), w1, b1, w2, b2)
    return (y + z).to(dt)


def sam_block_infer_reference(xw, vw, ln1, lnv, wq, bq, wkv, bkv, bias,
                              wproj, bproj, ln2, w1, b1, w2, b2, valid=None,
                              *, scale: float):
    """Plain PyTorch version in the kernel's rounding order (the TPU
    kernel's ``_sam_kernel``): q from LN1(x), scaled in f32 and rounded
    once; k and v from LNv(v); o rounded; the tail of :func:`_tail`."""
    c = xw.shape[-1]
    dt = xw.dtype
    q = (linear_f32(_ln_valid(xw, ln1, valid), wq, bq) * scale).to(dt)
    kv = linear_f32(_ln_valid(vw, lnv, valid), wkv, bkv)
    o = window_attention_infer_reference(q, kv[..., :c].to(dt),
                                         kv[..., c:].to(dt), bias)
    return _tail(xw, o, wproj, bproj, ln2, w1, b1, w2, b2)


def crf_block_infer_reference(xw, vw, ln1, wqk, bqk, bias, wproj, bproj, ln2,
                              w1, b1, w2, b2, mask=None, valid=None, *,
                              scale: float):
    """Plain PyTorch version in the kernel's rounding order (the TPU
    kernel's ``_crf_kernel``): q and k from LN1(x), q scaled in f32 and
    rounded once; the raw values; o rounded; the tail of :func:`_tail`."""
    c = xw.shape[-1]
    dt = xw.dtype
    qk = linear_f32(_ln_valid(xw, ln1, valid), wqk, bqk)
    o = window_attention_infer_reference((qk[..., :c] * scale).to(dt),
                                         qk[..., c:].to(dt), vw.to(dt), bias,
                                         mask)
    return _tail(xw, o, wproj, bproj, ln2, w1, b1, w2, b2)


def tolerance(dtype: torch.dtype) -> Tuple[float, float]:
    """``(atol, rtol)`` of both kernels against their plain versions on the
    same inputs; atol is a fraction of the output's largest value.

    f32: the products are the same; sums of up to 4C terms run in other
    orders, and erf, exp, rsqrt come from other libraries: a few ulps of f32
    through the five products of a block, as the row kernels'. bf16: the
    row kernels' ``(2^-6, 2^-6)`` (``rowblock_infer.tolerance``). The
    roundings in front of the tail are theirs: a q, k (or SAM v) or
    probability within rounding of a bf16 boundary rounds the other way on
    one side, which moves an o value by at most 2^-8 of max|v| and then
    ``o Wp`` by less than an ulp of the output's largest value. The tail
    rounds a subset of what theirs rounds (LN2(y), h, gelu(h) and the
    output, not z, y and m): the output's own rounding of two f32 values
    that differ by their sums' orders lands on neighbouring bf16 values
    (2^-7 relative), and a flip of LN2(y), h or gelu(h) moves z by less
    than an ulp of the largest value."""
    if dtype == torch.bfloat16:
        return 2.0 ** -6, 2.0 ** -6
    return 1e-5, 1e-5


#: ctypes signature of each C entry of ``csrc/block_infer.cu``
ARGTYPES = {
    "crf_block_infer": (_VP,) * 20 + (_I32,) * 6 + (_F32, _I32, _VP),
    "sam_block_infer": (_VP,) * 23 + (_I32,) * 6 + (_F32, _I32, _VP),
}


def crf_scratch_shapes(bw: int, n: int, c: int, hidden: int,
                       bf16: bool) -> dict:
    """The scratch of one ``crf_block_infer`` call, by name: ``qk``
    ``[BW, N, 2C]`` in the IO dtype (q and k; in bf16 the tail chain then
    keeps its f32 y, ``4 M C`` bytes, M = BW N, in all of it, and its bf16
    yn in the output buffer) and, in bf16, ``g`` ``[M, hidden]`` for the
    tail's hidden (None in f32)."""
    return {"qk": (bw, n, 2 * c), "g": (bw * n, hidden) if bf16 else None}


def sam_scratch_shapes(bw: int, n: int, c: int, hidden: int,
                       bf16: bool) -> dict:
    """The scratch of one ``sam_block_infer`` call, by name: ``qkv``
    ``[BW, N, 3C]`` in the IO dtype (q, k and v; in bf16 the tail chain then
    keeps its f32 y, ``4 M C`` bytes, M = BW N, at its start and its bf16
    yn in the ``2 M C`` bytes after them) and, in bf16, ``g`` ``[M,
    hidden]`` for the tail's hidden (None in f32)."""
    return {"qkv": (bw, n, 3 * c), "g": (bw * n, hidden) if bf16 else None}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("block_infer")
    for fn, types in ARGTYPES.items():
        getattr(lib, fn).argtypes = list(types)
        getattr(lib, fn).restype = _I32
    return lib


def _check(name, xw, vw, bias, mask, valid, norms, projections, tail):
    """Shapes and dtypes of a call, on any device (the parameters by
    ``rowblock_infer.check_weights``). Returns (BW, N, C, heads, hidden,
    nW), nW the period of the mask and valid tables (1 without them)."""
    if xw.dtype not in (torch.float32, torch.bfloat16) or vw.dtype != xw.dtype:
        raise TypeError(f"{name}: xw and vw must be float32 or bfloat16 of "
                        f"one dtype, not {xw.dtype}, {vw.dtype}")
    if xw.dim() != 3 or vw.shape != xw.shape:
        raise ValueError(f"{name}: xw and vw must be [BW, N, C] of one "
                         f"shape, not {tuple(xw.shape)}, {tuple(vw.shape)}")
    bw, n, c = xw.shape
    heads = bias.shape[0]
    if tuple(bias.shape) != (heads, n, n) or c % heads:
        raise ValueError(f"{name}: bias {tuple(bias.shape)} does not fit "
                         f"C={c} and {n} tokens a window")
    nw = mask.shape[0] if mask is not None else (
        valid.shape[0] if valid is not None else 1)
    if mask is not None and tuple(mask.shape) != (nw, n, n):
        raise ValueError(f"{name}: mask {tuple(mask.shape)} is not "
                         f"[nW, {n}, {n}]")
    if valid is not None and tuple(valid.shape) != (nw, n):
        raise ValueError(f"{name}: valid {tuple(valid.shape)} is not "
                         f"[{nw}, {n}] (the mask's windows and tokens)")
    if nw < 1 or bw % nw:
        raise ValueError(f"{name}: {bw} windows are not a multiple of the "
                         f"{nw} windows of an image")
    hidden = check_weights(name, c, norms, projections, tail,
                           (bias, mask, valid))
    return bw, n, c, heads, hidden, nw


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(name, xw, vw, bias, mask, valid, weights, vectors, scratch,
            call):
    """Checks of a launch, the scratch (``scratch``: shapes by name) and
    output buffers, and ``call(lib, weights in the kernel's layout, scratch
    tensors by name, out, stream)``; raises on a CUDA error."""
    if valid is not None and (valid.device != xw.device
                              or not valid.is_contiguous()):
        raise ValueError(f"{name}: valid must be contiguous on {xw.device}")
    kernel_weights = cuda_args(name, xw, vw, bias, mask, xw.shape[1], weights,
                               vectors)
    scratch = alloc_scratch(scratch, xw.dtype, xw.device)
    out = torch.empty_like(xw)
    with torch.cuda.device(xw.device):
        stream = torch.cuda.current_stream(xw.device).cuda_stream
        rc = call(_lib(), kernel_weights, scratch, out, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    return out


def sam_block_infer(xw: torch.Tensor, vw: torch.Tensor, ln1: tuple,
                    lnv: tuple, wq: torch.Tensor, bq: torch.Tensor,
                    wkv: torch.Tensor, bkv: torch.Tensor, bias: torch.Tensor,
                    wproj: torch.Tensor, bproj: torch.Tensor, ln2: tuple,
                    w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                    b2: torch.Tensor, valid: Optional[torch.Tensor] = None, *,
                    scale: float) -> torch.Tensor:
    """The SAM block, ``[BW, N, C]`` in x's dtype. CPU tensors run
    :func:`sam_block_infer_reference`; CUDA tensors launch the
    ``sam_block_infer`` kernels (one call counted in
    ``sam_block_infer.launches``); through :data:`SAM_OP` only while
    ``torch.export`` traces."""
    c = xw.shape[-1]
    _check(
        "sam_block_infer", xw, vw, bias, None, valid, [ln1, lnv],
        [(wq, bq, c), (wkv, bkv, 2 * c)], (wproj, bproj, ln2, w1, b1, w2, b2))
    _op.check_device("sam_block_infer", xw)
    args = (xw, vw, *ln1, *lnv, wq, bq, wkv, bkv, bias, wproj, bproj, *ln2,
            w1, b1, w2, b2, valid, float(scale))
    return SAM_OP(*args) if _op.through_op() else _sam_run(*args)


def _sam_run(xw, vw, ln1_w, ln1_b, lnv_w, lnv_b, wq, bq, wkv, bkv, bias,
             wproj, bproj, ln2_w, ln2_b, w1, b1, w2, b2, valid, scale):
    """The kernel of a ``sam_block_infer`` call on xw's device, its
    LayerNorm pairs flattened: the plain version on the CPU, the launch on
    the card (counted)."""
    ln1, lnv, ln2 = (ln1_w, ln1_b), (lnv_w, lnv_b), (ln2_w, ln2_b)
    bw, n, c = xw.shape
    heads, hidden = bias.shape[0], w1.shape[1]
    nw = valid.shape[0] if valid is not None else 1
    if xw.device.type == "cpu":
        return sam_block_infer_reference(
            xw, vw, ln1, lnv, wq, bq, wkv, bkv, bias, wproj, bproj, ln2, w1,
            b1, w2, b2, valid, scale=scale).contiguous()

    bf16 = xw.dtype == torch.bfloat16

    def call(lib, wts, scratch, out, stream):
        wq_t, wkv_t, wp_t, w1_t, w2_t = wts
        return lib.sam_block_infer(
            xw.data_ptr(), vw.data_ptr(), ln1[0].data_ptr(),
            ln1[1].data_ptr(), lnv[0].data_ptr(), lnv[1].data_ptr(),
            wq_t.data_ptr(), bq.data_ptr(), wkv_t.data_ptr(), bkv.data_ptr(),
            bias.data_ptr(), wp_t.data_ptr(), bproj.data_ptr(),
            ln2[0].data_ptr(), ln2[1].data_ptr(), w1_t.data_ptr(),
            b1.data_ptr(), w2_t.data_ptr(), b2.data_ptr(), _ptr(valid),
            scratch["qkv"].data_ptr(), _ptr(scratch["g"]), out.data_ptr(), bw,
            n, c, heads, hidden, nw, float(scale), int(bf16), stream)

    out = _launch("sam_block_infer", xw, vw, bias, None, valid,
                  (wq, wkv, wproj, w1, w2),
                  (*ln1, *lnv, bq, bkv, bproj, *ln2, b1, b2),
                  sam_scratch_shapes(bw, n, c, hidden, bf16), call)
    sam_block_infer.launches += 1
    return out


sam_block_infer.launches = 0

#: ``tpudepth::sam_block_infer``
SAM_OP = _op.define(
    "sam_block_infer",
    "(Tensor xw, Tensor vw, Tensor ln1_w, Tensor ln1_b, Tensor lnv_w, "
    "Tensor lnv_b, Tensor wq, Tensor bq, Tensor wkv, Tensor bkv, Tensor bias, "
    "Tensor wproj, Tensor bproj, Tensor ln2_w, Tensor ln2_b, Tensor w1, "
    "Tensor b1, Tensor w2, Tensor b2, Tensor? valid, float scale) -> Tensor",
    _sam_run, _sam_run, lambda xw, *rest: xw.new_empty(xw.shape))


def crf_block_infer(xw: torch.Tensor, vw: torch.Tensor, ln1: tuple,
                    wqk: torch.Tensor, bqk: torch.Tensor, bias: torch.Tensor,
                    wproj: torch.Tensor, bproj: torch.Tensor, ln2: tuple,
                    w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                    b2: torch.Tensor, mask: Optional[torch.Tensor] = None,
                    valid: Optional[torch.Tensor] = None, *,
                    scale: float) -> torch.Tensor:
    """The NewCRF block, ``[BW, N, C]`` in x's dtype. CPU tensors run
    :func:`crf_block_infer_reference`; CUDA tensors launch the
    ``crf_block_infer`` kernels (one call counted in
    ``crf_block_infer.launches``); through :data:`CRF_OP` only while
    ``torch.export`` traces."""
    _check(
        "crf_block_infer", xw, vw, bias, mask, valid, [ln1],
        [(wqk, bqk, 2 * xw.shape[-1])], (wproj, bproj, ln2, w1, b1, w2, b2))
    _op.check_device("crf_block_infer", xw)
    args = (xw, vw, *ln1, wqk, bqk, bias, wproj, bproj, *ln2, w1, b1, w2, b2,
            mask, valid, float(scale))
    return CRF_OP(*args) if _op.through_op() else _crf_run(*args)


def _crf_run(xw, vw, ln1_w, ln1_b, wqk, bqk, bias, wproj, bproj, ln2_w, ln2_b,
             w1, b1, w2, b2, mask, valid, scale):
    """The kernel of a ``crf_block_infer`` call on xw's device, its
    LayerNorm pairs flattened: the plain version on the CPU, the launch on
    the card (counted)."""
    ln1, ln2 = (ln1_w, ln1_b), (ln2_w, ln2_b)
    bw, n, c = xw.shape
    heads, hidden = bias.shape[0], w1.shape[1]
    nw = mask.shape[0] if mask is not None else (
        valid.shape[0] if valid is not None else 1)
    if xw.device.type == "cpu":
        return crf_block_infer_reference(
            xw, vw, ln1, wqk, bqk, bias, wproj, bproj, ln2, w1, b1, w2, b2,
            mask, valid, scale=scale).contiguous()

    bf16 = xw.dtype == torch.bfloat16

    def call(lib, wts, scratch, out, stream):
        wqk_t, wp_t, w1_t, w2_t = wts
        return lib.crf_block_infer(
            xw.data_ptr(), vw.data_ptr(), ln1[0].data_ptr(),
            ln1[1].data_ptr(), wqk_t.data_ptr(), bqk.data_ptr(),
            bias.data_ptr(), _ptr(mask), wp_t.data_ptr(), bproj.data_ptr(),
            ln2[0].data_ptr(), ln2[1].data_ptr(), w1_t.data_ptr(),
            b1.data_ptr(), w2_t.data_ptr(), b2.data_ptr(), _ptr(valid),
            scratch["qk"].data_ptr(), _ptr(scratch["g"]), out.data_ptr(), bw,
            n, c, heads, hidden, nw, float(scale), int(bf16), stream)

    out = _launch("crf_block_infer", xw, vw, bias, mask, valid,
                  (wqk, wproj, w1, w2), (*ln1, bqk, bproj, *ln2, b1, b2),
                  crf_scratch_shapes(bw, n, c, hidden, bf16), call)
    crf_block_infer.launches += 1
    return out


crf_block_infer.launches = 0

#: ``tpudepth::crf_block_infer``
CRF_OP = _op.define(
    "crf_block_infer",
    "(Tensor xw, Tensor vw, Tensor ln1_w, Tensor ln1_b, Tensor wqk, "
    "Tensor bqk, Tensor bias, Tensor wproj, Tensor bproj, Tensor ln2_w, "
    "Tensor ln2_b, Tensor w1, Tensor b1, Tensor w2, Tensor b2, Tensor? mask, "
    "Tensor? valid, float scale) -> Tensor",
    _crf_run, _crf_run, lambda xw, *rest: xw.new_empty(xw.shape))
