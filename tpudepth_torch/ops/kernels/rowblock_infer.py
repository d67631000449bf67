"""Whole NewCRF and SAM blocks for inference over the image layout:
LayerNorm and projections, window attention, and the block tail, with the
windows read straight out of ``[B, Hp, Wp, C]`` (no partition or reverse
copy).

Counterpart of ``tpudepth/ops/pallas/rowblock_infer.py::crf_rowblock_infer``
and ``::sam_rowblock_infer``. The kernels are ``tpudepth_torch/csrc/
rowblock_infer.cu``, CUDA C++ for ``sm_90a`` built by ``_build``, on the
device code of ``window_attn_infer`` (``csrc/window_attn.cuh``) and of
``block_epilogue_infer`` (``csrc/block_tail.cuh``; in bf16 their
projections and tails run on the ``wgmma`` core, ``csrc/tail_chain.cuh``);
the source's header says what bounds them, how they are laid out and how
many launches and scratch bytes a call takes (:func:`crf_scratch_shapes`,
:func:`sam_scratch_shapes`). The wrappers :func:`crf_rowblock_infer` and
:func:`sam_rowblock_infer` count their calls; the plain versions
:func:`crf_rowblock_infer_reference` and :func:`sam_rowblock_infer_reference`
have the kernels' rounding order. CPU tensors run the plain version; CUDA
tensors launch the kernels or raise. The boundary keeps the JAX layout:

- ``x``, ``v``: ``[B, Hp, Wp, C]`` RAW (not normalized) in one dtype
  (float32 or bfloat16), zero-padded at the bottom and right to multiples of
  the window and, for a shifted NewCRF block, already rolled by
  ``(-shift, -shift)``;
- ``valid_hw``: the real extent ``(h, w, shift)`` (NewCRF) or ``(h, w)``
  (SAM) of the map, default the whole map; pad tokens are made zero after
  the LayerNorm, so their queries, keys and values are the biases alone;
- ``mask``: None or the ``[nW, N, N]`` float32 shift mask, windows
  row-major; ``bias`` ``[heads, N, N]`` float32;
- weights float32 ``[in, out]`` (the ``.t()`` view of a ``Linear`` weight),
  biases and LayerNorm ``(scale, bias)`` pairs float32;
- the output ``[B, Hp, Wp, C]`` in x's dtype; its pad positions hold garbage
  that the caller crops.

The kernels take windows of at most 64 tokens, heads of a width that is a
multiple of 8 up to 64, and C, H = 4C widths of ``block_epilogue_infer``
(SAM and NewCRF: window 7, head width 32, C 128-1024).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from tpudepth_torch.ops.kernels import _build, _op
from tpudepth_torch.ops.kernels import epilogue_infer as _epi
from tpudepth_torch.ops.kernels.epilogue_infer import (
    block_epilogue_infer_reference,
    layer_norm_f32,
    linear_f32,
)
from tpudepth_torch.ops.kernels.window_attn_infer import (
    window_attention_infer_reference,
)
from tpudepth_torch.ops.window import window_partition, window_reverse

_VP, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _valid_image(h: int, w: int, hp: int, wp: int, shift: int) -> np.ndarray:
    """[Hp, Wp] 1/0 validity map of real (non-pad) pixels, post-roll."""
    v = np.zeros((hp, wp), np.float32)
    v[:h, :w] = 1.0
    if shift:
        v = np.roll(v, (-shift, -shift), axis=(0, 1))
    return v


@functools.lru_cache(maxsize=None)
def _valid_on(h: int, w: int, hp: int, wp: int, shift: int,
              device: torch.device) -> torch.Tensor:
    """:func:`_valid_image` as ``[Hp, Wp, 1]`` on ``device``, made once per
    shape (so that a captured CUDA graph of the plain version copies
    nothing from the host)."""
    return torch.from_numpy(_valid_image(h, w, hp, wp, shift)).to(
        device)[:, :, None]


def _valid(x: torch.Tensor, h: int, w: int, shift: int) -> torch.Tensor:
    _, hp, wp, _ = x.shape
    return _valid_on(h, w, hp, wp, shift, x.device)


def _attend_and_tail(x, q, k, v, bias, mask, wproj, bproj, ln2, w1, b1, w2,
                     b2, ws):
    """Window attention of the image-layout q, k, v (o rounded), then the
    block tail over the flat rows of o and x."""
    b, hp, wp, c = x.shape
    n = ws * ws
    o = window_attention_infer_reference(
        *(window_partition(t, ws).reshape(-1, n, c) for t in (q, k, v)),
        bias, mask)
    o = window_reverse(o.reshape(-1, ws, ws, c), ws, hp, wp)
    out = block_epilogue_infer_reference(
        o.reshape(-1, c), x.reshape(-1, c), wproj, bproj, ln2[0], ln2[1], w1,
        b1, w2, b2)
    return out.reshape(b, hp, wp, c)


def crf_rowblock_infer_reference(x, v, ln1, wqk, bqk, bias, wproj, bproj, ln2,
                                 w1, b1, w2, b2, mask=None, *, scale: float,
                                 window_size: int = 7,
                                 valid_hw: Optional[tuple] = None):
    """Plain PyTorch version in the kernel's rounding order (the TPU
    kernel's ``_crf_kernel``): ``q`` is scaled in f32 and rounded once."""
    _, hp, wp, c = x.shape
    dt = x.dtype
    h, w, shift = valid_hw if valid_hw is not None else (hp, wp, 0)
    xn = (layer_norm_f32(x, *ln1) * _valid(x, h, w, shift)).to(dt)
    qk = linear_f32(xn, wqk, bqk)
    q = (qk[..., :c] * scale).to(dt)
    k = qk[..., c:].to(dt)
    return _attend_and_tail(x, q, k, v.to(dt), bias, mask, wproj, bproj, ln2,
                            w1, b1, w2, b2, window_size)


def sam_rowblock_infer_reference(x, v, ln1, lnv, wq, bq, wkv, bkv, bias,
                                 wproj, bproj, ln2, w1, b1, w2, b2, *,
                                 scale: float, window_size: int = 7,
                                 valid_hw: Optional[tuple] = None):
    """Plain PyTorch version in the kernel's rounding order (the TPU
    kernel's ``_sam_kernel``): q from LN1(x), k and v from LNv(v)."""
    _, hp, wp, c = x.shape
    dt = x.dtype
    h, w = valid_hw if valid_hw is not None else (hp, wp)
    valid = _valid(x, h, w, 0)
    xn = (layer_norm_f32(x, *ln1) * valid).to(dt)
    vn = (layer_norm_f32(v, *lnv) * valid).to(dt)
    q = (linear_f32(xn, wq, bq) * scale).to(dt)
    kv = linear_f32(vn, wkv, bkv)
    return _attend_and_tail(x, q, kv[..., :c].to(dt), kv[..., c:].to(dt),
                            bias, None, wproj, bproj, ln2, w1, b1, w2, b2,
                            window_size)


def tolerance(dtype: torch.dtype) -> Tuple[float, float]:
    """``(atol, rtol)`` of both kernels against their plain versions on the
    same inputs; atol is a fraction of the output's largest value.

    f32: the products are the same; sums of up to 4C terms run in other
    orders, and erf, exp, rsqrt come from other libraries: a few ulps of f32
    through the five products of a block, as ``block_epilogue_infer``'s.
    bf16: the tail's own ``(2^-7, 2^-6)`` (``epilogue_infer.tolerance``),
    plus one more ulp of the output's largest value for the roundings in
    front of it: a q, k (or SAM v) or probability within rounding of a bf16
    boundary rounds the other way on one side, which moves an o value by
    at most 2^-8 of max|v| and then z = o Wp by less than an ulp of y."""
    if dtype == torch.bfloat16:
        return 2.0 ** -6, 2.0 ** -6
    return 1e-5, 1e-5


#: ctypes signature of each C entry of ``csrc/rowblock_infer.cu``
ARGTYPES = {
    "crf_rowblock_infer": (_VP,) * 19 + (_I32,) * 10 + (_F32, _I32, _VP),
    "sam_rowblock_infer": (_VP,) * 22 + (_I32,) * 9 + (_F32, _I32, _VP),
}


def crf_scratch_shapes(b: int, hp: int, wp: int, c: int, hidden: int,
                       bf16: bool) -> dict:
    """The scratch of one ``crf_rowblock_infer`` call, by name: ``qk``
    ``[B, Hp, Wp, 2C]`` in the IO dtype (q and k; in bf16 the tail chain's
    y and yn then take its ``2 M C`` elements, M = B Hp Wp) and, in bf16,
    ``g`` ``[M, hidden]`` for the tail's hidden (None in f32)."""
    return {"qk": (b, hp, wp, 2 * c),
            "g": (b * hp * wp, hidden) if bf16 else None}


def sam_scratch_shapes(b: int, hp: int, wp: int, c: int, hidden: int,
                       bf16: bool) -> dict:
    """The scratch of one ``sam_rowblock_infer`` call, by name: ``qkv``
    ``[B, Hp, Wp, 3C]`` in the IO dtype (q, k and v; in bf16 the tail
    chain's y and yn then take its first ``2 M C`` elements, M = B Hp Wp)
    and, in bf16, ``g`` ``[M, hidden]`` for the tail's hidden (None in
    f32)."""
    return {"qkv": (b, hp, wp, 3 * c),
            "g": (b * hp * wp, hidden) if bf16 else None}


def alloc_scratch(shapes: dict, dtype: torch.dtype,
                  device: torch.device) -> dict:
    """The tensors of a call's scratch ``shapes`` (here and in
    ``block_infer``), by name: ``g`` in bf16, the others in the IO dtype
    ``dtype``; a shape of None stays None."""
    return {k: None if shape is None else torch.empty(
        shape, dtype=torch.bfloat16 if k == "g" else dtype, device=device)
        for k, shape in shapes.items()}


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("rowblock_infer")
    for fn, types in ARGTYPES.items():
        getattr(lib, fn).argtypes = list(types)
        getattr(lib, fn).restype = _I32
    return lib


def _check(name, x, v, bias, mask, window_size, norms, projections, tail):
    """Shapes and dtypes of a call, on any device: ``norms`` the LayerNorm
    pairs in front of the projections, ``projections`` (weight, bias,
    output width) triples, ``tail`` the block tail's arguments. Returns
    (B, Hp, Wp, C, heads, hidden)."""
    if x.dtype not in (torch.float32, torch.bfloat16) or v.dtype != x.dtype:
        raise TypeError(f"{name}: x and v must be float32 or bfloat16 of one "
                        f"dtype, not {x.dtype}, {v.dtype}")
    if x.dim() != 4 or v.shape != x.shape:
        raise ValueError(f"{name}: x and v must be [B, Hp, Wp, C] of one "
                         f"shape, not {tuple(x.shape)}, {tuple(v.shape)}")
    b, hp, wp, c = x.shape
    ws = window_size
    n = ws * ws
    heads = bias.shape[0]
    if hp % ws or wp % ws:
        raise ValueError(f"{name}: the map {hp}x{wp} is not padded to "
                         f"multiples of the window {ws}")
    if tuple(bias.shape) != (heads, n, n) or c % heads:
        raise ValueError(f"{name}: bias {tuple(bias.shape)} does not fit "
                         f"C={c} and {n} tokens a window")
    if mask is not None and tuple(mask.shape) != ((hp // ws) * (wp // ws), n, n):
        raise ValueError(f"{name}: mask {tuple(mask.shape)} does not fit the "
                         f"{(hp // ws) * (wp // ws)} windows of the map")
    hidden = check_weights(name, c, norms, projections, tail, (bias, mask))
    return b, hp, wp, c, heads, hidden


def check_weights(name, c, norms, projections, tail, tables):
    """Shapes and dtypes of a whole-block call's parameters (here and in
    ``block_infer``): ``norms`` the LayerNorm pairs in front of the
    projections, ``projections`` (weight, bias, output width) triples,
    ``tail`` the block tail's arguments, ``tables`` the bias, mask (and
    valid) tensors or None. Returns the hidden width."""
    wproj, bproj, ln2, w1, b1, w2, b2 = tail
    hidden = w1.shape[1]
    pairs = [(wproj, (c, c)), (w1, (c, hidden)), (w2, (hidden, c)),
             (b1, (hidden,))] + [(t, (c,)) for t in (bproj, b2, *ln2)]
    pairs += [(t, (c,)) for ln in norms for t in ln]
    for w, bvec, cout in projections:
        pairs += [(w, (c, cout)), (bvec, (cout,))]
    if any(tuple(t.shape) != shape for t, shape in pairs):
        raise ValueError(f"{name}: weight shapes do not fit C={c}, "
                         f"H={hidden}")
    if any(t.dtype != torch.float32 for t, _ in pairs) or any(
            t is not None and t.dtype != torch.float32 for t in tables):
        raise TypeError(f"{name}: weights, vectors and tables (bias, mask, "
                        "valid) must be float32")
    return hidden


def cuda_args(name, x, v, bias, mask, tokens, weights, vectors):
    """Device, dtype and width checks of a launch of a whole-block kernel
    (here and in ``block_infer``) with windows of ``tokens`` tokens; returns
    the weights in the kernel's layout ([out, in] contiguous in the IO
    dtype)."""
    if x.device.type != "cuda":
        raise ValueError(f"no {name} kernel for {x.device}")
    c = x.shape[-1]
    heads = bias.shape[0]
    hidden = weights[-2].shape[1]
    if not (_epi.width_ok(c, out=True) and _epi.width_ok(hidden)):
        raise ValueError(f"{name} takes widths that are multiples of 32, at "
                         f"most 128 or multiples of 128, and C <= 1024, not "
                         f"C={c}, H={hidden}")
    if (tokens > 64 or (c // heads) % 8 or c // heads > 64):
        raise ValueError(f"{name} takes windows of at most 64 tokens and a "
                         f"head width that is a multiple of 8 up to 64, not "
                         f"{tokens} tokens, head width {c // heads}")
    for t, what in ((bias, "bias"), (mask, "mask")):
        if t is not None and (t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name}: {what} must be contiguous on "
                             f"{x.device}")
    return _epi.check_cuda(name, (x, v), weights, vectors)


def crf_rowblock_infer(x: torch.Tensor, v: torch.Tensor, ln1: tuple,
                       wqk: torch.Tensor, bqk: torch.Tensor,
                       bias: torch.Tensor, wproj: torch.Tensor,
                       bproj: torch.Tensor, ln2: tuple, w1: torch.Tensor,
                       b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                       mask: Optional[torch.Tensor] = None, *, scale: float,
                       window_size: int = 7,
                       valid_hw: Optional[tuple] = None) -> torch.Tensor:
    """The NewCRF block, ``[B, Hp, Wp, C]`` in x's dtype. CPU tensors run
    :func:`crf_rowblock_infer_reference`; CUDA tensors launch the
    ``crf_rowblock_infer`` kernels (one call counted in
    ``crf_rowblock_infer.launches``); through :data:`CRF_OP` only while
    ``torch.export`` traces."""
    _, hp, wp, _, _, _ = _check(
        "crf_rowblock_infer", x, v, bias, mask, window_size, [ln1],
        [(wqk, bqk, 2 * x.shape[-1])], (wproj, bproj, ln2, w1, b1, w2, b2))
    h, w, shift = valid_hw if valid_hw is not None else (hp, wp, 0)
    _op.check_device("crf_rowblock_infer", x)
    args = (x, v, *ln1, wqk, bqk, bias, wproj, bproj, *ln2, w1, b1, w2, b2,
            mask, float(scale), window_size, h, w, shift)
    return CRF_OP(*args) if _op.through_op() else _crf_run(*args)


def _crf_run(x, v, ln1_w, ln1_b, wqk, bqk, bias, wproj, bproj, ln2_w, ln2_b,
             w1, b1, w2, b2, mask, scale, window_size, h, w, shift):
    """The kernel of a ``crf_rowblock_infer`` call on x's device, its
    LayerNorm pairs flattened: the plain version on the CPU, the launch on
    the card (counted)."""
    ln1, ln2 = (ln1_w, ln1_b), (ln2_w, ln2_b)
    b, hp, wp, c = x.shape
    heads = bias.shape[0]
    hidden = w1.shape[1]
    if x.device.type == "cpu":
        return crf_rowblock_infer_reference(
            x, v, ln1, wqk, bqk, bias, wproj, bproj, ln2, w1, b1, w2, b2,
            mask, scale=scale, window_size=window_size,
            valid_hw=(h, w, shift)).contiguous()
    wqk_t, wp_t, w1_t, w2_t = cuda_args(
        "crf_rowblock_infer", x, v, bias, mask, window_size ** 2,
        (wqk, wproj, w1, w2), (*ln1, bqk, bproj, *ln2, b1, b2))
    bf16 = x.dtype == torch.bfloat16
    scratch = alloc_scratch(crf_scratch_shapes(b, hp, wp, c, hidden, bf16),
                            x.dtype, x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().crf_rowblock_infer(
            x.data_ptr(), v.data_ptr(), ln1[0].data_ptr(), ln1[1].data_ptr(),
            wqk_t.data_ptr(), bqk.data_ptr(), bias.data_ptr(), _ptr(mask),
            wp_t.data_ptr(), bproj.data_ptr(), ln2[0].data_ptr(),
            ln2[1].data_ptr(), w1_t.data_ptr(), b1.data_ptr(),
            w2_t.data_ptr(), b2.data_ptr(), scratch["qk"].data_ptr(),
            _ptr(scratch["g"]), out.data_ptr(), b, hp, wp, c, heads, hidden,
            window_size, h, w, shift, float(scale), int(bf16), stream)
    if rc != 0:
        raise RuntimeError(f"crf_rowblock_infer launch failed: CUDA error {rc}")
    crf_rowblock_infer.launches += 1
    return out


crf_rowblock_infer.launches = 0

#: ``tpudepth::crf_rowblock_infer``
CRF_OP = _op.define(
    "crf_rowblock_infer",
    "(Tensor x, Tensor v, Tensor ln1_w, Tensor ln1_b, Tensor wqk, Tensor bqk, "
    "Tensor bias, Tensor wproj, Tensor bproj, Tensor ln2_w, Tensor ln2_b, "
    "Tensor w1, Tensor b1, Tensor w2, Tensor b2, Tensor? mask, float scale, "
    "int window_size, int h, int w, int shift) -> Tensor",
    _crf_run, _crf_run, lambda x, *rest: x.new_empty(x.shape))


def sam_rowblock_infer(x: torch.Tensor, v: torch.Tensor, ln1: tuple,
                       lnv: tuple, wq: torch.Tensor, bq: torch.Tensor,
                       wkv: torch.Tensor, bkv: torch.Tensor,
                       bias: torch.Tensor, wproj: torch.Tensor,
                       bproj: torch.Tensor, ln2: tuple, w1: torch.Tensor,
                       b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, *,
                       scale: float, window_size: int = 7,
                       valid_hw: Optional[tuple] = None) -> torch.Tensor:
    """The SAM block, ``[B, Hp, Wp, C]`` in x's dtype. CPU tensors run
    :func:`sam_rowblock_infer_reference`; CUDA tensors launch the
    ``sam_rowblock_infer`` kernels (one call counted in
    ``sam_rowblock_infer.launches``); through :data:`SAM_OP` only while
    ``torch.export`` traces."""
    c = x.shape[-1]
    _, hp, wp, _, _, _ = _check(
        "sam_rowblock_infer", x, v, bias, None, window_size, [ln1, lnv],
        [(wq, bq, c), (wkv, bkv, 2 * c)], (wproj, bproj, ln2, w1, b1, w2, b2))
    h, w = valid_hw if valid_hw is not None else (hp, wp)
    _op.check_device("sam_rowblock_infer", x)
    args = (x, v, *ln1, *lnv, wq, bq, wkv, bkv, bias, wproj, bproj, *ln2, w1,
            b1, w2, b2, float(scale), window_size, h, w)
    return SAM_OP(*args) if _op.through_op() else _sam_run(*args)


def _sam_run(x, v, ln1_w, ln1_b, lnv_w, lnv_b, wq, bq, wkv, bkv, bias, wproj,
             bproj, ln2_w, ln2_b, w1, b1, w2, b2, scale, window_size, h, w):
    """The kernel of a ``sam_rowblock_infer`` call on x's device, its
    LayerNorm pairs flattened: the plain version on the CPU, the launch on
    the card (counted)."""
    ln1, lnv, ln2 = (ln1_w, ln1_b), (lnv_w, lnv_b), (ln2_w, ln2_b)
    b, hp, wp, c = x.shape
    heads = bias.shape[0]
    hidden = w1.shape[1]
    if x.device.type == "cpu":
        return sam_rowblock_infer_reference(
            x, v, ln1, lnv, wq, bq, wkv, bkv, bias, wproj, bproj, ln2, w1, b1,
            w2, b2, scale=scale, window_size=window_size,
            valid_hw=(h, w)).contiguous()
    wq_t, wkv_t, wp_t, w1_t, w2_t = cuda_args(
        "sam_rowblock_infer", x, v, bias, None, window_size ** 2,
        (wq, wkv, wproj, w1, w2), (*ln1, *lnv, bq, bkv, bproj, *ln2, b1, b2))
    bf16 = x.dtype == torch.bfloat16
    scratch = alloc_scratch(sam_scratch_shapes(b, hp, wp, c, hidden, bf16),
                            x.dtype, x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().sam_rowblock_infer(
            x.data_ptr(), v.data_ptr(), ln1[0].data_ptr(), ln1[1].data_ptr(),
            lnv[0].data_ptr(), lnv[1].data_ptr(), wq_t.data_ptr(),
            bq.data_ptr(), wkv_t.data_ptr(), bkv.data_ptr(), bias.data_ptr(),
            wp_t.data_ptr(), bproj.data_ptr(), ln2[0].data_ptr(),
            ln2[1].data_ptr(), w1_t.data_ptr(), b1.data_ptr(),
            w2_t.data_ptr(), b2.data_ptr(), scratch["qkv"].data_ptr(),
            _ptr(scratch["g"]), out.data_ptr(), b, hp, wp, c, heads, hidden,
            window_size, h, w, float(scale), int(bf16), stream)
    if rc != 0:
        raise RuntimeError(f"sam_rowblock_infer launch failed: CUDA error {rc}")
    sam_rowblock_infer.launches += 1
    return out


sam_rowblock_infer.launches = 0

#: ``tpudepth::sam_rowblock_infer``
SAM_OP = _op.define(
    "sam_rowblock_infer",
    "(Tensor x, Tensor v, Tensor ln1_w, Tensor ln1_b, Tensor lnv_w, "
    "Tensor lnv_b, Tensor wq, Tensor bq, Tensor wkv, Tensor bkv, Tensor bias, "
    "Tensor wproj, Tensor bproj, Tensor ln2_w, Tensor ln2_b, Tensor w1, "
    "Tensor b1, Tensor w2, Tensor b2, float scale, int window_size, int h, "
    "int w) -> Tensor",
    _sam_run, _sam_run, lambda x, *rest: x.new_empty(x.shape))
