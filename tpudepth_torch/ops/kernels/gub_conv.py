"""Fused GUB conv: ``y = conv_k(relu(x*A + C) [+skip], w) + b`` with optional
per-channel ``sum(y)`` and ``sum(y^2)``, and its analytic backward.

Counterpart of ``tpudepth/ops/pallas/gub_conv.py::conv_bn_act`` with its
``custom_vjp``. The kernels are ``tpudepth_torch/csrc/gub_conv_fwd.cu``
(``gub_conv_fwd``) and ``csrc/gub_conv_bwd.cu`` (``gub_conv_dw``,
``gub_conv_dx``), CUDA C++ for ``sm_90a`` built by ``_build``; their headers
say what bounds them and how they are laid out. Each kernel has a wrapper
with a launch counter (``conv_bn_act``, ``conv_bn_act_dw``,
``conv_bn_act_dx``) and a plain PyTorch version in the kernel's rounding
order (``*_reference``). A wrapper runs the plain version for CPU tensors
and launches its kernel for CUDA tensors, or raises. The public boundary
keeps the JAX layout:

- ``parts``: NHWC ``[B,H,W,Cin_j]`` tensors (or the ``permute(0,2,3,1)``
  view of a channels_last tensor), one dtype, treated as a channel concat
  that is never materialized;
- ``w``: HWIO ``[k,k,sum(Cin),Cout]`` float32 (any strides, so the
  ``permute(2,3,1,0)`` view of an OIHW conv weight needs no copy);
- ``b``: ``[Cout]`` float32;
- ``preludes``: per part ``(A, C)``, each ``[B, Cin_j]`` float32;
- ``skip``: part 0's shape, added after part 0's relu.

The plain versions compute in float32, or in float64 when the parts are
float64 (a CPU-only path for well-conditioned comparisons).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from tpudepth_torch.ops.kernels import _build, _op

Prelude = Tuple[torch.Tensor, torch.Tensor]

_MAX_PARTS = 4


def _ct(dtype: torch.dtype) -> torch.dtype:
    """The dtype the plain versions compute in for IO dtype ``dtype``."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _check_args(parts, w, b, preludes, skip):
    if not parts:
        raise ValueError("conv_bn_act needs at least one part")
    if skip is not None and preludes is None:
        raise ValueError("skip requires a prelude (relu(x*A+C) + skip)")
    bsz, h, wd, _ = parts[0].shape
    for p in parts:
        if p.dim() != 4 or tuple(p.shape[:3]) != (bsz, h, wd):
            raise ValueError(f"part shape {tuple(p.shape)} does not match "
                             f"{(bsz, h, wd)}")
        if p.dtype != parts[0].dtype:
            raise ValueError("all parts must share one dtype")
    k = w.shape[0]
    cin = sum(p.shape[-1] for p in parts)
    if w.dim() != 4 or w.shape[1] != k or w.shape[2] != cin or k % 2 != 1:
        raise ValueError(f"w {tuple(w.shape)} is not [k,k,{cin},Cout], k odd")
    if b.shape != (w.shape[3],):
        raise ValueError(f"b {tuple(b.shape)} is not [{w.shape[3]}]")
    if preludes is not None:
        if len(preludes) != len(parts):
            raise ValueError("one (A, C) prelude per part")
        for p, (a, c) in zip(parts, preludes):
            want = (bsz, p.shape[-1])
            if tuple(a.shape) != want or tuple(c.shape) != want:
                raise ValueError(f"prelude shapes {tuple(a.shape)}, "
                                 f"{tuple(c.shape)} are not {want}")
    if skip is not None and skip.shape != parts[0].shape:
        raise ValueError("skip must have part 0's shape")


def _activate(parts, preludes, skip):
    """The activated inputs, each rounded to the IO dtype (NHWC)."""
    if preludes is None:
        return list(parts)
    out = []
    for j, (x, (a, c)) in enumerate(zip(parts, preludes)):
        ct = _ct(x.dtype)
        z = torch.relu(x.to(ct) * a.to(ct)[:, None, None, :]
                       + c.to(ct)[:, None, None, :])
        if j == 0 and skip is not None:
            z = z + skip.to(ct)
        out.append(z.to(x.dtype))
    return out


def conv_bn_act_reference(
    parts: Sequence[torch.Tensor],
    w: torch.Tensor,
    b: torch.Tensor,
    *,
    preludes: Optional[Sequence[Prelude]] = None,
    skip: Optional[torch.Tensor] = None,
    stats: bool = False,
):
    """Plain PyTorch version, in the kernel's rounding order: the prelude in
    f32 rounded to the IO dtype, zero padding after it, products of
    IO-dtype-rounded operands summed in f32, the bias in f32, then the output
    rounded; the statistics sum the rounded output. On CUDA it needs
    ``torch.backends.cudnn.allow_tf32 = False`` to stay in full f32."""
    parts = tuple(parts)
    _check_args(parts, w, b, preludes, skip)
    dt = parts[0].dtype
    ct = _ct(dt)
    xa = torch.cat(_activate(parts, preludes, skip), dim=-1)
    wk = w.to(dt).to(ct).permute(3, 2, 0, 1)  # OIHW
    yf = F.conv2d(xa.to(ct).permute(0, 3, 1, 2), wk, b.to(ct),
                  padding=w.shape[0] // 2)
    y = yf.permute(0, 2, 3, 1).to(dt)
    if not stats:
        return y
    yr = y.to(ct)
    return y, yr.sum(dim=(0, 1, 2)), (yr * yr).sum(dim=(0, 1, 2))


def _cotangent(dy, y, ds, dq):
    """``g = dy + ds + 2*dq*y`` in the compute dtype, before it is rounded:
    the cotangent of the conv's output with the statistics' cotangents folded
    in (``y`` is the rounded forward output, or None without statistics)."""
    ct = _ct(dy.dtype)
    g = dy.to(ct)
    if y is not None:
        g = g + ds.to(ct) + 2.0 * dq.to(ct) * y.to(ct)
    return g


def conv_bn_act_dw_reference(
    parts: Sequence[torch.Tensor],
    dy: torch.Tensor,
    k: int,
    *,
    preludes: Optional[Sequence[Prelude]] = None,
    skip: Optional[torch.Tensor] = None,
    y: Optional[torch.Tensor] = None,
    ds: Optional[torch.Tensor] = None,
    dq: Optional[torch.Tensor] = None,
):
    """Plain PyTorch ``(dw, db)`` of the fused conv in the ``gub_conv_dw``
    kernel's rounding order: ``db`` sums ``g`` before it is rounded; ``dw``
    sums, in the compute dtype, products of the activated input as the
    forward stages it (zero outside the image) and ``g`` rounded to the IO
    dtype. ``dw`` is HWIO ``[k,k,sum(Cin),Cout]``."""
    dt = dy.dtype
    ct = _ct(dt)
    pad = k // 2
    bsz, h, wd, _ = dy.shape
    g = _cotangent(dy, y, ds, dq)
    db = g.sum(dim=(0, 1, 2))
    gb = g.to(dt).to(ct)
    xa = torch.cat(_activate(tuple(parts), preludes, skip), dim=-1).to(ct)
    xap = F.pad(xa, (0, 0, pad, pad, pad, pad))
    dw = torch.stack([
        torch.stack([
            torch.einsum("bhwi,bhwo->io", xap[:, u:u + h, v:v + wd], gb)
            for v in range(k)])
        for u in range(k)])
    return dw, db


def conv_bn_act_dx_reference(
    x: torch.Tensor,
    w: torch.Tensor,
    dy: torch.Tensor,
    *,
    prelude: Optional[Prelude] = None,
    want_skip: bool = False,
    y: Optional[torch.Tensor] = None,
    ds: Optional[torch.Tensor] = None,
    dq: Optional[torch.Tensor] = None,
):
    """Plain PyTorch ``(dx, dA, dC, dskip)`` of ONE part in the
    ``gub_conv_dx`` kernel's rounding order. ``w`` is the part's rows of the
    HWIO weight, ``[k,k,Cin_j,Cout]``. ``g`` is rounded to the IO dtype and
    zero-padded AFTER the statistics' cotangents are added (a halo pixel is
    0, not ``ds``); the weights are rounded to the IO dtype; the sums run in
    the compute dtype. ``dskip`` is the conv's input gradient before the
    gate; with a prelude the gate recomputes ``p = x*A + C`` as the forward
    does. ``dA``, ``dC`` are ``[B,Cin_j]`` in the compute dtype, or None."""
    dt = dy.dtype
    ct = _ct(dt)
    k = w.shape[0]
    pad = k // 2
    bsz, h, wd, _ = dy.shape
    g = _cotangent(dy, y, ds, dq).to(dt).to(ct)
    gp = F.pad(g, (0, 0, pad, pad, pad, pad))
    wr = w.to(dt).to(ct)
    dxa = None
    for u in range(k):
        for v in range(k):
            # dxa[h, w] takes g[h - u + pad, w - v + pad] through w[u, v]
            gs = gp[:, 2 * pad - u:2 * pad - u + h, 2 * pad - v:2 * pad - v + wd]
            t = torch.einsum("bhwo,io->bhwi", gs, wr[u, v])
            dxa = t if dxa is None else dxa + t
    dskip = dxa.to(dt) if want_skip else None
    if prelude is None:
        return dxa.to(dt), None, None, dskip
    a, c = (t.to(ct)[:, None, None, :] for t in prelude)
    xf = x.to(ct)
    p = xf * a + c
    dp = torch.where(p > 0, dxa, torch.zeros_like(dxa))
    return ((dp * a).to(dt), (dp * xf).sum(dim=(1, 2)), dp.sum(dim=(1, 2)),
            dskip)


def tolerance(dtype: torch.dtype) -> Tuple[float, float]:
    """(atol, rtol) of ``gub_conv_fwd`` against
    :func:`conv_bn_act_reference`, and of ``gub_conv_dx``'s ``dx`` and
    ``dskip`` against :func:`conv_bn_act_dx_reference`, on the same inputs,
    for inputs and outputs of unit scale.

    Both take the same IO-dtype operands and the same prelude rounding; only
    the order of the f32 sums differs. In f32 that leaves a few ulps of a sum
    of up to 9*64 products. In bf16 a sum that lands near a rounding boundary
    can round to the neighbouring value: one bf16 ulp, 2**-7 relative."""
    if dtype == torch.bfloat16:
        return 1e-3, 2.0 ** -7
    return 1e-4, 1e-4


def sum_tolerance(n_terms: int, term_rms: float) -> float:
    """atol of an f32 sum of ``n_terms`` terms of root mean square
    ``term_rms`` taken in two different orders (``dw``, ``db``, ``dA``,
    ``dC`` of the kernels against the plain versions; the terms themselves
    are bit-equal on both sides). It goes with the rtol :data:`SUM_RTOL`.

    Each addition rounds a running sum of size about ``sqrt(n) * rms`` to
    half an ulp; a single chain of ``n`` such roundings adds up, as a random
    walk, to ``eps * n * rms / sqrt(2)``. The kernels and the plain versions
    both sum in shorter chains, so ``eps * n * rms`` bounds their difference
    from above, while one wrong or missing term (of size ``rms``) exceeds it
    for every ``n`` below ``1 / eps`` (8.4 million)."""
    return float(torch.finfo(torch.float32).eps * n_terms * term_rms)


#: rtol that goes with :func:`sum_tolerance`. Terms with a non-zero mean
#: (an activated input is >= 0, and ``g`` carries ``ds``) give a sum far
#: larger than the random walk of its terms, and the last additions of
#: either order round at the size of the result itself: 16 ulps of it.
SUM_RTOL = 16 * torch.finfo(torch.float32).eps


_VP, _I32 = ctypes.c_void_p, ctypes.c_int
_PVP, _PI32 = ctypes.POINTER(_VP), ctypes.POINTER(_I32)
_PLL = ctypes.POINTER(ctypes.c_longlong)

#: ctypes signature of each C entry, by library (``csrc/<library>.cu``):
#: per-part arrays are pointers to pointers or to ints, the weight strides a
#: pointer to long longs
ARGTYPES = {
    "gub_conv_fwd": {
        "gub_conv_fwd": (_I32, _PVP, _PVP, _PVP, _PI32, _VP, _VP, _PLL)
                        + (_VP,) * 4 + (_I32,) * 6 + (_VP,),
    },
    "gub_conv_bwd": {
        "gub_conv_bwd_tiles": (_I32, _I32),
        "gub_conv_dw_blocks": (_I32, _PI32) + (_I32,) * 6,
        "gub_conv_dw": (_I32, _PVP, _PVP, _PVP, _PI32) + (_VP,) * 8
                       + (_PLL, _VP) + (_I32,) * 6 + (_VP,),
        "gub_conv_dx": (_VP,) * 8 + (_PLL, _I32) + (_VP,) * 6 + (_I32,) * 7
                       + (_VP,),
    },
}


def _bind(name: str) -> ctypes.CDLL:
    """Load library ``name`` and set the signature of each of its entries
    (each returns an int: a ``cudaError_t`` or a count)."""
    lib = _build.load(name)
    for fn, types in ARGTYPES[name].items():
        getattr(lib, fn).argtypes = list(types)
        getattr(lib, fn).restype = _I32
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _bind("gub_conv_fwd")


@functools.lru_cache(maxsize=None)
def _lib_bwd() -> ctypes.CDLL:
    return _bind("gub_conv_bwd")


def _check_cuda(parts, w, b, preludes, skip, kernel="gub_conv_fwd"):
    dev = parts[0].device
    dt = parts[0].dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{kernel} takes float32 or bfloat16, not {dt}")
    if len(parts) > _MAX_PARTS:
        raise ValueError(f"{kernel} takes at most {_MAX_PARTS} parts")
    if w.shape[0] not in (1, 3):
        raise ValueError(f"{kernel} takes k in {{1, 3}}")
    tensors = list(parts) + [w] + [t for t in (b, skip) if t is not None]
    if preludes is not None:
        tensors += [t for pc in preludes for t in pc]
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, expected {dev}")
    for t in list(parts) + ([skip] if skip is not None else []):
        if not t.is_contiguous():
            raise ValueError("parts and skip must be contiguous NHWC "
                             "(permute(0,2,3,1) of a channels_last tensor)")
        if t.dtype != dt:
            raise TypeError("skip must have the parts' dtype")
    if w.dtype != torch.float32 or (b is not None and b.dtype != torch.float32):
        raise TypeError("w and b must be float32")
    if b is not None and not b.is_contiguous():
        raise ValueError("b must be contiguous")
    if preludes is not None:
        for a, c in preludes:
            for t in (a, c):
                if t.dtype != torch.float32 or not t.is_contiguous():
                    raise ValueError("A and C must be contiguous float32")


def _check_cuda_cotangents(dy, y, ds, dq, shape, dt):
    """``dy`` (and ``y``) contiguous ``shape`` in the IO dtype on the card;
    ``ds`` and ``dq`` contiguous float32 ``[Cout]``."""
    for t in (dy,) if y is None else (dy, y):
        if (not t.is_cuda or tuple(t.shape) != tuple(shape) or t.dtype != dt
                or not t.is_contiguous()):
            raise ValueError(f"dy and y must be contiguous {tuple(shape)} "
                             f"{dt} CUDA tensors")
    if y is not None:
        for t in (ds, dq):
            if (not t.is_cuda or t.dtype != torch.float32
                    or tuple(t.shape) != (shape[-1],) or not t.is_contiguous()):
                raise ValueError("ds and dq must be contiguous float32 [Cout] "
                                 "CUDA tensors")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _part_arrays(parts, preludes):
    arr = ctypes.c_void_p * _MAX_PARTS
    xs = arr(*[p.data_ptr() for p in parts])
    if preludes is not None:
        a_ptrs = arr(*[a.data_ptr() for a, _ in preludes])
        c_ptrs = arr(*[c.data_ptr() for _, c in preludes])
    else:
        a_ptrs, c_ptrs = arr(), arr()
    cins = (ctypes.c_int * _MAX_PARTS)(*[p.shape[-1] for p in parts])
    return xs, a_ptrs, c_ptrs, cins


def _forward(parts, w, b, preludes, skip, stats):
    """The forward without autograd: plain version or ``gub_conv_fwd``."""
    if parts[0].device.type == "cpu":
        return conv_bn_act_reference(parts, w, b, preludes=preludes,
                                     skip=skip, stats=stats)
    if parts[0].device.type != "cuda":
        raise ValueError(f"no gub_conv_fwd kernel for {parts[0].device}")
    _check_cuda(parts, w, b, preludes, skip)

    bsz, h, wd, _ = parts[0].shape
    k, cout = w.shape[0], w.shape[3]
    dev = parts[0].device
    y = torch.empty((bsz, h, wd, cout), dtype=parts[0].dtype, device=dev)
    sq = None
    if stats:
        # f64 accumulators of the blocks' f32 sums, rounded to f32 below
        sq = torch.zeros((2, cout), dtype=torch.float64, device=dev)

    xs, a_ptrs, c_ptrs, cins = _part_arrays(parts, preludes)
    strides = (ctypes.c_longlong * 4)(*w.stride())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().gub_conv_fwd(
            len(parts), xs, a_ptrs, c_ptrs, cins, _ptr(skip),
            w.data_ptr(), strides, b.data_ptr(), y.data_ptr(),
            None if sq is None else sq[0].data_ptr(),
            None if sq is None else sq[1].data_ptr(),
            bsz, h, wd, cout, k, int(y.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"gub_conv_fwd launch failed: CUDA error {rc}")
    conv_bn_act.launches += 1
    if not stats:
        return y
    s, q = sq.float()
    return y, s, q


def conv_bn_act_dw(
    parts: Sequence[torch.Tensor],
    dy: torch.Tensor,
    w: torch.Tensor,
    *,
    preludes: Optional[Sequence[Prelude]] = None,
    skip: Optional[torch.Tensor] = None,
    y: Optional[torch.Tensor] = None,
    ds: Optional[torch.Tensor] = None,
    dq: Optional[torch.Tensor] = None,
):
    """``(dw, db)`` of the fused conv for the cotangents ``dy`` (and ``ds``,
    ``dq`` with the rounded forward output ``y`` when it emitted statistics).
    ``w`` gives ``dw`` its shape and layout and is not read: ``dw`` comes
    back HWIO ``[k,k,sum(Cin),Cout]`` in ``w``'s dtype and, on the card, with
    ``w``'s strides when ``w`` is dense (``torch.empty_like(w)``, written
    through its strides by the kernel), so the gradient of the
    ``permute(2,3,1,0)`` view of an OIHW parameter permutes back to the
    parameter's own layout without a copy.

    CPU tensors run :func:`conv_bn_act_dw_reference`; CUDA tensors launch
    the ``gub_conv_dw`` kernel (counted in ``conv_bn_act_dw.launches``)."""
    parts = tuple(parts)
    k = w.shape[0]
    if dy.device.type == "cpu":
        dw, db = conv_bn_act_dw_reference(parts, dy, k, preludes=preludes,
                                          skip=skip, y=y, ds=ds, dq=dq)
        return dw.to(w.dtype), db.to(w.dtype)
    if dy.device.type != "cuda":
        raise ValueError(f"no gub_conv_dw kernel for {dy.device}")
    _check_cuda(parts, w, None, preludes, skip, kernel="gub_conv_dw")
    bsz, h, wd, _ = parts[0].shape
    cout = w.shape[3]
    if tuple(w.shape[1:3]) != (k, sum(p.shape[-1] for p in parts)):
        raise ValueError(f"w {tuple(w.shape)} does not match the parts")
    _check_cuda_cotangents(dy, y, ds, dq, (bsz, h, wd, cout), parts[0].dtype)

    dev = dy.device
    lib = _lib_bwd()
    xs, a_ptrs, c_ptrs, cins = _part_arrays(parts, preludes)
    nb = lib.gub_conv_dw_blocks(len(parts), cins, cout, bsz, h, wd, k,
                                int(dy.dtype == torch.bfloat16))
    part_dw = torch.empty((nb, w.numel()), dtype=torch.float32, device=dev)
    part_db = torch.empty((nb, cout), dtype=torch.float32, device=dev)
    dw = torch.empty_like(w)  # w's strides when w is dense, else contiguous
    db = torch.empty(cout, dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 4)(*dw.stride())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gub_conv_dw(
            len(parts), xs, a_ptrs, c_ptrs, cins, _ptr(skip), dy.data_ptr(),
            _ptr(y), _ptr(ds), _ptr(dq), part_dw.data_ptr(),
            part_db.data_ptr(), dw.data_ptr(), strides, db.data_ptr(),
            bsz, h, wd, cout, k, int(dy.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"gub_conv_dw launch failed: CUDA error {rc}")
    conv_bn_act_dw.launches += 1
    return dw, db


conv_bn_act_dw.launches = 0


def conv_bn_act_dx(
    x: torch.Tensor,
    w: torch.Tensor,
    off: int,
    dy: torch.Tensor,
    *,
    prelude: Optional[Prelude] = None,
    want_skip: bool = False,
    y: Optional[torch.Tensor] = None,
    ds: Optional[torch.Tensor] = None,
    dq: Optional[torch.Tensor] = None,
):
    """``(dx, dA, dC, dskip)`` of the part ``x`` whose rows in the HWIO
    weight ``w`` start at ``off``. ``dx`` and ``dskip`` have ``x``'s shape
    and dtype; ``dA`` and ``dC`` are f32 ``[B,Cin_j]`` (None without a
    prelude); ``dskip`` is None unless ``want_skip``.

    CPU tensors run :func:`conv_bn_act_dx_reference`; CUDA tensors launch
    the ``gub_conv_dx`` kernel (counted in ``conv_bn_act_dx.launches``)."""
    cin = x.shape[-1]
    if dy.device.type == "cpu":
        dx, da, dc, dskip = conv_bn_act_dx_reference(
            x, w[:, :, off:off + cin], dy, prelude=prelude,
            want_skip=want_skip, y=y, ds=ds, dq=dq)
        if prelude is not None:
            da, dc = da.to(prelude[0].dtype), dc.to(prelude[1].dtype)
        return dx, da, dc, dskip
    if dy.device.type != "cuda":
        raise ValueError(f"no gub_conv_dx kernel for {dy.device}")
    if off < 0 or off + cin > w.shape[2]:
        raise ValueError(f"rows {off}..{off + cin} are not in w "
                         f"{tuple(w.shape)}")
    _check_cuda((x,), w[:, :, off:off + cin], None,
                None if prelude is None else (prelude,), None,
                kernel="gub_conv_dx")
    bsz, h, wd, _ = x.shape
    k, cout = w.shape[0], w.shape[3]
    _check_cuda_cotangents(dy, y, ds, dq, (bsz, h, wd, cout), x.dtype)

    dev = dy.device
    lib = _lib_bwd()
    dx = torch.empty_like(x)
    dskip = torch.empty_like(x) if want_skip else None
    da = dc = part_da = part_dc = None
    if prelude is not None:
        tiles = lib.gub_conv_bwd_tiles(h, wd)
        part_da = torch.empty((bsz, tiles, cin), dtype=torch.float32,
                              device=dev)
        part_dc = torch.empty_like(part_da)
        da = torch.empty((bsz, cin), dtype=torch.float32, device=dev)
        dc = torch.empty_like(da)
    a, c = prelude if prelude is not None else (None, None)
    strides = (ctypes.c_longlong * 4)(*w.stride())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gub_conv_dx(
            dy.data_ptr(), _ptr(y), _ptr(ds), _ptr(dq),
            x.data_ptr() if prelude is not None else None, _ptr(a), _ptr(c),
            w.data_ptr(), strides, off, dx.data_ptr(), _ptr(dskip),
            _ptr(part_da), _ptr(part_dc), _ptr(da), _ptr(dc),
            bsz, h, wd, cin, cout, k, int(dy.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"gub_conv_dx launch failed: CUDA error {rc}")
    conv_bn_act_dx.launches += 1
    return dx, da, dc, dskip


conv_bn_act_dx.launches = 0


def _unflatten(n, has_pre, has_skip, flat):
    """``(parts, preludes, skip)`` from parts, then every A, then every C,
    then the skip."""
    parts = tuple(flat[:n])
    preludes = None
    if has_pre:
        preludes = tuple(zip(flat[n:2 * n], flat[2 * n:3 * n]))
    return parts, preludes, flat[-1] if has_skip else None


class _ConvBnAct(torch.autograd.Function):
    """``conv_bn_act`` with its analytic backward, the counterpart of the
    ``custom_vjp`` in ``tpudepth/ops/pallas/gub_conv.py::_build``. It saves
    the raw inputs and, with statistics, the rounded output; no activated
    tensor is kept or written. Cotangents of unused outputs arrive as zeros
    (autograd materializes them). A part is given a ``gub_conv_dx`` launch
    only when it, its prelude or its skip needs a gradient, and
    ``gub_conv_dw`` runs only when ``w`` or ``b`` does."""

    @staticmethod
    def forward(ctx, n, has_pre, has_skip, stats, w, b, *flat):
        parts, preludes, skip = _unflatten(n, has_pre, has_skip, flat)
        out = _forward(parts, w, b, preludes, skip, stats)
        ctx.cfg = (n, has_pre, has_skip, stats)
        if stats:
            ctx.save_for_backward(w, out[0], *flat)
        else:
            ctx.save_for_backward(w, *flat)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, ds=None, dq=None):
        n, has_pre, has_skip, stats = ctx.cfg
        w, *saved = ctx.saved_tensors
        cot = {}
        if stats:
            y, *saved = saved
            cot = {"y": y, "ds": ds.contiguous(), "dq": dq.contiguous()}
        parts, preludes, skip = _unflatten(n, has_pre, has_skip, saved)
        needs = ctx.needs_input_grad[6:]
        dy = dy.contiguous()

        dw = db = None
        if ctx.needs_input_grad[4] or ctx.needs_input_grad[5]:
            dw, db = conv_bn_act_dw(parts, dy, w, preludes=preludes,
                                    skip=skip, **cot)
        grads = [None] * len(saved)
        off = 0
        for j, x in enumerate(parts):
            slots = [j] + ([n + j, 2 * n + j] if has_pre else [])
            want_skip = has_skip and j == 0
            if want_skip:
                slots.append(len(saved) - 1)
            if any(needs[i] for i in slots):
                out = conv_bn_act_dx(
                    x, w, off, dy, prelude=preludes[j] if has_pre else None,
                    want_skip=want_skip, **cot)
                dx, da, dc, dskip = out
                vals = [dx] + ([da, dc] if has_pre else [])
                for i, g in zip(slots, vals + [dskip]):  # zip drops a None dskip
                    grads[i] = g
            off += x.shape[-1]
        return (None, None, None, None, dw, db, *grads)


def conv_bn_act(
    parts: Sequence[torch.Tensor],
    w: torch.Tensor,
    b: torch.Tensor,
    *,
    preludes: Optional[Sequence[Prelude]] = None,
    skip: Optional[torch.Tensor] = None,
    stats: bool = False,
):
    """Fused ``conv(relu(x*A + C) [+skip], w) + b``, returning ``y`` or
    ``(y, sum_y, sum_y2)`` with the sums per channel over (B, H, W) in f32
    (the kernel adds its blocks' f32 sums in f64 and rounds once, so they
    keep f32 accuracy over millions of pixels).
    Differentiable in ``parts``, ``preludes``, ``skip``, ``w`` and ``b``
    through :class:`_ConvBnAct`.

    CPU tensors run :func:`conv_bn_act_reference`; CUDA tensors launch the
    ``gub_conv_fwd`` kernel (counted in ``conv_bn_act.launches``). Without
    autograd the call goes through :data:`FWD_OP` only while
    ``torch.export`` traces."""
    parts = tuple(parts)
    _check_args(parts, w, b, preludes, skip)
    _op.check_device("gub_conv_fwd", parts[0])
    flat = list(parts)
    if preludes is not None:
        flat += [a for a, _ in preludes] + [c for _, c in preludes]
    if skip is not None:
        flat.append(skip)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (w, b, *flat)):
        return _ConvBnAct.apply(len(parts), preludes is not None,
                                skip is not None, stats, w, b, *flat)
    if not _op.through_op():
        return _forward(parts, w, b, preludes, skip, stats)
    a, c = ([list(t) for t in zip(*preludes)] if preludes is not None
            else ([], []))
    y, s, q = FWD_OP(list(parts), w, b, a, c, skip, stats)
    return (y, s, q) if stats else y


conv_bn_act.launches = 0


def _fwd_run(parts, w, b, a, c, skip, stats):
    """:func:`_forward` with the preludes as two lists (empty: none) and
    three outputs, the sums empty without statistics: the plain version on
    the CPU (its output contiguous, as the launch's), the launch on the card
    (counted)."""
    preludes = tuple(zip(a, c)) if a else None
    out = _forward(tuple(parts), w, b, preludes, skip, stats)
    if stats:
        y, s, q = out
        # the launch's sums are rows of one tensor: outputs of an op may not
        # share storage
        return y.contiguous(), s.clone(), q.clone()
    none = out.new_empty((0,), dtype=torch.float32)
    return out.contiguous(), none, none.clone()


def _fwd_fake(parts, w, b, a, c, skip, stats):
    bsz, h, wd, _ = parts[0].shape
    cout = w.shape[3]
    n = cout if stats else 0
    return (parts[0].new_empty((bsz, h, wd, cout)),
            parts[0].new_empty((n,), dtype=torch.float32),
            parts[0].new_empty((n,), dtype=torch.float32))


#: ``tpudepth::gub_conv_fwd``: :func:`conv_bn_act` without autograd
FWD_OP = _op.define(
    "gub_conv_fwd",
    "(Tensor[] parts, Tensor w, Tensor b, Tensor[] a, Tensor[] c, "
    "Tensor? skip, bool stats) -> (Tensor, Tensor, Tensor)",
    _fwd_run, _fwd_run, _fwd_fake)
