"""Fused root-recipe loss: ``ssim_weight * mean(clip((1 - SSIM) / 2, 0, 1))
+ l1_weight * mean|p - t|`` (monodepth2 SSIM: ReflectionPad(1) and 3x3
average-pool statistics) with an analytic backward, float32 throughout.

Counterpart of ``tpudepth/ops/pallas/fused_root_loss.py``. The kernels are
in ``tpudepth_torch/csrc/fused_root_loss.cu`` (CUDA C++ for ``sm_90a``, built
by ``_build``); its header says how they are laid out and what bounds them.

- :func:`root_partials` (kernel ``fused_root_loss_fwd``): per image the two
  sums ``[sum of the clipped SSIM loss map, sum |p - t|]``;
- :func:`root_bwd` (kernel ``fused_root_loss_bwd``): ``dL/dp`` from ``p``,
  ``t`` and the two scales ``[s_ssim, s_l1]`` of the terms;
- :func:`fused_root_loss`: the ``torch.autograd.Function`` over both, with
  the combination and the scales as tensor code on the device (no host
  sync).

The plain versions (``*_reference``) repeat the kernels' arithmetic op for
op (the Pallas kernels' order: the box down the columns, then along the
rows; its adjoint along the rows, then down the columns), in float32, or in
float64 for float64 inputs (for ``gradcheck``). Each wrapper runs its plain
version for CPU tensors only; on a CUDA tensor it launches its kernel or
raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from tpudepth_torch.ops.kernels import _build

C1 = 0.01 ** 2
C2 = 0.03 ** 2
THIRD = 1.0 / 3.0


def _box(x: torch.Tensor) -> torch.Tensor:
    """3x3 mean with ReflectionPad(1) over the last two dims: down the
    columns ``((x[y-1] + x[y]) + x[y+1]) * third``, then along the rows."""
    xp = torch.cat([x[..., 1:2, :], x, x[..., -2:-1, :]], dim=-2)
    acc = (xp[..., :-2, :] + xp[..., 1:-1, :] + xp[..., 2:, :]) * THIRD
    ap = torch.cat([acc[..., 1:2], acc, acc[..., -2:-1]], dim=-1)
    return (ap[..., :-2] + ap[..., 1:-1] + ap[..., 2:]) * THIRD


def _box_adjoint(s: torch.Tensor) -> torch.Tensor:
    """Adjoint of :func:`_box`: along the rows, a zero-padded 3-sum times
    third plus the reflection's transpose (``s[0] * third`` added at column
    1, ``s[W-1] * third`` at column W-2); then down the columns the same."""
    w = s.shape[-1]
    sp = F.pad(s, (1, 1))
    acc = (sp[..., :-2] + sp[..., 1:-1] + sp[..., 2:]) * THIRD
    acc = acc + F.pad(s[..., :1] * THIRD, (1, w - 2))
    acc = acc + F.pad(s[..., -1:] * THIRD, (w - 2, 1))
    h = s.shape[-2]
    ap = F.pad(acc, (0, 0, 1, 1))
    out = (ap[..., :-2, :] + ap[..., 1:-1, :] + ap[..., 2:, :]) * THIRD
    out = out + F.pad(acc[..., :1, :] * THIRD, (0, 0, 1, h - 2))
    return out + F.pad(acc[..., -1:, :] * THIRD, (0, 0, h - 2, 1))


def _ssim_terms(p: torch.Tensor, t: torch.Tensor):
    """``(mu1, mu2, N1, D1, N2, D2)`` of the SSIM map."""
    m1, m2, e11, e22, e12 = _box(torch.stack([p, t, p * p, t * t, p * t]))
    s11 = e11 - m1 * m1
    s22 = e22 - m2 * m2
    s12 = e12 - m1 * m2
    n1 = 2.0 * m1 * m2 + C1
    d1 = m1 * m1 + m2 * m2 + C1
    n2 = 2.0 * s12 + C2
    d2 = s11 + s22 + C2
    return m1, m2, n1, d1, n2, d2


def _check(p: torch.Tensor, t: torch.Tensor):
    if p.dim() != 3 or p.shape != t.shape:
        raise ValueError(f"pred {tuple(p.shape)} and target {tuple(t.shape)} "
                         "must both be [B,H,W]")
    if p.shape[1] < 2 or p.shape[2] < 2:
        raise ValueError(f"the reflection pad needs H, W >= 2, not "
                         f"{tuple(p.shape[1:])}")
    if p.device != t.device or p.dtype != t.dtype:
        raise ValueError(f"pred ({p.dtype}, {p.device}) and target "
                         f"({t.dtype}, {t.device}) differ")


def root_partials_reference(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`root_partials`: ``[B,2]``."""
    _check(p, t)
    _, _, n1, d1, n2, d2 = _ssim_terms(p, t)
    ssim_map = (n1 * n2) / (d1 * d2)
    loss_map = torch.clamp((1.0 - ssim_map) * 0.5, 0.0, 1.0)
    return torch.stack([loss_map.sum(dim=(1, 2)),
                        (p - t).abs().sum(dim=(1, 2))], dim=1)


def root_bwd_reference(p: torch.Tensor, t: torch.Tensor,
                       scales: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`root_bwd`: the analytic ``dL/dp``
    ``[B,H,W]`` (``tpudepth/ops/pallas/fused_root_loss.py:116-145``). With
    ``R = 1/(D1*D2)``, ``M = N1*N2*R`` and the per-pixel clip gate
    ``G = -s_ssim/2`` strictly inside (0, 1), else 0, the coefficient maps
    are ``Cmu1 = G*(2*mu2*R*(N2-N1) - 2*mu1*M*(1/D1 - 1/D2))``, ``Ce11 =
    G*(-M/D2)``, ``Ce12 = G*(2*N1*R)``, and ``dL/dp = s_l1*sign(p-t) +
    B(Cmu1) + B(Ce11)*2p + B(Ce12)*t`` with ``B`` the adjoint box."""
    _check(p, t)
    s_ssim, s_l1 = scales.reshape(2).to(p.dtype).unbind()
    d = s_l1 * torch.sign(p - t)
    m1, m2, n1, d1, n2, d2 = _ssim_terms(p, t)
    r = 1.0 / (d1 * d2)
    m = n1 * n2 * r
    pre = (1.0 - m) * 0.5
    gate = torch.where((pre > 0.0) & (pre < 1.0), torch.full_like(p, -0.5),
                       torch.zeros_like(p)) * s_ssim
    cmu1 = gate * (2.0 * m2 * r * (n2 - n1) - 2.0 * m1 * m * (1.0 / d1 - 1.0 / d2))
    ce11 = gate * (-m / d2)
    ce12 = gate * (2.0 * n1 * r)
    b0, b1, b2 = _box_adjoint(torch.stack([cmu1, ce11, ce12]))
    return d + b0 + b1 * 2.0 * p + b2 * t


#: rtol of the kernels' partial sums against the plain versions': the sums
#: over an image's pixels are taken in another order (strips of 8x62, then
#: the blocks); the per-pixel maps are the same operations in the same order
PARTIALS_RTOL = 1e-5


_VP, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: ctypes signature of each C entry of ``csrc/fused_root_loss.cu``
ARGTYPES = {
    "fused_root_loss_fwd_strip": (ctypes.POINTER(_I32),),
    "fused_root_loss_fwd": (_VP,) * 4 + (_I32,) * 4 + (_F32,) * 2 + (_VP,),
    "fused_root_loss_bwd": (_VP,) * 4 + (_I32,) * 3 + (_F32,) * 2 + (_VP,),
}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_root_loss")
    for fn, types in ARGTYPES.items():
        getattr(lib, fn).argtypes = list(types)
        getattr(lib, fn).restype = _I32
    return lib


def _check_cuda(name: str, p: torch.Tensor, t: torch.Tensor):
    if p.device.type != "cuda":
        raise ValueError(f"no {name} kernel for {p.device}")
    if p.dtype != torch.float32:
        raise TypeError(f"{name} takes float32, not {p.dtype}")
    if not (p.is_contiguous() and t.is_contiguous()):
        raise ValueError(f"{name}: pred and target must be contiguous [B,H,W]")


@functools.lru_cache(maxsize=None)
def _fwd_strip() -> Tuple[int, int, int]:
    strip = (_I32 * 3)()
    _lib().fused_root_loss_fwd_strip(strip)
    return strip[0], strip[1], strip[2]


def fwd_scratch_words(bsz: int, h: int, w: int,
                      strip: Tuple[int, int, int]) -> int:
    """32-bit words of the forward's scratch for ``[bsz,h,w]`` inputs and its
    strip ``(rows, columns, warps a block)``: every block's two sums, then
    one ticket counter an image, which the C entry zeroes. Strip k holds the
    columns ``k*columns - 1 ..``, so ``ceil((w + 1) / columns)`` strips
    cover a row; a block takes ``warps`` strips of one image."""
    rows, cols, warps = strip
    strips = -(-h // rows) * -(-(w + 1) // cols)
    return bsz * -(-strips // warps) * 2 + bsz


def root_partials(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Per-image partial sums ``[B,2]`` of ``p``, ``t`` ``[B,H,W]``.

    CPU tensors run :func:`root_partials_reference`; CUDA tensors (float32)
    launch the ``fused_root_loss_fwd`` kernel, one CUDA kernel (counted in
    ``root_partials.launches``). The kernel's result repeats bit for bit
    from run to run."""
    _check(p, t)
    if p.device.type == "cpu":
        return root_partials_reference(p, t)
    _check_cuda("fused_root_loss_fwd", p, t)
    bsz, h, w = p.shape
    words = fwd_scratch_words(bsz, h, w, _fwd_strip())
    scratch = torch.empty(words, dtype=torch.float32, device=p.device)
    out = torch.empty((bsz, 2), dtype=torch.float32, device=p.device)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        rc = _lib().fused_root_loss_fwd(p.data_ptr(), t.data_ptr(),
                                        scratch.data_ptr(), out.data_ptr(),
                                        bsz, h, w, words, C1, C2, stream)
    if rc != 0:
        raise RuntimeError(f"fused_root_loss_fwd launch failed: CUDA error {rc}")
    root_partials.launches += 1
    return out


root_partials.launches = 0


def root_bwd(p: torch.Tensor, t: torch.Tensor,
             scales: torch.Tensor) -> torch.Tensor:
    """``dL/dp`` ``[B,H,W]`` from ``p``, ``t`` and ``scales`` (2 values on
    the inputs' device: the factors of the SSIM and L1 terms).

    CPU tensors run :func:`root_bwd_reference`; CUDA tensors (float32)
    launch the ``fused_root_loss_bwd`` kernel, one CUDA kernel and no
    scratch (counted in ``root_bwd.launches``)."""
    _check(p, t)
    if p.device.type == "cpu":
        return root_bwd_reference(p, t, scales)
    _check_cuda("fused_root_loss_bwd", p, t)
    if (scales.numel() != 2 or scales.dtype != torch.float32
            or scales.device != p.device or not scales.is_contiguous()):
        raise ValueError("scales must be 2 contiguous float32 on pred's device")
    bsz, h, w = p.shape
    dout = torch.empty_like(p)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        rc = _lib().fused_root_loss_bwd(p.data_ptr(), t.data_ptr(),
                                        scales.data_ptr(), dout.data_ptr(),
                                        bsz, h, w, C1, C2, stream)
    if rc != 0:
        raise RuntimeError(f"fused_root_loss_bwd launch failed: CUDA error {rc}")
    root_bwd.launches += 1
    return dout


root_bwd.launches = 0


def _as_bhw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if x.dim() == 4 and x.shape[1] == 1:
        x = x[:, 0]
    if x.dim() != 3:
        raise ValueError(f"expected [B,1,H,W] or [B,H,W], got {tuple(x.shape)}")
    return x.to(dtype).contiguous()


class _FusedRootLoss(torch.autograd.Function):
    """Saves ``p`` and ``t``, as the JAX VJP does; the backward's clip gate
    is per pixel and needs no forward partial."""

    @staticmethod
    def forward(ctx, pred, target, ssim_weight, l1_weight):
        dt = torch.promote_types(pred.dtype, torch.float32)
        p, t = _as_bhw(pred, dt), _as_bhw(target, dt)
        partials = root_partials(p, t)
        ctx.save_for_backward(p, t)
        ctx.weights = (ssim_weight, l1_weight)
        ctx.pred_meta = (pred.shape, pred.dtype)
        return (ssim_weight * partials[:, 0].sum()
                + l1_weight * partials[:, 1].sum()) / p.numel()

    @staticmethod
    def backward(ctx, g):
        p, t = ctx.saved_tensors
        ssim_weight, l1_weight = ctx.weights
        gf = g.to(p.dtype)
        scales = torch.stack([ssim_weight * gf / p.numel(),
                              l1_weight * gf / p.numel()]).contiguous()
        shape, dtype = ctx.pred_meta
        dpred = root_bwd(p, t, scales).reshape(shape).to(dtype)
        return dpred, None, None, None


def fused_root_loss(pred: torch.Tensor, target: torch.Tensor,
                    ssim_weight: float, l1_weight: float) -> torch.Tensor:
    """``ssim_weight * ssim + l1_weight * L1`` of ``pred`` and ``target``
    (``[B,1,H,W]`` or ``[B,H,W]``), fused, differentiable in ``pred``."""
    return _FusedRootLoss.apply(pred, target, ssim_weight, l1_weight)
