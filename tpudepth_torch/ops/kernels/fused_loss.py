"""Fused alhashim depth loss: ``alpha*L1 + beta*clip((1-SSIM)/2, 0, 1) +
gamma*gradient`` with an analytic backward, float32 throughout.

Counterpart of ``tpudepth/ops/pallas/fused_loss.py``. The kernels are in
``tpudepth_torch/csrc/fused_loss.cu`` (CUDA C++ for ``sm_90a``, built by
``_build``); its header says how they are laid out and what bounds them.

- :func:`fused_partials` (kernel ``fused_loss_fwd``): per image the three
  sums ``[sum|p-t|, sum SSIM map, sum of x/y forward-difference terms]``;
- :func:`fused_bwd` (kernel ``fused_loss_bwd``): ``dL/dp`` from ``p``, ``t``
  and the three scales of the terms;
- :func:`fused_depth_loss`: the ``torch.autograd.Function`` over both, with
  ``_combine`` and the scales as tensor code on the device (no host sync).

Each wrapper runs its plain version (``*_reference``) for CPU tensors only;
on a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpudepth_torch.ops.kernels import _build

_WS = 11
_HALF = _WS // 2


@functools.lru_cache(maxsize=None)
def _gauss_taps(window_size: int = _WS, sigma: float = 1.5) -> Tuple[float, ...]:
    """The normalized gaussian window, rounded to float32."""
    g = np.array([math.exp(-((i - window_size // 2) ** 2) / (2.0 * sigma ** 2))
                  for i in range(window_size)], dtype=np.float64)
    g = g / g.sum()
    return tuple(float(v) for v in g.astype(np.float32))


def _constants(max_depth: float) -> Tuple[float, float]:
    return (0.01 * max_depth) ** 2, (0.03 * max_depth) ** 2


def _gconv(x: torch.Tensor) -> torch.Tensor:
    """Zero-padded SAME separable 11-tap gaussian over the last two dims:
    down the columns, then along the rows, tap 0 first and taps 1..10 added
    in order (the order of the kernel and of the Pallas kernel)."""
    taps = _gauss_taps()
    h, w = x.shape[-2:]
    xp = F.pad(x, (0, 0, _HALF, _HALF))
    acc = taps[0] * xp[..., 0:h, :]
    for k in range(1, _WS):
        acc = acc + taps[k] * xp[..., k:k + h, :]
    xp = F.pad(acc, (_HALF, _HALF))
    acc = taps[0] * xp[..., 0:w]
    for k in range(1, _WS):
        acc = acc + taps[k] * xp[..., k:k + w]
    return acc


def _ssim_terms(p: torch.Tensor, t: torch.Tensor, max_depth: float):
    """``(mu1, mu2, N1, D1, N2, D2)`` of the SSIM map."""
    c1, c2 = _constants(max_depth)
    m1, m2, e11, e22, e12 = _gconv(torch.stack([p, t, p * p, t * t, p * t]))
    s11 = e11 - m1 * m1
    s22 = e22 - m2 * m2
    s12 = e12 - m1 * m2
    n1 = 2.0 * m1 * m2 + c1
    d1 = m1 * m1 + m2 * m2 + c1
    n2 = 2.0 * s12 + c2
    d2 = s11 + s22 + c2
    return m1, m2, n1, d1, n2, d2


def _check(p: torch.Tensor, t: torch.Tensor):
    if p.dim() != 3 or p.shape != t.shape:
        raise ValueError(f"pred {tuple(p.shape)} and target {tuple(t.shape)} "
                         "must both be [B,H,W]")
    if p.dtype != torch.float32 or t.dtype != torch.float32:
        raise TypeError("the fused loss takes float32")
    if p.device != t.device:
        raise ValueError(f"pred on {p.device}, target on {t.device}")


def fused_partials_reference(p: torch.Tensor, t: torch.Tensor,
                             max_depth: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_partials`: ``[B,3]`` float32."""
    _check(p, t)
    _, _, n1, d1, n2, d2 = _ssim_terms(p, t, max_depth)
    ssim_map = (n1 * n2) / (d1 * d2)
    gx = ((t[:, :, 1:] - t[:, :, :-1]) - (p[:, :, 1:] - p[:, :, :-1])).abs()
    gy = ((t[:, 1:, :] - t[:, :-1, :]) - (p[:, 1:, :] - p[:, :-1, :])).abs()
    return torch.stack([(p - t).abs().sum(dim=(1, 2)),
                        ssim_map.sum(dim=(1, 2)),
                        gx.sum(dim=(1, 2)) + gy.sum(dim=(1, 2))], dim=1)


def fused_bwd_reference(p: torch.Tensor, t: torch.Tensor, max_depth: float,
                        scales: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_bwd`: the analytic ``dL/dp``
    ``[B,H,W]`` (``tpudepth/ops/pallas/fused_loss.py:189-266``). With
    ``R = 1/(D1*D2)`` and ``M = N1*N2*R`` the coefficient maps are
    ``Cmu1 = 2*mu2*R*(N2-N1) - 2*mu1*M*(1/D1 - 1/D2)``, ``Ce11 = -M/D2``,
    ``Ce12 = 2*N1*R``, and ``d(sum SSIM)/dp = g(Cmu1) + g(Ce11)*2p +
    g(Ce12)*t`` with ``g`` the same zero-padded gaussian."""
    _check(p, t)
    s_l1, s_ssim, s_grad = scales.reshape(3).unbind()
    d = s_l1 * torch.sign(p - t)

    sx = torch.sign((t[:, :, 1:] - t[:, :, :-1]) - (p[:, :, 1:] - p[:, :, :-1]))
    d = d + s_grad * (F.pad(sx, (0, 1)) - F.pad(sx, (1, 0)))
    sy = torch.sign((t[:, 1:, :] - t[:, :-1, :]) - (p[:, 1:, :] - p[:, :-1, :]))
    d = d + s_grad * (F.pad(sy, (0, 0, 0, 1)) - F.pad(sy, (0, 0, 1, 0)))

    m1, m2, n1, d1, n2, d2 = _ssim_terms(p, t, max_depth)
    r = 1.0 / (d1 * d2)
    m = n1 * n2 * r
    cmu1 = 2.0 * m2 * r * (n2 - n1) - 2.0 * m1 * m * (1.0 / d1 - 1.0 / d2)
    ce11 = -m / d2
    ce12 = 2.0 * n1 * r
    g0, g1, g2 = _gconv(torch.stack([cmu1, ce11, ce12]))
    return d + s_ssim * (g0 + g1 * 2.0 * p + g2 * t)


def tolerance(p: torch.Tensor, t: torch.Tensor, max_depth: float) -> dict:
    """Tolerances of the kernels against the plain versions on these inputs,
    from the arithmetic and not from a run.

    Both do the same float32 operations in the same order, except that the
    kernel's gaussian taps are fused multiply-adds (one rounding where the
    plain version has two) and that sums over pixels are taken in another
    order. With ``u = 2**-24``, each of the 22 taps of a statistic can differ
    by one rounding of a partial sum, so ``e11``, ``e22``, ``e12`` and the
    squares of the means each differ by up to ``22*u*E`` with
    ``E = g(p*p) + g(t*t)``. The variances ``e11 - mu1**2`` cancel, so these
    errors stay absolute in ``N2`` and ``D2`` (six such terms: ``132*u*E``)
    and move one SSIM value, ``|N1/D1| <= 1`` and ``|N2/D2| <= 1``, by up to
    ``kappa = 132*u*E/D2`` per factor. For ``depth_norm`` targets in
    [1, 100] and ``C2 = 0.09`` that is ~1e-5 where the images vary and up to
    ~1e-1 on a flat patch of the largest values.

    - ``partials_rtol``: the L1 and gradient sums are sums of equal terms in
      another order; 1e-5 is far above ``sqrt(N)*u``;
    - ``ssim_atol`` ``[B]``: ``2*sum(kappa)`` over the image, plus ``1e-5*N``
      for the order of the sum;
    - ``grad_atol`` ``[B,H,W]``, in units of ``|scales[1]|``: the coefficient
      maps hold up to four factors of ``N2`` or ``D2``, so each differs by up
      to ``4*kappa`` of the sum of its terms' magnitudes; that goes through
      the gaussian with the adjoint's own factors ``1, 2|p|, |t|``, plus
      ``8*22*u`` of the same magnitudes for the taps of the adjoint pass. The
      sign terms are exact; ``grad_rtol`` covers the last additions."""
    u = 2.0 ** -24
    m1, m2, n1, d1, n2, d2 = _ssim_terms(p, t, max_depth)
    kappa = 132.0 * u * _gconv(p * p + t * t) / d2
    n = p.shape[-1] * p.shape[-2]
    r = 1.0 / (d1 * d2)
    m = (n1 * n2 * r).abs()
    mags = torch.stack([
        2.0 * m2.abs() * r * (n2.abs() + n1.abs())
        + 2.0 * m1.abs() * m * (1.0 / d1 + 1.0 / d2),
        m / d2,
        2.0 * n1.abs() * r])
    factors = torch.stack([torch.ones_like(p), 2.0 * p.abs(), t.abs()])
    grad_atol = (factors * _gconv(mags * (4.0 * kappa + 8 * 22 * u))).sum(0)
    return {"partials_rtol": 1e-5,
            "ssim_atol": 2.0 * kappa.sum(dim=(1, 2)) + 1e-5 * n,
            "grad_atol": grad_atol, "grad_rtol": 1e-5}


_VP, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: ctypes signature of each C entry of ``csrc/fused_loss.cu``; the 11 taps
#: go as a pointer to host floats (a ctypes array)
ARGTYPES = {
    "fused_loss_fwd_tile": (ctypes.POINTER(_I32),),
    "fused_loss_fwd": (_VP,) * 4 + (_I32,) * 4 + (_F32,) * 2 + (_VP, _VP),
    "fused_loss_bwd": (_VP,) * 4 + (_I32,) * 3 + (_F32,) * 2 + (_VP, _VP),
}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_loss")
    for fn, types in ARGTYPES.items():
        getattr(lib, fn).argtypes = list(types)
        getattr(lib, fn).restype = _I32
    return lib


def _check_cuda(p: torch.Tensor, t: torch.Tensor):
    if p.device.type != "cuda":
        raise ValueError(f"no fused loss kernel for {p.device}")
    if not (p.is_contiguous() and t.is_contiguous()):
        raise ValueError("pred and target must be contiguous [B,H,W]")


def _c_taps():
    return (ctypes.c_float * _WS)(*_gauss_taps())


@functools.lru_cache(maxsize=None)
def _fwd_tile() -> Tuple[int, int]:
    tile = (_I32 * 2)()
    _lib().fused_loss_fwd_tile(tile)
    return tile[0], tile[1]


def fwd_scratch_words(bsz: int, h: int, w: int, tile: Tuple[int, int]) -> int:
    """32-bit words of the forward's scratch for ``[bsz,h,w]`` inputs and its
    output tile ``(rows, columns)``: every block's three sums, then one
    ticket counter an image, which the C entry zeroes."""
    blocks = -(-h // tile[0]) * -(-w // tile[1])
    return bsz * blocks * 3 + bsz


def fused_partials(p: torch.Tensor, t: torch.Tensor,
                   max_depth: float) -> torch.Tensor:
    """Per-image partial sums ``[B,3]`` of ``p``, ``t`` ``[B,H,W]`` float32.

    CPU tensors run :func:`fused_partials_reference`; CUDA tensors launch the
    ``fused_loss_fwd`` kernel, one CUDA kernel (counted in
    ``fused_partials.launches``). The kernel's result repeats bit for bit
    from run to run."""
    if p.device.type == "cpu":
        return fused_partials_reference(p, t, max_depth)
    _check(p, t)
    _check_cuda(p, t)
    bsz, h, w = p.shape
    words = fwd_scratch_words(bsz, h, w, _fwd_tile())
    scratch = torch.empty(words, dtype=torch.float32, device=p.device)
    out = torch.empty((bsz, 3), dtype=torch.float32, device=p.device)
    c1, c2 = _constants(max_depth)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        rc = _lib().fused_loss_fwd(p.data_ptr(), t.data_ptr(),
                                   scratch.data_ptr(), out.data_ptr(), bsz, h,
                                   w, words, c1, c2, _c_taps(), stream)
    if rc != 0:
        raise RuntimeError(f"fused_loss_fwd launch failed: CUDA error {rc}")
    fused_partials.launches += 1
    return out


fused_partials.launches = 0


def fused_bwd(p: torch.Tensor, t: torch.Tensor, max_depth: float,
              scales: torch.Tensor) -> torch.Tensor:
    """``dL/dp`` ``[B,H,W]`` from ``p``, ``t`` and ``scales`` (3 float32 on
    the inputs' device: the factors of the L1, SSIM and gradient terms).

    CPU tensors run :func:`fused_bwd_reference`; CUDA tensors launch the
    ``fused_loss_bwd`` kernel, one CUDA kernel and no scratch (counted in
    ``fused_bwd.launches``)."""
    if p.device.type == "cpu":
        return fused_bwd_reference(p, t, max_depth, scales)
    _check(p, t)
    _check_cuda(p, t)
    if (scales.numel() != 3 or scales.dtype != torch.float32
            or scales.device != p.device or not scales.is_contiguous()):
        raise ValueError("scales must be 3 contiguous float32 on pred's device")
    bsz, h, w = p.shape
    dout = torch.empty_like(p)
    c1, c2 = _constants(max_depth)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        rc = _lib().fused_loss_bwd(p.data_ptr(), t.data_ptr(),
                                   scales.data_ptr(), dout.data_ptr(), bsz, h,
                                   w, c1, c2, _c_taps(), stream)
    if rc != 0:
        raise RuntimeError(f"fused_loss_bwd launch failed: CUDA error {rc}")
    fused_bwd.launches += 1
    return dout


fused_bwd.launches = 0


def _combine(partials: torch.Tensor, n_pixels: int, alpha: float, beta: float,
             gamma: float) -> torch.Tensor:
    total = partials.shape[0] * n_pixels
    l1 = partials[:, 0].sum() / total
    ssim_mean = partials[:, 1].sum() / total
    grad = partials[:, 2].sum() / total
    l_ssim = torch.clamp((1.0 - ssim_mean) * 0.5, 0.0, 1.0)
    return alpha * l1 + beta * l_ssim + gamma * grad


def _scales(partials: torch.Tensor, n_pixels: int, alpha: float, beta: float,
            gamma: float, g: torch.Tensor) -> torch.Tensor:
    """The three factors of ``dL/dp`` for the upstream gradient ``g``. The
    clip passes a gradient only strictly inside (0, 1)."""
    total = partials.shape[0] * n_pixels
    pre = (1.0 - partials[:, 1].sum() / total) * 0.5
    gate = ((pre > 0.0) & (pre < 1.0)).to(torch.float32)
    gf = g.to(torch.float32)
    return torch.stack([alpha * gf / total,
                        beta * gf * (-0.5) * gate / total,
                        gamma * gf / total])


def _as_bhw(x: torch.Tensor) -> torch.Tensor:
    if x.dim() == 4 and x.shape[1] == 1:
        x = x[:, 0]
    if x.dim() != 3:
        raise ValueError(f"expected [B,1,H,W] or [B,H,W], got {tuple(x.shape)}")
    return x.to(torch.float32).contiguous()


class _FusedDepthLoss(torch.autograd.Function):
    """The backward keeps the forward's partials for the clip gate (the JAX
    VJP recomputes them because it saves only ``pred`` and ``target``)."""

    @staticmethod
    def forward(ctx, pred, target, alpha, beta, gamma, max_depth):
        p, t = _as_bhw(pred), _as_bhw(target)
        partials = fused_partials(p, t, max_depth)
        ctx.save_for_backward(p, t, partials)
        ctx.args = (alpha, beta, gamma, max_depth)
        ctx.pred_meta = (pred.shape, pred.dtype)
        return _combine(partials, p.shape[1] * p.shape[2], alpha, beta, gamma)

    @staticmethod
    def backward(ctx, g):
        p, t, partials = ctx.saved_tensors
        alpha, beta, gamma, max_depth = ctx.args
        scales = _scales(partials, p.shape[1] * p.shape[2], alpha, beta,
                         gamma, g)
        shape, dtype = ctx.pred_meta
        dpred = fused_bwd(p, t, max_depth, scales).reshape(shape).to(dtype)
        return dpred, None, None, None, None, None


def fused_depth_loss(pred: torch.Tensor, target: torch.Tensor, alpha: float,
                     beta: float, gamma: float,
                     max_depth: float) -> torch.Tensor:
    """Fused alhashim ``DepthLoss(alpha, beta, gamma)`` of ``pred`` and
    ``target`` (``[B,1,H,W]`` or ``[B,H,W]``), differentiable in ``pred``."""
    return _FusedDepthLoss.apply(pred, target, alpha, beta, gamma, max_depth)
