"""Space-to-depth "packed" execution of thin-channel conv stages (NCHW).

Own copy of ``tpudepth/ops/packed.py``. A ``[B, C, H, W]`` tensor is
represented as ``[B, by*bx*C, H/by, W/bx]`` with packed channel
``(sy*bx + sx)*C + c``: the sub-pixel position slowest and the original
channel fastest, the JAX package's order, so that a packed tensor of the
port is a packed tensor of the JAX package transposed to NCHW.
``torch.nn.functional.pixel_unshuffle`` puts the sub-pixel position
fastest (``c*by*bx + sy*bx + sx``) and is not used.

``block`` is an int (a square fold) or an ``(by, bx)`` pair. Every op is an
exact rearrangement of its unpacked counterpart: the same parameters, the
same products, another order of the sums. The packed tensors this module
returns are channels_last NCHW views of contiguous NHWC memory, the layout
the fused GUB conv kernels read without a copy.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

BlockSpec = Union[int, Tuple[int, int]]


def block_pair(block: BlockSpec) -> Tuple[int, int]:
    """``(by, bx)`` of a block spec; an int means a square fold."""
    if isinstance(block, (tuple, list)):
        by, bx = block
        return int(by), int(bx)
    return int(block), int(block)


def block_total(block: BlockSpec) -> int:
    by, bx = block_pair(block)
    return by * bx


def space_to_depth(x: torch.Tensor, block: BlockSpec = 2) -> torch.Tensor:
    """``[B,C,H,W]`` -> ``[B, by*bx*C, H/by, W/bx]``."""
    by, bx = block_pair(block)
    b, c, h, w = x.shape
    if h % by or w % bx:
        raise ValueError(f"{h}x{w} does not fold by {(by, bx)}")
    t = x.permute(0, 2, 3, 1).reshape(b, h // by, by, w // bx, bx, c)
    t = t.permute(0, 1, 3, 2, 4, 5).reshape(b, h // by, w // bx, by * bx * c)
    return t.permute(0, 3, 1, 2)


def depth_to_space(x: torch.Tensor, block: BlockSpec = 2) -> torch.Tensor:
    """The inverse of :func:`space_to_depth`."""
    by, bx = block_pair(block)
    b, cp, hp, wp = x.shape
    c = cp // (by * bx)
    t = x.permute(0, 2, 3, 1).reshape(b, hp, wp, by, bx, c)
    t = t.permute(0, 1, 3, 2, 4, 5).reshape(b, hp * by, wp * bx, c)
    return t.permute(0, 3, 1, 2)


def packed_concat(tensors: Sequence[torch.Tensor],
                  block: BlockSpec = 2) -> torch.Tensor:
    """Channel concat in packed layout: the packing of the concat of the
    unpacked tensors. The GUB takes a plain concat instead and re-indexes
    the consuming conv's weight (:func:`concat_input_perm`)."""
    b2 = block_total(block)
    parts = [t.reshape(t.shape[0], b2, t.shape[1] // b2, *t.shape[2:])
             for t in tensors]
    cat = torch.cat(parts, dim=2)
    return cat.reshape(cat.shape[0], -1, *cat.shape[3:])


@functools.lru_cache(maxsize=None)
def _concat_input_perm(splits: Tuple[int, ...], b2: int) -> np.ndarray:
    total = sum(splits)
    q = np.empty(b2 * total, np.int64)
    off_c = 0
    off_p = 0
    for cj in splits:
        for s in range(b2):
            q[s * total + off_c: s * total + off_c + cj] = (
                off_p + s * cj + np.arange(cj))
        off_c += cj
        off_p += b2 * cj
    q.setflags(write=False)
    return q


def concat_input_perm(splits: Sequence[int], block: BlockSpec) -> np.ndarray:
    """Permutation ``q`` with ``packed_concat(parts)[:, i] ==
    cat(parts)[:, q[i]]`` for packed parts of ``splits`` original channels
    each."""
    return _concat_input_perm(tuple(int(s) for s in splits),
                              block_total(block))


@functools.lru_cache(maxsize=None)
def _axis_pack_map(k: int, b: int) -> Tuple[np.ndarray, int]:
    """1D scatter map ``m[P, s, d, u]`` from an unpacked length-k tap ``u``
    between sub-positions ``s -> d`` to packed tap ``P``, and the packed
    zero padding that reproduces the unpacked conv's ``k//2``."""
    half = k // 2
    offs = [d + u - half for d in range(b) for u in range(k)]
    pmin = min(o // b for o in offs)
    pmax = max(o // b for o in offs)
    m = np.zeros((pmax - pmin + 1, b, b, k), np.float32)
    for d in range(b):
        for u in range(k):
            o = d + u - half
            m[o // b - pmin, o % b, d, u] = 1.0
    if -pmin != pmax and k != 1:
        raise ValueError(f"no symmetric packed padding for k={k}, b={b}")
    m.setflags(write=False)
    return m, -pmin


@functools.lru_cache(maxsize=None)
def _pack_map(k: int, by: int, bx: int) -> Tuple[np.ndarray, Tuple[int, int]]:
    """0/1 map ``M[P, Q, s, d, u, v]`` from an unpacked ``[k,k]`` tap
    ``(u, v)`` between sub-positions ``s = (sy,sx) -> d = (dy,dx)`` to
    packed tap ``(P, Q)``, and the packed padding ``(pad_y, pad_x)``."""
    my, pad_y = _axis_pack_map(k, by)
    mx, pad_x = _axis_pack_map(k, bx)
    m = np.einsum("Pswu,Qtxv->PQstwxuv", my, mx)
    m = m.reshape(my.shape[0], mx.shape[0], by * bx, by * bx, k, k)
    m.setflags(write=False)
    return m, (pad_y, pad_x)


@functools.lru_cache(maxsize=None)
def _pack_index(k: int, by: int, bx: int, cin: int, cout: int,
                splits: Optional[Tuple[int, ...]]) -> np.ndarray:
    """Where each entry of the packed OIHW kernel comes from: an index into
    the flattened unpacked OIHW kernel ``[cout*cin*k*k]``, or
    ``cout*cin*k*k`` for a zero. Each packed entry is one unpacked entry or
    zero (:func:`_pack_map` has at most one 1 per ``(P, Q, s, d)``), so the
    packed kernel is a rearrangement, exact whatever the matmul precision.
    With ``splits`` the input channels follow a plain concat of packed
    parts (the kernel's rows re-indexed by ``argsort(concat_input_perm)``)."""
    m, _ = _pack_map(k, by, bx)
    kp_y, kp_x, b2 = m.shape[0], m.shape[1], m.shape[2]
    nz = m.reshape(kp_y, kp_x, b2, b2, k * k)
    has = nz.any(-1).transpose(3, 2, 0, 1)        # [d, s, P, Q]
    uv = nz.argmax(-1).transpose(3, 2, 0, 1)
    o = np.arange(cout)[None, :, None, None, None, None]
    i = np.arange(cin)[None, None, None, :, None, None]
    src = o * (cin * k * k) + i * (k * k) + uv[:, None, :, None]
    idx = np.where(has[:, None, :, None], src, cout * cin * k * k)
    idx = idx.reshape(b2 * cout, b2 * cin, kp_y, kp_x)
    if splits is not None:
        idx = idx[:, np.argsort(_concat_input_perm(splits, b2))]
    idx = np.ascontiguousarray(idx)
    idx.setflags(write=False)
    return idx


@functools.lru_cache(maxsize=None)
def _pack_pairs_on(k: int, by: int, bx: int, cin: int, cout: int,
                   splits: Optional[Tuple[int, ...]],
                   device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The non-zero entries of :func:`_pack_index` as ``(pos, src)``: the
    flat position in the packed kernel and the flat index in the unpacked
    one, on ``device``, made once per shape (a host-to-device copy per call
    would stall the stream; an exported program holds them as constants).
    Made outside inference mode, so that a train step may save them for its
    backward after a served call made them."""
    flat = _pack_index(k, by, bx, cin, cout, splits).reshape(-1)
    pos = np.flatnonzero(flat < cout * cin * k * k)
    with torch.inference_mode(False):
        return (torch.tensor(pos, device=device),
                torch.tensor(flat[pos], device=device))


def pack_conv_kernel(w: torch.Tensor, block: BlockSpec = 2,
                     input_splits: Optional[Sequence[int]] = None
                     ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """The packed OIHW kernel ``[b2*Cout, b2*Cin, kp_y, kp_x]`` of an
    unpacked OIHW kernel ``[Cout, Cin, k, k]``, and its padding, so that

        conv(x, w, pad=k//2) == depth_to_space(conv(space_to_depth(x), wp, pad))

    exactly. It is built from ``w`` on every call, inside autograd, so the
    gradient reaches ``w``: zeros with the ``b2`` copies of each weight put
    in place. Only the non-zero entries are indexed (a 256-channel kernel
    is 15/16 zeros), so the gradient of the gather sums ``b2`` entries an
    index. ``input_splits``: the packed input is a plain concat of packed
    parts with these original channel counts."""
    by, bx = block_pair(block)
    cout, cin, k, _ = w.shape
    splits = None if input_splits is None else tuple(int(s)
                                                     for s in input_splits)
    pos, src = _pack_pairs_on(k, by, bx, cin, cout, splits, w.device)
    m, pads = _pack_map(k, by, bx)
    b2, kp_y, kp_x = by * bx, m.shape[0], m.shape[1]
    wp = w.new_zeros(b2 * cout * b2 * cin * kp_y * kp_x).index_put(
        (pos,), w.reshape(-1)[src])
    return wp.view(b2 * cout, b2 * cin, kp_y, kp_x), pads


def packed_conv(x: torch.Tensor, w: torch.Tensor,
                block: BlockSpec = 2) -> torch.Tensor:
    """Packed-space conv equal to ``conv(unpacked x, w, pad=k//2)``."""
    wp, pads = pack_conv_kernel(w, block)
    return torch.nn.functional.conv2d(x, wp.to(x.dtype), padding=pads)


def tile_channel(v: torch.Tensor, block: BlockSpec = 2) -> torch.Tensor:
    """A per-original-channel ``[..., C]`` tiled to packed channels
    ``[..., b2*C]``."""
    return v.repeat(*([1] * (v.dim() - 1)), block_total(block))


def packed_channel_mean(x: torch.Tensor, block: BlockSpec = 2) -> torch.Tensor:
    """Spatial mean per ORIGINAL channel of a packed tensor: ``[B, C]``,
    the unpacked ``mean(dim=(2, 3))``."""
    y = x.mean(dim=(2, 3))
    return y.reshape(y.shape[0], block_total(block), -1).mean(dim=1)


def _shift(t: torch.Tensor, dim: int, direction: int) -> torch.Tensor:
    """Edge-clamped shift by one along ``dim``: the previous line
    (``direction < 0``) or the next one."""
    n = t.shape[dim]
    if direction < 0:
        return torch.cat([t.narrow(dim, 0, 1), t.narrow(dim, 0, n - 1)], dim)
    return torch.cat([t.narrow(dim, 1, n - 1), t.narrow(dim, n - 1, 1)], dim)


def _axis_up_taps(x: torch.Tensor, dim: int, b: int):
    """The ``b`` per-sub-position lines of exact-2x bilinear upsampling
    along ``dim`` folded by ``b``: even ``0.25*prev + 0.75*x``, odd
    ``0.75*x + 0.25*next``, edges clamped on the original grid (JAX's
    ``_axis_up_taps``). Fine line ``Q*b + t`` reads source line
    ``Q*(b/2) + t//2``, so the sources split into ``b/2`` interleaved
    groups."""
    if b == 1:
        raise ValueError("upsample2x output folded by 1 is not packed")
    if b == 2:
        return [0.25 * _shift(x, dim, -1) + 0.75 * x,
                0.75 * x + 0.25 * _shift(x, dim, +1)]
    if b % 2:
        raise ValueError(f"fold {b} is not even")
    g = b // 2
    n = x.shape[dim]
    if n % g:
        raise ValueError(f"{n} lines do not split into {g} groups")
    shp = list(x.shape)
    shp[dim:dim + 1] = [n // g, g]
    xg = x.reshape(shp)
    groups = [xg.select(dim + 1, j) for j in range(g)]
    m = groups[0].shape[dim]
    outs = []
    for t in range(b):
        j = t // 2
        if t % 2 == 0:
            if j > 0:
                prev = groups[j - 1]
            else:   # the last group's line before; clamped at the top
                prev = torch.cat([groups[0].narrow(dim, 0, 1),
                                  groups[g - 1].narrow(dim, 0, m - 1)], dim)
            outs.append(0.25 * prev + 0.75 * groups[j])
        else:
            if j < g - 1:
                nxt = groups[j + 1]
            else:   # the first group's line after; clamped at the bottom
                nxt = torch.cat([groups[0].narrow(dim, 1, m - 1),
                                 groups[g - 1].narrow(dim, m - 1, 1)], dim)
            outs.append(0.75 * groups[j] + 0.25 * nxt)
    return outs


def upsample2x_pack(x: torch.Tensor, block: BlockSpec) -> torch.Tensor:
    """``space_to_depth(resize_bilinear(x, 2x), block)`` without making the
    upsampled tensor: ``[B,C,H,W]`` -> ``[B, by*bx*C, 2H/by, 2W/bx]``,
    ``by``, ``bx`` even. Channel order ``(sy*bx + sx)*C + c``.

    Computed on the NHWC view, as the JAX package computes it, so every
    intermediate and the result are NHWC in memory whatever the strides
    of the lines it selects: an exported program lays them out as the
    eager call does, and the fused GUB kernels read the result as it is."""
    by, bx = block_pair(block)
    outs = []
    for r in _axis_up_taps(x.permute(0, 2, 3, 1), 1, by):
        outs.extend(_axis_up_taps(r, 2, bx))
    return torch.cat(outs, dim=3).to(x.dtype).permute(0, 3, 1, 2)


def upsample2x_packed(x: torch.Tensor) -> torch.Tensor:
    """:func:`upsample2x_pack` with block 2."""
    return upsample2x_pack(x, 2)


def upsample2x_pack4(x: torch.Tensor) -> torch.Tensor:
    """:func:`upsample2x_pack` with block 4."""
    return upsample2x_pack(x, 4)
