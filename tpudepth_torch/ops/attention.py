"""Windowed multi-head cross-attention over independent windows.

The port's counterpart of ``tpudepth/ops/attention.py``: the channel-packed
entry point of the SAM / NewCRF blocks and the two head-split compositions.

- :func:`window_cross_attention_xla`: everything in f32, the output rounded
  to the input dtype; what the JAX package computes on the CPU and the
  ``attn="plain"`` configuration of the port.
- :func:`window_cross_attention_fast`: products of input-dtype operands with
  f32 scores and softmax, the probabilities rounded to the input dtype; the
  arithmetic of the eval kernel ``window_attn_infer`` and its plain version.

The JAX package picks between them by backend and by whether a training
step is being traced; the port's caller says which it wants (``kernel=``).
"""

from __future__ import annotations

from typing import Optional

import torch


def to_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """[BW, N, C] -> [BW, heads, N, C // heads]."""
    bw, n, c = t.shape
    return t.reshape(bw, n, heads, c // heads).permute(0, 2, 1, 3)


def from_heads(t: torch.Tensor) -> torch.Tensor:
    """[BW, heads, N, D] -> [BW, N, heads * D]."""
    bw, h, n, d = t.shape
    return t.permute(0, 2, 1, 3).reshape(bw, n, h * d)


def _scores(q, k, bias, mask):
    """f32 scores ``q k^T + bias [+ mask]`` of head-split q, k; windows are
    [B, nW]-major, so window i takes ``mask[i % nW]``."""
    bw, heads, n, _ = q.shape
    s = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float())
    s = s + bias[None].float()
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(bw // nw, nw, heads, n, n)
             + mask[None, :, None].float()).reshape(bw, heads, n, n)
    return s


def _softmax(s: torch.Tensor) -> torch.Tensor:
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    return e / e.sum(dim=-1, keepdim=True)


def window_cross_attention_xla(q, k, v, bias, mask=None) -> torch.Tensor:
    """Head-split attention in f32 (q pre-scaled): q, k, v [BW, heads, N, D],
    bias [heads, N, N], mask None or [nW, N, N]. Returns q's dtype."""
    p = _softmax(_scores(q, k, bias, mask))
    return torch.einsum("bhnm,bhmd->bhnd", p, v.float()).to(q.dtype)


def window_cross_attention_fast(q, k, v, bias, mask=None) -> torch.Tensor:
    """As :func:`window_cross_attention_xla`, but the probabilities are
    rounded to the input dtype before ``p v`` (which sums in f32)."""
    p = _softmax(_scores(q, k, bias, mask)).to(q.dtype)
    return torch.einsum("bhnm,bhmd->bhnd", p.float(), v.float()).to(q.dtype)


def window_cross_attention_packed(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, bias: torch.Tensor,
                                  mask: Optional[torch.Tensor] = None, *,
                                  kernel: bool) -> torch.Tensor:
    """Channel-packed window attention: q, k, v and the output are
    [BW, N, C], C = heads * head_dim, q pre-scaled; bias [heads, N, N] f32.

    ``kernel=True`` is the eval kernel (``ops/kernels/window_attn_infer.py``;
    on CPU tensors its plain version); ``kernel=False`` splits heads and runs
    :func:`window_cross_attention_xla`."""
    if kernel:
        from tpudepth_torch.ops.kernels.window_attn_infer import (
            window_attention_infer,
        )

        return window_attention_infer(q, k, v, bias, mask)
    heads = bias.shape[0]
    out = window_cross_attention_xla(to_heads(q, heads), to_heads(k, heads),
                                     to_heads(v, heads), bias, mask)
    return from_heads(out)
