"""Windowing for the SAM / NewCRF attention decoders, on NHWC tensors.

The port's own copy of ``tpudepth/ops/window.py``: torch-order window
partition and reverse (``src/SAM.py:30-59``), the Swin relative position
index, the shifted-window mask and the valid-token mask (numpy, built once
per shape), and the bottom/right zero padding to window multiples.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def window_partition(x: torch.Tensor, window_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nH * nW, ws, ws, C), row-major window order."""
    b, h, w, c = x.shape
    ws = window_size
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c)


def window_reverse(windows: torch.Tensor, window_size: int, h: int,
                   w: int) -> torch.Tensor:
    """Inverse of :func:`window_partition`."""
    ws = window_size
    c = windows.shape[-1]
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, c).permute(
        0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


@functools.lru_cache(maxsize=None)
def relative_position_index(window_size: int) -> np.ndarray:
    """[N, N] int indices into the (2*ws-1)^2 relative-position bias table
    (the Swin construction, ``src/SAM.py:90-99``)."""
    ws = window_size
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1).astype(np.int64)


@functools.lru_cache(maxsize=None)
def shifted_window_attention_mask(h: int, w: int, window_size: int,
                                  shift_size: int) -> Optional[np.ndarray]:
    """[nW, N, N] additive mask (0 / -100) of shifted-window attention after
    the cyclic shift, on the map padded to window multiples
    (``src/newcrf_layers.py:331-350``); None when ``shift_size == 0``."""
    if shift_size == 0:
        return None
    ws = window_size
    hp = -(-h // ws) * ws
    wp = -(-w // ws) * ws
    img = np.zeros((hp, wp), dtype=np.float32)
    slices = (slice(0, -ws), slice(-ws, -shift_size), slice(-shift_size, None))
    cnt = 0
    for hs in slices:
        for wsl in slices:
            img[hs, wsl] = cnt
            cnt += 1
    m = img.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3)
    m = m.reshape(-1, ws * ws)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def window_valid_mask(h: int, w: int, window_size: int,
                      shift_size: int = 0) -> Optional[np.ndarray]:
    """[nW, N] 1/0 mask of the window tokens that are real (not bottom/right
    padding), after the optional cyclic shift; None without padding."""
    ws = window_size
    hp = -(-h // ws) * ws
    wp = -(-w // ws) * ws
    if hp == h and wp == w:
        return None
    valid = np.zeros((hp, wp), dtype=np.float32)
    valid[:h, :w] = 1.0
    if shift_size:
        valid = np.roll(valid, (-shift_size, -shift_size), axis=(0, 1))
    m = valid.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3)
    return m.reshape(-1, ws * ws)


@functools.lru_cache(maxsize=None)
def window_valid_mask_on(h: int, w: int, window_size: int, shift_size: int,
                         device: torch.device) -> Optional[torch.Tensor]:
    """:func:`window_valid_mask` as a float32 tensor on ``device``, made
    once per shape (so that a captured CUDA graph copies nothing from the
    host); None without padding."""
    m = window_valid_mask(h, w, window_size, shift_size)
    return None if m is None else torch.from_numpy(m).to(device)


def pad_to_window_multiple(x: torch.Tensor, window_size: int
                           ) -> Tuple[torch.Tensor, int, int]:
    """Zero-pad NHWC at the bottom and right to window multiples
    (``src/SAM.py:214-219``). Returns ``(x, Hp, Wp)``."""
    _, h, w, _ = x.shape
    ws = window_size
    pad_b = (ws - h % ws) % ws
    pad_r = (ws - w % ws) % ws
    if pad_b or pad_r:
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
    return x, h + pad_b, w + pad_r
