"""Training augmentations on the device, inside the train step.

Counterpart of ``tpudepth/data/augment.py`` (``getDefaultTrainTransform``,
``src/data.py:162-168``): per sample a horizontal flip with p = 0.5 on image
and depth, and with p = 0.5 a uniformly drawn RGB permutation (the identity
included). NCHW.
"""

from __future__ import annotations

from itertools import permutations
from typing import Optional, Tuple

import torch

# list(permutations(range(3))): the reference's table, in its order
_PERMS = tuple(permutations(range(3)))


def draw_decisions(generator: Optional[torch.Generator], b: int,
                   device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(do_flip, do_swap, perm_idx)`` of a batch of ``b``, drawn from
    ``generator`` in :func:`augment_batch`'s order. A data-parallel step
    draws them for the global batch on every rank and keeps its rows, as
    JAX draws the global batch's from one key."""
    do_flip = torch.rand(b, device=device, generator=generator) < 0.5
    do_swap = torch.rand(b, device=device, generator=generator) < 0.5
    perm_idx = torch.randint(0, len(_PERMS), (b,), device=device,
                             generator=generator)
    return do_flip, do_swap, perm_idx


def augment_batch(
    generator: Optional[torch.Generator],
    image: torch.Tensor,
    depth: torch.Tensor,
    *,
    do_flip: Optional[torch.Tensor] = None,
    do_swap: Optional[torch.Tensor] = None,
    perm_idx: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample random flip and channel swap of ``image`` ``[B,3,H,W]`` and
    ``depth`` ``[B,1,H,W]``.

    The decisions (``do_flip`` and ``do_swap`` bool ``[B]``, ``perm_idx``
    integers ``[B]`` into the permutation table) are drawn from ``generator``
    (a ``torch.Generator`` on the batch's device) unless they are passed in.
    """
    b, dev = image.shape[0], image.device
    if do_flip is None or do_swap is None or perm_idx is None:
        drawn = draw_decisions(generator, b, dev)
        do_flip = drawn[0] if do_flip is None else do_flip
        do_swap = drawn[1] if do_swap is None else do_swap
        perm_idx = drawn[2] if perm_idx is None else perm_idx
    do_flip, do_swap = do_flip.to(dev), do_swap.to(dev)
    flip = do_flip[:, None, None, None]
    image = torch.where(flip, image.flip(3), image)
    depth = torch.where(flip, depth.flip(3), depth)

    perms = torch.tensor(_PERMS, device=dev)[perm_idx.to(dev)]  # [b, 3]
    swapped = torch.gather(
        image, 1, perms[:, :, None, None].expand(-1, -1, *image.shape[2:]))
    image = torch.where(do_swap[:, None, None, None], swapped, image)
    return image, depth
