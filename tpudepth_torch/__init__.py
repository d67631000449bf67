"""tpudepth_torch: the PyTorch / CUDA port of tpudepth for NVIDIA Hopper.

The layout mirrors ``tpudepth`` (``core``, ``ops``, ``models``, ``train``,
``infer``, ``losses``, ``data``, ``eval``) so each module's counterpart is found by path. Modules work in
NCHW with ``torch.channels_last`` memory; parameters are float32 and are
cast to the compute dtype at use. Hand-written CUDA kernels live in
``csrc/`` and are built with ``nvcc`` on first use (``ops/kernels/_build``).

This package imports no JAX and nothing of ``tpudepth``: what it needs from
there it keeps as its own copy.
"""

from tpudepth_torch.losses.losses import DepthLoss
from tpudepth_torch.ops.kernels.fused_loss import fused_depth_loss
from tpudepth_torch.train.trainer import (
    LossRecipe,
    Trainer,
    TrainState,
    make_train_step,
)

__all__ = [
    "DepthLoss",
    "LossRecipe",
    "Trainer",
    "TrainState",
    "fused_depth_loss",
    "make_train_step",
]
