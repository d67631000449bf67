"""Dataset tables (max depth, model input resolution and evaluation crop per
dataset) and the training and evaluation configurations.

Own copy of ``tpudepth/core/config.py``
(``src/GuideDepth/training.py:13-16``, ``src/GuideDepth/evaluate.py:14-79``,
``src/test.py:30-37,119``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# Dataset max depth in meters.
MAX_DEPTHS = {
    "kitti": 80.0,
    "nyu": 10.0,
    "nyu_reduced": 10.0,
}

_NYU_RES = {
    "full": (480, 640),
    "half": (240, 320),
    "mini": (224, 224),
}
_KITTI_RES = {
    "full": (384, 1280),
    "tu_small": (128, 416),
    "tu_big": (228, 912),
    "half": (192, 640),
}
RESOLUTIONS = {
    "nyu": _NYU_RES,
    "nyu_reduced": _NYU_RES,
    "kitti": _KITTI_RES,
}

# Eigen-style eval crops [top, bottom, left, right]
# (src/GuideDepth/evaluate.py:32-35).
CROPS = {
    "kitti": (128, 381, 45, 1196),
    "nyu": (20, 460, 24, 616),
    "nyu_reduced": (20, 460, 24, 616),
}


def garg_crop(height: int, width: int) -> Tuple[int, int, int, int]:
    """Fractional Garg/Eigen crop of the root evaluator (``src/test.py:119``):
    ``[0.09375*H, 0.98125*H, 0.0640625*W, 0.9390625*W]`` floored to int."""
    return (
        int(0.09375 * height),
        int(0.98125 * height),
        int(0.0640625 * width),
        int(0.9390625 * width),
    )


def kitti_alhashim_crop(height: int, width: int) -> Tuple[int, int, int, int]:
    """KITTI crop of the GuideDepth evaluator
    (``src/GuideDepth/evaluate.py:123-124``): float64 products truncated to
    int32, as numpy's ``astype`` does there."""
    arr = np.array(
        [0.3324324 * height, 0.91351351 * height, 0.0359477 * width,
         0.96405229 * width]
    ).astype(np.int32)
    return tuple(int(v) for v in arr)


def image_size(dataset: str, resolution: str) -> Tuple[int, int]:
    """(H, W) of the model input for ``dataset`` at ``resolution``."""
    return RESOLUTIONS[dataset][resolution]


@dataclasses.dataclass
class TrainConfig:
    """Training configuration.

    Defaults follow the GuideDepth trainer (``src/GuideDepth/main.py:72-87``:
    bs 8, lr 1e-4, 20 epochs, StepLR(15, 0.1)). ``batch_size`` is the
    global batch; ``num_data_shards`` is the data axis (0: every rank of
    the process group; otherwise it must equal the world size,
    ``core/mesh.py::create_mesh``). ``remat`` rematerializes the whole
    forward in the backward, and ``remat_stages`` each GUB stage of the
    GuideDepth family
    (``tpudepth/core/config.py:103-107``; ``models/layers.py::
    rematerialize``).
    """

    model: str = "GuideDepth"
    dataset: str = "nyu_reduced"
    resolution: str = "half"
    epochs: int = 20
    batch_size: int = 8
    learning_rate: float = 1e-4
    scheduler_step_size: int = 15
    scheduler_gamma: float = 0.1
    eval_mode: str = "alhashim"  # 'alhashim' -> DepthLoss(0.1, 1, 1); else (1, 0, 0)
    data_path: str = "CSVdata.zip"
    checkpoint_dir: str = "./checkpoints"
    results_dir: str = "./results"
    load_checkpoint: str = ""
    seed: int = 0
    compute_dtype: str = "bfloat16"
    num_data_shards: int = 0  # 0 => all
    log_every: int = 5
    image_log_every: int = 300
    remat: bool = False  # rematerialize the whole forward (memory lever)
    # per-GUB-stage rematerialization (GuideDepth family): keep only the
    # stage inputs for the backward, run each stage again there
    remat_stages: bool = False
    # opt-in tripwire: a non-finite gradient norm turns the reported loss
    # into NaN, on the device and without a host sync
    check_grads: bool = False

    @property
    def max_depth(self) -> float:
        return MAX_DEPTHS[self.dataset]

    @property
    def image_size(self) -> Tuple[int, int]:
        return RESOLUTIONS[self.dataset][self.resolution]


@dataclasses.dataclass
class EvalConfig:
    """Evaluation configuration (``src/test.py:30-37`` and
    ``src/GuideDepth/evaluate.py:37-79``)."""

    model: str = "GuideDepth"
    dataset: str = "nyu_reduced"
    resolution: str = "half"
    eval_mode: str = "alhashim"
    batch_size: int = 6
    checkpoint: str = "./checkpoints/global_checkpoint.pth"
    min_depth_eval: float = 1e-3
    max_depth_eval: float = 80.0
    data_path: str = "CSVdata.zip"
    results_dir: str = "./results"
    flip_tta: bool = True
    compute_dtype: str = "bfloat16"

    @property
    def max_depth(self) -> float:
        return MAX_DEPTHS[self.dataset]

    @property
    def image_size(self) -> Tuple[int, int]:
        return RESOLUTIONS[self.dataset][self.resolution]

    @property
    def crop(self) -> Tuple[int, int, int, int]:
        return CROPS[self.dataset]
