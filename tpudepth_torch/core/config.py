"""Dataset tables (max depth and model input resolution per dataset) and the
training configuration.

Own copy of ``tpudepth/core/config.py:18-40,75-119``
(``src/GuideDepth/training.py:13-16``, ``src/GuideDepth/evaluate.py:19-27``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

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


def image_size(dataset: str, resolution: str) -> Tuple[int, int]:
    """(H, W) of the model input for ``dataset`` at ``resolution``."""
    return RESOLUTIONS[dataset][resolution]


@dataclasses.dataclass
class TrainConfig:
    """Training configuration.

    Defaults follow the GuideDepth trainer (``src/GuideDepth/main.py:72-87``:
    bs 8, lr 1e-4, 20 epochs, StepLR(15, 0.1)). The JAX package's mesh and
    rematerialization knobs (``num_data_shards``, ``remat``, ``remat_stages``)
    are left out: the port trains on one device and stores every activation.
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
    log_every: int = 5
    image_log_every: int = 300
    # opt-in tripwire: a non-finite gradient norm turns the reported loss
    # into NaN, on the device and without a host sync
    check_grads: bool = False

    @property
    def max_depth(self) -> float:
        return MAX_DEPTHS[self.dataset]

    @property
    def image_size(self) -> Tuple[int, int]:
        return RESOLUTIONS[self.dataset][self.resolution]
