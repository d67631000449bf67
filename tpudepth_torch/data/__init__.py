"""The data feed of the port: the zip datasets, their loaders, the native
decoder and the disk cache (``nyu``, ``datasets``, ``native``,
``diskcache``, ``synthetic``), and the train step's device-side
augmentation (``augment``). Exported under the JAX package's names."""

from tpudepth_torch.data.datasets import get_dataloader
from tpudepth_torch.data.nyu import (
    DATASET_LAYOUTS,
    DataLoader,
    NYUDepthDataset,
    get_testing_data,
    get_training_testing_data,
    load_zip_to_mem,
)
from tpudepth_torch.data.synthetic import (
    make_synthetic_kitti_zip,
    make_synthetic_zip,
)

__all__ = [
    "DATASET_LAYOUTS",
    "NYUDepthDataset",
    "DataLoader",
    "get_dataloader",
    "get_testing_data",
    "get_training_testing_data",
    "load_zip_to_mem",
    "make_synthetic_kitti_zip",
    "make_synthetic_zip",
]
