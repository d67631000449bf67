"""Evaluation metrics, both families of the reference, in float64 numpy:

- ``compute_errors``: the NeWCRFs-style 9-vector (``src/utils.py:45-66``:
  silog, abs_rel, log10, rms, sq_rel, log_rms, d1, d2, d3);
- ``Result`` / ``AverageMeter``: the FastDepth-derived family of the
  GuideDepth stack (``src/GuideDepth/metrics.py``).

Own copy of ``tpudepth/eval/metrics.py``. As there, two latent faults of the
original are repaired and not replicated: the bare ``self.sum_rmse_log``
statement in ``reset()`` and the mae / rmse_log argument swap between
``update()`` and ``average()``.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

METRIC_NAMES = [
    "silog",
    "abs_rel",
    "log10",
    "rms",
    "sq_rel",
    "log_rms",
    "d1",
    "d2",
    "d3",
]


def compute_errors(gt: np.ndarray, pred: np.ndarray) -> List[float]:
    """NeWCRFs eval 9-vector over pre-masked flat arrays
    (``src/utils.py:45-66``), in the order of :data:`METRIC_NAMES`."""
    gt = np.asarray(gt, dtype=np.float64)
    pred = np.asarray(pred, dtype=np.float64)
    thresh = np.maximum(gt / pred, pred / gt)
    d1 = float(np.mean(thresh < 1.25))
    d2 = float(np.mean(thresh < 1.25**2))
    d3 = float(np.mean(thresh < 1.25**3))

    rms = float(np.sqrt(np.mean((gt - pred) ** 2)))
    log_rms = float(np.sqrt(np.mean((np.log(gt) - np.log(pred)) ** 2)))

    abs_rel = float(np.mean(np.abs(gt - pred) / gt))
    sq_rel = float(np.mean(((gt - pred) ** 2) / gt))

    err = np.log(pred) - np.log(gt)
    silog = float(np.sqrt(np.mean(err**2) - np.mean(err) ** 2) * 100)

    log10 = float(np.mean(np.abs(np.log10(pred) - np.log10(gt))))
    return [silog, abs_rel, log10, rms, sq_rel, log_rms, d1, d2, d3]


class Result:
    """Per-sample metric record (FastDepth family, ``src/GuideDepth/metrics.py:16-62``)."""

    def __init__(self):
        self.irmse = self.imae = 0.0
        self.mse = self.rmse = self.mae = 0.0
        self.absrel = self.lg10 = 0.0
        self.delta1 = self.delta2 = self.delta3 = 0.0
        self.data_time = self.gpu_time = 0.0
        self.rmse_log = 0.0

    def set_to_worst(self):
        self.irmse = self.imae = np.inf
        self.mse = self.rmse = self.mae = np.inf
        self.rmse_log = np.inf
        self.absrel = self.lg10 = np.inf
        self.delta1 = self.delta2 = self.delta3 = 0.0
        self.data_time = self.gpu_time = 0.0

    def update(
        self, irmse, imae, mse, rmse, rmse_log, mae, absrel, lg10,
        delta1, delta2, delta3, gpu_time, data_time,
    ):
        self.irmse, self.imae = irmse, imae
        self.mse, self.rmse, self.mae = mse, rmse, mae
        self.rmse_log = rmse_log
        self.absrel, self.lg10 = absrel, lg10
        self.delta1, self.delta2, self.delta3 = delta1, delta2, delta3
        self.data_time, self.gpu_time = data_time, gpu_time

    def evaluate(self, output, target):
        """Metrics over (already cropped) depth maps in meters.

        Formula-parity with ``src/GuideDepth/metrics.py:41-62`` — note lg10 and
        rmse_log both use base-10 logs there, replicated here.
        """
        output = np.asarray(output, dtype=np.float64)
        target = np.asarray(target, dtype=np.float64)
        abs_diff = np.abs(output - target)

        self.mse = float(np.mean(abs_diff**2))
        self.rmse = math.sqrt(self.mse)
        self.mae = float(np.mean(abs_diff))
        log10_diff = np.abs(np.log10(output) - np.log10(target))
        self.lg10 = float(np.mean(log10_diff))
        self.rmse_log = math.sqrt(float(np.mean(log10_diff**2)))
        self.absrel = float(np.mean(abs_diff / target))

        max_ratio = np.maximum(output / target, target / output)
        self.delta1 = float(np.mean(max_ratio < 1.25))
        self.delta2 = float(np.mean(max_ratio < 1.25**2))
        self.delta3 = float(np.mean(max_ratio < 1.25**3))
        self.data_time = 0.0
        self.gpu_time = 0.0

        inv_output = 1.0 / output
        inv_target = 1.0 / target
        abs_inv_diff = np.abs(inv_output - inv_target)
        self.irmse = math.sqrt(float(np.mean(abs_inv_diff**2)))
        self.imae = float(np.mean(abs_inv_diff))


class AverageMeter:
    """Running average of :class:`Result` fields (``src/GuideDepth/metrics.py:65-104``,
    with the reset()/average() bugs fixed)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.count = 0.0
        self.sum_irmse = self.sum_imae = 0.0
        self.sum_mse = self.sum_rmse = self.sum_mae = 0.0
        self.sum_rmse_log = 0.0
        self.sum_absrel = self.sum_lg10 = 0.0
        self.sum_delta1 = self.sum_delta2 = self.sum_delta3 = 0.0
        self.sum_data_time = self.sum_gpu_time = 0.0

    def update(self, result: Result, gpu_time: float, data_time: float, n: int = 1):
        self.count += n
        self.sum_irmse += n * result.irmse
        self.sum_imae += n * result.imae
        self.sum_mse += n * result.mse
        self.sum_rmse += n * result.rmse
        self.sum_rmse_log += n * result.rmse_log
        self.sum_mae += n * result.mae
        self.sum_absrel += n * result.absrel
        self.sum_lg10 += n * result.lg10
        self.sum_delta1 += n * result.delta1
        self.sum_delta2 += n * result.delta2
        self.sum_delta3 += n * result.delta3
        self.sum_data_time += n * data_time
        self.sum_gpu_time += n * gpu_time

    def average(self) -> Result:
        avg = Result()
        c = self.count
        avg.update(
            self.sum_irmse / c, self.sum_imae / c,
            self.sum_mse / c, self.sum_rmse / c, self.sum_rmse_log / c,
            self.sum_mae / c, self.sum_absrel / c, self.sum_lg10 / c,
            self.sum_delta1 / c, self.sum_delta2 / c, self.sum_delta3 / c,
            self.sum_gpu_time / c, self.sum_data_time / c,
        )
        return avg
