"""Evaluators of both reference protocols.

Counterparts of ``tpudepth/eval/evaluator.py``:

- :class:`RootEvaluator` (``src/test.py:84-198``), how the root stack
  scores SAM and NewCRF: per-batch min-max ground truth, the prediction
  resized to it and clamped to [min_depth_eval, max_depth_eval] with inf
  and nan scrubbed (``:105-108``), the validity mask AND the fractional
  Garg crop (``:110-123``), the 9 ``compute_errors`` metrics averaged over
  batches;
- :class:`AlhashimEvaluator` (``src/GuideDepth/evaluate.py:81-157``), the
  GuideDepth stack's: flip-TTA with the flipped image evaluated as an extra
  sample, the model run at its reduced resolution and the predictions
  upscaled to the ground truth's size (``:95-116``), the fixed Eigen crop
  [20,460,24,616] for NYU and the fractional crop for KITTI (``:118-132``),
  FastDepth ``Result`` / ``AverageMeter`` metrics and ``results.txt``
  (``:159-171``).

Batches come from the loader as dicts of NHWC arrays (``image``
``[B,H,W,3]`` float in [0, 1], ``depth`` ``[B,H,W,1]`` or ``[B,H,W]``). The
``forward`` callable has the port's model layout: it takes ``[B,3,H,W]``
float32 on the evaluator's device and returns ``[B,1,H,W]`` there, so a model
wrapped by ``make_eval_step`` or an ``InferenceEngine`` serves as it is.
Resizes, the ground truth's normalization and the meters conversion run on
the device; the metrics are float64 numpy on the host, as the JAX package
computes them.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from tpudepth_torch.core.config import (
    EvalConfig,
    garg_crop,
    kitti_alhashim_crop,
)
from tpudepth_torch.core.runtime import DeviceLike, resolve_device
from tpudepth_torch.eval.metrics import (
    METRIC_NAMES,
    AverageMeter,
    Result,
    compute_errors,
)
from tpudepth_torch.losses.losses import depth_norm_minmax
from tpudepth_torch.ops.image import resize_bilinear
from tpudepth_torch.train.trainer import inverse_depth_norm


def _nchw(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """Float32 NCHW tensor on ``device`` of an NHWC (or ``[B,H,W]``)
    array."""
    t = torch.as_tensor(np.asarray(array, np.float32)).to(device)
    if t.dim() == 3:
        t = t[..., None]
    return t.permute(0, 3, 1, 2)


class RootEvaluator:
    """``src/test.py`` protocol over ``forward`` (``[B,3,H,W]`` ->
    ``[B,1,h,w]``, resized to the ground truth when h, w differ).
    ``device=None`` means the CUDA card."""

    def __init__(self, forward: Callable[[torch.Tensor], torch.Tensor],
                 config: EvalConfig, device: DeviceLike = None):
        self.forward = forward
        self.config = config
        self.device = resolve_device(device)

    @torch.no_grad()
    def evaluate(self, loader, progress: bool = False) -> Dict[str, float]:
        cfg = self.config
        lo, hi = cfg.min_depth_eval, cfg.max_depth_eval
        measures = np.zeros(10, dtype=np.float64)
        for i, batch in enumerate(loader):
            gt = depth_norm_minmax(_nchw(batch["depth"], self.device))
            pred = self.forward(_nchw(batch["image"], self.device)).float()
            pred = resize_bilinear(pred, gt.shape[2:])
            gt = gt[:, 0].cpu().numpy()
            pred = pred[:, 0].cpu().numpy()
            # the reference's order: clamp, then inf to max, nan to min
            pred[pred < lo] = lo
            pred[pred > hi] = hi
            pred[np.isinf(pred)] = hi
            pred[np.isnan(pred)] = lo

            mask = np.logical_and(gt > lo, gt < hi)
            top, bottom, left, right = garg_crop(*gt.shape[1:])
            crop_mask = np.zeros_like(mask)
            crop_mask[:, top:bottom, left:right] = True
            mask = np.logical_and(mask, crop_mask)

            measures[:9] += np.asarray(compute_errors(gt[mask], pred[mask]))
            measures[9] += 1
            if progress and i % 5 == 0:
                print(f"Step: [{i}/{len(loader)}]")
        measures[:9] /= measures[9]
        return dict(zip(METRIC_NAMES, measures[:9].tolist()))

    @staticmethod
    def format_report(metrics: Dict[str, float], count: int) -> str:
        """The reference's eval printout layout (``src/test.py:192-198``)."""
        header = ", ".join(f"{n:>7}" for n in METRIC_NAMES)
        values = ", ".join(f"{metrics[n]:7.4f}" for n in METRIC_NAMES)
        return (
            f"Computing errors for {count} eval samples\n{header}\n{values}"
        )


class AlhashimEvaluator:
    """``src/GuideDepth/evaluate.py`` Evaluater protocol. ``device=None``
    means the CUDA card."""

    # the reference's fixed sample-visualization indices (evaluate.py:73-79)
    DEFAULT_VISUALIZE = tuple(
        base + off for base in range(0, 700, 100) for off in range(6)
    )

    def __init__(
        self,
        forward: Callable[[torch.Tensor], torch.Tensor],
        config: EvalConfig,
        depth_scale: Optional[float] = None,
        visualize_images: Tuple[int, ...] = (),
        forward_returns_meters: bool = False,
        device: DeviceLike = None,
    ):
        self.forward = forward
        self.config = config
        self.device = resolve_device(device)
        # loader depth in [0,1] (8-bit) -> meters
        self.depth_scale = (depth_scale if depth_scale is not None
                            else config.max_depth)
        self.visualize_images = set(visualize_images)
        # True when ``forward`` already applies the inverse depth norm (an
        # InferenceEngine with max_depth fuses the meters conversion)
        self.forward_returns_meters = forward_returns_meters

    @staticmethod
    def _like(t: torch.Tensor, ref: np.ndarray) -> np.ndarray:
        """NCHW tensor ``t`` as float32 numpy in the layout of ``ref``
        (NHWC, or ``[B,H,W]``)."""
        out = t.permute(0, 2, 3, 1).float().cpu().numpy()
        return out if ref.ndim == 4 else out[..., 0]

    @torch.no_grad()
    def evaluate(self, loader, save_results_to: Optional[str] = None) -> Result:
        cfg = self.config
        meter = AverageMeter()
        max_depth = cfg.max_depth
        crop = list(cfg.crop)

        for i, batch in enumerate(loader):
            t0 = time.time()
            image = _nchw(batch["image"], self.device)
            gt = np.asarray(batch["depth"], np.float32) * np.float32(
                self.depth_scale)  # meters
            if (cfg.eval_mode != "alhashim"
                    and tuple(image.shape[2:]) != tuple(cfg.image_size)):
                # 'tu' mode evaluates AT the model resolution: no prediction
                # upscale, no crop; image and ground truth are resized to it
                image = resize_bilinear(image, cfg.image_size)
                gt = self._like(resize_bilinear(_nchw(gt, self.device),
                                                cfg.image_size), gt)
            image_flip = torch.flip(image, dims=(3,))
            gt_flip = gt[:, :, ::-1]

            if cfg.eval_mode == "alhashim":
                image = resize_bilinear(image, cfg.image_size)
                image_flip = resize_bilinear(image_flip, cfg.image_size)
            data_time = time.time() - t0

            t0 = time.time()
            pred = self.forward(image).float()
            pred_flip = self.forward(image_flip).float()
            if not self.forward_returns_meters:
                pred = inverse_depth_norm(pred, max_depth)
                pred_flip = inverse_depth_norm(pred_flip, max_depth)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            gpu_time = time.time() - t0

            if cfg.eval_mode == "alhashim":
                gt_hw = gt.shape[1:3]
                pred = resize_bilinear(pred, gt_hw)
                pred_flip = resize_bilinear(pred_flip, gt_hw)
                if cfg.dataset == "kitti":
                    crop = list(kitti_alhashim_crop(*gt_hw))
            pred, pred_flip = self._like(pred, gt), self._like(pred_flip, gt)
            if cfg.eval_mode == "alhashim":
                if i in self.visualize_images and save_results_to:
                    self.save_image_results(
                        np.asarray(batch["image"]),
                        gt[..., None] if gt.ndim == 3 else gt,
                        pred[..., None] if pred.ndim == 3 else pred,
                        i, save_results_to, cfg.max_depth,
                    )
                window = (slice(None), slice(crop[0], crop[1]),
                          slice(crop[2], crop[3]))
                gt_c, gt_flip_c = gt[window], gt_flip[window]
                pred, pred_flip = pred[window], pred_flip[window]
            else:
                gt_c, gt_flip_c = gt, gt_flip

            for p, g in ((pred, gt_c), (pred_flip, gt_flip_c)):
                r = Result()
                r.evaluate(p, g)
                meter.update(r, gpu_time, data_time, image.shape[0])

        avg = meter.average()
        if save_results_to:
            self.save_results(avg, save_results_to)
        return avg

    @staticmethod
    def save_image_results(image, gt, prediction, image_id: int,
                           result_dir: str, max_depth: float = 10.0):
        """Save input / gt / prediction / error-map PNGs for one sample
        (``src/GuideDepth/evaluate.py:198-245``). NHWC numpy inputs."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        os.makedirs(result_dir, exist_ok=True)
        img = np.asarray(image)[0]
        gt2d = np.asarray(gt)[0, :, :, 0]
        pred2d = np.asarray(prediction)[0, :, :, 0]
        error_map = gt2d - pred2d
        valid = gt2d[gt2d != 0.0]
        vmax = float(valid.max()) if valid.size else 1.0
        vmin = float(valid.min()) if valid.size else 0.0

        def save(fname, arr, **kw):
            fig = plt.figure(frameon=False)
            ax = plt.Axes(fig, [0.0, 0.0, 1.0, 1.0])
            ax.set_axis_off()
            fig.add_axes(ax)
            ax.imshow(arr, **kw)
            fig.savefig(os.path.join(result_dir, fname))
            plt.close(fig)

        save(f"image_{image_id}.png", np.clip(img, 0, 1))
        save(f"errors_{image_id}.png", error_map, vmin=0.0,
             vmax=max_depth / 10.0, cmap="Reds")
        save(f"gt_{image_id}.png", gt2d, vmin=vmin, vmax=vmax, cmap="viridis")
        save(f"depth_{image_id}.png", pred2d, vmin=vmin, vmax=vmax,
             cmap="viridis")

    @staticmethod
    def save_results(average: Result, result_dir: str):
        """``results.txt`` in the reference's format
        (``src/GuideDepth/evaluate.py:159-171``)."""
        os.makedirs(result_dir, exist_ok=True)
        with open(os.path.join(result_dir, "results.txt"), "w") as f:
            f.write("RMSE,MAE,REL, RMSE_log,Lg10,Delta1,Delta2,Delta3\n")
            f.write(
                f"{average.rmse:.3f},{average.mae:.3f},{average.absrel:.3f}"
                f",{average.rmse_log:.3f},{average.lg10:.3f},{average.delta1:.3f}"
                f",{average.delta2:.3f},{average.delta3:.3f}"
            )

    @staticmethod
    def format_report(avg: Result) -> str:
        """Console report (``src/GuideDepth/evaluate.py:148-157``)."""
        return (
            "\n*\n"
            f"RMSE={avg.rmse:.3f}\n"
            f"MAE={avg.mae:.3f}\n"
            f"Delta1={avg.delta1:.3f}\n"
            f"Delta2={avg.delta2:.3f}\n"
            f"Delta3={avg.delta3:.3f}\n"
            f"REL={avg.absrel:.3f}\n"
            f"Lg10={avg.lg10:.3f}\n"
            f"t_GPU={avg.gpu_time:.3f}\n"
        )
