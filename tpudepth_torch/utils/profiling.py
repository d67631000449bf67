"""Step timing (``tpudepth/utils/profiling.py::StepTimer``)."""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch


class StepTimer:
    """data_time / compute_time split per step (GuideDepth val-loop style)."""

    def __init__(self):
        self.data_time = 0.0
        self.compute_time = 0.0
        self.steps = 0
        self._t = time.perf_counter()

    def data_done(self):
        now = time.perf_counter()
        self.data_time += now - self._t
        self._t = now

    def step_done(self, sync_on: Optional[torch.Tensor] = None):
        """``sync_on``: a tensor of the step; when it lies on a CUDA device
        that device is synchronized first, so the step's device work counts."""
        if sync_on is not None and sync_on.is_cuda:
            torch.cuda.synchronize(sync_on.device)
        now = time.perf_counter()
        self.compute_time += now - self._t
        self._t = now
        self.steps += 1

    def summary(self) -> Dict[str, float]:
        n = max(self.steps, 1)
        return {
            "data_time_per_step": self.data_time / n,
            "compute_time_per_step": self.compute_time / n,
            "steps": self.steps,
        }
