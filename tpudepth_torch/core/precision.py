"""Mixed-precision policy (``tpudepth/core/precision.py``): parameters and
loss reductions stay float32; the compute dtype is bfloat16 or float32."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32

    @staticmethod
    def from_str(name: str) -> "Precision":
        name = (name or "bfloat16").lower()
        if name in ("bf16", "bfloat16"):
            return Precision()
        if name in ("f32", "float32", "fp32"):
            return Precision(compute_dtype=torch.float32)
        raise ValueError(f"unknown compute dtype {name!r}")
