"""The serving kernels as ``torch.library`` custom ops in the ``tpudepth``
namespace, so that ``torch.export`` traces a model through them.

A ``ctypes`` launch reads ``data_ptr()``, which the fake tensors of an
export trace do not have; an op has a fake kernel instead, which gives the
output's shape, dtype and strides, and the exported program calls the op.
Each wrapper's module defines its op at import (nothing is built then) with
:func:`define`: the CPU kernel is the wrapper's plain version, the CUDA
kernel its launch, counted in the wrapper's ``launches``; scratch is
allocated inside the launch only. Any other device has no kernel.

A wrapper calls its op only while ``torch.export`` traces
(:func:`through_op`); eager calls go to the same CPU or CUDA kernel
without the dispatcher. Both launch the same kernel, and neither falls
back to the plain version on the card. Eager calls skip the op because its
dispatch costs host time that a bs-1 frame, held by the host, pays in full:
on the H100 it added tens of microseconds to each ``gub_conv_fwd`` call,
about 2 % of a fused GuideDepth frame over nine calls, which PERF.md
records with the script that measured it. The route was decided on that
per-call host time; whole-frame turns spread too widely to show it.
"""

from __future__ import annotations

from typing import Callable

import torch

NAMESPACE = "tpudepth"


def through_op() -> bool:
    """Whether a wrapper calls its op now: only under ``torch.export``."""
    return torch.compiler.is_exporting()


def check_device(name: str, t: torch.Tensor) -> None:
    """Refuse a tensor on a device without a kernel of ``name`` (only the
    CPU and the card have one; the op's fake kernel would otherwise answer
    a meta tensor with a shape)."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {name} kernel for {t.device}")


def define(name: str, schema: str, cpu: Callable, cuda: Callable,
           fake: Callable):
    """Define ``tpudepth::<name>`` with ``schema`` (no argument mutated, no
    output aliasing an input) and its CPU, CUDA and fake kernels; returns
    the op's default overload."""
    op = torch.library.custom_op(f"{NAMESPACE}::{name}", cpu,
                                 mutates_args=(), device_types="cpu",
                                 schema=schema)
    op.register_kernel("cuda")(cuda)
    op.register_fake(fake)
    return getattr(torch.ops, NAMESPACE).__getattr__(name).default
