"""Numerics debugging: NaN detection (``tpudepth/utils/debug.py``).

- :func:`nan_debug_mode`: autograd's anomaly detection, the counterpart of
  ``jax_debug_nans``: a backward that makes a NaN raises, with the
  traceback of the forward operation whose gradient made it.
- :func:`checkify_nan_step`: the counterpart of ``checkify.checkify`` around
  a step: the step's floating outputs are checked for NaN and inf after
  each call, and a non-finite one raises.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Iterator

import torch

from tpudepth_torch.utils.profiling import tensors_in


@contextlib.contextmanager
def nan_debug_mode() -> Iterator[None]:
    """``torch.autograd.set_detect_anomaly(True)`` for the block; the
    previous setting (and its NaN check) is restored after it. Anomaly
    detection keeps a traceback per operation and slows every step."""
    prev = torch.is_anomaly_enabled()
    prev_nan = torch.is_anomaly_check_nan_enabled()
    torch.autograd.set_detect_anomaly(True)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev, check_nan=prev_nan)


def checkify_nan_step(step_fn: Callable) -> Callable:
    """``step_fn`` with the same signature that raises ``FloatingPointError``
    when a floating tensor among its outputs (a tensor, or tensors in
    nested tuples, lists and dicts) holds a NaN or an inf. The check is one
    reduction per output on its device and one device-to-host copy per
    call: the call waits for the step to finish."""

    @functools.wraps(step_fn)
    def wrapped(*args, **kw):
        out = step_fn(*args, **kw)
        floats = [t for t in tensors_in(out) if t.is_floating_point()]
        if floats:
            dev = floats[0].device
            finite = torch.stack([torch.isfinite(t).all().to(dev)
                                  for t in floats]).tolist()
            bad = [i for i, ok in enumerate(finite) if not ok]
            if bad:
                raise FloatingPointError(
                    f"nan or inf in output {bad[0]} of "
                    f"{getattr(step_fn, '__name__', 'the step')}")
        return out

    return wrapped
