"""Tracing and timing: :func:`trace`, :func:`annotate`, :func:`timed` and
``StepTimer`` (``tpudepth/utils/profiling.py``), and the count of CUDA
kernels a call launches (:func:`graph_kernels`).

The JAX package's ``jax.profiler`` trace for TensorBoard / XProf becomes a
``torch.profiler`` trace written as a Chrome trace (``chrome://tracing``,
Perfetto, TensorBoard's PyTorch profiler plugin); ``block_until_ready``
becomes ``torch.cuda.synchronize`` of the result's devices.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import time
from typing import Callable, Dict, Iterator, List, Optional

import torch


def tensors_in(tree) -> List[torch.Tensor]:
    """The tensors of a (nested) tuple, list or dict of results."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [t for item in tree for t in tensors_in(item)]
    return []


@contextlib.contextmanager
def trace(logdir: str) -> Iterator["torch.profiler.profile"]:
    """Profile the block with ``torch.profiler`` (CPU activity, and the
    card's through CUPTI when CUDA is available) and write its Chrome trace
    into ``logdir`` as ``trace_<pid>_<ns>.pt.trace.json`` when it ends.
    Yields the profiler (``key_averages()`` once the block is left)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json"))


def annotate(name: str):
    """A named region of a :func:`trace` (``torch.profiler.record_function``),
    a context manager."""
    return torch.profiler.record_function(name)


def timed(fn: Callable, *args, sync: bool = True, **kw):
    """``(result, seconds)`` of ``fn(*args, **kw)`` on the host clock; with
    ``sync`` every CUDA device holding a tensor of the result is
    synchronized first, so its device work counts."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    if sync:
        for dev in {t.device for t in tensors_in(out) if t.is_cuda}:
            torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


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


def graph_kernels(fn: Callable[[], object]) -> int:
    """CUDA kernels one call of ``fn`` launches on the current device: the
    kernel nodes of a CUDA graph captured from one call (after one call on a
    side stream), counted through libcuda (``cuGraphGetNodes``,
    ``cuGraphNodeGetType``). Memsets and copies are nodes of other types.
    Unlike a profiler trace, which can drop events late in a long run, the
    count does not depend on timing. Needs a card."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)   # the graph, not only
    with torch.cuda.graph(graph):                   # its executable
        fn()
    torch.cuda.synchronize()
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kernels, kind = 0, ctypes.c_int(-1)
    for node in nodes:
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                 ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        kernels += kind.value == 0   # CU_GRAPH_NODE_TYPE_KERNEL
    graph.reset()
    return kernels
