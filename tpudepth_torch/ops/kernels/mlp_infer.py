"""Transformer FFN for inference over rows: ``fc2(gelu(fc1(x)))``.

Counterpart of ``tpudepth/ops/pallas/mlp_infer.py::mlp_infer``. The kernel
is the ``mlp_infer`` entry of ``tpudepth_torch/csrc/epilogue_infer.cu``,
which shares its FFN device code with ``block_epilogue_infer``
(``ops/kernels/epilogue_infer.py``); the header there says what bounds it
and how it is laid out. In bf16 one call runs two products on the pipelined
``wgmma`` core of ``csrc/gemm_sm90.cuh`` (and, on a device's first call, the
kernel that fills their GELU table) through the bf16 hidden ``gelu(h)``
``[M, H]``, scratch that :func:`launch_ffn` allocates
(``epilogue_infer.ffn_scratch_shapes``); f32 runs one CUDA-core kernel.
The wrapper :func:`mlp_infer` counts its launches, one a call;
the plain version :func:`mlp_infer_reference` has the kernel's rounding
order (``h`` and ``gelu(h)`` rounded to the IO dtype). CPU tensors run the
plain version; CUDA tensors launch the kernel or raise. The boundary keeps
the JAX layout: ``x`` ``[M, C]`` float32 or bfloat16, ``w1`` ``[C, H]`` and
``w2`` ``[H, C2]`` float32 ``[in, out]`` (the ``.t()`` view of a ``Linear``
weight is taken without a copy), ``b1``, ``b2`` float32.
"""

from __future__ import annotations

import torch

from tpudepth_torch.ops.kernels import _op
from tpudepth_torch.ops.kernels import epilogue_infer as _epi

#: (atol as a fraction of the output's largest value, rtol) against the
#: plain version: the FFN part of ``epilogue_infer.tolerance``.
tolerance = _epi.tolerance


def mlp_infer_reference(x, w1, b1, w2, b2) -> torch.Tensor:
    """Plain PyTorch version in the kernel's rounding order."""
    return _epi.ffn_reference(x, w1, b1, w2, b2).to(x.dtype)


def check_widths(name, c, hidden, c2):
    """Refuse FFN widths the kernels do not take: the rule of the f32
    CUDA-core FFN (``block_tail.cuh``), held in both dtypes."""
    if not (_epi.width_ok(c) and _epi.width_ok(hidden)
            and _epi.width_ok(c2, out=True)):
        raise ValueError(f"{name} takes widths that are multiples of 32, at "
                         "most 128 or multiples of 128, and an output width "
                         f"<= 1024, not {c}, {hidden}, {c2}")


def launch_ffn(lib, name, x, w1, b1, w2, b2,
               round_vectors: bool = False) -> torch.Tensor:
    """Launch the C entry ``name`` of ``lib()``, an FFN (``mlp_infer``
    here, ``mlp_train_fwd`` in ``mlp_train.py``: one C signature,
    ``epilogue_infer.FFN_ARGTYPES``), on CUDA tensors and return its
    ``[M, C2]`` output in x's dtype; ``round_vectors`` rounds the biases to
    x's dtype first (the training FFN's casts). bf16 gets the scratch of
    ``epilogue_infer.ffn_scratch_shapes``. Raises on a refused input or a
    failed launch. The caller counts the launch."""
    m, c = x.shape
    hidden, c2 = w2.shape
    if x.device.type != "cuda":
        raise ValueError(f"no {name} kernel for {x.device}")
    check_widths(name, c, hidden, c2)
    w1t, w2t = _epi.check_cuda(name, (x,), (w1, w2), (b1, b2))
    if round_vectors:
        b1, b2 = (b.to(x.dtype).float() for b in (b1, b2))
    out = torch.empty((m, c2), dtype=x.dtype, device=x.device)
    bf16 = x.dtype == torch.bfloat16
    # kept alive until the launch is queued (the allocator reuses freed
    # memory in stream order)
    g = (torch.empty(_epi.ffn_scratch_shapes(m, hidden)["g"], dtype=x.dtype,
                     device=x.device) if bf16 else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib(), name)(
            x.data_ptr(), w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(),
            b2.data_ptr(), out.data_ptr(), g if g is None else g.data_ptr(),
            m, c, hidden, c2, int(bf16), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    return out


def mlp_infer(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """``[M, C2]`` in ``x``'s dtype. CPU tensors run
    :func:`mlp_infer_reference`; CUDA tensors launch the ``mlp_infer``
    kernel (counted in ``mlp_infer.launches``); through :data:`OP` only while
    ``torch.export`` traces."""
    m, c = x.shape
    hidden, c2 = w2.shape
    if w1.shape != (c, hidden) or b1.shape != (hidden,) or b2.shape != (c2,):
        raise ValueError(f"mlp_infer: shapes do not fit x {tuple(x.shape)}, "
                         f"w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    _op.check_device("mlp_infer", x)
    args = (x, w1, b1, w2, b2)
    return OP(*args) if _op.through_op() else _run(*args)


def _run(x, w1, b1, w2, b2):
    """The kernel of a call on x's device: the plain version on the CPU, the
    launch on the card (counted)."""
    if x.device.type == "cpu":
        return mlp_infer_reference(x, w1, b1, w2, b2).contiguous()
    out = launch_ffn(_epi.lib, "mlp_infer", x, w1, b1, w2, b2)
    mlp_infer.launches += 1
    return out


#: ``tpudepth::mlp_infer``
OP = _op.define(
    "mlp_infer",
    "(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2) -> Tensor",
    _run, _run,
    lambda x, w1, b1, w2, b2: x.new_empty((x.shape[0], w2.shape[1])))


mlp_infer.launches = 0
