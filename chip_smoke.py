#!/usr/bin/env python3
"""Smoke test of tpudepth_torch on one NVIDIA GPU: ``python3 chip_smoke.py``.

It drives the port's main paths at NYU 480x640: serving (GuideDepth in bf16
with fused GUB stages), training (``Trainer.fit``, alhashim recipe, bf16,
batch 8) with plain and with fused GUB stages, the evaluator on the trained
model, serving MobileV3SAMDepth (MobileNetV3-Large + four SAM stages at
full width, bf16) with its blocks fused, paired, as window rows and as
whole blocks over raw windows, serving MobileV3NewCRFDepth (the same
encoder + four two-block NewCRF stages, the second block of each shifted)
with its blocks as window rows, fused, paired and as whole blocks, both
scored by the root protocol's ``RootEvaluator``, and training both
attention models (``Trainer.fit``, root recipe, bf16, batch 8) through the
training kernels. It holds every CUDA kernel of those paths against its
plain PyTorch version. Phases:

1. device: needs CUDA; prints the card's name and power limit; turns TF32
   off for every f32 reference;
2. build: compiles every CUDA source of the package with nvcc (in parallel)
   and prints the time and the ptxas report;
3. kernels: ``gub_conv_fwd`` against ``conv_bn_act_reference`` at the nine
   shapes of the paths, at batch 1 (serving) and batch 8 (training,
   evaluation), in f32 and bf16, with and without prelude and skip, output
   and statistics; ``fused_loss_fwd`` and ``fused_loss_bwd``
   against ``fused_partials_reference`` / ``fused_bwd_reference`` at the
   training path's shape and at ragged, zero-target, pred == target, flat
   and narrow cases; each loss kernel's CUDA kernels a call from a CUDA
   graph of one call ([loss kernel count]; each is one); per
   shape the device time of the kernel, of the plain version and
   of a library yardstick (one cuDNN ``F.conv2d``; the port's ``DepthLoss``
   and its autograd backward) beside the bound, ``gub_conv_fwd`` also at
   batch 8 with statistics beside cuDNN and ``torch.batch_norm_stats``;
   ``gub_conv_dw`` and ``gub_conv_dx`` against ``conv_bn_act_dw_reference``
   / ``conv_bn_act_dx_reference`` at the nine shapes of a batch-8 train step
   in f32 and bf16 and at prelude / skip / ragged / k=1 / multi-part cases,
   timed beside cuDNN's ``convolution_backward`` of the same conv and the
   bound (each row's share of it; a total line a kernel); the SAM
   kernels (``window_attn_infer``, ``block_epilogue_infer``, ``mlp_infer``)
   at the four stage shapes (``mlp_infer`` also at an odd row count, each
   call rerun bit-equal); ``crf_rowblock_infer`` (shift 0 and 3) and
   ``sam_rowblock_infer`` against their plain versions at the four stage
   shapes of 480x640, B 1 and 8, f32 and bf16, every call rerun bit-equal,
   then one B 8 bf16 forward's calls timed beside the bound, the plain
   version, the library yardstick (the block's cuBLAS products + SDPA) and
   the port's ``row`` module and ``fused`` composition of the same block;
   [block kernels]: ``crf_block_infer`` (shift 0 and 3) and
   ``sam_block_infer`` the same way, on the windows of the same maps,
   beside the ``block``, ``row`` and ``fused`` modules; then one B 8 bf16
   call a stage of ``sam_rowblock_infer``, ``crf_rowblock_infer`` (shift 0
   and 3), ``sam_block_infer``, ``crf_block_infer`` (shift 0 and 3) and
   ``window_attn_train_bwd`` split into its CUDA kernels by
   ``torch.profiler`` ([row kernel split], [block kernel split], [train
   kernel split]);
   [train kernels]:
   ``window_attn_train_fwd`` / ``_bwd`` (with and without the shift-3 mask)
   and ``mlp_train_fwd`` / ``_bwd`` (also at an odd row count, the forward
   also at B 1) against their plain versions at the four stage shapes of a
   B 8 step, f32 and bf16, every backward and FFN forward run twice and
   bit-equal, then one B 8 bf16 SAM step's
   calls timed beside the bound, the plain version and SDPA (forward,
   autograd backward) or the FFN's
   cuBLAS products; [root loss kernels]: ``fused_root_loss_fwd`` / ``_bwd``
   against their plain versions at the training shape and at clip-active,
   pred == target, flat, ragged and 2-pixel-wide cases (the gradient
   bit-equal), every
   call rerun bit-equal, then timed at B 8 beside the bound, the plain
   version and the port's plain ``ssim + l1_loss`` and its autograd
   backward;
4. serving: 8 single-image requests through ``InferenceEngine`` (bf16,
   flip-TTA, meters), with the kernel's launches counted over exactly that
   run, then the raw outputs against the plain f32 model, then the engine's
   img/s at bs 1 and 8, fused and plain, each with a ``torch.profiler``
   window (device busy share, launches, largest kernels); then SAM serving:
   a seeded ``build_model("sam")`` through the bf16 ``InferenceEngine``,
   fused and pair, batch 1 and 8, with the SAM kernels' launches counted
   over exactly those requests (4 + 4 per forward), the served maps against
   the f32 plain model, f32 fused and pair against f32 plain, and ms/frame,
   img/s, peak memory and a profile of each mode; the same for SAM's ``row``
   mode (4 ``sam_rowblock_infer`` calls per forward) and its ``block`` mode
   (4 ``sam_block_infer``); then NewCRF serving, ``build_model("newcrf")``
   in modes ``row`` (the default: 8 ``crf_rowblock_infer`` calls per
   forward), ``fused`` (8 + 8 ``window_attn_infer`` and
   ``block_epilogue_infer``), ``pair`` (8 + 8 ``window_attn_infer`` and
   ``mlp_infer``) and ``block`` (8 ``crf_block_infer``), the same checks
   and timings; [root eval]: each attention model's bf16 ``block`` engine
   through ``RootEvaluator`` over seeded synthetic batches against the f32
   plain model through the same evaluator (5 % + 5e-3 per metric), the
   whole-block launches counted;
5. training: ``Trainer.fit`` for 2 epochs of 3 steps on seeded synthetic
   uint8 batches with one validation batch and a checkpoint per epoch (the
   seeded model's output bias starts at 3, inside the targets' range), the
   loss kernels' launches counted over exactly that run; the last checkpoint
   restored into a fresh trainer; one f32 step through the loss kernels
   against the same step through the plain ``DepthLoss``; 8 steps on one
   batch lower the loss;
6. fused training: the same ``fit`` on a ``gub="fused"`` model, with the
   launches of ``gub_conv_fwd``, ``gub_conv_dw``, ``gub_conv_dx`` and the
   loss kernels counted over exactly that run and checked per step; the last
   checkpoint restored; one f32 step fused against the same step plain; then
   ms/step, img/s, peak memory and a ``torch.profiler`` window of one step
   for the plain and the fused trainer, in turns;
7. evaluation: the trained fused model, its weights as ``fit`` left them,
   through ``InferenceEngine`` (bf16, meters) and ``AlhashimEvaluator`` over
   seeded synthetic batches, against the f32 plain model through the same
   evaluator; ``results.txt`` written and read back;
8. [sam train], [newcrf train]: a seeded model in its default block mode
   through ``Trainer.fit`` (2 epochs x 3 steps, root recipe, bf16, B 8,
   validation and checkpoints), the training kernels' launches counted over
   exactly that run and per step (SAM 4 + 4 + 4 + 4, NewCRF 8 + 8 + 8 + 8,
   and the root loss kernels 1 + 1 a step, the forward once more a
   validation batch);
   SAM's encoder bit-unchanged with its BatchNorm statistics moved,
   NewCRF's encoder moved; the last checkpoint restored; one f32 step
   against the ``plain`` step; 8 steps on one batch lower the loss;
   ms/step, img/s, peak memory and a profile of one step;
9. one JSON line on the kernels, and last the JSON line with the device.

Any failed check raises, and the script exits non-zero without printing a
result. It imports nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
BF16_FLOP_PER_S = 989e12    # H100 SXM dense bf16 tensor cores
F32_FLOP_PER_S = 67e12      # H100 SXM float32 outside the tensor cores

# (name, input channels per part, Cout, H, W, prelude): every k=3 GUB conv
# of GuideDepth at 480x640, in the order a forward runs them
PATH_SHAPES = [
    ("up_1.feature_conv_a", (64,), 64, 120, 160, False),
    ("up_1.guide_conv_a", (3,), 64, 120, 160, False),
    ("up_1.comb_conv_a", (32, 32), 64, 120, 160, True),
    ("up_2.feature_conv_a", (32,), 32, 240, 320, False),
    ("up_2.guide_conv_a", (3,), 32, 240, 320, False),
    ("up_2.comb_conv_a", (16, 16), 32, 240, 320, True),
    ("up_3.feature_conv_a", (16,), 16, 480, 640, False),
    ("up_3.guide_conv_a", (3,), 16, 480, 640, False),
    ("up_3.comb_conv_a", (8, 8), 16, 480, 640, True),
]
# raw model output, bf16 fused engine against the f32 plain model:
# ||got - ref|| / ||ref|| and max|got - ref| / max|ref|
SERVE_BF16_REL_L2 = 5e-2
SERVE_BF16_REL_MAX = 0.15
# raw model output, f32 fused against f32 plain (summation order only)
SERVE_F32_REL_MAX = 1e-4

# per-channel sum(y) against sum|y| and sum(y^2): f32 sums of 128 values per
# block (a few ulps each), added in f64, rounded once to f32
STATS_RTOL = 1e-6

DEVICE = torch.device("cuda")

# the training path: GuideDepth, NYU full resolution, batch 8
TRAIN_BATCH, TRAIN_HW, MAX_DEPTH = 8, (480, 640), 10.0
# (kind, B, H, W) of tests/test_torch_port_cuda.py::loss_pair: the training
# shape with depth_norm-scale targets, half resolution, a ragged image,
# masked (zero) targets, pred == target (gate closed, signs at 0), flat
# patches (signs of zero differences), uniform values, the backward's
# 32x64 tile and the forward's 40x64 exactly, one row and column above a
# tile, and an image narrower than the backward's 10-pixel halo
LOSS_CASES = [("norm", 8, 480, 640), ("norm", 8, 240, 320),
              ("norm", 2, 33, 47), ("zeros", 8, 480, 640),
              ("equal", 2, 96, 128), ("smooth", 2, 50, 70),
              ("random", 3, 48, 64), ("norm", 3, 32, 64), ("norm", 3, 40, 64),
              ("norm", 2, 33, 65), ("norm", 2, 41, 65), ("norm", 1, 11, 70)]
# float operations per pixel that the functions need: 22 multiply-adds for
# each of the 5 (forward) or 8 (backward) gaussian maps, plus the pointwise
# formulas (SSIM map, L1 and difference terms; coefficient maps and the sum)
LOSS_FWD_FLOP_PER_PIXEL = 5 * 22 * 2 + 30
LOSS_BWD_FLOP_PER_PIXEL = 8 * 22 * 2 + 60
# one f32 step through the loss kernels against the step through DepthLoss:
# the loss (sums in another order), and per tensor the largest gradient
# difference over the largest gradient. dL/dpred agrees to rtol 1e-4 (the
# JAX package's tolerance for its fused loss against DepthLoss) and weight
# gradients are sums of it over 2.4M pixels; conv biases in front of a
# BatchNorm have a zero gradient and hold noise (floor).
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_REL = 1e-3
STEP_GRAD_FLOOR = 1e-6
# evaluator metrics of the bf16 fused engine against the f32 plain model on
# the same weights: bf16 carries 3 significant digits through the network
EVAL_BF16_REL = 5e-2
EVAL_BF16_ABS = 5e-3


def check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def time_ms(fn, per_graph: int = 10, replays: int = 20) -> float:
    """Device time of one call of ``fn``: ``per_graph`` calls captured in a
    CUDA graph, the graph replayed ``replays`` times, each replay between
    CUDA events; the median replay over ``per_graph``. Replaying leaves out
    the host's Python and launch overhead, which a per-call event pair would
    count whenever the card waits for the host. Inputs stay in L2, as they
    do on the serving path."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_graph)
    return statistics.median(times)


def make_case(seed, bsz, h, w, cins, cout, prelude, skip, dtype, dev, k=3):
    rng = np.random.default_rng(seed)

    def t(arr, dt=torch.float32):
        return torch.from_numpy(np.asarray(arr, np.float32)).to(dev, dt)

    parts = [t(rng.standard_normal((bsz, h, w, c)), dtype) for c in cins]
    wt = t(rng.standard_normal((k, k, sum(cins), cout))
           / np.sqrt(k * k * sum(cins)))
    b = t(0.1 * rng.standard_normal(cout))
    pre = None
    if prelude:
        # C takes both signs, so a zero-padded halo differs from relu(C)
        pre = [(t(rng.uniform(0.5, 1.5, (bsz, c))),
                t(rng.standard_normal((bsz, c)))) for c in cins]
    sk = t(rng.standard_normal((bsz, h, w, cins[0])), dtype) if skip else None
    return parts, wt, b, pre, sk


def phase_device():
    check(torch.cuda.is_available(), "torch.cuda.is_available()")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)


def phase_build():
    from tpudepth_torch.ops.kernels import _build

    t0 = time.perf_counter()
    _build.build(_build.sources())
    print(f"[build] {_build.sources()} in {time.perf_counter() - t0:.1f} s")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    sys.stdout.flush()


def _bound_ms(bsz, h, w, cins, cout, prelude):
    """Least time of one bf16 launch: (bound, bytes time, operations time)."""
    cin = sum(cins)
    nbytes = (bsz * h * w * (cin + cout) * 2         # inputs once, output once
              + 9 * cin * cout * 4 + cout * 4       # f32 weights and bias
              + (2 * bsz * cin * 4 if prelude else 0))
    flops = 2 * bsz * h * w * 9 * cin * cout
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), t_bytes, t_ops


def fwd_train_step_times():
    """Device times of ``gub_conv_fwd`` in bf16 at the nine ``PATH_SHAPES``
    as a train step launches them: batch 8 with statistics, beside cuDNN's
    ``F.conv2d`` and the per-channel statistics of its output in one pass
    (``torch.batch_norm_stats``, f32 sums, no copy written) and the bound:
    [{"name", "ms", "library_ms", "bound_ms"}]."""
    from tpudepth_torch.ops.kernels.gub_conv import _activate, conv_bn_act

    dtype = torch.bfloat16
    out = []
    for i, (name, cins, cout, h, w, prelude) in enumerate(PATH_SHAPES):
        parts, wt, b, pre, _ = make_case(i, TRAIN_BATCH, h, w, cins, cout,
                                         prelude, False, dtype, DEVICE)
        x_lib = torch.cat(_activate(parts, pre, None), dim=-1).permute(
            0, 3, 1, 2)
        w_lib = wt.to(dtype).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        b_lib = b.to(dtype)

        def lib():
            return torch.batch_norm_stats(
                F.conv2d(x_lib, w_lib, b_lib, padding=1), 1e-5)

        r = {"name": name,
             "ms": time_ms(lambda: conv_bn_act(parts, wt, b, preludes=pre,
                                               stats=True),
                           per_graph=4, replays=10),
             "library_ms": time_ms(lib, per_graph=4, replays=10),
             "bound_ms": _bound_ms(TRAIN_BATCH, h, w, cins, cout,
                                   prelude)[0]}
        out.append(r)
        print(f"[kernel time] {name:<20} {'+'.join(map(str, cins))}->{cout} "
              f"@{h}x{w} B{TRAIN_BATCH} bf16 stats: kernel {r['ms']:.4f} ms, "
              f"F.conv2d + batch_norm_stats {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms "
              f"({100 * r['bound_ms'] / r['ms']:.1f}% of bound)", flush=True)
        del parts, x_lib
        torch.cuda.empty_cache()
    return out


def phase_kernels():
    from tpudepth_torch.ops.kernels.gub_conv import (
        conv_bn_act,
        conv_bn_act_reference,
        tolerance,
    )

    dev = torch.device("cuda")
    max_err = 0.0
    n_checks = 0

    def check_case(tag, seed, bsz, h, w, cins, cout, prelude, skip, dtype,
                   k=3):
        nonlocal max_err, n_checks
        parts, wt, b, pre, sk = make_case(seed, bsz, h, w, cins, cout,
                                          prelude, skip, dtype, dev, k)
        y, s, q = conv_bn_act(parts, wt, b, preludes=pre, skip=sk, stats=True)
        torch.cuda.synchronize()
        ry = conv_bn_act_reference(parts, wt, b, preludes=pre, skip=sk)
        atol, rtol = tolerance(dtype)
        yr, yk = ry.float(), y.float()
        err = (yk - yr).abs()
        ok_y = bool((err <= atol + rtol * yr.abs()).all())
        # the statistics against f64 sums of the kernel's own output, per
        # channel, relative to sum|y| and sum y^2
        yd = y.double()
        abs_s, sum_q = yd.abs().sum(dim=(0, 1, 2)), (yd * yd).sum(dim=(0, 1, 2))
        es = float(((s.double() - yd.sum(dim=(0, 1, 2))).abs()
                    / abs_s.clamp_min(1e-30)).max())
        eq = float(((q.double() - sum_q).abs() / sum_q.clamp_min(1e-30)).max())
        e = float(err.max())
        max_err = max(max_err, e)
        n_checks += 1
        print(f"[kernel] {tag:<24} {str(dtype)[6:]:<8} pre={int(prelude)} "
              f"skip={int(skip)} max_abs_err {e:.3e} "
              f"(max rel {float((err / yr.abs().clamp_min(1e-3)).max()):.3e}; "
              f"atol {atol:g} rtol {rtol:g}) stats rel err {es:.2e} {eq:.2e} "
              f"(rtol {STATS_RTOL:g})", flush=True)
        check(ok_y, f"{tag} {dtype} output beyond tolerance")
        check(es <= STATS_RTOL and eq <= STATS_RTOL,
              f"{tag} {dtype} statistics")

    for i, (name, cins, cout, h, w, prelude) in enumerate(PATH_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            check_case(name, i, 1, h, w, cins, cout, prelude, False, dtype)
            if not prelude:
                check_case(name + "+pre+skip", i, 1, h, w, cins, cout, True,
                           True, dtype)
    for dtype in (torch.float32, torch.bfloat16):
        check_case("B2 ragged 33x47", 50, 2, 33, 47, (16,), 8, True, True,
                   dtype)
        check_case("B2 k=1 (5,7)->12", 51, 2, 17, 29, (5, 7), 12, True, True,
                   dtype, k=1)
        check_case("B3 3 parts ->40", 52, 3, 9, 18, (4, 2, 3), 40, True,
                   False, dtype)
    # the nine shapes as the fused train step and the evaluation launch
    # them: batch 8 with statistics (sums over up to 2.4 M pixels)
    for i, (name, cins, cout, h, w, prelude) in enumerate(PATH_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            check_case(f"B{TRAIN_BATCH} {name}", 60 + i, TRAIN_BATCH, h, w,
                       cins, cout, prelude, False, dtype)
            torch.cuda.empty_cache()

    # Device times at the path's shapes in its serving dtype (bf16, bs 1,
    # no stats).
    rows = []
    for i, (name, cins, cout, h, w, prelude) in enumerate(PATH_SHAPES):
        dtype = torch.bfloat16
        parts, wt, b, pre, _ = make_case(i, 1, h, w, cins, cout, prelude,
                                         False, dtype, dev)
        xa = torch.cat([p.float() for p in parts], dim=-1)
        if pre is not None:
            xa = torch.cat(
                [torch.relu(p.float() * a[:, None, None, :] + c[:, None, None, :])
                 for p, (a, c) in zip(parts, pre)], dim=-1)
        x_lib = xa.to(dtype).permute(0, 3, 1, 2)  # channels_last NCHW view
        w_lib = wt.to(dtype).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        b_lib = b.to(dtype)
        ms = time_ms(lambda: conv_bn_act(parts, wt, b, preludes=pre))
        plain_ms = time_ms(lambda: conv_bn_act_reference(parts, wt, b,
                                                         preludes=pre))
        lib_ms = time_ms(lambda: F.conv2d(x_lib, w_lib, b_lib, padding=1))
        bound, t_bytes, t_ops = _bound_ms(1, h, w, cins, cout, prelude)
        rows.append({"name": name, "cins": list(cins), "cout": cout,
                     "hw": [h, w], "ms": ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "bound_ms": bound,
                     "bytes_ms": t_bytes, "ops_ms": t_ops})
        print(f"[kernel time] {name:<20} {'+'.join(map(str, cins))}->{cout} "
              f"@{h}x{w} bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"F.conv2d {lib_ms:.4f} ms, bound {bound:.4f} ms "
              f"({'bytes' if t_bytes >= t_ops else 'operations'}; "
              f"{100 * bound / ms:.1f}% of bound)", flush=True)
    for r, t in zip(rows, fwd_train_step_times()):
        r.update({"b8_" + k: t[k] for k in ("ms", "library_ms", "bound_ms")})
    for key, what, lib_name in (
            ("", "bs-1 forward", "cuDNN"),
            ("b8_", f"B{TRAIN_BATCH} train step with statistics",
             "cuDNN + batch_norm_stats")):
        ms, lib = (sum(r[key + k] for r in rows) for k in ("ms",
                                                           "library_ms"))
        print(f"[kernel time] gub_conv_fwd total, one {what} (nine convs): "
              f"{ms:.4f} ms, {lib_name} {lib:.4f} ms ({ms / lib:.2f}x)",
              flush=True)
    return rows, max_err, n_checks


def _rms(t) -> float:
    """The largest per-channel root mean square of ``t`` ``[..., C]``."""
    return float(t.float().square().mean(dim=tuple(range(t.dim() - 1)))
                 .sqrt().max())


def _bwd_bounds(bsz, h, w, cins, cout, prelude, dx_parts, k=3):
    """Least times (ms) of one bf16 ``gub_conv_dw`` launch and of the
    ``gub_conv_dx`` launches of the parts ``dx_parts``, with statistics:
    (bound, bytes time, operations time) each. Every input is read once and
    every output written once; ``dy`` and ``y`` count once per launch."""
    pix, cin, io = bsz * h * w, sum(cins), 2
    pre = 2 * bsz * cin * 4 if prelude else 0
    dw_bytes = (pix * (cin + 2 * cout) * io + pre + 2 * cout * 4
                + k * k * cin * cout * 4 + cout * 4)
    dw_flops = 2 * pix * k * k * cin * cout
    dx_bytes = dx_flops = 0
    for j in dx_parts:
        cj = cins[j]
        dx_bytes += (pix * 2 * cout * io + 2 * cout * 4   # dy, y, ds, dq
                     + k * k * cj * cout * 4              # the part's weights
                     + pix * cj * io                      # dx
                     + ((pix * cj * io + 4 * bsz * cj * 4) if prelude else 0))
        dx_flops += 2 * pix * k * k * cj * cout

    def bound(nbytes, flops):
        t_b = nbytes / HBM_BYTES_PER_S * 1e3
        t_o = flops / BF16_FLOP_PER_S * 1e3
        return max(t_b, t_o), t_b, t_o

    return bound(dw_bytes, dw_flops), bound(dx_bytes, dx_flops)


def phase_bwd_kernels():
    """``gub_conv_dw`` and ``gub_conv_dx`` against their plain versions, then
    their times at the shapes of one batch-8 bf16 train step.

    Tolerances: ``dx`` and ``dskip`` as the forward (``gub_conv.tolerance``:
    same operands, another order of the f32 sum; one bf16 ulp in bf16);
    ``dw``, ``db``, ``dA``, ``dC`` are f32 sums of bit-equal terms in another
    order: atol ``gub_conv.sum_tolerance(number of terms, rms of a term)``,
    rtol ``gub_conv.SUM_RTOL``."""
    from tpudepth_torch.ops.kernels import gub_conv as gc

    dev = DEVICE
    err = {"dw": 0.0, "dw_rel": 0.0, "dx": 0.0, "dx_sums_rel": 0.0}
    n_checks = {"dw": 0, "dx": 0}

    def cotangents(seed, y, stats):
        rng = np.random.default_rng(1000 + seed)
        dy = torch.from_numpy(rng.standard_normal(tuple(y.shape))
                              .astype(np.float32)).to(dev, y.dtype)
        if not stats:
            return dy, {}
        ds, dq = (torch.from_numpy((0.1 * rng.standard_normal(y.shape[-1]))
                                   .astype(np.float32)).to(dev)
                  for _ in range(2))
        return dy, {"y": y, "ds": ds, "dq": dq}

    def close(got, want, atol, rtol):
        d = (got.float() - want.float()).abs()
        return bool((d <= atol + rtol * want.float().abs()).all()), float(d.max())

    def check_case(tag, seed, bsz, h, w, cins, cout, prelude, skip, stats,
                   dtype, k=3):
        parts, wt, b, pre, sk = make_case(seed, bsz, h, w, cins, cout,
                                          prelude, skip, dtype, dev, k)
        y = gc.conv_bn_act(parts, wt, b, preludes=pre, skip=sk)
        dy, cot = cotangents(seed, y, stats)
        n = bsz * h * w
        g_rms = _rms(gc._cotangent(dy, cot.get("y"), cot.get("ds"),
                                   cot.get("dq")))
        xa_rms = _rms(torch.cat(gc._activate(parts, pre, sk), dim=-1))

        dw, db = gc.conv_bn_act_dw(parts, dy, wt, preludes=pre, skip=sk, **cot)
        torch.cuda.synchronize()
        rdw, rdb = gc.conv_bn_act_dw_reference(parts, dy, k, preludes=pre,
                                               skip=sk, **cot)
        ok_w, e_w = close(dw, rdw, gc.sum_tolerance(n, xa_rms * g_rms),
                          gc.SUM_RTOL)
        ok_b, e_b = close(db, rdb, gc.sum_tolerance(n, g_rms), gc.SUM_RTOL)
        dw2, db2 = gc.conv_bn_act_dw(parts, dy, wt, preludes=pre, skip=sk,
                                     **cot)
        same = torch.equal(dw, dw2) and torch.equal(db, db2)
        err["dw"] = max(err["dw"], e_w, e_b)
        err["dw_rel"] = max(err["dw_rel"], e_w / float(rdw.abs().max()),
                            e_b / float(rdb.abs().max()))
        n_checks["dw"] += 1
        del rdw, rdb, dw2, db2

        atol, rtol = gc.tolerance(dtype)
        e_x = e_s = 0.0
        ok_x = True
        off = 0
        for j, x in enumerate(parts):
            kw = dict(prelude=pre[j] if prelude else None,
                      want_skip=skip and j == 0, **cot)
            got = gc.conv_bn_act_dx(x, wt, off, dy, **kw)
            torch.cuda.synchronize()
            cin = x.shape[-1]
            want = gc.conv_bn_act_dx_reference(x, wt[:, :, off:off + cin],
                                               dy, **kw)
            again = gc.conv_bn_act_dx(x, wt, off, dy, **kw)
            for name, g, r, g2 in zip(("dx", "dA", "dC", "dskip"), got, want,
                                      again):
                check((g is None) == (r is None), f"{tag} {name} presence")
                if g is None:
                    continue
                same = same and torch.equal(g, g2)
                if name in ("dx", "dskip"):
                    ok, e = close(g, r, atol, rtol)
                    e_x = max(e_x, e)
                else:
                    # sums over H*W of dp (dC) and dp * x (dA), |dp| <= |dxa|
                    dxa_rms = _rms(want[3] if want[3] is not None
                                   else want[0] / pre[j][0][:, None, None, :])
                    term = dxa_rms * (_rms(x) if name == "dA" else 1.0)
                    ok, e = close(g, r, gc.sum_tolerance(h * w, term),
                                  gc.SUM_RTOL)
                    e_s = max(e_s, e / float(r.abs().max()))
                ok_x = ok_x and ok
            off += cin
            n_checks["dx"] += 1
            del got, want, again
        err["dx"] = max(err["dx"], e_x)
        err["dx_sums_rel"] = max(err["dx_sums_rel"], e_s)
        print(f"[kernel] bwd {tag:<24} {str(dtype)[6:]:<8} B{bsz} "
              f"pre={int(prelude)} skip={int(skip)} stats={int(stats)}: dw "
              f"max_abs_err {e_w:.3e} db {e_b:.3e} (of max|dw| "
              f"{float(dw.abs().max()):.3e}); dx max_abs_err {e_x:.3e} (atol "
              f"{atol:g} rtol {rtol:g}); dA/dC max err / max {e_s:.2e}; "
              f"repeat bit-equal {same}", flush=True)
        check(ok_w and ok_b, f"{tag} {dtype} dw/db beyond tolerance")
        check(ok_x, f"{tag} {dtype} dx/dskip/dA/dC beyond tolerance")
        check(same, f"{tag} {dtype} backward kernels do not repeat")

    for i, (name, cins, cout, h, w, prelude) in enumerate(PATH_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            check_case(name, i, TRAIN_BATCH, h, w, cins, cout, prelude, False,
                       True, dtype)
            torch.cuda.empty_cache()
    for dtype in (torch.float32, torch.bfloat16):
        check_case("ragged 33x47 +skip", 50, 2, 33, 47, (16,), 8, True, True,
                   True, dtype)
        check_case("k=1 (5,7)->12 +skip", 51, 2, 17, 29, (5, 7), 12, True,
                   True, False, dtype, k=1)
        check_case("3 parts ->40", 52, 3, 9, 18, (4, 2, 3), 40, True, False,
                   True, dtype)
        check_case("rgb no stats", 53, 2, 40, 56, (3,), 16, False, False,
                   False, dtype)

    # Device times at the shapes of one B8 bf16 train step (statistics on).
    # gub_conv_dx runs for every part that needs a gradient: the depth
    # feature and both parts of the comb conv, not the RGB guide.
    rows = []
    conv_bwd = torch.ops.aten.convolution_backward
    for i, (name, cins, cout, h, w, prelude) in enumerate(PATH_SHAPES):
        dtype = torch.bfloat16
        parts, wt, b, pre, _ = make_case(i, TRAIN_BATCH, h, w, cins, cout,
                                         prelude, False, dtype, dev)
        y = gc.conv_bn_act(parts, wt, b, preludes=pre)
        dy, cot = cotangents(i, y, True)
        dx_parts = [] if cins == (3,) else list(range(len(cins)))
        offs = np.cumsum([0, *cins])

        def run_dx():
            for j in dx_parts:
                gc.conv_bn_act_dx(parts[j], wt, int(offs[j]), dy,
                                  prelude=pre[j] if prelude else None, **cot)

        def plain_dx():
            for j in dx_parts:
                gc.conv_bn_act_dx_reference(
                    parts[j], wt[:, :, offs[j]:offs[j + 1]], dy,
                    prelude=pre[j] if prelude else None, **cot)

        x_lib = torch.cat(gc._activate(parts, pre, None), dim=-1).permute(
            0, 3, 1, 2)                       # channels_last NCHW view
        w_lib = wt.to(dtype).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        g_lib = dy.permute(0, 3, 1, 2)

        def lib(mask):
            return conv_bwd(g_lib, x_lib, w_lib, [cout], [1, 1], [1, 1],
                            [1, 1], False, [0, 0], 1, mask)

        row = {"name": name, "cins": list(cins), "cout": cout, "hw": [h, w],
               "dx_launches": len(dx_parts)}
        row["dw_ms"] = time_ms(lambda: gc.conv_bn_act_dw(
            parts, dy, wt, preludes=pre, **cot), per_graph=4, replays=10)
        row["dw_plain_ms"] = time_ms(lambda: gc.conv_bn_act_dw_reference(
            parts, dy, 3, preludes=pre, **cot), per_graph=1, replays=5)
        row["dw_library_ms"] = time_ms(lambda: lib([False, True, True]),
                                       per_graph=4, replays=10)
        (row["dw_bound_ms"], row["dw_bytes_ms"], row["dw_ops_ms"]), \
            (row["dx_bound_ms"], row["dx_bytes_ms"], row["dx_ops_ms"]) = \
            _bwd_bounds(TRAIN_BATCH, h, w, cins, cout, prelude, dx_parts)
        row["dx_ms"] = row["dx_plain_ms"] = row["dx_library_ms"] = 0.0
        if dx_parts:
            row["dx_ms"] = time_ms(run_dx, per_graph=4, replays=10)
            row["dx_plain_ms"] = time_ms(plain_dx, per_graph=1, replays=5)
            row["dx_library_ms"] = time_ms(lambda: lib([True, False, False]),
                                           per_graph=4, replays=10)
        rows.append(row)
        dx_share = (f"{100 * row['dx_bound_ms'] / row['dx_ms']:.1f}%"
                    if dx_parts else "-")
        print(f"[kernel time] {name:<20} {'+'.join(map(str, cins))}->{cout} "
              f"@{h}x{w} B{TRAIN_BATCH} bf16: gub_conv_dw {row['dw_ms']:.4f} "
              f"ms (plain {row['dw_plain_ms']:.3f}, cuDNN dw+db "
              f"{row['dw_library_ms']:.4f}, bound {row['dw_bound_ms']:.4f}: "
              f"{100 * row['dw_bound_ms'] / row['dw_ms']:.1f}%); gub_conv_dx "
              f"x{len(dx_parts)} {row['dx_ms']:.4f} ms (plain "
              f"{row['dx_plain_ms']:.3f}, cuDNN dx {row['dx_library_ms']:.4f}, "
              f"bound {row['dx_bound_ms']:.4f}: {dx_share})", flush=True)
        del parts, y, dy, cot, x_lib, g_lib
        torch.cuda.empty_cache()
    for which, lib_name in (("dw", "cuDNN dw+db"), ("dx", "cuDNN dx")):
        ms, lib, bound = (sum(r[f"{which}_{key}"] for r in rows)
                          for key in ("ms", "library_ms", "bound_ms"))
        print(f"[kernel time] gub_conv_{which} total, one B{TRAIN_BATCH} bf16 "
              f"train step ({sum(1 if which == 'dw' else r['dx_launches'] for r in rows)} "
              f"launches): {ms:.4f} ms, {lib_name} {lib:.4f} ms "
              f"({ms / lib:.2f}x), bound {bound:.4f} ms "
              f"({100 * bound / ms:.1f}%)", flush=True)
    return rows, err, n_checks


def make_loss_pair(kind, bsz, h, w, dev, seed=0):
    """``(pred, target)`` ``[B,H,W]`` f32 on ``dev``. ``norm``: a target of
    ``depth_norm`` scale (uniform in [1, 100]) with a prediction around it;
    ``zeros``: the same with a third of the target pixels 0; ``equal``:
    pred == target; ``smooth``: piecewise-constant images; ``random``: both
    uniform in [0, 10)."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        p = rng.random((bsz, h, w)) * 10
        t = rng.random((bsz, h, w)) * 10
    elif kind == "smooth":
        t = np.repeat(np.repeat(rng.integers(1, 9, (bsz, -(-h // 8), -(-w // 8))),
                                8, axis=1), 8, axis=2)[:, :h, :w].astype(float)
        p = t.copy()
        p[:, : h // 2] += 1.0
    else:
        t = rng.uniform(1.0, 100.0, (bsz, h, w))
        p = t * rng.uniform(0.5, 1.5, (bsz, h, w))
        if kind == "zeros":
            t[rng.random((bsz, h, w)) < 0.33] = 0.0
        if kind == "equal":
            p = t.copy()

    def put(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    return put(p), put(t)


def time_eager_ms(fn, calls: int = 20) -> float:
    """Device time of one call of ``fn`` run eagerly: ``calls`` calls between
    one pair of CUDA events, after a warm-up. For work that a CUDA graph does
    not take (an autograd backward); it counts host gaps where the host is
    slower than the card."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def loss_kernel_count(name, fn) -> dict:
    """The CUDA kernels one call of a loss kernel's wrapper launches
    (``tpudepth_torch.utils.profiling.graph_kernels``: the kernel nodes of a
    CUDA graph of one call), printed as ``[loss kernel count]``."""
    from tpudepth_torch.utils.profiling import graph_kernels

    count = graph_kernels(fn)
    print(f"[loss kernel count] {name}: {count} CUDA kernel(s) a call",
          flush=True)
    return {"cuda_kernels": count}


def phase_loss_kernels():
    """``fused_loss_fwd`` and ``fused_loss_bwd`` against their plain versions
    (tolerance: ``fused_loss.tolerance``, from the arithmetic), then their
    times at the training path's shape."""
    from tpudepth_torch.losses.losses import DepthLoss
    from tpudepth_torch.ops.kernels import fused_loss as fl

    dev = DEVICE
    err = {"fwd": 0.0, "bwd": 0.0, "bwd_rel": 0.0}
    for case in LOSS_CASES:
        kind, bsz, h, w = case
        p, t = make_loss_pair(kind, bsz, h, w, dev)
        n = h * w
        tol = fl.tolerance(p, t, MAX_DEPTH)
        got = fl.fused_partials(p, t, MAX_DEPTH)
        torch.cuda.synchronize()
        want = fl.fused_partials_reference(p, t, MAX_DEPTH)
        d = (got - want).abs()
        ok = bool((d[:, [0, 2]] <= tol["partials_rtol"] * want[:, [0, 2]].abs()).all()
                  and (d[:, 1] <= tol["ssim_atol"]).all())
        e_fwd = float(d.max()) / n      # error of the per-pixel means
        err["fwd"] = max(err["fwd"], e_fwd)
        again = fl.fused_partials(p, t, MAX_DEPTH)
        print(f"[kernel] fused_loss_fwd {kind:<7} B{bsz} {h}x{w}: partials/N "
              f"max_abs_err {e_fwd:.3e} (SSIM sum err {float(d[:, 1].max()):.3e}"
              f" <= atol {float(tol['ssim_atol'].min()):.3e}; L1, grad rtol "
              f"{tol['partials_rtol']:g}); repeat bit-equal "
              f"{torch.equal(got, again)}", flush=True)
        check(ok, f"fused_loss_fwd {case} beyond tolerance")
        check(torch.equal(got, again), f"fused_loss_fwd {case} does not repeat")
        if kind == "equal":
            check(bool((got[:, 1] == n).all() and (got[:, [0, 2]] == 0).all()),
                  "pred == target must give SSIM sum N and zero L1 / gradient")

        total = bsz * n
        scales = torch.tensor([0.1 / total, -0.5 / total, 1.0 / total],
                              device=dev)
        gk = fl.fused_bwd(p, t, MAX_DEPTH, scales)
        torch.cuda.synchronize()
        gr = fl.fused_bwd_reference(p, t, MAX_DEPTH, scales)
        bound = (0.5 / total) * tol["grad_atol"] + tol["grad_rtol"] * gr.abs()
        dg = (gk - gr).abs()
        e_bwd = float(dg.max())
        e_rel = e_bwd / max(float(gr.abs().max()), 1e-30)
        err["bwd"] = max(err["bwd"], e_bwd)
        if kind != "equal":   # there the gradient itself is rounding noise
            err["bwd_rel"] = max(err["bwd_rel"], e_rel)
        scales[1] = 0.0   # without the SSIM term only signs are left: exact
        signs_equal = torch.equal(fl.fused_bwd(p, t, MAX_DEPTH, scales),
                                  fl.fused_bwd_reference(p, t, MAX_DEPTH, scales))
        print(f"[kernel] fused_loss_bwd {kind:<7} B{bsz} {h}x{w}: max_abs_err "
              f"{e_bwd:.3e} of max|dL/dp| {float(gr.abs().max()):.3e} (rel "
              f"{e_rel:.3e}; largest share of its bound "
              f"{float((dg / bound.clamp_min(1e-30)).max()):.3f}); sign terms "
              f"bit-equal {signs_equal}", flush=True)
        check(bool((dg <= bound).all()), f"fused_loss_bwd {case} beyond tolerance")
        check(signs_equal, f"fused_loss_bwd {case}: sign terms differ")

    # device times at the training shape, targets of depth_norm scale
    bsz, (h, w) = TRAIN_BATCH, TRAIN_HW
    p, t = make_loss_pair("norm", bsz, h, w, dev)
    pixels = bsz * h * w
    scales = torch.tensor([0.1 / pixels, -0.5 / pixels, 1.0 / pixels], device=dev)
    loss = DepthLoss(0.1, 1.0, 1.0, MAX_DEPTH)
    p4, t4 = p[:, None], t[:, None]
    pg = p4.clone().requires_grad_(True)
    lib_fwd = time_eager_ms(lambda: loss(p4, t4))
    lib_both = time_eager_ms(
        lambda: torch.autograd.grad(loss(pg, t4), pg))
    rows = {}
    for name, kern, plain, nbytes, flops, lib in (
            ("fused_loss_fwd",
             lambda: fl.fused_partials(p, t, MAX_DEPTH),
             lambda: fl.fused_partials_reference(p, t, MAX_DEPTH),
             2 * pixels * 4 + bsz * 3 * 4, pixels * LOSS_FWD_FLOP_PER_PIXEL,
             lib_fwd),
            ("fused_loss_bwd",
             lambda: fl.fused_bwd(p, t, MAX_DEPTH, scales),
             lambda: fl.fused_bwd_reference(p, t, MAX_DEPTH, scales),
             3 * pixels * 4 + 3 * 4, pixels * LOSS_BWD_FLOP_PER_PIXEL,
             lib_both - lib_fwd)):
        ms, plain_ms = time_ms(kern), time_ms(plain, per_graph=2, replays=10)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOP_PER_S * 1e3
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib,
                      "bound_ms": max(t_bytes, t_ops), "bytes_ms": t_bytes,
                      "ops_ms": t_ops,
                      "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                      **loss_kernel_count(name, kern)}
        print(f"[kernel time] {name} B{bsz} {h}x{w} f32: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, DepthLoss "
              f"{'forward' if name.endswith('fwd') else 'autograd backward'} "
              f"{lib:.4f} ms (eager), bound {max(t_bytes, t_ops):.4f} ms "
              f"({rows[name]['bound_by']}: bytes {t_bytes:.4f}, operations "
              f"{t_ops:.4f}; {100 * max(t_bytes, t_ops) / ms:.1f}% of bound)",
              flush=True)
    print(f"[kernel time] DepthLoss forward + autograd backward {lib_both:.4f} "
          f"ms (eager), kernels {rows['fused_loss_fwd']['ms'] + rows['fused_loss_bwd']['ms']:.4f} ms")
    return rows, err


def phase_serving():
    from tpudepth_torch.infer.engine import InferenceEngine
    from tpudepth_torch.models.layers import init_random_
    from tpudepth_torch.models.registry import build_model
    from tpudepth_torch.ops.kernels.gub_conv import conv_bn_act

    shape = (1, 3, 480, 640)
    fused = init_random_(build_model("GuideDepth", gub="fused"), seed=0)
    plain = build_model("GuideDepth", gub="plain")
    plain.load_state_dict(fused.state_dict())
    images = [np.random.default_rng(100 + i).random(shape, dtype=np.float32)
              for i in range(8)]

    engine = InferenceEngine(fused, shape, compute_dtype=torch.bfloat16,
                             flip_tta=True, max_depth=10.0)
    engine(images[0])  # first call: cuDNN set-up; not one of the requests
    torch.cuda.synchronize()

    # the main path: 8 requests, the kernel's launches counted over them only
    conv_bn_act.launches = 0
    t0 = time.perf_counter()
    served = [engine(img) for img in images]
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    launches = conv_bn_act.launches
    print(f"[serve] 8 requests (bf16, fused, flip-TTA, meters) in "
          f"{t_serve:.3f} s host clock; gub_conv_fwd launches {launches}",
          flush=True)
    check(launches == 18 * len(images),
          f"{launches} launches for {len(images)} requests, expected 18 each")
    for out in served:
        check(tuple(out.shape) == (1, 1, 480, 640), f"shape {out.shape}")
        check(bool(torch.isfinite(out).all()), "non-finite depth")
        check(float(out.min()) >= 0.0 and float(out.max()) <= 10.0,
              "depth outside [0, 10] m")

    # the same answers from the plain f32 model, raw and in meters
    def answers(model, dtype, max_depth):
        eng = InferenceEngine(model, shape, compute_dtype=dtype,
                              flip_tta=True, max_depth=max_depth)
        return [eng(img).float() for img in images]

    ref_m = answers(plain, torch.float32, 10.0)
    ref = answers(plain, torch.float32, None)
    raw_bf16 = answers(fused, torch.bfloat16, None)
    raw_f32 = answers(fused, torch.float32, None)
    errs = {}
    for tag, got in (("bf16 fused", raw_bf16), ("f32 fused", raw_f32)):
        g, r = torch.cat(got), torch.cat(ref)
        rel_l2 = float((g - r).norm() / r.norm())
        rel_max = float((g - r).abs().max() / r.abs().max())
        errs[tag] = (rel_l2, rel_max)
        print(f"[serve] raw output, {tag} vs f32 plain: rel L2 {rel_l2:.3e}, "
              f"max abs / max|ref| {rel_max:.3e} (ref std "
              f"{float(r.std()):.3e}, max|ref| {float(r.abs().max()):.3e})")
    gm, rm = torch.cat(served), torch.cat(ref_m)
    print(f"[serve] meters, bf16 fused vs f32 plain: mean abs "
          f"{float((gm - rm).abs().mean()):.3e} m, share within 1%: "
          f"{float(((gm - rm).abs() <= 0.01 * rm).float().mean()):.4f}")
    check(float(torch.cat(ref).std()) > 1e-2, "reference output is constant")
    check(errs["f32 fused"][1] <= SERVE_F32_REL_MAX,
          f"f32 fused vs f32 plain beyond {SERVE_F32_REL_MAX}")
    check(errs["bf16 fused"][0] <= SERVE_BF16_REL_L2
          and errs["bf16 fused"][1] <= SERVE_BF16_REL_MAX,
          f"bf16 fused vs f32 plain beyond {SERVE_BF16_REL_L2} (L2) / "
          f"{SERVE_BF16_REL_MAX} (max)")

    # engine throughput: the CLI's bf16 engine (meters, no TTA)
    perf = {}
    for bs in (1, 8):
        for gub, model in (("fused", fused), ("plain", plain)):
            eng = InferenceEngine(model, (bs, 3, 480, 640),
                                  compute_dtype=torch.bfloat16,
                                  max_depth=10.0)
            torch.cuda.reset_peak_memory_stats()
            stats = eng.benchmark(100, 10)
            mem = torch.cuda.max_memory_allocated() / 2**20
            perf[f"{gub}_bs{bs}"] = stats["images_per_second"]
            print(f"[engine] GuideDepth 480x640 bf16 {gub:<5} bs{bs}: "
                  f"{stats['images_per_second']:.1f} img/s, "
                  f"{1e3 * stats['seconds_per_frame']:.3f} ms/batch mean, "
                  f"{1e3 * stats['median_seconds_per_frame']:.3f} ms median, "
                  f"peak memory {mem:.0f} MiB", flush=True)
            profile_engine(eng, f"{gub} bs{bs}")
    return launches, errs, perf


def profile_engine(eng, tag: str, runs: int = 5):
    """Profile ``runs`` engine calls on a zero image."""
    example = torch.zeros(eng.input_shape, device="cuda")
    profile_window(lambda: eng(example), tag, runs)


def profile_window(fn, tag: str, runs: int):
    """Device busy share of ``runs`` calls of ``fn`` (kernel time summed by
    the profiler over the host-clock window) and the kernels that take
    most."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # kernels and copies only: a record_function range that the profiler
    # mirrors onto the device timeline (Optimizer.step#...) is no device work
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        print(f"[profile] {tag}: no device time in the trace (not measured)")
        return
    n_launch = sum(e.count for e in kernels)
    print(f"[profile] {tag}: device busy {busy_us / runs / 1e3:.3f} ms of "
          f"{wall_us / runs / 1e3:.3f} ms per call ({100 * busy_us / wall_us:.1f}%"
          f" busy), {n_launch / runs:.0f} kernel launches per call")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[profile] {tag}:   {e.self_device_time_total / runs / 1e3:8.3f} "
              f"ms/call  x{e.count // runs:<4} {e.key[:90]}")
    sys.stdout.flush()


class SyntheticLoader:
    """``n`` seeded batches as a loader of the port delivers them: NHWC
    ``image`` raw uint8 and ``depth`` raw uint8 (training) or float in
    [0, 1] (validation), NYU-like with a tenth of the depth pixels 0."""

    def __init__(self, n: int, seed: int, raw_depth: bool):
        rng = np.random.default_rng(seed)
        h, w = TRAIN_HW
        self.batches = []
        for _ in range(n):
            image = rng.integers(0, 256, (TRAIN_BATCH, h, w, 3), dtype=np.uint8)
            depth = rng.integers(1, 256, (TRAIN_BATCH, h, w, 1), dtype=np.uint8)
            depth[rng.random(depth.shape) < 0.1] = 0
            if not raw_depth:
                depth = depth.astype(np.float32) / 255.0
            self.batches.append({"image": image, "depth": depth})

    def __len__(self):
        return len(self.batches)

    def set_epoch(self, epoch: int):
        pass

    def __iter__(self):
        return iter(self.batches)


# kernel launches of one fused train step / one fused eval forward: the
# nine k=3 GUB convs forward; nine gub_conv_dw; gub_conv_dx for the depth
# feature (1) and both parts of the comb conv (2) of each GUB, none for the
# RGB guide, which needs no gradient
FUSED_FWD_PER_PASS, FUSED_DW_PER_STEP, FUSED_DX_PER_STEP = 9, 9, 9
# one f32 step with fused GUB stages against the same step plain. Where
# nothing else happens the two differ by the order of the f32 sums of the
# nine convs and their gradients (1e-5 of a tensor's largest gradient). But
# each configuration rounds the argument of every ReLU gate and of the
# loss's |.| its own way (``(x - mean) * a + b`` against ``x*A + C``), and
# among 10^8 of them a few lie within rounding of 0 and fall on different
# sides. One such flip changes a parameter gradient by about one term of
# its sum: 1/sqrt(n) of a sum of n terms of random sign, 2.6e-3 at up_1's
# 153,600 pixels (``scripts/torch_gub_f32_probe.py`` counts the flips
# against f64 and shows plain and fused hit alike). Observed between the
# configurations: 0.6-0.7 % of a tensor's largest gradient.
FUSED_STEP_LOSS_RTOL = 1e-4
FUSED_STEP_GRAD_REL = 3e-2
FUSED_STEP_GRAD_FLOOR_REL = 1e-4   # of the largest gradient of all
# the output conv's bias of the models that ``fit`` trains, so that their
# predictions start inside the normalized targets' range [1, 100] and not
# around 0, where the meters conversion clamps nearly every pixel
OUTPUT_BIAS = 3.0


def fit_checkpoint_restore(gub, train_loader, val_loader, tmp):
    """The main training path: ``Trainer.fit`` for 2 epochs x 3 steps with
    one validation batch and one checkpoint per epoch, every kernel's
    launches counted over exactly that run; then the last checkpoint
    restored into a fresh trainer and compared. Returns the trainer, its
    config and the counts."""
    from tpudepth_torch.core.config import TrainConfig
    from tpudepth_torch.models.registry import build_model
    from tpudepth_torch.ops.kernels import fused_loss as fl
    from tpudepth_torch.ops.kernels import gub_conv as gc
    from tpudepth_torch.train.trainer import Trainer

    cfg = TrainConfig(model="GuideDepth", dataset="nyu_reduced",
                      resolution="full", batch_size=TRAIN_BATCH,
                      compute_dtype="bfloat16", log_every=1, seed=0,
                      checkpoint_dir=f"{tmp}/checkpoints_{gub}",
                      results_dir=f"{tmp}/results_{gub}")

    def trainer_for():
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            model = build_model("GuideDepth", gub=gub)
        with torch.no_grad():
            model.up_3.reduce.bias.fill_(OUTPUT_BIAS)
        return Trainer(cfg, model=model, device=DEVICE,
                       train_loader=train_loader, val_loader=val_loader)

    trainer = trainer_for()
    losses = []
    counters = {"fused_loss_fwd": fl.fused_partials, "fused_loss_bwd": fl.fused_bwd,
                "gub_conv_fwd": gc.conv_bn_act, "gub_conv_dw": gc.conv_bn_act_dw,
                "gub_conv_dx": gc.conv_bn_act_dx}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.fit(epochs=2, val_max_batches=1, checkpoint_style="per_epoch",
                log_fn=lambda e, i, n, loss, dt, it: losses.append(loss))
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in counters.items()}
    mem = torch.cuda.max_memory_allocated() / 2**20
    print(f"[train {gub}] fit: 2 epochs x 3 steps, GuideDepth {TRAIN_HW[0]}x"
          f"{TRAIN_HW[1]} B{TRAIN_BATCH} bf16 alhashim, augment on, output "
          f"bias from {OUTPUT_BIAS:g}, in "
          f"{t_fit:.2f} s host clock (first step included); losses "
          f"{[round(x, 4) for x in losses]}; val losses "
          f"{[round(x, 4) for x in trainer.val_losses]}; launches over 6 "
          f"train steps and 2 validation batches {counts}; peak memory "
          f"{mem:.0f} MiB", flush=True)
    check(len(losses) == 6 and all(np.isfinite(losses)),
          f"6 finite train losses expected, got {losses}")
    check(len(trainer.val_losses) == 2
          and all(np.isfinite(trainer.val_losses)), "validation losses")
    check(counts["fused_loss_bwd"] == 6,
          f"fused_loss_bwd launched {counts['fused_loss_bwd']} times in 6 steps")
    check(counts["fused_loss_fwd"] == 6 + 2,
          f"fused_loss_fwd launched {counts['fused_loss_fwd']} times in 6 "
          "steps and 2 validation batches")
    check(trainer.state.step == 6 and trainer.epoch == 2, "step count")
    for name, prm in trainer.model.named_parameters():
        check(bool(torch.isfinite(prm).all()), f"non-finite {name}")

    fresh = trainer_for()
    fresh.init_state()
    fresh.restore(f"{tmp}/checkpoints_{gub}/checkpoint_1")
    check(fresh.epoch == 2 and fresh.state.step == 6, "restored counters")
    check(fresh.val_losses == trainer.val_losses, "restored val_losses")
    saved = trainer.model.state_dict()
    for k, v in fresh.model.state_dict().items():
        check(torch.equal(v, saved[k]), f"restored {k} differs")
    so = trainer.state.optimizer.state_dict()["state"]
    ro = fresh.state.optimizer.state_dict()["state"]
    check(set(so) == set(ro) and len(so) > 100, "optimizer state keys")
    for k in so:
        for field in ("exp_avg", "exp_avg_sq", "step"):
            check(torch.equal(torch.as_tensor(so[k][field]).cpu(),
                              torch.as_tensor(ro[k][field]).cpu()),
                  f"restored optimizer state {k}.{field} differs")
    print(f"[train {gub}] checkpoint_1 restored into a fresh trainer: model, "
          "BatchNorm statistics, Adam moments, epoch and val_losses equal")
    return trainer, cfg, counts


def one_f32_step(cfg, model, batch, recipe):
    """Loss and gradients of one f32 train step (augment off) of ``model``
    (moved to the card) on ``batch``."""
    from tpudepth_torch.train.trainer import (
        TrainState,
        make_optimizer,
        make_train_step,
        step_lr,
    )

    model = model.to(DEVICE, memory_format=torch.channels_last)
    state = TrainState(model, make_optimizer(cfg, model.parameters()))
    step = make_train_step(model, recipe, step_lr(1e-4, 15, 0.1, 3),
                           compute_dtype=torch.float32, augment=False)
    loss = step(state, torch.as_tensor(batch["image"]).to(DEVICE),
                torch.as_tensor(batch["depth"]).to(DEVICE))
    torch.cuda.synchronize()
    return float(loss), {n: p.grad.clone() for n, p in model.named_parameters()}


def compare_steps(tag, got, want, loss_rtol, grad_rel, floor):
    """Hold loss and per-tensor gradients of two steps together: per tensor
    the largest difference over the tensor's largest gradient, with an
    absolute ``floor`` under which a tensor holds noise (conv biases in
    front of a BatchNorm have a zero gradient)."""
    (lk, gk), (lp, gp) = got, want
    worst, worst_name, g_max, n_above = 0.0, "", 0.0, 0
    for name in gk:
        scale = float(gp[name].abs().max())
        diff = float((gk[name] - gp[name]).abs().max())
        g_max = max(g_max, scale)
        if scale > floor:
            n_above += 1
            if diff / scale > worst:
                worst, worst_name = diff / scale, name
        check(diff <= max(grad_rel * scale, floor),
              f"{tag}: gradient of {name}: {diff:.3e} against max {scale:.3e}")
    print(f"[train] one f32 step, {tag}: loss {lk:.8f} vs {lp:.8f} (rel "
          f"{abs(lk - lp) / abs(lp):.2e}, rtol {loss_rtol:g}); gradients of "
          f"{len(gk)} tensors (largest |g| {g_max:.3e}), {n_above} with "
          f"max|g| above the floor {floor:.3g}: largest max|diff|/max|g| "
          f"{worst:.2e} ({worst_name}; bound {grad_rel:g})", flush=True)
    check(n_above > 100, "the gradients are too small to compare")
    check(abs(lk - lp) <= loss_rtol * abs(lp), f"{tag}: step loss")
    return abs(lk - lp) / abs(lp), worst


def phase_training(tmp):
    from tpudepth_torch.core.config import TrainConfig
    from tpudepth_torch.losses.losses import DepthLoss
    from tpudepth_torch.models.registry import build_model
    from tpudepth_torch.ops.kernels import fused_loss as fl
    from tpudepth_torch.train.trainer import LossRecipe, Trainer

    train_loader = SyntheticLoader(3, seed=200, raw_depth=True)
    val_loader = SyntheticLoader(1, seed=201, raw_depth=False)
    trainer, cfg, counts = fit_checkpoint_restore("plain", train_loader,
                                                  val_loader, tmp)
    check(counts["gub_conv_fwd"] == counts["gub_conv_dw"]
          == counts["gub_conv_dx"] == 0, "plain GUB stages launched a GUB kernel")
    out = {"fwd_launches": counts["fused_loss_fwd"],
           "bwd_launches": counts["fused_loss_bwd"]}

    # one f32 step through the loss kernels against the plain DepthLoss
    class PlainRecipe(LossRecipe):
        def loss(self, pred, target):
            return DepthLoss(0.1, 1.0, 1.0, self.max_depth)(pred, target)

    base = build_model("GuideDepth")
    base.load_state_dict(trainer.model.state_dict())
    batch = train_loader.batches[0]
    results = {}
    for tag, recipe_cls in (("kernel", LossRecipe), ("plain", PlainRecipe)):
        recipe = recipe_cls(kind="alhashim", max_depth=MAX_DEPTH,
                            depth_scale=MAX_DEPTH)
        before = fl.fused_bwd.launches
        results[tag] = one_f32_step(cfg, copy.deepcopy(base), batch, recipe)
        check(fl.fused_bwd.launches - before == (1 if tag == "kernel" else 0),
              f"{tag} step launched the backward kernel "
              f"{fl.fused_bwd.launches - before} times")
    out["step_loss_rel"], out["step_grad_rel"] = compare_steps(
        "loss kernels vs plain DepthLoss", results["kernel"], results["plain"],
        STEP_LOSS_RTOL, STEP_GRAD_REL, STEP_GRAD_FLOOR)

    # 8 steps on one fixed batch lower the loss (bf16, lr 1e-3; the same
    # augmentation draw at every step, so the batch is the same)
    cfg8 = TrainConfig(model="GuideDepth", dataset="nyu_reduced",
                       resolution="full", batch_size=TRAIN_BATCH,
                       compute_dtype="bfloat16", learning_rate=1e-3, seed=1)
    fixed = Trainer(cfg8, device=DEVICE, train_loader=train_loader)
    fixed.init_state()
    same_draw = torch.Generator(device=DEVICE)
    curve = [float(fixed.train_step(batch, same_draw.manual_seed(0)))
             for _ in range(8)]
    print(f"[train] 8 steps on one batch (bf16, lr 1e-3): "
          f"{[round(x, 4) for x in curve]}", flush=True)
    check(all(np.isfinite(curve)) and curve[-1] < curve[0],
          "8 steps on one batch did not lower the loss")
    return out, trainer, cfg, (train_loader, val_loader)


def phase_training_fused(tmp, plain_trainer, cfg, loaders):
    """The fused training path, its f32 step against the plain step, and
    both trainers' step times in turns."""
    from tpudepth_torch.models.registry import build_model
    from tpudepth_torch.ops.kernels import gub_conv as gc
    from tpudepth_torch.train.trainer import LossRecipe

    train_loader, val_loader = loaders
    trainer, _, counts = fit_checkpoint_restore("fused", train_loader,
                                                val_loader, tmp)
    want = {"gub_conv_fwd": FUSED_FWD_PER_PASS * (6 + 2),
            "gub_conv_dw": FUSED_DW_PER_STEP * 6,
            "gub_conv_dx": FUSED_DX_PER_STEP * 6}
    for name, n in want.items():
        check(counts[name] == n, f"{name} launched {counts[name]} times over "
              f"6 train steps and 2 validation batches, expected {n}")
    out = {"launches": counts}

    # one f32 step, fused stages against plain stages, same weights and batch
    batch = train_loader.batches[0]
    recipe = LossRecipe(kind="alhashim", max_depth=MAX_DEPTH,
                        depth_scale=MAX_DEPTH)
    results = {}
    for gub in ("fused", "plain"):
        model = build_model("GuideDepth", gub=gub)
        model.load_state_dict(trainer.model.state_dict())
        before = (gc.conv_bn_act.launches, gc.conv_bn_act_dw.launches,
                  gc.conv_bn_act_dx.launches)
        results[gub] = one_f32_step(cfg, model, batch, recipe)
        after = (gc.conv_bn_act.launches, gc.conv_bn_act_dw.launches,
                 gc.conv_bn_act_dx.launches)
        per_step = tuple(a - b for a, b in zip(after, before))
        check(per_step == ((FUSED_FWD_PER_PASS, FUSED_DW_PER_STEP,
                            FUSED_DX_PER_STEP) if gub == "fused" else (0, 0, 0)),
              f"{gub} step launched (fwd, dw, dx) = {per_step}")
    g_all = max(float(g.abs().max()) for g in results["plain"][1].values())
    out["step_loss_rel"], out["step_grad_rel"] = compare_steps(
        "fused GUB stages vs plain", results["fused"], results["plain"],
        FUSED_STEP_LOSS_RTOL, FUSED_STEP_GRAD_REL,
        FUSED_STEP_GRAD_FLOOR_REL * g_all)
    del results

    # step time of both trainers as Trainer.train_step runs them (host batch
    # in, augment on), warm, between CUDA events, in turns; then one
    # profiled window each
    def timed(tr, n_timed=12):
        for b in train_loader.batches:
            tr.train_step(b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(n_timed):
            tr.train_step(train_loader.batches[i % 3])
        end.record()
        end.synchronize()
        return (start.elapsed_time(end) / n_timed,
                torch.cuda.max_memory_allocated() / 2**20)

    times = {"plain": [], "fused": []}
    mem = {}
    for gub, tr in (("plain", plain_trainer), ("fused", trainer),
                    ("fused", trainer), ("plain", plain_trainer)):
        ms, mem[gub] = timed(tr)
        times[gub].append(ms)
    for gub in ("plain", "fused"):
        ms = statistics.mean(times[gub])
        out[f"{gub}_step_ms"] = ms
        out[f"{gub}_img_per_s"] = TRAIN_BATCH / ms * 1e3
        out[f"{gub}_peak_mib"] = mem[gub]
        print(f"[train {gub}] train step GuideDepth {TRAIN_HW[0]}x{TRAIN_HW[1]} "
              f"B{TRAIN_BATCH} bf16: {ms:.2f} ms/step "
              f"({', '.join(f'{t:.2f}' for t in times[gub])}), "
              f"{out[f'{gub}_img_per_s']:.1f} img/s (12 steps between CUDA "
              f"events, warm, turns plain-fused-fused-plain), peak memory "
              f"{mem[gub]:.0f} MiB", flush=True)
    profile_window(lambda: plain_trainer.train_step(batch),
                   "train step plain", 2)
    profile_window(lambda: trainer.train_step(batch), "train step fused", 2)
    return out, trainer


def phase_evaluation(tmp, trainer):
    """The trained fused model, as ``fit`` left it, through
    ``InferenceEngine`` (bf16, meters) and ``AlhashimEvaluator`` over seeded
    synthetic NYU-like batches, beside the same weights as a plain f32 model
    through the same evaluator."""
    from tpudepth_torch.core.config import EvalConfig
    from tpudepth_torch.eval.evaluator import AlhashimEvaluator
    from tpudepth_torch.infer.engine import InferenceEngine
    from tpudepth_torch.models.registry import build_model
    from tpudepth_torch.ops.kernels.gub_conv import conv_bn_act
    from tpudepth_torch.train.trainer import make_eval_step

    cfg = EvalConfig(model="GuideDepth", dataset="nyu_reduced",
                     resolution="full", batch_size=TRAIN_BATCH)
    rng = np.random.default_rng(300)
    h, w = TRAIN_HW
    loader = [{"image": rng.random((TRAIN_BATCH, h, w, 3), dtype=np.float32),
               "depth": rng.random((TRAIN_BATCH, h, w, 1), dtype=np.float32)
               * 0.9 + 0.05} for _ in range(2)]
    weights = trainer.model.state_dict()
    plain = build_model("GuideDepth", gub="plain")
    plain.load_state_dict(weights)
    plain.to(DEVICE, memory_format=torch.channels_last)
    plain_step = make_eval_step(plain, torch.float32)
    # The protocol scores every pixel of the crop and has no mask for a
    # prediction of 0 m, which is what a raw output of exactly 0 becomes
    # (tests/test_torch_port_evaluator.py holds that case against the JAX
    # package: infinite logarithmic metrics). The model starts OUTPUT_BIAS
    # away from 0, so here every raw prediction has to be positive.
    with torch.no_grad():
        lowest = min(float(plain_step(torch.from_numpy(b["image"]).to(DEVICE)
                                      .permute(0, 3, 1, 2)).min())
                     for b in loader)
    check(lowest > 0.0, f"smallest raw prediction {lowest}: the trained "
          "model's output crosses 0")
    fused = build_model("GuideDepth", gub="fused")
    fused.load_state_dict(weights)
    engine = InferenceEngine(fused, (TRAIN_BATCH, 3, h, w),
                             compute_dtype=torch.bfloat16, max_depth=MAX_DEPTH)
    evaluator = AlhashimEvaluator(engine, cfg, forward_returns_meters=True)
    conv_bn_act.launches = 0
    t0 = time.perf_counter()
    avg = evaluator.evaluate(loader, save_results_to=f"{tmp}/eval_fused")
    t_eval = time.perf_counter() - t0
    launches = conv_bn_act.launches
    # 2 batches, each forward on the image and on its flip
    check(launches == FUSED_FWD_PER_PASS * 2 * 2,
          f"evaluation launched gub_conv_fwd {launches} times")

    ref = AlhashimEvaluator(plain_step, cfg).evaluate(
        loader, save_results_to=f"{tmp}/eval_plain")
    with open(f"{tmp}/eval_fused/results.txt") as f:
        header, values = f.read().split("\n")
    check(header == "RMSE,MAE,REL, RMSE_log,Lg10,Delta1,Delta2,Delta3",
          f"results.txt header {header!r}")
    fields = ("rmse", "mae", "absrel", "rmse_log", "lg10", "delta1", "delta2",
              "delta3")
    check(values == ",".join(f"{getattr(avg, k):.3f}" for k in fields),
          f"results.txt values {values!r}")
    print(f"[eval] AlhashimEvaluator, 2 batches of {TRAIN_BATCH} + flips, "
          f"NYU Eigen crop, the weights as fit left them (smallest raw f32 "
          f"prediction {lowest:.3f}), fused bf16 engine in {t_eval:.2f} s "
          f"host clock (gub_conv_fwd launches {launches}); results.txt: "
          f"{values}")
    print(evaluator.format_report(avg).strip().replace("\n", " "))
    out = {}
    for k in fields + ("irmse", "imae", "mse"):
        a, b = getattr(avg, k), getattr(ref, k)
        out[k] = a
        check(np.isfinite(a) and np.isfinite(b), f"metric {k} not finite")
        print(f"[eval] {k:<8} fused bf16 engine {a:.6f}   plain f32 model "
              f"{b:.6f}")
        # bf16 against f32 on the same weights
        check(abs(a - b) <= EVAL_BF16_REL * abs(b) + EVAL_BF16_ABS,
              f"metric {k}: {a} against {b}")
    check(0.0 <= avg.delta1 <= avg.delta2 <= avg.delta3 <= 1.0, "delta order")
    return out, launches


# the attention stages of MobileV3SAMDepth and MobileV3NewCRFDepth at NYU
# 480x640: (name, C, heads, map h x w) of the four stages, in the order a
# forward runs them; each map pads to multiples of 7 (21x21, 35x42, 63x84,
# 126x161), so every stage pads
ATTN_STAGES = [("crf3", 1024, 32, (15, 20)), ("crf2", 512, 16, (30, 40)),
               ("crf1", 256, 8, (60, 80)), ("crf0", 128, 4, (120, 160))]
SAM_BATCH = 8
# the sigmoid map of the bf16 fused (or pair) engine against the f32 plain
# model: ||got - ref|| / ||ref|| and max|got - ref| / max|ref|. Each bf16
# rounding costs up to 2^-9 relative; ~60 layers (MobileNetV3's convs, four
# SAM blocks of LayerNorm, attention and FFN) round the map's inputs about
# 2^-9 * sqrt(60) ~ 1.5e-2 in rms, and the sigmoid's slope (at most 1/4)
# damps that. On an H100 the seeded weights read 3.81e-3 / 2.46e-2 to
# 2.79e-2; the bounds leave about 2.5 times that.
SAM_BF16_REL_L2 = 1e-2
SAM_BF16_REL_MAX = 6e-2
# f32 fused and pair against f32 plain, TF32 off: the kernels sum in other
# orders than the plain products (a few f32 ulps per product of up to 4096
# terms), nothing else differs
SAM_F32_REL_L2 = 1e-4
# the NewCRF map, bf16 engine against the f32 plain model: eight blocks of
# LayerNorm, attention and FFN where SAM has four, ~72 rounded layers against
# ~60. Set at 1.5e-2 / 9e-2 before the first run (SAM's scaled by sqrt 2 for
# twice the blocks); on an H100 the seeded weights read 2.65e-3 to 2.74e-3 /
# 1.01e-2 to 1.07e-2 in the three modes (the map's std is a third of SAM's),
# and the bounds leave about 2.5 times that, as SAM's do
NEWCRF_BF16_REL_L2 = 7e-3
NEWCRF_BF16_REL_MAX = 3e-2


def _sam_kernel_inputs(seed, bsz, windows, c, hidden, m_rows, dtype):
    """Seeded q, k, v, bias of one stage's attention and the rows, weights
    and vectors of its block tail, on the card (unit-scale activations,
    weights of std 1/sqrt(fan_in), LayerNorm scales around 1)."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def n(*shape, s=1.0, mean=0.0, dt=torch.float32):
        return (mean + s * torch.randn(*shape, generator=g, device=DEVICE)).to(dt)

    bw = bsz * windows
    heads = c // 32
    attn = dict(q=n(bw, 49, c, s=32 ** -0.5, dt=dtype), k=n(bw, 49, c, dt=dtype),
                v=n(bw, 49, c, dt=dtype), bias=n(heads, 49, 49, s=0.5))
    m = bsz * m_rows
    tail = dict(o=n(m, c, dt=dtype), x=n(m, c, dt=dtype),
                wproj=n(c, c, s=c ** -0.5), bproj=n(c, s=0.1),
                lns=n(c, s=0.2, mean=1.0), lnb=n(c, s=0.1),
                w1=n(c, hidden, s=c ** -0.5), b1=n(hidden, s=0.1),
                w2=n(hidden, c, s=hidden ** -0.5), b2=n(c, s=0.1))
    return attn, tail


def _padded(hw):
    """The map h x w padded to multiples of the 7 x 7 window."""
    return -(-hw[0] // 7) * 7, -(-hw[1] // 7) * 7


class KernelHold:
    """Holds kernels' outputs against their plain versions, each within its
    ``tolerance`` (atol as a fraction of max|ref|, rtol), and keeps per
    kernel the largest error, absolute and over max|ref| of the same case,
    and the number of checks."""

    def __init__(self, label, names):
        self.label = label
        self.err = {k: 0.0 for k in names}
        self.err_rel = dict(self.err)
        self.checks = {k: 0 for k in names}

    def __call__(self, name, got, want, tol, tag, extra=None):
        """``extra``: an elementwise atol added to the bound."""
        frac, rtol = tol
        g, w = got.float(), want.float()
        scale = float(w.abs().max())
        d = (g - w).abs()
        bound = frac * scale + rtol * w.abs()
        ok = bool((d <= (bound if extra is None else bound + extra)).all())
        e = float(d.max())
        margin = float((d / (bound if extra is None else bound + extra)
                        .clamp(min=1e-30)).max())
        self.err[name] = max(self.err[name], e)
        self.err_rel[name] = max(self.err_rel[name], e / scale)
        self.checks[name] += 1
        print(f"[{self.label}] {name:<20} {tag:<28} max_abs_err {e:.3e} of "
              f"max|ref| {scale:.3e} (atol {frac:g} of it, rtol {rtol:g}"
              f"{'' if extra is None else ', + elementwise atol'}; largest "
              f"err / bound {margin:.3f})", flush=True)
        check(ok, f"{name} {tag} beyond tolerance")


def _bound(nbytes, flops):
    """(bound ms, bytes ms, operations ms) of bf16 work on the card."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / BF16_FLOP_PER_S * 1e3
    return max(t_b, t_o), t_b, t_o


def phase_sam_kernels():
    """``window_attn_infer`` (also with the shift-3 mask),
    ``block_epilogue_infer`` and ``mlp_infer`` against their plain versions
    at the four SAM stage shapes, batch 1 and 8, f32 and bf16, each within
    its ``tolerance`` (``mlp_infer`` also at 8 h w - 3 rows; the attention
    and ``mlp_infer`` rerun bit-equal); then their times at batch 8 in bf16
    (CUDA graph replays) beside the bound, the plain version and one library
    yardstick: ``F.scaled_dot_product_attention`` on the head-split tensors
    with the bias as ``attn_mask`` (the attention also with the shift-3
    mask, bias + mask as ``attn_mask``); the block tail's and the FFN's
    products alone in cuBLAS (bf16, the weights cast beforehand), a lower
    bound on any unfused composition."""
    from tpudepth_torch.ops.kernels import epilogue_infer as ei
    from tpudepth_torch.ops.kernels import mlp_infer as mi
    from tpudepth_torch.ops.kernels import window_attn_infer as wai
    from tpudepth_torch.ops.window import shifted_window_attention_mask

    hold = KernelHold("sam kernel", ("window_attn_infer",
                                     "block_epilogue_infer", "mlp_infer"))
    for i, (stage, c, heads, hw) in enumerate(ATTN_STAGES):
        hp, wp = _padded(hw)
        windows, rows = hp * wp // 49, hw[0] * hw[1]
        mask = torch.from_numpy(
            shifted_window_attention_mask(hp, wp, 7, 3)).to(DEVICE)
        for bsz in (1, SAM_BATCH):
            for dtype in (torch.float32, torch.bfloat16):
                tag = f"{stage} B{bsz} {str(dtype)[6:]}"
                attn, tail = _sam_kernel_inputs(10 * i + bsz, bsz, windows, c,
                                                4 * c, rows, dtype)
                for mk in (None, mask):
                    got = wai.window_attention_infer(**attn, mask=mk)
                    again = wai.window_attention_infer(**attn, mask=mk)
                    torch.cuda.synchronize()
                    want = wai.window_attention_infer_reference(**attn, mask=mk)
                    hold("window_attn_infer", got, want, wai.tolerance(dtype),
                         tag + (" shift-3 mask" if mk is not None else ""))
                    check(torch.equal(got, again),
                          f"window_attn_infer {tag}: a rerun differs")
                    del got, again, want
                got = ei.block_epilogue_infer(**tail)
                torch.cuda.synchronize()
                hold("block_epilogue_infer", got,
                     ei.block_epilogue_infer_reference(**tail),
                     ei.tolerance(dtype), tag)
                args = (tail["o"], tail["w1"], tail["b1"], tail["w2"],
                        tail["b2"])
                # at batch 8 also 8 h w - 3 rows: odd, ragged in every tile
                odd = (tail["o"][:-3],) + args[1:]
                for x_tag, a in ((tag, args), (f"{tag} odd rows", odd)):
                    if a is odd and bsz != SAM_BATCH:
                        continue
                    got, again = mi.mlp_infer(*a), mi.mlp_infer(*a)
                    torch.cuda.synchronize()
                    hold("mlp_infer", got, mi.mlp_infer_reference(*a),
                         mi.tolerance(dtype), f"{x_tag} M {a[0].shape[0]}")
                    check(torch.equal(got, again),
                          f"mlp_infer {x_tag}: a rerun differs")
                del attn, tail, got, again, args, odd
                torch.cuda.empty_cache()

    # device times at batch 8 in bf16, the serving dtype
    rows = {k: [] for k in hold.err}
    for i, (stage, c, heads, hw) in enumerate(ATTN_STAGES):
        hp, wp = _padded(hw)
        windows, m_rows = hp * wp // 49, hw[0] * hw[1]
        mask = torch.from_numpy(
            shifted_window_attention_mask(hp, wp, 7, 3)).to(DEVICE)
        attn, tail = _sam_kernel_inputs(100 + i, SAM_BATCH, windows, c, 4 * c,
                                        m_rows, torch.bfloat16)
        bw, m, hidden = SAM_BATCH * windows, SAM_BATCH * m_rows, 4 * c
        q4, k4, v4 = (attn[k].reshape(bw, 49, heads, 32).transpose(1, 2)
                      .contiguous() for k in ("q", "k", "v"))
        amask = attn["bias"][None].to(torch.bfloat16)
        wp, w1, w2 = (tail[k].to(torch.bfloat16) for k in ("wproj", "w1", "w2"))
        o, x = tail["o"], tail["x"]
        args = (o, tail["w1"], tail["b1"], tail["w2"], tail["b2"])
        g = torch.empty(m, hidden, dtype=torch.bfloat16, device=DEVICE)
        cases = {
            "window_attn_infer": (
                lambda: wai.window_attention_infer(**attn),
                lambda: wai.window_attention_infer_reference(**attn),
                lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=amask,
                                                       scale=1.0),
                _bound(4 * bw * 49 * c * 2 + heads * 49 * 49 * 4,
                       4 * bw * 49 * 49 * c)),
            "block_epilogue_infer": (
                lambda: ei.block_epilogue_infer(**tail),
                lambda: ei.block_epilogue_infer_reference(**tail),
                lambda: (o @ wp, x @ w1, g @ w2),
                _bound(3 * m * c * 2 + (c * c + 2 * c * hidden) * 4
                       + (4 * c + hidden) * 4, 2 * m * c * (c + 2 * hidden))),
            "mlp_infer": (
                lambda: mi.mlp_infer(*args),
                lambda: mi.mlp_infer_reference(*args),
                lambda: (x @ w1, g @ w2),
                _bound(2 * m * c * 2 + 2 * c * hidden * 4 + (c + hidden) * 4,
                       4 * m * c * hidden)),
        }
        for name, (kern, plain, lib, (bound, t_b, t_o)) in cases.items():
            ms = time_ms(kern, per_graph=4, replays=10)
            plain_ms = time_ms(plain, per_graph=1, replays=5)
            lib_ms = time_ms(lib, per_graph=4, replays=10)
            rows[name].append({"name": stage, "windows": bw, "rows": m, "C": c,
                               "heads": heads, "ms": ms, "plain_ms": plain_ms,
                               "library_ms": lib_ms, "bound_ms": bound,
                               "bytes_ms": t_b, "ops_ms": t_o})
            print(f"[sam kernel time] {name:<20} {stage} B{SAM_BATCH} bf16 "
                  f"(M {m}, C {c}): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                  f"ms, library {lib_ms:.4f} ms, bound {bound:.4f} ms "
                  f"({'bytes' if t_b >= t_o else 'operations'}; "
                  f"{100 * bound / ms:.1f}% of bound)", flush=True)
        # the same attention with NewCRF's shift-3 mask (its shifted blocks'
        # calls); SDPA takes bias + mask per window as attn_mask
        amask = (attn["bias"][None] + mask.repeat(SAM_BATCH, 1, 1)[:, None]
                 ).to(torch.bfloat16)
        bound, t_b, t_o = _bound(4 * bw * 49 * c * 2 + heads * 49 * 49 * 4
                                 + mask.numel() * 4, 4 * bw * 49 * 49 * c)
        ms = time_ms(lambda: wai.window_attention_infer(**attn, mask=mask),
                     per_graph=4, replays=10)
        plain_ms = time_ms(lambda: wai.window_attention_infer_reference(
            **attn, mask=mask), per_graph=1, replays=5)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=amask, scale=1.0), per_graph=4, replays=10)
        rows["window_attn_infer"][-1].update(
            mask_ms=ms, mask_plain_ms=plain_ms, mask_library_ms=lib_ms,
            mask_bound_ms=bound)
        print(f"[sam kernel time] window_attn_infer    {stage} B{SAM_BATCH} "
              f"bf16 shift-3 mask: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, library {lib_ms:.4f} ms, bound {bound:.4f} ms "
              f"({'bytes' if t_b >= t_o else 'operations'}; "
              f"{100 * bound / ms:.1f}% of bound)", flush=True)
        del attn, tail, q4, k4, v4, g, args, mask, amask
        torch.cuda.empty_cache()
    return rows, hold.err, hold.err_rel, hold.checks


def _rowblock_inputs(seed, bsz, hw, c, heads, shift, dtype, sam=False):
    """Seeded keyword arguments of one window-row block call on the card: raw
    x, v zero-padded to multiples of 7 (rolled by -shift), weights [in, out]
    of std 1/sqrt(fan_in), LayerNorm scales around 1, the bias and the shift
    mask; and the keyword options (scale, window, valid extent)."""
    from tpudepth_torch.ops.window import shifted_window_attention_mask

    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def n(*shape, s=1.0, mean=0.0):
        return mean + s * torch.randn(*shape, generator=g, device=DEVICE)

    h, w = hw
    hp, wp = _padded(hw)
    hidden = 4 * c
    x = torch.zeros(bsz, hp, wp, c, device=DEVICE)
    v = torch.zeros(bsz, hp, wp, c, device=DEVICE)
    x[:, :h, :w] = n(bsz, h, w, c)
    v[:, :h, :w] = n(bsz, h, w, c)
    if shift:
        x, v = (torch.roll(t, (-shift, -shift), dims=(1, 2)) for t in (x, v))
    ln = lambda: (n(c, s=0.2, mean=1.0), n(c, s=0.1))  # noqa: E731
    a = dict(x=x.to(dtype).contiguous(), v=v.to(dtype).contiguous(), ln1=ln())
    if sam:
        a.update(lnv=ln(), wq=n(c, c, s=c ** -0.5), bq=n(c, s=0.1),
                 wkv=n(c, 2 * c, s=c ** -0.5), bkv=n(2 * c, s=0.1))
    else:
        a.update(wqk=n(c, 2 * c, s=c ** -0.5), bqk=n(2 * c, s=0.1))
    a.update(bias=n(heads, 49, 49, s=0.5), wproj=n(c, c, s=c ** -0.5),
             bproj=n(c, s=0.1), ln2=ln(), w1=n(c, hidden, s=c ** -0.5),
             b1=n(hidden, s=0.1), w2=n(hidden, c, s=hidden ** -0.5),
             b2=n(c, s=0.1))
    kw = dict(scale=(c // heads) ** -0.5, window_size=7)
    if sam:
        kw["valid_hw"] = (h, w)
    else:
        a["mask"] = (torch.from_numpy(shifted_window_attention_mask(
            h, w, 7, shift)).to(DEVICE) if shift else None)
        kw["valid_hw"] = (h, w, shift)
    return a, kw


def _rowblock_library(a, sam):
    """The library yardstick of one block: its four cuBLAS bf16 products
    alone (qk, or q and kv; proj; fc1; fc2) and
    ``F.scaled_dot_product_attention`` of the head-split windows with bias
    (and mask) as ``attn_mask``; the operands are cast and laid out
    beforehand. A lower bound on any unfused composition."""
    from tpudepth_torch.ops.window import window_partition

    x = a["x"]
    b, hp, wp, c = x.shape
    heads = a["bias"].shape[0]
    m = b * hp * wp
    bf = torch.bfloat16
    xf = x.reshape(m, c)
    wts = ([a["wq"].to(bf), a["wkv"].to(bf)] if sam else [a["wqk"].to(bf)])
    wp_, w1, w2 = (a[k].to(bf) for k in ("wproj", "w1", "w2"))
    g = torch.empty(m, w1.shape[1], dtype=bf, device=DEVICE)
    q4 = (window_partition(x, 7).reshape(-1, 49, heads, c // heads)
          .transpose(1, 2).contiguous())
    nw = (hp // 7) * (wp // 7)
    am = a["bias"][None].expand(nw, -1, -1, -1)
    if a.get("mask") is not None:
        am = am + a["mask"][:, None]
    am = am.repeat(b, 1, 1, 1).to(bf).contiguous()

    def run():
        for wt in wts:
            xf @ wt
        F.scaled_dot_product_attention(q4, q4, q4, attn_mask=am, scale=1.0)
        xf @ wp_
        xf @ w1
        g @ w2

    return run


def _rowblock_bound(bsz, hw, c, heads, sam, shift):
    """(bound ms, bytes ms, operations ms) of one bf16 block call, counting
    the work that the cropped output needs, over the m = B h w real tokens
    alone: a pad token's key and value are its projection's bias (its
    LayerNorm is zeroed) and a pad query's row is cropped. Bytes: x and v
    read and the output written for the real tokens (bf16), the weights in
    bf16 as the kernels read them, the bias table (and the shift mask) and
    the vectors in f32. Operations: 22 C^2 (SAM 24 C^2: q, k v, proj, FFN)
    a real token, and 4 49 C for its query's attention over one window."""
    m = bsz * hw[0] * hw[1]
    hp, wp = _padded(hw)
    per_token = (24 if sam else 22) * c * c + 4 * 49 * c
    weights = (12 if sam else 11) * c * c
    tables = heads * 49 * 49 + (hp * wp if shift else 0) * 49
    vectors = (15 if sam else 12) * c
    return _bound(3 * m * c * 2 + 2 * weights + 4 * (tables + vectors),
                  m * per_token)


def _block_inputs(seed, bsz, hw, c, heads, shift, dtype, sam=False):
    """The arguments of ``_rowblock_inputs`` as those of one whole-block
    call: the raw windows of the padded (and rolled) x and v, and the valid
    table of the map. Returns (arguments, options, the image-layout
    arguments)."""
    from tpudepth_torch.ops.window import (window_partition,
                                           window_valid_mask_on)

    a, kw = _rowblock_inputs(seed, bsz, hw, c, heads, shift, dtype, sam=sam)
    wa = {k: t for k, t in a.items() if k not in ("x", "v")}
    wa["xw"], wa["vw"] = (window_partition(a[k], 7).reshape(-1, 49, c)
                          .contiguous() for k in ("x", "v"))
    wa["valid"] = window_valid_mask_on(*hw, 7, shift, DEVICE)
    return wa, dict(scale=kw["scale"]), a


def _whole_block_phase(label, fns, tolerance, inputs, modes, seeds):
    """A NewCRF and a SAM whole-block kernel (``fns``: name -> (kernel,
    plain version), NewCRF's first) against their plain versions at the
    four stage shapes of 480x640 (every stage pads), batch 1 and 8, f32 and
    bf16, NewCRF at shift 0 and 3 (rolled inputs, the rolled valid
    geometry, the mask), each within ``tolerance`` and every call rerun
    bit-equal; then at batch 8 in bf16 the time of one forward's calls
    (CUDA graph replays; NewCRF: the two blocks of each stage, 8 calls;
    SAM: 4) beside the bound, the plain version, the library yardstick of
    ``_rowblock_library`` and the port's block module of the same block on
    the unpadded map in each of ``modes``. ``inputs`` is
    ``_block_inputs``' signature; ``seeds`` the seed bases of the checks
    and of the timing."""
    from tpudepth_torch.models.newcrf import CRFBlock
    from tpudepth_torch.models.sam import SAMBlock

    crf, sam_name = fns
    cases = ((crf, 0), (crf, 3), (sam_name, 0))
    hold = KernelHold(label, fns)
    for i, (stage, c, heads, hw) in enumerate(ATTN_STAGES):
        for bsz in (1, SAM_BATCH):
            for dtype in (torch.float32, torch.bfloat16):
                for name, shift in cases:
                    kern, plain = fns[name]
                    a, kw, _ = inputs(seeds[0] * i + bsz + shift, bsz, hw, c,
                                      heads, shift, dtype,
                                      sam=name == sam_name)
                    tag = f"{stage} B{bsz} {str(dtype)[6:]} shift {shift}"
                    got = kern(**a, **kw)
                    torch.cuda.synchronize()
                    hold(name, got, plain(**a, **kw), tolerance(dtype), tag)
                    check(torch.equal(got, kern(**a, **kw)),
                          f"{name} {tag}: a rerun is not bit-equal")
                    del a, got
                torch.cuda.empty_cache()

    rows = {k: [] for k in fns}
    for i, (stage, c, heads, hw) in enumerate(ATTN_STAGES):
        for name, shift in cases:
            sam = name == sam_name
            kern, plain = fns[name]
            a, kw, image = inputs(seeds[1] + i + shift, SAM_BATCH, hw, c,
                                  heads, shift, torch.bfloat16, sam=sam)
            h, w = hw
            block = {}
            for mode in modes:
                blk = (SAMBlock(c, heads, 7, mode=mode) if sam else
                       CRFBlock(c, heads, 7, shift_size=shift, mode=mode))
                block[mode] = blk.to(DEVICE).eval()
                block[mode].load_state_dict(block[modes[0]].state_dict())
            xb = torch.randn(SAM_BATCH, h, w, c, device=DEVICE,
                             dtype=torch.bfloat16)
            vb = torch.randn(SAM_BATCH, h, w, c, device=DEVICE,
                             dtype=torch.bfloat16)
            bound, t_b, t_o = _rowblock_bound(SAM_BATCH, hw, c, heads, sam,
                                              shift)
            with torch.inference_mode():
                ms = time_ms(lambda: kern(**a, **kw), per_graph=4, replays=10)
                plain_ms = time_ms(lambda: plain(**a, **kw), per_graph=1,
                                   replays=5)
                lib_ms = time_ms(_rowblock_library(image, sam), per_graph=4,
                                 replays=10)
                module_ms = {mode: time_ms(lambda: blk(xb, vb), per_graph=4,
                                           replays=10)
                             for mode, blk in block.items()}
            rows[name].append({
                "name": stage, "shift": shift, "C": c, "heads": heads,
                "tokens": SAM_BATCH * h * w,
                "padded_tokens": image["x"].shape[:3].numel(),
                "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": bound, "bytes_ms": t_b, "ops_ms": t_o,
                **{f"{mode}_module_ms": t for mode, t in module_ms.items()}})
            print(f"[{label} time] {name:<19} {stage} shift {shift} "
                  f"B{SAM_BATCH} bf16 (C {c}): kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
                  f"{bound:.4f} ms ({'bytes' if t_b >= t_o else 'operations'}"
                  f"; {100 * bound / ms:.1f}% of bound); the block as a "
                  "module: " + ", ".join(f"{m} {t:.4f} ms"
                                         for m, t in module_ms.items()),
                  flush=True)
            del a, image, block, xb, vb
            torch.cuda.empty_cache()
    return rows, hold.err, hold.err_rel, hold.checks


def split_ms(fn, calls: int = 3):
    """Device ms per call of each CUDA kernel ``fn`` launches, by name, from
    a ``torch.profiler`` trace of ``calls`` calls: [(name, ms, count)]."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = [(e.key, e.self_device_time_total / calls / 1e3, e.count // calls)
           for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0]
    return sorted(out, key=lambda r: -r[1])


def kernel_splits():
    """One B 8 bf16 call a SAM / NewCRF stage of ``sam_rowblock_infer``,
    ``crf_rowblock_infer`` (shift 0 and 3), ``sam_block_infer`` and
    ``crf_block_infer`` (shift 0 and 3) split into its CUDA kernels by
    ``split_ms`` ([row kernel split], [block kernel split]: the LayerNorm
    passes, the products on the wgmma core by epilogue, the attention, the
    wrapper's weight casts), and one of ``window_attn_train_bwd`` (the
    backward kernel and ``dbias_sum_kernel``, [train kernel split]): {"kernel[
    shift s]": {stage: split}}."""
    from tpudepth_torch.ops.kernels import block_infer as bi
    from tpudepth_torch.ops.kernels import rowblock_infer as rbi
    from tpudepth_torch.ops.kernels import window_attn as wat

    def attn_bwd(seed, bsz, hw, c, heads, shift, dtype, sam):
        hp, wp = _padded(hw)
        attn, ga = _train_kernel_inputs(seed, bsz, hp * wp // 49, c, heads,
                                        1, dtype)[:2]
        return dict(attn, mask=None, g=ga), {}

    cases = (("row", rbi.sam_rowblock_infer, 0, True, 200),
             ("row", rbi.crf_rowblock_infer, 0, False, 210),
             ("row", rbi.crf_rowblock_infer, 3, False, 220),
             ("block", bi.sam_block_infer, 0, True, 230),
             ("block", bi.crf_block_infer, 0, False, 240),
             ("block", bi.crf_block_infer, 3, False, 250),
             ("train", wat.window_attention_bwd, 0, True, 260))
    inputs = {"row": _rowblock_inputs, "block": _block_inputs,
              "train": attn_bwd}
    out = {}
    for label, kern, shift, sam, seed in cases:
        key = {"train": "window_attn_train_bwd"}.get(
            label, kern.__name__ + ("" if sam else f" shift {shift}"))
        out[key] = {}
        for i, (stage, c, heads, hw) in enumerate(ATTN_STAGES):
            a, kw = inputs[label](seed + i, SAM_BATCH, hw, c, heads, shift,
                                  torch.bfloat16, sam=sam)[:2]
            with torch.inference_mode():
                split = split_ms(lambda: kern(**a, **kw))
            out[key][stage] = split
            for kname, ms, count in split:
                print(f"[{label} kernel split] {key} {stage} B{SAM_BATCH} "
                      f"bf16: {ms:.4f} ms x{count} {kname[:100]}", flush=True)
            del a
            torch.cuda.empty_cache()
    return out


def phase_rowblock_kernels():
    """[row kernel]: ``crf_rowblock_infer`` and ``sam_rowblock_infer`` by
    ``_whole_block_phase``, beside the port's ``row`` module (pad, roll,
    the kernels, roll, crop) and its ``fused`` composition of the same
    block (LN, pad, roll, window partition, qk product,
    ``window_attn_infer``, reverse, roll, crop, ``block_epilogue_infer``)."""
    from tpudepth_torch.ops.kernels import rowblock_infer as rbi

    def inputs(*args, sam):
        a, kw = _rowblock_inputs(*args, sam=sam)
        return a, kw, a

    return _whole_block_phase(
        "row kernel",
        {"crf_rowblock_infer": (rbi.crf_rowblock_infer,
                                rbi.crf_rowblock_infer_reference),
         "sam_rowblock_infer": (rbi.sam_rowblock_infer,
                                rbi.sam_rowblock_infer_reference)},
        rbi.tolerance, inputs, ("row", "fused"), (20, 200))


def phase_block_kernels():
    """[block kernel]: ``crf_block_infer`` and ``sam_block_infer`` by
    ``_whole_block_phase`` on the windows of the same maps and the valid
    table, beside the port's ``block`` module (pad, roll, partition, the
    kernels, reverse, roll, crop), its ``row`` module and its ``fused``
    composition of the same block."""
    from tpudepth_torch.ops.kernels import block_infer as bi

    return _whole_block_phase(
        "block kernel",
        {"crf_block_infer": (bi.crf_block_infer,
                             bi.crf_block_infer_reference),
         "sam_block_infer": (bi.sam_block_infer,
                             bi.sam_block_infer_reference)},
        bi.tolerance, _block_inputs, ("block", "row", "fused"), (30, 300))


def serve_attention_model(name, label, blocks, per_forward, bf16_bounds):
    """The serving path of an attention model: a seeded ``build_model(name)``
    through ``InferenceEngine`` in bf16 at 480x640 in each kernel mode of
    ``per_forward`` (the main path first), batch 1 and 8, with the attention
    kernels' launches counted over exactly the requests of each mode (each
    kernel that ``per_forward[mode]`` names ``blocks`` times a forward, the
    others never); the served sigmoid maps against the f32 plain model
    (``bf16_bounds``: rel L2, max); each mode in f32 against f32 plain (TF32
    is off since phase 1); then ms/frame, img/s, peak memory and a profile
    of every mode and plain at batch 1 and 8."""
    from tpudepth_torch.infer.engine import InferenceEngine
    from tpudepth_torch.models.layers import init_random_
    from tpudepth_torch.models.registry import build_model
    from tpudepth_torch.ops.kernels import block_infer as bi
    from tpudepth_torch.ops.kernels import epilogue_infer as ei
    from tpudepth_torch.ops.kernels import mlp_infer as mi
    from tpudepth_torch.ops.kernels import rowblock_infer as rbi
    from tpudepth_torch.ops.kernels import window_attn_infer as wai

    counters = {"window_attn_infer": wai.window_attention_infer,
                "block_epilogue_infer": ei.block_epilogue_infer,
                "mlp_infer": mi.mlp_infer,
                "sam_rowblock_infer": rbi.sam_rowblock_infer,
                "crf_rowblock_infer": rbi.crf_rowblock_infer,
                "sam_block_infer": bi.sam_block_infer,
                "crf_block_infer": bi.crf_block_infer}
    modes = list(per_forward)
    weights = init_random_(build_model(name, attn="plain"), seed=0).state_dict()
    models = {}
    for mode in modes + ["plain"]:
        models[mode] = build_model(name, attn=mode)
        models[mode].load_state_dict(weights)
    h, w = TRAIN_HW
    images = [np.random.default_rng(400 + i).random((1, 3, h, w), dtype=np.float32)
              for i in range(4)]
    batch = np.random.default_rng(410).random((SAM_BATCH, 3, h, w),
                                              dtype=np.float32)
    engines = {(mode, bs): InferenceEngine(models[mode], (bs, 3, h, w),
                                           compute_dtype=torch.bfloat16)
               for mode in modes for bs in (1, SAM_BATCH)}
    for (mode, bs), eng in engines.items():   # first calls: cuDNN set-up
        eng(images[0] if bs == 1 else batch)
    torch.cuda.synchronize()

    # the main path, then the other modes: requests through each engine,
    # the counts set to 0 just before and read just after
    t0 = time.perf_counter()
    served = {}
    per_mode = {}
    for mode in modes:
        for fn in counters.values():
            fn.launches = 0
        served[mode] = ([engines[(mode, 1)](img) for img in images]
                        + [engines[(mode, SAM_BATCH)](batch)])
        torch.cuda.synchronize()
        per_mode[mode] = {k: fn.launches for k, fn in counters.items()}
    t_serve = time.perf_counter() - t0
    launches = {k: sum(c[k] for c in per_mode.values()) for k in counters}
    forwards = len(images) + 1
    print(f"[{name} serve] {len(images)} single-image requests and one batch "
          f"of {SAM_BATCH} through each of the {', '.join(modes)} bf16 "
          f"engines in {t_serve:.3f} s host clock; launches {launches}, by "
          f"mode {per_mode}", flush=True)
    for mode, kernels in per_forward.items():
        check(per_mode[mode] == {k: blocks * forwards if k in kernels else 0
                                 for k in counters}, f"{mode} launches")
    for outs in served.values():
        for out in outs:
            check(out.dtype == torch.float32 and out.shape[1:] == (1, h, w),
                  f"served shape {tuple(out.shape)}")
            check(bool(torch.isfinite(out).all()), "non-finite depth")
            check(float(out.min()) >= 0.0 and float(out.max()) <= 1.0,
                  "sigmoid map outside [0, 1]")

    inputs = images + [batch]

    def answers(mode, dtype):
        eng = {1: InferenceEngine(models[mode], (1, 3, h, w), compute_dtype=dtype),
               SAM_BATCH: InferenceEngine(models[mode], (SAM_BATCH, 3, h, w),
                                          compute_dtype=dtype)}
        before = [fn.launches for fn in counters.values()]
        outs = [eng[x.shape[0]](x).float() for x in inputs]
        if mode == "plain":
            check([fn.launches for fn in counters.values()] == before,
                  f"the plain {name} model launched an attention kernel")
        return torch.cat([o.reshape(-1) for o in outs])

    ref = answers("plain", torch.float32)
    check(float(ref.std()) > 1e-2, "reference output is constant")
    errs = {}
    got = {f"bf16 {m}": torch.cat([o.reshape(-1) for o in served[m]])
           for m in modes}
    del served
    got.update({f"f32 {m}": answers(m, torch.float32) for m in modes})
    for tag, g in got.items():
        rel_l2 = float((g - ref).norm() / ref.norm())
        rel_max = float((g - ref).abs().max() / ref.abs().max())
        errs[tag] = (rel_l2, rel_max)
        print(f"[{name} serve] sigmoid map, {tag} vs f32 plain: rel L2 "
              f"{rel_l2:.3e}, max abs / max|ref| {rel_max:.3e} (ref std "
              f"{float(ref.std()):.3e})", flush=True)
    bf16_l2, bf16_max = bf16_bounds
    for mode in modes:
        check(errs[f"f32 {mode}"][0] <= SAM_F32_REL_L2,
              f"f32 {mode} vs f32 plain beyond {SAM_F32_REL_L2} (rel L2)")
        check(errs[f"bf16 {mode}"][0] <= bf16_l2
              and errs[f"bf16 {mode}"][1] <= bf16_max,
              f"bf16 {mode} vs f32 plain beyond {bf16_l2} (L2) / "
              f"{bf16_max} (max)")
    del got

    perf = {}
    for bs in (1, SAM_BATCH):
        for mode in modes + ["plain"]:
            eng = InferenceEngine(models[mode], (bs, 3, h, w),
                                  compute_dtype=torch.bfloat16)
            torch.cuda.reset_peak_memory_stats()
            stats = eng.benchmark(50 if bs == 1 else 20, 5)
            mem = torch.cuda.max_memory_allocated() / 2**20
            perf[f"{mode}_bs{bs}"] = {
                "ms_per_batch": 1e3 * stats["seconds_per_frame"],
                "img_per_s": stats["images_per_second"], "peak_mib": mem}
            print(f"[{name} engine] {label} 480x640 bf16 {mode:<5} "
                  f"bs{bs}: {stats['images_per_second']:.1f} img/s, "
                  f"{1e3 * stats['seconds_per_frame']:.3f} ms/batch mean, "
                  f"{1e3 * stats['median_seconds_per_frame']:.3f} ms median, "
                  f"peak memory {mem:.0f} MiB", flush=True)
            profile_engine(eng, f"{name} {mode} bs{bs}", runs=3)
    return launches, per_mode, errs, perf


def phase_sam_serving():
    """SAM serving (four blocks a forward): ``fused`` (the default), then
    ``pair``, ``row`` and ``block``."""
    return serve_attention_model(
        "sam", "MobileV3SAMDepth", 4,
        {"fused": ("window_attn_infer", "block_epilogue_infer"),
         "pair": ("window_attn_infer", "mlp_infer"),
         "row": ("sam_rowblock_infer",),
         "block": ("sam_block_infer",)},
        (SAM_BF16_REL_L2, SAM_BF16_REL_MAX))


def phase_newcrf_serving():
    """NewCRF serving (eight blocks a forward, two a stage): ``row`` (the
    default), then ``fused``, ``pair`` and ``block``."""
    return serve_attention_model(
        "newcrf", "MobileV3NewCRFDepth", 8,
        {"row": ("crf_rowblock_infer",),
         "fused": ("window_attn_infer", "block_epilogue_infer"),
         "pair": ("window_attn_infer", "mlp_infer"),
         "block": ("crf_block_infer",)},
        (NEWCRF_BF16_REL_L2, NEWCRF_BF16_REL_MAX))


def phase_root_eval():
    """Each attention model in ``block`` mode through the bf16
    ``InferenceEngine`` and ``RootEvaluator`` over seeded synthetic NYU-like
    batches, against the f32 plain model on the same weights through the
    same evaluator, each metric within EVAL_BF16_REL + EVAL_BF16_ABS (as
    [eval] holds ``AlhashimEvaluator``); the whole-block kernel's launches
    counted over exactly the evaluation (a block each a forward)."""
    from tpudepth_torch.core.config import EvalConfig
    from tpudepth_torch.eval.evaluator import RootEvaluator
    from tpudepth_torch.eval.metrics import METRIC_NAMES
    from tpudepth_torch.infer.engine import InferenceEngine
    from tpudepth_torch.models.layers import init_random_
    from tpudepth_torch.models.registry import build_model
    from tpudepth_torch.ops.kernels import block_infer as bi

    rng = np.random.default_rng(500)
    h, w = TRAIN_HW
    loader = [{"image": rng.random((SAM_BATCH, h, w, 3), dtype=np.float32),
               "depth": rng.random((SAM_BATCH, h, w, 1), dtype=np.float32)
               * 0.9 + 0.05} for _ in range(2)]
    out = {}
    for name, blocks, kernel in (("sam", 4, bi.sam_block_infer),
                                 ("newcrf", 8, bi.crf_block_infer)):
        cfg = EvalConfig(model=name, dataset="nyu_reduced", resolution="full",
                         batch_size=SAM_BATCH)
        weights = init_random_(build_model(name, attn="plain"),
                               seed=0).state_dict()
        models = {}
        for mode in ("block", "plain"):
            models[mode] = build_model(name, attn=mode)
            models[mode].load_state_dict(weights)
        engine = InferenceEngine(models["block"], (SAM_BATCH, 3, h, w),
                                 compute_dtype=torch.bfloat16)
        kernel.launches = 0
        t0 = time.perf_counter()
        got = RootEvaluator(engine, cfg).evaluate(loader)
        t_eval = time.perf_counter() - t0
        launches = kernel.launches
        check(launches == blocks * len(loader),
              f"{name} root evaluation launched {kernel.__name__} "
              f"{launches} times")
        ref = RootEvaluator(InferenceEngine(models["plain"],
                                            (SAM_BATCH, 3, h, w),
                                            compute_dtype=torch.float32),
                            cfg).evaluate(loader)
        print(f"[root eval] {name}: RootEvaluator, {len(loader)} batches of "
              f"{SAM_BATCH}, Garg crop, block bf16 engine in {t_eval:.2f} s "
              f"host clock ({kernel.__name__} launches {launches}); "
              + RootEvaluator.format_report(got, SAM_BATCH * len(loader))
              .replace("\n", " | "), flush=True)
        for k in METRIC_NAMES:
            a, b = got[k], ref[k]
            check(np.isfinite(a) and np.isfinite(b), f"{name} {k} not finite")
            print(f"[root eval] {name} {k:<8} block bf16 engine {a:.6f}   "
                  f"plain f32 model {b:.6f}")
            check(abs(a - b) <= EVAL_BF16_REL * abs(b) + EVAL_BF16_ABS,
                  f"{name} metric {k}: {a} against {b}")
        check(0.0 <= got["d1"] <= got["d2"] <= got["d3"] <= 1.0,
              f"{name} delta order")
        out[name] = {"metrics": got, "plain_f32": ref, "launches": launches,
                     "seconds": t_eval}
        del models, engine
        torch.cuda.empty_cache()
    return out


# -- SAM and NewCRF training -----------------------------------------------

# one f32 train step (TF32 off) of an attention model in its default block
# mode (the training kernels) against the same step in ``plain`` (the f32
# compositions), same weights and batch; both steps take the root loss
# kernels. The kernels sum in other orders than cuBLAS and the einsums (a
# few f32 ulps per product). Three chip runs read the losses equal and the
# gradients within 1.5e-5 to 3.5e-5 of each tensor's largest, so the bounds
# are about 3x the largest reading: a backward term wrong by 1e-3 of its
# size fails them.
ATTN_STEP_LOSS_RTOL = 1e-6
ATTN_STEP_GRAD_REL = 1e-4
ATTN_STEP_GRAD_FLOOR_REL = 1e-4   # of the largest gradient of all
# the training kernels a step launches per attention block: window
# attention forward and backward, FFN forward and backward
TRAIN_KERNELS = ("window_attn_train_fwd", "window_attn_train_bwd",
                 "mlp_train_fwd", "mlp_train_bwd")


def _train_counters():
    from tpudepth_torch.ops.kernels import mlp_train as mt
    from tpudepth_torch.ops.kernels import window_attn as wat

    return dict(zip(TRAIN_KERNELS, (wat.window_attention_fwd,
                                    wat.window_attention_bwd,
                                    mt.mlp_train_fwd, mt.mlp_train_bwd)))


def _train_kernel_inputs(seed, bsz, windows, c, heads, rows, dtype):
    """Seeded attention inputs (q scaled, k, v, bias, cotangent) and FFN
    inputs (x, w1 [in, out], b1, w2, b2, cotangent) of one stage."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def n(*shape, s=1.0, dt=torch.float32):
        return (s * torch.randn(*shape, generator=g, device=DEVICE)).to(dt)

    bw, m, hidden = bsz * windows, bsz * rows, 4 * c
    attn = dict(q=n(bw, 49, c, s=32 ** -0.5, dt=dtype), k=n(bw, 49, c, dt=dtype),
                v=n(bw, 49, c, dt=dtype), bias=n(heads, 49, 49, s=0.5))
    ga = n(bw, 49, c, dt=dtype)
    ffn = dict(x=n(m, c, dt=dtype), w1=n(c, hidden, s=c ** -0.5),
               b1=n(hidden, s=0.1), w2=n(hidden, c, s=hidden ** -0.5),
               b2=n(c, s=0.1))
    gf = n(m, c, dt=dtype)
    return attn, ga, ffn, gf


def _attn_train_bounds(bw, c, heads):
    """(forward, backward) bounds of bf16 window attention: q, k, v, g read
    once, the outputs written once, bias (and dbias) in f32; 2 (forward) or
    5 (backward) products of 2 N^2 d a window and head."""
    io = bw * 49 * c * 2
    table = heads * 49 * 49 * 4
    return (_bound(4 * io + table, 4 * bw * 49 * 49 * c),
            _bound(7 * io + 2 * table, 10 * bw * 49 * 49 * c))


def _mlp_train_bounds(m, c, hidden):
    """(forward, backward) bounds of the bf16 FFN, counting the JAX kernels'
    own traffic (the hidden activation never leaves the chip): x, the
    output or g and dx once, bf16 weights read once, f32 weight gradients
    written once; 2 or 5 products of 2 M C H."""
    w = 2 * c * hidden
    return (_bound(2 * m * c * 2 + w * 2 + (hidden + c) * 4, 4 * m * c * hidden),
            _bound(3 * m * c * 2 + w * 2 + w * 4 + (hidden + c) * 4,
                   10 * m * c * hidden))


def phase_train_kernels():
    """``window_attn_train_fwd`` / ``_bwd`` and ``mlp_train_fwd`` / ``_bwd``
    against their plain versions at the four stage shapes of a 480x640
    batch-8 step, in f32 and bf16, the attention with and without the
    shift-3 mask, the FFN also at an odd row count and its forward at batch
    1; every attention call and FFN forward run twice and the reruns
    bit-equal. Then one B8 bf16 SAM step's calls timed (CUDA
    graph replays) beside the bound, the plain version and a library
    yardstick: ``F.scaled_dot_product_attention`` with the bias as
    ``attn_mask`` (the backward: its autograd backward, eager, less the
    forward) and the FFN's cuBLAS products (two forward, five backward)."""
    from tpudepth_torch.ops.kernels import mlp_train as mt
    from tpudepth_torch.ops.kernels import window_attn as wat
    from tpudepth_torch.ops.window import shifted_window_attention_mask

    hold = KernelHold("train kernels", TRAIN_KERNELS + ("dbias", "dw"))
    reruns = 0
    for i, (stage, c, heads, hw) in enumerate(ATTN_STAGES):
        hp, wp = _padded(hw)
        windows, rows = hp * wp // 49, hw[0] * hw[1]
        mask = torch.from_numpy(
            shifted_window_attention_mask(hp, wp, 7, 3)).to(DEVICE)
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"{stage} B{SAM_BATCH} {str(dtype)[6:]}"
            attn, ga, ffn, gf = _train_kernel_inputs(20 + i, SAM_BATCH, windows,
                                                     c, heads, rows, dtype)
            tol, dbias_tol = wat.bwd_tolerance(dtype)
            for mk in (None, mask):
                t = tag + (" shift-3 mask" if mk is not None else "")
                got = wat.window_attention_fwd(**attn, mask=mk)
                got_again = wat.window_attention_fwd(**attn, mask=mk)
                grads = wat.window_attention_bwd(**attn, mask=mk, g=ga)
                again = wat.window_attention_bwd(**attn, mask=mk, g=ga)
                torch.cuda.synchronize()
                check(torch.equal(got, got_again),
                      f"window_attn_train_fwd {t}: a rerun differs")
                hold("window_attn_train_fwd", got,
                     wat.window_attention_fwd_reference(**attn, mask=mk),
                     wat.fwd_tolerance(dtype), t)
                want = wat.window_attention_bwd_reference(**attn, mask=mk, g=ga)
                for name, a, b in zip(("dq", "dk", "dv"), grads, want):
                    hold("window_attn_train_bwd", a, b, tol, f"{t} {name}")
                hold("dbias", grads[3], want[3], dbias_tol, t)
                check(all(torch.equal(a, b) for a, b in zip(grads, again)),
                      f"window_attn_train_bwd {t}: a rerun differs")
                reruns += 1
                del got, got_again, grads, again, want
            out_tol, w_tol = mt.tolerance(dtype)
            odd = {**ffn, "x": ffn["x"][:-3]}   # 8 h w - 3 rows: odd
            # the forward also at batch 1 (its first h w rows)
            one = {**ffn, "x": ffn["x"][:rows]}
            got, again = mt.mlp_train_fwd(**one), mt.mlp_train_fwd(**one)
            torch.cuda.synchronize()
            hold("mlp_train_fwd", got, mt.mlp_train_fwd_reference(**one),
                 out_tol, f"{stage} B1 {str(dtype)[6:]} M {rows}")
            check(torch.equal(got, again),
                  f"mlp_train_fwd {stage} B1: a rerun differs")
            for x_tag, f, g in ((tag, ffn, gf), (f"{tag} odd rows", odd,
                                                 gf[:-3])):
                got = mt.mlp_train_fwd(**f)
                fwd_again = mt.mlp_train_fwd(**f)
                grads = mt.mlp_train_bwd(f["x"], g, f["w1"], f["b1"], f["w2"])
                again = mt.mlp_train_bwd(f["x"], g, f["w1"], f["b1"], f["w2"])
                torch.cuda.synchronize()
                hold("mlp_train_fwd", got, mt.mlp_train_fwd_reference(**f),
                     out_tol, f"{x_tag} M {f['x'].shape[0]}")
                check(torch.equal(got, fwd_again),
                      f"mlp_train_fwd {x_tag}: a rerun differs")
                want = mt.mlp_train_bwd_reference(f["x"], g, f["w1"], f["b1"],
                                                  f["w2"])
                flips = mt.flip_atol(f["x"], g, f["w1"], f["b1"], f["w2"])
                hold("mlp_train_bwd", grads[0], want[0], out_tol,
                     f"{x_tag} dx", flips[0])
                for name, a, b, flip in zip(("dw1", "db1", "dw2", "db2"),
                                            grads[1:], want[1:], flips[1:]):
                    hold("dw", a, b, w_tol, f"{x_tag} {name}", flip)
                del flips
                check(all(torch.equal(a, b) for a, b in zip(grads, again)),
                      f"mlp_train_bwd {x_tag}: a rerun differs")
                reruns += 1
                del got, fwd_again, grads, again, want
            del attn, ga, ffn, gf, odd, one
            torch.cuda.empty_cache()
    print(f"[train kernels] {reruns} backward calls rerun, each bit-equal "
          "(dq, dk, dv, dbias; dx, dw1, db1, dw2, db2); every FFN forward "
          "rerun bit-equal", flush=True)

    # device times of one B8 bf16 SAM train step's calls
    rows = {k: [] for k in TRAIN_KERNELS}
    for i, (stage, c, heads, hw) in enumerate(ATTN_STAGES):
        hp, wp = _padded(hw)
        windows, m_rows = hp * wp // 49, hw[0] * hw[1]
        attn, ga, ffn, gf = _train_kernel_inputs(120 + i, SAM_BATCH, windows,
                                                 c, heads, m_rows,
                                                 torch.bfloat16)
        bw, m, hidden = SAM_BATCH * windows, SAM_BATCH * m_rows, 4 * c
        q4, k4, v4, g4 = (t.reshape(bw, 49, heads, 32).transpose(1, 2)
                          .contiguous() for t in (attn["q"], attn["k"],
                                                  attn["v"], ga))
        amask = attn["bias"][None].to(torch.bfloat16)
        qg, kg, vg = (t.clone().requires_grad_() for t in (q4, k4, v4))

        def sdpa():
            return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=amask,
                                                  scale=1.0)

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=amask,
                                                 scale=1.0)
            return torch.autograd.grad(out, (qg, kg, vg), g4)

        x, w1b, w2b = ffn["x"], ffn["w1"].bfloat16(), ffn["w2"].bfloat16()
        hbuf = torch.empty(m, hidden, dtype=torch.bfloat16, device=DEVICE)
        fwd_bound, bwd_bound = _attn_train_bounds(bw, c, heads)
        mfwd_bound, mbwd_bound = _mlp_train_bounds(m, c, hidden)
        lib_attn_fwd = time_eager_ms(sdpa, calls=10)
        lib_attn_bwd = max(time_eager_ms(sdpa_fwd_bwd, calls=10) - lib_attn_fwd,
                           0.0)
        cases = {
            "window_attn_train_fwd": (
                lambda: wat.window_attention_fwd(**attn),
                lambda: wat.window_attention_fwd_reference(**attn),
                time_ms(sdpa, per_graph=4, replays=10), fwd_bound),
            "window_attn_train_bwd": (
                lambda: wat.window_attention_bwd(**attn, mask=None, g=ga),
                lambda: wat.window_attention_bwd_reference(**attn, mask=None,
                                                           g=ga),
                lib_attn_bwd, bwd_bound),
            "mlp_train_fwd": (
                lambda: mt.mlp_train_fwd(**ffn),
                lambda: mt.mlp_train_fwd_reference(**ffn),
                time_ms(lambda: (x @ w1b, hbuf @ w2b), per_graph=4,
                        replays=10), mfwd_bound),
            "mlp_train_bwd": (
                lambda: mt.mlp_train_bwd(x, gf, ffn["w1"], ffn["b1"],
                                         ffn["w2"]),
                lambda: mt.mlp_train_bwd_reference(x, gf, ffn["w1"],
                                                   ffn["b1"], ffn["w2"]),
                time_ms(lambda: (x @ w1b, gf @ w2b.t(), hbuf @ w1b.t(),
                                 x.t() @ hbuf, hbuf.t() @ gf), per_graph=4,
                        replays=10), mbwd_bound),
        }
        for name, (kern, plain, lib_ms, (bound, t_b, t_o)) in cases.items():
            ms = time_ms(kern, per_graph=4, replays=10)
            plain_ms = time_ms(plain, per_graph=1, replays=5)
            rows[name].append({"name": stage, "windows": bw, "rows": m, "C": c,
                               "heads": heads, "ms": ms, "plain_ms": plain_ms,
                               "library_ms": lib_ms, "bound_ms": bound,
                               "bytes_ms": t_b, "ops_ms": t_o})
            print(f"[train kernel time] {name:<22} {stage} B{SAM_BATCH} bf16 "
                  f"(windows {bw}, M {m}, C {c}): kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
                  f"{bound:.4f} ms ({'bytes' if t_b >= t_o else 'operations'}"
                  f"; {100 * bound / ms:.1f}% of bound)", flush=True)
        del attn, ga, ffn, gf, q4, k4, v4, g4, qg, kg, vg, hbuf
        torch.cuda.empty_cache()
    return rows, hold.err, hold.err_rel, hold.checks


# -- the root recipe's loss: fused_root_loss_fwd / _bwd ------------------------

# (kind, B, H, W) of tests/torch_port_helpers.py::root_pair: the training
# shape with a min-max target and a prediction in (0, 1), the same with the
# clip active, pred == target (the clip's bound), flat patches, ragged
# strips, the backward's 16x60 warp strip one row and column above a strip,
# the forward's 8-row strip (twice) and its first 61 columns (a strip
# holds 62, from column -1) one row and column below, at and above, images
# of 2 rows or columns
ROOT_CASES = [("unit", 8, 480, 640), ("anti", 8, 480, 640), ("equal", 2, 40, 40),
              ("smooth", 2, 34, 46), ("unit", 3, 33, 47), ("anti", 2, 17, 61),
              ("unit", 2, 15, 61), ("anti", 2, 17, 63), ("unit", 1, 16, 62),
              ("unit", 1, 2, 65), ("unit", 1, 65, 2)]
# float operations a pixel: the five 3x3 statistics (3 products, 2 x 15
# sums and thirds), the SSIM terms, the clipped map and |p - t| (forward);
# the same statistics, the gated coefficient maps, three adjoint boxes and
# the sum with the sign term (backward)
ROOT_FWD_FLOP_PER_PIXEL = 59
ROOT_BWD_FLOP_PER_PIXEL = 99
ROOT_KERNELS = ("fused_root_loss_fwd", "fused_root_loss_bwd")


def make_root_pair(kind, bsz, h, w, seed=0):
    """``(pred, target)`` ``[B,H,W]`` f32 on the card, as
    ``tests/torch_port_helpers.py::root_pair`` makes them."""
    rng = np.random.default_rng(seed)
    t = rng.random((bsz, h, w)) * 0.9 + 0.05
    p = rng.random((bsz, h, w)) * 0.9 + 0.05
    if kind == "anti":
        p = 1.0 - t + 0.05 * p
    elif kind == "equal":
        p = t.copy()
    elif kind == "smooth":
        t = np.repeat(np.repeat(rng.integers(1, 9, (bsz, -(-h // 8), -(-w // 8))),
                                8, axis=1), 8, axis=2)[:, :h, :w] / 10.0
        p = t.copy()
        p[:, : h // 2] += 0.05
        p[:, h // 2:] -= 0.03

    def put(a):
        return torch.from_numpy(a.astype(np.float32)).to(DEVICE)

    return put(p), put(t)


def _root_counters():
    from tpudepth_torch.ops.kernels import fused_root_loss as frl

    return dict(zip(ROOT_KERNELS, (frl.root_partials, frl.root_bwd)))


def phase_root_loss_kernels():
    """``fused_root_loss_fwd`` and ``_bwd`` against their plain versions
    (partials within ``PARTIALS_RTOL``: only the sums over pixels take
    another order; the gradient bit-equal: the same f32 operations per
    pixel in the same order), every call run twice and the reruns
    bit-equal; then both timed at B 8 480x640 (CUDA graph replays) beside
    the bound, the plain version and the port's plain composition ``1.0 *
    ssim + 0.1 * l1_loss`` (forward, and its autograd backward less the
    forward, eager)."""
    from tpudepth_torch.losses.losses import l1_loss, ssim
    from tpudepth_torch.ops.kernels import fused_root_loss as frl

    err = {k: 0.0 for k in ROOT_KERNELS}
    for case in ROOT_CASES:
        kind, bsz, h, w = case
        p, t = make_root_pair(kind, bsz, h, w)
        n = p.numel()
        scales = torch.tensor([1.0 / n, 0.1 / n], device=DEVICE)
        got, again = frl.root_partials(p, t), frl.root_partials(p, t)
        gk, gk2 = frl.root_bwd(p, t, scales), frl.root_bwd(p, t, scales)
        torch.cuda.synchronize()
        want = frl.root_partials_reference(p, t)
        gr = frl.root_bwd_reference(p, t, scales)
        d = (got - want).abs()
        e_fwd, e_bwd = float(d.max()), float((gk - gr).abs().max())
        err["fused_root_loss_fwd"] = max(err["fused_root_loss_fwd"], e_fwd / (h * w))
        err["fused_root_loss_bwd"] = max(err["fused_root_loss_bwd"], e_bwd)
        print(f"[root loss kernels] {kind:<6} B{bsz} {h}x{w}: partials "
              f"max_abs_err {e_fwd:.3e} of {float(want.abs().max()):.3e} "
              f"(rtol {frl.PARTIALS_RTOL:g}); dL/dp max_abs_err {e_bwd:.3e} "
              f"of {float(gr.abs().max()):.3e} (bit-equal "
              f"{torch.equal(gk, gr)}); reruns bit-equal "
              f"{torch.equal(got, again) and torch.equal(gk, gk2)}", flush=True)
        check(bool((d <= frl.PARTIALS_RTOL * want.abs()).all()),
              f"fused_root_loss_fwd {case} beyond tolerance")
        check(torch.equal(gk, gr), f"fused_root_loss_bwd {case} differs")
        check(torch.equal(got, again) and torch.equal(gk, gk2),
              f"fused_root_loss {case}: a rerun differs")
        if kind == "equal":
            check(float(got.abs().max()) == 0.0,
                  "pred == target must give zero partial sums")

    bsz, (h, w) = TRAIN_BATCH, TRAIN_HW
    p, t = make_root_pair("unit", bsz, h, w, seed=1)
    pixels = p.numel()
    scales = torch.tensor([1.0 / pixels, 0.1 / pixels], device=DEVICE)
    p4, t4 = p[:, None], t[:, None]
    pg = p4.clone().requires_grad_(True)
    lib_fwd = time_eager_ms(lambda: 1.0 * ssim(p4, t4) + 0.1 * l1_loss(p4, t4))
    lib_both = time_eager_ms(lambda: torch.autograd.grad(
        1.0 * ssim(pg, t4) + 0.1 * l1_loss(pg, t4), pg))
    rows = {}
    for name, kern, plain, nbytes, flops, lib in (
            ("fused_root_loss_fwd", lambda: frl.root_partials(p, t),
             lambda: frl.root_partials_reference(p, t),
             2 * pixels * 4 + bsz * 2 * 4, pixels * ROOT_FWD_FLOP_PER_PIXEL,
             lib_fwd),
            ("fused_root_loss_bwd", lambda: frl.root_bwd(p, t, scales),
             lambda: frl.root_bwd_reference(p, t, scales),
             3 * pixels * 4 + 2 * 4, pixels * ROOT_BWD_FLOP_PER_PIXEL,
             max(lib_both - lib_fwd, 0.0))):
        ms, plain_ms = time_ms(kern), time_ms(plain, per_graph=2, replays=10)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOP_PER_S * 1e3
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib,
                      "bound_ms": max(t_bytes, t_ops), "bytes_ms": t_bytes,
                      "ops_ms": t_ops,
                      "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                      **loss_kernel_count(name, kern)}
        print(f"[root loss kernel time] {name} B{bsz} {h}x{w} f32: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, ssim + l1_loss "
              f"{'forward' if name.endswith('fwd') else 'autograd backward'} "
              f"{lib:.4f} ms (eager), bound {max(t_bytes, t_ops):.4f} ms "
              f"({rows[name]['bound_by']}: bytes {t_bytes:.4f}, operations "
              f"{t_ops:.4f}; {100 * max(t_bytes, t_ops) / ms:.1f}% of bound)",
              flush=True)
    del p, t, p4, t4, pg
    torch.cuda.empty_cache()
    return rows, err, len(ROOT_CASES)


def train_attention_model(name, tmp, blocks):
    """The training path of an attention model: a seeded ``build_model(name)``
    (its default block mode) through ``Trainer.fit`` for 2 epochs of 3 steps
    at 480x640 B8 bf16 with one validation batch and a checkpoint per epoch,
    the training kernels' launches counted over exactly that run and checked
    per step (``blocks`` each); SAM's encoder bit-unchanged while its
    BatchNorm statistics moved, NewCRF's encoder moved; the last checkpoint
    restored into a fresh trainer; one f32 step against the same step in
    ``plain``; 8 steps on one batch lower the loss; ms/step, img/s, peak
    memory and a profile of one step."""
    from tpudepth_torch.core.config import TrainConfig
    from tpudepth_torch.models.layers import init_random_
    from tpudepth_torch.models.registry import build_model
    from tpudepth_torch.train.trainer import ENCODER_PREFIX, LossRecipe, Trainer

    label = f"{name} train"
    cfg = TrainConfig(model=name, dataset="nyu_reduced", resolution="full",
                      batch_size=SAM_BATCH, compute_dtype="bfloat16",
                      log_every=1, seed=0,
                      checkpoint_dir=f"{tmp}/checkpoints_{name}",
                      results_dir=f"{tmp}/results_{name}")
    weights = init_random_(build_model(name), seed=0).state_dict()
    train_loader = SyntheticLoader(3, seed=300, raw_depth=True)
    val_loader = SyntheticLoader(1, seed=301, raw_depth=False)

    def trainer_for():
        model = build_model(name)
        model.load_state_dict(weights)
        return Trainer(cfg, model=model, device=DEVICE,
                       train_loader=train_loader, val_loader=val_loader)

    counters = {**_train_counters(), **_root_counters()}
    trainer = trainer_for()
    losses, per_step = [], []

    def log_fn(epoch, i, n, loss, dt, it):
        losses.append(loss)
        per_step.append({k: fn.launches for k, fn in counters.items()})

    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.fit(epochs=2, val_max_batches=1, checkpoint_style="per_epoch",
                log_fn=log_fn)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in counters.items()}
    mem = torch.cuda.max_memory_allocated() / 2**20
    steps = [{k: s[k] - (per_step[j - 1][k] if j else 0) for k in s}
             for j, s in enumerate(per_step)]
    print(f"[{label}] fit: 2 epochs x 3 steps, {name} {TRAIN_HW[0]}x"
          f"{TRAIN_HW[1]} B{SAM_BATCH} bf16 root recipe, augment on, in "
          f"{t_fit:.2f} s host clock (first step included); losses "
          f"{[round(x, 4) for x in losses]}; val losses "
          f"{[round(x, 4) for x in trainer.val_losses]}; launches over 6 "
          f"train steps and 2 validation batches {counts}; peak memory "
          f"{mem:.0f} MiB", flush=True)
    check(trainer.recipe.kind == "root", f"{name} trains with the root recipe")
    check(len(losses) == 6 and all(np.isfinite(losses)),
          f"6 finite train losses expected, got {losses}")
    check(len(trainer.val_losses) == 2
          and all(np.isfinite(trainer.val_losses)), "validation losses")
    # the loss kernels: one of each a train step, and the forward once more
    # for the validation batch (epoch 0's is counted with step 3, the first
    # of epoch 1; epoch 1's after the last step)
    check(all({k: s[k] for k in TRAIN_KERNELS}
              == {k: blocks for k in TRAIN_KERNELS} for s in steps),
          f"{name}: launches per step {steps}, expected {blocks} each")
    check([s["fused_root_loss_bwd"] for s in steps] == [1] * 6
          and [s["fused_root_loss_fwd"] for s in steps] == [1, 1, 1, 2, 1, 1],
          f"{name}: loss kernel launches per step {steps}")
    check(counts == {**{k: 6 * blocks for k in TRAIN_KERNELS},
                     "fused_root_loss_fwd": 8, "fused_root_loss_bwd": 6},
          f"{name}: launches over the run {counts}")
    after = trainer.model.state_dict()
    enc_params = [n for n, _ in trainer.model.named_parameters()
                  if n.startswith(ENCODER_PREFIX)]
    enc_stats = [k for k in after if k.startswith(ENCODER_PREFIX)
                 and k.endswith("running_mean")]
    frozen = all(torch.equal(after[k].cpu(), weights[k]) for k in enc_params)
    stats_moved = all(not torch.equal(after[k].cpu(), weights[k])
                      for k in enc_stats)
    check(frozen == (name == "sam"),
          f"{name}: encoder parameters {'un' if frozen else ''}changed")
    check(stats_moved and len(enc_stats) > 40,
          f"{name}: encoder BatchNorm statistics did not move")
    dec = [n for n, _ in trainer.model.named_parameters()
           if not n.startswith(ENCODER_PREFIX)]
    check(all(not torch.equal(after[k].cpu(), weights[k]) for k in dec),
          f"{name}: a decoder parameter did not move")
    for n, prm in trainer.model.named_parameters():
        check(bool(torch.isfinite(prm).all()), f"non-finite {n}")
    print(f"[{label}] encoder: {len(enc_params)} parameters "
          f"{'bit-unchanged (frozen by the optimizer)' if frozen else 'moved'}"
          f", {len(enc_stats)} BatchNorm means moved; {len(dec)} decoder "
          "parameters moved", flush=True)

    fresh = trainer_for()
    fresh.init_state()
    fresh.restore(f"{tmp}/checkpoints_{name}/checkpoint_1")
    check(fresh.epoch == 2 and fresh.state.step == 6, "restored counters")
    check(fresh.val_losses == trainer.val_losses, "restored val_losses")
    for k, v in fresh.model.state_dict().items():
        check(torch.equal(v, after[k]), f"restored {k} differs")
    so = trainer.state.optimizer.state_dict()["state"]
    ro = fresh.state.optimizer.state_dict()["state"]
    n_opt = len(dec) if name == "sam" else len(dec) + len(enc_params)
    check(set(so) == set(ro) and len(so) == n_opt,
          f"optimizer state keys {len(so)}, expected {n_opt}")
    for k in so:
        for field in ("exp_avg", "exp_avg_sq", "step"):
            check(torch.equal(torch.as_tensor(so[k][field]).cpu(),
                              torch.as_tensor(ro[k][field]).cpu()),
                  f"restored optimizer state {k}.{field} differs")
    print(f"[{label}] checkpoint_1 restored into a fresh trainer: model, "
          f"BatchNorm statistics, Adam moments ({n_opt} parameters), epoch "
          "and val_losses equal", flush=True)
    del fresh

    # one f32 step in the default mode (training kernels) against plain
    batch = train_loader.batches[0]
    recipe = LossRecipe(kind="root", max_depth=MAX_DEPTH, depth_scale=MAX_DEPTH)
    results = {}
    for mode in ("kernels", "plain"):
        model = build_model(name, attn=None if mode == "kernels" else "plain")
        model.load_state_dict(after)
        before = {k: fn.launches for k, fn in counters.items()}
        results[mode] = one_f32_step(cfg, model, batch, recipe)
        got = {k: fn.launches - before[k] for k, fn in counters.items()}
        check(got == {**{k: blocks if mode == "kernels" else 0
                         for k in TRAIN_KERNELS},
                      "fused_root_loss_fwd": 1, "fused_root_loss_bwd": 1},
              f"{name} f32 {mode} step launched {got}")
        del model
    g_all = max(float(g.abs().max()) for g in results["plain"][1].values())
    out = {"launches": counts, "launches_per_step": steps[0],
           "encoder_frozen": frozen}
    out["step_loss_rel"], out["step_grad_rel"] = compare_steps(
        f"{name} training kernels vs plain", results["kernels"],
        results["plain"], ATTN_STEP_LOSS_RTOL, ATTN_STEP_GRAD_REL,
        ATTN_STEP_GRAD_FLOOR_REL * g_all)
    del results
    torch.cuda.empty_cache()

    # 8 steps on one fixed batch lower the loss (bf16, the root recipe's
    # learning rate 1e-4, TrainConfig's default: at GuideDepth's 1e-3 the
    # attention models overshoot, NewCRF's loss alternating step by step);
    # the plain mode's curve beside it, for comparison
    cfg8 = TrainConfig(model=name, dataset="nyu_reduced", resolution="full",
                       batch_size=SAM_BATCH, compute_dtype="bfloat16", seed=1)
    curves = {}
    for mode in (None, "plain"):
        model8 = build_model(name, attn=mode)
        model8.load_state_dict(weights)
        fixed = Trainer(cfg8, model=model8, device=DEVICE,
                        train_loader=train_loader)
        fixed.init_state()
        same_draw = torch.Generator(device=DEVICE)
        curves[mode or "kernels"] = [
            float(fixed.train_step(batch, same_draw.manual_seed(0)))
            for _ in range(8)]
        del fixed, model8
    curve = curves["kernels"]
    print(f"[{label}] 8 steps on one batch (bf16, lr {cfg8.learning_rate:g}):"
          f" {[round(x, 5) for x in curve]}; plain "
          f"{[round(x, 5) for x in curves['plain']]}", flush=True)
    check(all(np.isfinite(curve)) and curve[-1] < curve[0],
          "8 steps on one batch did not lower the loss")

    # step time as Trainer.train_step runs it (host batch in, augment on)
    for b in train_loader.batches:
        trainer.train_step(b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    n_timed = 10
    start.record()
    for i in range(n_timed):
        trainer.train_step(train_loader.batches[i % 3])
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / n_timed
    mem = torch.cuda.max_memory_allocated() / 2**20
    out.update({"step_ms": ms, "img_per_s": SAM_BATCH / ms * 1e3,
                "peak_mib": mem, "fit_s": t_fit, "curve": curve,
                "curve_plain": curves["plain"]})
    print(f"[{label}] train step {name} {TRAIN_HW[0]}x{TRAIN_HW[1]} "
          f"B{SAM_BATCH} bf16: {ms:.2f} ms/step, {out['img_per_s']:.1f} img/s "
          f"({n_timed} steps between CUDA events, warm), peak memory "
          f"{mem:.0f} MiB, launches per step {steps[0]}", flush=True)
    profile_window(lambda: trainer.train_step(batch), f"{name} train step", 1)
    del trainer
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import tpudepth_torch  # noqa: F401  (fails outside the repo)

    t_start = time.perf_counter()
    phase_device()
    phase_build()
    rows, max_err, n_checks = phase_kernels()
    loss_rows, loss_err = phase_loss_kernels()
    bwd_rows, bwd_err, bwd_checks = phase_bwd_kernels()
    sam_rows, sam_err, sam_err_rel, sam_checks = phase_sam_kernels()
    row_phase = phase_rowblock_kernels()
    blk_phase = phase_block_kernels()
    splits = kernel_splits()
    tk_rows, tk_err, tk_err_rel, tk_checks = phase_train_kernels()
    rl_rows, rl_err, rl_checks = phase_root_loss_kernels()
    launches, errs, perf = phase_serving()
    sam_launches, sam_per_mode, sam_errs, sam_perf = phase_sam_serving()
    crf_launches, crf_per_mode, crf_errs, crf_perf = phase_newcrf_serving()
    root_eval = phase_root_eval()
    with tempfile.TemporaryDirectory() as tmp:
        train, plain_trainer, cfg, loaders = phase_training(tmp)
        fused_train, fused_trainer = phase_training_fused(
            tmp, plain_trainer, cfg, loaders)
        del plain_trainer
        evaluation, eval_launches = phase_evaluation(tmp, fused_trainer)
        del fused_trainer
        torch.cuda.empty_cache()
        # the main paths of this slice: SAM (4 blocks) and NewCRF (8 blocks)
        # training, each kernel's count set to 0 just before its fit
        attn_train = {name: train_attention_model(name, tmp, blocks)
                      for name, blocks in (("sam", 4), ("newcrf", 8))}

    def total(table, key):
        return sum(r[key] for r in table)

    def bound_by(table, prefix=""):
        return ("bytes" if total(table, prefix + "bytes_ms")
                >= total(table, prefix + "ops_ms") else "operations")

    kernels = [{
        "name": "gub_conv_fwd",
        "route": "cuda",
        "source": "tpudepth_torch/csrc/gub_conv_fwd.cu",
        "replaces": "tpudepth/ops/pallas/gub_conv.py:201",
        "replaces_function": "tpudepth/ops/pallas/gub_conv.py::_fwd_call",
        "launches": launches,
        "launches_by_path": {
            "serving": launches,
            "fused_training": fused_train["launches"]["gub_conv_fwd"],
            "evaluation": eval_launches},
        "max_abs_err": max_err,
        "max_err": max_err,
        "checks": n_checks,
        "ok": True,
        "timed": "device time of one bs-1 480x640 bf16 forward: the nine "
                 "k=3 GUB convs summed, CUDA graph replays; train_step_ms "
                 "the same convs at batch 8 with statistics, "
                 "train_step_library_ms cuDNN and batch_norm_stats",
        "ms": total(rows, "ms"),
        "train_step_ms": total(rows, "b8_ms"),
        "train_step_library_ms": total(rows, "b8_library_ms"),
        "train_step_bound_ms": total(rows, "b8_bound_ms"),
        "plain_ms": total(rows, "plain_ms"),
        "bound_ms": total(rows, "bound_ms"),
        "bound_by": bound_by(rows),
        "library_ms": total(rows, "library_ms"),
        "shapes": rows,
    }]
    for name in ("fused_loss_fwd", "fused_loss_bwd", "fused_root_loss_fwd",
                 "fused_root_loss_bwd"):
        count = {**loss_rows, **rl_rows}[name]["cuda_kernels"]
        check(count == 1, f"{name} runs {count} CUDA kernels a call, not one")
    for name, line, fn, count, e in (
            ("fused_loss_fwd", 101, "_fused_partials", train["fwd_launches"],
             loss_err["fwd"]),
            ("fused_loss_bwd", 273, "_fused_bwd", train["bwd_launches"],
             loss_err["bwd"])):
        r = loss_rows[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "tpudepth_torch/csrc/fused_loss.cu",
            "replaces": f"tpudepth/ops/pallas/fused_loss.py:{line}",
            "replaces_function": f"tpudepth/ops/pallas/fused_loss.py::{fn}",
            "launches": count,
            "max_abs_err": e,
            "max_err": e,
            "checks": len(LOSS_CASES),
            "ok": True,
            "timed": f"device time of one launch at B{TRAIN_BATCH} "
                     f"{TRAIN_HW[0]}x{TRAIN_HW[1]} f32, CUDA graph replays; "
                     "library_ms is the port's DepthLoss "
                     + ("forward" if name.endswith("fwd") else
                        "forward + autograd backward less its forward")
                     + ", eager between CUDA events",
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "bytes_ms": r["bytes_ms"], "ops_ms": r["ops_ms"],
            "cuda_kernels_per_call": r["cuda_kernels"],
        })
    kernels[2]["max_rel_err"] = loss_err["bwd_rel"]
    for which, line, fn in (("dw", 355, "_dw_call"), ("dx", 535, "_dx_call")):
        kernels.append({
            "name": f"gub_conv_{which}",
            "route": "cuda",
            "source": "tpudepth_torch/csrc/gub_conv_bwd.cu",
            "replaces": f"tpudepth/ops/pallas/gub_conv.py:{line}",
            "replaces_function": f"tpudepth/ops/pallas/gub_conv.py::{fn}",
            "launches": fused_train["launches"][f"gub_conv_{which}"],
            "max_abs_err": bwd_err[which],
            "max_rel_err": bwd_err["dw_rel" if which == "dw" else "dx_sums_rel"],
            "checks": bwd_checks[which],
            "ok": True,
            "timed": f"device time of the launches of one B{TRAIN_BATCH} "
                     f"{TRAIN_HW[0]}x{TRAIN_HW[1]} bf16 train step with "
                     "statistics (nine shapes summed), CUDA graph replays; "
                     "library_ms is cuDNN's convolution_backward of the same "
                     "convs on the already-activated input ("
                     + ("weight and bias gradients" if which == "dw" else
                        "input gradient of the six convs whose input needs "
                        "one") + ")",
            "ms": total(bwd_rows, f"{which}_ms"),
            "plain_ms": total(bwd_rows, f"{which}_plain_ms"),
            "bound_ms": total(bwd_rows, f"{which}_bound_ms"),
            "bound_by": bound_by(bwd_rows, f"{which}_"),
            "library_ms": total(bwd_rows, f"{which}_library_ms"),
            "shapes": [{k: v for k, v in r.items()
                        if k in ("name", "cins", "cout", "hw", "dx_launches")
                        or k.startswith(which)} for r in bwd_rows],
        })
    for name, src, replaces, per, yardstick in (
            ("window_attn_infer", "window_attn_infer.cu",
             "window_attn_infer.py:95", "window_attention_infer",
             "F.scaled_dot_product_attention on the head-split tensors, the "
             "bias as attn_mask"),
            ("block_epilogue_infer", "epilogue_infer.cu",
             "epilogue_infer.py:92", "block_epilogue_infer",
             "the three cuBLAS products alone (o Wp, y W1, g W2; bf16)"),
            ("mlp_infer", "epilogue_infer.cu", "mlp_infer.py:135",
             "mlp_infer", "the two cuBLAS products alone (x W1, g W2; bf16)")):
        table = sam_rows[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"tpudepth_torch/csrc/{src}",
            "replaces": f"tpudepth/ops/pallas/{replaces}",
            "replaces_function": f"tpudepth/ops/pallas/{replaces.split(':')[0]}"
                                 f"::{per}",
            "launches": sam_launches[name] + crf_launches[name],
            "launches_by_mode": {
                **{m: c[name] for m, c in sam_per_mode.items()},
                **{f"newcrf {m}": c[name] for m, c in crf_per_mode.items()}},
            "max_abs_err": sam_err[name],
            "max_rel_err": sam_err_rel[name],
            "checks": sam_checks[name],
            "ok": True,
            "timed": f"device time of the four launches of one B{SAM_BATCH} "
                     "480x640 bf16 SAM forward (crf3..crf0 summed), CUDA graph "
                     f"replays; library_ms is {yardstick}",
            "ms": total(table, "ms"),
            "plain_ms": total(table, "plain_ms"),
            "bound_ms": total(table, "bound_ms"),
            "bound_by": bound_by(table),
            "library_ms": total(table, "library_ms"),
            **({f"shift3_{k}": total(table, k)
                for k in ("mask_ms", "mask_plain_ms", "mask_library_ms",
                          "mask_bound_ms")}
               if name == "window_attn_infer" else {}),
            "shapes": table,
        })
    newcrf_calls = ("the eight calls of one B8 480x640 bf16 NewCRF forward "
                    "(two blocks a stage, shift 0 and 3; crf3..crf0 summed)")
    sam_calls = ("the four calls of one B8 480x640 bf16 SAM forward "
                 "(crf3..crf0 summed)")
    for name, module, line, served, per_mode, calls, (table, err, err_rel,
                                                      checks), modes in (
            ("crf_rowblock_infer", "rowblock_infer", 270, crf_launches,
             crf_per_mode, newcrf_calls, row_phase, ("row", "fused")),
            ("sam_rowblock_infer", "rowblock_infer", 355, sam_launches,
             sam_per_mode, sam_calls, row_phase, ("row", "fused")),
            ("sam_block_infer", "block_infer", 201, sam_launches,
             sam_per_mode, sam_calls, blk_phase, ("block", "row", "fused")),
            ("crf_block_infer", "block_infer", 279, crf_launches,
             crf_per_mode, newcrf_calls, blk_phase,
             ("block", "row", "fused"))):
        table = table[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"tpudepth_torch/csrc/{module}.cu",
            "replaces": f"tpudepth/ops/pallas/{module}.py:{line}",
            "replaces_function": f"tpudepth/ops/pallas/{module}.py::{name}",
            "launches": served[name],
            "launches_by_mode": {m: c[name] for m, c in per_mode.items()},
            "max_abs_err": err[name],
            "max_rel_err": err_rel[name],
            "checks": checks[name],
            "ok": True,
            "timed": f"device time of {calls}, each call its kernels "
                     "(kernel_splits) and the wrapper's weight casts, CUDA "
                     "graph replays; bound_ms counts the real (cropped) "
                     "tokens only; library_ms is the block's four cuBLAS "
                     "bf16 products alone plus F.scaled_dot_product_attention "
                     "with bias and mask as attn_mask; "
                     + ", ".join(f"{m}_module_ms" for m in modes)
                     + " are the port's block module of the same blocks in "
                       "those modes",
            "ms": total(table, "ms"),
            "plain_ms": total(table, "plain_ms"),
            "bound_ms": total(table, "bound_ms"),
            "bound_by": bound_by(table),
            "library_ms": total(table, "library_ms"),
            **{f"{m}_module_ms": total(table, f"{m}_module_ms")
               for m in modes},
            "shapes": table,
        })
    for name, line, fn, src, yardstick, err_keys in (
            ("window_attn_train_fwd", 103, "window_attention_pallas",
             "window_attn.py", "F.scaled_dot_product_attention on the "
             "head-split tensors, the bias as attn_mask (CUDA graph replays)",
             ("window_attn_train_fwd",)),
            ("window_attn_train_bwd", 236, "window_attention_bwd_pallas",
             "window_attn.py", "the autograd backward of "
             "F.scaled_dot_product_attention with the bias as attn_mask, "
             "eager forward + backward less the eager forward",
             ("window_attn_train_bwd", "dbias")),
            ("mlp_train_fwd", 132, "_mlp_fwd_pallas", "mlp_train.py",
             "the two cuBLAS bf16 products alone (x W1, a W2)",
             ("mlp_train_fwd",)),
            ("mlp_train_bwd", 163, "_mlp_bwd_pallas", "mlp_train.py",
             "the five cuBLAS bf16 products alone (h = x W1, da = g W2^T, "
             "dx = dh W1^T, dw1 = x^T dh, dw2 = a^T g)",
             ("mlp_train_bwd", "dw"))):
        table = tk_rows[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "tpudepth_torch/csrc/"
                      + ("window_attn_train.cu" if src == "window_attn.py"
                         else "mlp_train.cu"),
            "replaces": f"tpudepth/ops/pallas/{src}:{line}",
            "replaces_function": f"tpudepth/ops/pallas/{src}::{fn}",
            "launches": sum(a["launches"][name] for a in attn_train.values()),
            "launches_by_path": {f"{m} training": a["launches"][name]
                                 for m, a in attn_train.items()},
            "max_abs_err": max(tk_err[k] for k in err_keys),
            "max_rel_err": max(tk_err_rel[k] for k in err_keys),
            "checks": sum(tk_checks[k] for k in err_keys),
            "ok": True,
            "timed": f"device time of the four calls of one B{SAM_BATCH} "
                     "480x640 bf16 SAM train step (crf3..crf0 summed), CUDA "
                     "graph replays; bound_ms counts the JAX kernel's own "
                     f"traffic; library_ms is {yardstick}",
            "ms": total(table, "ms"),
            "plain_ms": total(table, "plain_ms"),
            "bound_ms": total(table, "bound_ms"),
            "bound_by": bound_by(table),
            "library_ms": total(table, "library_ms"),
            "shapes": table,
        })
    for name, line, fn, what in (
            ("fused_root_loss_fwd", 148, "_fused_partials", "forward"),
            ("fused_root_loss_bwd", 189, "_frl_bwd",
             "forward + autograd backward less its forward")):
        r = rl_rows[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "tpudepth_torch/csrc/fused_root_loss.cu",
            "replaces": f"tpudepth/ops/pallas/fused_root_loss.py:{line}",
            "replaces_function":
                f"tpudepth/ops/pallas/fused_root_loss.py::{fn}",
            "launches": sum(a["launches"][name] for a in attn_train.values()),
            "launches_by_path": {f"{m} training": a["launches"][name]
                                 for m, a in attn_train.items()},
            "max_abs_err": rl_err[name],
            "checks": rl_checks,
            "ok": True,
            "timed": f"device time of one launch at B{TRAIN_BATCH} "
                     f"{TRAIN_HW[0]}x{TRAIN_HW[1]} f32, CUDA graph replays; "
                     "max_abs_err of the forward is per pixel of the partial "
                     "sums; bound_ms counts the JAX kernel's own traffic; "
                     "library_ms is the port's plain 1.0 * ssim + 0.1 * "
                     f"l1_loss {what}, eager between CUDA events",
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "bytes_ms": r["bytes_ms"], "ops_ms": r["ops_ms"],
            "cuda_kernels_per_call": r["cuda_kernels"],
        })
    print(json.dumps({"kernels": kernels, "serve_errors": errs,
                      "sam_serve_errors": sam_errs, "sam_engine": sam_perf,
                      "newcrf_serve_errors": crf_errs,
                      "newcrf_engine": crf_perf, "root_eval": root_eval,
                      "engine_img_per_s": perf, "training": train,
                      "fused_training": fused_train, "evaluation": evaluation,
                      "attention_training": attn_train,
                      "kernel_splits": splits,
                      "seconds": time.perf_counter() - t_start}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
