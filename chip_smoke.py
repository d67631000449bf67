#!/usr/bin/env python3
"""Smoke test of tpudepth_torch on one NVIDIA GPU: ``python3 chip_smoke.py``.

It drives the port's main paths at NYU 480x640 (the U-Net at KITTI
384x1280): serving (GuideDepth in bf16
with fused GUB stages), training (``Trainer.fit``, alhashim recipe, bf16,
batch 8) with plain and with fused GUB stages, the evaluator on the trained
model, serving MobileV3SAMDepth (MobileNetV3-Large + four SAM stages at
full width, bf16) with its blocks fused, paired, as window rows and as
whole blocks over raw windows, serving MobileV3NewCRFDepth (the same
encoder + four two-block NewCRF stages, the second block of each shifted)
with its blocks as window rows, fused, paired and as whole blocks, both
scored by the root protocol's ``RootEvaluator``, and training both
attention models (``Trainer.fit``, root recipe, bf16, batch 8) through the
training kernels, serving and training DenseDepth and the U-Nets, and
serializing engines through ``torch.export``. It holds every CUDA kernel of
those paths against its plain PyTorch version, and drives the data feed and
the command lines from a seeded dataset zip. Phases:

0. [host libs]: Pillow, matplotlib, OpenCV, TensorBoard, the libjpeg /
   libpng headers, g++, whether the native decoder built, and so which
   decoder reads the zips (the run fails when neither can);
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
   ``window_attn_train_bwd`` split into its CUDA kernels, counted from a
   CUDA graph of one call and timed by ``torch.profiler`` ([row kernel
   split], [block kernel split], [train kernel split]);
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
7b. [packed]: GuideDepth's packed (space-to-depth) stages, the JAX
   package's default (``build_model(packed=True)``: up_2 folded (2,2) to
   128 channels, up_3 (4,4) to 256): ``gub_conv_fwd`` (with and without
   statistics), ``gub_conv_dw`` and ``gub_conv_dx`` against their plain
   versions at the six packed conv shapes, B 1 and 8, f32 and bf16, then
   timed at B 8 beside cuDNN on the same packed tensors, the bound and
   the unpacked conv ([packed kernel time]); packed plain and fused
   engines (bf16, flip-TTA): 9 and 0 ``gub_conv_fwd`` a forward, bf16 and
   f32 against the f32 unpacked plain model, ms/frame, img/s and busy ms
   at bs 1 and 8 beside the unpacked engines, one call under
   ``utils.profiling.trace``; packed training at B 8 bf16: the kernels a
   step plain, fused and rematerialized (``remat_stages``: the forward
   kernel twice a step; ``TrainConfig(remat=True)`` too), one f32 packed
   step against the unpacked plain step, each rematerialized f32 step
   against the same model's plain step (running statistics moved once),
   ms/step, img/s and peak memory in turns;
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
   [weights jax]: a port trainer (GuideDepth fused; SAM with its encoder
   frozen) after 2 steps at B 8 bf16, the tree the JAX trainer's orbax
   checkpoint of that state restores to (built with the bridge tables'
   inverse: no JAX here), converted by ``trainer_checkpoint_from_jax`` and
   restored into two fresh trainers: model, statistics and Adam state
   bit-equal, the next step of the source within 4x the two restored
   copies' spread, SAM's encoder unchanged, the kernels counted;
   [weights torch]: GuideDepth saved as a GuideDepth release, the root
   ``global_checkpoint`` and the DDRNet ImageNet checkpoint, SAM's encoder
   as torchvision ``features``, each loaded into a fresh model and served
   one bs-1 bf16 frame bit-equal to the source's; [stage chain]: NewCRF
   ``row`` (its stages chained on the padded layout) against its blocks run
   one by one at bs 1 and 8: outputs bit-equal, chained blocks' padded
   outputs finite, launches and device
   ms a call in turns; [data parallel]: ``initialize`` a no-op without a
   launcher, then a world-1 NCCL group: fused GuideDepth at 480x640 bf16,
   global B 8, 3 ``Trainer`` steps with exact launches (9 + 9 + 9 GUB, 1 +
   1 loss a step) and ms a step, the warm step time under the group and
   without one between CUDA events in turns, one f32 step under the group
   against the step without (bit for bit when two repeats of the latter
   are; else within 4x their spread); then 2 gloo ranks on the one card
   (spawned ``--dp-rank`` processes, joined with a timeout), 4 images a
   rank, f32, 2 fused steps: both ranks bit-equal, rank 0's loss, change
   of the parameters, Adam first moments and running statistics within 4x
   the spread of two repeats of one process on the union batch, launches
   exact;
   [zoo]: DenseDepth, the interpolated U-Net large and small at 480x640 and
   the U-Net at KITTI's 384x1280 (it takes multiples of 64 only), seeded
   at their published widths, served in bf16 through ``InferenceEngine``
   at bs 1 and 8 (ms/frame, img/s, the half-size output against the f32
   model), then 3 root-recipe train steps at B 8 with
   ``fused_root_loss_fwd`` / ``_bwd`` counted (one each a step, at the
   half-size prediction: 240x320, 192x640), one f32 step through the loss
   kernels against the plain ``ssim + 0.1 l1_loss`` step, and img/s;
   [engine export]: the bf16 bs-1 engines of fused GuideDepth (unpacked
   and packed), SAM
   ``fused`` / ``pair`` / ``row`` / ``block``, NewCRF ``row`` / ``block``
   and the small interpolated U-Net serialized through ``torch.export``
   (every serving kernel a ``tpudepth::*`` custom op) and deserialized:
   the output against the live engine's, every kernel's launches a call
   equal live and deserialized (all eight kernels among them), export and
   load seconds, file size, live and deserialized ms/frame; [op cost]: the
   bs-1 frame of fused GuideDepth, SAM ``fused`` and NewCRF ``row`` with
   the kernels called through their ops and directly, in turns;
9. [data feed]: a seeded synthetic NYU zip (48 train and 16 test pairs at
   480x640, ``make_synthetic_zip``), its decode rate, the train split of
   ``get_dataloader`` from its decode-once cache in host batches and
   pinned and copied to the card one batch ahead, every device batch equal
   to its host batch over 3 epochs; [cli guidedepth]:
   ``guidedepth_main.main`` in this process, ``--train --eval`` at B8,
   2 epochs x 3 steps, GUB stages plain and fused (checkpoints,
   ``best_model``, ``results.txt``, finite metrics, the second epoch's train
   img/s beside [train]'s in-memory img/s); [cli train]: the root command
   line on NewCRF, B8, 1 epoch x 3 steps (rolling checkpoint, TensorBoard
   events); [cli test]: the root evaluation on that checkpoint; [cli
   inference]: ``tpudepth_torch.inference --eval --gub fused`` at bs 1
   (``inference_results.txt``). Each path's kernel launches are counted
   from 0 over exactly that run and must equal the expected counts;
10. one JSON line on the kernels (each kernel's launches on the command
   lines', the exported engines' and the zoo's training paths added to its
   ``launches_by_path``), and last the JSON line with the device.

Any failed check raises, and the script exits non-zero without printing a
result. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
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


def check_fwd_case(tag, seed, bsz, h, w, cins, cout, prelude, skip, dtype,
                   k=3, no_stats=False) -> float:
    """``gub_conv_fwd`` with statistics against ``conv_bn_act_reference``
    on one case (and, with ``no_stats``, the launch without statistics
    too), within ``gub_conv.tolerance``; the statistics within
    ``STATS_RTOL``. Returns the largest absolute error of the output."""
    from tpudepth_torch.ops.kernels.gub_conv import (
        conv_bn_act,
        conv_bn_act_reference,
        tolerance,
    )

    parts, wt, b, pre, sk = make_case(seed, bsz, h, w, cins, cout, prelude,
                                      skip, dtype, DEVICE, k)
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
    e_plain = None
    if no_stats:
        y2 = conv_bn_act(parts, wt, b, preludes=pre, skip=sk).float()
        torch.cuda.synchronize()
        err2 = (y2 - yr).abs()
        ok_y = ok_y and bool((err2 <= atol + rtol * yr.abs()).all())
        e_plain = float(err2.max())
        e = max(e, e_plain)
    print(f"[kernel] {tag:<24} {str(dtype)[6:]:<8} B{bsz} pre={int(prelude)} "
          f"skip={int(skip)} max_abs_err {float(err.max()):.3e} "
          f"(max rel {float((err / yr.abs().clamp_min(1e-3)).max()):.3e}; "
          f"atol {atol:g} rtol {rtol:g})"
          + ("" if e_plain is None else
             f", without statistics {e_plain:.3e}")
          + f" stats rel err {es:.2e} {eq:.2e} (rtol {STATS_RTOL:g})",
          flush=True)
    check(ok_y, f"{tag} {dtype} output beyond tolerance")
    check(es <= STATS_RTOL and eq <= STATS_RTOL, f"{tag} {dtype} statistics")
    return e


def phase_kernels():
    from tpudepth_torch.ops.kernels.gub_conv import (
        conv_bn_act,
        conv_bn_act_reference,
    )

    dev = torch.device("cuda")
    max_err = 0.0
    n_checks = 0

    def check_case(*args, **kwargs):
        nonlocal max_err, n_checks
        max_err = max(max_err, check_fwd_case(*args, **kwargs))
        n_checks += 1

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


def bwd_cotangents(seed, y, stats):
    """``dy`` of unit scale in ``y``'s dtype and, with statistics, ``ds`` and
    ``dq`` of scale 0.1 with the forward output ``y``."""
    rng = np.random.default_rng(1000 + seed)
    dy = torch.from_numpy(rng.standard_normal(tuple(y.shape))
                          .astype(np.float32)).to(DEVICE, y.dtype)
    if not stats:
        return dy, {}
    ds, dq = (torch.from_numpy((0.1 * rng.standard_normal(y.shape[-1]))
                               .astype(np.float32)).to(DEVICE)
              for _ in range(2))
    return dy, {"y": y, "ds": ds, "dq": dq}


def _close(got, want, atol, rtol):
    d = (got.float() - want.float()).abs()
    return bool((d <= atol + rtol * want.float().abs()).all()), float(d.max())


def check_bwd_case(tag, seed, bsz, h, w, cins, cout, prelude, skip, stats,
                   dtype, k=3):
    """``gub_conv_dw`` and ``gub_conv_dx`` (every part) on one case against
    their plain versions, each rerun bit-equal (tolerances: those of
    :func:`phase_bwd_kernels`). Returns ``{"dw", "dw_rel", "dx",
    "dx_sums_rel"}``: the largest errors, and the launches of dx."""
    from tpudepth_torch.ops.kernels import gub_conv as gc

    parts, wt, b, pre, sk = make_case(seed, bsz, h, w, cins, cout, prelude,
                                      skip, dtype, DEVICE, k)
    y = gc.conv_bn_act(parts, wt, b, preludes=pre, skip=sk)
    dy, cot = bwd_cotangents(seed, y, stats)
    n = bsz * h * w
    g_rms = _rms(gc._cotangent(dy, cot.get("y"), cot.get("ds"),
                               cot.get("dq")))
    xa_rms = _rms(torch.cat(gc._activate(parts, pre, sk), dim=-1))

    dw, db = gc.conv_bn_act_dw(parts, dy, wt, preludes=pre, skip=sk, **cot)
    torch.cuda.synchronize()
    rdw, rdb = gc.conv_bn_act_dw_reference(parts, dy, k, preludes=pre,
                                           skip=sk, **cot)
    ok_w, e_w = _close(dw, rdw, gc.sum_tolerance(n, xa_rms * g_rms),
                       gc.SUM_RTOL)
    ok_b, e_b = _close(db, rdb, gc.sum_tolerance(n, g_rms), gc.SUM_RTOL)
    dw2, db2 = gc.conv_bn_act_dw(parts, dy, wt, preludes=pre, skip=sk, **cot)
    same = torch.equal(dw, dw2) and torch.equal(db, db2)
    err = {"dw": max(e_w, e_b),
           "dw_rel": max(e_w / float(rdw.abs().max()),
                         e_b / float(rdb.abs().max()))}
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
                ok, e = _close(g, r, atol, rtol)
                e_x = max(e_x, e)
            else:
                # sums over H*W of dp (dC) and dp * x (dA), |dp| <= |dxa|
                dxa_rms = _rms(want[3] if want[3] is not None
                               else want[0] / pre[j][0][:, None, None, :])
                term = dxa_rms * (_rms(x) if name == "dA" else 1.0)
                ok, e = _close(g, r, gc.sum_tolerance(h * w, term),
                               gc.SUM_RTOL)
                e_s = max(e_s, e / float(r.abs().max()))
            ok_x = ok_x and ok
        off += cin
        del got, want, again
    err.update(dx=e_x, dx_sums_rel=e_s, dx_launches=len(parts))
    print(f"[kernel] bwd {tag:<24} {str(dtype)[6:]:<8} B{bsz} "
          f"pre={int(prelude)} skip={int(skip)} stats={int(stats)}: dw "
          f"max_abs_err {e_w:.3e} db {e_b:.3e} (of max|dw| "
          f"{float(dw.abs().max()):.3e}); dx max_abs_err {e_x:.3e} (atol "
          f"{atol:g} rtol {rtol:g}); dA/dC max err / max {e_s:.2e}; "
          f"repeat bit-equal {same}", flush=True)
    check(ok_w and ok_b, f"{tag} {dtype} dw/db beyond tolerance")
    check(ok_x, f"{tag} {dtype} dx/dskip/dA/dC beyond tolerance")
    check(same, f"{tag} {dtype} backward kernels do not repeat")
    return err


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

    def check_case(*args, **kwargs):
        e = check_bwd_case(*args, **kwargs)
        for key in err:
            err[key] = max(err[key], e[key])
        n_checks["dw"] += 1
        n_checks["dx"] += e["dx_launches"]

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
        dy, cot = bwd_cotangents(i, y, True)
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
    """Profile ``runs`` engine calls on a zero image; returns the busy ms a
    call (:func:`profile_window`)."""
    example = torch.zeros(eng.input_shape, device="cuda")
    return profile_window(lambda: eng(example), tag, runs)


def profile_window(fn, tag: str, runs: int):
    """Device busy share of ``runs`` calls of ``fn`` (kernel time summed by
    the profiler over the host-clock window) and the kernels that take
    most. Returns the busy ms a call (None when the trace has no device
    time)."""
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
        return None
    n_launch = sum(e.count for e in kernels)
    print(f"[profile] {tag}: device busy {busy_us / runs / 1e3:.3f} ms of "
          f"{wall_us / runs / 1e3:.3f} ms per call ({100 * busy_us / wall_us:.1f}%"
          f" busy), {n_launch / runs:.0f} kernel launches per call")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[profile] {tag}:   {e.self_device_time_total / runs / 1e3:8.3f} "
              f"ms/call  x{e.count // runs:<4} {e.key[:90]}")
    sys.stdout.flush()
    return busy_us / runs / 1e3


class SyntheticLoader:
    """``n`` seeded batches as a loader of the port delivers them: NHWC
    ``image`` raw uint8 and ``depth`` raw uint8 (training) or float in
    [0, 1] (validation), NYU-like with a tenth of the depth pixels 0."""

    def __init__(self, n: int, seed: int, raw_depth: bool, hw=TRAIN_HW):
        rng = np.random.default_rng(seed)
        h, w = hw
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


def one_f32_step(cfg, model, batch, recipe, remat=False):
    """Loss and gradients of one f32 train step (augment off) of ``model``
    (moved to the card) on ``batch``; ``remat``: the whole forward
    rematerialized (``make_train_step(remat=True)``)."""
    from tpudepth_torch.train.trainer import (
        TrainState,
        make_optimizer,
        make_train_step,
        step_lr,
    )

    model = model.to(DEVICE, memory_format=torch.channels_last)
    state = TrainState(model, make_optimizer(cfg, model.parameters()))
    step = make_train_step(model, recipe, step_lr(1e-4, 15, 0.1, 3),
                           compute_dtype=torch.float32, augment=False,
                           remat=remat)
    loss = step(state, torch.as_tensor(batch["image"]).to(DEVICE),
                torch.as_tensor(batch["depth"]).to(DEVICE))
    torch.cuda.synchronize()
    return float(loss), {n: p.grad.clone() for n, p in model.named_parameters()}


def compare_steps(tag, got, want, loss_rtol, grad_rel, floor,
                  min_compared=100):
    """Hold loss and per-tensor gradients of two steps together: per tensor
    the largest difference over the tensor's largest gradient, with an
    absolute ``floor`` under which a tensor holds noise (conv biases in
    front of a BatchNorm have a zero gradient); more than ``min_compared``
    tensors must lie above the floor."""
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
    check(n_above > min_compared, "the gradients are too small to compare")
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


# (name, input channels per part, Cout, H, W, prelude): the k=3 GUB convs of
# GuideDepth's packed stages at 480x640 (``build_model(packed=True)``), in
# the order a forward runs them: up_2 folded (2,2) to 128 channels and up_3
# folded (4,4) to 256, both on a 120x160 grid; the RGB guide folded to 12
# and 48 channels; the comb conv's two parts re-indexed into its weight.
# up_1 stays unpacked (PATH_SHAPES).
PACKED_SHAPES = [
    ("up_2.feature_conv_a", (128,), 128, 120, 160, False),
    ("up_2.guide_conv_a", (12,), 128, 120, 160, False),
    ("up_2.comb_conv_a", (64, 64), 128, 120, 160, True),
    ("up_3.feature_conv_a", (256,), 256, 120, 160, False),
    ("up_3.guide_conv_a", (48,), 256, 120, 160, False),
    ("up_3.comb_conv_a", (128, 128), 256, 120, 160, True),
]
# sub-pixel copies a packed channel stands for: a dense packed conv does
# this many times the unpacked conv's multiply-adds, the rest on zeros
PACKED_FOLD = {"up_2": 4, "up_3": 16}
PACKED_BLOCKS = [None, (2, 2), (4, 4)]
# serving timings of the packed phase: (bs, timed runs, warm-up runs)
PACKED_SERVE_RUNS = {1: (10, 2), 8: (5, 1)}
PACKED_TRAIN_STEPS = 3


def packed_kernel_checks():
    """The three GUB kernels against their plain versions at every
    ``PACKED_SHAPES`` row, B 1 and B 8, f32 and bf16: ``gub_conv_fwd``
    with and without statistics (:func:`check_fwd_case`), ``gub_conv_dw``
    and ``gub_conv_dx`` with the statistics' cotangents, every part
    (:func:`check_bwd_case`), with [kernel]'s and [bwd]'s tolerances."""
    err = {"fwd": 0.0, "dw": 0.0, "dw_rel": 0.0, "dx": 0.0,
           "dx_sums_rel": 0.0}
    checks = {"fwd": 0, "dw": 0, "dx": 0}
    for i, (name, cins, cout, h, w, prelude) in enumerate(PACKED_SHAPES):
        for bsz in (1, TRAIN_BATCH):
            for dtype in (torch.float32, torch.bfloat16):
                err["fwd"] = max(err["fwd"], check_fwd_case(
                    f"packed {name}", 700 + i, bsz, h, w, cins, cout,
                    prelude, False, dtype, no_stats=True))
                e = check_bwd_case(f"packed {name}", 720 + i, bsz, h, w, cins,
                                   cout, prelude, False, True, dtype)
                for key in ("dw", "dw_rel", "dx", "dx_sums_rel"):
                    err[key] = max(err[key], e[key])
                checks["fwd"] += 1
                checks["dw"] += 1
                checks["dx"] += e["dx_launches"]
                torch.cuda.empty_cache()
    return err, checks


def packed_kernel_times(rows, bwd_rows):
    """Device times of the three GUB kernels at ``PACKED_SHAPES`` as a
    packed B 8 bf16 train step launches them (statistics on; ``gub_conv_dx``
    for the depth feature and the comb conv's parts), beside cuDNN on the
    same packed tensors (``F.conv2d`` + ``batch_norm_stats``;
    ``convolution_backward``), the bound of the dense packed conv and the
    bound of its non-zero products (1/``PACKED_FOLD`` of them), and the
    unpacked conv's kernel times of [kernel time] (``rows``, ``bwd_rows``)."""
    from tpudepth_torch.ops.kernels import gub_conv as gc

    dtype = torch.bfloat16
    unpacked = {r["name"]: r for r in rows}
    unpacked_bwd = {r["name"]: r for r in bwd_rows}
    conv_bwd = torch.ops.aten.convolution_backward
    out = []
    for i, (name, cins, cout, h, w, prelude) in enumerate(PACKED_SHAPES):
        fold = PACKED_FOLD[name[:4]]
        parts, wt, b, pre, _ = make_case(740 + i, TRAIN_BATCH, h, w, cins,
                                         cout, prelude, False, dtype, DEVICE)
        x_lib = torch.cat(gc._activate(parts, pre, None), dim=-1).permute(
            0, 3, 1, 2)
        w_lib = wt.to(dtype).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        b_lib = b.to(dtype)
        y = gc.conv_bn_act(parts, wt, b, preludes=pre)
        dy, cot = bwd_cotangents(i, y, True)
        g_lib = dy.permute(0, 3, 1, 2)
        dx_parts = [] if "guide" in name else list(range(len(cins)))
        offs = np.cumsum([0, *cins])

        def run_dx():
            for j in dx_parts:
                gc.conv_bn_act_dx(parts[j], wt, int(offs[j]), dy,
                                  prelude=pre[j] if prelude else None, **cot)

        def lib_bwd(mask):
            return conv_bwd(g_lib, x_lib, w_lib, [cout], [1, 1], [1, 1],
                            [1, 1], False, [0, 0], 1, mask)

        fwd_b, fwd_bytes, fwd_ops = _bound_ms(TRAIN_BATCH, h, w, cins, cout,
                                              prelude)
        (dw_b, dw_bytes, dw_ops), (dx_b, dx_bytes, dx_ops) = _bwd_bounds(
            TRAIN_BATCH, h, w, cins, cout, prelude, dx_parts)
        r = {"name": name, "cins": list(cins), "cout": cout, "hw": [h, w],
             "fold": fold, "dx_launches": len(dx_parts),
             "fwd_ms": time_ms(lambda: gc.conv_bn_act(
                 parts, wt, b, preludes=pre, stats=True), 2, 5),
             "fwd_library_ms": time_ms(lambda: torch.batch_norm_stats(
                 F.conv2d(x_lib, w_lib, b_lib, padding=1), 1e-5), 2, 5),
             "fwd_bound_ms": fwd_b,
             "fwd_needed_bound_ms": max(fwd_bytes, fwd_ops / fold),
             "fwd_bound_by": "bytes" if fwd_bytes >= fwd_ops else "operations",
             "dw_ms": time_ms(lambda: gc.conv_bn_act_dw(
                 parts, dy, wt, preludes=pre, **cot), 2, 5),
             "dw_library_ms": time_ms(lambda: lib_bwd([False, True, True]),
                                      2, 5),
             "dw_bound_ms": dw_b,
             "dw_needed_bound_ms": max(dw_bytes, dw_ops / fold),
             "dx_ms": time_ms(run_dx, 2, 5) if dx_parts else 0.0,
             "dx_library_ms": (time_ms(lambda: lib_bwd([True, False, False]),
                                       2, 5) if dx_parts else 0.0),
             "dx_bound_ms": dx_b if dx_parts else 0.0,
             "dx_needed_bound_ms": (max(dx_bytes, dx_ops / fold)
                                    if dx_parts else 0.0),
             "unpacked_fwd_ms": unpacked[name]["b8_ms"],
             "unpacked_dw_ms": unpacked_bwd[name]["dw_ms"],
             "unpacked_dx_ms": unpacked_bwd[name]["dx_ms"]}
        out.append(r)
        print(f"[packed kernel time] {name:<20} "
              f"{'+'.join(map(str, cins))}->{cout} @{h}x{w} fold {fold} "
              f"B{TRAIN_BATCH} bf16 stats: gub_conv_fwd {r['fwd_ms']:.4f} ms "
              f"(cuDNN F.conv2d + batch_norm_stats {r['fwd_library_ms']:.4f}; "
              f"bound {fwd_b:.4f} dense {r['fwd_bound_by']}, "
              f"{r['fwd_needed_bound_ms']:.4f} non-zero; unpacked conv "
              f"{r['unpacked_fwd_ms']:.4f}); gub_conv_dw {r['dw_ms']:.4f} "
              f"(cuDNN {r['dw_library_ms']:.4f}, bound {dw_b:.4f} / "
              f"{r['dw_needed_bound_ms']:.4f}, unpacked "
              f"{r['unpacked_dw_ms']:.4f}); gub_conv_dx x{len(dx_parts)} "
              f"{r['dx_ms']:.4f} (cuDNN {r['dx_library_ms']:.4f}, bound "
              f"{r['dx_bound_ms']:.4f} / {r['dx_needed_bound_ms']:.4f}, "
              f"unpacked {r['unpacked_dx_ms']:.4f})", flush=True)
        del parts, x_lib, y, dy, cot, g_lib
        torch.cuda.empty_cache()
    for which in ("fwd", "dw", "dx"):
        ms, lib, unp = (sum(r[k] for r in out) for k in (
            f"{which}_ms", f"{which}_library_ms", f"unpacked_{which}_ms"))
        print(f"[packed kernel time] gub_conv_{which} total, the packed "
              f"stages of one B{TRAIN_BATCH} bf16 train step: {ms:.4f} ms, "
              f"cuDNN {lib:.4f} ms, the same convs unpacked {unp:.4f} ms",
              flush=True)
    return out


def packed_serving(tmp):
    """GuideDepth with ``packed=True``, GUB stages plain and fused, served
    through ``InferenceEngine`` (bf16, flip-TTA): 4 requests each with the
    kernels counted over exactly them (``gub_conv_fwd`` 9 a forward fused,
    0 plain); the raw bf16 and f32 outputs against the f32 unpacked plain
    model; ms/frame, img/s and busy ms a call at bs 1 and 8 beside the
    unpacked models of the same run; one fused call under
    ``utils.profiling.trace``."""
    from tpudepth_torch.infer.engine import InferenceEngine
    from tpudepth_torch.models.layers import init_random_
    from tpudepth_torch.models.registry import build_model
    from tpudepth_torch.utils.profiling import trace

    base = init_random_(build_model("GuideDepth"), seed=0).state_dict()
    models = {}
    for packed in (False, True):
        for gub in ("plain", "fused"):
            m = build_model("GuideDepth", gub=gub, packed=packed)
            m.load_state_dict(base)
            models[("packed " if packed else "") + gub] = m
    blocks = models["packed fused"].stage_blocks(*TRAIN_HW)
    check(blocks == PACKED_BLOCKS, f"stage blocks {blocks}")
    shape = (1, 3, *TRAIN_HW)
    images = [np.random.default_rng(800 + i).random(shape, dtype=np.float32)
              for i in range(4)]

    def answers(name, dtype):
        eng = InferenceEngine(models[name], shape, compute_dtype=dtype,
                              flip_tta=True)
        eng(images[0])
        outs, _, counts = run_counted(lambda: [eng(img).float()
                                               for img in images])
        return torch.cat(outs), counts

    out = {"blocks": blocks, "launches_per_forward": {}, "errors": {},
           "launches": 0}
    ref, _ = answers("plain", torch.float32)
    check(float(ref.std()) > 1e-2, "reference output is constant")
    for gub, per_forward in (("fused", FUSED_FWD_PER_PASS), ("plain", 0)):
        got, counts = answers(f"packed {gub}", torch.bfloat16)
        n = counts.get("gub_conv_fwd", 0)
        out["launches_per_forward"][gub] = n / (2 * len(images))
        if gub == "fused":
            out["launches"] = n
        check(n == per_forward * 2 * len(images) and set(counts) <= {
            "gub_conv_fwd"}, f"packed {gub}: {counts} over {len(images)} "
              f"flip-TTA requests, expected {per_forward} gub_conv_fwd a "
              "forward")
        got32, _ = answers(f"packed {gub}", torch.float32)
        for tag, g in ((f"bf16 packed {gub}", got), (f"f32 packed {gub}",
                                                     got32)):
            rel_l2 = float((g - ref).norm() / ref.norm())
            rel_max = float((g - ref).abs().max() / ref.abs().max())
            out["errors"][tag] = (rel_l2, rel_max)
            print(f"[packed serve] raw output, {tag} vs f32 unpacked plain "
                  f"(flip-TTA, 4 images): rel L2 {rel_l2:.3e}, max abs / "
                  f"max|ref| {rel_max:.3e}; gub_conv_fwd launches "
                  f"{n} over 4 bf16 requests", flush=True)
        l2, mx = out["errors"][f"bf16 packed {gub}"]
        check(l2 <= SERVE_BF16_REL_L2 and mx <= SERVE_BF16_REL_MAX,
              f"bf16 packed {gub} vs f32 unpacked plain: {l2:.3e} / {mx:.3e}")
        check(out["errors"][f"f32 packed {gub}"][0] <= SERVE_F32_REL_MAX,
              f"f32 packed {gub} vs f32 unpacked plain beyond "
              f"{SERVE_F32_REL_MAX}")

    # ms/batch in turns (unpacked and packed, plain and fused, then the
    # reverse order: the host's load drifts), then a profile of each
    out["perf"] = {}
    names = ("plain", "packed plain", "fused", "packed fused")
    for bs, (runs, warm) in PACKED_SERVE_RUNS.items():
        engines = {name: InferenceEngine(models[name], (bs, 3, *TRAIN_HW),
                                         compute_dtype=torch.bfloat16,
                                         flip_tta=True) for name in names}
        turns = {name: [] for name in names}
        peak = {}
        for name in names + names[::-1]:
            torch.cuda.reset_peak_memory_stats()
            turns[name].append(1e3 * engines[name].benchmark(
                runs, warm)["seconds_per_frame"])
            peak[name] = torch.cuda.max_memory_allocated() / 2**20
        for name in names:
            ms = statistics.mean(turns[name])
            r = out["perf"][f"{name} bs{bs}"] = {
                "ms_per_batch": ms, "turns_ms": turns[name],
                "img_per_s": bs / ms * 1e3, "peak_mib": peak[name],
                "busy_ms": profile_engine(engines[name],
                                          f"packed phase {name} bs{bs}",
                                          runs=1)}
            print(f"[packed engine] GuideDepth 480x640 bf16 flip-TTA "
                  f"{name:<12} bs{bs}: {ms:.3f} ms/batch (turns "
                  f"{', '.join(f'{t:.3f}' for t in turns[name])}; {runs} "
                  f"runs each), {r['img_per_s']:.1f} img/s, busy "
                  f"{r['busy_ms']:.3f} ms a call, peak {peak[name]:.0f} MiB",
                  flush=True)
        del engines
    eng = InferenceEngine(models["packed fused"], shape,
                          compute_dtype=torch.bfloat16, flip_tta=True)
    logdir = f"{tmp}/packed_trace"
    with trace(logdir):
        eng(images[0])
        torch.cuda.synchronize()
    files = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
    check(len(files) == 1 and os.path.getsize(f"{logdir}/{files[0]}") > 0,
          f"utils.profiling.trace wrote {files}")
    print(f"[packed] utils.profiling.trace around one packed fused call: "
          f"{files[0]}, {os.path.getsize(f'{logdir}/{files[0]}')} bytes",
          flush=True)
    out["trace_bytes"] = os.path.getsize(f"{logdir}/{files[0]}")
    return out


def packed_training():
    """Packed GuideDepth trained at B 8 bf16 through ``Trainer.train_step``
    (alhashim, augment on): the kernels a step, plain and fused, and with
    the GUB stages rematerialized; one f32 step packed against the unpacked
    plain step ([train fused]'s tolerances); one f32 step with
    ``remat_stages=True`` and one with ``remat=True`` against the same
    model's plain step (loss and gradients within [train]'s f32
    tolerances, running statistics equal); ms/step, img/s and peak memory,
    packed and unpacked in turns, and with each rematerialization."""
    from tpudepth_torch.core.config import TrainConfig
    from tpudepth_torch.models.layers import init_random_
    from tpudepth_torch.models.registry import build_model
    from tpudepth_torch.train.trainer import LossRecipe, Trainer

    loader = SyntheticLoader(3, seed=900, raw_depth=True)
    base = init_random_(build_model("GuideDepth"), seed=1)
    with torch.no_grad():
        base.up_3.reduce.bias.fill_(OUTPUT_BIAS)
    base = base.state_dict()
    cfg = TrainConfig(model="GuideDepth", dataset="nyu_reduced",
                      resolution="full", batch_size=TRAIN_BATCH,
                      compute_dtype="bfloat16", seed=0)

    def model_for(**options):
        m = build_model("GuideDepth", **options)
        m.load_state_dict(base)
        return m

    configs = {
        "plain": ({}, False),
        "fused": ({"gub": "fused"}, False),
        "packed plain": ({"packed": True}, False),
        "packed fused": ({"packed": True, "gub": "fused"}, False),
        "packed fused remat_stages": ({"packed": True, "gub": "fused",
                                       "remat_stages": True}, False),
        "packed fused remat": ({"packed": True, "gub": "fused"}, True),
    }
    trainers = {}
    for name, (options, remat) in configs.items():
        tr = Trainer(dataclasses.replace(cfg, remat=remat),
                     model=model_for(**options), device=DEVICE,
                     train_loader=loader)
        tr.init_state()
        trainers[name] = tr
    out = {"per_step": {}, "steps": {}}
    want = {"packed plain": (0, 0, 0),
            "packed fused": (FUSED_FWD_PER_PASS, FUSED_DW_PER_STEP,
                             FUSED_DX_PER_STEP),
            "packed fused remat_stages": (2 * FUSED_FWD_PER_PASS,
                                          FUSED_DW_PER_STEP,
                                          FUSED_DX_PER_STEP),
            "packed fused remat": (2 * FUSED_FWD_PER_PASS, FUSED_DW_PER_STEP,
                                   FUSED_DX_PER_STEP)}
    for name, per_step in want.items():
        tr = trainers[name]
        losses, _, counts = run_counted(lambda: [
            float(tr.train_step(b)) for b in loader.batches[:PACKED_TRAIN_STEPS]])
        got = tuple(counts.get(k, 0) / PACKED_TRAIN_STEPS for k in (
            "gub_conv_fwd", "gub_conv_dw", "gub_conv_dx"))
        out["per_step"][name] = counts
        print(f"[packed train] {name}: {PACKED_TRAIN_STEPS} steps B"
              f"{TRAIN_BATCH} bf16, losses {[round(x, 4) for x in losses]}, "
              f"launches {counts}", flush=True)
        check(all(np.isfinite(losses)), f"{name}: losses {losses}")
        check(got == per_step, f"{name}: (fwd, dw, dx) a step {got}, "
              f"expected {per_step}")
        check(counts.get("fused_loss_fwd") == PACKED_TRAIN_STEPS
              and counts.get("fused_loss_bwd") == PACKED_TRAIN_STEPS,
              f"{name}: loss kernels {counts}")

    # one f32 step: packed against unpacked plain, and each
    # rematerialization against the same model without it
    batch = loader.batches[0]
    recipe = LossRecipe(kind="alhashim", max_depth=MAX_DEPTH,
                        depth_scale=MAX_DEPTH)
    steps, stats = {}, {}
    for name in ("plain", "packed plain", "packed fused", "packed fused again",
                 "packed fused remat_stages", "packed fused remat"):
        options, remat = configs[name.replace(" again", "")]
        model = model_for(**options)
        steps[name] = one_f32_step(cfg, model, batch, recipe, remat=remat)
        stats[name] = {k: v.clone() for k, v in model.state_dict().items()
                       if "running" in k}
        del model
    g_all = max(float(g.abs().max()) for g in steps["plain"][1].values())
    for name in ("packed plain", "packed fused"):
        out["steps"][name] = compare_steps(
            f"{name} vs unpacked plain", steps[name], steps["plain"],
            FUSED_STEP_LOSS_RTOL, FUSED_STEP_GRAD_REL,
            FUSED_STEP_GRAD_FLOOR_REL * g_all)
    # A rematerialized step computes what the plain step computes, but no
    # two runs of the same f32 step are bit-equal: the forward kernel adds
    # its BatchNorm sums in f64 atomics in no fixed order, and a sum off by
    # its last bit flips a few ReLU gates as in [train fused] (and cuDNN's
    # backward may sum in another order). So each rematerialized step is
    # held to [train fused]'s tolerances, beside the same step run twice.
    for name in ("packed fused again", "packed fused remat_stages",
                 "packed fused remat"):
        out["steps"][name] = compare_steps(
            f"{name} vs packed fused", steps[name], steps["packed fused"],
            FUSED_STEP_LOSS_RTOL, FUSED_STEP_GRAD_REL,
            FUSED_STEP_GRAD_FLOOR_REL * g_all)
    for name in ("packed fused remat_stages", "packed fused remat"):
        # moved once: a second move would be off by a tenth of the first;
        # each tensor's largest difference over its largest value
        worst = max(float((v - stats["packed fused"][k]).abs().max()
                          / stats["packed fused"][k].abs().max())
                    for k, v in stats[name].items())
        same = all(torch.equal(v, stats["packed fused"][k])
                   for k, v in stats[name].items())
        out["steps"][name] += (worst, same)
        print(f"[packed train] {name}: running statistics after one f32 "
              f"step against packed fused: largest rel diff {worst:.2e}, "
              f"bit-equal {same}", flush=True)
        check(worst <= STATS_RTOL, f"{name}: running statistics moved "
              "otherwise than once")
    del steps

    # ms/step, img/s and peak memory in turns (warm, between CUDA events)
    times = {name: [] for name in trainers}
    mem = {}
    order = list(trainers)
    for name in order + order[::-1]:
        tr = trainers[name]
        tr.train_step(loader.batches[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(PACKED_TRAIN_STEPS):
            tr.train_step(loader.batches[i % 3])
        end.record()
        end.synchronize()
        times[name].append(start.elapsed_time(end) / PACKED_TRAIN_STEPS)
        mem[name] = torch.cuda.max_memory_allocated() / 2**20
    out["perf"] = {}
    for name in order:
        ms = statistics.mean(times[name])
        out["perf"][name] = {"step_ms": ms, "img_per_s": TRAIN_BATCH / ms * 1e3,
                             "peak_mib": mem[name], "turns_ms": times[name]}
        print(f"[packed train] {name:<26} GuideDepth 480x640 B{TRAIN_BATCH} "
              f"bf16: {ms:.2f} ms/step ({', '.join(f'{t:.2f}' for t in times[name])}"
              f"), {TRAIN_BATCH / ms * 1e3:.1f} img/s, peak memory "
              f"{mem[name]:.0f} MiB", flush=True)
    busy = {}
    for name in ("plain", "packed plain", "fused", "packed fused"):
        busy[name] = profile_window(
            lambda: trainers[name].train_step(batch),
            f"packed phase train step {name}", 1)
    out["busy_ms"] = busy
    return out


def phase_packed(tmp, rows, bwd_rows):
    """[packed]: GuideDepth's packed (space-to-depth) stages, the JAX
    package's default: the GUB kernels at the packed widths against their
    plain versions and timed, packed serving and packed training."""
    t0 = time.perf_counter()
    seconds = {}

    def part(name, fn, *args):
        t = time.perf_counter()
        result = fn(*args)
        torch.cuda.empty_cache()
        seconds[name] = time.perf_counter() - t
        return result

    err, checks = part("checks", packed_kernel_checks)
    out = {"errors": err, "checks": checks,
           "kernel_times": part("kernel times", packed_kernel_times, rows,
                                bwd_rows),
           "serving": part("serving", packed_serving, tmp),
           "training": part("training", packed_training),
           "seconds": time.perf_counter() - t0, "part_seconds": seconds}
    print(f"[packed] {out['seconds']:.1f} s: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()),
          flush=True)
    return out


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
    """The CUDA kernels ``fn`` launches a call, counted from the kernel
    nodes of a CUDA graph of one call (``utils.profiling.graph_kernels``,
    which drops nothing), and the device ms a call of each, by name, from a
    ``torch.profiler`` trace of ``calls`` calls (a trace can drop late
    events: its counts are printed beside the graph's). Returns
    ``{"cuda_kernels": n, "split": [(name, ms, count)]}``."""
    from torch.profiler import ProfilerActivity, profile

    from tpudepth_torch.utils.profiling import graph_kernels

    n = graph_kernels(fn)
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
    return {"cuda_kernels": n, "split": sorted(out, key=lambda r: -r[1])}


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
            traced = sum(count for _, _, count in split["split"])
            print(f"[{label} kernel split] {key} {stage} B{SAM_BATCH} bf16: "
                  f"{split['cuda_kernels']} CUDA kernels a call (CUDA graph; "
                  f"the profiler saw {traced})", flush=True)
            for kname, ms, count in split["split"]:
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
    counters = _counters()
    return {k: counters[k] for k in TRAIN_KERNELS}


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
# of 2 rows or columns; the zoo's half-size predictions at B 8
# (ZOO_LOSS_HW: 480x640 and KITTI's 384x1280 halved)
ZOO_LOSS_HW = [(240, 320), (192, 640)]
ROOT_CASES = [("unit", 8, 480, 640), ("anti", 8, 480, 640), ("equal", 2, 40, 40),
              ("smooth", 2, 34, 46), ("unit", 3, 33, 47), ("anti", 2, 17, 61),
              ("unit", 2, 15, 61), ("anti", 2, 17, 63), ("unit", 1, 16, 62),
              ("unit", 1, 2, 65), ("unit", 1, 65, 2)] + [
              ("unit", 8, h, w) for h, w in ZOO_LOSS_HW]
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
    counters = _counters()
    return {k: counters[k] for k in ROOT_KERNELS}


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
    # the zoo's training shapes: kernel, plain version and bound
    for h, w in ZOO_LOSS_HW:
        p, t = make_root_pair("unit", bsz, h, w, seed=2)
        pixels = p.numel()
        scales = torch.tensor([1.0 / pixels, 0.1 / pixels], device=DEVICE)
        for name, kern, plain, nbytes, flops in (
                ("fused_root_loss_fwd", lambda: frl.root_partials(p, t),
                 lambda: frl.root_partials_reference(p, t),
                 2 * pixels * 4 + bsz * 2 * 4, pixels * ROOT_FWD_FLOP_PER_PIXEL),
                ("fused_root_loss_bwd", lambda: frl.root_bwd(p, t, scales),
                 lambda: frl.root_bwd_reference(p, t, scales),
                 3 * pixels * 4 + 2 * 4, pixels * ROOT_BWD_FLOP_PER_PIXEL)):
            ms, plain_ms = time_ms(kern), time_ms(plain, per_graph=2,
                                                  replays=10)
            bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S) * 1e3
            rows[name].setdefault("zoo_shapes", []).append(
                {"shape": [bsz, 1, h, w], "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound})
            print(f"[root loss kernel time] {name} B{bsz} {h}x{w} f32 (zoo): "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{bound:.4f} ms ({100 * bound / ms:.1f}% of bound)",
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


# [zoo]: the rest of the model zoo, (name, input H x W, dataset); the U-Net
# takes H and W that are multiples of 64, which no NYU size is, so it runs
# at KITTI full
ZOO = [("densedepth", (480, 640), "nyu_reduced"),
       ("unet_interp", (480, 640), "nyu_reduced"),
       ("unet_interp_small", (480, 640), "nyu_reduced"),
       ("unet", (384, 1280), "kitti")]
# raw output (these heads have no sigmoid), bf16 engine against the f32
# model on the same weights: ||got - ref|| / ||ref||, the bound [serve]
# holds GuideDepth's raw output to
ZOO_BF16_REL_L2 = SERVE_BF16_REL_L2
ZOO_TRAIN_STEPS, ZOO_TIMED_STEPS = 3, 4
# a zoo model has 166-204 parameter tensors, against the attention models'
# 300-600; about half of them lie above [sam train]'s floor (1e-4 of the
# largest gradient: the encoder's early layers get far smaller ones)
ZOO_MIN_COMPARED = 60


def phase_zoo():
    """[zoo]: each model of ``ZOO`` seeded at its published widths, served
    in bf16 through ``InferenceEngine`` at bs 1 and 8 (ms/frame, img/s, the
    half-size output against the f32 model), then ``ZOO_TRAIN_STEPS``
    root-recipe train steps at B 8 bf16 with ``fused_root_loss_fwd`` /
    ``_bwd`` counted (one each a step, at the half-size prediction), one
    f32 step through the loss kernels against the same step through the
    plain ``ssim + 0.1 l1_loss`` (the [sam train] bounds), and the step's
    img/s."""
    from tpudepth_torch.core.config import TrainConfig
    from tpudepth_torch.infer.engine import InferenceEngine
    from tpudepth_torch.losses.losses import l1_loss, ssim
    from tpudepth_torch.models.layers import init_random_
    from tpudepth_torch.models.registry import build_model
    from tpudepth_torch.train.trainer import LossRecipe, Trainer

    class PlainRootRecipe(LossRecipe):
        def loss(self, pred, target):
            return 1.0 * ssim(pred, target) + 0.1 * l1_loss(pred, target)

    counters = _root_counters()
    out = {}
    for name, (h, w), dataset in ZOO:
        res = out[name] = {"input": [h, w]}
        model = init_random_(build_model(name), seed=500)
        weights = copy.deepcopy(model.state_dict())
        rng = np.random.default_rng(501)
        for bs in (1, SAM_BATCH):
            x = rng.random((bs, 3, h, w), dtype=np.float32)
            eng = InferenceEngine(model, (bs, 3, h, w),
                                  compute_dtype=torch.bfloat16)
            got = eng(x)
            ref = InferenceEngine(model, (bs, 3, h, w),
                                  compute_dtype=torch.float32)(x)
            check(tuple(got.shape) == (bs, 1, h // 2, w // 2)
                  and got.dtype == torch.float32, f"{name} output {got.shape}")
            check(bool(torch.isfinite(got).all()), f"{name}: non-finite depth")
            rel_l2 = float((got - ref).norm() / ref.norm())
            rel_max = float((got - ref).abs().max() / ref.abs().max())
            check(float(ref.std()) > 1e-3, f"{name}: constant reference")
            check(rel_l2 <= ZOO_BF16_REL_L2,
                  f"{name} bf16 vs f32 rel L2 {rel_l2:.3e} beyond "
                  f"{ZOO_BF16_REL_L2}")
            stats = eng.benchmark(20 if bs == 1 else 8, 3)
            res[f"bs{bs}"] = {
                "ms_per_frame": 1e3 * stats["seconds_per_frame"] / bs,
                "img_per_s": stats["images_per_second"], "rel_l2": rel_l2,
                "rel_max": rel_max}
            print(f"[zoo] {name} {h}x{w} bf16 bs{bs}: "
                  f"{res[f'bs{bs}']['ms_per_frame']:.3f} ms/frame, "
                  f"{stats['images_per_second']:.1f} img/s; output "
                  f"{tuple(got.shape)}, vs f32: rel L2 {rel_l2:.3e} (bound "
                  f"{ZOO_BF16_REL_L2:g}), max abs / max|ref| {rel_max:.3e}",
                  flush=True)
            del eng
        del model

        cfg = TrainConfig(model=name, dataset=dataset, resolution="full",
                          batch_size=TRAIN_BATCH, compute_dtype="bfloat16",
                          seed=0)
        loader = SyntheticLoader(2, seed=502, raw_depth=True, hw=(h, w))
        trained = build_model(name)
        trained.load_state_dict(weights)
        pred_shapes = []
        trained.register_forward_hook(
            lambda m, i, o: pred_shapes.append(tuple(o.shape)))
        trainer = Trainer(cfg, model=trained, device=DEVICE,
                          train_loader=loader)
        trainer.init_state()
        check(trainer.recipe.kind == "root" and not trainer.freeze_encoder,
              f"{name}: root recipe, encoder trained")
        per_step, losses = [], []
        for i in range(ZOO_TRAIN_STEPS):
            for fn in counters.values():
                fn.launches = 0
            losses.append(float(trainer.train_step(loader.batches[i % 2])))
            per_step.append({k: fn.launches for k, fn in counters.items()})
        check(all(np.isfinite(losses)), f"{name}: train losses {losses}")
        check(per_step == [{k: 1 for k in ROOT_KERNELS}] * ZOO_TRAIN_STEPS,
              f"{name}: loss kernel launches per step {per_step}")
        check(set(pred_shapes) == {(TRAIN_BATCH, 1, h // 2, w // 2)},
              f"{name}: predictions {set(pred_shapes)}")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(ZOO_TIMED_STEPS):
            trainer.train_step(loader.batches[i % 2])
        end.record()
        end.synchronize()
        step_ms = start.elapsed_time(end) / ZOO_TIMED_STEPS
        res.update({"train_losses": losses, "launches_per_step": per_step[0],
                    "loss_shape": [TRAIN_BATCH, 1, h // 2, w // 2],
                    "step_ms": step_ms,
                    "train_img_per_s": TRAIN_BATCH / step_ms * 1e3})
        print(f"[zoo] {name} train B{TRAIN_BATCH} {h}x{w} bf16 root recipe: "
              f"losses {[round(x, 5) for x in losses]}, loss kernels at "
              f"[{TRAIN_BATCH}, 1, {h // 2}, {w // 2}], launches per step "
              f"{per_step[0]}; {step_ms:.2f} ms/step, "
              f"{res['train_img_per_s']:.1f} img/s ({ZOO_TIMED_STEPS} steps "
              "between CUDA events, warm)", flush=True)
        del trainer, trained

        results = {}
        for tag, recipe_cls in (("kernels", LossRecipe),
                                ("plain", PlainRootRecipe)):
            m = build_model(name)
            m.load_state_dict(weights)
            recipe = recipe_cls(kind="root", max_depth=MAX_DEPTH,
                                depth_scale=MAX_DEPTH)
            before = {k: fn.launches for k, fn in counters.items()}
            results[tag] = one_f32_step(cfg, m, loader.batches[0], recipe)
            got = {k: fn.launches - before[k] for k, fn in counters.items()}
            check(got == {k: int(tag == "kernels") for k in ROOT_KERNELS},
                  f"{name} f32 {tag} step launched {got}")
            del m
        g_all = max(float(g.abs().max()) for g in results["plain"][1].values())
        res["step_loss_rel"], res["step_grad_rel"] = compare_steps(
            f"{name} root loss kernels vs plain", results["kernels"],
            results["plain"], ATTN_STEP_LOSS_RTOL, ATTN_STEP_GRAD_REL,
            ATTN_STEP_GRAD_FLOOR_REL * g_all, ZOO_MIN_COMPARED)
        del results
        torch.cuda.empty_cache()
    return out


# [engine export]: (label, model, build_model keywords, input H x W, meters,
# the kernels' launches a bs-1 forward); between them every serving kernel
EXPORT_CASES = [
    ("GuideDepth fused", "GuideDepth", {"gub": "fused"}, True,
     {"gub_conv_fwd": 9}),
    ("GuideDepth fused packed", "GuideDepth",
     {"gub": "fused", "packed": True}, True, {"gub_conv_fwd": 9}),
    ("sam fused", "sam", {"attn": "fused"}, False,
     {"window_attn_infer": 4, "block_epilogue_infer": 4}),
    ("sam pair", "sam", {"attn": "pair"}, False,
     {"window_attn_infer": 4, "mlp_infer": 4}),
    ("sam row", "sam", {"attn": "row"}, False, {"sam_rowblock_infer": 4}),
    ("sam block", "sam", {"attn": "block"}, False, {"sam_block_infer": 4}),
    ("newcrf row", "newcrf", {"attn": "row"}, False,
     {"crf_rowblock_infer": 8}),
    ("newcrf block", "newcrf", {"attn": "block"}, False,
     {"crf_block_infer": 8}),
    ("unet_interp_small", "unet_interp_small", {}, False, {}),
]
# the deserialized engine against the live one, if their bits differ
EXPORT_REL_L2 = 1e-3
# the eight serving kernels, each a tpudepth::* custom op
SERVING_KERNELS = {"gub_conv_fwd", "window_attn_infer", "block_epilogue_infer",
                   "mlp_infer", "crf_rowblock_infer", "sam_rowblock_infer",
                   "sam_block_infer", "crf_block_infer"}
# the engines whose bs-1 frame times the calls through the ops against
# direct calls, in turns of OP_COST_RUNS frames a route (a few: the route
# was decided on the host time a call, below, which these turns confirm)
OP_COST_CASES = ("GuideDepth fused", "sam fused", "newcrf row")
OP_COST_RUNS, OP_COST_TURNS = 10, 4
# host time of one wrapper call (enqueue only), op against direct: rounds of
# OP_CALLS calls a route, the card drained between rounds (not timed)
OP_CALLS, OP_CALL_ROUNDS = 40, 8


@contextlib.contextmanager
def through_ops(on):
    """The serving wrappers call their ``tpudepth::*`` ops even in eager
    calls (``on``), or go to their kernels directly as eager serving does;
    the same kernels launch either way."""
    from tpudepth_torch.ops.kernels import _op

    saved = _op.through_op
    if on:
        _op.through_op = lambda: True
    try:
        yield
    finally:
        _op.through_op = saved


def _host_us_per_call(fn):
    """Median host microseconds of one ``fn()`` (its launches enqueued, not
    waited for) over ``OP_CALL_ROUNDS`` rounds of ``OP_CALLS`` calls."""
    times = []
    for _ in range(OP_CALL_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(OP_CALLS):
            fn()
        times.append((time.perf_counter() - t0) / OP_CALLS * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def op_call_cost():
    """[op cost] per call: the host time of one bs-1 bf16 call of
    ``gub_conv_fwd`` (up_1's comb conv), ``window_attn_infer`` (SAM crf3's
    attention) and ``crf_rowblock_infer`` (NewCRF crf3's block) through
    the op and directly, in turns."""
    from tpudepth_torch.ops.kernels import rowblock_infer as rbi
    from tpudepth_torch.ops.kernels import window_attn_infer as wai
    from tpudepth_torch.ops.kernels.gub_conv import conv_bn_act

    bf16 = torch.bfloat16
    parts, wt, b, pre, _ = make_case(0, 1, 120, 160, (32, 32), 64, True,
                                     False, bf16, DEVICE)
    attn, _ = _sam_kernel_inputs(0, 1, 9, 1024, 4096, 300, bf16)
    row, kw = _rowblock_inputs(0, 1, (15, 20), 1024, 32, 0, bf16)
    calls = {
        "gub_conv_fwd": lambda: conv_bn_act(parts, wt, b, preludes=pre),
        "window_attn_infer": lambda: wai.window_attention_infer(**attn),
        "crf_rowblock_infer": lambda: rbi.crf_rowblock_infer(**row, **kw)}
    out = {}
    with torch.inference_mode():
        for name, fn in calls.items():
            us = {"op": [], "direct": []}
            for r in ("op", "direct", "direct", "op"):
                with through_ops(r == "op"):
                    us[r].append(_host_us_per_call(fn))
            op_us, direct_us = (statistics.median(us[r])
                                for r in ("op", "direct"))
            out[name] = {"op_us": op_us, "direct_us": direct_us,
                         "added_us": op_us - direct_us}
            print(f"[op cost] {name} bs1 bf16: {op_us:.1f} us of host time "
                  f"a call through the op, {direct_us:.1f} direct "
                  f"({op_us - direct_us:+.1f} us; medians of "
                  f"{2 * OP_CALL_ROUNDS} rounds of {OP_CALLS} calls a "
                  "route)", flush=True)
    return out


def _export_engine(case):
    """One of ``EXPORT_CASES`` in a worker process: its bf16 bs-1 engine
    (:func:`_export_case_engine`) serialized to the case's path. Returns
    the seconds of ``InferenceEngine.serialize``: one eager call, the
    ``torch.export`` trace and the save."""
    (_, name, kw, meters, _), path = case
    eng = _export_case_engine(name, kw, meters)
    t0 = time.perf_counter()
    eng.serialize(path)
    return time.perf_counter() - t0


def _export_case_engine(name, kw, meters):
    """The bf16 bs-1 480x640 engine of an ``EXPORT_CASES`` model, seeded
    (the same weights in every process)."""
    from tpudepth_torch.infer.engine import InferenceEngine
    from tpudepth_torch.models.layers import init_random_
    from tpudepth_torch.models.registry import build_model

    model = init_random_(build_model(name, **kw), seed=601)
    return InferenceEngine(model, (1, 3, *TRAIN_HW),
                           compute_dtype=torch.bfloat16,
                           max_depth=MAX_DEPTH if meters else None)


def phase_engine_export(tmp):
    """[engine export]: the bf16 bs-1 engine of each of ``EXPORT_CASES``
    at 480x640 serialized (``InferenceEngine.serialize``, ``torch.export``
    through the ``tpudepth::*`` ops), all at once by spawned processes (the
    trace and the save are host work in Python), then deserialized here on
    the card: its output against the live engine's (bit-equal expected,
    else rel L2 <= ``EXPORT_REL_L2``), every kernel's launches a call equal
    live and deserialized and equal to the case's, the export and load
    seconds, the file's size, and live and deserialized ms/frame.
    [op cost]: the bs-1 frame of ``OP_COST_CASES`` with the kernels called
    through their ops (:func:`through_ops`) and directly, in turns
    (``OP_COST_TURNS`` of ``OP_COST_RUNS`` frames each), and the host time
    of one call of three kernels (:func:`op_call_cost`)."""
    import multiprocessing

    from tpudepth_torch.infer.engine import InferenceEngine, speedtest

    x = np.random.default_rng(600).random((1, 3, *TRAIN_HW), dtype=np.float32)
    example = torch.as_tensor(x, device=DEVICE)
    paths = [f"{tmp}/engine_{i}.pt2" for i in range(len(EXPORT_CASES))]
    workers = min(len(EXPORT_CASES), os.cpu_count() or 1)
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        export_s = pool.map(_export_engine, list(zip(EXPORT_CASES, paths)))
    t_all = time.perf_counter() - t0
    print(f"[engine export] {len(EXPORT_CASES)} engines exported and saved "
          f"by {workers} spawned processes in {t_all:.2f} s", flush=True)
    out, cost = {"parallel_export_s": t_all, "engines": {}}, {}
    for (label, name, kw, meters, per_call), path, t_export in zip(
            EXPORT_CASES, paths, export_s):
        eng = _export_case_engine(name, kw, meters)
        t0 = time.perf_counter()
        loaded = InferenceEngine.deserialize(path, device=DEVICE)
        t_load = time.perf_counter() - t0
        size = os.path.getsize(path)
        live, _, live_counts = run_counted(lambda: eng(x))
        got, _, got_counts = run_counted(lambda: loaded(x))
        check(live_counts == per_call and got_counts == per_call,
              f"{label}: launches live {live_counts}, deserialized "
              f"{got_counts}, expected {per_call}")
        equal = torch.equal(got, live)
        rel_l2 = float((got - live).norm() / live.norm())
        max_err = float((got - live).abs().max())
        check(equal or rel_l2 <= EXPORT_REL_L2,
              f"{label}: deserialized vs live rel L2 {rel_l2:.3e}")
        check(float(live.std()) > 1e-4, f"{label}: constant output")
        times = {tag: 1e3 * speedtest(f, example, 20, 3)["seconds_per_frame"]
                 for tag, f in (("live", eng), ("deserialized", loaded))}
        res = out["engines"][label] = {
            "export_s": t_export, "load_s": t_load, "file_mib": size / 2**20,
            "bit_equal": equal, "rel_l2": rel_l2, "max_abs_err": max_err,
            "launches_per_call": got_counts,
            "live_ms": times["live"],
            "deserialized_ms": times["deserialized"]}
        print(f"[engine export] {label} 480x640 bf16 bs1: export + save "
              f"{t_export:.2f} s (one of {workers} processes), load "
              f"{t_load:.2f} s, file {res['file_mib']:.1f} MiB; deserialized "
              f"vs live bit-equal {equal} (rel L2 {rel_l2:.3e}, max abs "
              f"{max_err:.3e}); launches a call {got_counts} (live "
              f"{live_counts}); {res['live_ms']:.3f} ms/frame live, "
              f"{res['deserialized_ms']:.3f} deserialized", flush=True)
        os.remove(path)
        if label in OP_COST_CASES:
            turns = {"op": [], "direct": []}
            for j in range(OP_COST_TURNS):
                for r in ("op", "direct")[::1 if j % 2 == 0 else -1]:
                    with through_ops(r == "op"):
                        turns[r].append(1e3 * speedtest(
                            eng, example, OP_COST_RUNS, 3)["seconds_per_frame"])
            op_ms, direct_ms = (statistics.median(turns[r])
                                for r in ("op", "direct"))
            calls = sum(per_call.values())
            cost[label] = {
                "op_ms": op_ms, "direct_ms": direct_ms,
                "added_pct": 100 * (op_ms - direct_ms) / direct_ms,
                "op_calls_per_frame": calls,
                "us_per_op_call": 1e3 * (op_ms - direct_ms) / calls,
                "turns": turns}
            print(f"[op cost] {label} 480x640 bf16 bs1: {op_ms:.4f} ms/frame "
                  f"through the ops, {direct_ms:.4f} ms direct: "
                  f"{cost[label]['added_pct']:+.2f} % (medians of "
                  f"{OP_COST_TURNS} turns of {OP_COST_RUNS} frames; "
                  f"{cost[label]['us_per_op_call']:+.2f} us a call, "
                  f"{calls} calls a frame; turns op "
                  f"{[round(t, 4) for t in turns['op']]}, direct "
                  f"{[round(t, 4) for t in turns['direct']]})", flush=True)
        del eng, loaded
        torch.cuda.empty_cache()
    cost["per_call"] = op_call_cost()
    return out, cost


# the data feed and the command lines: one seeded synthetic NYU zip at
# 480x640, 48 train pairs (6 batches of 8: 2 epochs x 3 steps) and 16 test
# pairs (2 validation batches; 16 evaluation images at batch 1)
FEED_TRAIN, FEED_TEST, FEED_EPOCHS = 48, 16, 3
# GuideDepth through its command line: 2 epochs x 3 steps, each epoch's
# validation over the 2 batches of the test split, then the evaluation of
# the 16 test images and their flips at batch 1
CLI_STEPS, CLI_VAL_BATCHES, CLI_EVAL_FORWARDS = 6, 4, 2 * FEED_TEST
# the inference command line's speedtests: warm-up and timed runs, f32 and bf16
CLI_WARMUP, CLI_RUNS = 5, 20


def _counters():
    """Every kernel wrapper of the port by the kernel's name: each counts its
    launches in ``.launches``."""
    from tpudepth_torch.ops.kernels import (
        block_infer,
        epilogue_infer,
        fused_loss,
        fused_root_loss,
        gub_conv,
        mlp_infer,
        mlp_train,
        rowblock_infer,
        window_attn,
        window_attn_infer,
    )

    return {
        "gub_conv_fwd": gub_conv.conv_bn_act,
        "gub_conv_dw": gub_conv.conv_bn_act_dw,
        "gub_conv_dx": gub_conv.conv_bn_act_dx,
        "fused_loss_fwd": fused_loss.fused_partials,
        "fused_loss_bwd": fused_loss.fused_bwd,
        "fused_root_loss_fwd": fused_root_loss.root_partials,
        "fused_root_loss_bwd": fused_root_loss.root_bwd,
        "window_attn_train_fwd": window_attn.window_attention_fwd,
        "window_attn_train_bwd": window_attn.window_attention_bwd,
        "mlp_train_fwd": mlp_train.mlp_train_fwd,
        "mlp_train_bwd": mlp_train.mlp_train_bwd,
        "window_attn_infer": window_attn_infer.window_attention_infer,
        "block_epilogue_infer": epilogue_infer.block_epilogue_infer,
        "mlp_infer": mlp_infer.mlp_infer,
        "crf_rowblock_infer": rowblock_infer.crf_rowblock_infer,
        "sam_rowblock_infer": rowblock_infer.sam_rowblock_infer,
        "sam_block_infer": block_infer.sam_block_infer,
        "crf_block_infer": block_infer.crf_block_infer,
    }


def run_counted(fn):
    """``fn()`` with every kernel's count set to 0 just before it and read
    just after it. Returns its result, its host seconds (synchronized) and
    the kernels it launched with their counts."""
    counters = _counters()
    for f in counters.values():
        f.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return out, seconds, {k: f.launches for k, f in counters.items()
                          if f.launches}


def phase_host_libs():
    """[host libs]: what the card's machine offers the data feed: Pillow,
    matplotlib, OpenCV, TensorBoard, the libjpeg / libpng headers and g++,
    whether the port's native decoder built, and so which decoder reads the
    zips. Without Pillow and without the native decoder no zip can be made
    or read, and the run fails."""
    import importlib.util

    from tpudepth_torch.data import native

    have = {m: importlib.util.find_spec(m) is not None
            for m in ("PIL", "matplotlib", "cv2", "tensorboard")}
    pil = "missing"
    if have["PIL"]:
        import PIL

        pil = PIL.__version__
    headers = {h: os.path.exists(f"/usr/include/{h}")
               for h in ("jpeglib.h", "png.h")}
    try:
        gxx = subprocess.run(["g++", "--version"], capture_output=True,
                             text=True, timeout=60).stdout.splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        gxx = "missing"
    t0 = time.perf_counter()
    built = native.get_lib() is not None
    t_build = time.perf_counter() - t0
    route = "native" if built else "pillow" if have["PIL"] else "none"
    print(f"[host libs] Pillow {pil}; matplotlib "
          f"{'found' if have['matplotlib'] else 'missing'}; OpenCV "
          f"{'found' if have['cv2'] else 'missing'}; tensorboard "
          f"{'found' if have['tensorboard'] else 'missing'}; headers "
          + ", ".join(f"{h} {'found' if ok else 'missing'}"
                      for h, ok in headers.items())
          + f"; {gxx}", flush=True)
    print(f"[host libs] native decoder "
          + (f"built in {t_build:.1f} s" if built
             else f"not built ({native.build_error()})")
          + f"; route: the zips decode with {route}", flush=True)
    check(route != "none", "neither Pillow nor the native decoder: no zip "
          "can be made or decoded on this machine")
    return {"pillow": pil, **{k: v for k, v in have.items() if k != "PIL"},
            "headers": headers, "gxx": gxx, "native_decoder": built,
            "route": route}


def phase_data_feed(tmp):
    """[data feed]: the seeded NYU zip through the port's loaders. The decode
    rate (a dataset without a cache, every batch decoded); the train split as
    ``get_dataloader`` feeds the command lines (raw uint8, decode-once
    cache) in host batches, and the same batches pinned and copied to the
    card one batch ahead; every device batch held equal to its host batch
    over 3 epochs."""
    from tpudepth_torch.data import get_dataloader, make_synthetic_zip
    from tpudepth_torch.data.nyu import (
        DataLoader,
        NYUDepthDataset,
        load_zip_to_mem,
    )

    t0 = time.perf_counter()
    path = make_synthetic_zip(f"{tmp}/nyu_synthetic_480x640.zip",
                              n_train=FEED_TRAIN, n_test=FEED_TEST,
                              image_hw=TRAIN_HW, seed=0)
    t_zip = time.perf_counter() - t0
    data, train_pairs, _ = load_zip_to_mem(path)
    uncached = NYUDepthDataset(data, train_pairs, raw=True)
    t0 = time.perf_counter()
    n = sum(b["image"].shape[0]
            for b in DataLoader(uncached, TRAIN_BATCH, shuffle=True))
    decode_ips = n / (time.perf_counter() - t0)
    decoder = uncached.decoder()

    host = get_dataloader("nyu", path, "train", batch_size=TRAIN_BATCH,
                          resolution="full")
    ds = host.dataset
    deadline = time.perf_counter() + 120
    while (not all(ds._has_cached(i) for i in range(len(ds)))
           and time.perf_counter() < deadline):
        time.sleep(0.05)
    check(ds.raw and all(ds._has_cached(i) for i in range(len(ds))),
          "the train split's decode-once cache did not fill")
    device = DataLoader(ds, TRAIN_BATCH, shuffle=True, device=DEVICE)
    host_s, device_s, compared = 0.0, 0.0, 0
    for epoch in range(FEED_EPOCHS):
        host.set_epoch(epoch)
        device.set_epoch(epoch)
        t0 = time.perf_counter()
        want = list(host)
        host_s += time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = list(device)
        torch.cuda.synchronize()
        device_s += time.perf_counter() - t0
        check(len(got) == len(want) == FEED_TRAIN // TRAIN_BATCH,
              f"epoch {epoch}: {len(got)} device and {len(want)} host batches")
        for g, w in zip(got, want):
            for k in ("image", "depth"):
                check(g[k].is_cuda and g[k].dtype == torch.uint8
                      and torch.equal(g[k].cpu(), torch.from_numpy(w[k])),
                      f"epoch {epoch}: a device {k} batch differs from its "
                      "host batch")
                compared += 1
    images = FEED_EPOCHS * len(host) * TRAIN_BATCH
    out = {"zip_s": t_zip, "decoder": decoder, "decode_img_per_s": decode_ips,
           "cached_decoder": ds.decoder(),
           "host_img_per_s": images / host_s,
           "device_img_per_s": images / device_s,
           "batches_compared": compared // 2}
    print(f"[data feed] zip of {FEED_TRAIN} + {FEED_TEST} pairs at "
          f"{TRAIN_HW[0]}x{TRAIN_HW[1]} made in {t_zip:.2f} s; decoder "
          f"{decoder}: {decode_ips:.1f} img/s decoding every batch (raw "
          f"uint8, B{TRAIN_BATCH}, host clock); train split from its cache "
          f"(filled by {ds.decoder()}): host batches {out['host_img_per_s']:.1f}"
          f" img/s, pinned and on the card {out['device_img_per_s']:.1f} "
          f"img/s ({FEED_EPOCHS} epochs, synchronized); "
          f"{out['batches_compared']} device batches equal to their host "
          "batches", flush=True)
    return path, out


def _finite_results_txt(path):
    with open(path) as f:
        header, values = f.read().split("\n")
    check(header == "RMSE,MAE,REL, RMSE_log,Lg10,Delta1,Delta2,Delta3",
          f"{path}: header {header!r}")
    vals = [float(v) for v in values.split(",")]
    check(len(vals) == 8 and np.all(np.isfinite(vals)), f"{path}: {values}")
    return vals


def _start_checkpoint(path):
    """A GuideDepth-schema checkpoint to start ``--load_checkpoint`` from:
    the seeded model with its output bias at ``OUTPUT_BIAS``, as [train]
    starts its models (a model's raw output of exactly 0 scores as 0 m and
    makes the logarithmic metrics infinite), a fresh Adam, epoch 0."""
    from tpudepth_torch.core.config import TrainConfig
    from tpudepth_torch.models.registry import build_model
    from tpudepth_torch.train.checkpoint import save_checkpoint
    from tpudepth_torch.train.trainer import make_optimizer

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model("GuideDepth")
    with torch.no_grad():
        model.up_3.reduce.bias.fill_(OUTPUT_BIAS)
    optimizer = make_optimizer(TrainConfig(), model.parameters())
    return save_checkpoint(path, {"epoch": 0, "val_losses": [],
                                  "model": model.state_dict(),
                                  "optimizer": optimizer.state_dict()})


def phase_cli_guidedepth(tmp, path, in_memory):
    """[cli guidedepth]: ``guidedepth_main.main`` in this process, ``--train
    --eval`` on the zip at 480x640 B8, 2 epochs x 3 steps from
    :func:`_start_checkpoint` (``--load_checkpoint``), GUB stages plain and
    fused: the checkpoints, ``best_model`` and ``results.txt`` on disk,
    finite metrics, every kernel's launches over the run, and the train
    img/s of the second epoch (the first pays the model's warm-up) beside
    the [train] phase's on in-memory batches."""
    from tpudepth_torch.cli import guidedepth_main

    start = _start_checkpoint(f"{tmp}/cli_start/checkpoint")
    out = {}
    for gub in ("plain", "fused"):
        ck, res = f"{tmp}/cli_{gub}/checkpoints", f"{tmp}/cli_{gub}/results"
        argv = ["--train", "--eval", "--data_path", path, "--dataset", "nyu",
                "--resolution", "full", "--batch_size", str(TRAIN_BATCH),
                "--num_epochs", "2", "--steps-per-epoch", "3",
                "--load_checkpoint", start, "--save_checkpoint", ck,
                "--save_results", res, "--gub", gub, "--device", "cuda"]
        result, seconds, counts = run_counted(lambda: guidedepth_main.main(argv))
        check(sorted(os.listdir(ck)) == ["checkpoint_0", "checkpoint_1"],
              f"{ck}: {sorted(os.listdir(ck))}")
        check(os.path.isfile(f"{res}/best_model"), "best_model not exported")
        values = _finite_results_txt(f"{res}/results.txt")
        m = result["metrics"]
        check(np.all(np.isfinite([m.rmse, m.mae, m.absrel, m.lg10, m.delta1,
                                  m.rmse_log])), "metrics not finite")
        check(np.all(np.isfinite(result["val_losses"]))
              and len(result["val_losses"]) == 2, "validation losses")
        want = {"fused_loss_fwd": CLI_STEPS + CLI_VAL_BATCHES,
                "fused_loss_bwd": CLI_STEPS}
        if gub == "fused":
            want.update(gub_conv_fwd=FUSED_FWD_PER_PASS * (
                CLI_STEPS + CLI_VAL_BATCHES + CLI_EVAL_FORWARDS),
                gub_conv_dw=FUSED_DW_PER_STEP * CLI_STEPS,
                gub_conv_dx=FUSED_DX_PER_STEP * CLI_STEPS)
        check(counts == want, f"cli guidedepth {gub}: launches {counts}, "
              f"expected {want}")
        ep = result["epoch_times"][1]
        ips = ep["images"] / ep["seconds"]
        out[gub] = {"launches": counts, "seconds": seconds,
                    "train_img_per_s": ips,
                    "first_epoch_s": result["epoch_times"][0]["seconds"],
                    "in_memory_img_per_s": in_memory[gub],
                    "results": values}
        print(f"[cli guidedepth {gub}] train + eval in {seconds:.2f} s; "
              f"launches {counts}; train {ips:.1f} img/s (epoch 1: "
              f"{ep['images']} images in {ep['seconds']:.3f} s, host clock, "
              f"the feed included) beside {in_memory[gub]:.1f} img/s on "
              f"in-memory batches ([train {gub}]); epoch 0 "
              f"{out[gub]['first_epoch_s']:.2f} s; results.txt {values}",
              flush=True)
    return out


def phase_cli_train(tmp, path, in_memory):
    """[cli train]: the root command line in this process on NewCRF, B8,
    1 epoch x 3 steps, from a working directory of its own (it writes
    ``./checkpoints/global_checkpoint`` and ``runs/``): the checkpoint, the
    logged losses, every kernel's launches, and the epoch's img/s."""
    import importlib.util

    from tpudepth_torch.cli import train as cli_train

    work = f"{tmp}/cli_train"
    os.makedirs(work)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        argv = ["--model", "newcrf", "--bs", str(SAM_BATCH), "--epochs", "1",
                "--steps-per-epoch", "3", "--data", path, "--log-dir", "runs",
                "--device", "cuda"]
        result, seconds, counts = run_counted(lambda: cli_train.main(argv))
    finally:
        os.chdir(cwd)
    ckpt = f"{work}/checkpoints/global_checkpoint"
    check(result["checkpoint"] == ckpt and os.path.isfile(ckpt),
          f"no rolling checkpoint at {ckpt}")
    check(len(result["losses"]) == 1 and np.all(np.isfinite(result["losses"])),
          f"logged losses {result['losses']}")
    tb = importlib.util.find_spec("tensorboard") is not None
    grids = tb and importlib.util.find_spec("matplotlib") is not None
    events = [f for _, _, fs in os.walk(f"{work}/runs") for f in fs
              if f.startswith("events.out.tfevents")]
    check(bool(events) == tb, f"TensorBoard event files {events}")
    want = {**{k: 3 * 8 for k in TRAIN_KERNELS},
            "fused_root_loss_fwd": 3, "fused_root_loss_bwd": 3}
    if grids:  # the image grids' forwards at step 0 and at the epoch's end
        want["crf_rowblock_infer"] = 2 * 8
    check(counts == want, f"cli train: launches {counts}, expected {want}")
    ep = result["epoch_times"][0]
    ips = ep["images"] / ep["seconds"]
    print(f"[cli train] newcrf B{SAM_BATCH} 1 epoch x 3 steps in "
          f"{seconds:.2f} s; launches {counts}; train {ips:.1f} img/s (epoch "
          f"0 with the new model's first step, host clock) beside "
          f"{in_memory:.1f} img/s on in-memory batches ([newcrf train]); "
          f"TensorBoard {'events ' + str(len(events)) if tb else 'missing'}, "
          f"image grids {'logged' if grids else 'off (no matplotlib)'}",
          flush=True)
    return ckpt, {"launches": counts, "seconds": seconds,
                  "train_img_per_s": ips, "in_memory_img_per_s": in_memory,
                  "tensorboard_events": len(events), "image_grids": grids}


def phase_cli_test(path, ckpt):
    """[cli test]: the root evaluation command line on [cli train]'s
    checkpoint: finite metrics, ``crf_rowblock_infer`` 8 a batch."""
    from tpudepth_torch.cli import test as cli_test

    argv = ["--bs", str(SAM_BATCH), "--pt", ckpt, "--data", path, "--model",
            "newcrf", "--device", "cuda"]
    metrics, seconds, counts = run_counted(lambda: cli_test.main(argv))
    check(len(metrics) == 9 and np.all(np.isfinite(list(metrics.values()))),
          f"metrics {metrics}")
    want = {"crf_rowblock_infer": 8 * (FEED_TEST // SAM_BATCH)}
    check(counts == want, f"cli test: launches {counts}, expected {want}")
    print(f"[cli test] newcrf on the rolling checkpoint, {FEED_TEST} test "
          f"images at B{SAM_BATCH} in {seconds:.2f} s; launches {counts}; "
          + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items()), flush=True)
    return {"launches": counts, "seconds": seconds, "metrics": metrics}


def phase_cli_inference(tmp, path):
    """[cli inference]: ``tpudepth_torch.inference --eval`` on the model that
    [cli guidedepth] trained with fused GUB stages, at 480x640 bs 1: both
    speedtests (short), the bf16 engine through ``AlhashimEvaluator`` over
    the test split, the two report files, ``gub_conv_fwd`` 9 a forward."""
    from tpudepth_torch import inference

    res = f"{tmp}/cli_inference"
    argv = ["--eval", "--data_path", path, "--dataset", "nyu", "--resolution",
            "full", "--gub", "fused", "--weights_path",
            f"{tmp}/cli_fused/results/best_model", "--num_test_runs",
            str(CLI_RUNS), "--warm_up_runs", str(CLI_WARMUP),
            "--save_results", res, "--device", "cuda"]
    result, seconds, counts = run_counted(lambda: inference.main(argv))
    _finite_results_txt(f"{res}/results.txt")
    m = result["metrics"]
    with open(f"{res}/inference_results.txt") as f:
        lines = f.read().splitlines()
    check(lines[0] == "backend,s/frame,FPS,img/s,RMSE,Delta1"
          and lines[1].startswith("torch_f32,")
          and lines[2].startswith("engine_bf16,")
          and lines[2].endswith(f",{m.rmse:.3f},{m.delta1:.3f}")
          and np.all(np.isfinite([float(v) for v in lines[2].split(",")[1:]])),
          f"inference_results.txt {lines}")
    want = {"gub_conv_fwd": FUSED_FWD_PER_PASS * (
        2 * (CLI_WARMUP + CLI_RUNS) + CLI_EVAL_FORWARDS)}
    check(counts == want, f"cli inference: launches {counts}, expected {want}")
    ms = {k: result[k]["seconds_per_frame"] * 1e3 for k in ("f32", "bf16")}
    print(f"[cli inference] GuideDepth fused bs 1 in {seconds:.2f} s; f32 "
          f"{ms['f32']:.3f} ms/frame, bf16 engine {ms['bf16']:.3f} ms/frame "
          f"({CLI_RUNS} runs between CUDA events); eval RMSE {m.rmse:.3f} "
          f"Delta1 {m.delta1:.3f}; launches {counts}", flush=True)
    return {"launches": counts, "seconds": seconds, "ms_per_frame": ms,
            "rmse": m.rmse, "delta1": m.delta1}


# [weights jax]: optimizer steps before the conversion, one epoch of them
WEIGHTS_STEPS = 2
# after the restore, the source and restored trainers' next step may differ
# by at most this many times the spread of two repeats of that step from
# identical copies (the GUB statistics' f64 atomics and cuDNN's backward
# are not bit-repeatable; a restore that lost anything would differ by far
# more than the repeats)
WEIGHTS_SPREAD_FACTOR = 4.0
# the loss is one number: two repeats can agree by chance, so the loss
# also passes within this share of itself (f32 rounding of its sum; a
# restore that lost a parameter or a statistic moves it by far more)
WEIGHTS_LOSS_FLOOR = 1e-6


def _jax_tree(name, trainer, epoch, extra):
    """The tree ``orbax_io.read_orbax`` gives for the JAX trainer's
    checkpoint of ``trainer``'s state, built from the port's state with the
    bridge tables' inverse (this machine has no JAX and writes no orbax
    file)."""
    from tpudepth_torch.models.jax_weights import flax_from_torch
    from tpudepth_torch.train.jax_state import optax_state_from_torch

    tree = flax_from_torch(name, trainer.model.state_dict())
    tree["opt_state"] = optax_state_from_torch(
        name, trainer.state.optimizer.state_dict(), trainer.model,
        trainer.freeze_encoder)
    tree.update(epoch=epoch, **extra)
    return tree


def _same_state(label, a, b):
    """Model (parameters, BatchNorm statistics; not ``num_batches_tracked``,
    which JAX does not keep) and Adam state of two trainers bit-equal."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    check(set(sa) == set(sb), f"{label}: state_dict keys differ")
    for k, v in sa.items():
        if not k.endswith("num_batches_tracked"):
            check(torch.equal(v, sb[k]), f"{label}: {k} differs")
    oa = a.state.optimizer.state_dict()
    ob = b.state.optimizer.state_dict()
    check(set(oa["state"]) == set(ob["state"]) and len(oa["state"]) > 50,
          f"{label}: optimizer state keys")
    for i, st in oa["state"].items():
        for field in ("exp_avg", "exp_avg_sq", "step"):
            check(torch.equal(torch.as_tensor(st[field]).cpu(),
                              torch.as_tensor(ob["state"][i][field]).cpu()),
                  f"{label}: optimizer state {i}.{field} differs")
    check([g["lr"] for g in oa["param_groups"]]
          == [g["lr"] for g in ob["param_groups"]], f"{label}: learning rate")


def _max_diff(a, b):
    """Largest parameter difference of two models, and of their losses."""
    pb = dict(b.named_parameters())
    return max(float((p.detach().float() - pb[n].detach().float()).abs().max())
               for n, p in a.named_parameters())


def weights_jax_case(name, gub, seed):
    """[weights jax] for one model: a port trainer after ``WEIGHTS_STEPS``
    steps at 480x640 B 8 bf16, its JAX checkpoint tree, converted by
    ``trainer_checkpoint_from_jax`` and restored into two fresh trainers
    built from another seed: model and Adam state bit-equal to the source;
    then one more step in each, the source against a restored trainer
    within ``WEIGHTS_SPREAD_FACTOR`` times the two restored trainers'
    spread. The kernels' launches are counted over the three steps."""
    from tpudepth_torch.core.config import TrainConfig
    from tpudepth_torch.models.registry import build_model
    from tpudepth_torch.train.jax_state import trainer_checkpoint_from_jax
    from tpudepth_torch.train.trainer import ENCODER_PREFIX, Trainer

    cfg = TrainConfig(model=name, dataset="nyu_reduced", resolution="full",
                      batch_size=TRAIN_BATCH, compute_dtype="bfloat16",
                      log_every=1, seed=0, scheduler_step_size=1)
    loader = SyntheticLoader(WEIGHTS_STEPS, seed=seed, raw_depth=True)
    options = {"gub": gub} if gub else {}

    def trainer_for(model_seed):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(model_seed)
            model = build_model(name, **options)
        tr = Trainer(cfg, model=model, device=DEVICE, train_loader=loader)
        tr.init_state()
        return tr

    src = trainer_for(seed)
    for batch in loader:
        src.train_step(batch)
    torch.cuda.synchronize()
    root = src.recipe.kind == "root"
    # GuideDepth: checkpoint_0 holds the epoch to resume at; root: the
    # rolling checkpoint holds the completed epoch
    extra = ({"loss": 0.5} if root else {"val_losses": [0.25]})
    tree = _jax_tree(name, src, 0 if root else 1, extra)
    t0 = time.perf_counter()
    restored = []
    for k in range(2):
        tr = trainer_for(seed + 1 + k)
        payload = trainer_checkpoint_from_jax(name, tree, tr.model,
                                              tr.freeze_encoder)
        tr.restore_payload(payload)
        if root:
            tr.set_resume_epoch(tr.epoch + 1)
        check(tr.state.step == src.state.step == WEIGHTS_STEPS,
              f"{name}: restored step {tr.state.step}")
        _same_state(f"[weights jax] {name} restored {k}", src, tr)
        restored.append(tr)
    t_convert = (time.perf_counter() - t0) / 2
    encoder = {n: p.detach().clone()
               for n, p in restored[0].model.named_parameters()
               if n.startswith(ENCODER_PREFIX)}
    batch = loader.batches[0]

    def steps():
        return [float(tr.train_step(batch)) for tr in (src, *restored)]

    losses, seconds, launches = run_counted(steps)
    spread = _max_diff(restored[0].model, restored[1].model)
    diff = _max_diff(src.model, restored[0].model)
    loss_spread = abs(losses[1] - losses[2])
    loss_diff = abs(losses[0] - losses[1])
    print(f"[weights jax] {name}{' ' + gub if gub else ''}: {WEIGHTS_STEPS} "
          f"steps at {TRAIN_HW[0]}x{TRAIN_HW[1]} B{TRAIN_BATCH} bf16, the JAX "
          f"tree converted and restored in {t_convert:.2f} s a trainer: model, "
          "statistics, Adam moments, steps and learning rate bit-equal; the "
          f"next step: losses {losses}, source vs restored max |dp| "
          f"{diff:.3e} (loss {loss_diff:.3e}), the two restored copies' "
          f"spread {spread:.3e} (loss {loss_spread:.3e}); launches over the "
          f"3 steps {launches}", flush=True)
    check(all(np.isfinite(losses)), f"{name}: non-finite loss {losses}")
    check(diff <= WEIGHTS_SPREAD_FACTOR * spread
          and loss_diff <= max(WEIGHTS_SPREAD_FACTOR * loss_spread,
                               WEIGHTS_LOSS_FLOOR * abs(losses[0])),
          f"{name}: the restored trainer's step differs by {diff:.3e} "
          f"(loss {loss_diff:.3e}), beyond {WEIGHTS_SPREAD_FACTOR}x the "
          f"repeats' spread {spread:.3e} ({loss_spread:.3e})")
    if encoder:
        after = dict(restored[0].model.named_parameters())
        check(all(torch.equal(v, after[n]) for n, v in encoder.items()),
              f"{name}: the frozen encoder moved")
    return {"steps_before": WEIGHTS_STEPS, "losses": losses,
            "param_diff": diff, "param_spread": spread,
            "loss_diff": loss_diff, "loss_spread": loss_spread,
            "convert_restore_s": t_convert, "step_s": seconds,
            "frozen_encoder_params": len(encoder),
            "launches": launches,
            "launches_per_step": {k: v // 3 for k, v in launches.items()}}


def phase_weights_jax():
    """[weights jax]: GuideDepth with fused GUB stages (``optax.adam``'s
    layout) and SAM with its encoder frozen (``optax.multi_transform``'s)
    resumed from the JAX trainer's checkpoint tree."""
    t0 = time.perf_counter()
    out = {"GuideDepth fused": weights_jax_case("GuideDepth", "fused", 500),
           "sam": weights_jax_case("sam", None, 510)}
    gd, sam = out["GuideDepth fused"], out["sam"]
    check(gd["launches_per_step"] == {
        "gub_conv_fwd": FUSED_FWD_PER_PASS, "gub_conv_dw": FUSED_DW_PER_STEP,
        "gub_conv_dx": FUSED_DX_PER_STEP, "fused_loss_fwd": 1,
        "fused_loss_bwd": 1}, f"GuideDepth launches {gd['launches']}")
    check(sam["launches_per_step"] == {
        **{k: 4 for k in TRAIN_KERNELS}, "fused_root_loss_fwd": 1,
        "fused_root_loss_bwd": 1}, f"sam launches {sam['launches']}")
    check(sam["frozen_encoder_params"] > 100, "SAM's encoder not frozen")
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_weights_torch(tmp):
    """[weights torch]: a seeded GuideDepth (fused) saved as a GuideDepth
    release (``model``, ``src/GuideDepth/training.py:166-178``), as the
    root ``global_checkpoint`` (``model_state_dict``, ``src/train.py:
    147-153``) and as the DDRNet-23-slim ImageNet checkpoint (its backbone
    and the classifier head), and a seeded SAM's encoder as torchvision's
    ``features.*``; each loaded into a fresh model from another seed
    (the backbone-only files beside the source's other weights) and served
    one bs-1 bf16 frame, bit-equal to the source model's frame."""
    from tpudepth_torch.infer.engine import InferenceEngine
    from tpudepth_torch.models import torch_import
    from tpudepth_torch.models.layers import init_random_
    from tpudepth_torch.models.registry import build_model
    from tpudepth_torch.train.checkpoint import load_model_weights

    t0 = time.perf_counter()
    shape = (1, 3, 480, 640)
    image = np.random.default_rng(520).random(shape, dtype=np.float32)

    def serve(model):
        eng = InferenceEngine(model, shape, compute_dtype=torch.bfloat16,
                              device=DEVICE)
        (frame,), _, counts = run_counted(lambda: [eng(image)])
        return frame, counts

    def seeded(name, seed, **kw):
        return init_random_(build_model(name, **kw), seed=seed)

    cases = {}
    for name, kw, prefix, backbone in (
            ("GuideDepth", {"gub": "fused"}, "feature_extractor.", "ddrnet"),
            ("sam", {}, "Unet.0.original_model.features.", "mobilenetv3")):
        src = seeded(name, 521, **kw)
        sd = {k: v.detach().cpu() for k, v in src.state_dict().items()}
        want, counts = serve(src)
        files = {}
        if name == "GuideDepth":
            files["guidedepth release"] = {
                "epoch": 20, "val_losses": [0.5], "model": sd,
                "optimizer": {}, "lr_scheduler": {}}
            files["root global_checkpoint"] = {
                "epoch": 3, "model_state_dict": sd, "loss": 0.5,
                "optimizer_state_dict": {"state": {}, "param_groups": []}}
            head = {"down5.0.weight": torch.randn(256, 64, 3, 3),
                    "last_layer.0.weight": torch.randn(1024, 512, 1, 1),
                    "linear.weight": torch.randn(1000, 1024),
                    "linear.bias": torch.randn(1000)}
            files["ddrnet imagenet"] = {"state_dict": {
                **{k[len(prefix):]: v for k, v in sd.items()
                   if k.startswith(prefix)}, **head}}
        else:
            files["torchvision features"] = {
                **{"features." + k[len(prefix):]: v for k, v in sd.items()
                   if k.startswith(prefix)},
                "classifier.0.weight": torch.randn(1280, 960)}
        for label, payload in files.items():
            path = f"{tmp}/{label.replace(' ', '_')}.pth"
            torch.save(payload, path)
            fresh = seeded(name, 522, **kw)
            if label in ("ddrnet imagenet", "torchvision features"):
                # the source's other weights, then the backbone from the file
                fresh.load_state_dict({k: v for k, v in sd.items()
                                       if not k.startswith(prefix)},
                                      strict=False)
                before = serve(fresh)[0]
                check(not torch.equal(before, want),
                      f"{label}: the fresh model already serves the frame")
                loaded = torch.load(path, weights_only=True)
                if backbone == "ddrnet":
                    torch_import.load_ddrnet_imagenet(fresh, loaded)
                else:
                    torch_import.load_mobilenetv3_features(fresh, loaded)
            else:
                load_model_weights(fresh, path)
            got, got_counts = serve(fresh)
            check(torch.equal(got, want), f"[weights torch] {label}: the "
                  "served frame differs from the source model's")
            check(got_counts == counts, f"{label}: launches {got_counts}")
            cases[f"{name} {label}"] = {"bit_equal": True,
                                        "launches_per_frame": got_counts}
            print(f"[weights torch] {name} from a {label} .pth: the bs-1 "
                  f"bf16 frame bit-equal to the source model's; launches a "
                  f"frame {got_counts}", flush=True)
    return {"cases": cases, "seconds": time.perf_counter() - t0}


STAGE_CHAIN_TURNS = 2   # one by one, chained, chained, one by one


@contextlib.contextmanager
def newcrf_blocks_one_by_one(model):
    """Every NewCRF stage of ``model`` runs its blocks one by one through
    ``CRFBlock.forward`` (each padding and cropping its own maps) instead
    of the row mode's padded chain (``tests/torch_port_helpers.py`` has the
    same)."""
    from tpudepth_torch.models.newcrf import CRFLayer

    layers = [m for m in model.modules() if isinstance(m, CRFLayer)]

    def one_by_one(layer):
        def forward(x, v):
            for blk in layer.blocks:
                x = blk(x, v)
            return x
        return forward

    for layer in layers:
        layer.forward = one_by_one(layer)
    try:
        yield
    finally:
        for layer in layers:
            del layer.forward


def phase_stage_chain():
    """[stage chain]: NewCRF ``row`` at 480x640 bf16, bs 1 and 8, its
    stages chained on the padded layout (the model as served) against its
    blocks run one by one: outputs bit-equal, every chained block's whole
    padded output finite, the launches a forward, and the device time of a
    call (CUDA graph replays) in turns."""
    from tpudepth_torch.models.layers import init_random_
    from tpudepth_torch.models.newcrf import CRFBlock
    from tpudepth_torch.models.registry import build_model

    t0 = time.perf_counter()
    model = init_random_(build_model("newcrf", attn="row"), seed=530).to(
        DEVICE, memory_format=torch.channels_last).eval()
    blocks = [m for m in model.modules() if isinstance(m, CRFBlock)]

    def forward(one_by_one):
        if not one_by_one:
            return model(x)
        with newcrf_blocks_one_by_one(model):
            return model(x)

    out = {}
    for bsz in (1, 8):
        x = torch.from_numpy(np.random.default_rng(531 + bsz).random(
            (bsz, 3, 480, 640), dtype=np.float32)).to(
            DEVICE, torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        seen = []

        def recording(blk):
            rowblock = blk.rowblock

            def call(xp, vp, h, w):
                y = rowblock(xp, vp, h, w)
                seen.append((tuple(xp.shape), bool(torch.isfinite(y).all())))
                return y
            return call

        for blk in blocks:
            blk.rowblock = recording(blk)
        with torch.no_grad():
            (y_on,), _, on_counts = run_counted(lambda: [forward(False)])
        for blk in blocks:
            del blk.rowblock
        with torch.no_grad():
            (y_off,), _, off_counts = run_counted(lambda: [forward(True)])
        check(torch.equal(y_on, y_off),
              f"bs{bsz}: the chained NewCRF differs from its blocks one by "
              "one")
        check(len(seen) == 8 and all(f for _, f in seen),
              f"bs{bsz}: chained block outputs {seen}")
        check(all(s[1] % 7 == 0 and s[2] % 7 == 0 for s, _ in seen),
              f"bs{bsz}: the chained blocks did not take padded maps {seen}")
        check(on_counts == off_counts == {"crf_rowblock_infer": 8},
              f"bs{bsz}: launches {on_counts} / {off_counts}")
        times = {False: [], True: []}
        with torch.no_grad():
            for one_by_one in (True, False, False, True) * STAGE_CHAIN_TURNS:
                times[one_by_one].append(time_ms(
                    lambda: forward(one_by_one), per_graph=3, replays=10))
        r = {"bit_equal": True, "chained_block_maps": sorted({s for s, _ in
                                                              seen}),
             "launches_per_forward": on_counts,
             "one_by_one_ms": statistics.mean(times[True]),
             "chained_ms": statistics.mean(times[False]),
             "one_by_one_ms_turns": times[True],
             "chained_ms_turns": times[False]}
        out[f"bs{bsz}"] = r
        print(f"[stage chain] NewCRF row 480x640 bf16 bs{bsz}: chained "
              f"output bit-equal to the blocks one by one, the 8 chained "
              f"blocks' padded outputs finite, crf_rowblock_infer 8 a "
              f"forward either way; device ms a call (graph replays, "
              f"{2 * STAGE_CHAIN_TURNS} turns each) one by one "
              f"{r['one_by_one_ms']:.3f}, chained {r['chained_ms']:.3f} "
              f"(one by one {[round(t, 3) for t in times[True]]}, chained "
              f"{[round(t, 3) for t in times[False]]})", flush=True)
    out["seconds"] = time.perf_counter() - t0
    return out


# [data parallel]: the port's data axis on the card. (a) a world of one
# under NCCL: fused GuideDepth 480x640 bf16, global B 8, DP_STEPS steps
# through ``initialize`` and the ``Trainer``, the kernels' launches counted
# over exactly those steps; (b) DP_RANKS gloo ranks on the one card (NCCL
# refuses two ranks on one device), DP_PER_RANK images a rank, f32,
# DP_STEPS_GLOO fused steps, against one process on the union batch.
DP_STEPS = 3
DP_RANKS, DP_PER_RANK, DP_STEPS_GLOO = 2, 4, 2
# a child that has not finished by then fails the phase
DP_JOIN_TIMEOUT = 300
# the two-rank steps may differ from one process's by at most this many
# times the spread of two repeats of the single-process steps (the GUB
# statistics' atomics and cuDNN's backward are not bit-repeatable). Two
# repeats may also agree bit for bit while the ranks sum in another order,
# so each kind then passes within what the smoke holds two f32 steps that
# round differently to (fused against plain GUB stages, FUSED_STEP_*). The
# kinds: the loss; the parameters' change from the initial weights, as one
# vector, relative to one process's (the direction of the update); the
# Adam first moments (0.1 g + 0.09 g'), the only check that sees the
# gradients' scale, since Adam's normalized update hides a gradient off by
# a constant factor; the running statistics within DP_STATS_REL of each
# tensor's largest
DP_SPREAD_FACTOR = 4.0
DP_STATS_REL = 1e-3
# warm steps timed between CUDA events, with and without the group
DP_TIMED_STEPS = 12


def _dp_model():
    """Fused GuideDepth from seed 0, its output bias at ``OUTPUT_BIAS``."""
    from tpudepth_torch.models.registry import build_model

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model("GuideDepth", gub="fused")
    with torch.no_grad():
        model.up_3.reduce.bias.fill_(OUTPUT_BIAS)
    return model


def _dp_config(dtype: str, batch: int):
    from tpudepth_torch.core.config import TrainConfig

    return TrainConfig(model="GuideDepth", dataset="nyu_reduced",
                       resolution="full", batch_size=batch,
                       compute_dtype=dtype, log_every=1, seed=0)


def _dp_gloo_run(loader, rows=None):
    """``DP_STEPS_GLOO`` f32 steps of a fresh ``Trainer`` (on this process's
    rows of each global batch when ``rows`` is given); the losses, and the
    model's state and Adam first moments (``name:exp_avg``) on the host."""
    from tpudepth_torch.train.trainer import Trainer

    tr = Trainer(_dp_config("float32", DP_RANKS * DP_PER_RANK),
                 model=_dp_model(), device=DEVICE, train_loader=loader)
    tr.init_state()
    losses = []
    for batch in loader.batches[:DP_STEPS_GLOO]:
        if rows is not None:
            batch = {k: v[rows] for k, v in batch.items()}
        losses.append(float(tr.train_step(batch)))
    state = {k: v.detach().cpu() for k, v in tr.model.state_dict().items()
             if v.is_floating_point()}
    opt = tr.state.optimizer.state
    for n, p in tr.model.named_parameters():
        state[f"{n}:exp_avg"] = opt[p]["exp_avg"].cpu()
    return losses, state


def dp_gloo_worker(rank: int, workdir: str) -> int:
    """One of the DP_RANKS gloo ranks of [data parallel] (b), run as
    ``python chip_smoke.py --dp-rank RANK WORKDIR``: its rows of the
    phase's batches; writes its losses and state to WORKDIR."""
    from tpudepth_torch.parallel import initialize
    from tpudepth_torch.parallel.launch import shutdown

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize(f"file://{workdir}/rdzv", DP_RANKS, rank, backend="gloo",
               device="cuda")
    loader = SyntheticLoader(DP_STEPS_GLOO, seed=310, raw_depth=True)
    rows = slice(rank * DP_PER_RANK, (rank + 1) * DP_PER_RANK)
    (losses, state), seconds, launches = run_counted(
        lambda: _dp_gloo_run(loader, rows))
    torch.save({"losses": losses, "state": state, "seconds": seconds,
                "launches": launches}, f"{workdir}/rank{rank}.pt")
    shutdown()
    return 0


def _collective_host(fn, runs: int = 2):
    """All-reduces a call of ``fn`` and the host time in them (the
    profiler's CPU total of ``c10d::allreduce_``)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.key == "c10d::allreduce_"]
    return {"calls": sum(e.count for e in ev) // runs,
            "host_ms": sum(e.cpu_time_total for e in ev) / runs / 1e3}


def _state_diff(a, b, keys=None):
    return max(float((a[k] - b[k]).abs().max()) for k in (keys or a))


def _dp_kind(key: str) -> str:
    if key.endswith(":exp_avg"):
        return "exp_avg"
    return "stats" if key.endswith(("running_mean", "running_var")) \
        else "params"


def phase_data_parallel(tmp):
    """[data parallel]: (a) a world of one under NCCL, its launches exact
    and its f32 step against the step without a group; (b) two gloo ranks
    on the card against one process on the union batch."""
    import torch.distributed as dist

    from tpudepth_torch.parallel import host_shard_info, initialize
    from tpudepth_torch.parallel.launch import shutdown
    from tpudepth_torch.train.trainer import (
        Trainer,
        TrainState,
        make_optimizer,
        make_train_step,
        step_lr,
    )

    t_phase = time.perf_counter()
    out = {}
    # (a) NCCL, world 1
    check(initialize() == (0, 1) and not dist.is_initialized(),
          "initialize() without a launcher is not a no-op")
    loader = SyntheticLoader(DP_STEPS, seed=300, raw_depth=True)
    # the same trainer without a group, built before the group exists, for
    # the step time beside the group's
    solo = Trainer(_dp_config("bfloat16", TRAIN_BATCH), model=_dp_model(),
                   train_loader=loader)
    check(not solo.mesh.collective, f"the trainer's data axis {solo.mesh}")
    solo.init_state()
    initialize(f"file://{tmp}/dp_nccl", num_processes=1, process_id=0,
               backend="nccl")
    try:
        check(host_shard_info() == (0, 1) and dist.get_backend() == "nccl",
              "the world-1 NCCL group")
        tr = Trainer(_dp_config("bfloat16", TRAIN_BATCH), model=_dp_model(),
                     train_loader=loader)
        check(tr.mesh.collective and tr.mesh.world == 1
              and tr.device == torch.device("cuda", 0),
              f"the trainer's data axis {tr.mesh}")
        tr.init_state()

        def steps():
            losses, ms = [], []
            for batch in loader.batches:
                t0 = time.perf_counter()
                losses.append(float(tr.train_step(batch)))
                ms.append((time.perf_counter() - t0) * 1e3)
            return losses, ms

        (losses, step_ms), seconds, launches = run_counted(steps)
        want = {"gub_conv_fwd": FUSED_FWD_PER_PASS * DP_STEPS,
                "gub_conv_dw": FUSED_DW_PER_STEP * DP_STEPS,
                "gub_conv_dx": FUSED_DX_PER_STEP * DP_STEPS,
                "fused_loss_fwd": DP_STEPS, "fused_loss_bwd": DP_STEPS}
        print(f"[data parallel] NCCL world 1: fused GuideDepth "
              f"{TRAIN_HW[0]}x{TRAIN_HW[1]} global B{TRAIN_BATCH} bf16, "
              f"{DP_STEPS} Trainer steps in {seconds:.2f} s, ms a step "
              f"(host, synchronized; the first builds and warms) "
              f"{[round(x, 2) for x in step_ms]}; losses "
              f"{[round(x, 4) for x in losses]}; launches {launches}",
              flush=True)
        check(all(np.isfinite(losses)), f"non-finite losses {losses}")
        check(launches == want, f"launches {launches}, expected {want}")

        # step time as Trainer.train_step runs it (host batch in, augment
        # on), warm, between CUDA events, in turns group-none-none-group:
        # what the world-1 group's collectives cost
        def timed(t):
            for b in loader.batches:
                t.train_step(b)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(DP_TIMED_STEPS):
                t.train_step(loader.batches[i % len(loader.batches)])
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / DP_TIMED_STEPS

        times = {"group": [], "none": []}
        for label, t in (("group", tr), ("none", solo), ("none", solo),
                         ("group", tr)):
            times[label].append(timed(t))
        group_ms, none_ms = (statistics.mean(times["group"]),
                             statistics.mean(times["none"]))
        print(f"[data parallel] step time, {DP_TIMED_STEPS} warm steps "
              f"between CUDA events, turns group-none-none-group: under the "
              f"world-1 NCCL group {group_ms:.2f} ms "
              f"({', '.join(f'{x:.2f}' for x in times['group'])}), without a "
              f"group {none_ms:.2f} ms "
              f"({', '.join(f'{x:.2f}' for x in times['none'])}), "
              f"{group_ms / none_ms:.3f}x", flush=True)
        collectives = _collective_host(
            lambda: tr.train_step(loader.batches[0]))
        each_us = collectives["host_ms"] / max(collectives["calls"], 1) * 1e3
        print(f"[data parallel] profiled group step: {collectives['calls']} "
              f"all-reduces a step, {collectives['host_ms']:.2f} ms of host "
              f"time in them ({each_us:.1f} us each)", flush=True)
        del solo

        # one f32 step with the group's data axis against the step without
        # a group, from the same weights, batch and draws; two repeats of
        # the latter say whether the step repeats bit for bit
        batch = loader.batches[0]
        cfg = _dp_config("float32", TRAIN_BATCH)
        results = []
        for mesh in (tr.mesh, None, None):
            model = _dp_model().to(DEVICE, memory_format=torch.channels_last)
            state = TrainState(model, make_optimizer(cfg, model.parameters()))
            step = make_train_step(model, tr.recipe, step_lr(1e-4, 15, 0.1, 3),
                                   compute_dtype=torch.float32, mesh=mesh)
            loss = step(state, torch.as_tensor(batch["image"]).to(DEVICE),
                        torch.as_tensor(batch["depth"]).to(DEVICE),
                        torch.Generator(device=DEVICE).manual_seed(0))
            results.append((float(loss), {
                k: v.detach().cpu() for k, v in model.state_dict().items()
                if v.is_floating_point()}))
            del model, state, step
        (lg, sg), (l0, s0), (l1, s1) = results
        repeat_bits = l0 == l1 and _state_diff(s0, s1) == 0.0
        diff, spread = _state_diff(sg, s0), _state_diff(s0, s1)
        print(f"[data parallel] f32 step under the world-1 NCCL group vs "
              f"without: loss {lg!r} vs {l0!r}, max |d state| {diff:.3e}; "
              f"two repeats without a group: loss {l1!r}, max |d state| "
              f"{spread:.3e} ("
              f"{'bit-equal' if repeat_bits else 'not bit-equal'})",
              flush=True)
        if repeat_bits:
            check(lg == l0 and diff == 0.0,
                  "the world-1 group's f32 step differs from the step "
                  "without a group, which repeats bit for bit")
        else:
            check(diff <= DP_SPREAD_FACTOR * spread
                  and abs(lg - l0) <= DP_SPREAD_FACTOR * abs(l0 - l1),
                  f"the world-1 group's f32 step differs by {diff:.3e} "
                  f"(loss {abs(lg - l0):.3e}), beyond {DP_SPREAD_FACTOR}x "
                  f"the repeats' {spread:.3e} ({abs(l0 - l1):.3e})")
        out["nccl_world1"] = {
            "steps": DP_STEPS, "losses": losses, "step_ms": step_ms,
            "timed_group_ms": times["group"], "timed_none_ms": times["none"],
            "collectives": collectives,
            "seconds": seconds, "launches": launches,
            "f32_step_bit_equal": lg == l0 and diff == 0.0,
            "f32_repeats_bit_equal": repeat_bits,
            "f32_max_diff": diff, "f32_repeat_spread": spread}
        del tr, results
    finally:
        shutdown()
    torch.cuda.empty_cache()

    # (b) gloo, DP_RANKS ranks on the one card
    workdir = f"{tmp}/dp_gloo"
    os.makedirs(workdir)
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dp-rank", str(r),
         workdir], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(DP_RANKS)]
    try:
        # one process on the union batch, twice, while the ranks run
        loader = SyntheticLoader(DP_STEPS_GLOO, seed=310, raw_depth=True)
        ref = [_dp_gloo_run(loader) for _ in range(2)]
        logs = []
        for p in procs:
            log, _ = p.communicate(
                timeout=max(DP_JOIN_TIMEOUT - (time.perf_counter() - t0), 1))
            logs.append(log)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise RuntimeError(f"chip_smoke check failed: a gloo rank outlived "
                           f"{DP_JOIN_TIMEOUT} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0,
              f"gloo rank {r} exited {p.returncode}:\n{log[-4000:]}")
    t_ranks = time.perf_counter() - t0
    ranks = [torch.load(f"{workdir}/rank{r}.pt") for r in range(DP_RANKS)]
    (la, sa), (lb, sb) = ref
    r0, r1 = ranks
    check(r0["losses"] == r1["losses"]
          and all(torch.equal(v, r1["state"][k])
                  for k, v in r0["state"].items()),
          "the two gloo ranks' losses or states differ")
    loss_diff = max(abs(x - y) for x, y in zip(r0["losses"], la))
    loss_spread = max(abs(x - y) for x, y in zip(la, lb))
    g_all = max(float(v.abs().max()) for k, v in sa.items()
                if _dp_kind(k) == "exp_avg")
    kinds, beyond = {}, []
    # the parameters' change from the initial weights, as one vector
    p0 = _dp_model().state_dict()
    keys = [k for k in sa if _dp_kind(k) == "params"]

    def moved(state):
        return torch.cat([(state[k] - p0[k].float()).flatten() for k in keys])

    d_one, d_rep, d_ranks = moved(sa), moved(sb), moved(r0["state"])
    norm = float(d_one.norm())
    rel, spread = (float((d_ranks - d_one).norm()) / norm,
                   float((d_rep - d_one).norm()) / norm)
    bound = DP_SPREAD_FACTOR * spread if spread else FUSED_STEP_GRAD_REL
    if rel > bound:
        beyond.append(f"the parameters' change {rel:.3e} > {bound:.3e}")
    kinds["params"] = {"max_diff": rel, "repeat_spread": spread,
                       "worst_of_bound": rel / bound}
    for kind in ("stats", "exp_avg"):
        keys = [k for k in sa if _dp_kind(k) == kind]
        spread = _state_diff(sa, sb, keys)
        worst = 0.0
        for k in keys:
            d = float((r0["state"][k] - sa[k]).abs().max())
            top = float(sa[k].abs().max())
            bound = max(DP_SPREAD_FACTOR * spread, {
                "stats": DP_STATS_REL * top,
                "exp_avg": max(FUSED_STEP_GRAD_REL * top,
                               FUSED_STEP_GRAD_FLOOR_REL * g_all)}[kind])
            if d > bound:
                beyond.append(f"{k} {d:.3e} > {bound:.3e}")
            worst = max(worst, d / bound)
        kinds[kind] = {"max_diff": _state_diff(r0["state"], sa, keys),
                       "repeat_spread": spread, "worst_of_bound": worst}
    print(f"[data parallel] gloo {DP_RANKS} ranks on one card, "
          f"{DP_PER_RANK} images a rank at {TRAIN_HW[0]}x{TRAIN_HW[1]} f32, "
          f"{DP_STEPS_GLOO} fused GuideDepth steps: ranks bit-equal; losses "
          f"{r0['losses']} vs one process on the union batch {la} "
          f"(repeat {lb}); against the repeats' spread, and the largest "
          f"share of a bound (params: |d change| / |change| of all the "
          f"parameters; stats, exp_avg: max |d|): "
          + "; ".join(f"{kind} {v['max_diff']:.3e} / {v['repeat_spread']:.3e}"
                      f" ({v['worst_of_bound']:.2f})"
                      for kind, v in kinds.items())
          + f"; rank 0's run {r0['seconds']:.2f} s (its launches "
          f"{r0['launches']}), spawn to join {t_ranks:.2f} s", flush=True)
    check(not beyond, f"the two-rank state differs from one process's "
          f"beyond its bound in {len(beyond)} tensors: {beyond[:8]}")
    want = {"gub_conv_fwd": FUSED_FWD_PER_PASS * DP_STEPS_GLOO,
            "gub_conv_dw": FUSED_DW_PER_STEP * DP_STEPS_GLOO,
            "gub_conv_dx": FUSED_DX_PER_STEP * DP_STEPS_GLOO,
            "fused_loss_fwd": DP_STEPS_GLOO, "fused_loss_bwd": DP_STEPS_GLOO}
    check(r0["launches"] == r1["launches"] == want,
          f"the gloo ranks launched {r0['launches']}, {r1['launches']}, "
          f"expected {want} each")
    check(loss_diff <= max(DP_SPREAD_FACTOR * loss_spread,
                           FUSED_STEP_LOSS_RTOL * abs(la[-1])),
          f"the two-rank losses differ from one process's by "
          f"{loss_diff:.3e}, beyond {DP_SPREAD_FACTOR}x the repeats' spread "
          f"{loss_spread:.3e}")
    out["gloo"] = {"ranks": DP_RANKS, "per_rank": DP_PER_RANK,
                   "steps": DP_STEPS_GLOO, "losses": r0["losses"],
                   "single_losses": la, "kinds": kinds,
                   "loss_diff": loss_diff,
                   "loss_spread": loss_spread,
                   "rank_seconds": r0["seconds"], "spawn_to_join_s": t_ranks,
                   "launches": r0["launches"]}
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[data parallel] {out['seconds']:.1f} s", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import tpudepth_torch  # noqa: F401  (fails outside the repo)

    t_start = time.perf_counter()
    host_libs = phase_host_libs()
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
        # GuideDepth's packed stages served and trained, each path's counts
        # set to 0 just before it and read just after it (run_counted)
        packed = phase_packed(tmp, rows, bwd_rows)
        # the main paths of this slice: SAM (4 blocks) and NewCRF (8 blocks)
        # training, each kernel's count set to 0 just before its fit
        attn_train = {name: train_attention_model(name, tmp, blocks)
                      for name, blocks in (("sam", 4), ("newcrf", 8))}
        # weight I/O: a JAX trainer's checkpoint tree resumed (GuideDepth
        # fused, SAM frozen), reference .pth files served; NewCRF's padded
        # stage chain; each path's counts set to 0 just before it and read
        # just after it (run_counted)
        weights_jax = phase_weights_jax()
        weights_torch = phase_weights_torch(tmp)
        stage_chain = phase_stage_chain()
        # data-parallel training: a world of one under NCCL and two gloo
        # ranks on the card, each path's counts set to 0 just before it and
        # read just after it
        data_parallel = phase_data_parallel(tmp)
        # the rest of the zoo served and trained, then the engines
        # serialized and deserialized; each path's counts set to 0 just
        # before it and read just after it
        t_zoo = time.perf_counter()
        zoo = phase_zoo()
        t_zoo = time.perf_counter() - t_zoo
        t_export = time.perf_counter()
        export, op_cost = phase_engine_export(tmp)
        t_export = time.perf_counter() - t_export
        served = set().union(*(r["launches_per_call"]
                               for r in export["engines"].values()))
        check(served == SERVING_KERNELS,
              f"the exported engines launched {sorted(served)}")
        # the data feed and the command lines: each path's counts set to 0
        # just before it and read just after it (run_counted)
        t_feed = time.perf_counter()
        os.environ["TPUDEPTH_CACHE_DIR"] = f"{tmp}/data_cache"
        zip_path, data_feed = phase_data_feed(tmp)
        cli = {"guidedepth": phase_cli_guidedepth(tmp, zip_path, {
            gub: fused_train[f"{gub}_img_per_s"] for gub in ("plain", "fused")})}
        ckpt, cli["train"] = phase_cli_train(
            tmp, zip_path, attn_train["newcrf"]["img_per_s"])
        cli["test"] = phase_cli_test(zip_path, ckpt)
        cli["inference"] = phase_cli_inference(tmp, zip_path)
        t_feed = time.perf_counter() - t_feed
    cli_launches = {
        **{f"cli guidedepth {gub}": cli["guidedepth"][gub]["launches"]
           for gub in ("plain", "fused")},
        "cli train newcrf": cli["train"]["launches"],
        "cli test newcrf": cli["test"]["launches"],
        "cli inference fused": cli["inference"]["launches"]}

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
            "evaluation": eval_launches,
            "packed serving (fused, 4 bs-1 flip-TTA requests)":
                packed["serving"]["launches"],
            **{f"packed training {name} ({PACKED_TRAIN_STEPS} steps)":
               counts["gub_conv_fwd"]
               for name, counts in packed["training"]["per_step"].items()
               if counts.get("gub_conv_fwd")}},
        "launches_per_forward_packed":
            packed["serving"]["launches_per_forward"],
        "max_abs_err": max(max_err, packed["errors"]["fwd"]),
        "max_err": max(max_err, packed["errors"]["fwd"]),
        "checks": n_checks + packed["checks"]["fwd"],
        "packed_shapes": [{k: v for k, v in r.items()
                           if not k.startswith(("dw", "dx", "unpacked_d"))}
                          for r in packed["kernel_times"]],
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
        rel = "dw_rel" if which == "dw" else "dx_sums_rel"
        kernels.append({
            "name": f"gub_conv_{which}",
            "route": "cuda",
            "source": "tpudepth_torch/csrc/gub_conv_bwd.cu",
            "replaces": f"tpudepth/ops/pallas/gub_conv.py:{line}",
            "replaces_function": f"tpudepth/ops/pallas/gub_conv.py::{fn}",
            "launches": fused_train["launches"][f"gub_conv_{which}"],
            "launches_by_path": {
                f"packed training {name} ({PACKED_TRAIN_STEPS} steps)":
                counts[f"gub_conv_{which}"]
                for name, counts in packed["training"]["per_step"].items()
                if counts.get(f"gub_conv_{which}")},
            "max_abs_err": max(bwd_err[which], packed["errors"][which]),
            "max_rel_err": max(bwd_err[rel], packed["errors"][rel]),
            "checks": bwd_checks[which] + packed["checks"][which],
            "packed_shapes": [
                {k: v for k, v in r.items()
                 if k in ("name", "cins", "cout", "hw", "fold", "dx_launches",
                          f"unpacked_{which}_ms") or k.startswith(which)}
                for r in packed["kernel_times"]],
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
    by_path = {
        **cli_launches,
        **{f"engine export {label} (a bs-1 call, live and deserialized)":
           r["launches_per_call"] for label, r in export["engines"].items()},
        **{f"zoo training {name} ({ZOO_TRAIN_STEPS} steps)":
           {k: v * ZOO_TRAIN_STEPS for k, v in r["launches_per_step"].items()}
           for name, r in zoo.items()},
        **{f"weights jax {label} (one step each of the source and two "
           "restored trainers)": weights_jax[label]["launches"]
           for label in ("GuideDepth fused", "sam")},
        **{f"weights torch {label} (a bs-1 frame)": r["launches_per_frame"]
           for label, r in weights_torch["cases"].items()},
        **{f"stage chain newcrf row {bs} (a chained forward)":
           stage_chain[bs]["launches_per_forward"] for bs in ("bs1", "bs8")},
        f"data parallel nccl world 1 ({DP_STEPS} steps)":
            data_parallel["nccl_world1"]["launches"],
        f"data parallel gloo rank 0 of {DP_RANKS} ({DP_STEPS_GLOO} steps)":
            data_parallel["gloo"]["launches"]}
    for k in kernels:
        for path, counts in by_path.items():
            if counts.get(k["name"]):
                k.setdefault("launches_by_path", {})[path] = counts[k["name"]]
    for name in ("fused_loss_fwd", "fused_loss_bwd", "gub_conv_fwd",
                 "gub_conv_dw", "gub_conv_dx", "window_attn_train_fwd",
                 "window_attn_train_bwd", "mlp_train_fwd", "mlp_train_bwd",
                 "fused_root_loss_fwd", "fused_root_loss_bwd",
                 "crf_rowblock_infer"):
        check(any(name in c for c in cli_launches.values()),
              f"no command line launched {name}")
    seconds = time.perf_counter() - t_start
    print(f"[time] {seconds:.1f} s in all; the data feed and the command "
          f"lines {t_feed:.1f} s; [zoo] {t_zoo:.1f} s; [engine export] and "
          f"[op cost] {t_export:.1f} s; [packed] {packed['seconds']:.1f} s; "
          f"[weights jax] {weights_jax['seconds']:.1f} s, [weights torch] "
          f"{weights_torch['seconds']:.1f} s, [stage chain] "
          f"{stage_chain['seconds']:.1f} s, [data parallel] "
          f"{data_parallel['seconds']:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels, "serve_errors": errs,
                      "sam_serve_errors": sam_errs, "sam_engine": sam_perf,
                      "newcrf_serve_errors": crf_errs,
                      "newcrf_engine": crf_perf, "root_eval": root_eval,
                      "engine_img_per_s": perf, "training": train,
                      "fused_training": fused_train, "evaluation": evaluation,
                      "attention_training": attn_train, "packed": packed,
                      "kernel_splits": splits, "host_libs": host_libs,
                      "data_feed": data_feed, "cli": cli, "zoo": zoo,
                      "engine_export": export, "op_cost": op_cost,
                      "weights_jax": weights_jax,
                      "weights_torch": weights_torch,
                      "stage_chain": stage_chain,
                      "data_parallel": data_parallel, "seconds": seconds}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        sys.exit(dp_gloo_worker(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
