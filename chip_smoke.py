#!/usr/bin/env python3
"""Smoke test of tpudepth_torch on one NVIDIA GPU: ``python3 chip_smoke.py``.

It drives the port's main paths at NYU 480x640: serving (GuideDepth in bf16
with fused GUB stages), training (``Trainer.fit``, alhashim recipe, bf16,
batch 8) with plain and with fused GUB stages, and the evaluator on the
trained model. It holds every CUDA kernel of those paths against its plain
PyTorch version. Phases:

1. device: needs CUDA; prints the card's name and power limit; turns TF32
   off for every f32 reference;
2. build: compiles every CUDA source of the package with nvcc (in parallel)
   and prints the time and the ptxas report;
3. kernels: ``gub_conv_fwd`` against ``conv_bn_act_reference`` at the nine
   shapes of the paths, at batch 1 (serving) and batch 8 (training,
   evaluation), in f32 and bf16, with and without prelude and skip, output
   and statistics; ``fused_loss_fwd`` and ``fused_loss_bwd``
   against ``fused_partials_reference`` / ``fused_bwd_reference`` at the
   training path's shape and at ragged, zero-target, pred == target and flat
   cases; per shape the device time of the kernel, of the plain version and
   of a library yardstick (one cuDNN ``F.conv2d``; the port's ``DepthLoss``
   and its autograd backward) beside the bound; ``gub_conv_dw`` and
   ``gub_conv_dx`` against ``conv_bn_act_dw_reference`` /
   ``conv_bn_act_dx_reference`` at the nine shapes of a batch-8 train step in
   f32 and bf16 and at prelude / skip / ragged / k=1 / multi-part cases,
   timed beside cuDNN's ``convolution_backward`` of the same conv;
4. serving: 8 single-image requests through ``InferenceEngine`` (bf16,
   flip-TTA, meters), with the kernel's launches counted over exactly that
   run, then the raw outputs against the plain f32 model, then the engine's
   img/s at bs 1 and 8, fused and plain, each with a ``torch.profiler``
   window (device busy share, launches, largest kernels);
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
8. one JSON line on the kernels, and last the JSON line with the device.

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
# patches (signs of zero differences), and uniform values
LOSS_CASES = [("norm", 8, 480, 640), ("norm", 8, 240, 320),
              ("norm", 2, 33, 47), ("zeros", 8, 480, 640),
              ("equal", 2, 96, 128), ("smooth", 2, 50, 70),
              ("random", 3, 48, 64)]
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
        print(f"[kernel time] {name:<20} {'+'.join(map(str, cins))}->{cout} "
              f"@{h}x{w} B{TRAIN_BATCH} bf16: gub_conv_dw {row['dw_ms']:.4f} "
              f"ms (plain {row['dw_plain_ms']:.3f}, cuDNN dw+db "
              f"{row['dw_library_ms']:.4f}, bound {row['dw_bound_ms']:.4f}: "
              f"{100 * row['dw_bound_ms'] / row['dw_ms']:.1f}%); gub_conv_dx "
              f"x{len(dx_parts)} {row['dx_ms']:.4f} ms (plain "
              f"{row['dx_plain_ms']:.3f}, cuDNN dx {row['dx_library_ms']:.4f}, "
              f"bound {row['dx_bound_ms']:.4f})", flush=True)
        del parts, y, dy, cot, x_lib, g_lib
        torch.cuda.empty_cache()
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
                      "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
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
    launches, errs, perf = phase_serving()
    with tempfile.TemporaryDirectory() as tmp:
        train, plain_trainer, cfg, loaders = phase_training(tmp)
        fused_train, fused_trainer = phase_training_fused(
            tmp, plain_trainer, cfg, loaders)
        del plain_trainer
        evaluation, eval_launches = phase_evaluation(tmp, fused_trainer)

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
                 "k=3 GUB convs summed, CUDA graph replays",
        "ms": total(rows, "ms"),
        "plain_ms": total(rows, "plain_ms"),
        "bound_ms": total(rows, "bound_ms"),
        "bound_by": bound_by(rows),
        "library_ms": total(rows, "library_ms"),
        "shapes": rows,
    }]
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
    print(json.dumps({"kernels": kernels, "serve_errors": errs,
                      "engine_img_per_s": perf, "training": train,
                      "fused_training": fused_train, "evaluation": evaluation,
                      "seconds": time.perf_counter() - t_start}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
