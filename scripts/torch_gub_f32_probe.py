#!/usr/bin/env python3
"""What float32 costs one GuidedUpsamplingBlock of tpudepth_torch in train
mode, plain and fused, each against the plain block in float64.

    python3 scripts/torch_gub_f32_probe.py                 # the card, B 8, 480x640 stages
    python3 scripts/torch_gub_f32_probe.py --device cpu --batch 4 --scale 4

For every stage and seed it runs forward and backward of the same block on
the same inputs three times: plain in f64 (the reference), plain in f32,
fused in f32 (the ``gub_conv_*`` kernels on the card, their plain versions on
the CPU). Per run it prints, for the output, the parameter gradients (conv
biases in front of a BatchNorm left out: their gradient is 0) and the input
gradient:

- ``max``: the largest error over the tensor's largest value (the worst
  tensor of the kind);
- ``l2``: ``||got - ref|| / ||ref||``;
- ``off``: how many elements of the input gradient are further than 1e-3 of
  its largest value from the reference, and ``rest``: ``l2`` over all other
  elements;

and, for the plain f32 run, ``flips``: how many ReLU gates and signs of
``y - target`` differ from the f64 run's. A gate or sign flips when its
argument lies within rounding of 0. One flip changes the input gradient
around that pixel by about its own size and moves every parameter gradient by
about one term of its sum, which for a sum of ``n`` terms of random sign is
about ``1/sqrt(n)`` of the result; the rounding of everything else shows in
``l2``.
"""

from __future__ import annotations

import argparse
import copy
import pathlib
import subprocess
import sys

import numpy as np
import torch
import torch.nn as nn

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from tpudepth_torch.models.guidedepth import GuidedUpsamplingBlock  # noqa: E402
from tpudepth_torch.models.layers import init_random_  # noqa: E402

# (in, expand, out, H, W) of GuideDepth's three blocks at 480x640
STAGES = ((64, 64, 32, 120, 160), (32, 32, 16, 240, 320), (16, 16, 1, 480, 640))
OFF = 1e-3


def run(block, fused, dt, dev, guide, depth, target):
    """Gradients, output and (plain only) the gates of one train-mode pass."""
    m = copy.deepcopy(block).to(dt).to(
        dev, memory_format=torch.channels_last).train()
    m.fused = fused
    gates = []
    for mod in m.modules():
        if isinstance(mod, nn.ReLU):
            mod.register_forward_hook(
                lambda _m, _i, out: gates.append((out > 0).cpu()))
    g = guide.to(dev, dt).contiguous(memory_format=torch.channels_last)
    d = depth.to(dev, dt).contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    y = m(g, d)
    diff = y - target.to(dev, dt)
    gates.append((diff > 0).cpu())
    (diff.abs().mean() + 0.1 * (y * y).mean()).backward()
    grads = {n: p.grad.double().cpu() for n, p in m.named_parameters()}
    return grads, d.grad.double().cpu(), y.detach().double().cpu(), gates


def errors(got, ref):
    e = (got - ref).abs()
    off = e > OFF * ref.abs().max()
    return (float(e.max() / ref.abs().max()),
            float(e.norm() / ref.norm()), int(off.sum()),
            float(e[~off].norm() / ref.norm()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--scale", type=int, default=1,
                    help="divide every stage's height and width by this")
    ap.add_argument("--seeds", type=int, default=3)
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0])
    for stage, (cin, ef, cout, h, w) in enumerate(STAGES, start=1):
        h, w = h // args.scale, w // args.scale
        for seed in range(args.seeds):
            block = init_random_(GuidedUpsamplingBlock(cin, ef, cout),
                                 seed=10 * seed + stage)
            rng = np.random.default_rng(400 + 10 * seed + stage)
            bsz = args.batch
            guide = torch.from_numpy(rng.random((bsz, 3, h, w),
                                                dtype=np.float32))
            depth = torch.from_numpy(rng.standard_normal(
                (bsz, cin, h, w)).astype(np.float32))
            target = torch.from_numpy(rng.standard_normal(
                (bsz, cout, h, w)).astype(np.float32))
            data = (guide, depth, target)
            ref_p, ref_d, ref_y, ref_gates = run(block, False, torch.float64,
                                                 dev, *data)
            g_all = max(float(v.abs().max()) for v in ref_p.values())
            for tag, fused in (("plain", False), ("fused", True)):
                got_p, got_d, got_y, gates = run(block, fused, torch.float32,
                                                 dev, *data)
                par = [errors(got_p[n], v)[:2] for n, v in ref_p.items()
                       if float(v.abs().max()) > 1e-9 * g_all]
                d_max, d_l2, d_off, d_rest = errors(got_d, ref_d)
                y_max, y_l2 = errors(got_y, ref_y)[:2]
                flips = ""
                if not fused:
                    n = sum(int((a != b).sum())
                            for a, b in zip(gates, ref_gates))
                    flips = f" flips {n}"
                print(f"up_{stage} {cin}->{cout} @{h}x{w} B{bsz} seed {seed} "
                      f"{tag} f32 vs plain f64: output max {y_max:.2e} l2 "
                      f"{y_l2:.2e}; parameters max {max(p[0] for p in par):.2e}"
                      f" l2 {max(p[1] for p in par):.2e}; input gradient max "
                      f"{d_max:.2e} l2 {d_l2:.2e} off {d_off} of "
                      f"{ref_d.numel()} rest {d_rest:.2e}{flips}", flush=True)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
