#!/usr/bin/env python3
"""What ``chip_smoke.py`` does not print for a tree it is not part of: the
B 8 train-step times of ``gub_conv_fwd`` with statistics, the split of
``sam_rowblock_infer`` into its CUDA kernels, and digests of the outputs
that must stay bit-equal from tree to tree, on one NVIDIA GPU.

    python3 scripts/torch_kernel_ab.py [--tag NAME] [--json PATH]
        [--skip conv,row,digest]

It runs ``chip_smoke``'s own ``fwd_train_step_times`` and ``sam_row_split``
(from the ``chip_smoke.py`` beside this script's directory) on the
``tpudepth_torch`` of the current directory, so one call of this script
from another tree's root times that tree by the same code: e.g. an
unpacked parent under a git-ignored directory, ``cd .smoke_tree/parent &&
python3 ../../scripts/torch_kernel_ab.py --tag parent``. It prints
``chip_smoke``'s [kernel time] B 8 and [row kernel split] lines, then
``[digest]``: sha256 of the outputs of ``gub_conv_dw``, ``gub_conv_dx``
(bf16 at the nine conv shapes, batch 2, statistics on, cotangents and the
forward output drawn from a seed, not computed) and of
``block_epilogue_infer`` (bf16, the four SAM stages, batch 1). The card's
name and power limit come first; ``--json`` writes every number to PATH.
It needs a card.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_chip_smoke():
    """``chip_smoke`` of this script's tree; the ``tpudepth_torch`` it
    imports (inside its functions) is the current directory's."""
    sys.path.insert(0, os.getcwd())
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def digests(cs):
    from tpudepth_torch.ops.kernels import epilogue_infer as ei
    from tpudepth_torch.ops.kernels import gub_conv as gc

    bf = torch.bfloat16
    out = {}
    for i, (name, cins, cout, h, w, prelude) in enumerate(cs.PATH_SHAPES):
        parts, wt, b, pre, _ = cs.make_case(i, 2, h, w, cins, cout, prelude,
                                            False, bf, cs.DEVICE)
        rng = np.random.default_rng(500 + i)

        def draw(shape, s=1.0, dt=torch.float32):
            return torch.from_numpy((s * rng.standard_normal(shape)).astype(
                np.float32)).to(cs.DEVICE, dt)

        y = draw((2, h, w, cout), dt=bf)
        dy = draw((2, h, w, cout), dt=bf)
        cot = {"y": y, "ds": draw(cout, 0.1), "dq": draw(cout, 0.1)}
        dw = gc.conv_bn_act_dw(parts, dy, wt, preludes=pre, **cot)
        dxs, off = [], 0
        for j, x in enumerate(parts):
            if cins != (3,):
                dxs += [t for t in gc.conv_bn_act_dx(
                    x, wt, off, dy, prelude=pre[j] if prelude else None,
                    **cot) if t is not None]
            off += x.shape[-1]
        d = {"gub_conv_dw": digest(*dw), "gub_conv_dx": digest(*dxs)}
        out[name] = d
        print(f"[digest] {name:<20} gub_conv_dw {d['gub_conv_dw']} "
              f"gub_conv_dx {d['gub_conv_dx'] if dxs else '-'}", flush=True)
        del parts, y, dy, dw, dxs
        torch.cuda.empty_cache()
    for i, (stage, c, heads, hw) in enumerate(cs.ATTN_STAGES):
        _, tail = cs._sam_kernel_inputs(10 * i + 1, 1, 1, c, 4 * c,
                                        hw[0] * hw[1], bf)
        d = digest(ei.block_epilogue_infer(**tail))
        out[f"block_epilogue_infer {stage}"] = d
        print(f"[digest] block_epilogue_infer {stage} B1 bf16 {d}",
              flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--json", help="write every number to this file")
    ap.add_argument("--skip", default="", help="comma-separated sections")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_ab: needs a CUDA card", file=sys.stderr)
        return 1
    cs = load_chip_smoke()
    print(f"[{args.tag}] {os.getcwd()}", flush=True)
    cs.phase_device()
    skip = set(filter(None, args.skip.split(",")))
    result = {"tag": args.tag}
    for section, fn in (("conv", cs.fwd_train_step_times),
                        ("row", cs.sam_row_split),
                        ("digest", lambda: digests(cs))):
        if section not in skip:
            result[section] = fn()
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
