#!/usr/bin/env python3
"""What ``chip_smoke.py`` does not print for a tree it is not part of: the
B 8 train-step times of ``gub_conv_fwd`` with statistics, the split of
``sam_rowblock_infer``, ``crf_rowblock_infer``, ``sam_block_infer``,
``crf_block_infer`` and ``window_attn_train_bwd`` into their CUDA kernels,
and digests of the outputs that must stay bit-equal
from tree to tree, on one NVIDIA GPU.

    python3 scripts/torch_kernel_ab.py [--tag NAME] [--json PATH]
        [--skip conv,split,digest]

It runs ``chip_smoke``'s own ``fwd_train_step_times`` and ``kernel_splits``
(from the ``chip_smoke.py`` beside this script's directory) on the
``tpudepth_torch`` of the current directory, so one call of this script
from another tree's root times that tree by the same code: e.g. an
unpacked parent under a git-ignored directory, ``cd .smoke_tree/parent &&
python3 ../../scripts/torch_kernel_ab.py --tag parent``. It prints
``chip_smoke``'s [kernel time] B 8 and [row kernel split] / [block kernel
split] / [train kernel split] lines, then ``[digest]``: sha256 of the
outputs of, on seeded inputs:

- ``gub_conv_dw``, ``gub_conv_dx`` (bf16 at the nine conv shapes, batch 2,
  statistics on, cotangents and the forward output drawn from a seed, not
  computed);
- at the four SAM stages, batch 1, over a stage's padded map:
  ``block_epilogue_infer`` (bf16); ``window_attn_infer`` in bf16 and in
  f32, with and without the shift-3 mask; ``window_attn_train_bwd`` (bf16,
  dq, dk, dv and dbias, with and without the mask); ``crf_block_infer``
  (bf16, shift 0 and 3).

Equal digests in two trees are bit-equal outputs. Which must be equal
between a tree and its parent depends on what the change touched: since
the bf16 forward attention moved onto the tensor cores (its sum order
changed), the bf16 ``window_attn_infer`` and ``crf_block_infer`` digests
differ from the trees before it, while ``gub_conv_dw`` / ``_dx``,
``block_epilogue_infer``, the f32 ``window_attn_infer`` and the bf16
``window_attn_train_bwd`` (which shares the attention's tile code) do not.
Every digest is equal between two runs of one tree. The card's name and
power limit come first; ``--json`` writes every number to PATH. It needs a
card.
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
    from tpudepth_torch.ops.kernels import block_infer as bi
    from tpudepth_torch.ops.kernels import epilogue_infer as ei
    from tpudepth_torch.ops.kernels import gub_conv as gc
    from tpudepth_torch.ops.kernels import window_attn as wat
    from tpudepth_torch.ops.kernels import window_attn_infer as wai
    from tpudepth_torch.ops.window import shifted_window_attention_mask

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
        hp, wp = cs._padded(hw)
        windows = hp * wp // 49
        attn, tail = cs._sam_kernel_inputs(10 * i + 1, 1, windows, c,
                                           4 * c, hw[0] * hw[1], bf)
        attn32 = cs._sam_kernel_inputs(10 * i + 1, 1, windows, c, 4 * c,
                                       hw[0] * hw[1], torch.float32)[0]
        tattn, ga = cs._train_kernel_inputs(60 + i, 1, windows, c, heads,
                                            hw[0] * hw[1], bf)[:2]
        mask = torch.from_numpy(
            shifted_window_attention_mask(hp, wp, 7, 3)).to(cs.DEVICE)
        found = {"block_epilogue_infer": ei.block_epilogue_infer(**tail)}
        for mname, mk in (("", None), (" shift-3 mask", mask)):
            found["window_attn_infer" + mname] = wai.window_attention_infer(
                **attn, mask=mk)
            found["window_attn_infer f32" + mname] = (
                wai.window_attention_infer(**attn32, mask=mk))
            found["window_attn_train_bwd" + mname] = wat.window_attention_bwd(
                **tattn, mask=mk, g=ga)
        for shift in (0, 3):
            a, kw, _ = cs._block_inputs(40 + i + shift, 1, hw, c, heads,
                                        shift, bf)
            found[f"crf_block_infer shift {shift}"] = bi.crf_block_infer(
                **a, **kw)
        for name, t in found.items():
            out[f"{name} {stage}"] = d = digest(
                *(t if isinstance(t, tuple) else (t,)))
            print(f"[digest] {name} {stage} B1 "
                  f"{'f32' if ' f32' in name else 'bf16'} {d}", flush=True)
        del attn, attn32, tattn, ga, tail, found, a
        torch.cuda.empty_cache()
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
                        ("split", cs.kernel_splits),
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
