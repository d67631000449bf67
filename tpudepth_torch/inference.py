"""Speedtest CLI of the port: ``python -m tpudepth_torch.inference``.

The speedtest part of the JAX CLI (``inference.py``), on the card, for any
ported model (``--model GuideDepth|GuideDepth-S|sam|newcrf``): the model in
float32 and the bfloat16 engine (with the meters conversion), each timed with
the 10-warmup / 200-run protocol. ``--gub plain`` (the default, as the JAX
package's ``TPUDEPTH_GUB`` is off unless set to ``fused``) runs GuideDepth's
GUB stages as plain tensor code; ``--gub fused`` runs their k=3 convs
through the ``gub_conv_fwd`` CUDA kernel; ``--attn``
picks the mode of the attention blocks of SAM and NewCRF (``row``: the
window-row block kernels; ``block``: the whole-block kernels over raw
windows, ``TPUDEPTH_BLOCK=fused`` in JAX; ``fused``: the
``window_attn_infer`` and ``block_epilogue_infer`` kernels; ``pair``:
``window_attn_infer`` and ``mlp_infer``; ``plain``: no kernel), checked
against the model; by default each model's own (SAM ``fused``, NewCRF
``row``).
"""

from __future__ import annotations

import argparse
import os

import torch

from tpudepth_torch.core.config import MAX_DEPTHS, RESOLUTIONS, image_size
from tpudepth_torch.infer.engine import InferenceEngine
from tpudepth_torch.models.layers import init_random_
from tpudepth_torch.models.registry import ATTN_MODES, GUB_MODES, build_model


def get_args(argv=None):
    parser = argparse.ArgumentParser(
        description="H100 inference speedtest (tpudepth_torch)")
    parser.add_argument("--model", type=str, default="GuideDepth")
    parser.add_argument("--dataset", type=str, default="nyu_reduced",
                        choices=sorted(RESOLUTIONS))
    parser.add_argument("--resolution", type=str, default="half",
                        choices=["full", "half", "mini", "tu_small", "tu_big"])
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--num_test_runs", type=int, default=200)
    parser.add_argument("--warm_up_runs", type=int, default=10)
    parser.add_argument("--weights_path", type=str, default=None,
                        help="a torch.save'd state_dict of the port's model")
    parser.add_argument("--gub", type=str, default="plain", choices=GUB_MODES)
    parser.add_argument("--attn", type=str, default=None, choices=ATTN_MODES,
                        help="block mode of an attention model (default: "
                             "the model's own)")
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    print(args)
    if args.resolution not in RESOLUTIONS[args.dataset]:
        raise SystemExit(f"resolution {args.resolution!r} is not defined for "
                         f"{args.dataset!r}")
    h, w = image_size(args.dataset, args.resolution)
    shape = (args.batch_size, 3, h, w)

    try:
        model = build_model(args.model, gub=args.gub, attn=args.attn)
    except ValueError as e:
        raise SystemExit(str(e))
    if args.weights_path and os.path.exists(args.weights_path):
        model.load_state_dict(torch.load(args.weights_path, map_location="cpu",
                                         weights_only=True))
    else:
        print("no weights; random init")
        init_random_(model, seed=0)

    f32 = InferenceEngine(model, shape, compute_dtype=torch.float32)
    stats = f32.benchmark(args.num_test_runs, args.warm_up_runs)
    print("[tpudepth_torch f32]         {:.5f} s/frame, {:.1f} FPS, "
          "{:.1f} img/s ({})".format(stats["seconds_per_frame"], stats["fps"],
                                     stats["images_per_second"],
                                     stats["timing"]))
    engine = InferenceEngine(model, shape, compute_dtype=torch.bfloat16,
                             max_depth=MAX_DEPTHS[args.dataset])
    stats = engine.benchmark(args.num_test_runs, args.warm_up_runs)
    print("[tpudepth_torch bf16 engine] {:.5f} s/frame, {:.1f} FPS, "
          "{:.1f} img/s ({})".format(stats["seconds_per_frame"], stats["fps"],
                                     stats["images_per_second"],
                                     stats["timing"]))


if __name__ == "__main__":
    main()
