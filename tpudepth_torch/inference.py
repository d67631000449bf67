"""Inference command line of the port: ``python -m tpudepth_torch.inference``.

The JAX CLI (``inference.py``) on the card, for any of its models
(``--model``, a name or alias of ``models/registry.py``): the model in float32 and
the bfloat16 engine (with the meters conversion), each timed with the
10-warmup / 200-run protocol between CUDA events (``--num_test_runs 0``
skips the timing; on ``--device cpu`` it must be 0, since the speedtest
times the card). ``--gub plain`` (the default, as the JAX package's
``TPUDEPTH_GUB`` is off unless set to ``fused``) runs GuideDepth's GUB
stages as plain tensor code; ``--gub fused`` runs their k=3 convs through
the ``gub_conv_fwd`` CUDA kernel; ``--attn`` picks the mode of the
attention blocks of SAM and NewCRF (``row``: the window-row block kernels;
``block``: the whole-block kernels over raw windows, ``TPUDEPTH_BLOCK=fused``
in JAX; ``fused``: the ``window_attn_infer`` and ``block_epilogue_infer``
kernels; ``pair``: ``window_attn_infer`` and ``mlp_infer``; ``plain``: no
kernel), checked against the model; by default each model's own (SAM
``fused``, NewCRF ``row``).

``--eval`` scores the bf16 engine at batch 1 with ``AlhashimEvaluator``
(flip-TTA, Eigen crop) over the test split of ``--data_path`` (a zip, or
``synthetic[:HxW]``), writes its ``results.txt`` into ``--save_results``
and, beside it, ``inference_results.txt`` in the JAX CLI's format
(``backend,s/frame,FPS,img/s,RMSE,Delta1``; one row for the f32 model, one
for the bf16 engine with its accuracy; the timing columns stay empty when
the timing was skipped). ``--engine_path PATH`` serializes the bf16
engine of ``(batch_size, 3, H, W)`` to PATH (``InferenceEngine.serialize``,
``torch.export``); with ``--eval`` and ``--batch_size 1`` the deserialized
engine is scored too and gets the row ``engine_bf16_deserialized`` (the
JAX CLI's ``aot_bf16_deserialized``). ``--timing`` has no counterpart: CUDA
events leave no dispatch gap (``infer/engine.py``).
"""

from __future__ import annotations

import argparse
import os

import torch

from tpudepth_torch.core.config import MAX_DEPTHS, RESOLUTIONS, EvalConfig
from tpudepth_torch.core.runtime import resolve_device
from tpudepth_torch.infer.engine import InferenceEngine
from tpudepth_torch.models.layers import init_random_
from tpudepth_torch.models.registry import ATTN_MODES, GUB_MODES, build_model
from tpudepth_torch.train.checkpoint import load_model_weights


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="H100 inference speedtest (tpudepth_torch)")
    parser.set_defaults(evaluate=False)
    parser.add_argument("--eval", dest="evaluate", action="store_true")
    parser.add_argument("--data_path", type=str, default="CSVdata.zip")
    parser.add_argument("--model", type=str, default="GuideDepth")
    parser.add_argument("--dataset", type=str, default="nyu_reduced",
                        choices=sorted(RESOLUTIONS))
    parser.add_argument("--resolution", type=str, default="half",
                        choices=["full", "half", "mini", "tu_small", "tu_big"])
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--num_test_runs", type=int, default=200)
    parser.add_argument("--warm_up_runs", type=int, default=10)
    parser.add_argument("--weights_path", type=str, default=None,
                        help="a checkpoint or state_dict the port wrote")
    parser.add_argument("--save_results", type=str, default="./results")
    parser.add_argument("--engine_path", type=str, default="",
                        help="serialize the bf16 engine here (torch.export)")
    parser.add_argument("--gub", type=str, default="plain", choices=GUB_MODES)
    parser.add_argument("--attn", type=str, default=None, choices=ATTN_MODES,
                        help="block mode of an attention model (default: "
                             "the model's own)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (raises without a card) or 'cpu'")
    return parser


def get_args(argv=None):
    return get_parser().parse_args(argv)


def _timed(label, engine, args):
    if args.num_test_runs <= 0:
        print(f"[{label}] speedtest skipped (--num_test_runs 0)")
        return None
    stats = engine.benchmark(args.num_test_runs, args.warm_up_runs)
    print("[{}] {:.5f} s/frame, {:.1f} FPS, {:.1f} img/s ({})".format(
        label, stats["seconds_per_frame"], stats["fps"],
        stats["images_per_second"], stats["timing"]))
    return stats


def _row(name, stats, avg=None) -> str:
    times = ("{:.5f},{:.1f},{:.1f}".format(
        stats["seconds_per_frame"], stats["fps"], stats["images_per_second"])
        if stats else ",,")
    acc = "{:.3f},{:.3f}".format(avg.rmse, avg.delta1) if avg else ","
    return f"{name},{times},{acc}\n"


def evaluate(args, model, config, device):
    """The bf16 engine at batch 1 through ``AlhashimEvaluator`` over the
    test split (the engine's output is already in meters); with
    ``--engine_path`` and ``--batch_size 1`` the deserialized engine too.
    Returns the engine's metrics and the deserialized engine's (or None)."""
    from tpudepth_torch.data.datasets import get_dataloader
    from tpudepth_torch.data.synthetic import resolve_data
    from tpudepth_torch.eval.evaluator import AlhashimEvaluator

    data_path = resolve_data(args.data_path, n_train=8, dataset=args.dataset)
    test_loader = get_dataloader(args.dataset, data_path, "test", batch_size=1,
                                 resolution=args.resolution)
    h, w = config.image_size
    engine = InferenceEngine(model, (1, 3, h, w), compute_dtype=torch.bfloat16,
                             max_depth=config.max_depth, device=device)
    evaluator = AlhashimEvaluator(
        engine, config, depth_scale=1.0 if args.dataset == "kitti" else None,
        forward_returns_meters=True, device=device)
    avg = evaluator.evaluate(test_loader, save_results_to=args.save_results)
    print("[bf16 engine eval]")
    print(AlhashimEvaluator.format_report(avg))
    deser_avg = None
    if args.engine_path and args.batch_size == 1:
        deser = InferenceEngine.deserialize(args.engine_path, device=device)
        deser_avg = AlhashimEvaluator(
            deser, config,
            depth_scale=1.0 if args.dataset == "kitti" else None,
            forward_returns_meters=True, device=device).evaluate(test_loader)
        print("[deserialized engine eval]")
        print(AlhashimEvaluator.format_report(deser_avg))
    return avg, deser_avg


def main(argv=None) -> dict:
    """Run the command line; returns the speedtests' statistics (None when
    skipped) and, with ``--eval``, the engine's ``metrics``."""
    args = get_args(argv)
    print(args)
    if args.resolution not in RESOLUTIONS[args.dataset]:
        raise SystemExit(f"resolution {args.resolution!r} is not defined for "
                         f"{args.dataset!r}")
    config = EvalConfig(model=args.model, dataset=args.dataset,
                        resolution=args.resolution,
                        results_dir=args.save_results)
    h, w = config.image_size
    shape = (args.batch_size, 3, h, w)

    try:
        model = build_model(args.model, gub=args.gub, attn=args.attn)
    except ValueError as e:
        raise SystemExit(str(e))
    if args.weights_path and os.path.exists(args.weights_path):
        load_model_weights(model, args.weights_path)
    else:
        print("no weights; random init")
        init_random_(model, seed=0)
    device = resolve_device(args.device)

    f32 = _timed("tpudepth_torch f32        ", InferenceEngine(
        model, shape, compute_dtype=torch.float32, device=device), args)
    engine = InferenceEngine(model, shape, compute_dtype=torch.bfloat16,
                             max_depth=MAX_DEPTHS[args.dataset], device=device)
    if args.engine_path:
        engine.serialize(args.engine_path)
        print("serialized engine to", args.engine_path)
    bf16 = _timed("tpudepth_torch bf16 engine", engine, args)
    out = {"f32": f32, "bf16": bf16}
    if args.evaluate:
        avg, deser_avg = evaluate(args, model, config, device)
        out["metrics"] = avg
        if deser_avg is not None:
            out["deserialized_metrics"] = deser_avg
        os.makedirs(args.save_results, exist_ok=True)
        with open(os.path.join(args.save_results, "inference_results.txt"),
                  "w") as f:
            f.write("backend,s/frame,FPS,img/s,RMSE,Delta1\n")
            f.write(_row("torch_f32", f32))
            f.write(_row("engine_bf16", bf16, avg))
            if deser_avg is not None:
                f.write(_row("engine_bf16_deserialized", None, deser_avg))
    return out


if __name__ == "__main__":
    main()
