"""Root evaluation command line: ``python -m tpudepth_torch.cli.test``.

Counterpart of the JAX package's ``test.py`` (``src/test.py:30-37``:
``--bs --pt --min_depth_eval --max_depth_eval``, and ``--data``, ``--model``,
``--dtype``), plus ``--device`` (default ``cuda``). It loads a checkpoint
the port wrote (``tpudepth_torch/train/checkpoint.py``: either schema, an
exported ``best_model`` or a bare ``state_dict``) and scores the model with
``RootEvaluator`` over ``get_training_testing_data``'s test split: the
Garg/Eigen fractional crop, min-max ground truth, the nine-metric report.
"""

from __future__ import annotations

import argparse

import torch

from tpudepth_torch.core.config import EvalConfig
from tpudepth_torch.core.runtime import resolve_device
from tpudepth_torch.data.nyu import get_training_testing_data
from tpudepth_torch.data.synthetic import resolve_data
from tpudepth_torch.eval.evaluator import RootEvaluator
from tpudepth_torch.models.registry import build_model
from tpudepth_torch.train.checkpoint import load_model_weights
from tpudepth_torch.train.trainer import make_eval_step


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Monocular Depth Estimation via Transfer Learning "
                    "(H100 eval)")
    parser.add_argument("--bs", "--batch-size", default=6, type=int,
                        help="batch size")
    parser.add_argument("--pt", "--path",
                        default="./checkpoints/global_checkpoint", type=str,
                        help="path to the model checkpoint")
    parser.add_argument("--min_depth_eval", type=float, default=1e-3,
                        help="minimum depth for evaluation")
    parser.add_argument("--max_depth_eval", type=float, default=80,
                        help="maximum depth for evaluation")
    parser.add_argument("--data", default="CSVdata.zip", type=str)
    parser.add_argument("--model", default="GuideDepth", type=str)
    parser.add_argument("--dtype", default="bfloat16", type=str)
    parser.add_argument("--device", default="cuda", type=str,
                        help="'cuda' (raises without a card) or 'cpu'")
    return parser


def main(argv=None) -> dict:
    """Run the command line; returns the nine metrics by name."""
    args = get_parser().parse_args(argv)
    device = resolve_device(args.device)
    zip_path = resolve_data(args.data)

    print("getting the Model from: ", args.pt)
    model = build_model(args.model)
    restored = load_model_weights(model, args.pt)
    model.to(device, memory_format=torch.channels_last)
    print("Model started.")
    print("Model with: {} epoch".format(restored.get("epoch", "?")))

    _, test_loader = get_training_testing_data(args.bs, zip_path)
    dtype = torch.bfloat16 if args.dtype.startswith("b") else torch.float32
    config = EvalConfig(model=args.model, batch_size=args.bs,
                        min_depth_eval=args.min_depth_eval,
                        max_depth_eval=args.max_depth_eval)
    evaluator = RootEvaluator(make_eval_step(model, dtype), config,
                              device=device)
    metrics = evaluator.evaluate(test_loader, progress=True)
    print(RootEvaluator.format_report(metrics, len(test_loader)))
    return metrics


if __name__ == "__main__":
    main()
