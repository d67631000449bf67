"""GuideDepth stack command line: ``python -m tpudepth_torch.cli.guidedepth_main``.

Counterpart of the JAX package's ``guidedepth_main.py`` with its flags and
defaults (``src/GuideDepth/main.py:10-96``: ``--train/--eval``,
``--data_path/--test_path``, ``--dataset``, ``--resolution``,
``--eval_mode``, ``--model``, ``--weights_path``, ``--load_checkpoint``,
``--save_checkpoint``, ``--save_results``, ``--batch_size``,
``--learning_rate``, ``--num_epochs``, ``--scheduler_step_size``,
``--num_workers``, ``--steps-per-epoch``), plus ``--device`` (default
``cuda``) and ``--gub plain|fused`` (the GUB stages as plain modules or
through the fused GUB conv kernels; the JAX package reads ``TPUDEPTH_GUB``).

``--train`` trains with the alhashim ``Depth_Loss(0.1, 1, 1)`` recipe on
inverse-depth-norm targets (``src/GuideDepth/training.py:63-66,199-204``)
over ``get_dataloader``'s train split (pinned and copied to the card ahead
of the step), validates on the test split, writes ``checkpoint_{e}`` per
epoch and exports ``best_model`` into ``--save_results``. ``--eval`` scores
the trained (or ``--weights_path``) model in bf16 with the flip-TTA /
Eigen-crop protocol and writes ``results.txt``. ``--data_path synthetic``
or ``synthetic:HxW`` makes a seeded zip.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from tpudepth_torch.core.config import EvalConfig, TrainConfig
from tpudepth_torch.core.runtime import resolve_device
from tpudepth_torch.data.datasets import get_dataloader
from tpudepth_torch.data.synthetic import resolve_data
from tpudepth_torch.eval.evaluator import AlhashimEvaluator
from tpudepth_torch.models.layers import init_random_
from tpudepth_torch.models.registry import GUB_MODES, build_model
from tpudepth_torch.train.checkpoint import load_model_weights
from tpudepth_torch.train.trainer import Trainer, make_eval_step


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="UpSampling for Monocular Depth Estimation (H100)")
    parser.set_defaults(train=False, evaluate=False)
    parser.add_argument("--train", dest="train", action="store_true")
    parser.add_argument("--eval", dest="evaluate", action="store_true")
    parser.add_argument("--data_path", type=str, default="CSVdata.zip")
    parser.add_argument("--test_path", type=str, default="")
    parser.add_argument("--dataset", type=str,
                        choices=["kitti", "nyu", "nyu_reduced"],
                        default="nyu_reduced")
    parser.add_argument("--resolution", type=str,
                        choices=["full", "half", "mini", "tu_small", "tu_big"],
                        default="half")
    parser.add_argument("--eval_mode", type=str, choices=["alhashim", "tu"],
                        default="alhashim")
    parser.add_argument("--model", type=str, default="GuideDepth")
    parser.add_argument("--weights_path", type=str, default=None)
    parser.add_argument("--load_checkpoint", type=str, default="")
    parser.add_argument("--save_checkpoint", type=str, default="./checkpoints")
    parser.add_argument("--save_results", type=str, default="./results")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--learning_rate", type=float, default=1e-4)
    parser.add_argument("--num_epochs", type=int, default=20)
    parser.add_argument("--scheduler_step_size", type=int, default=15)
    parser.add_argument("--num_workers", type=int, default=2)
    parser.add_argument("--steps-per-epoch", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (raises without a card) or 'cpu'")
    parser.add_argument("--gub", type=str, default="plain", choices=GUB_MODES)
    return parser


def train(args, device: torch.device, data_path: str) -> Trainer:
    config = TrainConfig(
        model=args.model, dataset=args.dataset, resolution=args.resolution,
        epochs=args.num_epochs, batch_size=args.batch_size,
        learning_rate=args.learning_rate,
        scheduler_step_size=args.scheduler_step_size,
        eval_mode=args.eval_mode, data_path=data_path,
        checkpoint_dir=args.save_checkpoint, results_dir=args.save_results)
    print("Maximum Depth of Dataset: {}".format(config.max_depth))
    loaders = {split: get_dataloader(
        args.dataset, data_path, split, batch_size=args.batch_size,
        resolution=args.resolution, workers=args.num_workers,
        device=device if split == "train" else None)
        for split in ("train", "val")}
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(config.seed)
        model = build_model(args.model, gub=args.gub)
    trainer = Trainer(config, model=model, device=device,
                      train_loader=loaders["train"], val_loader=loaders["val"])
    trainer.init_state()
    if args.load_checkpoint:
        trainer.restore(args.load_checkpoint)

    def on_epoch_end(epoch, train_avg, val_avg, tr):
        print("{} - Average Training Loss: {:3.4f}".format(
            time.strftime("%H:%M"), train_avg))
        if val_avg is not None:
            print("{} - Average Validation Loss: {:3.4f}".format(
                time.strftime("%H:%M"), tr.val_losses[-1]))
            print(AlhashimEvaluator.format_report(val_avg))

    # per-epoch checkpoints with val_losses and the best epoch's export
    # (src/GuideDepth/training.py:72-86,166-189)
    args.weights_path = trainer.fit(
        epochs=args.num_epochs, steps_per_epoch=args.steps_per_epoch,
        val_max_batches=args.steps_per_epoch or 0, on_epoch_end=on_epoch_end,
        checkpoint_style="per_epoch", export_best=True)
    print("Model saved.")
    return trainer


def evaluate(args, device: torch.device, test_path: str):
    config = EvalConfig(model=args.model, dataset=args.dataset,
                        resolution=args.resolution, eval_mode=args.eval_mode,
                        results_dir=args.save_results)
    print("Resolution for Eval: {}".format(config.image_size))
    print("Maximum Depth of Dataset: {}".format(config.max_depth))
    model = build_model(args.model, gub=args.gub)
    if args.weights_path and os.path.exists(str(args.weights_path)):
        load_model_weights(model, args.weights_path)
    else:
        print("no weights_path; using random init")
        init_random_(model, seed=0)
    model.to(device, memory_format=torch.channels_last)
    test_loader = get_dataloader(args.dataset, test_path, "test", batch_size=1,
                                 resolution=args.resolution,
                                 workers=args.num_workers)
    # the kitti loader yields meters; nyu's 8-bit maps [0,1] x max_depth
    depth_scale = 1.0 if args.dataset == "kitti" else None
    evaluator = AlhashimEvaluator(make_eval_step(model, torch.bfloat16),
                                  config, depth_scale=depth_scale,
                                  device=device)
    avg = evaluator.evaluate(test_loader, save_results_to=args.save_results)
    print(AlhashimEvaluator.format_report(avg))
    return avg


def main(argv=None) -> dict:
    """Run the command line; returns ``weights_path`` and, where they ran,
    the trainer's ``epoch_times`` and ``val_losses`` and the evaluation's
    ``metrics`` (a ``Result``)."""
    args = get_parser().parse_args(argv)
    print(args)
    device = resolve_device(args.device)
    data_path = resolve_data(args.data_path, dataset=args.dataset)
    test_path = (resolve_data(args.test_path, dataset=args.dataset)
                 if args.test_path else data_path)
    os.makedirs(args.save_checkpoint, exist_ok=True)
    os.makedirs(args.save_results, exist_ok=True)
    out = {}
    if args.train:
        trainer = train(args, device, data_path)
        out.update(epoch_times=trainer.epoch_times,
                   val_losses=trainer.val_losses)
        del trainer
    out["weights_path"] = args.weights_path
    if args.evaluate:
        out["metrics"] = evaluate(args, device, test_path)
    return out


if __name__ == "__main__":
    main()
