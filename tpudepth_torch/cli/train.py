"""Root training command line: ``python -m tpudepth_torch.cli.train``.

Counterpart of the JAX package's ``train.py`` (``src/train.py:26-31``):
``--epochs --lr --bs --cp`` and the JAX command line's ``--data`` (a zip,
or ``synthetic[:HxW]``), ``--model``, ``--dtype``, ``--log-dir`` and
``--steps-per-epoch``, plus ``--device`` (default ``cuda``). It trains
with the port's ``Trainer`` (GuideDepth with the alhashim recipe, SAM and
NewCRF with the root recipe: 1.0 * SSIM + 0.1 * L1 on min-max targets,
``src/train.py:89-100``) over ``get_training_testing_data``, keeps one
rolling ``./checkpoints/global_checkpoint`` (``--cp 1`` resumes from it,
the port's file or the JAX package's orbax directory of that name)
and logs to TensorBoard under the reference's tags (``src/train.py:48-49,
132,141,170-190``): ``Train/Loss`` every logged step, ``Train/Loss.avg``
every epoch, the image grids ``Train.1.Image``, ``Train.2.Depth``,
``Train.3.Ours`` and ``Train.3.Diff``. The writer is
``torch.utils.tensorboard``'s, or None when that does not import; the
colorized grids need matplotlib and are left out, with a note, without it.

Data parallel: ``torchrun --nproc_per_node N -m tpudepth_torch.cli.train
...`` trains over N processes (NCCL on the cards, ``cuda:LOCAL_RANK`` each;
gloo with ``--device cpu``), ``--bs`` the global batch, each rank loading
its shard of the train split; rank 0 alone prints, logs and saves.
"""

from __future__ import annotations

import argparse
import datetime
import importlib.util
import os

import numpy as np
import torch

from tpudepth_torch.core.config import TrainConfig
from tpudepth_torch.core.runtime import resolve_device
from tpudepth_torch.data.nyu import get_training_testing_data
from tpudepth_torch.data.synthetic import resolve_data
from tpudepth_torch.eval.metrics import ScalarMeter
from tpudepth_torch.losses.losses import depth_norm_minmax
from tpudepth_torch.parallel.launch import default_device, initialize, shutdown
from tpudepth_torch.train.trainer import Trainer, make_eval_step
from tpudepth_torch.utils.viz import colorize, make_grid


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="High Quality Monocular Depth Estimation via Transfer "
                    "Learning (H100)")
    parser.add_argument("--epochs", default=30, type=int,
                        help="number of total epochs to run")
    parser.add_argument("--lr", "--learning-rate", default=0.0001, type=float,
                        help="initial learning rate")
    parser.add_argument("--bs", default=3, type=int, help="batch size")
    parser.add_argument("--cp", default=0, type=int,
                        help="1 to enable usage of the last checkpoint")
    parser.add_argument("--data", default="CSVdata.zip", type=str,
                        help="dataset zip path, or 'synthetic'")
    parser.add_argument("--model", default="GuideDepth", type=str)
    parser.add_argument("--dtype", default="bfloat16", type=str)
    parser.add_argument("--log-dir", default="runs", type=str)
    parser.add_argument("--steps-per-epoch", default=0, type=int,
                        help="truncate epochs (smoke runs)")
    parser.add_argument("--device", default="cuda", type=str,
                        help="'cuda' (raises without a card) or 'cpu'")
    return parser


def make_writer(log_dir: str):
    """``torch.utils.tensorboard``'s ``SummaryWriter``, or None when it does
    not import (the JAX command line's ``except ImportError``)."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir=log_dir, flush_secs=30)


def log_progress(trainer: Trainer, test_loader, writer, niter: int):
    """TensorBoard image grids with the reference's tags (``LogProgress``,
    ``src/train.py:160-190``): Train.1.Image / Train.2.Depth at step 0,
    Train.3.Ours / Train.3.Diff on every call."""
    sample = next(iter(test_loader))
    img = np.asarray(sample["image"])
    depth = np.asarray(sample["depth"])
    if niter == 0:
        writer.add_image("Train.1.Image", make_grid(img, normalize=True), niter)
        writer.add_image("Train.2.Depth", colorize(make_grid(depth)), niter)
    image = torch.from_numpy(img).to(trainer.device).permute(0, 3, 1, 2)
    pred = make_eval_step(trainer.model, trainer.compute_dtype)(image)
    pred_n = depth_norm_minmax(pred).permute(0, 2, 3, 1).cpu().numpy()
    writer.add_image("Train.3.Ours", colorize(make_grid(pred_n)), niter)
    if pred_n.shape == depth.shape:
        writer.add_image("Train.3.Diff",
                         colorize(make_grid(np.abs(pred_n - depth))), niter)


def main(argv=None) -> dict:
    """Run the command line; returns the checkpoint's path, the logged
    losses and the trainer's ``epoch_times``."""
    args = get_parser().parse_args(argv)
    resolve_device(args.device)   # raises on cuda without a card
    started = not torch.distributed.is_initialized()
    rank, world = initialize(device=args.device)
    device = default_device(None if args.device == "cuda" else args.device)
    if args.bs % world:
        raise ValueError(f"--bs {args.bs} does not split into {world} ranks")
    # rank 0 alone prints, logs to TensorBoard and saves
    say = print if rank == 0 else (lambda *a, **k: None)
    zip_path = resolve_data(args.data)
    config = TrainConfig(model=args.model, epochs=args.epochs,
                         batch_size=args.bs, learning_rate=args.lr,
                         compute_dtype=args.dtype, data_path=zip_path)
    say(f"Device: {device}")
    train_loader, test_loader = get_training_testing_data(
        args.bs // world, zip_path, device=device, shard=rank,
        num_shards=world)
    say("Model created.")

    # TensorBoard with the reference's tags (src/train.py:48-49,132,141)
    writer = None if rank else make_writer(os.path.join(
        args.log_dir, f"MobileNetV3_large-e{args.epochs}-bs{args.bs}-lr{args.lr}"))
    images = (writer is not None
              and importlib.util.find_spec("matplotlib") is not None)
    if writer is not None and not images:
        say("matplotlib is not installed: TensorBoard gets the scalars and "
            "no image grids")
    trainer = Trainer(config, device=device, train_loader=train_loader,
                      val_loader=test_loader, writer=writer)
    trainer.init_state()

    ckpt_path = os.path.abspath("./checkpoints/global_checkpoint")
    if args.cp == 1:
        say("starting training from the last checkpoint")
        restored = trainer.restore(ckpt_path)
        # the root schema stores the completed epoch (src/train.py:59-68)
        trainer.set_resume_epoch(trainer.epoch + 1)
        say("epoch started:", trainer.epoch)
        say("loss started:", restored.get("loss", 0.0))

    losses, batch_time = ScalarMeter(), ScalarMeter()
    logged = []

    def log_fn(epoch, loader_pos, steps_total, loss_f, dt, niter):
        if loader_pos == 0:  # fresh meters each epoch (src/train.py:74-79)
            losses.reset()
            batch_time.reset()
        losses.update(loss_f, args.bs)
        batch_time.update(dt)
        logged.append(loss_f)
        eta = str(datetime.timedelta(
            seconds=int(batch_time.val * (steps_total - loader_pos))))
        print(f"Epoch: [{epoch}][{loader_pos}/{steps_total}]\t"
              f"Time {batch_time.val:.3f} ({batch_time.sum:.3f})\t"
              f"ETA {eta}\tLoss {losses.val:.4f} ({losses.avg:.4f})")
        if writer:
            writer.add_scalar("Train/Loss", losses.val, niter)

    def image_log_fn(niter):
        if images:
            say("Recording epoch`s intermediate results. %300")
            log_progress(trainer, test_loader, writer, niter)

    def on_epoch_end(epoch, train_avg, val_avg, tr):
        if writer:
            writer.add_scalar("Train/Loss.avg", losses.avg, epoch)
        if images:
            log_progress(trainer, test_loader, writer, epoch)
        say("saving a checkpoint.")

    trainer.val_loader = None  # the root recipe logs images, no validation
    try:
        trainer.fit(epochs=args.epochs, steps_per_epoch=args.steps_per_epoch,
                    log_fn=log_fn, image_log_fn=image_log_fn,
                    on_epoch_end=on_epoch_end, checkpoint_style="rolling")
    finally:
        if writer:
            writer.close()
        if started:   # leave only the group this command joined
            shutdown()
    say("checkpoint saved at:", ckpt_path)
    return {"checkpoint": ckpt_path, "losses": logged,
            "epoch_times": trainer.epoch_times}


if __name__ == "__main__":
    main()
