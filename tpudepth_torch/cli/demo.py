"""Single-image demo: ``python -m tpudepth_torch.cli.demo``.

Counterpart of the JAX package's ``demo.py`` (the reference's
``src/demo.py``, which is broken in its snapshot): a checkpoint the port
wrote, a JAX orbax checkpoint directory of ``--model`` or a reference
``.pth`` (or a random model when ``--pt`` does not exist), one RGB image
(``--image``, resized to 640x480; a synthetic gradient without it), the
prediction in bf16, and the input beside its colorized depth saved as
``--out``. :func:`predict_depth` is the prediction on an array alone, so it
runs without Pillow; reading the image and writing the PNG need Pillow and
matplotlib.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from tpudepth_torch.core.runtime import DeviceLike, resolve_device
from tpudepth_torch.models.layers import init_random_
from tpudepth_torch.models.registry import build_model
from tpudepth_torch.train.checkpoint import load_model_weights
from tpudepth_torch.train.trainer import make_eval_step


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="tpudepth_torch single-image demo")
    parser.add_argument("--image", default="", type=str, help="input RGB image")
    parser.add_argument("--pt", default="./checkpoints/global_checkpoint",
                        type=str)
    parser.add_argument("--model", default="GuideDepth", type=str)
    parser.add_argument("--out", default="demo_out.png", type=str)
    parser.add_argument("--device", default="cuda", type=str,
                        help="'cuda' (raises without a card) or 'cpu'")
    return parser


def predict_depth(model: torch.nn.Module, image: np.ndarray,
                  device: DeviceLike = None,
                  compute_dtype: torch.dtype = torch.bfloat16) -> np.ndarray:
    """The raw prediction ``[H, W]`` (float32) of ``model`` for one RGB
    image ``[H, W, 3]`` with values in [0, 1]."""
    device = resolve_device(device)
    model.to(device, memory_format=torch.channels_last)
    x = torch.from_numpy(np.ascontiguousarray(image, np.float32))
    x = x.permute(2, 0, 1)[None].to(device)
    return make_eval_step(model, compute_dtype)(x)[0, 0].cpu().numpy()


def main(argv=None) -> dict:
    """Run the command line; returns the prediction and the output path."""
    args = get_parser().parse_args(argv)
    device = resolve_device(args.device)
    from PIL import Image

    from tpudepth_torch.utils.viz import colorize_cpu

    if args.image:
        img = Image.open(args.image).convert("RGB").resize((640, 480))
        x = np.asarray(img, np.float32) / 255.0
    else:
        print("no --image given; using a synthetic gradient sample")
        yy, xx = np.mgrid[0:480, 0:640]
        x = np.stack([xx / 640, yy / 480, np.ones_like(xx) * 0.5],
                     -1).astype(np.float32)

    model = build_model(args.model)
    if os.path.exists(args.pt):
        load_model_weights(model, args.pt, args.model)
    else:
        print(f"checkpoint {args.pt} not found; using random init")
        init_random_(model, seed=0)
    pred = predict_depth(model, x, device)
    print("prediction:", pred.shape, "min", pred.min(), "max", pred.max())

    rgb = Image.fromarray((x * 255).astype(np.uint8))
    dep = colorize_cpu(pred).convert("RGB").resize(rgb.size)
    side = Image.new("RGB", (rgb.width * 2, rgb.height))
    side.paste(rgb, (0, 0))
    side.paste(dep, (rgb.width, 0))
    side.save(args.out)
    print("wrote", args.out)
    return {"prediction": pred, "out": args.out}


if __name__ == "__main__":
    main()
