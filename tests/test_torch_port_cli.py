"""The port's command lines on the CPU against the JAX package's.

Each of ``tpudepth_torch.cli.{guidedepth_main,train,test,demo}`` and
``tpudepth_torch.inference`` takes the flags and defaults of its JAX twin
(the root ``guidedepth_main.py``, ``train.py``, ``test.py``, ``demo.py``,
``inference.py``, read from their source), runs end to end on
``--device cpu`` over a seeded ``synthetic:48x64`` zip for one or two
steps, and writes the files its twin writes: ``checkpoint_{e}``,
``best_model`` and ``results.txt``; the rolling ``global_checkpoint`` and
TensorBoard's scalars and image grids under the reference's tags;
``inference_results.txt``; the demo PNG. The report files are held
byte-equal to what the JAX package's own writers make of the same metrics.
With ``--device cuda`` and no card each raises.
"""

import ast
import importlib
import os
import pathlib
import sys
import tempfile
import types

import numpy as np
import pytest
import torch

from torch_port_helpers import torch_one_thread  # noqa: F401
from tpudepth.eval.evaluator import AlhashimEvaluator as JaxAlhashimEvaluator
from tpudepth.eval.evaluator import RootEvaluator as JaxRootEvaluator
from tpudepth.eval.metrics import METRIC_NAMES

ROOT = pathlib.Path(__file__).resolve().parents[1]
# port module -> (JAX twin, JAX flags the port leaves out and why)
CLIS = {
    "tpudepth_torch.cli.guidedepth_main": ("guidedepth_main.py", ()),
    "tpudepth_torch.cli.train": ("train.py", ()),
    "tpudepth_torch.cli.test": ("test.py", ()),
    "tpudepth_torch.cli.demo": ("demo.py", ()),
    # --timing has no counterpart: CUDA events leave no dispatch gap
    "tpudepth_torch.inference": ("inference.py", ("--timing",)),
}
DATA = "synthetic:48x64"


def _jax_flags(path):
    """{option strings: add_argument keywords} and set_defaults of a JAX
    command line, from its source."""
    flags, defaults = {}, {}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr == "add_argument":
                opts = tuple(a.value for a in node.args)
                flags[opts] = {k.arg: k.value for k in node.keywords}
            elif node.func.attr == "set_defaults":
                defaults.update({k.arg: ast.literal_eval(k.value)
                                 for k in node.keywords})
    return flags, defaults


@pytest.mark.parametrize("module", sorted(CLIS))
def test_flags_and_defaults_match_the_jax_cli(module):
    twin, left_out = CLIS[module]
    flags, set_defaults = _jax_flags(ROOT / twin)
    parser = importlib.import_module(module).get_parser()
    actions = {tuple(a.option_strings): a for a in parser._actions}
    parsed = vars(parser.parse_args([]))
    assert len(flags) >= 4
    for opts, kw in flags.items():
        if opts[0] in left_out:
            assert opts not in actions
            continue
        assert opts in actions, f"{module} lacks {opts}"
        act = actions[opts]
        dest = (ast.literal_eval(kw["dest"]) if "dest" in kw
                else opts[-1 if len(opts) == 1 else 0].lstrip("-").replace(
                    "-", "_"))
        assert act.dest == dest
        want = (ast.literal_eval(kw["default"]) if "default" in kw
                else set_defaults.get(dest, None))
        assert parsed[dest] == want, (opts, parsed[dest], want)
        if "choices" in kw:
            assert list(act.choices) == ast.literal_eval(kw["choices"]), opts
        if "type" in kw:
            assert act.type.__name__ == kw["type"].id, opts
        if "action" in kw:
            assert ast.literal_eval(kw["action"]) == "store_true"
            assert act.const is True and act.nargs == 0, opts
    assert parsed["device"] == "cuda"


NO_CARD_ARGS = {  # the default --device is cuda
    "tpudepth_torch.cli.guidedepth_main": ["--train", "--data_path", DATA],
    "tpudepth_torch.cli.train": ["--data", DATA],
    "tpudepth_torch.cli.test": ["--data", DATA],
    "tpudepth_torch.cli.demo": [],
    "tpudepth_torch.inference": ["--resolution", "mini"],
}


@pytest.mark.parametrize("module", sorted(CLIS))
def test_every_cli_raises_on_cuda_without_a_card(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = importlib.import_module(module).main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(NO_CARD_ARGS[module])


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A working directory (the CLIs write ``./checkpoints`` there) whose
    temporary directory holds the synthetic zips."""
    root = tmp_path_factory.mktemp("cli")
    (root / "tmp").mkdir()
    cwd, tmp = os.getcwd(), tempfile.tempdir
    os.chdir(root)
    tempfile.tempdir = str(root / "tmp")
    try:
        yield root
    finally:
        os.chdir(cwd)
        tempfile.tempdir = tmp


def _results_txt_of(metrics, tmp_path):
    """What the JAX package's ``AlhashimEvaluator.save_results`` writes for
    ``metrics``."""
    JaxAlhashimEvaluator.save_results(metrics, str(tmp_path))
    return (tmp_path / "results.txt").read_text()


@pytest.mark.parametrize("gub", ("plain", "fused"))
def test_guidedepth_main_trains_and_evaluates_and_writes_its_twins_files(
        workdir, tmp_path, gub):
    from tpudepth_torch.cli import guidedepth_main

    ckpt, res = workdir / f"ck_{gub}", workdir / f"res_{gub}"
    out = guidedepth_main.main([
        "--train", "--eval", "--data_path", DATA, "--resolution", "mini",
        "--batch_size", "4", "--num_epochs", "2", "--steps-per-epoch", "1",
        "--save_checkpoint", str(ckpt), "--save_results", str(res),
        "--gub", gub, "--device", "cpu"])
    # the JAX CLI's files: checkpoint_{e} per epoch, the best epoch's
    # best_model, results.txt (tpudepth/train/trainer.py, eval/evaluator.py)
    assert sorted(os.listdir(ckpt)) == ["checkpoint_0", "checkpoint_1"]
    assert sorted(os.listdir(res)) == ["best_model", "results.txt"]
    assert out["weights_path"] == str(res / "best_model")
    assert len(out["val_losses"]) == 2 and np.all(np.isfinite(out["val_losses"]))
    assert [t["images"] for t in out["epoch_times"]] == [4, 4]
    metrics = out["metrics"]
    assert np.isfinite([metrics.rmse, metrics.mae, metrics.absrel,
                        metrics.lg10, metrics.delta1]).all()
    assert (res / "results.txt").read_text() == _results_txt_of(metrics,
                                                                tmp_path)


class _Writer:
    """Stands in for ``torch.utils.tensorboard.SummaryWriter``: records the
    tags (importing TensorBoard here imports TensorFlow, ~10 s)."""

    made = []

    def __init__(self, log_dir, flush_secs=30):
        self.log_dir, self.tags = log_dir, []
        _Writer.made.append(self)

    def add_scalar(self, tag, value, step):
        assert np.isfinite(value)
        self.tags.append(tag)

    def add_image(self, tag, img, step):
        assert img.ndim == 3 and img.shape[0] in (1, 3)
        self.tags.append(tag)

    def close(self):
        pass


@pytest.fixture(scope="module")
def root_checkpoint(workdir):
    """``cli.train`` for 2 steps of GuideDepth: the rolling checkpoint."""
    from tpudepth_torch.cli import train

    stub = types.ModuleType("torch.utils.tensorboard")
    stub.SummaryWriter = _Writer
    saved = sys.modules.get("torch.utils.tensorboard")
    sys.modules["torch.utils.tensorboard"] = stub
    try:
        out = train.main(["--epochs", "1", "--bs", "4", "--steps-per-epoch",
                          "2", "--data", DATA, "--log-dir", "runs",
                          "--device", "cpu"])
    finally:
        if saved is None:
            del sys.modules["torch.utils.tensorboard"]
        else:
            sys.modules["torch.utils.tensorboard"] = saved
    return out, _Writer.made[-1]


def test_root_train_cli_writes_the_rolling_checkpoint_and_the_tags(
        workdir, root_checkpoint):
    from tpudepth_torch.train.checkpoint import load_checkpoint

    out, writer = root_checkpoint
    assert out["checkpoint"] == str(workdir / "checkpoints" / "global_checkpoint")
    saved = load_checkpoint(out["checkpoint"])
    assert saved["epoch"] == 0 and np.isfinite(saved["loss"])
    assert {"model", "optimizer"} <= set(saved)
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"]).all()
    assert writer.log_dir == os.path.join("runs",
                                          "MobileNetV3_large-e1-bs4-lr0.0001")
    # src/train.py:132,141,170-190: step 0 logs the grids, each epoch's end
    # the average and the grids at step number = epoch (0 here, so the
    # input and depth grids again, as in the JAX command line)
    grids = ["Train.1.Image", "Train.2.Depth", "Train.3.Ours", "Train.3.Diff"]
    assert writer.tags == ["Train/Loss", *grids, "Train/Loss.avg", *grids]


def test_root_test_cli_scores_the_port_checkpoint(root_checkpoint, capsys):
    from tpudepth_torch.cli import test

    metrics = test.main(["--bs", "4", "--data", DATA, "--device", "cpu",
                         "--pt", root_checkpoint[0]["checkpoint"]])
    assert list(metrics) == list(METRIC_NAMES)
    assert np.isfinite(list(metrics.values())).all()
    assert JaxRootEvaluator.format_report(metrics, 2) in capsys.readouterr().out


def test_demo_writes_the_side_by_side_png(workdir, root_checkpoint):
    from PIL import Image

    from tpudepth_torch.cli import demo

    out = demo.main(["--pt", root_checkpoint[0]["checkpoint"], "--out",
                     str(workdir / "demo.png"), "--device", "cpu"])
    assert out["prediction"].shape == (480, 640)
    assert np.isfinite(out["prediction"]).all()
    with Image.open(workdir / "demo.png") as img:
        assert img.size == (1280, 480) and img.mode == "RGB"
    # the prediction is a function on an array: the module imports no Pillow
    tree = ast.parse(pathlib.Path(demo.__file__).read_text())
    assert not [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))
                and "PIL" in ast.unparse(n)]


def test_inference_eval_writes_its_twins_report_files(workdir, tmp_path):
    from tpudepth_torch import inference

    res = workdir / "res_inference"
    out = inference.main(["--eval", "--data_path", DATA, "--resolution",
                          "mini", "--num_test_runs", "0", "--save_results",
                          str(res), "--device", "cpu"])
    assert out["f32"] is None and out["bf16"] is None
    metrics = out["metrics"]
    assert sorted(os.listdir(res)) == ["inference_results.txt", "results.txt"]
    assert (res / "results.txt").read_text() == _results_txt_of(metrics,
                                                                tmp_path)
    lines = (res / "inference_results.txt").read_text().splitlines()
    assert lines == ["backend,s/frame,FPS,img/s,RMSE,Delta1", "torch_f32,,,,,",
                     f"engine_bf16,,,,{metrics.rmse:.3f},{metrics.delta1:.3f}"]
    # the speedtest times the card: on the CPU it refuses
    with pytest.raises(RuntimeError, match="CUDA"):
        inference.main(["--resolution", "mini", "--num_test_runs", "1",
                        "--warm_up_runs", "0", "--device", "cpu"])
