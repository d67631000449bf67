"""``Trainer.fit`` of the port on the CPU with a tiny in-memory loader
(GuideDepth-S at 64x64, f32): the loss falls on a fixed batch, the epoch
loss is the exact sample-weighted mean, both checkpoint schemas round-trip,
a resumed run reproduces the uninterrupted one with StepLR aligned (the
mirror of ``tests/test_fit_resume.py``), the best model is the argmin of the
validation losses, and the small modules the loop needs agree with the JAX
package's (metrics, config defaults, precision names).
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpudepth.core.config import TrainConfig as JaxTrainConfig
from tpudepth.eval.metrics import AverageMeter as JaxAverageMeter
from tpudepth.eval.metrics import Result as JaxResult
from tpudepth_torch import Trainer
from tpudepth_torch.core.config import TrainConfig
from tpudepth_torch.core.precision import Precision
from tpudepth_torch.eval.metrics import AverageMeter, Result
from tpudepth_torch.models.registry import build_model
from tpudepth_torch.train.checkpoint import load_checkpoint, save_checkpoint
from tpudepth_torch.utils.profiling import StepTimer
from torch_port_helpers import torch_one_thread  # noqa: F401

HW = (64, 64)


class Loader:
    """``n`` fixed batches of raw uint8 images with float depth in [0, 1]."""

    def __init__(self, n, bs, seed, sizes=None):
        rng = np.random.default_rng(seed)
        sizes = sizes or [bs] * n
        self.batches = [
            {"image": rng.integers(0, 256, (b, *HW, 3), dtype=np.uint8),
             "depth": rng.random((b, *HW, 1), dtype=np.float32) * 0.9 + 0.05}
            for b in sizes]
        self.epochs_set = []

    def __len__(self):
        return len(self.batches)

    def set_epoch(self, epoch):
        self.epochs_set.append(epoch)

    def __iter__(self):
        return iter(self.batches)


def _trainer(tmp_path, tag="a", n_train=2, lr=1e-3, step_size=15):
    cfg = TrainConfig(model="GuideDepth-S", dataset="nyu_reduced",
                      resolution="half", epochs=2, batch_size=2,
                      learning_rate=lr, scheduler_step_size=step_size,
                      compute_dtype="float32", seed=3,
                      checkpoint_dir=str(tmp_path / f"ck_{tag}"),
                      results_dir=str(tmp_path / f"res_{tag}"))
    return Trainer(cfg, device="cpu", train_loader=Loader(n_train, 2, 0),
                   val_loader=Loader(1, 2, 1))


def _params(trainer):
    return {k: v.clone() for k, v in trainer.model.state_dict().items()}


def test_loss_decreases_on_a_fixed_batch(tmp_path):
    tr = _trainer(tmp_path)
    tr.init_state()
    batch = tr.train_loader.batches[0]
    same_draw = torch.Generator()   # one augmentation draw for every step
    losses = [tr.train_step(batch, same_draw.manual_seed(0)) for _ in range(8)]
    assert all(isinstance(x, torch.Tensor) and x.dim() == 0 for x in losses)
    losses = [float(x) for x in losses]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    assert tr.state.step == 8


def test_epoch_loss_is_the_exact_sample_weighted_mean(tmp_path):
    tr = _trainer(tmp_path)
    tr.train_loader = Loader(3, 2, 0, sizes=[2, 2, 1])
    tr.steps_per_epoch = 3
    tr.init_state()
    seen = []
    real_step = tr.train_step
    tr.train_step = lambda batch: seen.append(real_step(batch)) or seen[-1]
    logged = []
    avg = tr.train_epoch(log_fn=lambda *a: logged.append(a))
    want = sum(float(x) * b for x, b in zip(seen, [2, 2, 1])) / 5
    assert avg == pytest.approx(want, rel=1e-6)
    assert [a[1] for a in logged] == [0]      # log_every = 5: step 0 only
    assert tr.train_epoch(steps_cap=1) == pytest.approx(float(seen[-1]), rel=1e-6)


def test_fit_checkpoints_resume_and_best_model(tmp_path):
    # uninterrupted: 2 epochs, per-epoch checkpoints, StepLR drops at epoch 1
    full = _trainer(tmp_path, "a", step_size=1)
    state = full.fit(epochs=2, val_max_batches=1, checkpoint_style="per_epoch")
    assert state is full.state and full.epoch == 2 and state.step == 4
    assert full.train_loader.epochs_set == [0, 1]
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(1e-4)
    ck_a = tmp_path / "ck_a"
    assert (ck_a / "checkpoint_0").exists() and (ck_a / "checkpoint_1").exists()
    c1 = load_checkpoint(str(ck_a / "checkpoint_1"))
    assert int(c1["epoch"]) == 2
    assert len(c1["val_losses"]) == 2
    assert all(np.isfinite(v) for v in c1["val_losses"])
    for k, v in full.model.state_dict().items():
        assert torch.equal(c1["model"][k], v), k

    # interrupted after epoch 0, resumed by a fresh trainer
    first = _trainer(tmp_path, "b", step_size=1)
    first.fit(epochs=1, val_max_batches=1, checkpoint_style="per_epoch")
    second = _trainer(tmp_path, "b", step_size=1)
    second.init_state()
    second.restore(str(tmp_path / "ck_b" / "checkpoint_0"))
    assert second.epoch == 1 and second.state.step == 2
    assert len(second.val_losses) == 1
    second.fit(epochs=2, val_max_batches=1, checkpoint_style="per_epoch")
    assert second.state.optimizer.param_groups[0]["lr"] == pytest.approx(1e-4)
    for k, v in full.model.state_dict().items():
        torch.testing.assert_close(second.model.state_dict()[k], v,
                                   atol=1e-6, rtol=0, msg=k)
    assert second.val_losses == pytest.approx(full.val_losses, abs=1e-5)

    # best model: the argmin of the validation losses
    second.val_losses = [0.5, 0.9]
    best = load_checkpoint(second.export_best_model())
    assert int(best["best_epoch"]) == 0
    assert best["val_loss"] == pytest.approx(0.5)
    c0 = load_checkpoint(str(tmp_path / "ck_b" / "checkpoint_0"))
    for k, v in c0["model"].items():
        assert torch.equal(best["model"][k], v), k
    second.val_losses = []
    current = load_checkpoint(second.export_best_model())
    assert "val_loss" not in current and int(current["best_epoch"]) == 2

    # root rolling schema
    full.save_rolling_checkpoint(epoch=1, loss=0.123)
    ck = load_checkpoint(str(ck_a / "global_checkpoint"))
    assert int(ck["epoch"]) == 1 and ck["loss"] == pytest.approx(0.123)
    assert "model" in ck and "optimizer" in ck


def test_fit_rolling_style_and_on_epoch_end(tmp_path):
    tr = _trainer(tmp_path, "r")
    calls = []
    tr.fit(epochs=1, steps_per_epoch=1, checkpoint_style="rolling",
           on_epoch_end=lambda e, avg, val, t: calls.append((e, avg, val, t)))
    assert tr.state.step == 1          # steps_per_epoch caps the epoch
    (epoch, avg, val, who), = calls
    assert epoch == 0 and np.isfinite(avg) and who is tr
    assert isinstance(val, Result) and np.isfinite(val.rmse) and val.delta1 >= 0
    ck = load_checkpoint(str(tmp_path / "ck_r" / "global_checkpoint"))
    assert int(ck["epoch"]) == 0 and ck["loss"] == pytest.approx(avg)


def test_set_resume_epoch_aligns_the_step(tmp_path):
    tr = _trainer(tmp_path, "s")
    tr.init_state()
    tr.save_rolling_checkpoint(epoch=3, loss=0.5)
    tr2 = _trainer(tmp_path, "s")
    tr2.init_state()
    tr2.restore(str(tmp_path / "ck_s" / "global_checkpoint"))
    assert tr2.epoch == 3
    tr2.set_resume_epoch(tr2.epoch + 1)
    assert tr2.epoch == 4
    assert tr2.state.step == 4 * tr2.steps_per_epoch


def test_augmentation_stream_depends_on_seed_and_step_only(tmp_path):
    a, b = _trainer(tmp_path, "x"), _trainer(tmp_path, "y")
    a.init_state()
    b.init_state()
    batch = a.train_loader.batches[0]
    b.train_step(b.train_loader.batches[1])     # other history, same step next
    b.state.step = 0
    b.model.load_state_dict(a.model.state_dict())
    b.state.optimizer.load_state_dict(a.state.optimizer.state_dict())
    assert float(a.train_step(batch)) == float(b.train_step(batch))


def test_own_model_is_initialized_from_the_seed_and_a_given_one_is_kept(tmp_path):
    a, b = _trainer(tmp_path, "i"), _trainer(tmp_path, "j")
    a.init_state()
    b.init_state()
    for (k, v), w in zip(_params(a).items(), _params(b).values()):
        assert torch.equal(v, w), k
    given = build_model("GuideDepth-S")
    want = {k: v.clone() for k, v in given.state_dict().items()}
    tr = Trainer(a.config, model=given, device="cpu",
                 train_loader=Loader(1, 2, 0))
    tr.init_state()
    for k, v in want.items():
        assert torch.equal(given.state_dict()[k], v), k


def test_fit_with_a_fused_model_checkpoints_and_restores(tmp_path):
    """``Trainer.fit`` on a ``gub="fused"`` model: finite losses that match
    the plain model's from the same weights (f32: the first step rel 1e-5,
    the stages differ in rounding only; after an Adam step, which moves every
    element by ``lr * sign(g)`` even where ``g`` is rounding noise, rel
    1e-2), a checkpoint, and a fresh fused trainer that restores it and takes
    the next step with the same loss, bit for bit."""
    torch.manual_seed(0)
    weights = build_model("GuideDepth-S").state_dict()

    def trainer(tag, gub):
        base = _trainer(tmp_path, tag)
        model = build_model("GuideDepth-S", gub=gub)
        model.load_state_dict(weights)
        return Trainer(base.config, model=model, device="cpu",
                       train_loader=base.train_loader,
                       val_loader=base.val_loader)

    losses = {}
    for gub in ("fused", "plain"):
        tr = trainer(f"fit_{gub}", gub)
        seen = []
        tr.config.log_every = 1
        tr.fit(epochs=1, val_max_batches=1, checkpoint_style="per_epoch",
               log_fn=lambda e, i, n, loss, dt, it: seen.append(loss))
        losses[gub] = seen + tr.val_losses
        if gub == "fused":
            fused = tr
    assert len(losses["fused"]) == 3 and np.isfinite(losses["fused"]).all()
    assert losses["fused"][0] == pytest.approx(losses["plain"][0], rel=1e-5)
    assert losses["fused"] == pytest.approx(losses["plain"], rel=1e-2)

    assert fused.state.step == 2 and fused.epoch == 1
    fresh = trainer("fit_fused", "fused")
    fresh.init_state()
    fresh.restore(str(tmp_path / "ck_fit_fused" / "checkpoint_0"))
    assert fresh.epoch == 1 and fresh.state.step == 2
    assert fresh.val_losses == fused.val_losses
    batch = fused.train_loader.batches[0]
    assert float(fresh.train_step(batch)) == float(fused.train_step(batch))
    for k, v in fused.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k


def test_the_card_is_the_default_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(TrainConfig(model="GuideDepth-S"))


def test_l1_recipe_when_eval_mode_is_not_alhashim(tmp_path):
    tr = _trainer(tmp_path, "l")
    cfg = dataclasses.replace(tr.config, eval_mode="eigen")
    tr = Trainer(cfg, device="cpu", train_loader=Loader(1, 2, 0))
    assert tr.recipe.kind == "l1" and tr.recipe.depth_scale == 10.0
    kitti = Trainer(dataclasses.replace(cfg, dataset="kitti", resolution="full"),
                    device="cpu")
    assert kitti.recipe.depth_scale == 1.0 and kitti.recipe.max_depth == 80.0


def test_checkpoint_round_trip(tmp_path):
    payload = {"epoch": 3, "val_losses": [0.5, 0.25],
               "model": {"w": torch.arange(6.0).view(2, 3)}}
    path = save_checkpoint(str(tmp_path / "deep" / "dir" / "ck"), payload)
    back = load_checkpoint(path)
    assert back["epoch"] == 3 and back["val_losses"] == [0.5, 0.25]
    assert torch.equal(back["model"]["w"], payload["model"]["w"])
    assert [p.name for p in (tmp_path / "deep" / "dir").iterdir()] == ["ck"]


def test_result_and_average_meter_match_the_jax_package():
    rng = np.random.default_rng(0)
    ours, theirs = AverageMeter(), JaxAverageMeter()
    for n in (1, 3):
        out = rng.random(500) * 9 + 0.5
        gt = rng.random(500) * 9 + 0.5
        r, jr = Result(), JaxResult()
        r.evaluate(out, gt)
        jr.evaluate(out, gt)
        assert vars(r) == vars(jr)
        ours.update(r, 0.25, 0.5, n)
        theirs.update(jr, 0.25, 0.5, n)
    assert vars(ours.average()) == vars(theirs.average())
    worst = Result()
    worst.set_to_worst()
    assert worst.rmse == np.inf and worst.delta1 == 0.0


def test_train_config_keeps_the_jax_package_defaults():
    ours = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxTrainConfig)}
    dropped = set()
    assert set(theirs) - set(ours) == dropped
    assert {k: theirs[k] for k in ours} == ours
    cfg = TrainConfig(dataset="kitti", resolution="half")
    assert cfg.max_depth == 80.0 and cfg.image_size == (192, 640)


@pytest.mark.parametrize("name,dtype", [
    ("bf16", torch.bfloat16), ("bfloat16", torch.bfloat16), ("", torch.bfloat16),
    ("f32", torch.float32), ("float32", torch.float32), ("FP32", torch.float32)])
def test_precision_names(name, dtype):
    p = Precision.from_str(name)
    assert p.compute_dtype == dtype and p.param_dtype == torch.float32


def test_precision_rejects_unknown_names():
    with pytest.raises(ValueError):
        Precision.from_str("fp8")


def test_step_timer_splits_data_and_compute_time():
    timer = StepTimer()
    timer.data_done()
    timer.step_done(sync_on=torch.zeros(1))
    timer.data_done()
    timer.step_done()
    s = timer.summary()
    assert s["steps"] == 2
    assert s["data_time_per_step"] >= 0 and s["compute_time_per_step"] >= 0
