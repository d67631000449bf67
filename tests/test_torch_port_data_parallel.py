"""Data-parallel training of the port on the CPU: two gloo ranks against one
process on the union batch, and against the JAX package's step on an
8-device ``data`` mesh.

Two ranks are spawned once for the module (``tests/torch_port_dp_worker.py``,
a ``file://`` rendezvous under the module's temporary directory, torch on
one thread each) and run every case; the parent computes the JAX steps and
the single-process ``fit`` meanwhile and then reads what the ranks wrote. A
rank that fails or outlives ``JOIN_TIMEOUT`` is killed and fails the tests.

Cases, 2 float64 steps each, 4 pairs a rank (the union batch is rank 0's
rows then rank 1's), Adam at lr 1e-3; the workers compute the losses in
float64 too (the port's are float32, as the JAX package's):

- ``unet_interp`` with the root recipe at 32x32 (the JAX package's
  ``tests/test_multihost.py`` case): the min-max target's MIN / MAX;
- GuideDepth plain, alhashim, at 64x128 (``GD_HW``): the BatchNorm
  moments' all-reduce;
- GuideDepth ``gub="fused"``: the GUB kernels' plain versions, their sums
  all-reduced;
- GuideDepth plain with ``eval_mode="l1"``: the masked L1's global sums;
- GuideDepth fused with ``remat_stages``: each stage's forward, its
  all-reduces included, runs again in the backward, and the statistics
  move once;
- ``unet_interp`` with augmentation on: the global batch's draws.

Tolerances. Each step is held against the single-process step on the union
batch from the same state (for the second step, the state the two ranks
left, bit-equal on both): the loss, and per tensor the gradients,
parameters, running statistics and Adam moments, within 1e-9 of the
tensor's largest value (the two runs differ by the order of float64 sums).
Tensors whose largest value lies under 1e-6 of the largest of their kind
are held to 1e-9 of that largest instead: the conv biases in front of a
BatchNorm have a zero gradient, and their gradients and moments hold
rounding noise that no two summation orders share; the parameters whose
Adam first moment lies under that floor are held to lr, the most Adam
moves an element. Two steps chained on each side would not do: Adam
divides each gradient by its own size, so an element whose gradient is a
cancellation carries its float64 rounding into the update, and after two
steps one process differs from itself by 5e-9 of a GuideDepth conv weight
when the union batch's rows come in another order. Against JAX:
``torch_port_jax_steps.check_recorded64``'s tolerances (forward and
statistics rtol 1e-3 / atol 1e-4, loss 1e-5, gradients 1e-3 of a tensor's
largest). The 2-rank ``fit`` runs in float32: its epoch and validation
losses equal the single process's to 1e-5 relative (float32 sums in
another order; the validation forward runs 4 rows a rank).
"""

import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
from tpudepth.core.mesh import create_mesh as jax_create_mesh
from torch_port_helpers import one_torch_thread, torch_one_thread  # noqa: F401
from torch_port_jax_steps import (
    BRIDGE,
    batch,
    check_recorded64,
    jax_step64,
    random_variables,
)

from tpudepth_torch.core import mesh as mesh_lib
from tpudepth_torch.core.config import TrainConfig
from tpudepth_torch.losses.losses import DepthLoss, ssim_gaussian
from tpudepth_torch.models.layers import init_random_
from tpudepth_torch.models.registry import build_model
from tpudepth_torch.parallel import host_shard_info, initialize
from tpudepth_torch.train import trainer as ttr

REPO = pathlib.Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_port_dp_worker.py"
WORLD, PER_RANK = 2, 4
UNET_HW = (32, 32)
# GuideDepth at 64x128, not torch_port_helpers.HW (64x96): there a batch of
# 8 sits on a ReLU kink that the float32 pieces of the JAX package's
# float64 step cross, and the gradients differ from JAX's by up to 14 times
# check_step64's tolerance in one process each; a shift of 1e-8 in one
# BatchNorm's batch mean makes them agree
# (tests/test_torch_port_guidedepth_batch8.py holds both)
GD_HW = (64, 128)
JOIN_TIMEOUT = 180
# name: (model, build options, input size, recipe, augment)
CASES = {
    "unet_interp-root": ("unet_interp", {}, UNET_HW, "root", False),
    "guidedepth-alhashim": ("GuideDepth", {}, GD_HW, "alhashim", False),
    "guidedepth-fused": ("GuideDepth", {"gub": "fused"}, GD_HW, "alhashim",
                         False),
    "guidedepth-l1": ("GuideDepth", {}, GD_HW, "l1", False),
    "guidedepth-fused-remat": ("GuideDepth", {"gub": "fused",
                                              "remat_stages": True},
                               GD_HW, "alhashim", False),
    "unet_interp-augment": ("unet_interp", {}, UNET_HW, "root", True),
}
JAX_CASES = ("unet_interp-root", "guidedepth-alhashim")
STEP_REL = 1e-9
LR = 1e-3   # the workers' Adam
FIT_REL = 1e-5


@pytest.fixture(scope="module")
def variables():
    """JAX variables of the two architectures (seeded numpy fills)."""
    return {"unet_interp": random_variables("unet_interp", 3, UNET_HW),
            "GuideDepth": random_variables("GuideDepth", 4, GD_HW)}


def _batches(seed, hw):
    return [batch(seed + s, bsz=WORLD * PER_RANK, hw=hw) for s in range(2)]


def _fit_spec(workdir):
    rng = np.random.default_rng(7)

    def global_batch():
        return {"image": rng.integers(0, 256, (WORLD * PER_RANK, *UNET_HW, 3),
                                      dtype=np.uint8),
                "depth": rng.random((WORLD * PER_RANK, *UNET_HW, 1),
                                    dtype=np.float32) * 0.9 + 0.05}

    config = dict(model="unet_interp", batch_size=WORLD * PER_RANK,
                  learning_rate=1e-3, compute_dtype="float32", seed=5,
                  log_every=1, checkpoint_dir=str(workdir / "ck"),
                  results_dir=str(workdir / "res"))
    weights = init_random_(build_model("unet_interp"), seed=8).state_dict()
    return {"config": config, "weights": weights,
            "train": [global_batch(), global_batch()],
            "val": [global_batch()], "next": global_batch()}


class Ranks:
    """The spawned ranks and the torchrun command line, joined once."""

    def __init__(self, workdir, procs, cli):
        self.workdir, self.procs, self.cli = workdir, procs, cli
        self._results = None

    def _join(self, proc, deadline):
        try:
            proc.wait(timeout=max(deadline - time.time(), 1))
        except subprocess.TimeoutExpired:
            for p in self.procs + [self.cli]:
                p.kill()
            pytest.fail(f"a rank outlived the {JOIN_TIMEOUT} s join timeout")
        return pathlib.Path(proc.log).read_text()

    def results(self):
        if self._results is None:
            deadline = time.time() + JOIN_TIMEOUT
            logs = [self._join(p, deadline) for p in self.procs]
            for p, log in zip(self.procs, logs):
                assert p.returncode == 0, f"rank failed:\n{log[-6000:]}"
            self._results = [torch.load(self.workdir / f"rank{r}.pt",
                                        weights_only=False)
                             for r in range(WORLD)]
            self.cli_log = self._join(self.cli, deadline)
        return self._results


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, variables):
    """Write the cases, start both ranks and the torchrun command line."""
    workdir = tmp_path_factory.mktemp("dp")
    steps = {}
    for name, (model, options, hw, kind, augment) in CASES.items():
        seed = 21 if model == "unet_interp" else 31
        if augment:
            seed += 100
        steps[name] = {"model": model, "options": options, "kind": kind,
                       "augment": augment, "batches": _batches(seed, hw),
                       "weights": BRIDGE[model][0](variables[model])}
    torch.save({"steps": steps, "record": JAX_CASES,
                "fit": _fit_spec(workdir)}, workdir / "cases.pt")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               TPUDEPTH_CACHE_DIR=str(workdir / "cache"))

    def start(args, cwd, log):
        proc = subprocess.Popen(args, cwd=cwd, env=env,
                                stdout=open(log, "w"),
                                stderr=subprocess.STDOUT)
        proc.log = log
        return proc

    procs = [start([sys.executable, str(WORKER), f"file://{workdir}/rdzv",
                    str(WORLD), str(r), str(workdir)], REPO,
                   workdir / f"rank{r}.log") for r in range(WORLD)]
    from tpudepth_torch.data.synthetic import make_synthetic_zip

    cli_dir = workdir / "cli"
    cli_dir.mkdir()
    zip_path = make_synthetic_zip(str(cli_dir / "synth.zip"), n_train=4,
                                  n_test=2, image_hw=UNET_HW)
    cli = start(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(WORLD), "-m", "tpudepth_torch.cli.train",
         "--device", "cpu", "--data", zip_path, "--model", "unet_interp",
         "--dtype", "float32", "--bs", "2", "--epochs", "1",
         "--steps-per-epoch", "1", "--log-dir", str(cli_dir / "runs")],
        cli_dir, workdir / "cli.log")
    handle = Ranks(workdir, procs, cli)
    yield handle
    for p in procs + [cli]:
        if p.poll() is None:
            p.kill()


@pytest.fixture(scope="module")
def jax_want(ranks, variables):
    """The JAX package's float64 step on the union batch, on an 8-device
    ``data`` mesh (computed while the ranks run)."""
    mesh = jax_create_mesh(num_data=8)
    out = {}
    for name in JAX_CASES:
        model, _, hw, kind, _ = CASES[name]
        image, depth = _batches(21 if model == "unet_interp" else 31, hw)[0]
        # GuideDepth unpacked, as the port builds it (the JAX default packs
        # it, with the same parameters; unpacked compiles 3x faster here)
        options = {"packed": False} if model == "GuideDepth" else {}
        out[name] = jax_step64(model, variables[model], image, depth,
                               kind=kind, mesh=mesh, **options)
    return out


class ListLoader:
    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        return iter(self.batches)


@pytest.fixture(scope="module")
def fit_reference(ranks):
    """One process's ``fit`` on the union batches (while the ranks run)."""
    spec = torch.load(ranks.workdir / "cases.pt", weights_only=False)["fit"]
    cfg = TrainConfig(**{**spec["config"],
                         "checkpoint_dir": str(ranks.workdir / "ck_one")})
    model = build_model(cfg.model)
    model.load_state_dict(spec["weights"])
    tr = ttr.Trainer(cfg, model=model, device="cpu",
                     train_loader=ListLoader(spec["train"]),
                     val_loader=ListLoader(spec["val"]))
    epoch_loss = []
    tr.fit(epochs=1,
           on_epoch_end=lambda e, avg, val, t: epoch_loss.append(avg))
    return {"epoch_loss": epoch_loss[0], "val_losses": tr.val_losses,
            "next_loss": float(tr.train_step(spec["next"]))}


@pytest.fixture(scope="module")
def results(ranks, jax_want, fit_reference):
    return ranks.results()


@pytest.mark.parametrize("name", list(CASES))
def test_two_rank_step_equals_one_process_on_the_union_batch(results, name):
    compared = next(r["compared"][name] for r in results
                    if name in r["compared"])
    got, want = compared["loss"]["got"], compared["loss"]["want"]
    assert len(got) == 2 and np.isfinite(want).all()
    for g, w in zip(got, want):
        assert abs(g - w) <= STEP_REL * abs(w), (got, want)
    for i, after in enumerate(compared["after"]):
        for kind in ("grad", "params", "stats", "exp_avg", "exp_avg_sq"):
            c = after[kind]
            assert c["n"] > 10, (i, kind, c)
            assert max(c["rel"], c["floor_rel"]) <= STEP_REL, (i, kind, c)
            # parameters whose gradient is rounding noise: Adam moves each
            # element by at most about lr
            assert c["noise_abs"] <= LR, (i, kind, c)


def test_both_ranks_end_bit_equal(results):
    a, b = results
    assert (a["rank"], b["rank"], a["world"]) == (0, 1, WORLD)
    for name in CASES:
        assert a["steps"][name]["loss"] == b["steps"][name]["loss"], name
        assert a["steps"][name]["digest"] == b["steps"][name]["digest"], name
    assert a["fit"]["digest"] == b["fit"]["digest"]


@pytest.mark.parametrize("name", JAX_CASES)
def test_two_rank_step_equals_the_jax_step_on_a_data_mesh(results, jax_want,
                                                         name):
    rec = results[0]["record"][name]
    want = jax_want[name]
    # the first step's prediction of each rank, in the union batch's order
    pred = torch.cat([r["record"][name]["pred0"] for r in results])
    assert pred.shape[0] == WORLD * PER_RANK
    check_recorded64(want, pred, rec["stats0"], rec["loss"][0],
                     rec["grads0"])


def test_fit_over_two_ranks_equals_one_process(results, fit_reference):
    a, b = (r["fit"] for r in results)
    for key in ("epoch_loss", "val_losses", "next_loss"):
        assert a[key] == b[key], key
    want = fit_reference
    assert a["epoch_loss"] == pytest.approx(want["epoch_loss"], rel=FIT_REL)
    assert a["val_losses"] == pytest.approx(want["val_losses"], rel=FIT_REL)
    assert a["next_loss"] == pytest.approx(want["next_loss"], rel=FIT_REL)
    # rank 0 alone writes files
    assert a["saved"] == ["checkpoint_0"] and b["saved"] == []
    # a 2-rank restore resumes to the same next step
    for r in (a, b):
        assert r["resumed_step"] == 2
        assert r["resumed_loss"] == r["next_loss"]
        assert r["resumed_same_state"]


def test_torchrun_trains_the_root_cli_over_two_cpu_ranks(results, ranks):
    log = ranks.cli_log
    assert ranks.cli.returncode == 0, log[-6000:]
    ck = ranks.workdir / "cli" / "checkpoints"
    assert sorted(os.listdir(ck)) == ["global_checkpoint"], log[-3000:]
    assert log.count("checkpoint saved at:") == 1, log[-3000:]


def test_initialize_and_every_mesh_helper_are_the_identity_at_world_1(
        tmp_path, monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    assert initialize() == (0, 1) and host_shard_info() == (0, 1)
    assert initialize(num_processes=1, device="cpu") == (0, 1)
    assert not torch.distributed.is_initialized()
    x = torch.randn(4, 3, dtype=torch.float64, requires_grad=True)

    def helpers(mesh):
        with mesh_lib.data_axis(mesh):
            axis = mesh_lib.current_axis()
            y = mesh_lib.all_reduce_sum(x * 2, axis)
            y.sum().backward()
        return (y.detach(), x.grad.clone(), mesh_lib.all_reduce_min(x, mesh),
                mesh_lib.all_reduce_max(x, mesh),
                mesh_lib.all_reduce_mean(x, mesh),
                mesh_lib.gather_rows(x, mesh),
                mesh_lib.shard_batch(mesh, {"a": x})["a"],
                mesh_lib.min_of_host_ints(3, mesh))

    def same(got, want):
        for g, w in zip(got, want):
            if isinstance(w, torch.Tensor):
                assert torch.equal(g, w)
            else:
                assert g == w

    mesh = mesh_lib.create_mesh()
    assert (mesh.rank, mesh.world, mesh.collective) == (0, 1, False)
    want = helpers(mesh)
    x.grad = None
    same(want, (x * 2, torch.full_like(x, 2.0), x, x, x, x, x, 3))
    # a group of one runs every collective, each the identity bit for bit
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path}/rdzv", world_size=1, rank=0)
    try:
        mesh = mesh_lib.create_mesh(device="cpu")
        assert mesh.collective and host_shard_info() == (0, 1)
        same(helpers(mesh), want)
        x.grad = None
        lin = torch.nn.Linear(3, 2)
        w0 = lin.weight.detach().clone()
        lin.weight.grad = torch.full_like(w0, 3.0)
        mesh_lib.replicated(mesh, lin)
        mesh_lib.average_gradients(lin.parameters(), mesh)
        assert torch.equal(lin.weight, w0)
        assert torch.equal(lin.weight.grad, torch.full_like(w0, 3.0))
        model = init_random_(build_model("GuideDepth-S", gub="fused"), 9)
        batch_ = batch(4, bsz=2)
        losses = []
        for axis in (None, mesh):
            with one_torch_thread():
                m = build_model("GuideDepth-S", gub="fused")
                m.load_state_dict(model.state_dict())
                state = ttr.TrainState(m, ttr.make_optimizer(
                    TrainConfig(), m.parameters()))
                step = ttr.make_train_step(
                    m, ttr.LossRecipe(), ttr.step_lr(1e-3, 15, 0.1, 10),
                    compute_dtype=torch.float32, augment=True, mesh=axis)
                losses.append((float(step(
                    state, torch.from_numpy(batch_[0]),
                    torch.from_numpy(batch_[1]),
                    torch.Generator().manual_seed(0))), m.state_dict()))
        assert losses[0][0] == losses[1][0]
        for k, v in losses[0][1].items():
            assert torch.equal(v, losses[1][1][k]), k
    finally:
        torch.distributed.destroy_process_group()


def test_num_data_shards_other_than_the_world_raises():
    assert TrainConfig().num_data_shards == 0
    ttr.Trainer(TrainConfig(num_data_shards=1), device="cpu")
    with pytest.raises(ValueError, match="data axis of 2 needs 2 processes"):
        ttr.Trainer(TrainConfig(num_data_shards=2), device="cpu")


def test_batch_size_that_does_not_split_over_the_ranks_raises(monkeypatch):
    two = mesh_lib.DataMesh(0, 2)
    monkeypatch.setattr(mesh_lib, "create_mesh", lambda *a, **k: two)
    with pytest.raises(ValueError, match="batch_size 7 does not split"):
        ttr.Trainer(TrainConfig(batch_size=7), device="cpu")
    with pytest.raises(ValueError, match="7 does not split into 2"):
        mesh_lib.batch_rows(two, 7)


def test_the_ssim_clamp_per_rank_equals_the_clamp_of_the_global_batch():
    """``DepthLoss`` clamps each rank's SSIM term where JAX clamps the
    global batch's: equal while (1 - SSIM) * 0.5 needs no clamp, which
    holds for SSIM in [-1, 1], at random, equal and opposite maps."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.random((4, 1, 24, 32)) * 9 + 0.5)
    for y in (torch.from_numpy(rng.random((4, 1, 24, 32)) * 9 + 0.5),
              x.clone(), 10.0 - x, x * 0.0 + 5.0):
        per_rank = [float(ssim_gaussian(x[i:i + 2], y[i:i + 2], 10.0))
                    for i in (0, 2)]
        whole = float(ssim_gaussian(x, y, 10.0))
        for s in per_rank + [whole]:
            assert -1.0 <= s <= 1.0 + 1e-12
            assert 0.0 <= (1 - s) * 0.5 <= 1.0 or abs(1 - s) < 1e-12
        clamped = np.mean([min(max((1 - s) * 0.5, 0), 1) for s in per_rank])
        assert clamped == pytest.approx(min(max((1 - whole) * 0.5, 0), 1),
                                        rel=1e-12, abs=1e-15)
    loss = DepthLoss(0.1, 1.0, 1.0, 10.0)
    assert float(loss(x, x)) == pytest.approx(0.0, abs=1e-12)


@pytest.mark.parametrize("preset", [None, "TORCH_FR_BUFFER_SIZE",
                                    "TORCH_NCCL_TRACE_BUFFER_SIZE"])
def test_initialize_turns_the_flight_recorder_off_under_nccl_unless_set(
        monkeypatch, preset):
    """NCCL's group starts with torch's flight recorder off unless the
    environment sizes it; gloo's environment is left alone."""
    from tpudepth_torch.parallel import launch

    for key in launch.FLIGHT_RECORDER_ENV + launch.LAUNCHER_ENV:
        # set, then removed: the fixture restores what was there before
        monkeypatch.setenv(key, "")
        monkeypatch.delenv(key)
    if preset:
        monkeypatch.setenv(preset, "2000")
    started = []
    monkeypatch.setattr(launch.dist, "init_process_group",
                        lambda backend, **kw: started.append(backend))
    monkeypatch.setattr(launch, "resolve_device", lambda device: device)
    monkeypatch.setattr(launch.torch.cuda, "set_device", lambda i: None)
    monkeypatch.setattr(launch.torch.cuda, "device_count", lambda: 1)
    initialize("file:///unused", num_processes=1, process_id=0,
               backend="gloo", device="cpu")
    assert started == ["gloo"]
    assert os.environ.get("TORCH_FR_BUFFER_SIZE") == (
        "2000" if preset == "TORCH_FR_BUFFER_SIZE" else None)
    initialize("file:///unused", num_processes=1, process_id=0,
               backend="nccl")
    assert started == ["gloo", "nccl"]
    if preset:
        assert os.environ[preset] == "2000"
        assert ("TORCH_FR_BUFFER_SIZE" in os.environ) == (
            preset == "TORCH_FR_BUFFER_SIZE")
    else:
        assert os.environ["TORCH_FR_BUFFER_SIZE"] == "0"
