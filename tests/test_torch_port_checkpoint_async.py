"""Asynchronous checkpoint saves of the port (``train/checkpoint.py``), the
counterpart of the JAX package's orbax ``AsyncCheckpointer``
(``tpudepth/train/checkpoint.py:29-59``, ``Trainer.fit``'s wait at
``tpudepth/train/trainer.py:628-653``).

The background writer is held at a gate (``_write`` wrapped to wait on an
event) where a test needs a save still in flight: the caller then changes
the state, loads the path, removes the directory or ends ``fit`` while the
write has not started.
"""

import threading

import numpy as np
import pytest
import torch
from torch_port_helpers import one_torch_thread

from tpudepth_torch.core.config import TrainConfig
from tpudepth_torch.models.layers import init_random_
from tpudepth_torch.models.registry import build_model
from tpudepth_torch.train import checkpoint as ck
from tpudepth_torch.train.trainer import Trainer


@pytest.fixture
def gate(monkeypatch):
    """An event the writer waits on before each write (opened at the end
    of the test at the latest)."""
    opened = threading.Event()
    real = ck._write

    def held(path, payload):
        assert opened.wait(timeout=60)
        real(path, payload)

    monkeypatch.setattr(ck, "_write", held)
    yield opened
    opened.set()
    ck.wait_for_checkpoints()


def test_the_file_holds_the_state_at_the_call(tmp_path, gate):
    lin = torch.nn.Linear(3, 2)
    want = {k: v.clone() for k, v in lin.state_dict().items()}
    steps = torch.arange(4.0)
    path = ck.save_checkpoint(str(tmp_path / "ck"),
                              {"model": lin.state_dict(), "epoch": 1,
                               "history": [steps, 0.5]})
    with torch.no_grad():
        lin.weight.add_(1.0)
        lin.bias.zero_()
    steps.mul_(10)
    assert not (tmp_path / "ck").exists()
    gate.set()
    ck.wait_for_checkpoints()
    back = torch.load(path, weights_only=True)
    assert back["epoch"] == 1
    for k, v in want.items():
        assert torch.equal(back["model"][k], v), k
    assert torch.equal(back["history"][0], torch.arange(4.0))
    assert back["history"][1] == 0.5
    # written beside the target and renamed: nothing else is left
    assert [p.name for p in tmp_path.iterdir()] == ["ck"]


def test_load_of_a_path_being_saved_waits_for_it(tmp_path, gate):
    path = ck.save_checkpoint(str(tmp_path / "ck"),
                              {"epoch": 7, "model": {"w": torch.ones(2)}})
    assert not (tmp_path / "ck").exists()
    threading.Timer(0.2, gate.set).start()
    back = ck.load_checkpoint(path)
    assert gate.is_set()
    assert back["epoch"] == 7 and torch.equal(back["model"]["w"],
                                              torch.ones(2))


def test_a_failed_save_raises_at_the_wait(tmp_path, gate):
    target = tmp_path / "gone" / "ck"
    ck.save_checkpoint(str(target), {"epoch": 1})
    (tmp_path / "gone").rmdir()
    gate.set()
    # torch.save names the missing directory
    with pytest.raises((OSError, RuntimeError), match="gone"):
        ck.wait_for_checkpoints()
    # reported once; the next wait has nothing to report
    ck.wait_for_checkpoints()
    assert not (tmp_path / "gone").exists()


def test_two_saves_to_one_path_land_in_order(tmp_path, gate):
    for i in range(1, 4):
        ck.save_checkpoint(str(tmp_path / "ck"),
                           {"epoch": i, "w": torch.full((3,), float(i))})
    gate.set()
    ck.wait_for_checkpoints()
    back = torch.load(tmp_path / "ck", weights_only=True)
    assert back["epoch"] == 3 and torch.equal(back["w"], torch.full((3,), 3.))
    assert [p.name for p in tmp_path.iterdir()] == ["ck"]


def test_a_blocking_save_is_on_disk_when_it_returns(tmp_path):
    path = ck.save_checkpoint(str(tmp_path / "a" / "ck"), {"epoch": 2},
                              blocking=True)
    assert torch.load(path, weights_only=True) == {"epoch": 2}


class _Loader:
    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.batches = [{"image": rng.random((2, 32, 32, 3), np.float32),
                         "depth": rng.random((2, 32, 32, 1), np.float32)
                         * 0.9 + 0.05} for _ in range(n)]

    def __len__(self):
        return len(self.batches)

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        return iter(self.batches)


def test_fit_returns_with_every_epoch_file_on_disk(tmp_path, gate):
    cfg = TrainConfig(model="unet_interp", batch_size=2, epochs=3,
                      learning_rate=1e-3, compute_dtype="float32",
                      checkpoint_dir=str(tmp_path / "ck"), log_every=1)
    model = init_random_(build_model("unet_interp"), seed=3)
    tr = Trainer(cfg, model=model, device="cpu", train_loader=_Loader(1, 4))
    states = []

    def at_epoch_end(epoch, avg, val, trainer):
        states.append({k: v.clone() for k, v in
                       trainer.model.state_dict().items()})
        if epoch == 2:
            # the writer starts once the loop is over: fit must wait
            threading.Timer(0.2, gate.set).start()

    with one_torch_thread():
        tr.fit(checkpoint_style="per_epoch", on_epoch_end=at_epoch_end)
    assert gate.is_set()
    for epoch, want in enumerate(states):
        back = torch.load(tmp_path / "ck" / f"checkpoint_{epoch}",
                          weights_only=True)
        assert back["epoch"] == epoch + 1
        for k, v in want.items():
            assert torch.equal(back["model"][k], v), (epoch, k)
    # the epochs' states differ, so each file is its own epoch's
    assert not torch.equal(states[0]["conv3.weight"],
                           states[2]["conv3.weight"])
