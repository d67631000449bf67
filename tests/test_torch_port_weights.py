"""Weight I/O of the port against the JAX package, on the CPU.

- ``train/orbax_io.py::read_orbax`` against ``tpudepth.train.checkpoint.
  load_checkpoint`` without a target, leaf for leaf and bit for bit, on the
  three files one JAX ``Trainer`` writes (``save_epoch_checkpoint``,
  ``save_rolling_checkpoint``, ``export_best_model``), on SAM's
  ``optax.multi_transform`` state (written with ``make_optimizer(...).init``
  and ``save_checkpoint``) and on orbax's four storage layouts;
- ``jax_weights.state_dict_from_flax`` against each family function, and a
  converted JAX checkpoint served against JAX's forward (rtol 1e-3 / atol
  1e-4, the bridge's tolerance);
- one Adam update after the restore against optax's update from the
  restored state in float64, for ``optax.adam`` and the frozen-encoder
  layout: parameters rtol 1e-12 (atol 1e-12 of the learning rate),
  moments to 1e-12 of their tensor's
  largest (float64 rounding of two orders of the same operations),
  ``step`` equal to ``count``;
- ``Trainer.restore`` of a JAX checkpoint against the JAX trainer's own
  ``restore`` (both schemas, packed and unpacked GuideDepth): step,
  learning rate, ``val_losses``, parameters, statistics and Adam state
  equal;
- ``train/jax_state.py`` on malformed JAX states, reference ``.pth`` files against JAX's ``convert_*``
  (forwards at rtol 1e-3 / atol 1e-4), Keras ``.h5`` against JAX's walk,
  and reading without ``tensorstore`` / ``h5py``.

The JAX trainer is built once and takes no train step: its state holds
seeded weights and a seeded Adam state at count 3 (one epoch of three
steps), so no train step compiles.
"""

import copy
import functools
import sys
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
import torch.nn as nn

import tpudepth.models.keras_import as jax_keras
from tpudepth.core.config import TrainConfig as JaxTrainConfig
from tpudepth.core.mesh import create_mesh
from tpudepth.models import build_model as jax_build_model
from tpudepth.models.ddrnet import DualResNetBackbone
from tpudepth.models.mobilenetv3 import MobileNetV3Features
from tpudepth.models.torch_import import (
    convert_attention_model,
    convert_ddrnet,
    convert_guidedepth,
    convert_mobilenetv3,
)
from tpudepth.train import trainer as jtr
from tpudepth.train.checkpoint import load_checkpoint as jax_load_checkpoint
from tpudepth.train.checkpoint import save_checkpoint as jax_save_checkpoint
from tpudepth.train.checkpoint import wait_for_checkpoints
from torch_port_helpers import one_torch_thread, torch_one_thread  # noqa: F401
from torch_port_jax_steps import random_variables
from tpudepth_torch.core.config import TrainConfig
from tpudepth_torch.models import jax_weights as jw
from tpudepth_torch.models import keras_import, torch_import
from tpudepth_torch.models.layers import BatchNorm, Conv, Linear, init_random_
from tpudepth_torch.models.registry import build_model
from tpudepth_torch.train import trainer as ttr
from tpudepth_torch.train.checkpoint import load_checkpoint, load_model_weights
from tpudepth_torch.train.jax_state import trainer_checkpoint_from_jax
from tpudepth_torch.train.orbax_io import is_orbax_checkpoint, read_orbax

RTOL, ATOL = 1e-3, 1e-4
HW = (64, 96)
STEPS = 3           # optimizer steps of one epoch, and steps taken
LR, GAMMA = 1e-3, 0.5


class _Loader:
    """A loader of ``STEPS`` batches (the trainers read its length)."""

    def __len__(self):
        return STEPS


def _adam_state(tx, params, seed):
    """``tx.init(params)`` with every count at ``STEPS`` and seeded moments
    (``nu`` positive): the state of an epoch's steps, made without running
    them (eager optax updates of these trees take tens of seconds)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if jnp.issubdtype(leaf.dtype, jnp.integer):
            return np.asarray(STEPS, leaf.dtype)
        if ".nu" in jax.tree_util.keystr(path):
            return (1e-4 * rng.random(leaf.shape)).astype(np.float32)
        return (1e-2 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill,
                                            jax.eval_shape(tx.init, params))


def _jax_cfg(tmp, model):
    return JaxTrainConfig(model=model, compute_dtype="float32",
                          learning_rate=LR, scheduler_step_size=1,
                          scheduler_gamma=GAMMA, checkpoint_dir=str(tmp / "ck"),
                          results_dir=str(tmp / "res"))


def _port_cfg(model):
    return TrainConfig(model=model, compute_dtype="float32", learning_rate=LR,
                       scheduler_step_size=1, scheduler_gamma=GAMMA)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """One JAX GuideDepth trainer (packed, the JAX default) with seeded
    weights and the Adam state of one epoch, its three checkpoint files,
    SAM's frozen-encoder state saved beside them, and what the JAX
    trainer's own ``restore`` gives back for each trainer schema."""
    tmp = tmp_path_factory.mktemp("weights")
    cfg = _jax_cfg(tmp, "GuideDepth")
    tr = jtr.Trainer(cfg, mesh=create_mesh(num_data=1), train_loader=_Loader())
    # the state init_state would make, with seeded weights (init_state runs
    # an eager init forward of the model: 15 s here)
    variables = random_variables("GuideDepth", 51)
    tx = jtr.make_optimizer(cfg, STEPS)
    tr.state = jtr.TrainState(
        step=jnp.asarray(STEPS, jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=_adam_state(tx, variables["params"], 52), tx=tx,
        apply_fn=tr.model.apply)
    tr.val_losses = [0.25]
    paths = {"checkpoint_0": tr.save_epoch_checkpoint(0),
             "global_checkpoint": tr.save_rolling_checkpoint(0, 0.5)}
    wait_for_checkpoints()
    paths["best_model"] = tr.export_best_model()

    sam = random_variables("sam", 53)
    stx = jtr.make_optimizer(_jax_cfg(tmp, "sam"), STEPS,
                             jtr.freeze_encoder_mask(sam["params"]))
    paths["sam"] = str(tmp / "sam_checkpoint")
    jax_save_checkpoint(paths["sam"], {
        "epoch": 0, "loss": 0.5, "params": sam["params"],
        "batch_stats": sam["batch_stats"],
        "opt_state": _adam_state(stx, sam["params"], 54)}, blocking=True)

    restored = {}
    for name in ("checkpoint_0", "global_checkpoint"):
        tr.restore(paths[name])
        if name == "global_checkpoint":
            # the root schema stores the completed epoch (src/train.py:59-68)
            tr.set_resume_epoch(tr.epoch + 1)
        restored[name] = types.SimpleNamespace(
            step=int(tr.state.step), epoch=tr.epoch,
            val_losses=list(tr.val_losses),
            schedule_count=int(tr.state.opt_state[1].count),
            variables=jax.device_get({"params": tr.state.params,
                                      "batch_stats": tr.state.batch_stats}),
            adam=jax.device_get(tr.state.opt_state[0]))
    return types.SimpleNamespace(trainer=tr, paths=paths, restored=restored,
                                 sam_tx=stx, gd_tx=tr.state.tx, tmp=tmp)


# -- 1. read_orbax against the JAX restore ------------------------------------

def _same_tree(want, got, path="tree"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _same_tree(want[k], got[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(want, got)):
            _same_tree(a, b, f"{path}/{i}")
    elif want is None:
        assert got is None, path
    elif isinstance(want, (bool, int, float, str)):
        assert type(got) is type(want) and got == want, path
    else:
        want = np.asarray(want)
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.array_equal(np.atleast_1d(got).view(np.uint8),
                              np.atleast_1d(want).view(np.uint8)), path


@pytest.mark.parametrize("name", ["checkpoint_0", "global_checkpoint",
                                  "best_model", "sam"])
def test_read_orbax_equals_the_jax_restore_bit_for_bit(jax_run, name):
    path = jax_run.paths[name]
    assert is_orbax_checkpoint(path)
    _same_tree(jax_load_checkpoint(path), read_orbax(path))


@pytest.mark.parametrize("ocdbt,zarr3", [(True, False), (False, False),
                                         (True, True), (False, True)],
                         ids=["ocdbt-zarr2", "files-zarr2", "ocdbt-zarr3",
                              "files-zarr3"])
def test_read_orbax_reads_every_storage_layout(tmp_path, ocdbt, zarr3):
    import orbax.checkpoint as ocp

    rng = np.random.default_rng(55)
    payload = {"epoch": 2, "val_losses": [0.5, 0.25], "loss": 1.5,
               "empty": {}, "none": [], "n": np.int32(4),
               "params": {"a": {"kernel": rng.standard_normal((3, 4)).astype(
                   np.float32)}, "b": [np.arange(3, dtype=np.int64)]}}
    path = str(tmp_path / "ck")
    ocp.Checkpointer(ocp.PyTreeCheckpointHandler(
        use_ocdbt=ocdbt, use_zarr3=zarr3)).save(path, payload)
    _same_tree(ocp.PyTreeCheckpointer().restore(path), read_orbax(path))


# -- 2. the bridge by name and a converted checkpoint served ------------------

def _image():
    """The one input shape of every JAX forward here: JAX compiles each
    eager op once per shape, so later forwards of the file reuse the
    first's ops."""
    return np.random.default_rng(58).random((1, *HW, 3), dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _jax_forward(model):
    return jax.jit(lambda v, a: model.apply(v, a, train=False))


def _jax_eval(model, variables, x):
    """JAX's eval forward, compiled once a model (a cold eager forward
    compiles every op on its own: 5-10x longer here); of a list of taps,
    the last."""
    out = _jax_forward(model)(variables, jnp.asarray(x))
    return np.asarray(out[-1] if isinstance(out, (list, tuple)) else out)


def _equal_state(got, want):
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("name", ["GuideDepth-unpacked", "GuideDepth", "sam",
                                  "newcrf", "unet_interp_small"])
def test_state_dict_from_flax_equals_each_family_function(jax_run, name):
    if name == "GuideDepth-unpacked":
        # the unpacked model's tree is the packed one's
        shapes = jax.eval_shape(
            lambda k, x: jax_build_model("GuideDepth", packed=False).init(
                k, x, train=False),
            jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3), jnp.float32))
        variables = random_variables("GuideDepth", 56)
        assert jax.tree_util.tree_map(lambda a: a.shape, shapes) == \
            jax.tree_util.tree_map(lambda a: a.shape, variables)
        name = "GuideDepth"
    elif name == "GuideDepth":
        variables = read_orbax(jax_run.paths["best_model"])
    elif name == "sam":
        variables = read_orbax(jax_run.paths["sam"])
    else:
        variables = random_variables(name, 57)
    family = {"GuideDepth": jw.guidedepth_state_dict_from_flax,
              "sam": jw.sam_state_dict_from_flax,
              "newcrf": jw.newcrf_state_dict_from_flax}.get(
        name, lambda v: jw.zoo_state_dict_from_flax(name, v))
    want = family({"params": variables["params"],
                   "batch_stats": variables["batch_stats"]})
    _equal_state(jw.state_dict_from_flax(name, variables), want)
    alias = {"GuideDepth": "guidedepth", "sam": "mobilev3_sam",
             "newcrf": "mobilev3_newcrf",
             "unet_interp_small": "unet_interpolado_small"}[name]
    _equal_state(jw.state_dict_from_flax(alias, variables), want)


def test_converted_jax_checkpoint_serves_as_jax_does(jax_run):
    """``best_model`` of the JAX trainer (packed GuideDepth) into the port's
    packed and unpacked GuideDepth through ``load_model_weights``: both
    serve JAX's eval forward."""
    path = jax_run.paths["best_model"]
    ck = jax_load_checkpoint(path)
    x = _image()
    want = _jax_eval(jax_run.trainer.model,
                     {"params": ck["params"], "batch_stats": ck["batch_stats"]},
                     x)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    for packed in (True, False):
        model = build_model("GuideDepth", packed=packed)
        restored = load_model_weights(model, path, "GuideDepth")
        assert restored["best_epoch"] == 0 and restored["val_loss"] == 0.25
        with torch.no_grad():
            got = model.eval()(xt).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# -- 3. one Adam update after the restore, against optax ------------------------

def _to64(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64)
        if np.issubdtype(np.asarray(a).dtype, np.floating) else a, tree)


def _flax64(name, tree):
    """A flax params tree (optax's masked nodes as None) in the port's
    names and layouts, float64."""
    def raw(node):
        if isinstance(node, dict):
            return {k: raw(v) for k, v in node.items()}
        return None if isinstance(node, optax.MaskedNode) else node

    return jw._convert(jw._flatten(raw(tree), keep_none=True,
                                   dtype=np.float64),
                       None, jw._entries(name), dtype=np.float64)


@pytest.mark.parametrize("name,key", [("GuideDepth", "checkpoint_0"),
                                      ("sam", "sam")],
                         ids=["adam", "frozen-encoder"])
def test_one_adam_update_after_restore_equals_optax(jax_run, name, key):
    path = jax_run.paths[key]
    freeze = name == "sam"
    tx = jax_run.sam_tx if freeze else jax_run.gd_tx
    raw = jax_load_checkpoint(path)
    target = dict(raw, opt_state=tx.init(raw["params"]))
    restored = jax_load_checkpoint(path, target)
    count = int(restored["opt_state"].inner_states["train"].inner_state[0]
                .count if freeze else restored["opt_state"][0].count)
    rng = np.random.default_rng(59)
    grads = jax.tree_util.tree_map(
        lambda p: np.asarray(0.01 * rng.standard_normal(p.shape), np.float32),
        raw["params"])
    with jax.enable_x64(True):
        # one compiled update: optax's own arithmetic, op for op
        p64 = _to64(restored["params"])
        updates, new_state = jax.jit(tx.update)(
            _to64(grads), _to64(restored["opt_state"]), p64)
        new_params = jax.device_get(jax.jit(optax.apply_updates)(p64,
                                                                 updates))
        new_state = jax.device_get(new_state)
    adam = (new_state.inner_states["train"].inner_state[0] if freeze
            else new_state[0])

    with one_torch_thread():
        model = build_model(name).double()
        ck = load_checkpoint(path, model_name=name, model=model)
        torch_import.load_reference_state_dict(model, ck)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        opt = ttr.make_optimizer(_port_cfg(name),
                                 ttr.trainable_parameters(model, freeze))
        opt.load_state_dict(ck["optimizer"])
        g = {"GuideDepth": jw.guidedepth_grads_from_flax,
             "sam": jw.sam_grads_from_flax}[name](grads)
        for n, p in model.named_parameters():
            p.grad = g[n].double()
        for group in opt.param_groups:
            group["lr"] = ttr.step_lr(LR, 1, GAMMA, STEPS)(count)
        opt.step()

    want_p = _flax64(name, new_params)
    moments = {"exp_avg": _flax64(name, adam.mu),
               "exp_avg_sq": _flax64(name, adam.nu)}
    trainable = ttr.trainable_parameters(model, freeze)
    index = {id(p): i for i, p in enumerate(trainable)}
    state = opt.state_dict()["state"]
    frozen = 0
    for n, p in model.named_parameters():
        # atol: 1e-12 of the learning rate, for parameters near 0
        np.testing.assert_allclose(p.detach().numpy(), want_p[n].numpy(),
                                   rtol=1e-12, atol=1e-12 * LR, err_msg=n)
        if id(p) not in index:
            frozen += 1
            assert torch.equal(p.detach(), before[n]), n
            assert moments["exp_avg"][n] is None, n
            continue
        s = state[index[id(p)]]
        assert float(s["step"]) == count + 1 == int(adam.count), n
        for field, want in moments.items():
            scale = float(want[n].abs().max()) or 1.0
            np.testing.assert_allclose(s[field].numpy(), want[n].numpy(),
                                       rtol=0, atol=1e-12 * scale,
                                       err_msg=f"{n} {field}")
    assert frozen == (sum(1 for n in before if n.startswith(ttr.ENCODER_PREFIX))
                      if freeze else 0)
    assert not freeze or frozen > 100


# -- 4. Trainer.restore against the JAX trainer's restore ----------------------

@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
@pytest.mark.parametrize("schema", ["checkpoint_0", "global_checkpoint"])
def test_trainer_restore_equals_the_jax_restore(jax_run, schema, packed):
    want = jax_run.restored[schema]
    tr = ttr.Trainer(_port_cfg("GuideDepth"),
                     model=build_model("GuideDepth", packed=packed),
                     device="cpu", train_loader=_Loader())
    tr.init_state()
    tr.restore(jax_run.paths[schema])
    if schema == "global_checkpoint":
        tr.set_resume_epoch(tr.epoch + 1)
    assert (tr.state.step, tr.epoch) == (want.step, want.epoch) == (STEPS, 1)
    assert tr.val_losses == want.val_losses
    lr = ttr.step_lr(LR, 1, GAMMA, STEPS)(tr.state.step)
    assert lr == pytest.approx(jtr.step_lr(LR, 1, GAMMA, STEPS)(
        want.schedule_count), rel=1e-15) and lr == LR * GAMMA
    sd = tr.model.state_dict()
    for k, v in jw.state_dict_from_flax("GuideDepth", want.variables).items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(sd[k], v), k
    moments = {"exp_avg": jw.guidedepth_grads_from_flax(want.adam.mu),
               "exp_avg_sq": jw.guidedepth_grads_from_flax(want.adam.nu)}
    state = tr.state.optimizer.state_dict()["state"]
    names = [n for n, _ in tr.model.named_parameters()]
    assert sorted(state) == list(range(len(names)))
    for i, n in enumerate(names):
        assert float(state[i]["step"]) == int(want.adam.count) == STEPS
        for field, table in moments.items():
            assert torch.equal(state[i][field], table[n]), (n, field)


def test_cli_scores_a_jax_checkpoint_and_a_reference_pth(jax_run, tmp_path,
                                                         monkeypatch):
    """``cli.test --pt`` takes the JAX ``best_model`` directory and a
    reference ``.pth`` of the same weights, and scores them alike."""
    from tpudepth_torch.cli import test as cli_test

    monkeypatch.chdir(tmp_path)
    pth = str(tmp_path / "best_model.pth")
    sd = load_checkpoint(jax_run.paths["best_model"],
                         model_name="GuideDepth")["model"]
    torch.save({"model": sd, "epoch": 20, "val_losses": [0.25]}, pth)
    with one_torch_thread():
        got = [cli_test.main(["--bs", "4", "--data", "synthetic:48x64",
                              "--device", "cpu", "--pt", p])
               for p in (jax_run.paths["best_model"], pth)]
    assert got[0] == got[1] and np.isfinite(list(got[0].values())).all()


# -- 5. malformed JAX states raise, naming the leaf ------------------------------

_DROP = object()


def _with(tree, path, value):
    """A copy of ``tree`` (dicts and lists along ``path`` only) with the
    leaf at ``path`` set to ``value`` (``_DROP``: removed)."""
    head, *rest = path
    node = copy.copy(tree)
    if rest:
        node[head] = _with(tree[head], rest, value)
    elif value is _DROP:
        del node[head]
    else:
        node[head] = value
    return node


SAM_ADAM = ["opt_state", "inner_states", "train", "inner_state", 0]
GD_ADAM = ["opt_state", 0]
DECODER_KERNEL = ["decoder", "conv0", "Conv_0", "kernel"]
ENCODER_KERNEL = ["encoder", "stem", "conv", "Conv_0", "kernel"]
GD_KERNEL = ["up_1", "reduce", "Conv_0", "kernel"]


@pytest.mark.parametrize("case", [
    "masked-where-trainable", "array-where-frozen", "missing-moment",
    "moment-shape", "extra-moment", "missing-param", "payload-key",
    "not-adam"])
def test_malformed_jax_state_raises_naming_the_leaf(jax_run, case):
    sam = read_orbax(jax_run.paths["sam"]) if "frozen" in case or \
        "trainable" in case else None
    gd = read_orbax(jax_run.paths["checkpoint_0"])
    name, tree, err, match = "GuideDepth", gd, ValueError, None
    if case == "masked-where-trainable":
        name, tree = "sam", _with(sam, SAM_ADAM + ["mu"] + DECODER_KERNEL,
                                  None)
        match = "mu/decoder/conv0/Conv_0/kernel is masked"
    elif case == "array-where-frozen":
        name, tree = "sam", _with(sam, SAM_ADAM + ["nu"] + ENCODER_KERNEL,
                                  np.zeros((3, 3, 3, 16), np.float32))
        match = "nu/encoder/stem/conv/Conv_0/kernel holds an array"
    elif case == "missing-moment":
        tree, err = _with(gd, GD_ADAM + ["mu"] + GD_KERNEL, _DROP), KeyError
        match = "up_1/reduce/Conv_0/kernel is missing"
    elif case == "moment-shape":
        tree = _with(gd, GD_ADAM + ["nu"] + GD_KERNEL,
                     np.zeros((1, 1, 2, 3), np.float32))
        match = "nu/up_1/reduce/Conv_0/kernel has shape"
    elif case == "extra-moment":
        tree = _with(gd, GD_ADAM + ["mu", "bogus"], np.zeros(3, np.float32))
        match = "bogus"
    elif case == "missing-param":
        tree, err = _with(gd, ["params"] + GD_KERNEL, _DROP), KeyError
        match = "params/up_1/reduce/Conv_0/kernel is missing"
    elif case == "payload-key":
        tree, match = _with(gd, ["bogus"], 1), "unknown keys \\['bogus'\\]"
    else:
        tree, match = _with(gd, ["opt_state"], {"count": 1}), "optax.adam"
    with pytest.raises(err, match=match):
        trainer_checkpoint_from_jax(name, tree, build_model(name),
                                    freeze_encoder=name == "sam")


def test_orbax_directory_needs_a_model_name(jax_run):
    with pytest.raises(ValueError, match="model_name"):
        load_checkpoint(jax_run.paths["checkpoint_0"])


@pytest.mark.parametrize("freeze", [None, True, False],
                         ids=["trainer-rule", "frozen", "trainable"])
def test_orbax_optimizer_follows_the_callers_frozen_encoder(jax_run, freeze):
    """SAM's ``multi_transform`` state converts with the encoder frozen,
    the trainer's rule (``trainer.freezes_encoder``) unless the caller
    says otherwise; said trainable, its masked encoder leaves raise."""
    assert ttr.freezes_encoder("sam") and not ttr.freezes_encoder("newcrf")
    model = build_model("sam")
    if freeze is False:
        with pytest.raises(ValueError, match="masked .None. where the "
                           "trainable Unet.0."):
            load_checkpoint(jax_run.paths["sam"], model_name="sam",
                            model=model, freeze_encoder=False)
        return
    got = load_checkpoint(jax_run.paths["sam"], model_name="sam", model=model,
                          freeze_encoder=freeze)
    trainable = ttr.trainable_parameters(model, True)
    assert len(got["optimizer"]["state"]) == len(trainable)
    assert all(got["optimizer"]["state"][i]["exp_avg"].shape == p.shape
               for i, p in enumerate(trainable))


# -- 6. reference .pth files against JAX's converters ---------------------------

def _seeded(name, seed, **kw):
    return init_random_(build_model(name, **kw), seed=seed).eval()


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _close(got, want):
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["ddrnet-imagenet", "mobilenetv3-features",
                                  "root-schema", "guidedepth-schema",
                                  "bare-state-dict"])
def test_reference_pth_loads_as_the_jax_converters_read_it(tmp_path, case):
    x = _image()
    path = str(tmp_path / "weights.pth")
    with one_torch_thread():
        if case == "ddrnet-imagenet":
            src = _seeded("GuideDepth", 61).feature_extractor.state_dict()
            sd = dict(src)
            # the ImageNet classifier's head (down5, last_layer, linear)
            for k, shape in (("down5.0.weight", (256, 64, 3, 3)),
                             ("down5.1.running_mean", (256,)),
                             ("last_layer.0.weight", (1024, 512, 1, 1)),
                             ("linear.weight", (1000, 1024)),
                             ("linear.bias", (1000,))):
                sd[k] = torch.randn(shape)
            torch.save({"state_dict": sd}, path)
            model = _seeded("GuideDepth", 62)
            torch_import.load_ddrnet_imagenet(model, torch.load(path))
            with torch.no_grad():
                got = model.feature_extractor(_nchw(x))
            variables = convert_ddrnet(torch_import.state_dict_to_numpy(sd))
            want = _jax_eval(DualResNetBackbone(features=64), variables, x)
        elif case == "mobilenetv3-features":
            enc = _seeded("sam", 63).Unet[0].original_model.features
            sd = {f"features.{k}": v for k, v in enc.state_dict().items()}
            sd["classifier.0.weight"] = torch.randn(1280, 960)
            torch.save(sd, path)
            model = _seeded("sam", 64)
            torch_import.load_mobilenetv3_features(model, torch.load(path))
            with torch.no_grad():
                got = model.Unet[0](_nchw(x))[-1]
            variables = convert_mobilenetv3(
                torch_import.state_dict_to_numpy(sd), "large")
            want = _jax_eval(MobileNetV3Features("large"), variables, x)
        elif case == "root-schema":
            sd = dict(_seeded("sam", 65).state_dict())
            for i, c in enumerate((128, 256, 512, 1024)):
                # what the reference has and the port does not
                sd[f"Unet.1.crf{i}.proj.weight"] = torch.randn(c, c, 3, 3)
                sd[f"Unet.1.crf{i}.proj.bias"] = torch.randn(c)
                sd[f"Unet.1.crf{i}.sam_block.attn.relative_position_index"] = \
                    torch.zeros(49, 49, dtype=torch.long)
            torch.save({"epoch": 3, "model_state_dict": sd, "loss": 0.5,
                        "optimizer_state_dict": {"state": {},
                                                 "param_groups": []}}, path)
            model = build_model("sam")
            restored = load_model_weights(model, path)
            assert restored["epoch"] == 3 and "optimizer" in restored
            with torch.no_grad():
                got = model.eval()(_nchw(x))
            want = _jax_eval(jax_build_model("sam"), convert_attention_model(
                torch_import.state_dict_to_numpy(sd), "sam"), x)
        else:
            sd = _seeded("GuideDepth", 66).state_dict()
            if case == "guidedepth-schema":
                # src/GuideDepth/training.py:166-178
                torch.save({"epoch": 20, "val_losses": [0.5], "model": sd,
                            "optimizer": {}, "lr_scheduler": {}}, path)
            else:
                # a release as a bare state_dict, num_batches_tracked dropped
                torch.save({k: v for k, v in sd.items()
                            if "num_batches_tracked" not in k}, path)
            model = build_model("GuideDepth")
            load_model_weights(model, path)
            with torch.no_grad():
                got = model.eval()(_nchw(x))
            want = _jax_eval(jax_build_model("GuideDepth"), convert_guidedepth(
                torch_import.state_dict_to_numpy(sd)), x)
    _close(got, want)


@pytest.mark.parametrize("case", ["unknown-key", "missing-key", "shape"])
def test_reference_pth_malformed_raises_naming_the_key(case):
    model = build_model("GuideDepth-S")
    sd = dict(model.state_dict())
    if case == "unknown-key":
        sd["bogus.weight"], match = torch.zeros(1), "bogus.weight"
    elif case == "missing-key":
        del sd["up_1.reduce.weight"]
        match = "up_1.reduce.weight"
    else:
        sd["up_1.reduce.weight"] = torch.zeros(1, 2, 3, 3)
        match = "up_1.reduce.weight"
    with pytest.raises(ValueError, match=match):
        torch_import.load_reference_state_dict(model, {"model_state_dict": sd})
    fe = dict(model.feature_extractor.state_dict())
    fe["layer9.weight"] = torch.zeros(1)
    with pytest.raises(ValueError, match="layer9.weight"):
        torch_import.load_ddrnet_imagenet(model, fe)


# -- 7. Keras .h5 -----------------------------------------------------------------

def test_load_keras_h5_equals_jax(tmp_path):
    import h5py

    rng = np.random.default_rng(67)
    for group in ("model_weights", None):
        p = str(tmp_path / f"{group}.h5")
        with h5py.File(p, "w") as f:
            root = f.create_group(group) if group else f
            conv = root.create_group("conv1/conv1")
            conv.create_dataset("kernel:0", data=rng.standard_normal(
                (3, 3, 3, 16)).astype(np.float32))
            conv.create_dataset("bias:0", data=np.zeros(16, np.float32))
            bn = root.create_group("bn1/bn1")
            for n in ("gamma:0", "beta:0", "moving_mean:0",
                      "moving_variance:0"):
                bn.create_dataset(n, data=rng.random(16).astype(np.float32))
        want, got = jax_keras.load_keras_h5(p), keras_import.load_keras_h5(p)
        _same_tree(want, got)
        for a, b in zip(jax_keras.keras_bn(want["bn1/bn1"]),
                        keras_import.keras_bn(got["bn1/bn1"])):
            assert np.array_equal(a, b)
    x = np.asarray([0.5, 2.0, 1000.0])
    assert np.array_equal(keras_import.my_depth_norm(x),
                          jax_keras.my_depth_norm(x))
    assert np.array_equal(keras_import.clip_predictions(x),
                          jax_keras.clip_predictions(x))


class _Tiny(nn.Module):
    """The port's counterpart of ``tests/test_keras_import.py``'s ``Tiny``."""

    def __init__(self):
        super().__init__()
        self.conv1 = Conv(3, 8, 3, padding=1)
        self.bn = BatchNorm(8)
        self.conv2 = Conv(8, 4, 1)

    def forward(self, x):
        return self.conv2(torch.relu(self.bn(self.conv1(x))))


def test_import_keras_sequential_equals_the_jax_walk():
    import flax.linen as fnn

    class Tiny(fnn.Module):
        @fnn.compact
        def __call__(self, x, train=False):
            x = fnn.Conv(8, (3, 3), padding="SAME")(x)
            x = fnn.BatchNorm(use_running_average=not train)(x)
            return fnn.Conv(4, (1, 1))(fnn.relu(x))

    rng = np.random.default_rng(68)
    x = rng.random((1, 8, 8, 3)).astype(np.float32)
    wl = [rng.random((3, 3, 3, 8)), rng.random(8), rng.random(8) + 0.5,
          rng.random(8), rng.random(8), rng.random(8) + 0.1,
          rng.random((1, 1, 8, 4)), rng.random(4)]
    wl = [w.astype(np.float32) for w in wl]
    jmodel = Tiny()
    jvars = jax_keras.import_keras_sequential(
        wl, jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)),
        layer_order=["Conv_0", "BatchNorm_0", "Conv_1"])
    port = _Tiny()
    sd = keras_import.import_keras_sequential(wl, port)
    assert not torch.equal(port.conv1.weight, sd["conv1.weight"])
    port.load_state_dict(sd)
    p, s = jvars["params"], jvars["batch_stats"]
    for name, want in (("conv1.weight", p["Conv_0"]["kernel"]),
                       ("conv2.weight", p["Conv_1"]["kernel"])):
        assert np.array_equal(sd[name].numpy(),
                              np.transpose(np.asarray(want), (3, 2, 0, 1)))
    for name, want in (("conv1.bias", p["Conv_0"]["bias"]),
                       ("bn.weight", p["BatchNorm_0"]["scale"]),
                       ("bn.bias", p["BatchNorm_0"]["bias"]),
                       ("bn.running_mean", s["BatchNorm_0"]["mean"]),
                       ("bn.running_var", s["BatchNorm_0"]["var"]),
                       ("conv2.bias", p["Conv_1"]["bias"])):
        assert np.array_equal(sd[name].numpy(), np.asarray(want)), name
    want = np.asarray(jmodel.apply(jvars, jnp.asarray(x)))
    with torch.no_grad():
        got = port.eval()(_nchw(x))
    _close(got, want)


@pytest.mark.parametrize("case,shapes", [
    ("exhausted", [(3, 4)]),
    ("mismatch", [(5, 4), (4,)]),
    ("unconsumed", [(3, 4), (4,), (4,)])])
def test_import_keras_sequential_errors_match_jax(case, shapes):
    import flax.linen as fnn

    class M(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.Dense(4)(x)

    weights = [np.zeros(s, np.float32) for s in shapes]
    v = M().init(jax.random.PRNGKey(0), jnp.zeros((1, 3)))
    with pytest.raises(ValueError, match=case):
        jax_keras.import_keras_sequential(weights, v)
    with pytest.raises(ValueError, match=case):
        keras_import.import_keras_sequential(weights, Linear(3, 4))


# -- 8. reading without the packages -----------------------------------------------

def test_reading_without_tensorstore_or_h5py_raises_naming_it(
        jax_run, monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="tensorstore"):
        read_orbax(jax_run.paths["checkpoint_0"])
    tr = ttr.Trainer(_port_cfg("GuideDepth"), device="cpu",
                     train_loader=_Loader())
    tr.init_state()
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    with pytest.raises(ImportError, match="tensorstore"):
        tr.restore(jax_run.paths["checkpoint_0"])
    _equal_state(tr.model.state_dict(), before)
    with pytest.raises(ImportError, match="h5py"):
        keras_import.load_keras_h5(str(tmp_path / "none.h5"))
