"""JAX-side helpers of the SAM and NewCRF train-step tests
(``tests/test_torch_port_{sam,newcrf}_train.py``): seeded JAX variables, a
batch, the JAX package's float64 train step and the port's against it, and
the trainer's name-keyed switches against the JAX trainer's.

Tolerances (what ``check_step64`` holds): forward and mutated
``batch_stats`` rtol 1e-3 / atol 1e-4 (what ``tests/test_models.py`` holds
the JAX model to against the reference PyTorch model); loss rtol 1e-5; each
parameter gradient to 1e-3 of its tensor's largest (floor 1e-6: biases in
front of a BatchNorm hold only noise). ``check_trainer_switches``: one
``val_epoch`` loss against the JAX trainer's at rtol 1e-4 (f32 eval, two
implementations of the eval forward, each within f32 rounding of the other).
"""

import functools
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tpudepth.core.config import TrainConfig as JaxTrainConfig
from tpudepth.core.mesh import create_mesh
from tpudepth.models import build_model as jax_build_model
from tpudepth.ops.attention import training_mode
from tpudepth.ops.image import resize_bilinear as jax_resize_bilinear
from tpudepth.train import trainer as jtr
from torch_port_helpers import HW
from tpudepth_torch.core.config import TrainConfig
from tpudepth_torch.models import jax_weights
from tpudepth_torch.models import registry
from tpudepth_torch.models.registry import build_model
from tpudepth_torch.ops.image import resize_bilinear
from tpudepth_torch.train import trainer as ttr

MAX_DEPTH = 10.0
BRIDGE = {
    "sam": (jax_weights.sam_state_dict_from_flax,
            jax_weights.sam_grads_from_flax),
    "newcrf": (jax_weights.newcrf_state_dict_from_flax,
               jax_weights.newcrf_grads_from_flax),
    "GuideDepth": (jax_weights.guidedepth_state_dict_from_flax, None),
    "GuideDepth-S": (jax_weights.guidedepth_state_dict_from_flax, None),
    **{name: (functools.partial(jax_weights.zoo_state_dict_from_flax, name),
              functools.partial(jax_weights.zoo_grads_from_flax, name))
       for name in jax_weights.ZOO_MODELS},
}


def random_variables(name, seed, hw=HW):
    """JAX variables of ``name`` of its own structure (traced at ``hw``),
    filled from a numpy seed: lecun-normal kernels, BatchNorm statistics,
    scales and biases away from (0, 1), LayerNorm scales around 1, bias
    tables N(0, 0.02)."""
    model = jax_build_model(name)
    shapes = jax.eval_shape(lambda k, x: model.init(k, x, train=False),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, *hw, 3), jnp.float32))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        key = jax.tree_util.keystr(path)
        shape = leaf.shape
        if key.endswith("['kernel']"):
            arr = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif key.endswith("['relative_position_bias_table']"):
            arr = 0.02 * rng.standard_normal(shape)
        elif key.endswith("['mean']"):
            arr = 0.1 * rng.standard_normal(shape)
        elif key.endswith("['var']") or key.endswith("['scale']"):
            arr = rng.uniform(0.5, 1.5, shape)
        else:
            arr = 0.05 * rng.standard_normal(shape)
        return arr.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def batch(seed, bsz=2, hw=HW):
    rng = np.random.default_rng(seed)
    image = rng.random((bsz, *hw, 3), dtype=np.float32)
    depth = rng.random((bsz, *hw, 1), dtype=np.float32) * 0.9 + 0.05
    depth[rng.random(depth.shape) < 0.05] = 0.0   # masked pixels
    return image, depth


def jax_step64(name, variables, image, depth):
    """The JAX package's float64 train-mode forward, mutated statistics,
    root loss and gradients, carried to the port's names. A prediction at
    half the input's size gets the target resized to it, as the JAX
    trainer's step does (``tpudepth/train/trainer.py:240-248``)."""
    to_state, to_grads = BRIDGE[name]
    recipe = jtr.LossRecipe(kind="root", max_depth=MAX_DEPTH,
                            depth_scale=MAX_DEPTH)
    with jax.enable_x64(True):
        model64 = jax_build_model(name, dtype=jnp.float64)
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     variables)
        target = recipe.target(jnp.asarray(depth))

        def loss_fn(params):
            with training_mode():
                pred, mutated = model64.apply(
                    {"params": params, "batch_stats": v64["batch_stats"]},
                    jnp.asarray(image, jnp.float64), train=True,
                    mutable=["batch_stats"])
            tgt = target
            if pred.shape[1:3] != tgt.shape[1:3]:
                tgt = jax_resize_bilinear(tgt, pred.shape[1:3])
            return recipe.loss(pred, tgt), (pred, mutated["batch_stats"])

        (loss, (pred, stats)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(v64["params"])
        return {"loss": float(loss), "pred": np.asarray(pred),
                "stats": to_state({"params": variables["params"],
                                   "batch_stats": stats}),
                "grads": to_grads(grads)}


def check_step64(name, variables, want, image, depth):
    """The port's float64 step in its default block mode against ``want``."""
    to_state, _ = BRIDGE[name]
    port = build_model(name)
    port.load_state_dict(to_state(variables))
    model = port.double().train()
    recipe = ttr.LossRecipe(kind="root", max_depth=MAX_DEPTH,
                            depth_scale=MAX_DEPTH)
    # the head's sigmoid runs in f32 in both packages
    pred = model(torch.from_numpy(image).permute(0, 3, 1, 2).double())
    assert np.std(want["pred"]) > 1e-3
    np.testing.assert_allclose(pred.permute(0, 2, 3, 1).detach().numpy(),
                               want["pred"], rtol=1e-3, atol=1e-4)
    sd = model.state_dict()
    keys = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(keys) >= 90   # MobileNetV3-Large's 46 BatchNorms
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), want["stats"][k].numpy(),
                                   rtol=1e-3, atol=1e-4, err_msg=k)
    target = recipe.target(torch.from_numpy(depth).permute(0, 3, 1, 2))
    if pred.shape[2:] != target.shape[2:]:
        # the port trainer's step (tpudepth_torch/train/trainer.py)
        target = resize_bilinear(target, pred.shape[2:])
    loss = recipe.loss(pred, target)
    assert loss.item() == pytest.approx(want["loss"], rel=1e-5)
    loss.backward()
    assert set(want["grads"]) == {n for n, _ in model.named_parameters()}
    n_compared = 0
    for n, p in model.named_parameters():
        g, gw = p.grad.numpy(), want["grads"][n].numpy()
        tol = max(1e-3 * np.abs(gw).max(), 1e-6)
        assert np.abs(g - gw).max() <= tol, (n, np.abs(g - gw).max(), tol)
        n_compared += int(np.abs(gw).max() > 1e-6)
    assert n_compared > 100


def aliases(name):
    """``name`` and every alias of it in the port's registry."""
    found = [a for a, c in registry._ALIASES.items() if c == name]
    return [name] + [a for a in found if a != name] + [found[-1].upper()]


def jax_val_loss(name, variables, loader):
    """One ``val_epoch`` of the JAX trainer on ``variables``, f32."""
    jt = jtr.Trainer(JaxTrainConfig(model=name, compute_dtype="float32"),
                     mesh=create_mesh(devices=jax.devices()[:1]),
                     val_loader=loader)
    jt.state = types.SimpleNamespace(params=variables["params"],
                                     batch_stats=variables["batch_stats"])
    jt.val_epoch()
    return jt.recipe, jt.val_losses[-1]


def check_trainer_switches(alias, canon, variables, loader, want):
    """The port's ``Trainer`` for ``alias``: recipe and frozen encoder keyed
    on ``canon``, and one ``val_epoch`` loss against the JAX trainer's."""
    jrecipe, jloss = want
    cfg = TrainConfig(model=alias, compute_dtype="float32")
    own = ttr.Trainer(cfg, device="cpu")
    assert own.model_name == canon
    assert type(own.model).__name__ == type(build_model(canon)).__name__
    port = build_model(canon)
    port.load_state_dict(BRIDGE[canon][0](variables))
    t = ttr.Trainer(cfg, model=port, device="cpu", val_loader=loader)
    assert (t.recipe.kind, t.recipe.max_depth, t.recipe.depth_scale,
            t.recipe.silog_weight) == (jrecipe.kind, jrecipe.max_depth,
                                       jrecipe.depth_scale,
                                       jrecipe.silog_weight)
    assert t.recipe.kind == ("alhashim" if canon.startswith("GuideDepth")
                             else "root")
    assert t.freeze_encoder == (canon == "sam")
    t.val_epoch()
    assert t.val_losses[-1] == pytest.approx(jloss, rel=1e-4)


class Loader:
    """One validation batch as a loader delivers it (NHWC float)."""

    def __init__(self, seed):
        image, depth = batch(seed, bsz=1)
        self.batches = [{"image": image, "depth": depth}]

    def __len__(self):
        return len(self.batches)

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        return iter(self.batches)
