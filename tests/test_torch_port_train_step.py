"""One train step of the port against the JAX package's: GuideDepth at
2x96x128 from the same weights (through the bridge) and the same batch,
augmentation off, alhashim recipe, both on the CPU (the JAX package takes
its jnp ``DepthLoss`` there, the port its plain ``DepthLoss``).

At this size the DAPPM's pooled maps are 1x1, so four of its BatchNorms
normalize over the 2 values of the batch, and in float32 they turn a 1e-5
relative rounding difference into 5e-4 (a port run in float32 against the
same port in float64 shows it). Weight gradients are sums over pixels of
signed terms that cancel about a hundredfold, so they carry that as 1-6 %.
The comparison of the arithmetic is therefore made with both models in
float64 (the JAX model under ``jax.enable_x64``; the pools and
the loss stay float32 in both packages), and the float32 step is held to
what its conditioning allows.

Tolerances. Float64 models: train-mode forward and mutated ``batch_stats``
rtol 1e-3, atol 1e-4 (what ``tests/test_models.py`` holds the JAX model to
against the reference PyTorch model); loss rtol 1e-5; parameter gradients,
per tensor, 1e-3 of the tensor's largest gradient (floor 1e-6: conv biases
in front of a BatchNorm have a zero gradient and hold only noise). Float32
step: loss rtol 1e-4; BatchNorm statistics rtol 1e-3, atol 1e-4; gradients
10 % of the tensor's largest (floor 1e-5; the branch behind the global pool
shows 6 %); parameters after one Adam step: the first
update is ``-lr * g/(|g| + eps)``, i.e. ``-lr * sign(g)`` wherever
``|g| >> eps``, so elements whose ``|g|`` lies under twice the gradient
tolerance may take the other sign in the other package and are held to
``2 * lr``, the rest to 1e-3 of ``lr``.
"""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_port_guidedepth import HW, _random_variables

from tpudepth.core.config import TrainConfig as JaxTrainConfig
from tpudepth.data.augment import _PERMS as JAX_PERMS
from tpudepth.data.augment import augment_batch as jax_augment_batch
from tpudepth.models import build_model as jax_build_model
from tpudepth.train import trainer as jtr
from tpudepth_torch.core.config import TrainConfig
from tpudepth_torch.data.augment import _PERMS, augment_batch
from tpudepth_torch.models.jax_weights import (
    guidedepth_grads_from_flax,
    guidedepth_state_dict_from_flax,
)
from tpudepth_torch.models.registry import build_model
from tpudepth_torch.train import trainer as ttr
from torch_port_helpers import torch_one_thread  # noqa: F401

LR = 1e-4
MAX_DEPTH = 10.0


def _batch(seed=11, bsz=2, hw=HW):
    rng = np.random.default_rng(seed)
    image = rng.random((bsz, *hw, 3), dtype=np.float32)
    depth = rng.random((bsz, *hw, 1), dtype=np.float32) * 0.9 + 0.05
    depth[rng.random(depth.shape) < 0.05] = 0.0   # masked pixels
    return image, depth


@pytest.fixture(scope="module")
def both():
    """The JAX package's results (float64 forward / loss / gradients, and a
    float32 train step) and the port's model with the same weights."""
    variables = _random_variables("GuideDepth", 0)
    image, depth = _batch()
    recipe = jtr.LossRecipe(kind="alhashim", max_depth=MAX_DEPTH,
                            depth_scale=MAX_DEPTH)

    with jax.enable_x64(True):
        model64 = jax_build_model("GuideDepth", dtype=jnp.float64)
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     variables)
        target = recipe.target(jnp.asarray(depth))

        def loss_fn(params):
            pred, mutated = model64.apply(
                {"params": params, "batch_stats": v64["batch_stats"]},
                jnp.asarray(image, jnp.float64), train=True,
                mutable=["batch_stats"])
            return recipe.loss(pred, target), (pred, mutated["batch_stats"])

        (loss, (pred, stats)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(v64["params"])
        assert pred.dtype == jnp.float64
        want = {
            "loss": float(loss), "pred": np.asarray(pred),
            "stats": guidedepth_state_dict_from_flax(
                {"params": variables["params"], "batch_stats": stats}),
            "grads": guidedepth_grads_from_flax(grads),
        }

    model = jax_build_model("GuideDepth")
    cfg = JaxTrainConfig(compute_dtype="float32", learning_rate=LR)
    tx = jtr.make_optimizer(cfg, steps_per_epoch=10)
    state = jtr.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]), tx=tx, apply_fn=model.apply)
    step = jtr.make_train_step(model, recipe, compute_dtype=jnp.float32,
                               augment=False)
    new_state, step_loss = step(state, jnp.asarray(image), jnp.asarray(depth),
                                jax.random.PRNGKey(0))
    want["step_loss"] = float(step_loss)
    want["after"] = guidedepth_state_dict_from_flax(
        {"params": new_state.params, "batch_stats": new_state.batch_stats})

    port = build_model("GuideDepth")
    port.load_state_dict(guidedepth_state_dict_from_flax(variables))
    return want, port, (image, depth)


def _port_step(port, batch, **kwargs):
    cfg = TrainConfig(compute_dtype="float32", learning_rate=LR)
    state = ttr.TrainState(port, ttr.make_optimizer(cfg, port.parameters()))
    recipe = ttr.LossRecipe(kind="alhashim", max_depth=MAX_DEPTH,
                            depth_scale=MAX_DEPTH)
    step = ttr.make_train_step(
        port, recipe, ttr.step_lr(LR, 15, 0.1, 10),
        compute_dtype=torch.float32, augment=False, **kwargs)
    loss = step(state, torch.from_numpy(batch[0]), torch.from_numpy(batch[1]))
    return state, loss


def test_float64_forward_stats_loss_and_gradients_match_jax(both):
    want, port, (image, depth) = both
    model = copy.deepcopy(port).double().train()
    recipe = ttr.LossRecipe(kind="alhashim", max_depth=MAX_DEPTH,
                            depth_scale=MAX_DEPTH)
    pred = model(torch.from_numpy(image).permute(0, 3, 1, 2).double())
    assert pred.dtype == torch.float64
    np.testing.assert_allclose(pred.permute(0, 2, 3, 1).detach().numpy(),
                               want["pred"], rtol=1e-3, atol=1e-4)
    sd = model.state_dict()
    keys = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(keys) > 100
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), want["stats"][k].numpy(),
                                   rtol=1e-3, atol=1e-4, err_msg=k)

    target = recipe.target(torch.from_numpy(depth).permute(0, 3, 1, 2))
    loss = recipe.loss(pred, target)
    assert loss.item() == pytest.approx(want["loss"], rel=1e-5)
    loss.backward()
    assert set(want["grads"]) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        g, gw = p.grad.numpy(), want["grads"][name].numpy()
        tol = max(1e-3 * np.abs(gw).max(), 1e-6)
        assert np.abs(g - gw).max() <= tol, (name, np.abs(g - gw).max(), tol)


def test_one_float32_step_matches_jax(both):
    want, port, batch = both
    model = copy.deepcopy(port)
    state, loss = _port_step(model, batch)
    assert state.step == 1
    assert want["loss"] == pytest.approx(want["step_loss"], rel=1e-4)
    assert loss.item() == pytest.approx(want["step_loss"], rel=1e-4)

    before = port.state_dict()
    after = model.state_dict()
    n_small = n_all = 0
    for name, p in model.named_parameters():
        g, gw = p.grad.numpy(), want["grads"][name].numpy()
        gtol = max(0.1 * np.abs(gw).max(), 1e-5)
        assert np.abs(g - gw).max() <= gtol, (name, np.abs(g - gw).max(), gtol)
        is_small = np.abs(gw) <= 2 * gtol
        got, ref = after[name].numpy(), want["after"][name].numpy()
        diff = np.abs(got - ref)
        assert diff[~is_small].max(initial=0.0) <= (
            1e-3 * LR + 1e-7 * np.abs(ref).max()), name
        assert diff[is_small].max(initial=0.0) <= 2 * LR * 1.001, name
        if np.abs(gw).max() > 1e-6:  # the step moved the parameter at all
            assert np.abs(got - before[name].numpy()).max() > 0.5 * LR, name
        n_small += int(is_small.sum())
        n_all += is_small.size
    assert n_small < n_all

    for k in after:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(after[k].numpy(), want["after"][k].numpy(),
                                       rtol=1e-3, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("steps_per_epoch", [1, 7, 100])
def test_step_lr_matches_jax(steps_per_epoch):
    jsched = jtr.step_lr(1e-4, 15, 0.1, steps_per_epoch)
    tsched = ttr.step_lr(1e-4, 15, 0.1, steps_per_epoch)
    for step in [0, 1, steps_per_epoch * 15 - 1, steps_per_epoch * 15,
                 steps_per_epoch * 30, steps_per_epoch * 44 + 3]:
        assert tsched(step) == pytest.approx(float(jsched(step)), rel=1e-12)


def test_optimizer_is_adam_with_the_optax_defaults():
    cfg = TrainConfig(learning_rate=3e-4)
    opt = ttr.make_optimizer(cfg, [torch.nn.Parameter(torch.zeros(2))])
    group = opt.param_groups[0]
    assert isinstance(opt, torch.optim.Adam)
    assert group["lr"] == 3e-4 and group["betas"] == (0.9, 0.999)
    assert group["eps"] == 1e-8 and group["weight_decay"] == 0


def test_augment_batch_with_injected_decisions_matches_jax():
    assert [tuple(p) for p in JAX_PERMS.tolist()] == list(_PERMS)
    b = 16
    rng = np.random.default_rng(0)
    image = rng.random((b, 6, 8, 3), dtype=np.float32)
    depth = rng.random((b, 6, 8, 1), dtype=np.float32)
    key = jax.random.PRNGKey(5)
    k_flip, k_swap_p, k_swap_i = jax.random.split(key, 3)
    do_flip = np.asarray(jax.random.uniform(k_flip, (b,)) < 0.5)
    do_swap = np.asarray(jax.random.uniform(k_swap_p, (b,)) < 0.5)
    perm_idx = np.asarray(jax.random.randint(k_swap_i, (b,), 0, len(JAX_PERMS)))
    assert do_flip.any() and (~do_flip).any() and do_swap.any()
    want_img, want_dep = jax_augment_batch(key, jnp.asarray(image),
                                           jnp.asarray(depth))
    got_img, got_dep = augment_batch(
        None, torch.from_numpy(image).permute(0, 3, 1, 2),
        torch.from_numpy(depth).permute(0, 3, 1, 2),
        do_flip=torch.from_numpy(do_flip), do_swap=torch.from_numpy(do_swap),
        perm_idx=torch.from_numpy(perm_idx))
    np.testing.assert_array_equal(got_img.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want_img))
    np.testing.assert_array_equal(got_dep.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want_dep))


def test_augment_batch_draws_from_its_generator():
    image = torch.arange(4 * 3 * 2 * 5, dtype=torch.float32).view(4, 3, 2, 5)
    depth = torch.arange(4 * 2 * 5, dtype=torch.float32).view(4, 1, 2, 5)
    a = augment_batch(torch.Generator().manual_seed(3), image, depth)
    b = augment_batch(torch.Generator().manual_seed(3), image, depth)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    seen = {augment_batch(torch.Generator().manual_seed(s), image, depth)[0]
            .numpy().tobytes() for s in range(8)}
    assert len(seen) > 1
    # every sample is the original or its flip, with some channel order
    for s in range(4):
        planes = {image[s, c].numpy().tobytes() for c in range(3)}
        planes |= {image[s, c].flip(1).numpy().tobytes() for c in range(3)}
        assert all(a[0][s, c].numpy().tobytes() in planes for c in range(3))


def _small_step(image, depth, **kwargs):
    """The loss of one f32 step of a seeded GuideDepth-S on the batch."""
    from tpudepth_torch.models.layers import init_random_

    model = init_random_(build_model("GuideDepth-S"), seed=0)
    return _port_step(model, (image, depth), **kwargs)[1].item()


def test_raw_uint8_and_uint16_batches_are_normalized_on_the_device():
    rng = np.random.default_rng(2)
    image8 = rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
    depth8 = rng.integers(0, 256, (1, 64, 64, 1), dtype=np.uint8)
    depth16 = rng.integers(0, 2560, (1, 64, 64, 1)).astype(np.uint16)
    image_f = image8.astype(np.float32) * np.float32(1.0 / 255.0)

    got = _small_step(image8, depth8)
    want = _small_step(image_f, depth8.astype(np.float32) * np.float32(1 / 255))
    assert got == pytest.approx(want, rel=1e-6)

    got = _small_step(image8, depth16, depth_post_scale=1.0 / 256.0)
    want = _small_step(image_f, depth16.astype(np.float32) * np.float32(1 / 256))
    assert got == pytest.approx(want, rel=1e-6)
    # a float batch is taken as it is: depth_post_scale is for integers only
    again = _small_step(image_f, depth16.astype(np.float32) / 256,
                        depth_post_scale=1.0 / 256.0)
    assert again == pytest.approx(want, rel=1e-6)


def test_only_a_down_resize_is_applied():
    rng = np.random.default_rng(4)
    image = rng.random((1, 128, 128, 3), dtype=np.float32)
    depth = rng.random((1, 128, 128, 1), dtype=np.float32)
    from tpudepth_torch.ops.image import resize_bilinear

    def down(x):
        t = torch.from_numpy(x).permute(0, 3, 1, 2)
        return resize_bilinear(t, (64, 64)).permute(0, 2, 3, 1).numpy()

    got = _small_step(image, depth, train_hw=(64, 64))
    want = _small_step(down(image), down(depth))
    assert got == pytest.approx(want, rel=1e-6)
    up = _small_step(down(image), down(depth), train_hw=(128, 128))
    assert up == pytest.approx(want, rel=1e-6)


def test_check_grads_turns_a_poisoned_step_into_nan():
    from tpudepth_torch.models.layers import init_random_

    rng = np.random.default_rng(6)
    image = rng.random((1, 64, 64, 3), dtype=np.float32)
    depth = rng.random((1, 64, 64, 1), dtype=np.float32)
    assert np.isfinite(_small_step(image, depth, check_grads=True))
    model = init_random_(build_model("GuideDepth-S"), seed=0)
    model.up_3.reduce.weight.register_hook(
        lambda g: torch.full_like(g, float("inf")))
    loss = _port_step(model, (image, depth), check_grads=True)[1]
    assert torch.isnan(loss)


def test_loss_recipe_kinds():
    """The masked L1 and the root recipe (min-max target, box SSIM + 0.1 L1,
    with and without SILog) against the JAX package's recipes."""
    with pytest.raises(ValueError):
        ttr.LossRecipe(kind="huber")
    p = torch.rand(2, 1, 16, 16, generator=torch.Generator().manual_seed(0))
    d = torch.rand(2, 1, 16, 16, generator=torch.Generator().manual_seed(1))
    d[0, 0, :4] = 0.0
    jd = jnp.asarray(d.permute(0, 2, 3, 1).numpy())
    for kwargs, scale in (({"kind": "l1"}, 10.0), ({"kind": "root"}, 1.0),
                          ({"kind": "root", "silog_weight": 0.5}, 1.0)):
        recipe = ttr.LossRecipe(max_depth=10.0, depth_scale=10.0, **kwargs)
        jrecipe = jtr.LossRecipe(max_depth=10.0, depth_scale=10.0, **kwargs)
        pred = p * scale
        target = recipe.target(d)
        np.testing.assert_allclose(target.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(jrecipe.target(jd)), rtol=1e-6,
                                   atol=1e-7)
        got = recipe.loss(pred, target).item()
        want = float(jrecipe.loss(
            jnp.asarray(pred.permute(0, 2, 3, 1).numpy()), jrecipe.target(jd)))
        assert got == pytest.approx(want, rel=1e-5), kwargs
