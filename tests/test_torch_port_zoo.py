"""The rest of the port's model zoo against the JAX package, on the CPU:
MobileV3DenseDepth, MobileV3UNet and MobileV3UNetInterp (large and small),
their layers, the registry's names and the trainer's switches.

The same weights feed both packages: the JAX model's own tree filled from a
numpy seed and carried to the port by ``jax_weights.zoo_state_dict_from_flax``
(no converter of the JAX package covers these models, so this bridge and
this parity are the only numeric check either package gets for them).
Tolerance: rtol 1e-3, atol 1e-4 in f32 eval (what ``tests/test_models.py``
holds the JAX model to against the reference PyTorch model). The float64
train steps hold what ``tests/torch_port_jax_steps.py::check_step64`` holds:
forward and mutated statistics rtol 1e-3 / atol 1e-4, loss rtol 1e-5, each
gradient to 1e-3 of its tensor's largest.
"""

import flax.linen as fnn
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tpudepth.models import registry as jax_registry
from tpudepth.models import build_model as jax_build_model
from tpudepth.models.layers import ConvTranspose as JaxConvTranspose
from tpudepth.ops import image as jax_image
from torch_port_helpers import torch_one_thread  # noqa: F401 (autouse)
from torch_port_jax_steps import (
    BRIDGE,
    aliases,
    batch,
    check_step64,
    jax_step64,
    random_variables,
)
from tpudepth_torch.core.config import TrainConfig
from tpudepth_torch.models import registry
from tpudepth_torch.models.jax_weights import ZOO_MODELS, zoo_state_dict_from_flax
from tpudepth_torch.models.layers import ConvTranspose, init_random_
from tpudepth_torch.models.registry import build_model
from tpudepth_torch.ops import image as port_image
from tpudepth_torch.train import trainer as ttr

RTOL, ATOL = 1e-3, 1e-4
# the U-Net takes multiples of 64 only; the others a size that is not
HW = {"densedepth": (96, 128), "unet": (128, 128), "unet_interp": (96, 128),
      "unet_interp_small": (96, 128)}
CLASSES = {"densedepth": "MobileV3DenseDepth", "unet": "MobileV3UNet",
           "unet_interp": "MobileV3UNetInterp",
           "unet_interp_small": "MobileV3UNetInterp"}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


# -- layers ---------------------------------------------------------------------

def test_conv_transpose_matches_flax_on_an_asymmetric_kernel(rng):
    """The bridge turns flax's (kh, kw, in, out) kernel into torch's
    (in, out, kh, kw) and flips it in H and W; an asymmetric kernel shows a
    missing or extra flip."""
    x = rng.standard_normal((2, 5, 7, 6)).astype(np.float32)
    mod = JaxConvTranspose(4)
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    kernel = np.asarray(v["params"]["ConvTranspose_0"]["kernel"])
    assert kernel.shape == (2, 2, 6, 4)
    assert not np.allclose(kernel, kernel[::-1, ::-1])
    bias = rng.standard_normal(4).astype(np.float32)
    v = {"params": {"ConvTranspose_0": {"kernel": kernel, "bias": bias}}}
    want = np.asarray(mod.apply(v, jnp.asarray(x)))
    port = ConvTranspose(6, 4)
    port.load_state_dict({
        "weight": torch.from_numpy(np.ascontiguousarray(
            np.transpose(kernel, (2, 3, 0, 1))[:, :, ::-1, ::-1])),
        "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        got = _nhwc(port(_nchw(x)))
    assert got.shape == (2, 10, 14, 4)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    with torch.no_grad():
        unflipped = port.weight.flip(2, 3)
        wrong = torch.nn.functional.conv_transpose2d(
            _nchw(x), unflipped, port.bias, 2)
    assert np.abs(_nhwc(wrong) - want).max() > 1e-2


@pytest.mark.parametrize("size,align", [((15, 20), (30, 40)),
                                        ((8, 10), (15, 20)),
                                        ((4, 5), (8, 10))])
def test_resize_bilinear_align_corners_at_the_zoo_sizes(rng, size, align):
    """The zoo's UpSample stages resize with align_corners=True to the
    skip's size: 15 -> 30, and 8 -> 15 where a skip's side is odd. Both
    interpolate in f32 along H, then W, with their weights from other
    formulas: a few ulps of the unit-normal values (atol 1e-5); a wrong
    corner rule is off by 1e-1."""
    x = rng.standard_normal((2, *size, 3)).astype(np.float32)
    want = np.asarray(jax_image.resize_bilinear(jnp.asarray(x), align,
                                                align_corners=True))
    got = _nhwc(port_image.resize_bilinear(_nchw(x), align,
                                           align_corners=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size", [(15, 20), (7, 9), (4, 4)])
def test_max_pool_floors_an_odd_side_as_jax(rng, size):
    x = rng.standard_normal((2, *size, 3)).astype(np.float32)
    want = np.asarray(jax_image.max_pool(jnp.asarray(x), 2, 2))
    got = _nhwc(port_image.max_pool(_nchw(x), 2, 2))
    assert got.shape == want.shape == (2, size[0] // 2, size[1] // 2, 3)
    np.testing.assert_array_equal(got, want)


# -- the registry ------------------------------------------------------------------

def test_aliases_and_model_names_equal_jax():
    assert registry._ALIASES == jax_registry._ALIASES
    assert registry.MODEL_NAMES == jax_registry.MODEL_NAMES
    for alias, canon in registry._ALIASES.items():
        assert (registry.canonical_model_name(alias.upper())
                == jax_registry.canonical_model_name(alias.upper()) == canon)


@pytest.mark.parametrize("name", ZOO_MODELS)
def test_build_model_builds_every_alias_and_refuses_the_other_modes(name):
    for alias in aliases(name):
        assert type(build_model(alias)).__name__ == CLASSES[name]
    with pytest.raises(ValueError, match="attn"):
        build_model(name, attn="row")
    with pytest.raises(ValueError, match="gub"):
        build_model(name, gub="fused")
    with pytest.raises(ValueError, match="gub"):
        build_model("sam", gub="fused")
    with pytest.raises(ValueError, match="unknown model"):
        build_model("resnet")


def test_parameter_counts_equal_jax():
    """The JAX model's parameter count (eval_shape of its init) and the
    port's, and every leaf of the JAX tree carried across."""
    for name in ZOO_MODELS:
        model = jax_build_model(name)
        shapes = jax.eval_shape(
            lambda k, x, m=model: m.init(k, x, train=False),
            jax.random.PRNGKey(0), jnp.zeros((1, *HW[name], 3), jnp.float32))
        n_jax = sum(int(np.prod(a.shape))
                    for a in jax.tree_util.tree_leaves(shapes["params"]))
        port = build_model(name)
        assert sum(p.numel() for p in port.parameters()) == n_jax, name
        keys = set(port.state_dict())
        filled = jax.tree_util.tree_map(
            lambda a: np.zeros(a.shape, np.float32), shapes)
        assert set(zoo_state_dict_from_flax(name, filled)) == keys, name


def test_the_unet_takes_multiples_of_64_only_as_jax():
    """96x128: the JAX U-Net fails at its first concat (3 rows against a
    pooled-and-doubled 2); the port refuses with the rule."""
    model = jax_build_model("unet")
    with pytest.raises(TypeError):
        jax.eval_shape(lambda k, x: model.init(k, x, train=False),
                       jax.random.PRNGKey(0),
                       jnp.zeros((1, 96, 128, 3), jnp.float32))
    with pytest.raises(ValueError, match="multiples of 64"):
        build_model("unet")(torch.zeros(1, 3, 96, 128))


# -- the models against JAX -----------------------------------------------------


def _eval_case(name, seed):
    variables = random_variables(name, seed, hw=HW[name])
    x = np.random.default_rng(seed + 1).random((1, *HW[name], 3),
                                               dtype=np.float32)
    model = jax_build_model(name)
    want = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(
        variables, jnp.asarray(x)))
    return variables, x, want


@pytest.fixture(scope="module")
def densedepth():
    return _eval_case("densedepth", 31)


@pytest.fixture(scope="module")
def unet():
    return _eval_case("unet", 33)


@pytest.fixture(scope="module")
def unet_interp():
    return _eval_case("unet_interp", 35)


@pytest.fixture(scope="module")
def unet_interp_small():
    return _eval_case("unet_interp_small", 37)


@pytest.mark.parametrize("name", ZOO_MODELS)
def test_model_matches_jax_in_eval(request, name):
    variables, x, want = request.getfixturevalue(name)
    port = build_model(name)
    port.load_state_dict(zoo_state_dict_from_flax(name, variables))
    with torch.no_grad():
        got = port.eval()(_nchw(x).contiguous(memory_format=torch.channels_last))
    h, w = HW[name]
    assert got.shape == (1, 1, h // 2, w // 2) and got.dtype == torch.float32
    assert np.std(want) > 1e-2  # the comparison is not of a constant
    np.testing.assert_allclose(_nhwc(got), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ZOO_MODELS)
def test_bf16_output_keeps_the_input_dtype(name):
    port = init_random_(build_model(name), seed=1).eval()
    x = torch.rand(1, 3, 64, 128).to(torch.bfloat16)
    with torch.no_grad():
        out = port(x)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 1, 32, 64)
    assert torch.isfinite(out).all()


# -- training -------------------------------------------------------------------

@pytest.mark.parametrize("name,hw", [("densedepth", (64, 96)),
                                     ("unet", (64, 128))])
def test_float64_step_matches_jax(name, hw):
    """One root-recipe train step, the target resized to the half-size
    prediction in both packages; ``unet`` carries the transposed convs."""
    variables = random_variables(name, 41, hw=hw)
    image, depth = batch(43, hw=hw)
    want = jax_step64(name, variables, image, depth)
    assert want["pred"].shape == (2, hw[0] // 2, hw[1] // 2, 1)
    check_step64(name, variables, want, image, depth)


@pytest.mark.parametrize("name", ZOO_MODELS)
def test_trainer_recipe_is_root_with_the_encoder_trained(name):
    """For every name and alias: the root recipe (as the JAX trainer, for
    any model outside the GuideDepth family) and no frozen parameter; only
    ``sam`` freezes its encoder."""
    for alias in aliases(name):
        t = ttr.Trainer(TrainConfig(model=alias, compute_dtype="float32"),
                        device="cpu")
        assert t.model_name == name
        assert type(t.model).__name__ == CLASSES[name]
        assert t.recipe.kind == "root" and not t.freeze_encoder
        state = t.init_state()
        n_opt = sum(len(g["params"]) for g in state.optimizer.param_groups)
        assert n_opt == len(list(t.model.parameters()))
    assert BRIDGE[name][1] is not None
