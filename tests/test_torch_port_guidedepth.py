"""Port GuideDepth (tpudepth_torch) against the JAX GuideDepth: the weight
bridge, and the eval forward in the plain and the fused GUB configuration,
unpacked and packed (space-to-depth stages, the JAX package's default).

The same JAX variables (the JAX model's parameter tree filled from a numpy
seed, with BatchNorm statistics, scales and biases away from (0, 1) so every
BN affine and prelude is non-trivial) feed both packages. The fused JAX path runs under
``TPUDEPTH_GUB=fused`` with its Pallas kernel in interpret mode on the CPU;
the fused port path runs the plain version of its CUDA kernel on the CPU.
Each JAX output is computed once for the module (:func:`jax_outputs`).
Tolerance: rtol 1e-3, atol 1e-4 in f32 (what ``tests/test_models.py`` holds
the JAX model to against the reference PyTorch model).
"""

import contextlib
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tpudepth.models import build_model as jax_build_model
from tpudepth.models.torch_import import convert_guidedepth, state_dict_to_numpy
from tpudepth_torch.models.guidedepth import GuidedUpsamplingBlock
from tpudepth_torch.models.jax_weights import guidedepth_state_dict_from_flax
from tpudepth_torch.models.registry import build_model

HW = (96, 128)


def _random_variables(name: str, seed: int):
    """JAX variables of the model's own structure (``jax.eval_shape`` of its
    init), filled from a numpy seed: lecun-normal conv and dense kernels, and
    non-trivial BN statistics, scales and biases."""
    model = jax_build_model(name)
    shapes = jax.eval_shape(lambda k, x: model.init(k, x, train=False),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, *HW, 3), jnp.float32))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        key = jax.tree_util.keystr(path)
        shape = leaf.shape
        if key.endswith("['kernel']"):
            fan_in = int(np.prod(shape[:-1]))
            arr = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif key.endswith("['mean']"):
            arr = 0.1 * rng.standard_normal(shape)
        elif key.endswith("['var']") or key.endswith("['scale']"):
            arr = rng.uniform(0.5, 1.5, shape)
        else:
            assert key.endswith("['bias']"), key
            arr = 0.05 * rng.standard_normal(shape)
        return arr.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def variables():
    return {name: _random_variables(name, seed)
            for seed, name in enumerate(["GuideDepth", "GuideDepth-S"])}


def _port_model(name, gub, flax_vars, **options):
    model = build_model(name, gub=gub, **options)
    model.load_state_dict(guidedepth_state_dict_from_flax(flax_vars))
    return model.eval()


@contextlib.contextmanager
def _gub_env(gub):
    """``TPUDEPTH_GUB=fused`` (the JAX package's fused stages) for the block
    when ``gub`` is ``'fused'``, unset otherwise."""
    before = os.environ.pop("TPUDEPTH_GUB", None)
    if gub == "fused":
        os.environ["TPUDEPTH_GUB"] = "fused"
    try:
        yield
    finally:
        os.environ.pop("TPUDEPTH_GUB", None)
        if before is not None:
            os.environ["TPUDEPTH_GUB"] = before


#: the input of every eval-forward comparison
X = np.random.default_rng(7).standard_normal((1, *HW, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_outputs(variables):
    """``get(name, gub, **options)``: the JAX default (packed) model's eval
    output on :data:`X`, computed once a configuration."""
    cache = {}

    def get(name, gub, **options):
        key = (name, gub, tuple(sorted(options.items())))
        if key not in cache:
            model = jax_build_model(name, **options)
            with _gub_env(gub):
                cache[key] = np.asarray(jax.jit(
                    lambda v, x: model.apply(v, x, train=False))(
                        variables[name], jnp.asarray(X)))
        return cache[key]

    return get


def _port_forward(port):
    with torch.no_grad():
        got = port(torch.from_numpy(X).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last))
    return got.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("name", ["GuideDepth", "GuideDepth-S"])
def test_bridge_covers_every_leaf_and_entry(variables, name):
    flax_vars = variables[name]
    sd = guidedepth_state_dict_from_flax(flax_vars)
    want = build_model(name).state_dict()
    assert set(sd) == set(want)
    for k, v in want.items():
        assert sd[k].shape == v.shape, k
    n_flax = sum(a.size for a in jax.tree_util.tree_leaves(flax_vars))
    n_port = sum(v.numel() for k, v in sd.items()
                 if not k.endswith("num_batches_tracked"))
    assert n_flax == n_port


def test_bridge_rejects_a_leaf_it_does_not_consume(variables):
    flax_vars = jax.tree_util.tree_map(lambda a: a, variables["GuideDepth"])
    flax_vars["params"]["up_1"]["stray"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="stray"):
        guidedepth_state_dict_from_flax(flax_vars)


def test_bridge_round_trip_through_convert_guidedepth(variables):
    flax_vars = variables["GuideDepth"]
    port = _port_model("GuideDepth", "plain", flax_vars)
    back = convert_guidedepth(state_dict_to_numpy(port.state_dict()))
    want = dict(jax.tree_util.tree_leaves_with_path(flax_vars))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(map(jax.tree_util.keystr, want)) == set(
        map(jax.tree_util.keystr, got))
    got = {jax.tree_util.keystr(k): v for k, v in got.items()}
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[jax.tree_util.keystr(k)]),
                                      v, err_msg=jax.tree_util.keystr(k))


@pytest.mark.parametrize("name,gub", [("GuideDepth", "plain"),
                                      ("GuideDepth", "fused"),
                                      ("GuideDepth-S", "fused")])
def test_eval_forward_matches_jax(variables, jax_outputs, name, gub):
    want = jax_outputs(name, gub)
    got = _port_forward(_port_model(name, gub, variables[name]))
    assert got.shape == want.shape == (1, *HW, 1)
    assert np.std(want) > 1e-2  # the comparison is not of a constant
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


#: (name, the port's gub mode, the JAX run it is held against, JAX options):
#: the packed port in both modes against the JAX default model (its plain
#: and fused runs compute the same function), and GuideDepth-S with the
#: override of 256-channel stages and a 192-channel guide
PACKED_CASES = [
    ("GuideDepth", "plain", "plain", {}),
    ("GuideDepth", "fused", "fused", {}),
    ("GuideDepth-S", "plain", "fused", {}),
    ("GuideDepth-S", "fused", "fused", {}),
    ("GuideDepth-S", "fused", "plain",
     {"packed_blocks": ((2, 4), (4, 8), (8, 8))}),
]


@pytest.mark.parametrize("name,gub,jax_gub,options", PACKED_CASES,
                         ids=["GuideDepth-plain", "GuideDepth-fused",
                              "GuideDepth-S-plain", "GuideDepth-S-fused",
                              "GuideDepth-S-fused-blocks"])
def test_packed_eval_forward_matches_jax(variables, jax_outputs, name, gub,
                                         jax_gub, options):
    port = _port_model(name, gub, variables[name], packed=True, **options)
    blocks = port.stage_blocks(*HW)
    assert sum(b is not None for b in blocks) >= 2, blocks
    want = jax_outputs(name, jax_gub, **options)
    got = _port_forward(port)
    assert got.shape == want.shape == (1, *HW, 1)
    assert np.std(want) > 1e-2
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("name", ["GuideDepth", "GuideDepth-S"])
def test_the_bridge_loads_into_a_packed_model(variables, name):
    """Packing changes no parameter or buffer: the bridge's state dict loads
    strictly into a packed fused model, key for key and shape for shape."""
    sd = guidedepth_state_dict_from_flax(variables[name])
    packed = build_model(name, gub="fused", packed=True)
    packed.load_state_dict(sd)
    assert {k: v.shape for k, v in packed.state_dict().items()} == {
        k: v.shape for k, v in build_model(name).state_dict().items()}


def test_fused_gub_runs_forward_and_backward_in_train_mode():
    """Train mode of the fused stages (held against the JAX block in
    ``tests/test_torch_port_gub_train.py``): every parameter but the conv
    biases in front of a BatchNorm gets a gradient that is not zero."""
    gub = GuidedUpsamplingBlock(4, 4, 1, fused=True).train()
    gen = torch.Generator().manual_seed(0)
    out = gub(torch.rand(2, 3, 8, 8, generator=gen),
              torch.rand(2, 4, 8, 8, generator=gen))
    assert out.shape == (2, 1, 8, 8)
    out.square().mean().backward()
    for name, p in gub.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        if not (name.endswith(".bias") and name != "reduce.bias"
                and name[-6] in "03"):
            assert float(p.grad.abs().max()) > 0, name


def test_build_model_rejects_unported_names():
    """Every name of the JAX registry is ported; a name it lacks raises."""
    with pytest.raises(ValueError, match="unknown model"):
        build_model("resnet")
    with pytest.raises(ValueError):
        build_model("GuideDepth", gub="packed")


def test_cli_serves_the_plain_gub_unless_asked_as_the_reference_does(
        monkeypatch):
    """The JAX package takes its fused GUB stages only when
    ``TPUDEPTH_GUB=fused`` is set; the port's CLI takes them only when
    ``--gub fused`` is given."""
    from tpudepth.models.guidedepth import gub_fused_enabled
    from tpudepth_torch import inference as cli

    monkeypatch.delenv("TPUDEPTH_GUB", raising=False)
    assert not gub_fused_enabled()
    assert cli.get_args([]).gub == "plain"
    monkeypatch.setenv("TPUDEPTH_GUB", "fused")
    assert gub_fused_enabled() and cli.get_args(["--gub", "fused"]).gub == (
        "fused")
