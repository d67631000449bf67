"""Port serving engine and depth normalization against the JAX ones.

The engine comparison feeds one set of weights to both packages: a port
GuideDepth filled from a numpy seed, carried to JAX by
``tpudepth.models.torch_import.convert_guidedepth``. f32 on the CPU,
tolerance rtol 1e-3, atol 1e-4 (``tests/test_models.py``).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tpudepth.infer.engine import InferenceEngine as JaxEngine
from tpudepth.models import build_model as jax_build_model
from tpudepth.models.torch_import import convert_guidedepth, state_dict_to_numpy
from tpudepth.train import trainer as jax_trainer
from tpudepth_torch import inference as cli
from tpudepth_torch.core.runtime import resolve_device
from tpudepth_torch.infer.engine import InferenceEngine, speedtest
from tpudepth_torch.models.layers import init_random_
from tpudepth_torch.models.registry import build_model
from tpudepth_torch.train import trainer


@pytest.mark.parametrize("fn", ["inverse_depth_norm", "depth_norm"])
@pytest.mark.parametrize("max_depth", [10.0, 80.0])
def test_depth_norms_match_jax(fn, max_depth):
    rng = np.random.default_rng(0)
    d = rng.uniform(-1.0, 2.0 * max_depth, (4, 1, 9, 11)).astype(np.float32)
    d[0, 0, :3] = 0.0  # zeros stay zero
    d[1, 0, 0, :4] = [1e-6, max_depth / 100.0, max_depth, 1e4]
    want = np.asarray(getattr(jax_trainer, fn)(jnp.asarray(d), max_depth))
    got = getattr(trainer, fn)(torch.from_numpy(d), max_depth).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert np.all(got[0, 0, :3] == 0.0)


@pytest.mark.parametrize("gub", ["plain", "fused"])
def test_engine_matches_jax_engine(gub, monkeypatch):
    if gub == "fused":
        monkeypatch.setenv("TPUDEPTH_GUB", "fused")
    else:
        monkeypatch.delenv("TPUDEPTH_GUB", raising=False)
    port = init_random_(build_model("GuideDepth", gub=gub), seed=3)
    variables = convert_guidedepth(state_dict_to_numpy(port.state_dict()))
    x = np.random.default_rng(4).random((1, 96, 128, 3), dtype=np.float32)

    jeng = JaxEngine(jax_build_model("GuideDepth"), variables, x.shape,
                     compute_dtype=jnp.float32, flip_tta=True, max_depth=10.0)
    want = np.asarray(jeng(x))

    eng = InferenceEngine(port, (1, 3, 96, 128), compute_dtype=torch.float32,
                          flip_tta=True, max_depth=10.0, device="cpu")
    got = eng(x.transpose(0, 3, 1, 2))
    assert got.dtype == torch.float32 and got.shape == (1, 1, 96, 128)
    got = got.permute(0, 2, 3, 1).numpy()
    assert np.all((got >= 0.0) & (got <= 10.0))
    assert np.std(want) > 1e-2
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_engine_rejects_another_shape():
    eng = InferenceEngine(build_model("GuideDepth-S"), (1, 3, 32, 32),
                          compute_dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="built for"):
        eng(np.zeros((2, 3, 32, 32), np.float32))


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_engine_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(build_model("GuideDepth-S"), (1, 3, 32, 32))


def test_speedtest_needs_the_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        speedtest(lambda x: x, torch.zeros(1), 1, 0)


def test_cli_parses_the_speedtest_surface_and_needs_the_card(monkeypatch):
    args = cli.get_args(["--model", "GuideDepth-S", "--resolution", "mini",
                         "--batch_size", "2", "--gub", "plain"])
    assert (args.model, args.resolution, args.batch_size, args.gub) == (
        "GuideDepth-S", "mini", 2, "plain")
    assert cli.get_args([]).gub == "plain"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--model", "GuideDepth-S", "--resolution", "mini"])
