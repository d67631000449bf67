"""The serving kernels as ``tpudepth::*`` custom ops and the engine's
serialization through ``torch.export``, on the CPU.

- ``torch.library.opcheck`` of each of the eight ops on small CPU inputs
  (schema, fake kernel against the real one, AOT dispatch);
- an engine serialized and deserialized (``InferenceEngine.serialize`` /
  ``deserialize``) gives the live engine's bits, for GuideDepth-S plain and
  fused and a zoo model, with and without flip-TTA and the meters
  conversion (SAM and NewCRF in ``tests/test_torch_port_export_attn.py``);
  the program calls the ops, once a kernel launch of the eager forward;
- the port's deserialized engine against the JAX package's deserialized
  engine on the same weights (f32, rtol 1e-3 / atol 1e-4: what
  ``tests/test_models.py`` holds the JAX model to against the reference);
- ``inference.main(... --engine_path ...)`` writes the
  ``engine_bf16_deserialized`` row; ``deserialize`` refuses another device.

On the CPU each op runs its wrapper's plain version, so the round trip
holds the graph around the kernels, which is what the card runs too.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tpudepth.infer.engine import InferenceEngine as JaxInferenceEngine
from tpudepth.models import build_model as jax_build_model
from torch_port_helpers import round_trip, same_bits_deserialized
from torch_port_helpers import serving_op_cases
from torch_port_helpers import torch_one_thread  # noqa: F401 (autouse)
from torch_port_jax_steps import random_variables
from tpudepth_torch.infer.engine import InferenceEngine
from tpudepth_torch.models.jax_weights import zoo_state_dict_from_flax
from tpudepth_torch.models.layers import init_random_
from tpudepth_torch.models.registry import build_model
from tpudepth_torch.ops.kernels import _op

RTOL, ATOL = 1e-3, 1e-4
MAX_DEPTH = 10.0  # the engines' meters conversion
OPS = ("gub_conv_fwd", "window_attn_infer", "block_epilogue_infer",
       "mlp_infer", "crf_rowblock_infer", "sam_rowblock_infer",
       "sam_block_infer", "crf_block_infer")


@pytest.mark.parametrize("name", OPS)
def test_opcheck_of_each_serving_op(name):
    op, _, args = serving_op_cases("cpu")[name]
    assert str(op) == f"tpudepth.{name}.default"
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_gub_conv_op_with_statistics_and_without_a_prelude():
    op, run, args = serving_op_cases("cpu")["gub_conv_fwd"]
    parts, w, b, _, _, _, _ = args
    for call in ((parts, w, b, [], [], None, True),
                 (parts[:1], w[:, :, :16], b, [], [], None, False)):
        assert set(torch.library.opcheck(op, call).values()) == {"SUCCESS"}
    y, s, q = op(*args[:-1], True)
    torch.testing.assert_close(s, y.float().sum(dim=(0, 1, 2)))
    assert q.shape == (32,)


@pytest.mark.parametrize("name", OPS)
def test_op_and_direct_call_give_the_same_bits_on_the_cpu(name):
    op, run, args = serving_op_cases("cpu", dtype=torch.bfloat16)[name]
    got, want = op(*args), run(*args)
    for g, w in zip(*(t if isinstance(t, tuple) else (t,) for t in (got, want))):
        assert torch.equal(g, w)


@pytest.mark.parametrize("gub,tta,meters", [("plain", False, True),
                                            ("fused", True, True),
                                            ("fused", False, False)])
def test_guidedepth_s_engine_round_trips_bit_for_bit(tmp_path, gub, tta,
                                                     meters):
    model = init_random_(build_model("GuideDepth-S", gub=gub), seed=1)
    ops = round_trip(tmp_path, model, (64, 64), tta=tta, meters=meters)
    # the fused stages: three k=3 convs a GUB, three GUBs a forward
    assert ops == ({"gub_conv_fwd": 9 * (1 + tta)} if gub == "fused" else {})


@pytest.fixture(scope="module")
def zoo_engine(tmp_path_factory):
    """The bf16 ``unet_interp_small`` engine at 32x64 with flip-TTA and the
    meters conversion, and the file it serialized to (one export for the
    tests that read it)."""
    model = init_random_(build_model("unet_interp_small"), seed=2)
    live = InferenceEngine(model, (1, 3, 32, 64),
                           compute_dtype=torch.bfloat16, flip_tta=True,
                           max_depth=MAX_DEPTH, device="cpu")
    path = str(tmp_path_factory.mktemp("zoo") / "engine.pt2")
    live.serialize(path)
    return live, path


def test_zoo_engine_round_trips_bit_for_bit(zoo_engine):
    assert same_bits_deserialized(*zoo_engine) == {}


def test_export_route_traces_through_the_ops(monkeypatch):
    """An eager call skips the dispatcher and gives the bits of a call
    through the ops (the round trips hold that the export trace goes
    through the ops and that its program gives the eager bits)."""
    assert not _op.through_op()
    model = init_random_(build_model("sam", attn="fused"), seed=3)
    eng = InferenceEngine(model, (1, 3, 32, 32),
                          compute_dtype=torch.bfloat16, device="cpu")
    x = np.random.default_rng(4).random((1, 3, 32, 32), dtype=np.float32)
    want = eng(x)
    with monkeypatch.context() as m:
        m.setattr(_op, "through_op", lambda: True)
        assert torch.equal(eng(x), want)


@pytest.fixture(scope="module")
def zoo_weights():
    """JAX variables of ``unet_interp_small`` from a numpy seed."""
    return random_variables("unet_interp_small", 5, hw=(64, 96))


def test_deserialized_engine_matches_the_jax_deserialized_engine(
        tmp_path, zoo_weights):
    """f32 with the meters conversion in both engines; each serialized,
    deserialized and run on the same image."""
    shape = (1, 64, 96, 3)
    jax_engine = JaxInferenceEngine(
        jax_build_model("unet_interp_small"), zoo_weights, shape,
        compute_dtype=jnp.float32, max_depth=MAX_DEPTH)
    jax_path = str(tmp_path / "jax_engine.bin")
    jax_engine.serialize(jax_path)
    x = np.random.default_rng(6).random(shape, dtype=np.float32)
    want = np.asarray(JaxInferenceEngine.deserialize(jax_path)(x))

    port = build_model("unet_interp_small")
    port.load_state_dict(zoo_state_dict_from_flax("unet_interp_small",
                                                  zoo_weights))
    live = InferenceEngine(port, (1, 3, 64, 96), compute_dtype=torch.float32,
                           max_depth=MAX_DEPTH, device="cpu")
    path = str(tmp_path / "engine.pt2")
    live.serialize(path)
    got = InferenceEngine.deserialize(path)(np.transpose(x, (0, 3, 1, 2)))
    assert got.shape == (1, 1, 32, 48) and np.std(want) > 1e-2
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=RTOL, atol=ATOL)


def test_deserialize_refuses_another_device(tmp_path, zoo_engine):
    _, path = zoo_engine
    loaded = InferenceEngine.deserialize(path, device="cpu")
    assert loaded.device.type == "cpu"
    with pytest.raises(ValueError, match="built for"):
        loaded(np.zeros((1, 3, 32, 32), np.float32))
    with pytest.raises(ValueError, match="is not moved"):
        InferenceEngine.deserialize(path, device="cuda")
    # a program saved without the engine's description
    torch.export.save(loaded.program, str(tmp_path / "bare.pt2"))
    with pytest.raises(ValueError, match="InferenceEngine.serialize"):
        InferenceEngine.deserialize(str(tmp_path / "bare.pt2"))


def test_inference_cli_writes_the_deserialized_engine_row(tmp_path,
                                                          monkeypatch):
    from tpudepth_torch import inference

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    path = str(tmp_path / "engine.pt2")
    out = inference.main([
        "--model", "unet_interp_small", "--resolution", "mini", "--eval",
        "--device", "cpu", "--num_test_runs", "0", "--data_path",
        "synthetic:48x64", "--engine_path", path, "--save_results",
        str(tmp_path / "res")])
    assert os.path.isfile(path)
    rows = (tmp_path / "res" / "inference_results.txt").read_text().split()
    assert rows[0] == "backend,s/frame,FPS,img/s,RMSE,Delta1"
    assert [r.split(",")[0] for r in rows[1:]] == [
        "torch_f32", "engine_bf16", "engine_bf16_deserialized"]
    live, deser = out["metrics"], out["deserialized_metrics"]
    assert np.isfinite(deser.rmse) and (live.rmse, live.delta1) == (
        deser.rmse, deser.delta1)
    assert rows[3] == "engine_bf16_deserialized,,,,{:.3f},{:.3f}".format(
        deser.rmse, deser.delta1)
