"""The model axis of the port on the CPU: image rows split over four gloo
ranks, against one process and against the JAX package
(``tests/test_spatial_sharding.py``).

Four ranks are spawned once for the module (``tests/torch_port_spatial_
worker.py``, a ``file://`` rendezvous under the module's temporary
directory, torch on one thread each) and build the (1 x 4), (2 x 2) and
(4 x 1) grids of ``core/mesh.py::create_mesh``; the parent computes the JAX
package's runs on its 8-device CPU mesh meanwhile and then reads what the
ranks wrote. A rank that fails or outlives ``JOIN_TIMEOUT`` is killed and
fails the tests. The ranks build each model's weights themselves from a
seed (``torch_port_spatial_worker.build``: ``init_random_``, or torch's own
initialization under ``torch.manual_seed(0)``), and the parent builds the
same to carry them to flax for the JAX package's runs.

Cases and tolerances:

- forwards in eval (``test_spatial_sharding.py:17, 36``): GuideDepth-S and
  ``unet_interp`` at 2x64x64, GuideDepth-S at 1x80x64 (5 rows at 1/16 over
  4 ranks: 2, 1, 1, 1), DenseDepth at 1x96x64 (6 rows at 1/16: 2, 2, 1, 1),
  the transposed-conv U-Net at 1x128x128 and the SAM stage (8/32/16/4,
  2x28x28, marked ``run_whole_on_rows``) on (1 x 4), and GuideDepth-S at
  2x96x128 on (2 x 2) (1/32 of 96 rows is 3, which 2 ranks split 2, 1: the
  port despatializes above it). In float64 the joined rows equal the
  port's single process within 1e-10 of the map's largest value (the halo
  strips' convs and the row-wise resizes sum in other orders); in float32
  they match JAX's apply of ``P("data", "model")`` inputs at JAX's rtol
  1e-4, atol 1e-5. The stem conv's output holds this rank's rows of ``H /
  2`` by ``core/mesh.py::row_bounds``.
- float64 train steps on the grid against one process's first step on
  the whole batch (alhashim: GuideDepth-S at 4x64x64, plain and fused GUB
  stages, on (2 x 2) and (1 x 4), and at 4x80x64 on (1 x 4), where the
  maps from 1/8 down split unequally; root: NewCRF at 2x64x64 on (2 x 2),
  ``test_spatial_sharding.py:154``; SAM with its frozen encoder at 2x64x64
  on (2 x 2), ``__graft_entry__.py:173-220``; DenseDepth at 2x96x64 and the
  U-Net at 2x64x64 on (1 x 4); the interpolated U-Net's 2x80x64 batch
  resized by the step to 70x64, whose input rows split unequally, on
  (1 x 4)): the first step's loss, and
  per tensor every gradient of a trained parameter and every running
  statistic, within 1e-9 of the tensor's largest value, and the parameters
  after it within 1e-9 (a millionth of the learning rate). Tensors under
  1e-6 of the largest of their kind are held to 1e-9 of that largest (the
  conv biases in front of a BatchNorm have a zero gradient, which holds
  rounding noise). The worker computes the losses and the attention
  models' head in float64 (the port's are float32, as the JAX package's).
  A parameter used on rows and one used whole (``layer4``) are both among
  the gradients held, so a share summed where a whole gradient is not (or
  the reverse) fails. SAM's encoder stays bit for bit, its decoder moves.
- JAX's invariants (``test_spatial_sharding.py:60, 154``): GuideDepth-S
  plain on (2 x 2) and NewCRF take three SGD steps (lr 1e-3; the others
  one Adam step), held against the JAX package's single-device run: the
  first loss within 1e-5, the gradient norm (the parameters' change over
  3 lr) within 10 %, and descent on both. As JAX's test starts from its
  models' own initialization, these start from the port's
  (``torch.manual_seed(0)``, what ``Trainer`` does), carried to flax
  (``jax_weights.flax_from_torch``). Both run in float64: in float32 three
  steps of two implementations drift apart through the train-mode
  BatchNorms (GuideDepth-S's gradient norm reads 14.2 in one port process,
  13.0 in JAX's run and 16.0 on the grid), as JAX's test explains for two
  meshes of one implementation. NewCRF runs at 2x64x64, not JAX's
  4x128x128 (see ``STEPS``).
- the (4 x 1) grid's step is the data axis's step bit for bit; every rank
  of a grid ends with the same bits.
- a 3-row map over (1 x 4) (one rank holds no rows) through a conv, the
  transposed conv and a resize on rows, forward and backward, equals the
  whole map's within 1e-12 (float64): the empty rank enters every
  exchange.
- a train-mode BatchNorm, the SE squeeze and ``global_avg_pool`` on rows
  of a 15-row map (4, 4, 4, 3 rows on (1 x 4); 8, 7 on (2 x 2)) equal the
  whole map's within 1e-12 (float64): their means add sums and counts.
- without ranks: ``min_spatial_height`` and ``validate_spatial_input`` at
  ``test_spatial_sharding.py:137``'s numbers and message, an input height
  that does not divide by the model axis raises naming both (the only
  refusal of the model axis beside JAX's guard), the row rule gives every
  row of any map to one rank, and the conv, transposed-conv and resize row
  plans joined equal the whole map's ops, at heights that do not split
  equally and with ranks that hold no rows.
"""

import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import optax
from jax.sharding import NamedSharding, PartitionSpec as P
from tpudepth.core.mesh import create_mesh as jax_create_mesh
from tpudepth.core.mesh import replicated as jax_replicated
from tpudepth.models import build_model as jax_build_model
from tpudepth.models.sam import SAM as JaxSAM
from tpudepth.models.torch_import import (
    _Builder,
    _sam_stage,
    state_dict_to_numpy,
)
from tpudepth.train.trainer import LossRecipe as JaxLossRecipe
from tpudepth.train.trainer import TrainState as JaxTrainState
from tpudepth.train.trainer import make_train_step as jax_make_train_step
import torch_port_spatial_worker as worker
from torch_port_jax_steps import batch

from tpudepth_torch.core import mesh as mesh_lib
from tpudepth_torch.models.jax_weights import flax_from_torch
from tpudepth_torch.models.layers import BatchNorm
from tpudepth_torch.models.layers import (
    conv_plan,
    conv_strip,
    transpose_plan,
    transpose_strip,
)
from tpudepth_torch.ops.image import resize_plan, resize_strip

REPO = pathlib.Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_port_spatial_worker.py"
WORLD = 4
JOIN_TIMEOUT = 240
FWD64_REL = 1e-10
STEP_REL = 1e-9
LR = 1e-3
SAM_STAGE = dict(input_dim=8, embed_dim=32, v_dim=16, num_heads=4)
# name: (model, build options, batch, H x W, grid)
FORWARDS = {
    "GuideDepth-S": ("GuideDepth-S", {}, 2, (64, 64), "1x4"),
    "unet_interp": ("unet_interp", {}, 2, (64, 64), "1x4"),
    "sam_stage": ("sam_stage", SAM_STAGE, 2, (28, 28), "1x4"),
    "GuideDepth-S-96x128": ("GuideDepth-S", {}, 2, (96, 128), "2x2"),
    "GuideDepth-S-80x64": ("GuideDepth-S", {}, 1, (80, 64), "1x4"),
    "densedepth": ("densedepth", {}, 1, (96, 64), "1x4"),
    "unet": ("unet", {}, 1, (128, 128), "1x4"),
}
JAX_FORWARDS = ("GuideDepth-S", "unet_interp", "sam_stage",
                "GuideDepth-S-80x64", "densedepth", "unet")
# name: (model, build options, recipe, H x W, grid, frozen encoder)
# name: (model, build options, recipe, batch, H x W, grid, frozen encoder,
# SGD steps: 0 is one Adam step). The two SGD runs also hold JAX's
# invariants; they start from torch's own initialization (seed None), as
# JAX's test starts from its models' own. NewCRF and SAM run at 2x64x64:
# JAX's test takes 128 rows for its partitioner's guard
# (``min_spatial_height``), which the port's exchange does not need (its
# rows stay equal down to 1/16: 2 rows a rank), and the JAX package's
# float64 NewCRF step takes 15 s on an 8-core CPU at 4x128x128, more than
# this file's share of the gate. In this order the single-process steps,
# spread over the ranks as names[rank::4], put the shortest beside NewCRF's
# and the U-Net's beside the shortest of the first six.
STEPS = {
    "gd-plain-2x2": ("GuideDepth-S", {}, "alhashim", 4, (64, 64), "2x2",
                     False, 3),
    "sam-frozen-2x2": ("sam", {}, "root", 2, (64, 64), "2x2", True, 0),
    "gd-fused-2x2": ("GuideDepth-S", {"gub": "fused"}, "alhashim", 4,
                     (64, 64), "2x2", False, 0),
    "newcrf-2x2": ("newcrf", {}, "root", 2, (64, 64), "2x2", False, 3),
    "gd-plain-1x4": ("GuideDepth-S", {}, "alhashim", 4, (64, 64), "1x4",
                     False, 0),
    "gd-fused-1x4": ("GuideDepth-S", {"gub": "fused"}, "alhashim", 4,
                     (64, 64), "1x4", False, 0),
    "unet-1x4": ("unet", {}, "root", 2, (64, 64), "1x4", False, 0),
    "gd-fused-80-1x4": ("GuideDepth-S", {"gub": "fused"}, "alhashim", 4,
                        (80, 64), "1x4", False, 0),
    "densedepth-1x4": ("densedepth", {}, "root", 2, (96, 64), "1x4", False,
                       0),
    "gd-plain-80-1x4": ("GuideDepth-S", {}, "alhashim", 4, (80, 64), "1x4",
                        False, 0),
    "interp-resized-1x4": ("unet_interp", {}, "root", 2, (80, 64), "1x4",
                           False, 0),
}
SGD = [name for name, case in STEPS.items() if case[7]]
# the steps' ``train_hw``: the batch resized on the whole map to a height
# the model axis does not divide (70 rows over 4 ranks: 18, 18, 17, 17),
# as JAX's step resizes within itself
TRAIN_HW = {"interp-resized-1x4": (70, 64)}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


# the seed of each model's weights (``torch_port_spatial_worker.build``)
SEEDS = {"GuideDepth-S": 41, "unet_interp": 42, "newcrf": 43, "sam": 44,
         "sam_stage": 45, "densedepth": 46, "unet": 47}
# a map of 15 rows per grid (4, 4, 4, 3 rows on (1 x 4); 8, 7 on (2 x 2))
MOMENTS = {"1x4": (2, 6, 15, 5), "2x2": (4, 6, 15, 5)}


def _flax(case):
    """The JAX variables of a case's port weights."""
    state = worker.build(case).state_dict()
    if case["model"] != "sam_stage":
        return flax_from_torch(case["model"], state)
    b = _Builder({f"s.{k}": v for k, v in state_dict_to_numpy(state).items()})
    _sam_stage(b, "s", "s", True, True)
    return {"params": b.variables()["params"]["s"]}


def _forward_inputs(name):
    model, _, bsz, hw, _ = FORWARDS[name]
    rng = np.random.default_rng(7)
    if model == "sam_stage":
        return [rng.standard_normal((bsz, *hw, c)).astype(np.float32)
                for c in (SAM_STAGE["input_dim"], SAM_STAGE["v_dim"])]
    return [rng.random((bsz, *hw, 3)).astype(np.float32)]


def _step_batch(hw, seed=9, bsz=4):
    image, depth = batch(seed, bsz=bsz, hw=hw)
    return torch.from_numpy(image), torch.from_numpy(depth)


# NewCRF's JAX run in a process of its own, beside the parent's JAX runs
# and the ranks: it is the longest of them
JAX_NEWCRF = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import torch
sys.path.insert(0, sys.argv[2])
import test_torch_port_spatial as t
torch.save(t._jax_sgd(t._cases()["steps"]["newcrf-2x2"]), sys.argv[1])
"""


class Ranks:
    """The spawned ranks and NewCRF's JAX run, joined once."""

    def __init__(self, workdir, procs, jax_newcrf):
        self.workdir, self.procs, self.jax_newcrf = workdir, procs, jax_newcrf
        self._results = None

    def _join(self, procs):
        deadline = time.time() + JOIN_TIMEOUT
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.time(), 1))
            except subprocess.TimeoutExpired:
                for q in self.procs + [self.jax_newcrf]:
                    q.kill()
                pytest.fail(f"a process outlived the {JOIN_TIMEOUT} s join "
                            "timeout")
        for p in procs:
            log = pathlib.Path(p.log).read_text()
            assert p.returncode == 0, f"process failed:\n{log[-6000:]}"

    def results(self):
        if self._results is None:
            self._join(self.procs)
            self._results = [torch.load(self.workdir / f"rank{r}.pt",
                                        weights_only=False)
                             for r in range(WORLD)]
        return self._results

    def jax_newcrf_sgd(self):
        self._join([self.jax_newcrf])
        return torch.load(self.workdir / "jax_newcrf.pt", weights_only=False)


def _cases():
    forward = {}
    for name, (model, options, _, _, grid) in FORWARDS.items():
        forward[name] = {"model": model, "options": options, "grid": grid,
                         "seed": SEEDS[model],
                         "inputs": [_nchw(a).double()
                                    for a in _forward_inputs(name)]}
    steps = {}
    for name, (model, options, kind, bsz, hw, grid, freeze,
               sgd_steps) in STEPS.items():
        image, depth = _step_batch(hw, bsz=bsz)
        steps[name] = {"model": model, "options": options, "kind": kind,
                       "grid": grid, "freeze": freeze, "image": image,
                       "depth": depth, "sgd_steps": sgd_steps,
                       "seed": None if sgd_steps else SEEDS[model],
                       "train_hw": TRAIN_HW.get(name)}
    rng = np.random.default_rng(11)
    moments = {grid: torch.from_numpy(1.0 + rng.standard_normal(shape))
               for grid, shape in MOMENTS.items()}
    empty = {"x": torch.from_numpy(rng.standard_normal((2, 3, 3, 8))),
             "w": torch.from_numpy(rng.standard_normal((4, 3, 3, 3))),
             "wt": torch.from_numpy(rng.standard_normal((4, 2, 2, 2))),
             "size": (7, 20)}
    return {"forward": forward, "steps": steps, "moments": moments,
            "empty_rank": empty, "data_only": steps["gd-fused-2x2"]}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Write the cases and start the four ranks."""
    workdir = tmp_path_factory.mktemp("spatial")
    torch.save(_cases(), workdir / "cases.pt")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               TPUDEPTH_CACHE_DIR=str(workdir / "cache"))

    def start(args, env, log):
        p = subprocess.Popen(args, cwd=REPO, env=env, stdout=open(log, "w"),
                             stderr=subprocess.STDOUT)
        p.log = log
        return p

    procs = [start([sys.executable, str(WORKER), f"file://{workdir}/rdzv",
                    str(WORLD), str(r), str(workdir)], env,
                   workdir / f"rank{r}.log") for r in range(WORLD)]
    jax_newcrf = start(
        [sys.executable, "-c", JAX_NEWCRF, str(workdir / "jax_newcrf.pt"),
         str(REPO / "tests")], {**os.environ, "PYTHONPATH": str(REPO)},
        workdir / "jax_newcrf.log")
    handle = Ranks(workdir, procs, jax_newcrf)
    yield handle
    for p in procs + [jax_newcrf]:
        if p.poll() is None:
            p.kill()


def _jax_sgd(case):
    """JAX's three single-device float64 SGD steps (lr 1e-3), as
    ``test_spatial_sharding.py:60`` runs them in float32: losses and
    gradient norm."""
    model_name, kind = case["model"], case["kind"]
    options = {"packed": False} if model_name.startswith("GuideDepth") else {}
    image, depth = case["image"], case["depth"]
    v = _flax(case)
    with jax.enable_x64(True):
        model = jax_build_model(model_name, dtype=jnp.float64, **options)
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v)
        tx = optax.sgd(LR)
        params = v["params"]
        params0 = jax.device_get(params)
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                              batch_stats=v["batch_stats"],
                              opt_state=tx.init(params), tx=tx,
                              apply_fn=model.apply)
        recipe = (JaxLossRecipe(kind="alhashim", max_depth=10.0,
                                depth_scale=10.0) if kind == "alhashim"
                  else JaxLossRecipe(kind="root"))
        step = jax_make_train_step(
            model, recipe, compute_dtype=jnp.float64, augment=False,
            mesh=jax_create_mesh(1, 1, jax.devices()[:1]))
        losses = []
        for i in range(case["sgd_steps"]):
            state, loss = step(state,
                               jnp.asarray(image.numpy(), jnp.float64),
                               jnp.asarray(depth.numpy(), jnp.float64),
                               jax.random.PRNGKey(i))
            losses.append(float(loss))
        gnorm = np.sqrt(sum(
            float(np.sum((np.asarray(a) - np.asarray(b)) ** 2))
            for a, b in zip(jax.tree_util.tree_leaves(params0),
                            jax.tree_util.tree_leaves(
                                jax.device_get(state.params))))) / (
            case["sgd_steps"] * LR)
    return losses, gnorm


@pytest.fixture(scope="module")
def jax_want(ranks):
    """The JAX package's runs, computed while the ranks run: the f32
    forwards of ``P("data", "model")`` inputs on a (1 x 4) mesh (the SAM
    stage's ``P(None, "model")``), and the SGD runs (NewCRF's in its own
    process, ``JAX_NEWCRF``)."""
    mesh = jax_create_mesh(num_data=1, num_model=4)
    cases = _cases()
    out = {}
    for name in JAX_FORWARDS:
        model_name = FORWARDS[name][0]
        v = _flax(cases["forward"][name])
        if model_name == "sam_stage":
            model = JaxSAM(input_dim=8, embed_dim=32, v_dim=16, num_heads=4,
                           use_pallas=False)
            spec = P(None, "model")
            fwd = jax.jit(lambda v, e, q: model.apply(v, e, q))
        else:
            options = ({"packed": False} if model_name.startswith("GuideDepth")
                       else {})
            model = jax_build_model(model_name, **options)
            spec = P("data", "model")
            fwd = jax.jit(lambda v, x: model.apply(v, x, train=False))
        sharded = [jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))
                   for a in _forward_inputs(name)]
        out[name] = np.asarray(fwd(jax.device_put(v, jax_replicated(mesh)),
                                   *sharded))
    out["sgd"] = {"gd-plain-2x2": _jax_sgd(cases["steps"]["gd-plain-2x2"]),
                  "newcrf-2x2": ranks.jax_newcrf_sgd()}
    return out


@pytest.fixture(scope="module")
def results(ranks, jax_want):
    return ranks.results()


def _joined(results, grid, key):
    """The ranks' rows of a forward joined into the global NCHW batch."""
    per = {}
    for r in results:
        d, m = r["coords"][grid]
        per[(d, m)] = r["forward"][key[0]][key[1]]
    nd = 1 + max(d for d, _ in per)
    nm = 1 + max(m for _, m in per)
    return torch.cat([torch.cat([per[(d, m)] for m in range(nm)], dim=2)
                      for d in range(nd)], dim=0)


@pytest.mark.parametrize("name", list(FORWARDS))
def test_forward_on_rows_equals_one_process(results, name):
    grid = FORWARDS[name][4]
    got = _joined(results, grid, (name, str(torch.float64)))
    want = results[0]["forward"][name]["single"]
    assert got.shape == want.shape and float(want.std()) > 1e-3
    assert float((got - want).abs().max()) <= FWD64_REL * float(
        want.abs().max())


@pytest.mark.parametrize("name", JAX_FORWARDS)
def test_forward_on_rows_matches_jax_on_sharded_inputs(results, jax_want,
                                                       name):
    got = _joined(results, FORWARDS[name][4], (name, str(torch.float32)))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               jax_want[name], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["GuideDepth-S", "GuideDepth-S-96x128",
                                  "GuideDepth-S-80x64"])
def test_the_stem_conv_holds_its_share_of_the_rows(results, name):
    _, _, bsz, (h, w), grid = FORWARDS[name]
    nd, nm = (int(n) for n in grid.split("x"))
    bounds = mesh_lib.row_bounds(h // 2, nm)
    for r in results:
        m = r["coords"][grid][1]
        stems = r["forward"][name]["stem"]
        assert stems == [(bsz // nd, 32, bounds[m + 1] - bounds[m],
                          w // 2)], stems


@pytest.mark.parametrize("name", list(STEPS))
def test_step_on_rows_equals_one_process(results, name):
    compared = next(r["single"][name] for r in results
                    if name in r["single"])
    loss = compared["loss"]
    assert np.isfinite(loss["want"])
    assert abs(loss["got"] - loss["want"]) <= STEP_REL * abs(loss["want"])
    for kind in ("grad", "stats"):
        c = compared[kind]
        assert c["n"] > 10, (kind, c)
        assert max(c["rel"], c["floor_rel"]) <= STEP_REL, (kind, c)
    # Adam divides each gradient by its own size, so an element whose
    # gradient is a cancellation carries its float64 rounding into the
    # update: the parameters after it are held to a millionth of lr
    assert compared["after"]["abs"] <= 1e-6 * LR, compared["after"]
    if STEPS[name][0].startswith("GuideDepth"):
        # a parameter on rows (a share) and one on the whole map (whole)
        grads = results[0]["steps"][name]["digest"]
        assert "feature_extractor.layer4.0.conv1.weight:grad" in grads
        assert "feature_extractor.layer1.0.conv1.weight:grad" in grads


@pytest.mark.parametrize("grid", list(MOMENTS))
def test_means_over_unequal_rows_equal_the_whole_maps(results, grid):
    x = _cases()["moments"][grid]
    bn = BatchNorm(x.shape[1]).double().train()
    want = {"bn": bn(x), "se": x.mean(dim=(2, 3)),
            "gap": x.mean(dim=(2, 3), keepdim=True),
            "running_mean": bn.running_mean, "running_var": bn.running_var}
    nd, nm = (int(n) for n in grid.split("x"))
    bounds = mesh_lib.row_bounds(x.shape[2], nm)
    assert len(set(np.diff(bounds))) > 1
    per = {r["coords"][grid]: r["moments"][grid] for r in results}
    b = x.shape[0] // nd
    for (d, m), got in per.items():
        rows = slice(bounds[m], bounds[m + 1])
        local = {"bn": want["bn"][d * b:(d + 1) * b, :, rows],
                 "se": want["se"][d * b:(d + 1) * b],
                 "gap": want["gap"][d * b:(d + 1) * b]}
        for k in want:
            w = local.get(k, want[k]).detach()
            assert got[k].shape == w.shape, (k, got[k].shape, w.shape)
            assert float((got[k] - w).abs().max()) <= 1e-12, (k, d, m)


def test_a_rank_without_rows_enters_every_exchange(results):
    """3 rows over 4 ranks (1, 1, 1, 0), a conv, the transposed conv (2, 2,
    1, 1) and a resize to 7 rows on rows, forward and backward: the whole
    map's, on every rank; the weights' shares add up to their gradients."""
    case = _cases()["empty_rank"]
    x, w, wt = (case[k].clone().requires_grad_() for k in ("x", "w", "wt"))
    y = F.interpolate(F.conv_transpose2d(F.conv2d(x, w, None, 1, 1), wt,
                                         None, 2),
                      size=case["size"], mode="bilinear", align_corners=False)
    (y * y).sum().backward()
    got = [r["empty_rank"] for r in results]
    assert [g["rows"].stop - g["rows"].start for g in got] == [1, 1, 1, 0]
    for k, want in (("out", y.detach()), ("x", x.grad)):
        for g in got:
            assert float((g[k] - want).abs().max()) <= 1e-12 * float(
                want.abs().max()), k
    for k, want in (("w", w.grad), ("wt", wt.grad)):
        total = sum(g[k] for g in got)
        assert float((total - want).abs().max()) <= 1e-12 * float(
            want.abs().max()), k


def test_every_rank_of_a_grid_ends_with_the_same_bits(results):
    for name in STEPS:
        first = results[0]["steps"][name]
        for r in results[1:]:
            for key in ("losses", "moved_norm", "digest"):
                assert r["steps"][name][key] == first[key], (name, key)


def test_the_frozen_encoder_stays_and_the_decoder_moves(results):
    for r in results:
        step = r["steps"]["sam-frozen-2x2"]
        assert step["frozen_unchanged"]
        assert any(n.startswith("Unet.1.") for n in step["moved"])
        assert not any(n.startswith("Unet.0.") for n in step["moved"])


@pytest.mark.parametrize("name", SGD)
def test_sgd_steps_keep_the_jax_invariants(results, jax_want, name):
    got = results[0]["steps"][name]
    n = STEPS[name][7]
    l_port, n_port = got["losses"], got["moved_norm"] / (n * LR)
    l_jax, n_jax = jax_want["sgd"][name]
    assert len(l_port) == len(l_jax) == n
    assert abs(l_port[0] - l_jax[0]) < 1e-5, (l_port, l_jax)
    assert abs(n_port - n_jax) / n_jax < 0.1, (n_port, n_jax)
    assert l_port[-1] < l_port[0] and l_jax[-1] < l_jax[0], (l_port, l_jax)


def test_a_grid_of_one_model_rank_is_the_data_axis_bit_for_bit(results):
    assert all(r["data_only_equal"] for r in results)
    assert [r["coords"]["4x1"] for r in results] == [(r, 0) for r in
                                                     range(WORLD)]
    assert [r["coords"]["2x2"] for r in results] == [(0, 0), (0, 1), (1, 0),
                                                     (1, 1)]


def test_min_spatial_height_and_the_guard_match_jax():
    assert mesh_lib.min_spatial_height(2) == 128
    assert mesh_lib.min_spatial_height(4) == 256
    grid = mesh_lib.Mesh(num_model=4)
    with pytest.raises(ValueError, match="unsafe for spatial sharding"):
        mesh_lib.validate_spatial_input(64, grid)
    mesh_lib.validate_spatial_input(256, grid)
    mesh_lib.validate_spatial_input(64, mesh_lib.Mesh(world=8))


def test_an_input_height_that_does_not_split_raises_naming_both():
    grid = mesh_lib.Mesh(model_rank=1, num_model=4)
    with pytest.raises(ValueError, match=r"66 rows .* 4 equal shards"):
        mesh_lib.image_rows(grid, 66)
    with pytest.raises(ValueError, match=r"66 rows .* 4 equal shards"):
        mesh_lib.shard_spatial(grid, torch.zeros(1, 66, 8, 3))
    assert mesh_lib.image_rows(grid, 64) == slice(16, 32)
    # 72 rows over 4 ranks plan down to 1/16 (5 rows: 2, 1, 1, 1)
    assert mesh_lib.image_rows(grid, 72) == slice(18, 36)
    h = 72
    for _ in range(4):
        plan = conv_plan(h, 3, 2, 1, 1, 4)
        h = plan[-1][1]
        assert [o1 - o0 for o0, o1, *_ in plan] == np.diff(
            mesh_lib.row_bounds(h, 4)).tolist()
    assert h == 5 and mesh_lib.rows_of(grid, h) == slice(2, 3)


@pytest.mark.parametrize("k,s,p", [(3, 1, 1), (3, 2, 1), (1, 1, 0), (1, 2, 0),
                                   (5, 2, 2), (5, 1, 2)])
def test_conv_row_plan_joins_to_the_whole_conv(k, s, p):
    x = torch.randn(2, 3, 24, 10, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(k * 10 + s))
    w = torch.randn(4, 3, k, k, dtype=torch.float64)
    want = F.conv2d(x, w, None, s, p)
    for m in (2, 4):
        plan = conv_plan(24, k, s, p, 1, m)
        got = torch.cat([conv_strip(x[:, :, r[2]:r[3]], w, None, r, (s, s),
                                    (p, p), (1, 1), 1) for r in plan], dim=2)
        assert torch.equal(got, want), (m, float((got - want).abs().max()))


@pytest.mark.parametrize("mode,align,size", [
    ("bilinear", False, (48, 20)), ("bilinear", True, (48, 20)),
    ("bilinear", False, (12, 5)), ("bilinear", True, (96, 7)),
    ("nearest", False, (12, 5)), ("nearest", False, (48, 20))])
def test_resize_row_plan_joins_to_the_whole_resize(mode, align, size):
    x = torch.randn(2, 3, 24, 10, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(size[0]))
    kw = {} if mode == "nearest" else {"align_corners": align}
    want = F.interpolate(x, size=size, mode=mode, **kw)
    for m in (2, 4):
        plan = resize_plan(24, size[0], m, mode, align)
        got = torch.cat([resize_strip(x[:, :, r[2]:r[3]], 24, size, r, mode,
                                      align) for r in plan], dim=2)
        # torch's own lerp order; float64 rounding of the weights only
        assert float((got - want).abs().max()) <= 1e-15 * float(
            want.abs().max()) * 10


@pytest.mark.parametrize("m", [2, 3, 4])
def test_the_row_rule_gives_every_row_to_one_rank(m):
    for h in range(1, 41):
        bounds = mesh_lib.row_bounds(h, m)
        rows = [list(range(h))[mesh_lib.rows_of(
            mesh_lib.Mesh(model_rank=q, num_model=m), h)] for q in range(m)]
        assert sum(rows, []) == list(range(h)), (h, m)
        sizes = np.diff(bounds)
        # balanced: no rank holds two rows more than another, and none is
        # empty while the map has a row for each
        assert sizes.max() - sizes.min() <= 1 and (h < m or sizes.min() > 0)


# heights that split unequally over 2, 3 and 4 ranks, and maps of fewer
# rows than ranks (empty ranks)
UNEQUAL = (15, 30, 7, 5, 3, 2)


@pytest.mark.parametrize("k,s,p", [(3, 1, 1), (3, 2, 1), (1, 1, 0), (1, 2, 0),
                                   (5, 2, 2), (5, 1, 2)])
def test_conv_row_plan_at_unequal_heights_joins_bit_for_bit(k, s, p):
    for h in UNEQUAL:
        x = torch.randn(2, 3, h, 10, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(h))
        w = torch.randn(4, 3, k, k, dtype=torch.float64)
        want = F.conv2d(x, w, None, s, p)
        for m in (2, 3, 4):
            plan = conv_plan(h, k, s, p, 1, m)
            got = torch.cat([conv_strip(x[:, :, r[2]:r[3]], w, None, r,
                                        (s, s), (p, p), (1, 1), 1)
                             for r in plan], dim=2)
            assert torch.equal(got, want), (h, m)


@pytest.mark.parametrize("h", UNEQUAL)
def test_transposed_conv_row_plan_joins_bit_for_bit(h):
    x = torch.randn(2, 3, h, 10, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(h))
    w = torch.randn(3, 4, 2, 2, dtype=torch.float64)
    b = torch.randn(4, dtype=torch.float64)
    want = F.conv_transpose2d(x, w, b, 2)
    for m in (2, 3, 4):
        plan = transpose_plan(h, 2, 2, m)
        # output rows 2i and 2i + 1 read input row i alone
        for o0, o1, lo, hi in plan:
            assert (lo, hi) == ((o0 // 2, (o1 + 1) // 2) if o1 > o0
                                else (lo, lo))
        got = torch.cat([transpose_strip(x[:, :, r[2]:r[3]], w, b, r, (2, 2))
                         for r in plan], dim=2)
        assert torch.equal(got, want), (h, m)


@pytest.mark.parametrize("mode,align,scale", [
    ("bilinear", False, 2), ("bilinear", True, 2), ("bilinear", False, 0.5),
    ("bilinear", True, 3.1), ("nearest", False, 0.5),
    ("nearest", False, 2)])
def test_resize_row_plan_at_unequal_heights_joins_to_the_whole_resize(
        mode, align, scale):
    """Split over 2-4 ranks, the strips join bit for bit to the same
    strip computation over one rank, and match ``F.interpolate`` within
    the float64 rounding of its other sum order."""
    for h in UNEQUAL:
        x = torch.randn(2, 3, h, 10, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(h))
        size = (max(int(h * scale), 1), 20)
        kw = {} if mode == "nearest" else {"align_corners": align}
        want = F.interpolate(x, size=size, mode=mode, **kw)
        one = resize_plan(h, size[0], 1, mode, align)[0]
        whole = resize_strip(x[:, :, one[2]:one[3]], h, size, one, mode,
                             align)
        assert float((whole - want).abs().max()) <= 1e-15 * float(
            want.abs().max()) * 10
        for m in (2, 3, 4):
            plan = resize_plan(h, size[0], m, mode, align)
            got = torch.cat([resize_strip(x[:, :, r[2]:r[3]], h, size, r,
                                          mode, align) for r in plan], dim=2)
            assert torch.equal(got, whole), (h, m)
