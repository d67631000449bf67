"""One rank of the model-axis CPU tests (``tests/test_torch_port_spatial.py``);
imports no JAX.

    python tests/torch_port_spatial_worker.py INIT_URL WORLD RANK WORKDIR

joins a gloo group of four ranks, builds the (1 x 4), (2 x 2) and (4 x 1)
grids (``tpudepth_torch.core.mesh.create_mesh``) and reads
``WORKDIR/cases.pt``, which the test wrote:

- ``forward``: per case a model (or the SAM stage), the seed of its
  weights (``build``) and an input batch. The rank runs the eval forward on its batch and image
  rows under the case's grid, in float64 and in float32, and records its
  rows; rank 0 also runs the float64 forward in one process on the whole
  batch. A forward hook records the rows of the stem conv's output.
- ``steps``: per case a model, its options and the seed of its weights,
  the recipe, a global batch (NHWC) and its steps (one Adam step, or
  ``sgd_steps`` SGD steps). The rank runs the float64 steps
  (``make_train_step(mesh=...)``) on its rows under the case's grid and
  records the first step's loss, every trainable parameter's gradient,
  every running statistic and the parameters after it, every step's loss
  and the parameters' change (which the test holds against the JAX
  package's run by JAX's own invariants,
  ``tests/test_spatial_sharding.py:60, 154``); one process's first step on
  the whole batch runs on one rank (the cases spread over the ranks) from
  the same weights. The losses compute in float64 (``losses.widen``
  swapped for the identity) and so does the attention models' sigmoid
  head (in float32 in the port, as in the JAX package).
- ``data_only``: the (4 x 1) grid's step against the step under the mesh of
  the data axis alone (``Mesh(rank, world, WORLD)``), bit for bit.
- ``empty_rank``: a 3-row map over the (1 x 4) grid's ranks (the last
  holds no rows): taken to rows (``take_rows``), a 3x3 conv, the U-Net's
  transposed conv and a bilinear resize on rows, despatialized, and the
  backward of its sum of squares; the rank records the whole output, the
  input's gradient and its shares of the two weights' gradients.
- ``moments``: per grid a map whose rows do not split equally; the rank
  runs a train-mode ``BatchNorm``, the SE squeeze and ``global_avg_pool``
  marked to run on rows on its batch rows and image rows
  (``core/mesh.py::rows_of``) and records their outputs and the running
  statistics.

Rank ``r`` writes ``WORKDIR/rank{r}.pt``.
"""

import hashlib
import os
import sys
import time

import torch
import torch.distributed as dist

from tpudepth_torch.core import mesh as mesh_lib
from tpudepth_torch.core.config import TrainConfig
from tpudepth_torch.losses import losses
from tpudepth_torch.models import decoders
from tpudepth_torch.models.guidedepth import SELayer
from tpudepth_torch.models.layers import (
    BatchNorm,
    conv_rows,
    conv_transpose_rows,
    init_random_,
)
from tpudepth_torch.models.registry import build_model
from tpudepth_torch.models.sam import SAM
from tpudepth_torch.ops.image import (
    global_avg_pool,
    pixel_shuffle,
    resize_rows,
    upsample,
)
from tpudepth_torch.train import trainer as ttr

LR = 1e-3
MAX_DEPTH = 10.0


def _head_in_input_dtype(self, feats):
    """``AttentionDecoder.forward`` with its sigmoid in the input's dtype
    (float32 in the port): a float64 step then stays float64 throughout."""
    e3 = self.crf3(feats[16], self.conv0(feats[17]))
    e2 = self.crf2(feats[13], pixel_shuffle(e3, 2))
    e1 = self.crf1(feats[7], pixel_shuffle(e2, 2))
    e0 = self.crf0(feats[4], pixel_shuffle(e1, 2))
    return upsample(torch.sigmoid(self.conv1(e0)), 4, align_corners=False)


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()
                          ).hexdigest()


def _fresh(case):
    if case["model"] == "sam_stage":
        return SAM(**case["options"])
    return build_model(case["model"], **case["options"])


def build(case):
    """The case's model and weights: ``init_random_`` from the case's
    ``seed``, or with ``seed`` None torch's own initialization under
    ``torch.manual_seed(0)``, what ``Trainer`` does. The test builds the
    same weights to carry them to flax."""
    if case["seed"] is None:
        with torch.random.fork_rng():
            torch.manual_seed(0)
            return _fresh(case)
    return init_random_(_fresh(case), case["seed"])


def forward_case(case, mesh, rank):
    """The case's eval forward on this rank's rows (float64, float32), the
    stem conv's rows, and on rank 0 the whole batch in one process."""
    out = {}
    for dtype in (torch.float64, torch.float32):
        model = build(case).to(dtype).eval()
        if case["model"] == "sam_stage":
            mesh_lib.run_whole_on_rows(model)
        inputs = [mesh_lib.shard_spatial(mesh, x.to(dtype), "NCHW")
                  for x in case["inputs"]]
        stem = []
        if case["model"].startswith("GuideDepth"):
            model.feature_extractor.conv1[0].register_forward_hook(
                lambda m, i, o: stem.append(tuple(o.shape)))
        with torch.no_grad(), mesh_lib.mesh_context(mesh):
            out[str(dtype)] = model(*inputs)
        out["stem"] = stem
        if dtype == torch.float64 and rank == 0:
            with torch.no_grad():
                out["single"] = model(*[x.to(dtype) for x in case["inputs"]])
    return out


def moments_case(x, mesh):
    """A ``BatchNorm`` (train mode), the SE squeeze and ``global_avg_pool``
    on rows of ``x`` (this rank's batch rows and image rows), marked to run
    on rows: the normalized rows, the moved running statistics and the two
    means."""
    x = x[mesh_lib.batch_rows(mesh, x.shape[0])][
        :, :, mesh_lib.rows_of(mesh, x.shape[2])]
    bn = BatchNorm(x.shape[1]).double().train()
    mesh_lib.run_on_rows(bn)
    with mesh_lib.mesh_context(mesh):
        out = {"bn": bn(x).detach(), "se": SELayer.squeeze(x, rows=mesh),
               "gap": global_avg_pool(x, keepdims=True, rows=mesh)}
    out.update(running_mean=bn.running_mean, running_var=bn.running_var)
    return out


def empty_rank_case(case, mesh):
    """``case``'s map through a conv, a transposed conv and a resize on
    rows of ``mesh``, where a rank may hold none of the map's rows: the
    whole output, the input's gradient and this rank's shares of the
    weights' gradients."""
    x = case["x"].clone().requires_grad_()
    w = case["w"].clone().requires_grad_()
    wt = case["wt"].clone().requires_grad_()
    mesh.plan.start(*x.shape[2:])
    y = conv_rows(mesh_lib.take_rows(x, mesh), w, None, (1, 1), (1, 1),
                  (1, 1), 1, mesh)
    y = conv_transpose_rows(y, wt, None, (2, 2), mesh)
    y = mesh_lib.despatialize(
        resize_rows(y, case["size"], "bilinear", False, mesh), mesh)
    (y * y).sum().backward()
    return {"out": y.detach(), "x": x.grad, "w": w.grad, "wt": wt.grad,
            "rows": mesh_lib.rows_of(mesh, x.shape[2])}


def run_steps(case, mesh, steps=None):
    """The case's float64 steps on this rank's rows (``mesh``) or on the
    whole batch (None): one Adam step, or with ``case["sgd_steps"]`` that
    many SGD steps (lr 1e-3); ``steps`` caps them; the step resizes the
    batch to ``case["train_hw"]`` where it is set. The first step's loss,
    every trainable parameter's gradient, every running statistic and the
    parameters after it; every step's loss; the parameters' change over
    all steps as one vector's norm."""
    model = build(case).double()
    before = [p.detach().clone() for p in model.parameters()]
    recipe = ttr.LossRecipe(kind=case["kind"], max_depth=MAX_DEPTH,
                            depth_scale=MAX_DEPTH)
    params = ttr.trainable_parameters(model, case["freeze"])
    n = case["sgd_steps"]
    optimizer = (torch.optim.SGD(params, lr=LR) if n
                 else ttr.make_optimizer(TrainConfig(learning_rate=LR),
                                         params))
    state = ttr.TrainState(model, optimizer)
    step = ttr.make_train_step(model, recipe, lambda s: LR,
                               compute_dtype=torch.float64, augment=False,
                               train_hw=case["train_hw"], mesh=mesh)
    image, depth = case["image"].double(), case["depth"].double()
    if mesh is not None:
        image = mesh_lib.shard_spatial(mesh, image)
        depth = mesh_lib.shard_spatial(mesh, depth)
    out = {"losses": []}
    trainable = {id(p) for p in params}
    for i in range(min(n or 1, steps or n or 1)):
        out["losses"].append(float(step(state, image, depth)))
        if i:
            continue
        first = out["first"] = {"loss": out["losses"][0]}
        for name, p in model.named_parameters():
            # a frozen encoder's gradients are never reduced nor applied
            if id(p) in trainable:
                first[f"{name}:grad"] = p.grad.clone()
            first[f"{name}:after"] = p.detach().clone()
        for k, v in model.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                first[k] = v.clone()
    out["moved_norm"] = float(torch.cat([
        (p.detach() - b).flatten()
        for p, b in zip(model.parameters(), before)]).norm())
    return out


def kind_of(key: str) -> str:
    if key.endswith((":grad", ":after")):
        return key.rsplit(":", 1)[1]
    return "stats"


def compare(got, want):
    """Per kind of tensor (``grad``, ``after``: the parameters after the
    update, ``stats``): the largest ``max|got - want| / max|want|`` and its
    tensor over the tensors above the kind's floor (1e-6 of the kind's
    largest value), and the largest difference under the floor over the
    kind's largest value (``floor_rel``: a conv bias in front of a
    BatchNorm has a zero gradient, which holds rounding noise); the
    losses."""
    scale = {}
    for k, w in want.items():
        if k != "loss":
            scale[kind_of(k)] = max(scale.get(kind_of(k), 0.0),
                                    float(w.abs().max()))
    res = {kind: {"rel": 0.0, "worst": "", "floor_rel": 0.0, "n": 0,
                  "abs": 0.0} for kind in scale}
    for k, w in want.items():
        if k == "loss":
            continue
        r, top = res[kind_of(k)], float(w.abs().max())
        diff = float((got[k] - w).abs().max())
        r["abs"] = max(r["abs"], diff)
        if top > 1e-6 * scale[kind_of(k)]:
            r["n"] += 1
            if diff / top > r["rel"]:
                r["rel"], r["worst"] = diff / top, k
        else:
            r["floor_rel"] = max(r["floor_rel"], diff / scale[kind_of(k)])
    res["loss"] = {"got": got["loss"], "want": want["loss"]}
    return res


def main(init_url, world, rank, workdir):
    torch.set_num_threads(1)
    losses.widen = lambda x: x
    decoders.AttentionDecoder.forward = _head_in_input_dtype
    dist.init_process_group("gloo", init_method=init_url, world_size=world,
                            rank=rank)
    grids = {"1x4": mesh_lib.create_mesh(1, 4),
             "2x2": mesh_lib.create_mesh(2, 2),
             "4x1": mesh_lib.create_mesh(4, 1)}
    spec = torch.load(os.path.join(workdir, "cases.pt"), weights_only=False)
    out = {"rank": rank, "coords": {k: (m.rank, m.model_rank)
                                    for k, m in grids.items()},
           "forward": {}, "steps": {}, "single": {}, "seconds": {}}
    t0 = time.perf_counter()
    for name, case in spec["forward"].items():
        out["forward"][name] = forward_case(case, grids[case["grid"]], rank)
    out["seconds"]["forward"] = time.perf_counter() - t0
    out["moments"] = {grid: moments_case(x, grids[grid])
                      for grid, x in spec["moments"].items()}
    out["empty_rank"] = empty_rank_case(spec["empty_rank"], grids["1x4"])
    names = list(spec["steps"])
    mine, kept = names[rank::world], {}
    for name in names:
        t0 = time.perf_counter()
        case = spec["steps"][name]
        run = run_steps(case, grids[case["grid"]])
        got, weights = run["first"], build(case).state_dict()
        out["steps"][name] = {
            "losses": run["losses"], "moved_norm": run["moved_norm"],
            "digest": {k: digest(v) for k, v in got.items() if k != "loss"},
            "frozen_unchanged": all(
                torch.equal(got[f"{n}:after"], weights[n].double())
                for n in weights if n.startswith(ttr.ENCODER_PREFIX)
                and f"{n}:after" in got),
            "moved": sorted(n for n in weights if f"{n}:after" in got
                            and not torch.equal(got[f"{n}:after"],
                                                weights[n].double()))}
        if name in mine:
            kept[name] = got
        out["seconds"][name] = time.perf_counter() - t0
    # the (4 x 1) grid against the data axis alone: the same step, bits
    case = spec["data_only"]
    grid = run_steps(case, grids["4x1"], steps=1)["first"]
    data_only = run_steps(case, mesh_lib.Mesh(rank, world, dist.group.WORLD),
                          steps=1)["first"]
    out["data_only_equal"] = all(torch.equal(torch.as_tensor(v),
                                             torch.as_tensor(data_only[k]))
                                 for k, v in grid.items())
    # one process's first step on the whole batch, the cases spread over
    # the ranks
    for name in mine:
        t0 = time.perf_counter()
        want = run_steps(spec["steps"][name], None, steps=1)["first"]
        out["single"][name] = compare(kept.pop(name), want)
        out["seconds"][f"single {name}"] = time.perf_counter() - t0
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
