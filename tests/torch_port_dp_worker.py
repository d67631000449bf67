"""One rank of the data-parallel CPU tests
(``tests/test_torch_port_data_parallel.py``); imports no JAX.

    python tests/torch_port_dp_worker.py INIT_URL WORLD RANK WORKDIR

joins a gloo group (``tpudepth_torch.parallel.initialize``) and reads
``WORKDIR/cases.pt``, which the test wrote:

- ``steps``: per case a model name, its ``build_model`` options, a
  ``state_dict``, the loss recipe, whether to augment, and the global
  batches (NHWC float32, one per step). The rank runs the float64 step
  (``make_train_step(mesh=...)``, its losses in float64 too:
  ``losses.widen`` swapped for the identity) on its rows of each batch;
  then, outside the group's data axis, for the cases
  ``names[rank::world]`` the single-process step on the whole batch from
  the state the ranks' previous step left, and writes the largest
  difference of each kind of tensor after each step (loss, gradients,
  parameters, running statistics, Adam moments) beside the reference's
  largest value. For the cases named in ``record`` each rank also writes
  the first step's prediction of its rows, and rank 0 its statistics,
  loss and gradients, which the test holds against the JAX package.
- ``fit``: a ``Trainer`` configuration, its model's ``state_dict`` and the
  global train and validation batches; the rank fits its shard for one
  epoch with per-epoch checkpoints, takes one more step, and a fresh
  trainer restored from the checkpoint takes the same step.

Every rank writes ``WORKDIR/rank{RANK}.pt``: the sha256 of every tensor of
every final state (both ranks must agree bit for bit), the losses, the
comparisons and what it saved through ``save_checkpoint``.
"""

import copy
import hashlib
import os
import sys

import torch

from tpudepth_torch.core.config import TrainConfig
from tpudepth_torch.losses import losses
from tpudepth_torch.models.registry import build_model
from tpudepth_torch.parallel import create_mesh, initialize
from tpudepth_torch.parallel.launch import shutdown
from tpudepth_torch.train import trainer as ttr

LR = 1e-3
MAX_DEPTH = 10.0


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().cpu().numpy()
                          .tobytes()).hexdigest()


def run_steps(case, mesh, starts=None):
    """The case's steps in float64 on this rank's rows (``mesh``) or on
    the whole batches (``mesh`` None): losses, the first step's
    prediction, statistics and gradients, the parameters, statistics,
    gradients and Adam moments by name after each step, and the model's
    and optimizer's state after each step. ``starts``: the state each step
    starts from (None: where the previous step left it)."""
    model = build_model(case["model"], **case["options"])
    model.load_state_dict(case["weights"])
    model.double()
    recipe = ttr.LossRecipe(kind=case["kind"], max_depth=MAX_DEPTH,
                            depth_scale=MAX_DEPTH)
    cfg = TrainConfig(learning_rate=LR)
    state = ttr.TrainState(model, ttr.make_optimizer(cfg, model.parameters()))
    step = ttr.make_train_step(model, recipe, ttr.step_lr(LR, 15, 0.1, 10),
                               compute_dtype=torch.float64,
                               augment=case["augment"], mesh=mesh)
    preds = []
    hook = model.register_forward_hook(
        lambda m, i, o: preds.append(o.detach().clone()))
    out = {"loss": [], "after": [], "states": []}
    for s, (image, depth) in enumerate(case["batches"]):
        if starts is not None and starts[s] is not None:
            model.load_state_dict(starts[s][0])
            state.optimizer.load_state_dict(starts[s][1])
            state.step = s
        if mesh is not None:
            rows = ttr.mesh_lib.batch_rows(mesh, len(image))
            image, depth = image[rows], depth[rows]
        generator = torch.Generator().manual_seed(100 + s)
        loss = step(state, torch.from_numpy(image), torch.from_numpy(depth),
                    generator)
        out["loss"].append(float(loss))
        if s == 0:
            sd = model.state_dict()
            out["pred0"] = preds[0]
            out["stats0"] = {k: v.clone() for k, v in sd.items()
                             if k.endswith(("running_mean", "running_var"))}
            out["grads0"] = {n: p.grad.clone()
                             for n, p in model.named_parameters()}
        after = {k: v.clone() for k, v in model.state_dict().items()
                 if v.is_floating_point()}
        opt = state.optimizer.state
        for n, p in model.named_parameters():
            after[f"{n}:grad"] = p.grad.clone()
            after[f"{n}:exp_avg"] = opt[p]["exp_avg"].clone()
            after[f"{n}:exp_avg_sq"] = opt[p]["exp_avg_sq"].clone()
        out["after"].append(after)
        out["states"].append((copy.deepcopy(model.state_dict()),
                              copy.deepcopy(state.optimizer.state_dict())))
    hook.remove()
    return out


def kind_of(key: str) -> str:
    for kind in ("grad", "exp_avg", "exp_avg_sq"):
        if key.endswith(f":{kind}"):
            return kind
    if key.endswith(("running_mean", "running_var")):
        return "stats"
    return "params"


def compare_state(got, want):
    """Per kind of tensor: the largest ``max|got - want|`` over the tensor's
    ``max|want|`` and the worst tensor, over the tensors above the kind's
    floor (1e-6 of the kind's largest value); the largest difference of
    the tensors under it over the kind's largest value (``floor_rel``).
    Parameters fall under the floor when their Adam first moment does
    (their gradient is rounding noise); for them ``noise_abs`` is the
    largest absolute difference."""
    scale = {}
    for k, w in want.items():
        scale[kind_of(k)] = max(scale.get(kind_of(k), 0.0),
                                float(w.abs().max()))
    res = {kind: {"rel": 0.0, "worst": "", "floor_rel": 0.0, "n": 0,
                  "noise_abs": 0.0} for kind in scale}
    for k, w in want.items():
        kind = kind_of(k)
        r = res[kind]
        diff = float((got[k] - w).abs().max())
        top = float(w.abs().max())
        if kind == "params" and f"{k}:exp_avg" in want:
            noise = (float(want[f"{k}:exp_avg"].abs().max())
                     <= 1e-6 * scale["exp_avg"])
        else:
            noise = top <= 1e-6 * scale[kind]
        if not noise:
            r["n"] += 1
            if diff / top > r["rel"]:
                r["rel"], r["worst"] = diff / top, k
        elif kind == "params":
            r["noise_abs"] = max(r["noise_abs"], diff)
        else:
            r["floor_rel"] = max(r["floor_rel"], diff / scale[kind])
    return res


def compare(got, want):
    """``compare_state`` after each step, and the losses."""
    return {"after": [compare_state(g, w) for g, w in
                      zip(got["after"], want["after"])],
            "loss": {"got": got["loss"], "want": want["loss"]}}


def fit_case(spec, mesh, saved):
    """One epoch of ``Trainer.fit`` on this rank's shard, then one more
    step by the trainer and by a fresh one restored from the checkpoint."""
    cfg = TrainConfig(**spec["config"])

    class Loader:
        def __init__(self, batches, shard):
            self.batches = [{k: (v[ttr.mesh_lib.batch_rows(mesh, len(v))]
                                 if shard else v) for k, v in b.items()}
                            for b in batches]

        def __len__(self):
            return len(self.batches)

        def set_epoch(self, epoch):
            pass

        def __iter__(self):
            return iter(self.batches)

    def trainer():
        model = build_model(cfg.model)
        model.load_state_dict(spec["weights"])
        return ttr.Trainer(cfg, model=model, device="cpu",
                           train_loader=Loader(spec["train"], True),
                           val_loader=Loader(spec["val"], False))

    tr = trainer()
    epoch_loss = []
    tr.fit(epochs=1, checkpoint_style="per_epoch",
           on_epoch_end=lambda e, avg, val, t: epoch_loss.append(avg))
    nxt = spec["next"]
    rows = ttr.mesh_lib.batch_rows(mesh, len(nxt["image"]))
    batch = {k: v[rows] for k, v in nxt.items()}
    cont = float(tr.train_step(batch))
    resumed = trainer()
    resumed.init_state()
    resumed.restore(os.path.join(cfg.checkpoint_dir, "checkpoint_0"))
    res_step = resumed.state.step
    again = float(resumed.train_step(batch))
    same = all(torch.equal(a, b) for a, b in zip(
        tr.model.state_dict().values(), resumed.model.state_dict().values()))
    return {"epoch_loss": epoch_loss[0], "val_losses": list(tr.val_losses),
            "next_loss": cont, "resumed_loss": again,
            "resumed_step": res_step, "resumed_same_state": same,
            "saved": saved,
            "digest": {k: digest(v) for k, v in tr.model.state_dict().items()}}


def main(init_url, world, rank, workdir):
    torch.set_num_threads(1)
    # float64 losses: the port's losses compute in float32, as the JAX
    # package's, and float32 sums in another order would not hold 1e-9
    losses.widen = lambda x: x
    initialize(init_url, num_processes=world, process_id=rank, device="cpu")
    mesh = create_mesh(device="cpu")
    spec = torch.load(os.path.join(workdir, "cases.pt"), weights_only=False)
    saved = []
    real_save = ttr.save_checkpoint
    ttr.save_checkpoint = lambda path, payload: (
        saved.append(os.path.basename(path)), real_save(path, payload))[1]
    out = {"rank": rank, "world": mesh.world, "steps": {}, "compared": {},
           "record": {}}
    names = list(spec["steps"])
    mine = names[rank::world]
    runs = {}
    for name in names:
        run = run_steps(spec["steps"][name], mesh)
        out["steps"][name] = {
            "loss": run["loss"],
            "digest": {k: digest(v) for k, v in run["after"][-1].items()}}
        if name in spec["record"]:
            keep = ("pred0",) + (("loss", "stats0", "grads0") if rank == 0
                                 else ())
            out["record"][name] = {k: run[k] for k in keep}
        if name in mine:
            runs[name] = run
        del run
    out["fit"] = fit_case(spec["fit"], mesh, saved)
    for name in mine:
        # each single-process step starts from the state the two ranks'
        # previous step left (bit-equal on both)
        got = runs.pop(name)
        want = run_steps(spec["steps"][name], None,
                         [None] + got["states"][:-1])
        out["compared"][name] = compare(got, want)
        del got, want
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    shutdown()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
