"""Training of the port: the alhashim recipe, the train step and the fit
loop."""

from tpudepth_torch.train.trainer import (  # noqa: F401
    LossRecipe,
    Trainer,
    TrainState,
    depth_norm,
    inverse_depth_norm,
    make_eval_step,
    make_optimizer,
    make_train_step,
    step_lr,
)
