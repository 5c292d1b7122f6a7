"""Training: the blood-pressure regression head over the engine's vitals
(the counterpart of ``bp_from_video_tpu/train``)."""

from bp_from_video_tpu_torch.train.bp_regressor import (
    MLPParams, TrainState, features_from_outputs, init_mlp, init_train_state,
    loss_fn, make_e2e_train_step, make_optimizer, mlp_apply, train_step)

__all__ = [
    "MLPParams", "TrainState", "features_from_outputs", "init_mlp",
    "init_train_state", "loss_fn", "make_e2e_train_step", "make_optimizer",
    "mlp_apply", "train_step",
]
