from .train_step import (TrainState, cross_entropy, init_train_state,
                         loss_and_grads, make_train_step, state_from_numpy,
                         state_template, state_template_on_device)
from .trainer import RunReport, SpotTrainer, TrainJob

__all__ = ["RunReport", "SpotTrainer", "TrainJob", "TrainState",
           "cross_entropy", "init_train_state", "loss_and_grads",
           "make_train_step", "state_from_numpy", "state_template",
           "state_template_on_device"]
