"""Training of the port: parameter groups and schedules, the train and eval
steps, evaluation, and the two-phase trainer behind ``run_pipnet``."""

from .eval import class_prototype_weights, evaluate
from .optim import label_params, make_optimizer, set_trainable
from .steps import project_classifier, train_step
from .trainer import Trainer, check_ported, run_pipnet

__all__ = ["run_pipnet", "Trainer", "check_ported", "train_step",
           "project_classifier", "evaluate", "class_prototype_weights",
           "label_params", "make_optimizer", "set_trainable"]
