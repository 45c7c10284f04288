"""Training of the port (`repro/train`): the train step and the resilient loop."""

from repro_torch.train.resilient import ResilienceConfig, train_resilient
from repro_torch.train.train_step import TrainConfig, TrainState, init_train_state, make_train_step

__all__ = [
    "TrainConfig",
    "TrainState",
    "init_train_state",
    "make_train_step",
    "ResilienceConfig",
    "train_resilient",
]
