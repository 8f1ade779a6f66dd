"""Training: the train step, the trainer loop and its fault tolerance
(port of ``repro/train``)."""
from repro_torch.train.train_step import (  # noqa: F401
    StepConfig, TrainState, init_train_state, make_train_step,
)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: F401
