from .loss import make_loss, smooth_l1
from .optim import make_optimizer, reference_schedule
from .state import TrainBatch, TrainState, create_train_state, draw_randoms, make_train_step

__all__ = [
    "TrainBatch",
    "TrainState",
    "create_train_state",
    "draw_randoms",
    "make_loss",
    "make_optimizer",
    "make_train_step",
    "reference_schedule",
    "smooth_l1",
]
