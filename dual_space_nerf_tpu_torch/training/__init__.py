from .checkpoint import Checkpointer, PeriodicCheckpointer
from .loss import make_loss, smooth_l1
from .optim import make_optimizer, reference_schedule
from .state import TrainBatch, TrainState, create_train_state, draw_randoms, make_train_step

__all__ = [
    "Checkpointer",
    "PeriodicCheckpointer",
    "TrainBatch",
    "TrainState",
    "create_train_state",
    "do_train",
    "draw_randoms",
    "make_loss",
    "make_optimizer",
    "make_train_step",
    "reference_schedule",
    "smooth_l1",
]


def __getattr__(name):
    # the loop imports `data`, whose batching imports TrainBatch from this
    # package: it is loaded on first use, not with the package
    if name == "do_train":
        from .loop import do_train

        return do_train
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
