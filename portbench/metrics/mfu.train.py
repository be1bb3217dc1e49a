"""Model FLOPs of the window's training steps at the card's peak, %."""

from portbench import readers


def read(r: readers.Readings):
    return readers.mfu(r)
