"""Model FLOPs of the window's images at the card's peak, %."""

from portbench import readers


def read(r: readers.Readings):
    return readers.mfu(r)
