"""Model FLOPs of the traced image over the card's busy time in it at the
peak, %."""

from portbench import readers


def read(r: readers.Readings):
    return readers.device_mfu(r)
