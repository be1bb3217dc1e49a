"""Share of the traced training steps in which the card runs nothing, %."""

from portbench import readers


def read(r: readers.Readings):
    return readers.device_idle(r)
