"""Device kernels per training step in the traced stretch."""

from portbench import readers


def read(r: readers.Readings):
    return readers.launches_per_unit(r)
