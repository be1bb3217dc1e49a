"""Device kernels per image in the traced stretch (the cell whose
end-to-end time is the device's)."""

from portbench import readers


def read(r: readers.Readings):
    return readers.launches_per_unit(r)
