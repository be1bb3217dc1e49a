"""Device ms of GG and the nearest-face searches per image (the cell whose
end-to-end time is the device's)."""

from portbench import readers


def read(r: readers.Readings):
    return readers.search_ms_per_unit(r)
