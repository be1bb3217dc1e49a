"""Device ms of GG and the nearest-face searches per training step."""

from portbench import readers


def read(r: readers.Readings):
    return readers.search_ms_per_unit(r)
