"""The networks' share of their roofline in an image, %."""

from portbench import readers


def read(r: readers.Readings):
    return readers.networks_roofline(r)
