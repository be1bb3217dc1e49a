"""The networks' share of their roofline in an image, % (the cell whose
end-to-end time is the device's)."""

from portbench import readers


def read(r: readers.Readings):
    return readers.networks_roofline(r)
