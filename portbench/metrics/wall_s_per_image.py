"""The measured window's wall seconds per image, in the cell whose
end-to-end time is the device's: there the shared host swings this by
more than any bound allows."""

from portbench import readers


def read(r: readers.Readings):
    return readers.wall_s_per_unit(r)
