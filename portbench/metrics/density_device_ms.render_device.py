"""Device ms a traced image of the ops launched inside the program's
gated density passes (``dsnerf.render.density``: the warps, the density
network and the mask over every sample), in the cell whose end-to-end
time is the device's."""

from portbench import readers


def read(r: readers.Readings):
    return readers.stage_device_ms(r, "render.density")
