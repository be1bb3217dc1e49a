"""Wall ms a traced step in the program's forward (the render and the
loss: ``dsnerf.step.forward``), on the main thread."""

from portbench import readers


def read(r: readers.Readings):
    return readers.stage_host_ms(r, "step.forward")
