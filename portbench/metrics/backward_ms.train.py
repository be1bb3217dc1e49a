"""Wall ms a traced step in the program's backward (``total.backward()``
and the zero gradients: ``dsnerf.step.backward``), on the main thread."""

from portbench import readers


def read(r: readers.Readings):
    return readers.stage_host_ms(r, "step.backward")
