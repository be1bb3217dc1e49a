"""Wall ms a traced step in the program's optimizer part (the metrics,
Adam, the schedule: ``dsnerf.step.optimizer``), on the main thread."""

from portbench import readers


def read(r: readers.Readings):
    return readers.stage_host_ms(r, "step.optimizer")
