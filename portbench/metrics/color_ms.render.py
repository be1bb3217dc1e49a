"""Wall ms a traced image in the program's colour passes
(``dsnerf.render.color``: the triangles' gather, the networks, the normal,
the lighting), on the main thread."""

from portbench import readers


def read(r: readers.Readings):
    return readers.stage_host_ms(r, "render.color")
