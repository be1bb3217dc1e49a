"""Wall ms a traced image in the program's pack (``dsnerf.image.pack``:
the canvas, the float16 cast and the copy to the host, where the host
waits for the card), on the main thread."""

from portbench import readers


def read(r: readers.Readings):
    return readers.stage_host_ms(r, "image.pack")
