"""Device ms a traced step of the ops launched while the program's fine
pass was open (``dsnerf.render.fine``, at any depth: the resample, and the
second pass's sample, search, density, select, colour and composite),
`enclosing.enclosing_device_ms`: the fine pass's forward on the card. Its
backward runs on autograd's thread while the main thread waits in
``dsnerf.step.backward``, and stays charged there. None where the program
opens no such span."""

from portbench import enclosing, readers


def read(r: readers.Readings):
    return enclosing.enclosing_device_ms(r, "render.fine")
