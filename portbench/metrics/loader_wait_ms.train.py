"""Mean wait in the loader's next() over the window's steps, ms (host clock)."""

from portbench import readers


def read(r: readers.Readings):
    return 1e3 * sum(r.loader_waits_s) / len(r.loader_waits_s) if r.loader_waits_s else None
