"""The network passes of the traced stretch that took the fused pair, over
all its passes (fused, fast, plain), %, from the program's pass counter
(`utils/tracing.py::passes`)."""

from portbench import readers


def read(r: readers.Readings):
    return readers.fused_pass_share(r)
