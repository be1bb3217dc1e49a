"""Stage spans for the profiler, off by default.

A span marks one stage of the program (the train step's forward, backward
and optimizer, `render_rays`' stages, `render_item`'s mesh and copy, the
loader's wait, fetch and transform) as a `torch.profiler.record_function`
named ``dsnerf.<stage>``. A profiler session then records it on the same
timeline as the host's ops and the card's kernels, so that the card's
work and its idle gaps can be charged to a stage. The profiler is the only
exporter: nothing is kept here.

Off (the default), `span` returns one shared no-op context after a single
flag test: no profiler call, no allocation. An operator turns the spans on
around a profiled stretch::

    with tracing.enabled(), torch.profiler.profile(...) as prof:
        ...

`training/loop.py::do_train(profile_dir=...)` does so for its traced epoch.
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "dsnerf."

_on = False
_OFF = contextlib.nullcontext()


def span(name: str):
    """The context of stage ``name``: a ``dsnerf.<name>`` record_function
    while tracing is on, else a shared no-op."""
    if not _on:
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


def is_on() -> bool:
    return _on


@contextlib.contextmanager
def enabled(on: bool = True):
    """Spans on (or off, with ``on=False``) inside the block, in every
    thread; the previous state is restored on exit."""
    global _on
    prev, _on = _on, bool(on)
    try:
        yield
    finally:
        _on = prev
