"""Stage spans for the profiler, off by default.

A span marks one stage of the program (the train step's forward, backward
and optimizer, `render_rays`' stages, `render_item`'s mesh and copy, the
loader's wait, fetch and transform) as a `torch.profiler.record_function`
named ``dsnerf.<stage>``. A profiler session then records it on the same
timeline as the host's ops and the card's kernels, so that the card's
work and its idle gaps can be charged to a stage. The profiler is the only
exporter of the spans: nothing of them is kept here.

Off (the default), `span` returns one shared no-op context after a single
flag test: no profiler call, no allocation. An operator turns the spans on
around a profiled stretch::

    with tracing.enabled(), torch.profiler.profile(...) as prof:
        ...

`training/loop.py::do_train(profile_dir=...)` does so for its traced epoch.

Two counters are always on, one add under a lock each, as
`PrefetchLoader.stats` counts its items: the network passes of
`render_rays` (a density or a colour pass, however many mlp_chunk slices
it takes) by the path they took (`renderer/pipeline.py::network_path`:
"plain", "fused" or "fast"), and the samples it renders by the pass's role
(`ROLES`: the coarse pass's R x S, the fine pass's R x (S + n_fine)).
`passes()` and `samples()` read them over the process's life; a reader
takes the difference of two readings.
"""

from __future__ import annotations

import contextlib
import threading

import torch

PREFIX = "dsnerf."

_on = False
_OFF = contextlib.nullcontext()

PATHS = ("fused", "fast", "plain")
_passes_lock = threading.Lock()
_passes = dict.fromkeys(PATHS, 0)

ROLES = ("coarse", "fine")
_samples_lock = threading.Lock()
_samples = dict.fromkeys(ROLES, 0)


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


def count_pass(path: str) -> None:
    """One network pass took ``path`` (one of `PATHS`)."""
    with _passes_lock:
        _passes[path] += 1


def passes() -> dict:
    """The network passes so far, {path: count} over `PATHS`."""
    with _passes_lock:
        return dict(_passes)


def count_samples(role: str, n: int) -> None:
    """A pass of role ``role`` (one of `ROLES`) rendered ``n`` samples."""
    with _samples_lock:
        _samples[role] += n


def samples() -> dict:
    """The samples rendered so far, {role: count} over `ROLES`."""
    with _samples_lock:
        return dict(_samples)
