"""The device time of the ops launched while a stage span was open on the
launching thread at any depth: the charge of `Trace.stage_device_ns`,
which goes to the innermost span alone, widened to every span around it.
A span that wraps whole stages, as ``dsnerf.render.fine`` wraps the fine
pass's, reads nothing through the innermost charge.

The reduced trace keeps, of each device op, the name of the innermost stage
span open at its launch (`Trace.launched_in`), and the main thread's stage
spans with their times (`Trace.stages`), but not which of a name's spans
launched the op: the coarse and the fine pass open the same stage names.
This reading recovers it from the order of launches. The port launches on
one stream, so the card starts its ops in the order they were launched,
and the main thread passes through its innermost spans in the order of its
timeline. Walking the ops by their start on the card, each op whose stage
name the main thread opens is given the first piece of the main thread's
timeline, from the previous op's piece on, in which that name is the
innermost span and which began before the op ended. The op is inside the
outer span where that piece is. Ops of names the main thread never opens
(the loader threads' own spans) and ops launched in no span are passed
over. An op launched on a thread with no span open (autograd's) carries
the main thread's innermost name at its launch, as in `trace.py`, so the
backward of a pass is charged to ``step.backward`` and not to the pass.
"""

from __future__ import annotations

import bisect

from .readers import Readings
from .trace import STAGE_PREFIX, Trace


def timeline(stages: list) -> list[tuple[int, str, frozenset]]:
    """The main thread's time cut where a stage span opens or closes:
    [(start, innermost span's name, the names of every span open)] by
    start, over the pieces in which some span is open. ``stages``:
    [(name, start, end)], spans that nest."""
    spans = sorted(stages, key=lambda x: (x[1], -x[2]))
    points = sorted({t for _, s, e in spans for t in (s, e)})
    pieces = []
    for a in points:
        open_ = [name for name, s, e in spans if s <= a < e]  # outermost first
        if open_:
            pieces.append((a, open_[-1], frozenset(open_)))
    return pieces


def enclosing_device_ns(tr: Trace, stage: str, t0: int, t1: int) -> int | None:
    """Device ns of the ops that start in [t0, t1) and were launched while
    ``dsnerf.<stage>`` was open, at any depth; None where there is none."""
    outer = STAGE_PREFIX + stage
    pieces = timeline(tr.stages)
    by_name: dict[str, list[int]] = {}
    for i, (_, name, _) in enumerate(pieces):
        by_name.setdefault(name, []).append(i)
    at, total, found = 0, 0, False
    for (_, s, e, _), name in zip(tr.device, tr.launched_in):
        idx = by_name.get(name)
        if idx is None:
            continue
        j = bisect.bisect_left(idx, at)
        if j == len(idx) or pieces[idx[j]][0] > e:
            continue
        at = idx[j]
        if outer in pieces[at][2] and t0 <= s < t1:
            total += e - s
            found = True
    return total if found else None


def enclosing_device_ms(r: Readings, stage: str) -> float | None:
    """Device ms a unit of the stretch of the ops launched while the
    program's ``dsnerf.<stage>`` span was open, at any depth."""
    if r.trace is None:
        return None
    t0, t1, n = r.trace.stretch(r.unit)
    ns = enclosing_device_ns(r.trace, stage, t0, t1)
    return None if ns is None else ns / 1e6 / n
