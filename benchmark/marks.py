"""A step call's device time by phase, read from the program's step marks.

The program names the phases of its training step (input, forward, loss,
backward, update). While the step is captured as a CUDA graph it launches
an empty kernel at each edge of a phase, named `ofb_mark_<phase>_begin`
and `ofb_mark_<phase>_end`, so every replay runs the marks in stream order
around the phase's own kernels. Here each begin mark in the traced window
is paired with the next end mark of its phase, in time order, and every
other device event of the window (kernels, memcpys, memsets; an NCCL
kernel on NCCL's own stream too, which the graph joins to the step's
stream by events) goes to the phase whose interval, from the begin mark's
start to the end mark's end, holds the event's start; an event no interval
holds is unmarked. A mark's own time counts in no phase and is not
unmarked. Times are device ms a step call, summed (two events at once both
count), clipped to the window as the other readers clip them.
"""

from __future__ import annotations

import bisect
import re
from typing import Dict, List, Optional, Tuple

MARK = re.compile(r"ofb_mark_([a-z]+)_(begin|end)\b")


def mark_of(name: str) -> Optional[Tuple[str, str]]:
    """(phase, 'begin' | 'end') of a mark kernel's name, else None."""
    m = MARK.search(name)
    return (m.group(1), m.group(2)) if m else None


def intervals(t) -> List[Tuple[float, float, str]]:
    """(start, end, phase) of every phase whose begin mark starts in the
    window, paired with the next end mark of its phase, in time order."""
    lo, hi = t.window
    marks = sorted((s, e, *mk) for n, s, e in t.events
                   if (mk := mark_of(n)) is not None and lo <= s < hi)
    out, begun = [], {}
    for s, e, phase, edge in marks:
        if edge == "begin":
            begun[phase] = s
        elif phase in begun:
            out.append((begun.pop(phase), e, phase))
    return sorted(out)


def phase_ms(t) -> Optional[Dict[Optional[str], float]]:
    """{phase: device ms a call} for every phase that has an interval in
    the window, and None: the device ms a call that no phase holds.
    None when the window holds no paired marks or no call."""
    ivs = intervals(t)
    if not ivs or not t.calls:
        return None
    lo, hi = t.window
    starts = [s for s, _, _ in ivs]
    out: Dict[Optional[str], float] = {p: 0.0 for _, _, p in ivs}
    out[None] = 0.0
    for n, s, e in t.events:
        if mark_of(n) is not None:
            continue
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        i = bisect.bisect_right(starts, s) - 1
        phase = ivs[i][2] if i >= 0 and s <= ivs[i][1] else None
        out[phase] += e - s
    return {p: us * 1e-3 / t.calls for p, us in out.items()}


def read_phase(t, phase: Optional[str]) -> Optional[float]:
    """Device ms a call of one phase (None: the unmarked time); None when
    the window holds no marks of it."""
    got = phase_ms(t)
    if got is None or phase not in got:
        return None
    return got[phase]
