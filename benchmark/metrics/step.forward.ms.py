"""Device milliseconds a step call in the step's `forward` phase: the device
events between the program's `ofb_mark_forward_begin` and
`ofb_mark_forward_end` marks (`marks.py`). Nothing without marks."""

from benchmark.marks import read_phase


def read(t):
    return read_phase(t, "forward")
