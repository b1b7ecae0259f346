"""Device milliseconds a step call in the step's `input` phase: the device
events between the program's `ofb_mark_input_begin` and
`ofb_mark_input_end` marks (`marks.py`). Nothing without marks."""

from benchmark.marks import read_phase


def read(t):
    return read_phase(t, "input")
