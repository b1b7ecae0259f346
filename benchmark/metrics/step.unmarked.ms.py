"""Device milliseconds a step call that lie in no phase of the step: the
device events outside every interval of the program's marks (`marks.py`),
the marks' own time apart. What the marks leave out; nothing without
marks."""

from benchmark.marks import read_phase


def read(t):
    return read_phase(t, None)
