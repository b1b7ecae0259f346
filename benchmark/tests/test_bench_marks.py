"""The step-phase reader (`marks.py`) and its six metrics on synthetic traced
windows: phases summed per call, an NCCL kernel goes to the phase its
start lies in, what lies outside the window is left out, no marks read
nothing, the unmarked time is what no phase holds, and a mark's own time
counts nowhere."""

import pytest

from benchmark import cells, marks
from benchmark.trace import TracedWindow

PHASES = ("input", "forward", "loss", "backward", "update")


def _window(events, window=(0.0, 100.0), calls=2):
    spans = [("bench.call", window[0], window[0] + 1),
             ("bench.sync", window[1] - 1, window[1])]
    return TracedWindow(events=events, spans=spans, window=window,
                        calls=calls, cell={})


def _phase(name, s, e, kernels):
    """A phase's marks at [s, s + 1) and [e - 1, e), its kernels between."""
    return [(f"ofb_mark_{name}_begin", s, s + 1)] + kernels \
        + [(f"ofb_mark_{name}_end", e - 1, e)]


def _read(t, metric):
    return cells.metric_reader(metric).read(t)


def test_phases_are_summed_per_call():
    ev = []
    for c in (0, 50):                      # two calls, A = 2 in each
        ev += _phase("input", c, c + 10, [("elementwise", c + 2, c + 8)])
        for a in (0, 15):
            b = c + 10 + a
            ev += _phase("forward", b, b + 5, [("nvjet_gemm", b + 1, b + 3)])
            ev += _phase("loss", b + 5, b + 8, [("reduce", b + 6, b + 7)])
            ev += _phase("backward", b + 8, b + 15,
                         [("attention_bwd", b + 9, b + 14)])
        ev += _phase("update", c + 40, c + 48, [("foreach", c + 41, c + 46),
                                                 ("Memset", c + 46, c + 47)])
    t = _window(ev)
    got = {p: _read(t, f"step.{p}.ms") for p in PHASES}
    # us a call -> ms a call
    assert got == pytest.approx({"input": 6e-3, "forward": 4e-3,
                                 "loss": 2e-3, "backward": 10e-3,
                                 "update": 6e-3})
    assert _read(t, "step.unmarked.ms") == 0.0


def test_an_nccl_kernel_goes_to_the_phase_it_starts_in():
    ev = _phase("loss", 0, 10, [("reduce", 1, 3)]) \
        + [("ncclDevKernel_AllReduce_Sum_f32", 4, 12)] \
        + _phase("update", 10, 30, [("foreach", 11, 20)]) \
        + [("ncclDevKernel_AllReduce_Sum_f32", 21, 29)]
    t = _window(ev, calls=1)
    assert _read(t, "step.loss.ms") == pytest.approx((2 + 8) * 1e-3)
    assert _read(t, "step.update.ms") == pytest.approx((9 + 8) * 1e-3)
    assert _read(t, "step.unmarked.ms") == 0.0


def test_what_lies_outside_the_window_is_left_out():
    ev = _phase("forward", 2, 10, [("gemm", 3, 5)]) \
        + _phase("forward", 90, 110, [("gemm", 95, 105)]) \
        + _phase("backward", -20, -5, [("elementwise", -15, -10)]) \
        + [("elementwise", 12, 14)]
    t = _window(ev, window=(0.0, 100.0), calls=1)
    # a phase whose end mark lies past the window is not paired: its
    # kernel's part inside the window is unmarked; the phase before the
    # window is not read at all
    assert _read(t, "step.forward.ms") == pytest.approx(2e-3)
    assert _read(t, "step.backward.ms") is None
    assert _read(t, "step.unmarked.ms") == pytest.approx((2 + 5) * 1e-3)


def test_a_window_without_marks_reads_nothing():
    t = _window([("gemm", 1, 5), ("elementwise", 6, 9)])
    for p in PHASES + ("unmarked",):
        assert _read(t, f"step.{p}.ms") is None
    assert marks.phase_ms(t) is None
    # marks but no calls: nothing either
    assert marks.phase_ms(_window(_phase("loss", 1, 5, []), calls=0)) is None


def test_unmarked_time_is_what_no_phase_holds():
    ev = [("elementwise", 0, 3)] \
        + _phase("input", 5, 15, [("elementwise", 6, 14)]) \
        + [("Memcpy DtoD (Device -> Device)", 16, 18),
           ("vectorized_elementwise", 19, 25)] \
        + _phase("update", 30, 40, [("foreach", 31, 39)])
    t = _window(ev, calls=2)
    assert _read(t, "step.unmarked.ms") == pytest.approx((3 + 2 + 6) / 2e3)
    assert _read(t, "step.input.ms") == pytest.approx(8 / 2e3)
    assert _read(t, "step.forward.ms") is None


def test_a_marks_own_time_counts_in_no_phase():
    ev = _phase("backward", 0, 20, [("attention_bwd", 2, 18)])
    ev = [(n, s, e + 0.5) if n.startswith("ofb_mark_") else (n, s, e)
          for n, s, e in ev]           # marks that take longer than usual
    t = _window(ev, calls=1)
    assert _read(t, "step.backward.ms") == pytest.approx(16e-3)
    assert _read(t, "step.unmarked.ms") == 0.0
    assert marks.mark_of("void ofb_mark_update_end()") == ("update", "end")
    assert marks.mark_of("ofb_marks_elementwise") is None
