"""Host milliseconds a step call that the epoch loop spends on its own work:
the harness's spans around each call of the planned step (the plan's check,
the graph's replay, the output's clone) and around the metric readback
every tenth call, as `core/engine.py`'s planned loop reads it, less the time
the host waits in the CUDA runtime inside them (`trace.TracedWindow.waits`:
the graph's launch, which blocks while the card's queue is full, the copy
to the host, a synchronise). That wait is the card's time seen from the
host, read as the kernels' times and `device.idle`; what is left moves
`img_s` where the host paces the card."""

from benchmark.trace import length, subtract


def read(t):
    if not t.calls:
        return None
    host = t.span_intervals("bench.call", "bench.readback")
    return length(subtract(host, t.waits)) * 1e-6 / t.calls * 1e3
