"""The traced window: the profiler's device intervals and the harness's own
host spans, and the interval arithmetic the per-layer readers use.

A traced run records, with `torch.profiler`, a fixed number of step calls
after the set-up, each wrapped in the harness's host spans (`bench.call`,
`bench.readback`, `bench.sync`, recorded by `record_function` so that they
share the device events' clock). The window runs from the first call's
start to the end of the final synchronise. Device intervals are kernels,
memcpys and memsets; a kernel's class (GEMM, attention, NCCL, other) is
read from its name. Host intervals in which the CUDA runtime waits for the
card are kept too: a graph's launch (which blocks while the card's queue
is full), a copy to the host, a synchronise.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]

SPAN_PREFIX = "bench."
_GEMM = re.compile(r"gemm|nvjet|xmma|cutlass|cublas", re.IGNORECASE)
_MEM = re.compile(r"^(memcpy|memset)", re.IGNORECASE)
_WAIT = re.compile(r"^cuda(GraphLaunch|Memcpy|StreamSynchronize|"
                   r"DeviceSynchronize|EventSynchronize)")


def kernel_class(name: str) -> str:
    """'attention' (the port's attention_* kernels), 'nccl', 'gemm' (cuBLAS
    and cuDNN matrix products, by name), 'memory' (memcpy, memset) or
    'other'."""
    if "attention_" in name:
        return "attention"
    if name.startswith("nccl") or "nccl" in name[:40].lower():
        return "nccl"
    if _MEM.match(name):
        return "memory"
    if _GEMM.search(name):
        return "gemm"
    return "other"


def union(iv: Sequence[Interval]) -> List[Interval]:
    """The union of intervals, as sorted disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted(iv):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def length(iv: Sequence[Interval]) -> float:
    return sum(e - s for s, e in union(iv))


def clip(iv: Sequence[Interval], window: Interval) -> List[Interval]:
    lo, hi = window
    return [(max(s, lo), min(e, hi)) for s, e in iv if e > lo and s < hi]


def subtract(a: Sequence[Interval], b: Sequence[Interval]) -> List[Interval]:
    """The parts of union(a) that union(b) does not cover."""
    out, bs = [], union(b)
    for s, e in union(a):
        cur = s
        for bs_, be in bs:
            if be <= cur or bs_ >= e:
                continue
            if bs_ > cur:
                out.append((cur, bs_))
            cur = max(cur, be)
            if cur >= e:
                break
        if cur < e:
            out.append((cur, e))
    return out


def gaps(iv: Sequence[Interval], window: Interval) -> List[Interval]:
    """The parts of the window that no interval covers."""
    return subtract([window], iv)


@dataclass
class TracedWindow:
    """What a per-layer reader reads: the device events (name, start, end,
    in us), the harness's host spans (name, start, end), the window, the
    number of step calls in it, the cell and the host's waits in the CUDA
    runtime (start, end)."""
    events: List[Tuple[str, float, float]]
    spans: List[Tuple[str, float, float]]
    window: Interval
    calls: int
    cell: dict                      # config, workload, phase, geometry
    power_limit_w: Optional[float] = None
    waits: List[Interval] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def intervals(self, *classes: str) -> List[Interval]:
        return clip([(s, e) for n, s, e in self.events
                     if not classes or kernel_class(n) in classes],
                    self.window)

    def device_s(self, *classes: str) -> float:
        """Summed device time (s) of the events of these classes in the
        window (not their union: two kernels at once both count)."""
        return sum(e - s for s, e in self.intervals(*classes)) * 1e-6

    def busy_s(self) -> float:
        """Seconds of the window in which the card runs anything."""
        return length(self.intervals()) * 1e-6

    def span_s(self, name: str) -> float:
        return sum(e - s for n, s, e in self.spans if n == name) * 1e-6

    def span_intervals(self, *names: str) -> List[Interval]:
        return [(s, e) for n, s, e in self.spans if n in names]


def from_profile(prof, cell: dict, calls: int,
                 power_limit_w=None) -> TracedWindow:
    """The traced window of a finished `torch.profiler.profile`."""
    from torch.autograd import DeviceType
    events, spans, waits = [], [], []
    for e in prof.events():
        tr = e.time_range
        if e.name.startswith(SPAN_PREFIX):
            # a span's device-side projection is no device work
            if e.device_type != DeviceType.CUDA:
                spans.append((e.name, float(tr.start), float(tr.end)))
        elif e.device_type == DeviceType.CUDA:
            events.append((e.name, float(tr.start), float(tr.end)))
        elif _WAIT.match(e.name):
            waits.append((float(tr.start), float(tr.end)))
    calls_at = [s for n, s, _ in spans if n == SPAN_PREFIX + "call"]
    ends = [e for n, _, e in spans if n == SPAN_PREFIX + "sync"]
    if not calls_at or not ends:
        raise RuntimeError("the traced window holds none of the harness's "
                           "spans")
    return TracedWindow(events=events, spans=spans,
                        window=(min(calls_at), max(ends)), calls=calls,
                        cell=cell, power_limit_w=power_limit_w, waits=waits)


def breakdown(t: TracedWindow, top: int = 10) -> dict:
    """The longest device operations by name and the longest idle gaps,
    each gap named by the harness span over its middle."""
    by_name: Dict[str, float] = {}
    for n, s, e in t.events:
        s, e = max(s, t.window[0]), min(e, t.window[1])
        if e > s:
            by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = []
    for s, e in gaps(t.intervals(), t.window):
        mid = 0.5 * (s + e)
        over = [(se - ss, n) for n, ss, se in t.spans if ss <= mid <= se]
        label = min(over)[1][len(SPAN_PREFIX):] if over else "host"
        idle.append([label, (e - s) * 1e-6])
    idle.sort(key=lambda x: -x[1])
    return {"device_ops": [[n[:160], v] for n, v in ops],
            "idle_gaps": idle[:top]}
