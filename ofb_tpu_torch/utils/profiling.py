"""Profiling hooks: a torch.profiler trace and the phases of a step.

Port of ofb_tpu/utils/profiling.py. `trace(logdir)` records the host and,
on the card, the device activity of its block and writes a Chrome trace
(`trace.json`, open it in Perfetto or chrome://tracing) into `logdir`.

`step_phase(name)` names a part of a training step (`PHASES`: input,
forward, loss, backward, update; `core/steps.py` places them). It always
opens the profiler range `ofb.step.<name>`, which an eager step shows as a
host span (and, on the card, as that span's device-side projection). A
step captured as a CUDA graph (`core.steps.PlannedStep`) runs no Python at
a replay, so there the phase also launches two empty kernels on the
captured stream, `ofb_mark_<name>_begin` and `ofb_mark_<name>_end`
(`csrc/step_marks.cu`): graph nodes that every replay runs in stream order
around the phase's own kernels. A device trace of replays (`trace`, or the
benchmark's `benchmark/marks.py`) splits a call's device time by phase
from the marks' times. Outside a capture, and on the CPU, a phase launches
nothing and loads no library.

To see a run's step phases, wrap a few step calls in `trace(logdir)` and
open `logdir/trace.json`: an eager step's phases are host spans named
`ofb.step.*`; a replayed graph's are the `ofb_mark_*` kernels on the
device's stream, each phase's kernels between its begin and end marks.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
from typing import Optional

import torch

PHASES = ("input", "forward", "loss", "backward", "update")
RANGE_PREFIX = "ofb.step."
STEP_RANGES = tuple(RANGE_PREFIX + p for p in PHASES)


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """Capture a torch.profiler trace of the block into
    `logdir`/trace.json (nothing without a logdir). Yields the profiler
    (None without a logdir)."""
    if not logdir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@functools.lru_cache(maxsize=None)
def load_step_marks():
    """The C entry that launches a mark: its library built and loaded, and
    every mark kernel loaded into the current context. A step's capture
    calls it first, so that the capture records only the marks'
    launches."""
    from ..ops.cuda_build import load
    lib = load("step_marks")
    lib.ofb_step_marks_load.argtypes = []
    lib.ofb_step_marks_load.restype = ctypes.c_int
    rc = lib.ofb_step_marks_load()
    if rc != 0:
        raise RuntimeError(f"loading the step marks failed: CUDA error {rc}")
    fn = lib.ofb_step_mark
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _mark(phase: int, edge: int) -> None:
    rc = load_step_marks()(phase, edge,
                           torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the {PHASES[phase]} step mark failed: CUDA "
                           f"error {rc}")


@contextlib.contextmanager
def step_phase(name: str):
    """The block is step phase `name` (one of `PHASES`): the profiler
    range `ofb.step.<name>` and, while the current CUDA stream is captured,
    a begin and an end mark kernel on it."""
    if name not in PHASES:
        raise ValueError(f"step phase {name!r} (one of {', '.join(PHASES)})")
    # no stream captures before CUDA is initialised
    marks = torch.cuda.is_initialized() \
        and torch.cuda.is_current_stream_capturing()
    phase = PHASES.index(name)
    with torch.profiler.record_function(RANGE_PREFIX + name):
        if marks:
            _mark(phase, 0)
        yield
        if marks:
            _mark(phase, 1)
