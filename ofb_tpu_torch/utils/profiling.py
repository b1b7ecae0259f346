"""Profiling hooks: a torch.profiler trace and a step timer.

Port of ofb_tpu/utils/profiling.py. `trace(logdir)` records the host and,
on the card, the device activity of its block and writes a Chrome trace
(`trace.json`, open it in Perfetto or chrome://tracing) into `logdir`.
`StepTimer` measures steps a second between hard synchronisations: a
scalar read back to the host, which waits for every step queued before it.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


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


class StepTimer:
    """Wall-clock steps a second, synchronised every `sync_every` steps."""

    def __init__(self, sync_every: int = 50):
        self.sync_every = sync_every
        self.count = 0
        self.t0 = time.perf_counter()
        self.synced_steps = 0
        self.rate = float("nan")

    def tick(self, sync_value=None) -> Optional[float]:
        """Call once a step with a small device scalar; returns steps/s
        over the steps since the last sync at each `sync_every`-th call
        (None otherwise)."""
        self.count += 1
        if self.count % self.sync_every == 0 and sync_value is not None:
            float(sync_value)  # the readback waits for the queued steps
            now = time.perf_counter()
            self.rate = (self.count - self.synced_steps) / (now - self.t0)
            self.t0 = now
            self.synced_steps = self.count
            return self.rate
        return None
