"""Metric tracking: SmoothedValue / MetricLogger.

A copy of ofb_tpu/utils/metrics.py (framework-free): windowed median / avg
and global average per meter, and the iteration logger with data / step
timing and ETA. The port is single-process, so no cross-rank sync.
"""

from __future__ import annotations

import collections
import datetime
import time
from typing import Dict, Iterable

import numpy as np


class SmoothedValue:
    """Windowed median/avg + global avg (reference utils.py:23-82)."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = collections.deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


class MetricLogger:
    """Iteration logger with data/step timing and ETA
    (reference utils.py:85-164)."""

    def __init__(self, delimiter: str = "  ", print_fn=print):
        self.meters: Dict[str, SmoothedValue] = collections.defaultdict(
            SmoothedValue)
        self.delimiter = delimiter
        self.print_fn = print_fn

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def add_meter(self, name, meter):
        self.meters[name] = meter

    def __getattr__(self, name):
        if name in self.meters:
            return self.meters[name]
        raise AttributeError(name)

    def __str__(self):
        return self.delimiter.join(
            f"{k}: {v}" for k, v in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = ""):
        i = 0
        start = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        try:
            total = len(iterable)
        except TypeError:
            total = None
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total and i == total - 1):
                if total:
                    eta = datetime.timedelta(
                        seconds=int(iter_time.global_avg * (total - i)))
                    self.print_fn(
                        f"{header} [{i}/{total}] eta: {eta} {self} "
                        f"time: {iter_time} data: {data_time}")
                else:
                    self.print_fn(f"{header} [{i}] {self} time: {iter_time}")
            i += 1
            end = time.time()
        elapsed = time.time() - start
        self.print_fn(
            f"{header} Total time: "
            f"{datetime.timedelta(seconds=int(elapsed))} "
            f"({elapsed / max(i, 1):.4f} s / it)")

    def averages(self) -> Dict[str, float]:
        return {k: m.global_avg for k, m in self.meters.items()}
