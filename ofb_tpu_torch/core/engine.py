"""Per-epoch loops: search, train, evaluate.

Port of ofb_tpu/core/engine.py: the classic loops over a feed, and the
planned loops over a `core.steps.PlannedStep` (the epoch's index plan on
the device, one graph replay an iteration on the card). The inner loop
enqueues steps and, at the compress cadence, runs the host-side compress
pass. Metrics stay on the device until the log window ends and come back in
one transfer per window, so the host runs ahead of the device between
windows.

Each epoch prints its wall time and sustained img/s and splits the time
into feed (waiting for the next batch: for the decode workers and the
loader's pin thread, or for the decode itself without workers, then the
copy's enqueue and, for an unfused step, the augment's dispatch), dispatch
(enqueueing the steps), readback (the window transfers, which wait for the
device) and compress (the host passes). `epoch_lines` reads that line back.
"""

from __future__ import annotations

import math
import re
import sys
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from ..config import SearchConfig
from ..models.search_space import SearchSpace
from ..parallel.distributed import all_sum, data_group
from ..utils.logging import master_print
from ..utils.metrics import MetricLogger
from .compress import compress, sync_w_p, update_w_p
from .steps import TrainState, keep_ratio_schedule


class _Window:
    """Metrics of the steps since the last readback, read back in one
    transfer: the values of every step stacked on the device, then one copy
    to the host. Without `keys` a step hands a {name: tensor} dict; with
    `keys` a packed fp32 vector in that order, and a value of `halt` that
    is not finite in any row ends the run (exit code 1)."""

    def __init__(self, logger: MetricLogger, timing: Dict[str, float],
                 keys=None, halt: Optional[str] = None, print_fn=None):
        self.logger = logger
        self.timing = timing
        self.keys = keys
        self.halt = halt
        self.print_fn = print_fn
        self.pending: List[Any] = []

    def add(self, metrics):
        self.pending.append(metrics)

    def flush(self):
        if not self.pending:
            return
        t0 = time.perf_counter()
        if self.keys is None:
            keys = list(self.pending[0])
            rows = [torch.stack([m[k].detach().float() for k in keys])
                    for m in self.pending]
        else:
            keys, rows = self.keys, [m.reshape(-1) for m in self.pending]
        host = torch.stack(rows).cpu().tolist()
        self.timing["readback_s"] += time.perf_counter() - t0
        for row in host:
            self.logger.update(**dict(zip(keys, row)))
            if self.halt is not None:
                val = row[keys.index(self.halt)]
                if not math.isfinite(val):
                    self.print_fn(f"Loss is {val}, stopping training")
                    sys.exit(1)
        self.pending.clear()


def _batch_images(imgs) -> int:
    return int(imgs.shape[0] * imgs.shape[1]) if imgs.dim() == 5 \
        else int(imgs.shape[0])


def _timed(feed, timing):
    """Iterate `feed`, adding the time spent waiting for it to feed_s."""
    it = iter(feed)
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        timing["feed_s"] += time.perf_counter() - t0
        yield item


def _close(stats, timing, t_epoch, n_images, epoch, print_fn):
    dt = time.perf_counter() - t_epoch
    stats["epoch_time_s"] = dt
    stats["img_s"] = n_images / max(dt, 1e-9)
    print_fn(f"Epoch [{epoch}] total {dt:.1f}s "
             f"({stats['img_s']:.1f} img/s sustained) "
             f"[feed {timing['feed_s']:.3f}s "
             f"dispatch {timing['dispatch_s']:.3f}s "
             f"readback {timing['readback_s']:.3f}s "
             f"compress {timing['compress_s']:.3f}s]")
    return stats


_EPOCH_LINE = re.compile(
    r"Epoch \[(\d+)\] total [\d.]+s \(([\d.]+) img/s sustained\) "
    r"\[feed ([\d.]+)s dispatch ([\d.]+)s readback ([\d.]+)s "
    r"compress ([\d.]+)s\]")


def epoch_lines(text: str) -> List[Dict[str, float]]:
    """The epoch lines `_close` printed in `text`: epoch, img_s and the
    split's feed_s, dispatch_s, readback_s and compress_s, in order."""
    keys = ("epoch", "img_s", "feed_s", "dispatch_s", "readback_s",
            "compress_s")
    return [dict(zip(keys, (int(m[0]),) + tuple(float(x) for x in m[1:])))
            for m in _EPOCH_LINE.findall(text)]


def _halt_if_not_finite(logger, key, print_fn):
    val = logger.meters[key].value
    if not math.isfinite(val):
        print_fn(f"Loss is {val}, stopping training")
        sys.exit(1)


def _new_timing() -> Dict[str, float]:
    return {"feed_s": 0.0, "dispatch_s": 0.0, "readback_s": 0.0,
            "compress_s": 0.0}


def _compress(state, scfg, space, timing, print_fn):
    """One compress pass on the state, in place; returns its report."""
    print_fn("Start Compression")
    t_c = time.perf_counter()
    params, alphas, arch, opt_state, report = compress(
        state.params, state.alphas, state.arch, state.opt_state, space,
        scfg.compress_thresh)
    state.params, state.alphas, state.arch, state.opt_state = \
        params, alphas, arch, opt_state
    dt_c = time.perf_counter() - t_c
    timing["compress_s"] += dt_c
    for e in report.events:
        print_fn(f"  {e}")
    print_fn(f"  compress pass {dt_c:.4f}s ({len(report.events)} events)")
    return report


def search_one_epoch(state: TrainState, step_fn: Callable, feed: Iterable,
                     *, epoch: int, steps_per_epoch: int, scfg: SearchConfig,
                     space: SearchSpace, generator, finish_search: bool,
                     log_every: int = 10, print_fn=master_print
                     ) -> Tuple[TrainState, Dict[str, float], bool, bool]:
    """One search epoch. Returns (state, stats, finish_search,
    execute_pruned).

    Per iteration: the PMIM keep ratio and the w_p anneal at the fraction of
    the epoch done, then `step_fn(state, images, labels, generator, keep)`.
    Unless the search has finished, compress runs every steps_per_epoch //
    compress_per_epoch iterations. A loss that is not finite at a log
    window's readback ends the run (exit code 1)."""
    timing = _new_timing()
    logger = MetricLogger(print_fn=print_fn)
    window = _Window(logger, timing)
    execute_pruned = False
    A = scfg.accum_iter
    micro_per_epoch = steps_per_epoch * A
    compress_every = max(steps_per_epoch // scfg.compress_per_epoch, 1)
    t_epoch = time.perf_counter()
    n_images = 0

    for it, (imgs, lbls) in enumerate(_timed(feed, timing)):
        frac_epoch = (it * A) / max(micro_per_epoch, 1) + epoch
        keep = keep_ratio_schedule(frac_epoch, scfg, state.arch, space)
        update_w_p(state.arch, frac_epoch, scfg.schedule.warmup_epochs)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, imgs, lbls, generator, keep)
        timing["dispatch_s"] += time.perf_counter() - t0
        window.add(metrics)
        n_images += _batch_images(imgs)

        if it % log_every == 0 or it == steps_per_epoch - 1:
            window.flush()
            _halt_if_not_finite(logger, "loss_total", print_fn)
            print_fn(f"Epoch [{epoch}] [{it}/{steps_per_epoch}] {logger}")

        if not finish_search and (it + 1) % compress_every == 0:
            window.flush()
            report = _compress(state, scfg, space, timing, print_fn)
            execute_pruned |= report.execute_prune
            finish_search = report.finish_search

    window.flush()
    stats = _close(logger.averages(), timing, t_epoch, n_images, epoch,
                   print_fn)
    return state, stats, finish_search, execute_pruned


def train_one_epoch(state: TrainState, step_fn: Callable, feed: Iterable, *,
                    epoch: int, steps_per_epoch: int, generator,
                    log_every: int = 10, print_fn=master_print
                    ) -> Tuple[TrainState, Dict[str, float]]:
    """One finetune epoch of `step_fn(state, images, labels, generator)`,
    with the search epoch's readback windows and NaN halt."""
    timing = _new_timing()
    logger = MetricLogger(print_fn=print_fn)
    window = _Window(logger, timing)
    t_epoch = time.perf_counter()
    n_images = 0
    for it, (imgs, lbls) in enumerate(_timed(feed, timing)):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, imgs, lbls, generator)
        timing["dispatch_s"] += time.perf_counter() - t0
        window.add(metrics)
        n_images += _batch_images(imgs)
        if it % log_every == 0 or it == steps_per_epoch - 1:
            window.flush()
            _halt_if_not_finite(logger, "loss", print_fn)
            print_fn(f"Epoch [{epoch}] [{it}/{steps_per_epoch}] {logger}")
    window.flush()
    stats = _close(logger.averages(), timing, t_epoch, n_images, epoch,
                   print_fn)
    return state, stats


def _graph_line(step_fn, print_fn):
    if step_fn.captures:
        print_fn(f"planned step: {step_fn.captures} CUDA graph capture, "
                 f"{step_fn.replays} replays of {step_fn.calls} calls")


def search_one_epoch_planned(state: TrainState, step_fn, metric_keys,
                             cache: torch.Tensor, labels, batches, *,
                             epoch: int, scfg: SearchConfig,
                             space: SearchSpace, generator,
                             finish_search: bool, log_every: int = 10,
                             print_fn=master_print
                             ) -> Tuple[TrainState, Dict[str, float], bool,
                                        bool]:
    """`search_one_epoch` over a `make_planned_search_step` step: the
    epoch's index plan `batches` (steps, batch) into the uint8 device
    `cache` goes to the device once (`step_fn.load_plan`), and each
    iteration is one call that takes no host input. The compress cadence,
    the NaN halt (on every step's packed loss) and the log windows are the
    classic loop's; before a compress pass and at the end of the epoch the
    host writes the w_p the schedule gives at that point, so the state
    carries what the next step would apply."""
    timing = _new_timing()
    logger = MetricLogger(print_fn=print_fn)
    window = _Window(logger, timing, keys=list(metric_keys),
                     halt="loss_total", print_fn=print_fn)
    execute_pruned = False
    A = scfg.accum_iter
    warm = scfg.schedule.warmup_epochs
    t_epoch = time.perf_counter()
    idx_plan, labels_plan, base, epoch_dev = step_fn.load_plan(
        batches, labels, epoch, state.step)
    steps_per_epoch = int(idx_plan.shape[0])
    micro = max(steps_per_epoch * A, 1)
    compress_every = max(steps_per_epoch // scfg.compress_per_epoch, 1)

    for it in range(steps_per_epoch):
        t0 = time.perf_counter()
        state, packed = step_fn(state, cache, idx_plan, labels_plan,
                                generator, base, epoch_dev)
        timing["dispatch_s"] += time.perf_counter() - t0
        window.add(packed)

        if it % log_every == 0 or it == steps_per_epoch - 1:
            window.flush()
            print_fn(f"Epoch [{epoch}] [{it}/{steps_per_epoch}] {logger}")

        if not finish_search and (it + 1) % compress_every == 0:
            window.flush()
            sync_w_p(state.arch, epoch + ((it + 1) * A) / micro, warm)
            report = _compress(state, scfg, space, timing, print_fn)
            execute_pruned |= report.execute_prune
            finish_search = report.finish_search

    window.flush()
    sync_w_p(state.arch, epoch + 1.0, warm)
    _graph_line(step_fn, print_fn)
    stats = _close(logger.averages(), timing, t_epoch, idx_plan.numel(),
                   epoch, print_fn)
    return state, stats, finish_search, execute_pruned


def train_one_epoch_planned(state: TrainState, step_fn,
                            cache: torch.Tensor, labels, batches, *,
                            epoch: int, generator, log_every: int = 10,
                            print_fn=master_print
                            ) -> Tuple[TrainState, Dict[str, float]]:
    """`train_one_epoch` over a `make_planned_train_step` step, the plan on
    the device as in `search_one_epoch_planned`."""
    timing = _new_timing()
    logger = MetricLogger(print_fn=print_fn)
    window = _Window(logger, timing, keys=["loss"], halt="loss",
                     print_fn=print_fn)
    t_epoch = time.perf_counter()
    idx_plan, labels_plan, base, _ = step_fn.load_plan(
        batches, labels, epoch, state.step)
    steps_per_epoch = int(idx_plan.shape[0])
    for it in range(steps_per_epoch):
        t0 = time.perf_counter()
        state, loss = step_fn(state, cache, idx_plan, labels_plan,
                              generator, base)
        timing["dispatch_s"] += time.perf_counter() - t0
        window.add(loss)
        if it % log_every == 0 or it == steps_per_epoch - 1:
            window.flush()
            print_fn(f"Epoch [{epoch}] [{it}/{steps_per_epoch}] {logger}")
    window.flush()
    _graph_line(step_fn, print_fn)
    stats = _close(logger.averages(), timing, t_epoch, idx_plan.numel(),
                   epoch, print_fn)
    return state, stats


def evaluate(eval_step: Callable, feed: Iterable, *args,
             print_fn=master_print, header: str = "Test:"
             ) -> Dict[str, float]:
    """Top-1 / top-5 / loss over a feed. `args` are the model state pieces
    the eval step takes before (images, labels). The sums stay on the
    device (float64) and come back once at the end; under a process group
    they are then summed over the ranks of the data axis (each rank's feed
    its shard of the val set; a model group's ranks score the same rows),
    so every rank reports the full val set's statistics."""
    keys = ("loss_sum", "top1", "top5", "count")
    tot = None
    for imgs, lbls in feed:
        if imgs.dim() == 5:                     # (A, mb, ...) -> one batch
            imgs = imgs.reshape(-1, *imgs.shape[2:])
            lbls = lbls.reshape(-1)
        m = eval_step(*args, imgs, lbls)
        row = torch.stack([m[k].detach().double() for k in keys])
        tot = row if tot is None else tot + row
    vals = dict(zip(keys, all_sum(tot.cpu().tolist() if tot is not None
                                  else [0.0] * 4, group=data_group())))
    n = max(vals["count"], 1.0)
    stats = {"loss": vals["loss_sum"] / n, "acc1": 100.0 * vals["top1"] / n,
             "acc5": 100.0 * vals["top5"] / n}
    print_fn(f"{header} Acc@1 {stats['acc1']:.3f} Acc@5 {stats['acc5']:.3f} "
             f"loss {stats['loss']:.3f}")
    return stats
