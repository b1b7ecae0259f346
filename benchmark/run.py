"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout holding the program (`ofb_tpu_torch`) and
`BENCHMARK.json`. The cell's files (`workloads/<cell>.json`, its
configuration, its phase module, its per-layer readers) are found by name.
A cell on several cards starts one process a card itself (NCCL over
`tcp://localhost`); rank 0's readings decide `correct`, and this process
prints the line.

A run: set-up (imports, the kernels built or loaded, the benchmark's
weights, device cache and plan made from the seed, the program's step
built and its first three calls: two eager warm-up calls and the CUDA
graph's capture), then the measured window of `--seconds`, calling the step
once an iteration and reading its outputs back every tenth call, as the
program's planned epoch loop does; then, with the program's state freed,
the plain reference's three updates for the comparison (`compare`). With
`--trace 1` a fixed number of calls (the workload's `trace_calls`) are
traced instead of the window, and the per-layer metrics are read from the
trace.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` `breakdown`,
and last `checks`, each number compared beside its limit (which also close
standard error). Without a CUDA card, or with fewer than the cell needs, it
exits 2 and prints no result; it exits 1 and prints none if the process
holds a module of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import time
from contextlib import nullcontext
from typing import Optional

FOREIGN = ("jax", "jaxlib", "flax", "ofb_tpu")
READBACK_EVERY = 10           # the engine's log_every: one readback a window
WARM_CALLS = 3                # calls between the set-up and a traced window
RANK_TIMEOUT = 1100           # seconds a rank may take


def process_start_wall() -> float:
    """This process's start, on the wall clock (from /proc)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    ticks = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.time() - uptime + ticks


def foreign_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FOREIGN))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def power_limit_w(rank: int) -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", str(rank)],
            capture_output=True, text=True, timeout=60, check=True)
        return float(out.stdout.strip())
    except (OSError, subprocess.SubprocessError, ValueError):
        return None


class Cell:
    """A cell's files, read by name."""

    def __init__(self, name: str):
        from . import cells
        self.name = name
        self.bench = cells.benchmark()
        self.workload = cells.workload(name)
        self.config = cells.config(self.workload["config"])
        self.phase = self.workload["phase"]
        self.chips = self.workload["chips"]


def _window(prog, deadline_s: Optional[float], calls: Optional[int],
            stop_group, trace_spans: bool):
    """Call the step until the deadline (or `calls` times), reading the
    outputs back every tenth call; returns (calls, seconds, non-finite
    losses). Ranks agree at each readback whether to go on."""
    import torch
    import torch.distributed as dist
    from torch.profiler import record_function

    def span(name):
        return record_function("bench." + name) if trace_spans \
            else nullcontext()

    dev = prog.cache.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    sync()
    pending, n, bad = [], 0, 0
    t0 = time.perf_counter()
    while True:
        with span("call"):
            pending.append(prog.loss(prog.call()))
        n += 1
        if calls is not None and n >= calls:
            break
        if (n - 1) % READBACK_EVERY == 0:
            with span("readback"):
                vals = torch.stack(pending).cpu().tolist()
                pending.clear()
                bad += sum(not math.isfinite(v) for v in vals)
                stop = calls is None \
                    and time.perf_counter() - t0 >= deadline_s
                if stop_group is not None:
                    flag = torch.tensor([int(stop)])
                    dist.all_reduce(flag, op=dist.ReduceOp.MAX,
                                    group=stop_group)
                    stop = bool(flag.item())
            if stop:
                break
    with span("sync"):
        if pending:
            vals = torch.stack(pending).cpu().tolist()
            bad += sum(not math.isfinite(v) for v in vals)
        sync()
    return n, time.perf_counter() - t0, bad


def run_rank(cell: Cell, seed: int, seconds: float, trace: bool, *,
             rank: int = 0, world: int = 1, device: str = "cuda",
             port: Optional[int] = None,
             t_start: Optional[float] = None) -> dict:
    """One rank's run of the cell; returns its readings."""
    import torch
    import torch.distributed as dist
    from . import cells, compare, program, trace as tr
    from .reference import steps as ref_steps

    t_start = process_start_wall() if t_start is None else t_start
    dev = torch.device(device, rank) if device == "cuda" \
        else torch.device(device)
    stop_group = None
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    if world > 1:
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=world)
        stop_group = dist.new_group(backend="gloo")
    wl, cfg = cell.workload, cell.config
    t_in = time.time()
    prog = cells.phase(cell.phase).build(cfg, wl, seed, dev, rank)
    t_built = time.time()
    reading = program.first_updates(prog, seed)
    log(f"rank {rank} set-up: {t_in - t_start:.2f} s to the harness (imports, "
        f"process group), {t_built - t_in:.2f} s building the step and its "
        f"inputs, {time.time() - t_built:.2f} s in the three checked calls")

    out = {"rank": rank, "attempted": 0, "failed": 0}
    if not trace:
        if world > 1:
            dist.barrier(group=stop_group)
        out["setup_s"] = time.time() - t_start
        n, dt, bad = _window(prog, seconds, None, stop_group, False)
        out.update(attempted=n, failed=bad, window_s=dt,
                   img_s=n * prog.geo.mb * prog.geo.A / dt)
    else:
        from torch.profiler import ProfilerActivity, profile
        _window(prog, None, WARM_CALLS, stop_group, False)
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            n, dt, bad = _window(prog, None, wl["trace_calls"], stop_group,
                                 True)
        view = tr.from_profile(prof, {
            "config": cfg, "workload": wl, "phase": cell.phase,
            "rank_images_per_call": prog.geo.mb * prog.geo.A,
            "rank_rows": prog.geo.mb, "microbatches_per_call": prog.geo.A},
            n, power_limit_w(rank) if dev.type == "cuda" else None)
        del prof
        vals = {}
        for m in cells.per_layer(cell.bench, cell.name):
            v = cells.metric_reader(m["name"]).read(view)
            if v is not None:
                vals[m["name"]] = v
        out.update(attempted=n, failed=bad, per_layer=vals,
                   busy_s=view.busy_s(), trace_window_s=view.window_s,
                   breakdown=tr.breakdown(view),
                   power_limit_w=view.power_limit_w)
    if dev.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        out["kind"] = torch.cuda.get_device_name(dev)
    else:
        out["peak_bytes"], out["kind"] = 0, "cpu"

    prog.free()
    del prog
    gc.collect()
    if world > 1:
        dist.destroy_process_group()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if rank == 0:
        t_ref = time.time()
        ref = ref_steps.run(cell.phase, cfg, wl, seed, dev)
        log(f"the reference's updates took {time.time() - t_ref:.2f} s")
        out["correct"], out["checks"] = compare.judge(
            compare.gaps(reading, ref), wl["limits"])
    out["foreign"] = foreign_modules()      # after all the rank has run
    return out


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(args, cell: Cell, t_start: float):
    """Start one process a card and collect their readings."""
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for r in range(cell.chips):
            cmd = [sys.executable, "-m", "benchmark.run", "--workload",
                   args.workload, "--seed", str(args.seed), "--seconds",
                   str(args.seconds), "--trace", str(args.trace),
                   "--rank", str(r), "--world", str(cell.chips), "--port",
                   str(port), "--t-start", repr(t_start), "--out",
                   os.path.join(tmp, f"rank{r}.json")]
            procs.append(subprocess.Popen(cmd))
        deadline = time.time() + RANK_TIMEOUT
        failed = None
        while any(p.poll() is None for p in procs):
            if failed is None:
                failed = next((r for r, p in enumerate(procs)
                               if p.poll() not in (None, 0)), None)
            if failed is not None or time.time() > deadline:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
            time.sleep(0.2)
        for p in procs:
            p.wait()
        codes = [p.returncode for p in procs]
        if any(codes):
            log(f"ranks exited with {codes}")
            sys.exit(1)
        outs = []
        for r in range(cell.chips):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                outs.append(json.load(f))
    return outs


def merge(cell: Cell, outs, trace: bool) -> dict:
    """The cell's result line from its ranks' readings."""
    from . import cells
    r0 = outs[0]
    metrics = {}
    if not trace:
        vals = {"img_s": sum(o["img_s"] for o in outs),
                "peak_mem_gib": max(o["peak_bytes"] for o in outs) / 2 ** 30,
                "setup_s": max(o["setup_s"] for o in outs)}
        for m in cells.end_to_end(cell.bench, cell.name):
            metrics[m["name"]] = {"value": vals[m["name"]], "unit": m["unit"]}
    else:
        for m in cells.per_layer(cell.bench, cell.name):
            got = [o["per_layer"][m["name"]] for o in outs
                   if m["name"] in o["per_layer"]]
            if not got:
                continue
            how = getattr(cells.metric_reader(m["name"]), "COMBINE", "mean")
            v = max(got) if how == "max" else sum(got) / len(got)
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": r0["kind"], "count": len(outs),
              "memory_peak_bytes": max(o["peak_bytes"] for o in outs)}
    line = {"correct": bool(r0["correct"]) and not any(
                o["failed"] for o in outs),
            "attempted": r0["attempted"],
            "failed": sum(o["failed"] for o in outs),
            "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = sum(o["busy_s"] for o in outs) / len(outs)
        device["window_s"] = sum(o["trace_window_s"] for o in outs) / len(outs)
        line["breakdown"] = r0["breakdown"]
    line["checks"] = r0["checks"]
    return line


def emit(line: dict, outs) -> None:
    foreign = sorted({m for o in outs for m in o["foreign"]}
                     | set(foreign_modules()))
    if foreign:
        log(f"modules of JAX or of the JAX package are loaded: {foreign}")
        sys.exit(1)
    if outs[0].get("power_limit_w") is not None:
        log(f"card power limit {outs[0]['power_limit_w']} W")
    for k, c in line["checks"].items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--t-start", type=float, help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    t_start = args.t_start if args.t_start is not None \
        else process_start_wall()
    cell = Cell(args.workload)
    trace = bool(args.trace)

    if args.rank is not None:             # one rank of a several-card cell
        out = run_rank(cell, args.seed, args.seconds, trace, rank=args.rank,
                       world=args.world, port=args.port, t_start=t_start)
        with open(args.out, "w") as f:
            json.dump(out, f)
        return

    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA card(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"{torch.cuda.device_count()} found")
        sys.exit(2)
    if cell.chips == 1:
        outs = [run_rank(cell, args.seed, args.seconds, trace,
                         t_start=t_start)]
    else:
        outs = _run_ranks(args, cell, t_start)
    emit(merge(cell, outs, trace), outs)


if __name__ == "__main__":
    main()
