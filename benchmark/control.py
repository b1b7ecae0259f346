"""The readings the limits of `correct` are set from, over many seeds in one
process (the kernels built once):

    python3 -m benchmark.control --workload <cell> --what <what>
        --seeds <n> [<n> ...]

`--what program` reads the program's first three updates against the
plain reference, as a run does (the lower readings); `control` reads the
control, the reference with every matrix product in float8, against the
reference (it must fail); `unchanged`, `half` and `unexchanged` read the
program with a fault planted in its step: the update left out (the state
returned unchanged), half of each microbatch left out (the mean taken over
the rest), the gradients' and metrics' exchange between cards left out. A
cell on several cards starts its ranks as `benchmark.run` does (the control
needs one card). One JSON line a seed: the three gaps. Not run by the
benchmark's runs.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys

import torch


@contextlib.contextmanager
def planted(fault: str):
    """The program's step with `fault` planted, restored on exit."""
    from ofb_tpu_torch.core import steps
    name, new = {
        "unchanged": ("_apply", lambda *a, **k: None),
        "half": ("_gather", _half(steps._gather)),
        "unexchanged": ("all_mean_", lambda *a, **k: None),
    }[fault]
    old = getattr(steps, name)
    setattr(steps, name, new)
    try:
        yield
    finally:
        setattr(steps, name, old)


def _half(gather):
    def half(*args):
        imgs, lbls = gather(*args)
        mb = imgs.shape[1] // 2
        return imgs[:, :mb], lbls[:, :mb]
    return half


def program_reading(cell, seed: int, dev, rank: int) -> dict:
    """The program's first three updates through the window's own call."""
    from . import cells, program
    prog = cells.phase(cell.phase).build(cell.config, cell.workload, seed,
                                         dev, rank)
    reading = program.first_updates(prog, seed)
    prog.free()
    return reading


def read_seeds(cell, what: str, seeds, *, rank: int = 0, world: int = 1,
               port=None, device: str = "cuda", emit=print):
    from . import compare
    from .reference import steps as ref_steps
    dev = torch.device(device, rank) if device == "cuda" \
        else torch.device(device)
    if world > 1:
        import torch.distributed as dist
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
    for seed in seeds:
        if what == "control":
            got = ref_steps.run(cell.phase, cell.config, cell.workload, seed,
                                dev, control=True)
        else:
            ctx = planted(what) if what != "program" else \
                contextlib.nullcontext()
            with ctx:
                got = program_reading(cell, seed, dev, rank)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if rank == 0:
            ref = ref_steps.run(cell.phase, cell.config, cell.workload, seed,
                                dev)
            emit(json.dumps({"workload": cell.name, "what": what,
                             "seed": seed, **compare.gaps(got, ref)}))
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        if world > 1:
            torch.distributed.barrier()
    if world > 1:
        torch.distributed.destroy_process_group()


def main(argv=None):
    from .run import Cell, _free_port
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--what", required=True,
                    choices=("program", "control", "unchanged", "half",
                             "unexchanged"))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    world = 1 if args.what == "control" else cell.chips
    if args.rank is not None:
        read_seeds(cell, args.what, args.seeds, rank=args.rank, world=world,
                   port=args.port)
        return
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        sys.exit(f"{cell.name} needs {world} CUDA card(s)")
    if world == 1:
        read_seeds(cell, args.what, args.seeds)
        return
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "benchmark.control", "--workload", cell.name,
         "--what", args.what, "--seeds", *map(str, args.seeds), "--rank",
         str(r), "--port", str(port)]) for r in range(world)]
    codes = [p.wait() for p in procs]
    if any(codes):
        sys.exit(f"ranks exited with {codes}")


if __name__ == "__main__":
    main()
