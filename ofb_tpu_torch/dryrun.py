"""Multi-device dry run of the tensor-parallel search step: the counterpart of
the JAX package's `__graft_entry__.dryrun_multichip`; and `entry()`, the
counterpart of its `entry` (the flagship's forward and example inputs).

    python -m ofb_tpu_torch.dryrun --devices N [--tiny] [--device cpu|cuda]
    torchrun --nproc_per_node N -m ofb_tpu_torch.dryrun [--tiny]
        [--mesh DP TP] [--batch B] [--steps K] [--planned]

Runs the flagship DeiT-S supernet in bf16 (the 32-wide two-block model in
fp32 with --tiny, the JAX package's OFB_DRYRUN_TINY=1) over a (data,
model) mesh of N ranks, with the JAX function's mesh choice: a model axis
of 2 when N is even and at least 4, else 1. One search step on a global
batch of one image per data rank, then a forced compress event (block 0's
MLP alpha cell 0 pushed to -8, the consensus prune decision), the digest
line, then a step after the prune. `--mesh` replaces the mesh choice,
`--batch` the global batch and `--steps K` times K more steps after those
(host time, synchronised); each rank then prints its ms a step and its
peak device memory. With `--planned` (DeiT-S on the card) the K steps are
the planned step's instead (`bench.PlannedCalls`: a device cache of uint8
staging images, the fused augment, this data rank's columns of one plan),
eager and replayed as a CUDA graph in turns (`bench.time_planned`), which
on a model axis needs NCCL.

Every rank runs on the card unless --device cpu asks for the CPU. Under a
launcher (torchrun's environment, or the JAX package's
COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID) it runs in place, one
process a rank, over NCCL (gloo with --device cpu). Without one it starts
N processes itself that meet over gloo through a file rendezvous, as the
JAX function re-executes itself onto an N-device CPU platform: they share
the one card, or run on the CPU with --device cpu. Their output is passed
on in rank order and the exit status is non-zero when any rank failed;
the first rank to fail ends the others at once, and its exit code and
stderr are named (`run_ranks`).
"""

from __future__ import annotations

import argparse
import hashlib
import os
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch

TIMEOUT = 1200          # seconds a spawned rank may take
PEER_TIMEOUT = 300      # seconds a spawned rank waits for a peer (the
                        # rendezvous, a collective) before it raises


def flagship(tiny: bool, device):
    """The DeiT-S supernet's bundle, or the 32-wide model of the JAX
    package's tiny dry run."""
    from .models.registry import ModelBundle, create_model
    from .models.search_space import SearchSpace
    from .models.vit import ModelCfg
    if not tiny:
        return create_model("deit_small_patch16_224_mim", device=device,
                            patch_search=True)
    cfg = ModelCfg(img_size=32, patch_size=8, num_classes=16, embed_dim=32,
                   depth=2, num_heads=2, mlp_ratio=2.0)
    space = SearchSpace.build(cfg.embed_dim, cfg.depth, cfg.num_heads,
                              cfg.hidden, cfg.num_patches, patch_search=True)
    return ModelBundle(name="tiny", cfg=cfg, space=space,
                       device=torch.device(device), kind="mim")


def entry(device="cuda"):
    """The flagship's forward as `(fn, (params, alphas, arch, x))`: the port
    of `__graft_entry__.entry`. `fn(params, alphas, arch, x)` is the DeiT-S
    supernet's eval forward without MIM (bf16 compute) and returns the
    (8, 1000) fp32 logits; the weights come from seed 0 and `x` is zeros
    (8, 224, 224, 3), all on `device` (the card unless "cpu" is asked
    for)."""
    from .device import resolve_device
    from .models.mim_vit import mim_forward
    dev = resolve_device(device)
    bundle = flagship(False, dev)
    params, alphas, arch = bundle.init(0)
    S = bundle.cfg.img_size
    x = torch.zeros((8, S, S, 3), dtype=torch.float32, device=dev)

    def fwd(params, alphas, arch, x):
        return mim_forward(params, alphas, arch, x, bundle.cfg, bundle.space,
                           train=False, use_mim=False).logits

    return fwd, (params, alphas, arch, x)


def mesh_shape(n: int):
    """(data, model): the JAX dry run's choice."""
    tp = 2 if n % 2 == 0 and n >= 4 else 1
    return n // tp, tp


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(tiny: bool, device, mesh_dims=None, batch: int = 0,
        steps: int = 0, planned: bool = False) -> None:
    """The dry run in this rank of an initialised process group, on a mesh
    of `mesh_dims` (the JAX choice by default), a global batch of `batch`
    images (one a data rank by default), then `steps` timed steps (of the
    planned step with `planned`)."""
    from .config import SearchConfig
    from .core.compress import compress
    from .core.optim import build_search_optimizer, named_leaves
    from .core.steps import TrainState, make_search_step
    from .device import resolve_device
    from .parallel.distributed import data_rank_world, rank_world
    from .parallel.mesh import local_rows, make_mesh, shard_params

    rank, n = rank_world()
    dev = resolve_device(device)
    dp, tp = mesh_dims or mesh_shape(n)
    batch = batch or dp
    mesh = make_mesh((dp, tp))
    bundle = flagship(tiny, dev)
    compute = torch.float32 if tiny else torch.bfloat16
    params, alphas, arch = bundle.init(0)
    scfg = SearchConfig(accum_iter=1,
                        target_flops=0.0002 if tiny else 2.3).resolve(1)
    tx, _ = build_search_optimizer(
        scfg.optim_param, scfg.optim_arch, scfg.optim_decoder, scfg.schedule,
        total_steps=100, steps_per_epoch=10)
    shard_params(params, mesh, bundle.cfg)
    state = TrainState(step=0, params=params, alphas=alphas, arch=arch,
                       opt_state=tx.init(named_leaves(params, alphas)))
    step = make_search_step(bundle.space, bundle.cfg, scfg, tx,
                            phase="search", compute_dtype=compute,
                            device=dev)

    # the global batch (one image a data rank by default); this rank takes
    # its rows
    sz, ncls = bundle.cfg.img_size, bundle.cfg.num_classes
    drank, _ = data_rank_world()
    imgs = torch.from_numpy(np.random.RandomState(0).rand(
        1, batch, sz, sz, 3).astype(np.float32))
    lbls = torch.from_numpy(np.random.RandomState(1).randint(0, ncls,
                                                             (1, batch)))
    x, y = (local_rows(t, drank, dp, dim=1).to(dev) for t in (imgs, lbls))
    say = print if rank == 0 else (lambda *a, **k: None)
    dtype = str(compute).replace("torch.", "")
    times = []

    def timed_step(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        _sync(dev)
        t0 = time.perf_counter()
        out = step(state, x, y, g, 0.8)
        total = float(out[1]["loss_total"])
        times.append((time.perf_counter() - t0) * 1e3)
        if not np.isfinite(total):
            raise AssertionError(f"rank {rank}: non-finite loss {total}")
        return total

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    total = timed_step(1)
    say(f"{bundle.name}: mesh=({dp}x{tp}) {dtype} step0 "
        f"loss_total={total:.4f}", flush=True)

    # the forced compress event: one MLP cell far below the kill
    # threshold; every rank takes rank 0's decisions (compress broadcasts)
    with torch.no_grad():
        alphas.blocks[0].mlp[..., 0] = -8.0
    _, _, arch, _, report = compress(state.params, alphas, state.arch,
                                     state.opt_state, bundle.space,
                                     scfg.compress_thresh)
    if not report.execute_prune:
        raise AssertionError("forced compress event did not fire")
    switch = np.concatenate([b.mlp.switch.detach().cpu().numpy().astype(
        np.uint8).reshape(-1) for b in arch.blocks]).tobytes()
    digest = hashlib.sha256(switch).hexdigest()[:12]
    say(f"compress digest: {'; '.join(report.events)} "
        f"| mlp-switch sha256[:12]={digest}", flush=True)

    total = timed_step(2)
    more = ""
    if steps and planned:
        t = _time_planned(bundle, scfg, tx, state, dev, batch, steps)
        more = (f", planned step over {steps} steps a turn: eager "
                f"{t['eager']}, CUDA graph {t['graph']}")
    elif steps:
        _sync(dev)
        t0 = time.perf_counter()
        for k in range(steps):
            step(state, x, y, torch.Generator(device=dev).manual_seed(3 + k),
                 0.8)
        _sync(dev)
        more = (f", {(time.perf_counter() - t0) * 1e3 / steps:.3f} over "
                f"{steps} more steps")
    peak = f"{torch.cuda.max_memory_allocated(dev) / 2 ** 20:.1f} MiB" \
        if dev.type == "cuda" else "not measured (CPU)"
    print(f"rank {rank}: mesh=({dp}x{tp}) batch {batch} ms a step "
          f"{[round(t, 2) for t in times]} (host time, the first with "
          f"warm-up){more}, peak device memory {peak}", flush=True)
    say(f"dryrun_multichip({n}): {bundle.name} mesh=({dp}x{tp}) "
        f"post-prune loss_total={total:.4f} OK", flush=True)


def _time_planned(bundle, scfg, tx, state, dev, batch: int, steps: int):
    """{"eager": [ms, ms], "graph": [ms, ms]} of the planned search step on
    the mesh, `steps` a turn, in turns (`bench.time_planned`)."""
    from .bench import PlannedCalls, time_planned
    from .core.steps import make_planned_search_step
    from .parallel.distributed import data_rank_world
    rows = 3 * steps + 8
    pstep, _ = make_planned_search_step(
        bundle.space, bundle.cfg, scfg, tx, phase="search",
        steps_per_epoch=rows, compute_dtype=torch.bfloat16, device=dev)
    calls = PlannedCalls(pstep, {"state": state}, batch, rows, search=True,
                         part=data_rank_world())
    times = time_planned(calls, steps)
    if pstep.captures != 1:
        raise AssertionError(f"{pstep.captures} CUDA graph captures")
    return {k: [round(t * 1e3, 3) for t in v] for k, v in times.items()}


def _drain(pipe, sink: List[str]) -> None:
    """Read a child's pipe to its end into `sink`, a line at a time."""
    for line in iter(pipe.readline, ""):
        sink.append(line)
    pipe.close()


def run_ranks(cmds: List[List[str]], envs: List[dict], cwd: str,
              timeout: float = TIMEOUT) -> int:
    """Run one process a rank (`cmds[r]` in `envs[r]`, each in a session of
    its own) and wait for all of them. A thread a pipe drains every rank's
    stdout and stderr at once, so no rank blocks on a full pipe while its
    peers wait on it in a collective. Once a rank exits non-zero, or
    `timeout` seconds have passed, the ranks still running are killed: they
    would wait on it in a collective. Then the ranks' stdout in rank
    order, their stderr with each line tagged `[rank R]` and, on a failure,
    every rank's exit code and each failed rank's code and stderr tail.
    Returns the exit code of the lowest rank that failed on its own (1 for
    a signal, 124 for the timeout), else 0."""
    import signal
    import threading
    outs: List[List[str]] = [[] for _ in cmds]
    errs: List[List[str]] = [[] for _ in cmds]
    procs, readers, killed = [], [], []
    try:
        for cmd, env, out, err in zip(cmds, envs, outs, errs):
            p = subprocess.Popen(cmd, env=env, cwd=cwd,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True,
                                 errors="replace", start_new_session=True)
            procs.append(p)
            for pipe, sink in ((p.stdout, out), (p.stderr, err)):
                readers.append(threading.Thread(target=_drain,
                                                args=(pipe, sink),
                                                daemon=True))
                readers[-1].start()
        deadline = time.time() + timeout
        while time.time() < deadline:
            codes = [p.poll() for p in procs]
            if None not in codes or any(c not in (None, 0) for c in codes):
                break
            time.sleep(0.05)
    finally:
        for r, p in enumerate(procs):
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                killed.append(r)
            p.wait()
        for t in readers:
            t.join()
    for out in outs:
        sys.stdout.write("".join(out))
    sys.stdout.flush()
    for r, err in enumerate(errs):
        sys.stderr.write("".join(f"[rank {r}] {line}" for line in err))
    failed = {r: p.returncode for r, p in enumerate(procs)
              if p.returncode != 0 and r not in killed}
    if not failed and not killed:
        return 0
    why = f"rank {min(failed)} failed" if failed \
        else f"still running after {timeout:g} s"
    print(f"dryrun: exit codes by rank {[p.returncode for p in procs]}"
          + (f" (ranks {killed} killed: {why})" if killed else ""),
          file=sys.stderr)
    for r, code in sorted(failed.items()):
        print(f"dryrun: rank {r} failed with exit code {code}; its stderr's "
              f"last lines:\n" + "".join(errs[r][-40:]), file=sys.stderr)
    if not failed:
        return 124
    code = failed[min(failed)]
    return code if code > 0 else 1


def _spawn(n: int, tiny: bool, device: str, extra: List[str]) -> int:
    """N ranks of this module over gloo through a file rendezvous
    (`run_ranks`); the exit code of the first rank that failed, else 0."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with tempfile.TemporaryDirectory(prefix="ofb_dryrun_") as tmp:
        env = {k: v for k, v in os.environ.items() if k not in (
            "MASTER_ADDR", "MASTER_PORT", "COORDINATOR_ADDRESS",
            "NUM_PROCESSES", "PROCESS_ID", "TORCHELASTIC_RUN_ID")}
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        env.setdefault("OMP_NUM_THREADS", "1")
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in [env.get("PYTHONPATH")] if p])
        cmd = [sys.executable, "-m", "ofb_tpu_torch.dryrun", "--devices",
               str(n), "--device", device, "--rdzv",
               os.path.join(tmp, "rdzv")] + (["--tiny"] if tiny else []) \
            + extra
        return run_ranks([cmd] * n, [dict(env, RANK=str(r),
                                          WORLD_SIZE=str(n), LOCAL_RANK="0")
                                     for r in range(n)], root)


def main(argv: Optional[List[str]] = None) -> int:
    from .parallel.distributed import _launch_env, init_distributed
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks; under a launcher its world (the default)")
    ap.add_argument("--tiny", action="store_true",
                    help="the 32-wide fp32 model instead of DeiT-S bf16")
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                    help="cuda (the default: NCCL under a launcher, the "
                         "one card shared over gloo by spawned ranks) or "
                         "cpu (gloo)")
    ap.add_argument("--mesh", type=int, nargs=2, default=None,
                    metavar=("DP", "TP"), help="the (data, model) mesh "
                    "(default: the JAX dry run's choice)")
    ap.add_argument("--batch", type=int, default=0,
                    help="global batch (default: one image a data rank)")
    ap.add_argument("--steps", type=int, default=0,
                    help="steps timed after the dry run's two")
    ap.add_argument("--planned", action="store_true",
                    help="time the planned step (DeiT-S on the card)")
    ap.add_argument("--rdzv", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.planned and (args.tiny or args.device == "cpu"
                         or not args.steps):
        ap.error("--planned times DeiT-S steps on the card: with --steps, "
                 "without --tiny and --device cpu")
    launch = _launch_env()
    if launch is None:
        if args.devices < 1:
            ap.error("--devices N is needed without a launcher")
        extra = (["--mesh", *map(str, args.mesh)] if args.mesh else []) + [
            f"--batch={args.batch}", f"--steps={args.steps}"] + (
            ["--planned"] if args.planned else [])
        if args.device == "cuda":
            from .device import resolve_device
            resolve_device("cuda")      # raises without a card
        return _spawn(args.devices, args.tiny, args.device, extra)

    import torch.distributed as dist
    device = args.device
    backend = "gloo" if args.rdzv or device == "cpu" else "nccl"
    rank, world = init_distributed(
        backend, device=device,
        init_method=f"file://{args.rdzv}" if args.rdzv else None,
        timeout=PEER_TIMEOUT if args.rdzv else None)
    if args.devices and args.devices != world:
        ap.error(f"--devices {args.devices} in a world of {world}")
    if args.mesh and args.mesh[0] * args.mesh[1] != world:
        ap.error(f"--mesh {args.mesh} in a world of {world}")
    try:
        run(args.tiny, device, args.mesh, args.batch, args.steps,
            args.planned)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
