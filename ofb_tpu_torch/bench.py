"""Benchmark: step throughput of the port's DeiT OFB lifecycle on one GPU.

`--phase search` (the default) times the full search step (gated supernet
forward with the PMIM decoder, the loss families, backward through the
CUDA attention kernels, the five-family AdamW) in images per second, with
bf16 compute (fp32 params cast at each use, as the JAX package does) on
random images from a seed. The other phases first force the search to
converge (`force_convergence`: crafted alphas, one `compress` pass, to a
subnet of mixed head geometry) and then time

  postsearch   the supernet's postsearch step (Mixup, soft-target CE, the
               decoder frozen);
  finetune     the dense train step on the exported subnet (layer-decay
               AdamW, Mixup / CutMix, EMA);
  eval         the dense eval step on the exported subnet.

With `--subnet DIR` the finetune and eval phases take the subnet of an
exported checkpoint (`cli.export`'s) instead, and skip the search. With
`--input-size S` they run the subnet on S x S images, its pos-embed resized
to the new patch grid as `cli.finetune --input-size S` resizes it (384: 577
tokens, the streaming attention body's).

With `--planned` the search, postsearch and finetune phases time the
planned step instead (`core.steps.make_planned_search_step` /
`make_planned_train_step`): each iteration gathers its batch from a device
cache of random uint8 staging images (256 -> 224), runs the fused augment
(RandAugment m9, erasing) and the step, all on the device. It is timed in
turns eagerly (the step's own function, one launch a kernel from the host)
and replayed as a CUDA graph (`PlannedStep`), so the two differ only in how
the work reaches the card; the line reports both.

`--phase augment` times `ops.augment.apply_train_augment` alone instead:
the train transform of a batch of SYNTHETIC staging images (256 -> 224,
RandAugment m9 two layers, erasing) with draws from a seed (no MFU).
`--phase feed` times the host side of the CLIs' feed alone, on SYNTHETIC
at staging 256 with the CLIs' default 4 DataLoader workers and no step: one image's
decode on this thread, the loader's first batch and its steady ms a batch
(unpinned, and pinned by the DataLoader's thread), and a batch's
`pin_memory()` on this thread.

`--model swin_tiny | swin_small | swin_base` runs the same phases on the
searchable Swin with per-stage widths (`embed_search`), bf16, 224 px:
the search step, beside the dense Swin's supervised step at the same
batch (its img/s, MFU and the search's overhead over it; --no-dense skips
it), the postsearch step, and the exported subnet's train (the search
CLI's export finetune: cosine AdamW) and eval steps; --planned as for
DeiT. With --profile N it also prints the window attention's share of
the traced steps' device kernel time: the kernels under its profiler
range (`models/swin.py:WINDOW_ATTENTION_RANGE`) and those of the backward
nodes its ops created, in the same trace. Swin's window attention is
plain PyTorch: no attention kernel of the port runs.

MFU counts 6 x the model's forward MACs per image for a training step
(backward ~ 2 x forward, 2 flops a MAC) and 2 x for eval, against the H100
SXM dense bf16 peak of 989 TFLOP/s; for the supernet the MACs are the
dense supernet's (the FLOPs model's total), for the subnet its own.

`--remat` recomputes each block of the DeiT supernet in the backward
(`ModelCfg.remat`, the JAX package's `bench.py --remat`). The line of a
step timed without --planned also reports the timed steps' peak device
memory (`torch.cuda.max_memory_allocated`).

Usage: python -m ofb_tpu_torch.bench [--model deit_small] [--batch 256]
       [--steps 20] [--phase search|postsearch|finetune|eval|augment]
       [--subnet DIR] [--input-size S] [--planned] [--remat] [--profile N]
Prints one JSON line; the phases that converge the search also report the
host time of the converging `compress` pass and of a pass that finds
nothing to prune. Needs a CUDA device. With --profile N it then traces N
more steps with torch.profiler and prints, on stderr, the device time by
kernel and the device's busy share of the traced wall time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from .models.swin import WINDOW_ATTENTION_RANGE

H100_BF16_PEAK = 989e12
# the port's profiler ranges: their device-side spans are not kernels
RANGES = (WINDOW_ATTENTION_RANGE,)


def card() -> str:
    """`nvidia-smi`'s name and power limit of the current card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", str(torch.cuda.current_device())],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def search_config(batch: int):
    """(SearchConfig, optimizer) of the benchmarked search: one microbatch
    of `batch` images an update, the default families and schedule."""
    from .config import SearchConfig
    from .core.optim import build_search_optimizer

    scfg = SearchConfig(accum_iter=1, target_flops=1.0)
    scfg.data.batch_size = batch
    scfg = scfg.resolve(1)
    tx, _ = build_search_optimizer(
        scfg.optim_param, scfg.optim_arch, scfg.optim_decoder, scfg.schedule,
        total_steps=100000, steps_per_epoch=1000)
    return scfg, tx


def build_step(model: str, batch: int, *, device="cuda", seed: int = 0,
               remat: bool = False):
    """(bundle, state, step, images, labels) for `model`'s search step at
    `batch` images (one microbatch), bf16 compute, random weights and
    images from `seed`; `remat` recomputes each block in the backward."""
    import dataclasses
    from .core.optim import named_leaves
    from .core.steps import TrainState, make_search_step
    from .models.registry import create_model

    bundle = create_model(f"{model}_patch16_224_mim", device=device,
                          patch_search=True)
    if remat:
        bundle.cfg = dataclasses.replace(bundle.cfg, remat=True)
    params, alphas, arch = bundle.init(seed)
    scfg, tx = search_config(batch)
    state = TrainState(step=0, params=params, alphas=alphas, arch=arch,
                       opt_state=tx.init(named_leaves(params, alphas)))
    step = make_search_step(bundle.space, bundle.cfg, scfg, tx,
                            compute_dtype=torch.bfloat16, device=device)
    images, labels = random_batch(bundle.cfg, batch, bundle.device, seed)
    return bundle, state, step, images, labels


def random_batch(cfg, batch: int, device, seed: int = 0):
    """(images (1, batch, S, S, 3) in [0, 1), labels (1, batch)) of a model
    config, from `seed`."""
    g = torch.Generator(device=device).manual_seed(seed + 1)
    S = cfg.img_size
    images = torch.rand((1, batch, S, S, 3), generator=g, device=device)
    labels = torch.randint(0, cfg.num_classes, (1, batch), generator=g,
                           device=device)
    return images, labels


def load_exported(path: str, device="cuda"):
    """(dense ViT, its ModelCfg) of a checkpoint that `cli.export` wrote."""
    from .core import checkpoint as ckpt
    from .models.vit import ModelCfg, ViT

    meta = ckpt.latest_meta(path)
    if meta is None or not meta.get("exported"):
        raise ValueError(f"{path} holds no exported checkpoint")
    cfg = ckpt.model_cfg_from_meta(meta["model_cfg"], ModelCfg)
    dense = ViT(cfg).to(device)
    ckpt.load_checkpoint(path, params=dense)
    return dense, cfg


# Cells the forced convergence picks, DeiT geometry (head grid 2 | 4 | 6,
# channel grid 16..64 in steps of 8, 7 MLP cells): (attention cell (heads,
# channels), MLP cell) per block, repeated over the depth. Head dims 64
# (full), 40, 32, 48, 24, 56 and 16: 24, 40 and 56 are 8 * odd, which the
# resident attention body runs zero-padded to the next multiple of 16.
FORCED_CELLS = (((2, 6), 6), ((1, 3), 4), ((2, 2), 3), ((1, 4), 5),
                ((0, 1), 2), ((2, 5), 4), ((2, 0), 3))
FORCED_EMBED_CELL = 12           # of 17: 336 of DeiT-S's 384 channels
FORCED_PATCH_CELL = 4            # all tokens


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def force_convergence(state, space):
    """Craft the alphas (+8 on one cell of every module, -8 elsewhere, in
    place; a Swin's stage widths at three quarters of their grid) so that
    one `compress` pass converges the whole search, and run
    that pass and then one more, which finds nothing to do. Returns
    (report, ms of the converging pass, ms of the idle pass), host time
    with the device drained before and after."""
    from .core.compress import compress

    def onehot(p, idx):
        with torch.no_grad():
            p.fill_(-8.0)
            p[idx] = 8.0

    alphas = state.alphas
    onehot(alphas.embed, min(FORCED_EMBED_CELL, space.embed.num_cells - 1))
    onehot(alphas.patch, min(FORCED_PATCH_CELL, space.patch.num_cells - 1))
    for i, (blk, bs) in enumerate(zip(alphas.blocks, space.blocks)):
        (h, c), m = FORCED_CELLS[i % len(FORCED_CELLS)]
        kh, kc = bs.attn.num_cells
        onehot(blk.attn, (min(h, kh - 1), min(c, kc - 1)))
        onehot(blk.mlp, min(m, bs.mlp.num_cells - 1))
    for e in getattr(alphas, "stage_embeds", ()):     # a Swin's widths
        onehot(e, 3 * e.numel() // 4)
    dev = alphas.embed.device
    times, report = [], None
    for _ in range(2):
        _sync(dev)
        t0 = time.perf_counter()
        out = compress(state.params, alphas, state.arch, state.opt_state,
                       space)
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        report = report or out[4]
    return report, times[0], times[1]


def build_postsearch_step(bundle, batch: int, *, device="cuda"):
    """The postsearch step of `build_step`'s search (the same config and
    optimizer), to run on its state once the search has converged."""
    from .core.steps import make_search_step
    scfg, tx = search_config(batch)
    return make_search_step(bundle.space, bundle.cfg, scfg, tx,
                            phase="postsearch", compute_dtype=torch.bfloat16,
                            device=device)


def build_subnet_steps(bundle, state, batch: int, *, device="cuda",
                       subnet=None, input_size=None, planned=False):
    """Export the converged supernet (or take `subnet`, a (dense params,
    dense cfg) pair) and build the finetune stage on the subnet: (dense
    params, dense cfg, meta (None for `subnet`), train state, train step,
    eval step), with `FinetuneConfig`'s defaults (layer decay 0.95, weight
    decay 0.05, Mixup 0.8 / CutMix 1.0, EMA) and a cosine schedule. With
    `input_size` the subnet takes images of that size, its pos-embed
    resized to the new patch grid. With `planned` the train step is the
    planned one (`make_planned_train_step`, fused augment) of the same
    optimizer and settings."""
    import dataclasses
    from .config import FinetuneConfig
    from .core.export import export_subnet
    from .core.lr_decay import build_finetune_optimizer
    from .core.optim import make_schedule
    from .core.steps import (TrainState, make_eval_step_dense,
                             make_planned_train_step, make_train_step)
    from .models.pos_embed import interpolate_pos_embed

    if subnet is None:
        dense, dcfg, meta = export_subnet(state.params, state.arch,
                                          bundle.space, bundle.cfg)
    else:
        (dense, dcfg), meta = subnet, None
    if input_size and input_size != dcfg.img_size:
        dcfg = dataclasses.replace(dcfg, img_size=input_size)
        dense.pos_embed = torch.nn.Parameter(interpolate_pos_embed(
            dense.pos_embed.detach(), dcfg.num_patches, dcfg.num_tokens))
    fcfg = FinetuneConfig()
    fcfg.data.batch_size = batch
    fcfg = fcfg.resolve(1)
    schedule = make_schedule(fcfg.lr, fcfg.schedule, 100000, 1000)
    tx = build_finetune_optimizer(
        dense, lr_schedule=schedule, betas=fcfg.betas, eps=fcfg.eps,
        weight_decay=fcfg.weight_decay, layer_decay=fcfg.layer_decay,
        num_layers=dcfg.depth, clip_grad=fcfg.clip_grad)
    leaves = dict(dense.named_parameters())
    fstate = TrainState(step=0, params=dense, alphas=None, arch=None,
                        opt_state=tx.init(leaves),
                        ema_params={n: p.detach().clone()
                                    for n, p in leaves.items()})
    common = dict(num_classes=dcfg.num_classes, mixup_cfg=fcfg.mixup,
                  smoothing=fcfg.mixup.label_smoothing,
                  ema_decay=fcfg.model_ema_decay,
                  compute_dtype=torch.bfloat16, device=device)
    train = make_planned_train_step(dcfg, tx, **common) if planned \
        else make_train_step(dcfg, tx, **common)
    evaluate = make_eval_step_dense(dcfg, compute_dtype=torch.bfloat16,
                                    device=device)
    return dense, dcfg, meta, fstate, train, evaluate


def profile_steps(call, n: int, top: int = 25):
    """Trace n calls of `call()` (one step each); print device time by
    kernel and the busy share; return the profile."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.key, e.device_time_total, e.count)
            for e in prof.key_averages() if e.device_time_total > 0
            and e.device_type == torch.autograd.DeviceType.CUDA
            and e.key not in RANGES]
    busy = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    print(f"profile: {n} steps, wall {wall_us / n / 1e3:.2f} ms/step, "
          f"device kernels {busy / n / 1e3:.2f} ms/step, busy share "
          f"{busy / wall_us:.3f} (kernel time summed; overlap counts twice)",
          file=sys.stderr)
    attn = sum(t for key, t, _ in rows if "attention_" in key)
    print(f"  attention kernels (ofb::...attention_*): {attn / n / 1e3:.3f} "
          f"ms/step, {100 * attn / busy:.1f}% of device kernel time",
          file=sys.stderr)
    for key, t, c in rows[:top]:
        print(f"  {t / n / 1e3:9.3f} ms/step {100 * t / busy:5.1f}%  "
              f"{c // n:5d}/step  {key[:110]}", file=sys.stderr)
    return prof


def kernel_us(prof) -> float:
    """Device time (us) of every kernel in a trace, the device-side spans
    of the profiler ranges left out."""
    return sum(e.device_time_total for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in RANGES)


def range_events(prof, name: str):
    """The events of a trace inside the profiler range `name` and the
    backward nodes that the range's ops created (matched by autograd
    sequence number and forward thread): (ranges, backward nodes)."""
    cpu = torch.autograd.DeviceType.CPU
    ranges = [e for e in prof.events()
              if e.name == name and e.device_type == cpu]
    made = set()
    for e in ranges:
        stack = list(e.cpu_children)
        while stack:
            c = stack.pop()
            if c.sequence_nr >= 0:
                made.add((c.thread, c.sequence_nr))
            stack.extend(c.cpu_children)
    nodes = [e for e in prof.events()
             if e.name.startswith("autograd::engine::evaluate_function")
             and (e.fwd_thread, e.sequence_nr) in made]
    return ranges, nodes


def range_us(prof, name: str):
    """Device time (us) in a trace of the kernels launched inside the
    profiler range `name` (its forward) and by the backward nodes its ops
    created: (forward, backward)."""
    ranges, nodes = range_events(prof, name)
    return (sum(e.device_time_total for e in ranges),
            sum(e.device_time_total for e in nodes))


def time_calls(call, steps: int, warmup: int = 3) -> float:
    """Seconds per call of `call()` (which returns a tensor to read back),
    after `warmup` calls, ended by reading the last result; the warm-up is
    drained on the result's device first."""
    for _ in range(warmup):              # first calls build kernels
        out = call()
    _sync(out.device)
    t0 = time.perf_counter()
    for _ in range(steps):
        out = call()
    value = out.item()
    dt = time.perf_counter() - t0
    if not torch.isfinite(torch.tensor(value)):
        raise RuntimeError(f"non-finite loss {value}")
    return dt / steps


class PlannedCalls:
    """Calls of a planned step over a device cache of random uint8 staging
    images: `graph()` through the `PlannedStep` (replayed as a CUDA graph
    after its warm-up), `eager()` through its own function; each returns
    the loss and keeps the step's output in `out`. `restart()` loads a
    fresh plan from the state's step counter, so a timing run never walks
    off the plan's end. `part` (rank, parts): this data rank's columns of
    a plan of `batch` images a step."""

    def __init__(self, pstep, box, batch: int, rows: int, *, search: bool,
                 staging: int = 256, images: int = 1024, seed: int = 0,
                 part=(0, 1)):
        import numpy as np
        g = torch.Generator(device="cuda").manual_seed(seed + 3)
        self.cache = torch.randint(0, 256, (images, staging, staging, 3),
                                   generator=g, device="cuda",
                                   dtype=torch.uint8)
        rng = np.random.default_rng(seed)
        self.labels = rng.integers(0, 1000, (images,))
        mb = batch // part[1]
        self.batches = rng.integers(0, images, (rows, batch))[
            :, part[0] * mb:(part[0] + 1) * mb]
        self.pstep, self.box, self.search = pstep, box, search
        self.gen = torch.Generator(device="cuda").manual_seed(seed + 4)
        self.restart()

    def restart(self):
        self.plan = self.pstep.load_plan(self.batches, self.labels, 0,
                                         self.box["state"].step)

    def _call(self, fn):
        idx, lab, base, epoch = self.plan
        args = (self.box["state"], self.cache, idx, lab, self.gen, base) \
            + ((epoch,) if self.search else ())
        self.box["state"], self.out = fn(*args)
        return self.out.reshape(-1)[1 if self.search else 0]

    def graph(self):
        return self._call(self.pstep)

    def eager(self):
        return self._call(self.pstep.fn)


def time_planned(calls: PlannedCalls, steps: int, rounds: int = 2):
    """Seconds a step, eager and graph-replayed in turns (eager, graph,
    graph, eager, ...): ({"eager": [...], "graph": [...]})."""
    out = {"eager": [], "graph": []}
    for r in range(rounds):
        for kind in (("eager", "graph") if r % 2 == 0 else
                     ("graph", "eager")):
            calls.restart()
            out[kind].append(time_calls(getattr(calls, kind), steps))
    return out


def augment_call(batch: int, staging: int = 256, out_size: int = 224):
    """A call of the train transform on `batch` SYNTHETIC staging images on
    the card, with draws from a seed; returns one output value."""
    from .data.datasets import SyntheticDataset
    from .ops.augment import apply_train_augment, draw_train_augment

    ds = SyntheticDataset(batch, 1000, staging)
    x = torch.stack([torch.from_numpy(ds[i][0]) for i in range(batch)]) \
        .cuda()
    g = torch.Generator(device="cuda").manual_seed(2)
    draws = draw_train_augment(g, batch, staging, out_size, device="cuda")
    return lambda: apply_train_augment(x, draws, out_size=out_size)[
        0, 0, 0, 0]


def feed_times(batch: int, workers: int, steps: int):
    """Host ms of the feed's parts at `batch` (see the module docstring)."""
    import numpy as np
    from .data.datasets import SyntheticDataset
    from .data.pipeline import HostLoader

    ds = SyntheticDataset(batch * (steps + 1), 1000, 256)
    t0 = time.perf_counter()
    for i in range(32):
        ds[i]
    out = {"decode_ms_per_image": (time.perf_counter() - t0) / 32 * 1e3}
    plan = np.arange(batch * (steps + 1)).reshape(steps + 1, batch)
    for pin in (False, True):
        it = HostLoader(ds, plan, num_workers=workers).batches(pin)
        t0 = time.perf_counter()
        x, _ = next(it)
        t1 = time.perf_counter()
        for _ in it:
            pass
        tag = "pinned" if pin else "unpinned"
        out[f"first_batch_ms_{tag}"] = (t1 - t0) * 1e3
        out[f"loader_ms_per_batch_{tag}"] = \
            (time.perf_counter() - t1) / steps * 1e3
    x = x.clone()
    for _ in range(2):                   # the host allocator's first blocks
        x.pin_memory()
    t0 = time.perf_counter()
    for _ in range(5):
        x.pin_memory()
    out["pin_ms_per_batch"] = (time.perf_counter() - t0) / 5 * 1e3
    return {k: round(v, 3) for k, v in out.items()}


# ---------------------------------------------------------------------------
# The Swin family (`--model swin_tiny | swin_small | swin_base`)
# ---------------------------------------------------------------------------

def build_swin_step(model: str, batch: int, *, device="cuda", seed: int = 0):
    """(bundle, state, step, images, labels) of `model`'s Swin search step
    with per-stage widths (`embed_search`) at `batch` images, bf16, random
    weights and images from `seed`."""
    from .core.optim import named_leaves
    from .core.steps import TrainState
    from .core.swin_steps import make_swin_search_step
    from .models.registry import create_model

    bundle = create_model(f"{model}_patch4_window7_224_mim", device=device,
                          embed_search=True)
    params, alphas, arch = bundle.init(seed)
    scfg, tx = search_config(batch)
    state = TrainState(step=0, params=params, alphas=alphas, arch=arch,
                       opt_state=tx.init(named_leaves(params, alphas)))
    step = make_swin_search_step(bundle.space, bundle.cfg, scfg, tx,
                                 compute_dtype=torch.bfloat16, device=device)
    images, labels = random_batch(bundle.cfg, batch, bundle.device, seed)
    return bundle, state, step, images, labels


def build_swin_subnet_steps(bundle, state, batch: int, *, device="cuda",
                            planned=False):
    """Export the converged Swin supernet and build the subnet's finetune
    stage (the search CLI's export finetune: cosine AdamW, weight decay
    0.05): (dense, cfg, meta, train state, train step, eval step); with
    `planned` the train step is the planned one."""
    from .config import ScheduleConfig
    from .core.optim import adamw, cosine_schedule
    from .core.steps import TrainState
    from .core.swin_steps import (make_planned_swin_train_step,
                                  make_swin_eval_step_dense,
                                  make_swin_train_step_dense)
    from .models.swin_search import export_swin_subnet

    dense, dcfg, meta = export_swin_subnet(state.params, state.arch,
                                           bundle.space, bundle.cfg)
    tx = adamw(cosine_schedule(2.5e-4 * batch / 256, ScheduleConfig(
        warmup_lr=1e-6, min_lr=1e-6, warmup_epochs=5), 100000, 1000),
        weight_decay=0.05)
    fstate = TrainState(step=0, params=dense, alphas=None, arch=None,
                        opt_state=tx.init(dict(dense.named_parameters())))
    make = make_planned_swin_train_step if planned \
        else make_swin_train_step_dense
    train = make(dcfg, tx, compute_dtype=torch.bfloat16, device=device)
    evaluate = make_swin_eval_step_dense(dcfg, compute_dtype=torch.bfloat16,
                                         device=device)
    return dense, dcfg, meta, fstate, train, evaluate


def bench_swin(args):
    """The Swin family's phases (see `main`): one JSON line, and with
    --profile N the step's kernel breakdown and the window attention's
    share of the step's kernel time on stderr."""
    from .core.swin_steps import (make_planned_swin_search_step,
                                  make_swin_search_step,
                                  make_swin_train_step_dense)
    from .models.swin import Swin, swin_dense_flops
    from .models.swin_search import swin_model_flops

    batch = args.batch
    gen = torch.Generator(device="cuda").manual_seed(2)
    bundle, state, step, images, labels = build_swin_step(args.model, batch)
    cfg = bundle.cfg
    box = {"state": state}
    extra = {}
    passes = 6.0
    with torch.no_grad():
        gflops = float(swin_model_flops(state.alphas, state.arch,
                                        bundle.space, cfg)[0])

    def call():
        box["state"], m = step(box["state"], images, labels, gen)
        return m["loss_total"]

    scfg, tx = search_config(batch)
    if args.phase != "search":
        call()
        report, ms, idle_ms = force_convergence(state, bundle.space)
        if not report.finish_search:
            raise RuntimeError(f"the search did not converge: {report.events}")
        extra = {"compress_ms": round(ms, 3),
                 "compress_idle_ms": round(idle_ms, 3),
                 "compress_events": len(report.events)}
    if args.phase == "postsearch":
        post = make_swin_search_step(bundle.space, cfg, scfg, tx,
                                     phase="postsearch",
                                     compute_dtype=torch.bfloat16,
                                     device="cuda")

        def call():
            box["state"], m = post(box["state"], images, labels, gen)
            return m["loss_total"]
    elif args.phase in ("finetune", "eval"):
        with torch.no_grad():
            gflops = float(swin_model_flops(state.alphas, state.arch,
                                            bundle.space, cfg)[1])
        dense, dcfg, meta, fstate, train, evaluate = build_swin_subnet_steps(
            bundle, state, batch, planned=args.planned)
        box["state"] = fstate
        extra.update(stage_dims=meta["stage_dims"],
                     mlp_hidden=[b["mlp_hidden"] for b in meta["blocks"]])
        if args.phase == "finetune":
            def call():
                box["state"], m = train(box["state"], images, labels, gen)
                return m["loss"]
        else:
            passes = 2.0

            def call():
                return evaluate(dense, images[0], labels[0])["loss_sum"]

    if args.planned:
        rows = 3 * args.steps + 8
        if args.phase == "finetune":
            pstep = train
        else:
            pstep, _ = make_planned_swin_search_step(
                bundle.space, cfg, scfg, tx, phase=args.phase,
                steps_per_epoch=rows, device="cuda")
        calls = PlannedCalls(pstep, box, batch, rows,
                             search=args.phase != "finetune")
        times = time_planned(calls, args.steps)
        dt = min(times["graph"])
        extra.update(
            planned=True, captures=pstep.captures,
            ms_per_step_eager=[round(t * 1e3, 3) for t in times["eager"]],
            ms_per_step_graph=[round(t * 1e3, 3) for t in times["graph"]],
            img_s_eager=[round(batch / t, 2) for t in times["eager"]])
        call = calls.graph
    else:
        dt = time_calls(call, args.steps)
    img_s = batch / dt
    if args.phase == "search" and not args.planned and not args.no_dense:
        # the dense Swin's supervised step at the same batch: what the
        # search machinery costs on top of it
        from .core.optim import adamw
        from .core.steps import TrainState
        dense = Swin(cfg, generator=torch.Generator().manual_seed(2)).cuda()
        dtx = adamw(lambda count: torch.full_like(
            torch.as_tensor(count, dtype=torch.float32), 1e-4),
            weight_decay=1e-4)
        dbox = {"state": TrainState(step=0, params=dense, alphas=None,
                                    arch=None, opt_state=dtx.init(
                                        dict(dense.named_parameters())))}
        dstep = make_swin_train_step_dense(cfg, dtx,
                                           compute_dtype=torch.bfloat16,
                                           device="cuda")

        def dense_call():
            dbox["state"], m = dstep(dbox["state"], images, labels, gen)
            return m["loss"]
        dense_img_s = batch / time_calls(dense_call, args.steps)
        extra.update(dense_img_s=round(dense_img_s, 2),
                     dense_mfu=round(dense_img_s * 6.0 * swin_dense_flops(
                         cfg) * 1e9 / H100_BF16_PEAK, 4),
                     search_overhead_vs_dense=round(dense_img_s / img_s - 1.0,
                                                    4))
        del dense, dbox
    kind = {"search": "ofb_search_step", "postsearch": "ofb_postsearch_step",
            "finetune": "subnet_train_step", "eval": "subnet_eval_step"}
    print(json.dumps({
        "metric": f"{args.model}_{kind[args.phase]}_throughput",
        "value": round(img_s, 2), "unit": "img/s", "batch": batch,
        "ms_per_step": round(dt * 1e3, 3),
        "mfu": round(img_s * passes * gflops * 1e9 / H100_BF16_PEAK, 4),
        "gflops_per_image": round(gflops, 4),
        "peak_tflops": H100_BF16_PEAK / 1e12, **extra,
        "device": card(), "count": torch.cuda.device_count()}), flush=True)
    if args.profile:
        n = args.profile
        prof = profile_steps(call, n)
        busy = kernel_us(prof)
        fwd, bwd = range_us(prof, WINDOW_ATTENTION_RANGE)
        if fwd == 0.0:
            print("  window attention: its range is not in the trace (a "
                  "graph replay runs no ops)", file=sys.stderr)
        else:
            print(f"  window attention in the traced steps (range "
                  f"{WINDOW_ATTENTION_RANGE}: forward {fwd / n / 1e3:.3f}, "
                  f"its backward nodes {bwd / n / 1e3:.3f} ms a step): "
                  f"{(fwd + bwd) / n / 1e3:.3f} of {busy / n / 1e3:.3f} ms "
                  f"device kernel time a step, "
                  f"{100 * (fwd + bwd) / busy:.1f}%", file=sys.stderr)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="deit_small",
                    choices=["deit_tiny", "deit_small", "deit_base",
                             "swin_tiny", "swin_small", "swin_base"])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--phase", default="search",
                    choices=["search", "postsearch", "finetune", "eval",
                             "augment", "feed"])
    ap.add_argument("--subnet", default="",
                    help="finetune / eval: an exported checkpoint's subnet "
                         "instead of the forced one")
    ap.add_argument("--input-size", type=int, default=224,
                    help="finetune / eval: the image size; the subnet's "
                         "pos-embed is resized to its patch grid")
    ap.add_argument("--planned", action="store_true",
                    help="search / postsearch / finetune: time the planned "
                         "step over a device cache, eager and as a CUDA "
                         "graph in turns")
    ap.add_argument("--profile", type=int, default=0,
                    help="trace this many more steps and print a breakdown")
    ap.add_argument("--no-dense", action="store_true",
                    help="Swin search: skip the dense companion step")
    ap.add_argument("--remat", action="store_true",
                    help="DeiT search / postsearch: recompute each block in "
                         "the backward (memory for FLOPs)")
    args = ap.parse_args()
    if args.remat and (args.model.startswith("swin")
                       or args.phase not in ("search", "postsearch")):
        ap.error("--remat is for the DeiT search and postsearch phases")
    if args.planned and args.phase not in ("search", "postsearch",
                                           "finetune"):
        ap.error("--planned is for the search, postsearch and finetune "
                 "phases")

    if args.phase == "feed":
        print(json.dumps({"metric": "host_feed_ms", "batch": args.batch,
                          "workers": 4, **feed_times(args.batch, 4, args.steps),
                          "device": card()}), flush=True)
        return
    if args.phase == "augment":
        call = augment_call(args.batch)
        dt = time_calls(call, args.steps)
        print(json.dumps({
            "metric": "train_augment_throughput",
            "value": round(args.batch / dt, 2), "unit": "img/s",
            "batch": args.batch, "ms_per_step": round(dt * 1e3, 3),
            "device": card(), "count": torch.cuda.device_count()}),
            flush=True)
        if args.profile:
            profile_steps(call, args.profile)
        return

    if args.model.startswith("swin"):
        if args.subnet or args.input_size != 224:
            ap.error("--subnet and --input-size are for the DeiT models")
        return bench_swin(args)

    from .models.vit import dense_flops
    from .ops.flops import model_flops

    if (args.subnet or args.input_size != 224) \
            and args.phase not in ("finetune", "eval"):
        ap.error("--subnet and --input-size are for the finetune and eval "
                 "phases")
    gen = torch.Generator(device="cuda").manual_seed(2)
    extra = {}
    passes = 6.0
    if args.subnet:
        subnet = load_exported(args.subnet)
        bundle = state = None
        images, labels = random_batch(subnet[1], args.batch, "cuda")
        extra["subnet"] = args.subnet
    else:
        subnet = None
        bundle, state, step, images, labels = build_step(
            args.model, args.batch, remat=args.remat)
        extra["remat"] = args.remat
        with torch.no_grad():
            gmacs, _ = model_flops(state.alphas, state.arch, bundle.space,
                                   bundle.cfg)
    box = {"state": state}

    def search_call():
        box["state"], m = step(box["state"], images, labels, gen, 0.75)
        return m["loss_total"]

    call = search_call
    if args.phase != "search" and not args.subnet:
        search_call()                    # moments to zero at the prune
        report, ms, idle_ms = force_convergence(state, bundle.space)
        if not report.finish_search:
            raise RuntimeError(f"the search did not converge: {report.events}")
        extra.update(compress_ms=round(ms, 3),
                     compress_idle_ms=round(idle_ms, 3),
                     compress_events=len(report.events))
    if args.phase == "postsearch":
        post = build_postsearch_step(bundle, args.batch)

        def call():
            box["state"], m = post(box["state"], images, labels, gen, 0.75)
            return m["loss_total"]
    elif args.phase in ("finetune", "eval"):
        dense, dcfg, meta, fstate, train, evaluate = build_subnet_steps(
            bundle, state, args.batch, subnet=subnet,
            input_size=args.input_size, planned=args.planned)
        box["state"] = fstate
        if images.shape[2] != dcfg.img_size:
            images, labels = random_batch(dcfg, args.batch, "cuda")
        gmacs = dense_flops(dcfg)
        extra.update(embed_dim=dcfg.embed_dim, input_size=dcfg.img_size,
                     tokens=dcfg.num_patches + dcfg.num_tokens,
                     block_dims=[list(b) for b in dcfg.block_overrides])
        if args.phase == "finetune":
            def call():
                box["state"], m = train(box["state"], images, labels, gen)
                return m["loss"]
        else:
            passes = 2.0

            def call():
                return evaluate(dense, images[0], labels[0])["loss_sum"]

    if args.planned:
        from .core.steps import make_planned_search_step
        rows = 3 * args.steps + 8
        if args.phase == "finetune":
            pstep = train
        else:
            scfg, tx = search_config(args.batch)
            pstep, _ = make_planned_search_step(
                bundle.space, bundle.cfg, scfg, tx, phase=args.phase,
                steps_per_epoch=rows, device="cuda")
        calls = PlannedCalls(pstep, box, args.batch, rows,
                             search=args.phase != "finetune")
        times = time_planned(calls, args.steps)
        dt = min(times["graph"])
        extra.update(
            planned=True,
            ms_per_step_eager=[round(t * 1e3, 3) for t in times["eager"]],
            ms_per_step_graph=[round(t * 1e3, 3) for t in times["graph"]],
            img_s_eager=[round(args.batch / t, 2) for t in times["eager"]],
            captures=pstep.captures,
            launches_per_replay={f"{w}/{b}": n for (w, b), n in
                                 pstep.launches_per_replay.items() if n})
        call = calls.graph
    else:
        torch.cuda.reset_peak_memory_stats()
        dt = time_calls(call, args.steps)
        extra["peak_mem_gib"] = round(
            torch.cuda.max_memory_allocated() / 2 ** 30, 3)
    img_s = args.batch / dt
    mfu = img_s * passes * float(gmacs) * 1e9 / H100_BF16_PEAK
    name = {"deit_small": "deit_s", "deit_base": "deit_b",
            "deit_tiny": "deit_t"}[args.model]
    kind = {"search": "ofb_search_step", "postsearch": "ofb_postsearch_step",
            "finetune": "subnet_train_step", "eval": "subnet_eval_step"}
    print(json.dumps({
        "metric": f"{name}_{kind[args.phase]}_throughput",
        "value": round(img_s, 2),
        "unit": "img/s",
        "batch": args.batch,
        "ms_per_step": round(dt * 1e3, 3),
        "mfu": round(mfu, 4),
        "peak_tflops": H100_BF16_PEAK / 1e12,
        **extra,
        "device": card(),
        "count": torch.cuda.device_count(),
    }), flush=True)
    if args.profile:
        profile_steps(call, args.profile)


if __name__ == "__main__":
    main()
