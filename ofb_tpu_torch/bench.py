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

MFU counts 6 x the model's forward MACs per image for a training step
(backward ~ 2 x forward, 2 flops a MAC) and 2 x for eval, against the H100
SXM dense bf16 peak of 989 TFLOP/s; for the supernet the MACs are the
dense supernet's (the FLOPs model's total), for the subnet its own.

Usage: python -m ofb_tpu_torch.bench [--model deit_small] [--batch 256]
       [--steps 20] [--phase search|postsearch|finetune|eval] [--profile N]
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

H100_BF16_PEAK = 989e12


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


def build_step(model: str, batch: int, *, device="cuda", seed: int = 0):
    """(bundle, state, step, images, labels) for `model`'s search step at
    `batch` images (one microbatch), bf16 compute, random weights and
    images from `seed`."""
    from .core.optim import named_leaves
    from .core.steps import TrainState, make_search_step
    from .models.registry import create_model

    bundle = create_model(f"{model}_patch16_224_mim", device=device,
                          patch_search=True)
    params, alphas, arch = bundle.init(seed)
    scfg, tx = search_config(batch)
    state = TrainState(step=0, params=params, alphas=alphas, arch=arch,
                       opt_state=tx.init(named_leaves(params, alphas)))
    step = make_search_step(bundle.space, bundle.cfg, scfg, tx,
                            compute_dtype=torch.bfloat16, device=device)
    g = torch.Generator(device=bundle.device).manual_seed(seed + 1)
    S = bundle.cfg.img_size
    images = torch.rand((1, batch, S, S, 3), generator=g,
                        device=bundle.device)
    labels = torch.randint(0, bundle.cfg.num_classes, (1, batch),
                           generator=g, device=bundle.device)
    return bundle, state, step, images, labels


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
    place) so that one `compress` pass converges the whole search, and run
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


def build_subnet_steps(bundle, state, batch: int, *, device="cuda"):
    """Export the converged supernet and build the finetune stage on the
    subnet: (dense params, dense cfg, meta, train state, train step, eval
    step), with `FinetuneConfig`'s defaults (layer decay 0.95, weight decay
    0.05, Mixup 0.8 / CutMix 1.0, EMA) and a cosine schedule."""
    from .config import FinetuneConfig
    from .core.export import export_subnet
    from .core.lr_decay import build_finetune_optimizer
    from .core.optim import make_schedule
    from .core.steps import (TrainState, make_eval_step_dense,
                             make_train_step)

    dense, dcfg, meta = export_subnet(state.params, state.arch, bundle.space,
                                      bundle.cfg)
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
    train = make_train_step(dcfg, tx, num_classes=dcfg.num_classes,
                            mixup_cfg=fcfg.mixup,
                            smoothing=fcfg.mixup.label_smoothing,
                            ema_decay=fcfg.model_ema_decay,
                            compute_dtype=torch.bfloat16, device=device)
    evaluate = make_eval_step_dense(dcfg, compute_dtype=torch.bfloat16,
                                    device=device)
    return dense, dcfg, meta, fstate, train, evaluate


def profile_steps(call, n: int, top: int = 25):
    """Trace n calls of `call()` (one step each); print device time by
    kernel and the busy share."""
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
            and e.device_type == torch.autograd.DeviceType.CUDA]
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


def time_calls(call, steps: int, warmup: int = 3) -> float:
    """Seconds per call of `call()` (which returns a tensor to read back),
    after `warmup` calls, ended by reading the last result."""
    for _ in range(warmup):              # first calls build kernels
        out = call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        out = call()
    value = out.item()
    dt = time.perf_counter() - t0
    if not torch.isfinite(torch.tensor(value)):
        raise RuntimeError(f"non-finite loss {value}")
    return dt / steps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="deit_small",
                    choices=["deit_tiny", "deit_small", "deit_base"])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--phase", default="search",
                    choices=["search", "postsearch", "finetune", "eval"])
    ap.add_argument("--profile", type=int, default=0,
                    help="trace this many more steps and print a breakdown")
    args = ap.parse_args()

    from .models.vit import dense_flops
    from .ops.flops import model_flops

    bundle, state, step, images, labels = build_step(args.model, args.batch)
    gen = torch.Generator(device=bundle.device).manual_seed(2)
    box = {"state": state}
    extra = {}
    with torch.no_grad():
        gmacs, _ = model_flops(state.alphas, state.arch, bundle.space,
                               bundle.cfg)
    passes = 6.0

    def search_call():
        box["state"], m = step(box["state"], images, labels, gen, 0.75)
        return m["loss_total"]

    call = search_call
    if args.phase != "search":
        search_call()                    # moments to zero at the prune
        report, ms, idle_ms = force_convergence(state, bundle.space)
        if not report.finish_search:
            raise RuntimeError(f"the search did not converge: {report.events}")
        extra = {"compress_ms": round(ms, 3),
                 "compress_idle_ms": round(idle_ms, 3),
                 "compress_events": len(report.events)}
    if args.phase == "postsearch":
        post = build_postsearch_step(bundle, args.batch)

        def call():
            box["state"], m = post(box["state"], images, labels, gen, 0.75)
            return m["loss_total"]
    elif args.phase in ("finetune", "eval"):
        dense, dcfg, meta, fstate, train, evaluate = build_subnet_steps(
            bundle, state, args.batch)
        box["state"] = fstate
        gmacs = dense_flops(dcfg)
        extra.update(embed_dim=dcfg.embed_dim,
                     block_dims=[list(b) for b in dcfg.block_overrides])
        if args.phase == "finetune":
            def call():
                box["state"], m = train(box["state"], images, labels, gen)
                return m["loss"]
        else:
            passes = 2.0

            def call():
                return evaluate(dense, images[0], labels[0])["loss_sum"]

    dt = time_calls(call, args.steps)
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
