"""Benchmark: DeiT OFB search-step throughput of the port on one GPU.

Times the full search step (gated supernet forward with the PMIM decoder,
the loss families, backward through the CUDA attention kernels, the
five-family AdamW) in images per second, with bf16 compute (fp32 params
cast at each use, as the JAX package does) on random images from a seed.
MFU counts 6 x the dense supernet's forward MACs per image (the FLOPs
model's total; backward ~ 2 x forward, 2 flops a MAC) against the H100 SXM
dense bf16 peak of 989 TFLOP/s.

Usage: python -m ofb_tpu_torch.bench [--model deit_small] [--batch 256]
       [--steps 20] [--profile N]
Prints one JSON line. Needs a CUDA device. With --profile N it then traces
N more steps with torch.profiler and prints, on stderr, the device time by
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


def build_step(model: str, batch: int, *, device="cuda", seed: int = 0):
    """(bundle, state, step, images, labels) for `model`'s search step at
    `batch` images (one microbatch), bf16 compute, random weights and
    images from `seed`."""
    from .config import SearchConfig
    from .core.optim import build_search_optimizer, named_leaves
    from .core.steps import TrainState, make_search_step
    from .models.registry import create_model

    bundle = create_model(f"{model}_patch16_224_mim", device=device,
                          patch_search=True)
    params, alphas, arch = bundle.init(seed)
    scfg = SearchConfig(accum_iter=1, target_flops=1.0)
    scfg.data.batch_size = batch
    scfg = scfg.resolve(1)
    tx, _ = build_search_optimizer(
        scfg.optim_param, scfg.optim_arch, scfg.optim_decoder, scfg.schedule,
        total_steps=100000, steps_per_epoch=1000)
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


def profile_steps(step, state, images, labels, gen, n: int, top: int = 25):
    """Trace n steps; print device time by kernel and the busy share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = step(state, images, labels, gen, 0.75)
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
    for key, t, c in rows[:top]:
        print(f"  {t / n / 1e3:9.3f} ms/step {100 * t / busy:5.1f}%  "
              f"{c // n:5d}/step  {key[:110]}", file=sys.stderr)
    return state


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="deit_small",
                    choices=["deit_tiny", "deit_small", "deit_base"])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--profile", type=int, default=0,
                    help="trace this many more steps and print a breakdown")
    args = ap.parse_args()

    from .ops.flops import model_flops

    bundle, state, step, images, labels = build_step(args.model, args.batch)
    gen = torch.Generator(device=bundle.device).manual_seed(2)
    for _ in range(3):                   # warm up: first calls build kernels
        state, metrics = step(state, images, labels, gen, 0.75)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, metrics = step(state, images, labels, gen, 0.75)
    loss = metrics["loss_total"].item()
    dt = time.perf_counter() - t0
    if not torch.isfinite(torch.tensor(loss)):
        raise RuntimeError(f"non-finite loss {loss}")

    img_s = args.batch * args.steps / dt
    with torch.no_grad():
        total_gmacs, _ = model_flops(state.alphas, state.arch, bundle.space,
                                     bundle.cfg)
    mfu = img_s * 6.0 * float(total_gmacs) * 1e9 / H100_BF16_PEAK
    name = {"deit_small": "deit_s", "deit_base": "deit_b",
            "deit_tiny": "deit_t"}[args.model]
    print(json.dumps({
        "metric": f"{name}_ofb_search_step_throughput",
        "value": round(img_s, 2),
        "unit": "img/s",
        "batch": args.batch,
        "mfu": round(mfu, 4),
        "peak_tflops": H100_BF16_PEAK / 1e12,
        "device": card(),
        "count": torch.cuda.device_count(),
    }), flush=True)
    if args.profile:
        profile_steps(step, state, images, labels, gen, args.profile)


if __name__ == "__main__":
    main()
