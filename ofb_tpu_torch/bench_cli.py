"""Benchmark: sustained epoch throughput of the port's CLIs on one GPU,
beside the step throughput of `ofb_tpu_torch.bench` at the same batch.

Runs, in this process, on SYNTHETIC data (staging 256 -> 224, host decode
by --workers DataLoader workers):

  search     `cli.search` on DeiT-S, bf16, fused RandAugment m9 + erasing,
             compress threshold 1.0 (so the search converges within the
             run), --epochs epochs, on --images images;
  export     `cli.export` of the search's best checkpoint;
  finetune   3 `cli.finetune` epochs of that exported subnet (EMA,
             Mixup / CutMix, the transform in the feed) from the host
             loader, and as many with --cache-device; SYNTHETIC's default
             2048 images an epoch, since the finetune CLI has no size flag;
  step       `python -m ofb_tpu_torch.bench --phase search` (the supernet)
             and `--phase finetune --subnet <export>` (the same subnet the
             finetune ran) at the same batch, on random float images.

With --cache-device the search gathers its batches from the device cache
(the transform still fused in the step); with --planned-epoch the search and
the cached finetune run the planned loop (the epoch's plan on the device,
each step one CUDA graph replay), there is no host-loader finetune, and the
step rates are `bench --planned`'s (eager and graph-replayed). Run it with
--cache-device and with --planned-epoch to compare the two loops on the
same feed.

Prints one JSON line: each CLI epoch's img/s (the engine's `img_s`: images
over wall time, the feed, compress passes and readbacks included) and its
split into feed / dispatch / readback / compress seconds, the compress
passes' host ms, the step rates, and the card's name and power limit.

With --model swin_tiny it runs the Swin family's CLIs instead, on Swin-T
with per-stage widths (`embed_search`), bf16, on --images images:

  search     `cli.search_swin`, --epochs search epochs (compress passes
             at the CLI's 0.2), then --force-finish, the export and
             --epochs epochs of the export finetune (cosine AdamW);
  dense      `cli.train_swin_dense`, --epochs epochs of the dense Swin-T;
  step       `bench --model swin_tiny --phase search` (with the dense
             companion step when classic) and `--phase finetune` (the
             subnet that bench's forced convergence carves out; the
             export of a real search depends on its scores).

Under `torchrun` the CLIs run data parallel (--batch per process) and
rank 0 prints the line: each epoch's img/s is its rank's, `global_img_s`
that times the world (the ranks step together); `bench.py`'s step rates
are one process's on rank 0's card.

Usage: python -m ofb_tpu_torch.bench_cli [--model deit_small | swin_tiny]
       [--batch 64] [--epochs 2] [--images 2048] [--workers 4]
       [--cache-device | --planned-epoch] [--out DIR]
  torchrun --nproc_per_node N -m ofb_tpu_torch.bench_cli ...
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile


def step_rate(phase, batch, *extra):
    out = subprocess.run(
        [sys.executable, "-m", "ofb_tpu_torch.bench", "--batch", str(batch),
         "--phase", phase, "--steps", "10", *extra], capture_output=True,
        text=True, check=True, timeout=900)
    return json.loads(out.stdout.strip().splitlines()[-1])


def _compress_ms(text):
    return [round(float(x) * 1e3, 3)
            for x in re.findall(r"compress pass ([\d.]+)s", text)]


def _step_rates(result, batch, planned, model, phases):
    """bench.py's step rates of `phases` ((name, extra args)) into
    `result`, on rank 0 only."""
    import torch

    from .parallel.distributed import rank_world
    if rank_world()[0] != 0:
        return
    torch.cuda.empty_cache()
    for phase, extra in phases:
        r = step_rate(phase, batch, "--model", model, *extra,
                      *(("--planned",) if planned else ()))
        result[f"{phase}_step_img_s"] = r["value"]
        result[f"{phase}_step_ms"] = r["ms_per_step"]
        if planned:
            result[f"{phase}_step_ms_eager"] = r["ms_per_step_eager"]
        elif "dense_img_s" in r:
            result["dense_step_img_s"] = r["dense_img_s"]


def swin(args, root, cached, planned):
    """The Swin CLIs (see the module's docstring): their epochs and the
    step rates, as one dict."""
    from .cli import search_swin, train_swin_dense
    from .cli.common import run_main
    from .core.engine import epoch_lines

    data = ["--data-set", "SYNTHETIC", "--synthetic-size", str(args.images),
            "--batch-size", str(args.batch), "--num_workers",
            str(args.workers)]
    e = str(args.epochs)
    _, text = run_main(search_swin, data + [
        "--epochs", e, "--embed_search", "--force-finish",
        "--export-finetune-epochs", e, "--output_dir",
        os.path.join(root, "swin_search")] + cached + planned)
    lines = epoch_lines(text)
    result = {"search_epochs": lines[:args.epochs],
              "finetune_epochs": lines[args.epochs:],
              "graph_lines": re.findall(r"planned step: .*", text),
              "compress_ms": _compress_ms(text)}
    _, text = run_main(train_swin_dense, data + [
        "--model", "swin_tiny_patch4_window7_224", "--epochs", e,
        "--eval-every", "1", "--output_dir",
        os.path.join(root, "swin_dense")] + cached + planned)
    result["dense_epochs"] = epoch_lines(text)
    result["dense_graph_lines"] = re.findall(r"planned step: .*", text)
    _step_rates(result, args.batch, bool(planned), "swin_tiny",
                (("search", ()), ("finetune", ())))
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="deit_small",
                    choices=["deit_small", "swin_tiny"])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--images", type=int, default=2048)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--cache-device", action="store_true")
    ap.add_argument("--planned-epoch", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    planned = ["--planned-epoch"] if args.planned_epoch else []
    cached = ["--cache-device"] if args.cache_device or planned else []

    import torch
    from .bench import card
    from .parallel.distributed import init_distributed

    if not torch.cuda.is_available():
        raise SystemExit("bench_cli needs a CUDA device")
    rank, world = init_distributed()
    if world > 1 and not args.out:
        raise SystemExit("under torchrun pass --out: the directory rank 0 "
                         "writes and every rank reads")
    root = args.out or tempfile.mkdtemp(prefix="ofb_bench_cli_")
    result = {"model": args.model, "batch": args.batch,
              "images": args.images, "workers": args.workers,
              "cache_device": bool(cached), "planned_epoch": bool(planned),
              "world": world}
    run = swin if args.model == "swin_tiny" else deit
    result.update(run(args, root, cached, planned))
    if rank != 0:
        return
    for lines in result.values():
        if isinstance(lines, list):
            for ep in lines:
                if isinstance(ep, dict) and "img_s" in ep:
                    ep["global_img_s"] = ep["img_s"] * world
    result["device"] = card()
    print(json.dumps(result), flush=True)


def deit(args, root, cached, planned):
    """The DeiT-S CLIs (see the module's docstring): their epochs and the
    step rates, as one dict."""
    from .cli import export, finetune, search
    from .cli.common import run_main
    from .core.engine import epoch_lines

    sdir = os.path.join(root, "search")
    xdir = os.path.join(root, "exported")
    b = str(args.batch)
    _, text = run_main(search, [
        "--data-set", "SYNTHETIC", "--synthetic-size", str(args.images),
        "--batch-size", b, "--accum-iter", "1", "--epochs",
        str(args.epochs), "--compress-thresh", "1.0", "--mixup", "0.8",
        "--cutmix", "1.0", "--num_workers", str(args.workers),
        "--output_dir", sdir] + cached + planned)
    result = {"search_epochs": epoch_lines(text),
              "graph_lines": re.findall(r"planned step: .*", text),
              "compress_ms": _compress_ms(text)}
    (_, dcfg), _ = run_main(export, ["--checkpoint",
                                     os.path.join(sdir, "best"), "--out",
                                     xdir])
    result["subnet"] = {"embed_dim": dcfg.embed_dim,
                        "blocks": [list(x) for x in dcfg.block_overrides]}
    runs = (("finetune_planned_epochs", ["--cache-device"] + planned),) \
        if planned else (("finetune_epochs", []),
                         ("finetune_cached_epochs", ["--cache-device"]))
    for name, extra in runs:
        _, text = run_main(finetune, [
            "--data-set", "SYNTHETIC", "--batch-size", b, "--finetune",
            xdir, "--epochs", "3", "--model-ema",
            "--num_workers", str(args.workers), "--output_dir",
            os.path.join(root, name)] + extra)
        result[name] = epoch_lines(text)
    _step_rates(result, args.batch, bool(planned), "deit_small",
                (("search", ()), ("finetune", ("--subnet", xdir))))
    return result


if __name__ == "__main__":
    main()
