"""Component-level timing of the OFB step on one GPU. Port of
scripts/perf_breakdown.py.

Each row is a subset of the work, timed on the host over `--steps` calls
after two warm-up calls and ended by reading back the last loss
(`bench.time_calls`), reported as img/s and MFU against the H100 SXM dense
bf16 peak of 989 TFLOP/s (`bench.H100_BF16_PEAK`): 1 x the supernet's
forward FLOPs an image for the eval row, 3 x for the train rows (the dense
row's too, as the JAX script counts it). Rows:

  eval_fwd       gated supernet forward, no MIM, no grad
  search_step    the full search train step (fwd + the loss families + bwd
                 + the five-family AdamW) — bench.py's headline
  dense_step     plain supervised train step of the same dense ViT (no
                 gates, decoder or arch loss) under AdamW(1e-4): isolates
                 the search machinery
  search_no_mim  the search step of a supernet without the PMIM decoder
                 and mask token: the decoder, masked-L1 and norm-target cost
  search_sgd0    the search step under SGD at learning rate 0: the AdamW's
                 cost is the gap to search_step
  augment_only   the device train transform alone (256 px uint8 staging
                 -> RandAugment m9 -> the model's input size, erasing 0.25)

The rows are built and freed one at a time, each from the same seeds.
`--tiny` or `--device cpu` takes the 32-pixel two-block model in fp32 and
skips augment_only, as the JAX script does off the TPU. Runs on the card
unless --device cpu asks for the CPU; without a card it raises.

Usage: python -m ofb_tpu_torch.scripts.perf_breakdown [--tiny]
           [--model deit_small] [--batch N] [--steps N] [--remat]
           [--device cuda|cpu]
Prints one JSON line: rows with img_s and mfu, search_overhead_vs_dense,
mim_decoder_cost and adamw_cost.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json

import torch

STAGING = 256           # augment_only's staging size
KEEP_RATIO = 0.75


def search_state(bundle, tx, params=None, seed: int = 0):
    """A TrainState of the supernet drawn from `seed` (or of `params`, with
    the seed's alphas and arch state) under optimizer `tx`."""
    from ..core.optim import named_leaves
    from ..core.steps import TrainState
    p, alphas, arch = bundle.init(seed)
    params = p if params is None else params
    return TrainState(step=0, params=params, alphas=alphas, arch=arch,
                      opt_state=tx.init(named_leaves(params, alphas)))


def dense_optimizer():
    """optax.adamw(1e-4): a constant 1e-4 and its default weight decay of
    1e-4 on every leaf."""
    from ..config import ScheduleConfig
    from ..core.optim import adamw, make_schedule
    return adamw(make_schedule(1e-4, ScheduleConfig(sched="constant",
                                                    warmup_epochs=0), 1, 1),
                 weight_decay=1e-4)


def eval_call(bundle, state, images, labels, compute):
    """The eval_fwd row: a call and the box holding its last metrics."""
    from ..core.steps import make_eval_step
    ev = make_eval_step(bundle.space, bundle.cfg, compute_dtype=compute,
                        device=bundle.device)
    box = {}

    def call():
        box["m"] = ev(state.params, state.alphas, state.arch, images[0],
                      labels[0])
        return box["m"]["loss_sum"]
    return call, box


def search_call(bundle, scfg, tx, state, images, labels, compute,
                generator):
    """A search-step row (search_step, search_no_mim, search_sgd0)."""
    from ..core.steps import make_search_step
    step = make_search_step(bundle.space, bundle.cfg, scfg, tx,
                            phase="search", compute_dtype=compute,
                            device=bundle.device)
    box = {"s": state}

    def call():
        box["s"], box["m"] = step(box["s"], images, labels, generator,
                                  KEEP_RATIO)
        return box["m"]["loss_total"]
    return call, box


def dense_call(cfg, dparams, images, labels, compute, generator, device):
    """The dense_step row: the dense ViT's supervised step under
    `dense_optimizer`."""
    from ..core.steps import TrainState, make_train_step
    dtx = dense_optimizer()
    state = TrainState(step=0, params=dparams, alphas=None, arch=None,
                       opt_state=dtx.init(dict(dparams.named_parameters())))
    step = make_train_step(cfg, dtx, num_classes=cfg.num_classes,
                           compute_dtype=compute, device=device)
    box = {"s": state}

    def call():
        box["s"], box["m"] = step(box["s"], images, labels, generator)
        return box["m"]["loss"]
    return call, box


def augment_call(batch: int, out_size: int, device, generator):
    """The augment_only row: uint8 staging images from a seed through
    `train_augment_batch`, fresh draws each call."""
    import numpy as np
    from ..ops.augment import train_augment_batch
    staged = torch.from_numpy(np.random.RandomState(4).randint(
        0, 255, (batch, STAGING, STAGING, 3)).astype(np.uint8)).to(device)

    def call():
        return train_augment_batch(generator, staged, out_size=out_size,
                                   use_randaug=True, re_prob=0.25).sum()
    return call, {}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--model", default="deit_small",
                    choices=["deit_small", "deit_base", "deit_tiny"])
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..bench import H100_BF16_PEAK, random_batch, search_config, \
        time_calls
    from ..core.optim import sgd
    from ..device import resolve_device
    from ..dryrun import flagship
    from ..models.mim_vit import init_mim_params
    from ..models.registry import create_model
    from ..models.vit import ViT
    from ..ops.flops import model_flops

    dev = resolve_device(args.device)
    tiny = args.tiny or dev.type == "cpu"
    if tiny:
        # the JAX script's tiny supernet: 32 px, patch 8, D 32, 2 blocks
        bundle = flagship(True, dev)
        batch, compute = args.batch or 8, torch.float32
    else:
        bundle = create_model(f"{args.model}_patch16_224_mim", device=dev,
                              patch_search=True)
        if args.remat:
            bundle.cfg = dataclasses.replace(bundle.cfg, remat=True)
        batch = args.batch or (256 if args.model != "deit_base" else 128)
        compute = torch.bfloat16
    cfg, space = bundle.cfg, bundle.space
    scfg, tx = search_config(batch)
    images, labels = random_batch(cfg, batch, dev)
    gen = torch.Generator(device=dev).manual_seed(1)

    _, alphas, arch = bundle.init(0)
    total, _ = model_flops(alphas, arch, space, cfg)
    fwd_flops = 2.0 * float(total) * 1e9           # FLOPs = 2 x MACs
    del alphas, arch
    rows = {}

    def timed(name, make, flops):
        call, box = make()
        dt = time_calls(call, args.steps, warmup=2)
        rows[name] = (batch / dt, batch / dt * flops / H100_BF16_PEAK)
        box.clear()
        del call, box
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    # 1) forward only (eval step)
    timed("eval_fwd", lambda: eval_call(
        bundle, search_state(bundle, tx), images, labels, compute),
        fwd_flops)
    # 2) the full search step
    timed("search_step", lambda: search_call(
        bundle, scfg, tx, search_state(bundle, tx), images, labels, compute,
        gen), 3 * fwd_flops)
    # 3) the dense supervised step of the same architecture
    timed("dense_step", lambda: dense_call(
        cfg, ViT(cfg, generator=torch.Generator().manual_seed(2)).to(dev),
        images, labels, compute, gen, dev), 3 * fwd_flops)
    # 4) the search step without the PMIM decoder (mae off)
    timed("search_no_mim", lambda: search_call(
        bundle, scfg, tx, search_state(bundle, tx, init_mim_params(
            cfg, space, mae=False,
            generator=torch.Generator().manual_seed(3)).to(dev)),
        images, labels, compute, gen), 3 * fwd_flops)
    # 5) the search step with a free optimizer: the AdamW's cost
    ztx = sgd(0.0)
    timed("search_sgd0", lambda: search_call(
        bundle, scfg, ztx, search_state(bundle, ztx), images, labels,
        compute, gen), 3 * fwd_flops)
    # 6) the device augment alone
    if not tiny:
        timed("augment_only", lambda: augment_call(batch, cfg.img_size, dev,
                                                   gen), 0.0)

    out = {"model": bundle.name, "batch": batch,
           "rows": {k: {"img_s": round(v[0], 1), "mfu": round(v[1], 4)}
                    for k, v in rows.items()},
           "search_overhead_vs_dense": round(
               rows["dense_step"][0] / rows["search_step"][0] - 1.0, 4),
           "mim_decoder_cost": round(
               rows["search_no_mim"][0] / rows["search_step"][0] - 1.0, 4),
           "adamw_cost": round(
               rows["search_sgd0"][0] / rows["search_step"][0] - 1.0, 4)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
