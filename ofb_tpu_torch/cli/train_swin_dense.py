"""Dense Swin trainer of the port: the flags and flow of
scripts/train_swin_dense.py on one GPU.

Trains a stock registry Swin (no search machinery) from scratch with the
recipe of the Swin search's export finetune (cosine AdamW, weight decay
0.05, label smoothing, the classic loop or, with --cache-device
--planned-epoch, the planned one), evaluating every --eval-every epochs.
Writes running_ckpt every --ckpt-every epochs and the last, best/ (the
weights of the best eval, as the search CLIs keep theirs) whenever an
eval is at least as good, and at the end model_finetuned from best/.
--resume continues from running_ckpt and restores the best weights from
best/, so a resumed run ends with the weights that reached its recorded
accuracy (the JAX package's trainer keeps the best weights in memory
only, and a resume loses them).

  python -m ofb_tpu_torch.cli.train_swin_dense --data-set SYNTHETIC \\
      --tiny-test --device cpu --compute-dtype float32 --epochs 2 \\
      --batch-size 8 --output_dir runs/swin_dense_smoke

Under `torchrun` the ranks split each batch plan and average their
gradients (lr scaled by the world); --cache-device is single-process only.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch


def get_args_parser():
    p = argparse.ArgumentParser("dense Swin trainer (PyTorch port)",
                                add_help=False)
    p.add_argument("--batch-size", default=128, type=int)
    p.add_argument("--epochs", default=40, type=int)
    p.add_argument("--model", default="swin_tiny_patch4_window7_224")
    p.add_argument("--input-size", default=224, type=int)
    p.add_argument("--drop-path", type=float, default=0.1)
    p.add_argument("--blr", type=float, default=2.5e-4)
    p.add_argument("--smoothing", type=float, default=0.1)
    p.add_argument("--aa", type=str, default="rand-m9-mstd0.5-inc1")
    p.add_argument("--reprob", type=float, default=0.25)
    p.add_argument("--min-crop-scale", type=float, default=0.08)
    p.add_argument("--no-hflip", action="store_false", dest="hflip",
                   default=True)
    p.add_argument("--data-path", default="", type=str)
    p.add_argument("--data-set", default="IMNET",
                   choices=["CIFAR10", "CIFAR100", "IMNET", "IMNET100",
                            "INAT", "INAT19", "SYNTHETIC", "DIGITS"])
    p.add_argument("--synthetic-size", type=int, default=2048,
                   help="samples per epoch when --data-set SYNTHETIC")
    p.add_argument("--output_dir", default="runs/swin_dense")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--num_workers", default=4, type=int)
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--eval-every", default=5, type=int)
    p.add_argument("--ckpt-every", default=5, type=int)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--checkpoint", default="", type=str)
    p.add_argument("--auto-resume", default=2, type=int)
    p.add_argument("--tiny-test", action="store_true")
    p.add_argument("--cache-device", action="store_true")
    p.add_argument("--cache-device-max-gb", default=12.0, type=float)
    p.add_argument("--planned-epoch", action="store_true", default=False)
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda (the default) raises without a "
                        "card, cpu runs on the CPU")
    return p


def main(args):
    from ..config import DataConfig, ScheduleConfig
    from ..core import checkpoint as ckpt
    from ..core.engine import (evaluate, train_one_epoch,
                               train_one_epoch_planned)
    from ..core.optim import adamw, cosine_schedule
    from ..core.steps import TrainState
    from ..core.swin_steps import (make_planned_swin_train_step,
                                   make_swin_eval_step_dense,
                                   make_swin_train_step_dense)
    from ..data.datasets import build_dataset
    from ..data.pipeline import (build_device_cache, device_cache_feed,
                                 device_feed, epoch_plan, make_epoch_loader)
    from ..models.registry import create_model
    from ..models.swin import Swin
    from ..parallel.distributed import reinit_state
    from ..utils.logging import master_print
    from .common import (device_cache_on, distributed_setup, epoch_generator,
                         epoch_seed, swin_tiny_cfg)

    if args.planned_epoch and not args.cache_device:
        raise SystemExit("--planned-epoch gathers its batches from the "
                         "device cache: it needs --cache-device")
    rank, world, dev = distributed_setup(args.device)
    compute = torch.bfloat16 if args.compute_dtype == "bfloat16" \
        else torch.float32
    t0 = time.time()

    staging = 256 if not args.tiny_test else 40
    out_size = args.input_size if not args.tiny_test else 32
    dcfg = DataConfig(data_path=args.data_path, data_set=args.data_set,
                      input_size=out_size, num_workers=args.num_workers,
                      batch_size=args.batch_size,
                      synthetic_size=args.synthetic_size)
    ds_train, nb_classes = build_dataset(True, dcfg, staging)
    ds_val, _ = build_dataset(False, dcfg, staging)
    cache_train = cache_val = None
    use_cache = device_cache_on(args, world)
    planned = args.planned_epoch and use_cache
    if use_cache:
        max_bytes = int(args.cache_device_max_gb * 2**30)
        cache_train = build_device_cache(ds_train, max_bytes=max_bytes,
                                         device=dev)
        cache_val = build_device_cache(ds_val, max_bytes=max_bytes,
                                       device=dev)
        master_print("device cache staged")

    g = torch.Generator().manual_seed(args.seed)
    if args.tiny_test:
        cfg = swin_tiny_cfg(nb_classes, args.drop_path)
        params = Swin(cfg, generator=g).to(dev)
    else:
        bundle = create_model(args.model, device=dev, num_classes=nb_classes,
                              img_size=args.input_size,
                              drop_path_rate=args.drop_path)
        cfg = bundle.cfg
        params = bundle.init(args.seed)

    steps_per_epoch = len(make_epoch_loader(
        ds_train, epoch=0, rank=rank, world=world, batch_size=args.batch_size,
        repeated_aug=False, train=True, seed=args.seed))
    master_print(f"dense swin: steps/epoch {steps_per_epoch}")
    # the Swin search's export-finetune recipe
    lr = args.blr * args.batch_size * world / 256
    sch = cosine_schedule(
        lr, ScheduleConfig(warmup_lr=1e-6, min_lr=1e-6,
                           warmup_epochs=min(5, args.epochs // 4)),
        args.epochs * steps_per_epoch, steps_per_epoch)
    tx = adamw(sch, weight_decay=0.05)
    state = TrainState(step=0, params=params, alphas=None, arch=None,
                       opt_state=tx.init(dict(params.named_parameters())))
    best_params = Swin(cfg, device=dev)
    best_params.load_state_dict(params.state_dict())

    start_epoch, best = 0, 0.0
    best_dir = os.path.join(args.output_dir, "best")
    if args.resume:
        rdir = args.checkpoint or os.path.join(args.output_dir,
                                               "running_ckpt")
        meta = ckpt.load_checkpoint(rdir, params=params,
                                    opt_state=state.opt_state)["meta"]
        start_epoch = meta.get("epoch", -1) + 1
        best = float(meta.get("best_acc1", 0.0))
        state.step.fill_(start_epoch * steps_per_epoch)
        if ckpt.latest_meta(best_dir) is not None:
            ckpt.load_checkpoint(best_dir, params=best_params)
        master_print(f"resumed from {rdir} at epoch {start_epoch} (best "
                     f"acc1 {best:.2f})")
    reinit_state((state, best_params))

    aug = dict(use_randaug=bool(args.aa), re_prob=args.reprob,
               crop_scale=(args.min_crop_scale, 1.0), hflip=args.hflip)
    eval_step = make_swin_eval_step_dense(cfg, compute_dtype=compute,
                                          device=dev)
    if planned:
        step = make_planned_swin_train_step(cfg, tx, smoothing=args.smoothing,
                                            compute_dtype=compute, device=dev,
                                            **aug)
        plan_gen = torch.Generator(device=dev)
        master_print("planned-epoch loop: one step call an iteration")
    else:
        step = make_swin_train_step_dense(cfg, tx, smoothing=args.smoothing,
                                          compute_dtype=compute, device=dev)

    def val_feed():
        if cache_val is not None:
            return device_cache_feed(
                *cache_val, epoch=0, rank=rank, world=world,
                batch_size=args.batch_size, repeated_aug=False, train=False,
                seed=args.seed, out_size=out_size)
        vloader = make_epoch_loader(ds_val, epoch=0, rank=rank, world=world,
                                    batch_size=args.batch_size,
                                    repeated_aug=False, train=False,
                                    seed=args.seed)
        return device_feed(vloader, train=False, out_size=out_size,
                           device=dev)

    meta = {"family": "swin", "from_scratch": True,
            "model_cfg": dataclasses.asdict(cfg)}
    os.makedirs(args.output_dir, exist_ok=True)
    for ep in range(start_epoch, args.epochs):
        te = time.time()
        seed = args.seed + 777
        if planned:
            plan_gen.manual_seed(epoch_seed(seed, ep))
            batches = epoch_plan(int(cache_train[0].shape[0]), epoch=ep,
                                 rank=rank, world=world,
                                 batch_size=args.batch_size,
                                 repeated_aug=False, train=True,
                                 seed=args.seed)
            state, _ = train_one_epoch_planned(
                state, step, cache_train[0], cache_train[1], batches,
                epoch=ep, generator=plan_gen)
        else:
            gen = epoch_generator(dev, seed, ep)
            if cache_train is not None:
                feed = device_cache_feed(
                    *cache_train, generator=gen, epoch=ep, rank=rank,
                    world=world, batch_size=args.batch_size,
                    repeated_aug=False, train=True, seed=args.seed,
                    out_size=out_size, **aug)
            else:
                feed = device_feed(make_epoch_loader(
                    ds_train, epoch=ep, rank=rank, world=world,
                    batch_size=args.batch_size, repeated_aug=False,
                    train=True, seed=args.seed,
                    num_workers=args.num_workers if not args.tiny_test
                    else 0), generator=gen, train=True, out_size=out_size,
                    device=dev, **aug)
            state, _ = train_one_epoch(state, step, feed, epoch=ep,
                                       steps_per_epoch=steps_per_epoch,
                                       generator=gen)
        if ep % max(args.eval_every, 1) == 0 or ep == args.epochs - 1:
            stats = evaluate(eval_step, val_feed(), state.params)
            if stats["acc1"] >= best:
                best = stats["acc1"]
                best_params.load_state_dict(state.params.state_dict())
                ckpt.save_checkpoint(best_dir, params=best_params,
                                     meta={"epoch": ep, "acc1": best,
                                           "exported": True, **meta})
            master_print(f"epoch {ep} acc1 {stats['acc1']:.2f} "
                         f"(best {best:.2f}) {time.time() - te:.1f}s")
        if ep % max(args.ckpt_every, 1) == 0 or ep == args.epochs - 1:
            ckpt.save_checkpoint(
                os.path.join(args.output_dir, "running_ckpt"),
                params=state.params, opt_state=state.opt_state,
                meta={"epoch": ep, "best_acc1": best, **meta},
                async_write=True)

    ckpt.save_checkpoint(os.path.join(args.output_dir, "model_finetuned"),
                         params=best_params,
                         meta={"exported": True, "acc1": best, **meta})
    ckpt.commit_saves("dense swin checkpoints committed")
    master_print(f"dense swin done: best acc1 {best:.2f} in "
                 f"{time.strftime('%H:%M:%S', time.gmtime(time.time() - t0))}")
    return state, best_params


if __name__ == "__main__":
    from ..utils.resilience import run_with_auto_resume
    parser = argparse.ArgumentParser("dense Swin trainer (PyTorch port)",
                                     parents=[get_args_parser()])
    run_with_auto_resume(main, parser.parse_args())
