"""Finetune CLI of the port: train the exported (pruned) subnet to its final
accuracy (the flags of scripts/finetune.py).

Loads the subnet (`load_searched_model`: an exported checkpoint, a
searched supernet checkpoint to export on the fly, or --from-scratch the
registry model; a checkpoint of the port's or of the JAX package's, whose
msgpack parts `core/checkpoint.py` reads), resizes the pos-embed to the input size, builds the
layer-decay AdamW and runs `train_one_epoch` with Mixup / CutMix and EMA;
after each epoch it evaluates the raw and the EMA weights and keeps the
better of the two in `best`.

  python -m ofb_tpu_torch.cli.finetune --data-set SYNTHETIC --tiny-test \\
      --finetune runs/smoke/exported --epochs 2 --batch-size 8 --device cpu

--distillation-type soft|hard distils from --teacher-model
(`models/teacher.py`); --planned-epoch (with --cache-device) runs the
planned loop: the epoch's plan on the device and, on the card, each step
one CUDA graph replay. Under `torchrun` each process trains on its rank's
shard of the plan (--batch-size per process, the lr scaled by the world's
batch), the steps average their gradients over the ranks, and rank 0
writes; --cache-device is single-process only.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import os
import time

import torch


def get_args_parser():
    p = argparse.ArgumentParser("OFB finetune (PyTorch port)", add_help=False)
    p.add_argument("--batch-size", default=128, type=int)
    p.add_argument("--epochs", default=300, type=int)
    p.add_argument("--accum-iter", default=1, type=int)
    p.add_argument("--model", default="deit_small_patch16_224_finetune")
    p.add_argument("--finetune", default="", type=str,
                   help="searched checkpoint dir (supernet) or exported "
                        "dense checkpoint dir; empty only with --from-scratch")
    p.add_argument("--from-scratch", action="store_true",
                   help="train the --model registry model from a fresh init "
                        "under the same recipe")
    p.add_argument("--input-size", default=224, type=int)
    p.add_argument("--drop", type=float, default=0.0)
    p.add_argument("--drop-path", type=float, default=0.1)
    p.add_argument("--model-ema", action="store_true", default=True)
    p.add_argument("--no-model-ema", action="store_false", dest="model_ema")
    p.add_argument("--model-ema-decay", type=float, default=0.99996)
    p.add_argument("--opt-eps", default=1e-8, type=float)
    p.add_argument("--opt-betas", default=(0.9, 0.999), type=float, nargs=2)
    p.add_argument("--weight-decay", type=float, default=0.05)
    p.add_argument("--layer-decay", type=float, default=0.95)
    p.add_argument("--clip-grad", type=float, default=None)
    p.add_argument("--blr", type=float, default=1.5e-4)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--warmup-lr", type=float, default=1e-6)
    p.add_argument("--min-lr", type=float, default=1e-6)
    p.add_argument("--warmup-epochs", type=int, default=5)
    p.add_argument("--sched", default="cosine", type=str)
    p.add_argument("--patience-epochs", default=10, type=int)
    p.add_argument("--decay-rate", default=0.1, type=float)
    p.add_argument("--color-jitter", type=float, default=0.4)
    p.add_argument("--aa", type=str, default="rand-m9-mstd0.5-inc1")
    p.add_argument("--smoothing", type=float, default=0.1)
    p.add_argument("--repeated-aug", action="store_true", default=True)
    p.add_argument("--no-repeated-aug", action="store_false",
                   dest="repeated_aug")
    p.add_argument("--reprob", type=float, default=0.25)
    p.add_argument("--min-crop-scale", type=float, default=0.08,
                   help="lower bound of the random-resized-crop area")
    p.add_argument("--no-hflip", action="store_false", dest="hflip",
                   default=True, help="disable horizontal flip")
    p.add_argument("--mixup", type=float, default=0.8)
    p.add_argument("--cutmix", type=float, default=1.0)
    p.add_argument("--cutmix-minmax", type=float, nargs="+", default=None,
                   help="cutmix min/max ratio (overrides alpha)")
    p.add_argument("--mixup-prob", type=float, default=1.0)
    p.add_argument("--mixup-switch-prob", type=float, default=0.5)
    p.add_argument("--mixup-mode", type=str, default="batch",
                   choices=["batch", "pair", "elem"])
    p.add_argument("--teacher-model", default="deit_base_patch16_224")
    p.add_argument("--teacher-path", default="", type=str)
    p.add_argument("--distillation-type", default="none",
                   choices=["none", "soft", "hard"],
                   help="distil from --teacher-model (models/teacher.py)")
    p.add_argument("--distillation-alpha", default=0.5, type=float)
    p.add_argument("--distillation-tau", default=1.0, type=float)
    p.add_argument("--data-path", default="", type=str)
    p.add_argument("--data-set", default="IMNET",
                   choices=["CIFAR10", "CIFAR100", "IMNET", "IMNET100",
                            "INAT", "INAT19", "SYNTHETIC", "DIGITS"])
    p.add_argument("--synthetic-size", type=int, default=2048,
                   help="samples per epoch when --data-set SYNTHETIC")
    p.add_argument("--output_dir", default="runs/finetune")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--start_epoch", default=0, type=int)
    p.add_argument("--num_workers", default=4, type=int)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--checkpoint", default="", type=str)
    p.add_argument("--auto-resume", default=2, type=int,
                   help="on a transient failure (a decode worker killed, an "
                        "ECC error, a stale network file), re-exec with "
                        "--resume --checkpoint <output_dir>/running_ckpt up "
                        "to N times; 0 off")
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--eval-every", default=1, type=int)
    p.add_argument("--tiny-test", action="store_true")
    p.add_argument("--cache-device", action="store_true",
                   help="keep the decoded uint8 staging set in device memory")
    p.add_argument("--cache-device-max-gb", default=12.0, type=float)
    p.add_argument("--planned-epoch", action="store_true", default=False,
                   help="the epoch's plan on the device, each step one CUDA "
                        "graph replay (needs --cache-device)")
    p.add_argument("--no-planned-epoch", action="store_false",
                   dest="planned_epoch")
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda (the default) raises without a "
                        "card, cpu runs on the CPU")
    p.add_argument("--use-amp", action="store_true", help="[compat] no-op")
    p.add_argument("--gpu", default="", help="[compat] no-op")
    p.add_argument("--world_size", default=1, type=int,
                   help="[compat] no-op: the world is the launcher's")
    p.add_argument("--dist_url", default="env://", help="[compat] no-op")
    p.add_argument("--dist-eval", action="store_true", help="[compat] no-op")
    p.add_argument("--pin-mem", action="store_true", help="[compat] no-op")
    return p


def load_searched_model(finetune_dir: str, args, nb_classes: int,
                        device="cuda"):
    """(dense ViT on `device`, its ModelCfg): an exported checkpoint as it
    is, a searched supernet checkpoint force-finished and exported, or with
    an empty `finetune_dir` the registry model (or the tiny geometry) drawn
    on `device` from args.seed."""
    from ..core import checkpoint as ckpt
    from ..core.compress import compress
    from ..core.export import export_subnet
    from ..device import resolve_device
    from ..models.registry import create_model
    from ..models.vit import ModelCfg, ViT
    from .common import supernet_bundle, tiny_cfg

    dev = resolve_device(device)
    if not finetune_dir:
        banner = ("=" * 64 + "\nTRAINING DENSE MODEL FROM SCRATCH (no "
                  "--finetune checkpoint)\n" + "=" * 64)
        if not getattr(args, "from_scratch", False):
            banner += ("\nNOTE: pass --from-scratch to make this explicit; "
                       "an empty --finetune without it is usually a "
                       "forgotten flag.")
        print(banner, flush=True)
        cfg = tiny_cfg(nb_classes) if args.tiny_test else create_model(
            args.model, device=dev, num_classes=nb_classes).cfg
        # drawn on the device from args.seed (a ViT-H drawn on the host
        # takes seconds)
        g = torch.Generator(device=dev).manual_seed(args.seed)
        return ViT(cfg, generator=g, device=dev), cfg

    meta = ckpt.latest_meta(finetune_dir)
    if meta is None:
        raise FileNotFoundError(f"no checkpoint at {finetune_dir}")
    if meta.get("exported"):
        cfg = ckpt.model_cfg_from_meta(meta["model_cfg"], ModelCfg)
        params = ViT(cfg, device=dev)
        ckpt.load_checkpoint(finetune_dir, params=params)
        return params, cfg

    saved_args = dict(meta.get("args", {}))
    saved_args["model"] = saved_args.get("model", args.model).replace(
        "_finetune", "_mim")
    if args.tiny_test:
        saved_args["tiny_test"] = True
    bundle = supernet_bundle(saved_args, args.model, nb_classes, dev)
    params, alphas, arch = bundle.init(0)
    ckpt.load_checkpoint(finetune_dir, params=params, alphas=alphas,
                         arch=arch)
    guard = 0
    while not arch.all_finished and guard < 20:
        params, alphas, arch, _, _ = compress(params, alphas, arch, None,
                                              bundle.space, thresh=1.0)
        guard += 1
    dense, dense_cfg, _ = export_subnet(params, arch, bundle.space,
                                        bundle.cfg, fuse=True)
    return dense, dense_cfg


def main(args):
    from ..config import (DataConfig, DistillationConfig, MixupConfig,
                          ScheduleConfig)
    from ..core import checkpoint as ckpt
    from ..core.engine import (evaluate, train_one_epoch,
                               train_one_epoch_planned)
    from ..core.lr_decay import build_finetune_optimizer
    from ..core.optim import (PlateauTracker, make_schedule, set_lr_scale,
                              with_lr_scale)
    from ..core.steps import (TrainState, make_eval_step_dense,
                              make_planned_train_step, make_train_step)
    from ..data.datasets import build_dataset
    from ..data.pipeline import (build_device_cache, device_cache_feed,
                                 device_feed, epoch_plan, make_epoch_loader)
    from ..models.pos_embed import interpolate_pos_embed
    from ..models.vit import dense_flops
    from ..parallel.distributed import reinit_state
    from ..utils.logging import RunLogger, master_print
    from .common import (device_cache_on, distributed_setup, epoch_generator,
                         epoch_seed)

    if args.planned_epoch and not args.cache_device:
        raise SystemExit("--planned-epoch gathers its batches from the "
                         "device cache: it needs --cache-device")
    rank, world, dev = distributed_setup(args.device)
    compute = torch.bfloat16 if args.compute_dtype == "bfloat16" \
        else torch.float32
    dcfg = DataConfig(data_path=args.data_path, data_set=args.data_set,
                      input_size=args.input_size,
                      num_workers=args.num_workers,
                      repeated_aug=args.repeated_aug,
                      batch_size=args.batch_size,
                      synthetic_size=args.synthetic_size)
    staging = 256 if not args.tiny_test else 40
    out_size = args.input_size if not args.tiny_test else 32
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

    params, cfg = load_searched_model(args.finetune, args, nb_classes, dev)
    # the model takes the input size (reference finetune.py:331-349), so a
    # subnet searched at 224 finetunes at --input-size 384 with its
    # pos-embed resized below; scripts/finetune.py keeps the checkpoint's
    # img_size, and its resize never runs
    cfg = dataclasses.replace(cfg, num_classes=nb_classes,
                              drop_path_rate=args.drop_path,
                              drop_rate=args.drop, img_size=out_size)
    want_tokens = cfg.num_patches + cfg.num_tokens
    if params.pos_embed.shape[1] != want_tokens:
        params.pos_embed = torch.nn.Parameter(interpolate_pos_embed(
            params.pos_embed.detach(), cfg.num_patches, cfg.num_tokens))

    eff_batch = args.batch_size * args.accum_iter * world
    lr = args.lr if args.lr is not None else args.blr * eff_batch / 256
    master_print(f"finetune lr {lr:.2e} (eff batch {eff_batch}) "
                 f"model dims: D={cfg.embed_dim} blocks={cfg.block_overrides}")

    batch = args.batch_size * args.accum_iter
    steps_per_epoch = len(make_epoch_loader(
        ds_train, epoch=0, rank=rank, world=world, batch_size=batch,
        repeated_aug=args.repeated_aug, train=True, seed=args.seed))
    total_micro = args.epochs * steps_per_epoch * args.accum_iter
    sched_cfg = ScheduleConfig(sched=args.sched, warmup_lr=args.warmup_lr,
                               min_lr=args.min_lr,
                               warmup_epochs=args.warmup_epochs,
                               decay_rate=args.decay_rate)
    schedule = make_schedule(lr, sched_cfg, total_micro,
                             steps_per_epoch * args.accum_iter)
    tx = build_finetune_optimizer(
        params, lr_schedule=lambda c: schedule(c * args.accum_iter),
        betas=tuple(args.opt_betas), eps=args.opt_eps,
        weight_decay=args.weight_decay, layer_decay=args.layer_decay,
        num_layers=cfg.depth, clip_grad=args.clip_grad)
    plateau = PlateauTracker(patience=args.patience_epochs,
                             decay_rate=args.decay_rate) \
        if args.sched == "plateau" else None
    if plateau is not None:
        tx = with_lr_scale(tx)

    # the EMA weights are a second model's parameters, so the eval step
    # runs them as they are
    ema_model = None
    if args.model_ema:
        ema_model = copy.deepcopy(params)
        ema_model.requires_grad_(False)
    state = TrainState(step=0, params=params, alphas=None, arch=None,
                       opt_state=tx.init(dict(params.named_parameters())),
                       ema_params=dict(ema_model.named_parameters())
                       if ema_model is not None else None)
    start_epoch = args.start_epoch
    if args.resume and args.checkpoint:
        restored = ckpt.load_checkpoint(args.checkpoint, params=params,
                                        opt_state=state.opt_state,
                                        ema_params=ema_model)
        start_epoch = restored["meta"].get("epoch", -1) + 1
        master_print(f"resumed from {args.checkpoint} at epoch "
                     f"{start_epoch}")
    reinit_state((state, ema_model))

    mix = MixupConfig(mixup=args.mixup, cutmix=args.cutmix,
                      prob=args.mixup_prob,
                      switch_prob=args.mixup_switch_prob,
                      cutmix_minmax=tuple(args.cutmix_minmax)
                      if args.cutmix_minmax else None,
                      mode=args.mixup_mode, label_smoothing=args.smoothing)
    teacher_apply = None
    distill = DistillationConfig(distillation_type=args.distillation_type,
                                 alpha=args.distillation_alpha,
                                 tau=args.distillation_tau)
    if args.distillation_type != "none":
        from ..models.teacher import build_teacher
        teacher_apply = build_teacher(
            args.teacher_model, teacher_path=args.teacher_path,
            num_classes=nb_classes, compute_dtype=compute, device=dev)
    common = dict(num_classes=nb_classes, mixup_cfg=mix,
                  smoothing=args.smoothing,
                  ema_decay=args.model_ema_decay if args.model_ema else None,
                  teacher_apply=teacher_apply, distill=distill,
                  compute_dtype=compute, device=dev)
    if planned:
        step_fn = make_planned_train_step(
            cfg, tx, accum_iter=args.accum_iter, use_randaug=bool(args.aa),
            re_prob=args.reprob, crop_scale=(args.min_crop_scale, 1.0),
            hflip=args.hflip, **common)
        plan_gen = torch.Generator(device=dev)
        master_print("planned-epoch loop: the epoch's plan on the device, "
                     "one step call an iteration")
    else:
        step_fn = make_train_step(cfg, tx, **common)
    eval_step = make_eval_step_dense(cfg, compute_dtype=compute, device=dev)
    logger = RunLogger(args.output_dir)
    aug = dict(use_randaug=bool(args.aa), re_prob=args.reprob,
               crop_scale=(args.min_crop_scale, 1.0), hflip=args.hflip)
    cfg_meta = dataclasses.asdict(cfg)
    max_acc = 0.0
    t0 = time.time()

    def run_eval(model, header):
        if cache_val is not None:
            vfeed = device_cache_feed(
                *cache_val, epoch=0, rank=rank, world=world,
                batch_size=args.batch_size, repeated_aug=False, train=False,
                seed=args.seed, out_size=out_size)
        else:
            vfeed = device_feed(make_epoch_loader(
                ds_val, epoch=0, rank=rank, world=world,
                batch_size=args.batch_size,
                repeated_aug=False, train=False, seed=args.seed),
                train=False, out_size=out_size, device=dev)
        return evaluate(eval_step, vfeed, model, header=header)

    for epoch in range(start_epoch, args.epochs):
        if planned:
            # one generator for the run, reseeded each epoch: a captured
            # step draws from the generator it was captured with
            plan_gen.manual_seed(epoch_seed(args.seed, epoch))
            batches = epoch_plan(
                int(cache_train[0].shape[0]), epoch=epoch, rank=rank,
                world=world, batch_size=batch,
                repeated_aug=args.repeated_aug, train=True,
                seed=args.seed)
            state, train_stats = train_one_epoch_planned(
                state, step_fn, cache_train[0], cache_train[1], batches,
                epoch=epoch, generator=plan_gen)
        else:
            gen = epoch_generator(dev, args.seed, epoch)
            if cache_train is not None:
                feed = device_cache_feed(
                    *cache_train, generator=gen, epoch=epoch, rank=rank,
                    world=world, batch_size=batch,
                    repeated_aug=args.repeated_aug, train=True,
                    seed=args.seed, accum_iter=args.accum_iter,
                    out_size=out_size, **aug)
            else:
                loader = make_epoch_loader(
                    ds_train, epoch=epoch, rank=rank, world=world,
                    batch_size=batch,
                    repeated_aug=args.repeated_aug, train=True,
                    seed=args.seed,
                    num_workers=args.num_workers if not args.tiny_test
                    else 0)
                feed = device_feed(loader, generator=gen, train=True,
                                   accum_iter=args.accum_iter,
                                   out_size=out_size, device=dev, **aug)
            state, train_stats = train_one_epoch(
                state, step_fn, feed, epoch=epoch,
                steps_per_epoch=steps_per_epoch, generator=gen)

        if args.output_dir:
            ckpt.save_checkpoint(
                os.path.join(args.output_dir, "running_ckpt"),
                params=state.params, opt_state=state.opt_state,
                ema_params=ema_model,
                meta={"epoch": epoch, "exported": True,
                      "from_scratch": not bool(args.finetune),
                      "model_cfg": cfg_meta})

        if epoch % args.eval_every == 0 or epoch == args.epochs - 1:
            # raw and EMA weights both evaluated, the better one kept
            test_stats = run_eval(state.params, "Test[raw]:")
            candidates = [("raw", test_stats["acc1"])]
            if ema_model is not None:
                ema_stats = run_eval(ema_model, "Test[ema]:")
                candidates.append(("ema", ema_stats["acc1"]))
                test_stats["ema_acc1"] = ema_stats["acc1"]
                master_print(f"EMA accuracy: {ema_stats['acc1']:.2f}%")
            win_kind, win_acc = max(candidates, key=lambda kv: kv[1])
            if win_acc >= max_acc and args.output_dir:
                # the winner's weights go in 'params' (what consumers load),
                # the other set in the 'ema' slot
                win, other = (ema_model, state.params) if win_kind == "ema" \
                    else (state.params, ema_model)
                ckpt.save_checkpoint(
                    os.path.join(args.output_dir, "best"),
                    params=win, ema_params=other,
                    meta={"epoch": epoch, "acc1": win_acc,
                          "eval_winner": win_kind,
                          "from_scratch": not bool(args.finetune),
                          "exported": True, "model_cfg": cfg_meta})
            max_acc = max(max_acc, win_acc)
            master_print(f"Max accuracy: {max_acc:.2f}%")
            if plateau is not None:
                set_lr_scale(state.opt_state, plateau.update(win_acc))
            n_params = sum(p.numel() for p in state.params.parameters())
            logger.log_epoch(epoch, train_stats, test_stats, n_params,
                             dense_flops(cfg))

    ckpt.commit_saves("finetune checkpoints committed")
    master_print(f"Finetune time "
                 f"{time.strftime('%H:%M:%S', time.gmtime(time.time() - t0))}")
    return state


if __name__ == "__main__":
    from ..utils.resilience import run_with_auto_resume
    parser = argparse.ArgumentParser("OFB finetune (PyTorch port)",
                                     parents=[get_args_parser()])
    run_with_auto_resume(main, parser.parse_args())
