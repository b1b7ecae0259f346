"""OFB search CLI of the port: the flags and orchestration of
scripts/search.py on one GPU.

Builds the data, the supernet and its optimizers; runs the epoch loop of
`search_one_epoch` with the in-loop compress passes; at finish_search
switches to the postsearch step (PMIM off, decoder frozen, Mixup / CutMix,
soft-target CE); after each epoch writes the checkpoints (running_ckpt,
best on the soft accuracy, model_pruned), log.txt and alpha.txt; stops at
--fuse_point, and at the end fuses the best checkpoint, evaluates it and
saves model_fused.

  python -m ofb_tpu_torch.cli.search --data-set SYNTHETIC --tiny-test \\
      --device cpu --compute-dtype float32 --epochs 2 --batch-size 8

--device defaults to cuda and raises without a card. --planned-epoch
(with --cache-device and the fused augment) runs the planned loop: the
epoch's plan on the device and, on the card, each step one CUDA graph
replay. --pretrained_path loads a timm DeiT / ViT state dict
(`models/torch_import.py`); --distillation-type soft|hard adds the teacher
(`models/teacher.py`). --resume --checkpoint takes a running checkpoint
of the port's or of the JAX package's (params, alphas, arch state, Adam
moments, EMA and the epoch).

Under `torchrun` every process takes its rank's shard of each epoch's plan
(--batch-size is per process, the learning rates scale with the world's
batch) and the steps average their gradients over the ranks; rank 0 writes
the run's files. --cache-device (and so --planned-epoch) is single-process
only and falls back to the host loader at a larger world:

  torchrun --nproc_per_node 8 -m ofb_tpu_torch.cli.search --data-set IMNET \
      --data-path /data/imagenet --batch-size 64 --output_dir runs/s8
"""

from __future__ import annotations

import argparse
import copy
import os
import time

import numpy as np
import torch


def get_args_parser():
    p = argparse.ArgumentParser("OFB search (PyTorch port)", add_help=False)
    p.add_argument("--batch-size", default=128, type=int)
    p.add_argument("--epochs", default=100, type=int)
    p.add_argument("--accum-iter", default=2, type=int)
    p.add_argument("--model", default="deit_small_patch16_224_mim", type=str)
    p.add_argument("--mae", action="store_true", default=True)
    p.add_argument("--no-mae", action="store_false", dest="mae")
    p.add_argument("--input-size", default=224, type=int)
    p.add_argument("--mask-ratio", default=1.0, type=float)
    p.add_argument("--fuse_point", default=50, type=int)
    p.add_argument("--drop", type=float, default=0.0)
    p.add_argument("--drop-path", type=float, default=0.1)
    p.add_argument("--model-ema", action="store_true", default=False)
    p.add_argument("--model-ema-decay", type=float, default=0.99996)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--checkpoint", default="", type=str)
    p.add_argument("--auto-resume", default=2, type=int,
                   help="on a transient failure (a decode worker killed, an "
                        "ECC error, a stale network file), re-exec this CLI "
                        "with --resume --checkpoint <output_dir>/running_ckpt "
                        "up to N times; 0 disables")
    p.add_argument("--opt-eps", default=1e-8, type=float)
    p.add_argument("--opt-betas", default=(0.9, 0.999), type=float, nargs=2)
    p.add_argument("--opt-betas-arch", default=(0.5, 0.999), type=float,
                   nargs=2)
    p.add_argument("--weight-decay", type=float, default=1e-3)
    p.add_argument("--weight-decay-arch", type=float, default=1e-3)
    p.add_argument("--weight-decay-decoder", type=float, default=1e-3)
    p.add_argument("--clip-grad", type=float, default=None)
    p.add_argument("--sched", default="cosine", type=str)
    p.add_argument("--patience-epochs", default=10, type=int,
                   help="plateau scheduler patience")
    p.add_argument("--decay-rate", default=0.1, type=float)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--lr_arch", type=float, default=None)
    p.add_argument("--lr_decoder", type=float, default=None)
    p.add_argument("--blr", type=float, default=2.5e-4)
    p.add_argument("--blr_arch", type=float, default=2.5e-4)
    p.add_argument("--blr_decoder", type=float, default=2.5e-4)
    p.add_argument("--warmup-lr", type=float, default=1e-6)
    p.add_argument("--min-lr", type=float, default=1e-5)
    p.add_argument("--min-lr-arch", type=float, default=None,
                   help="LR floor of the arch schedule only (absolute)")
    p.add_argument("--warmup-epochs", type=int, default=20)
    p.add_argument("--color-jitter", type=float, default=0.4)
    p.add_argument("--aa", type=str, default="rand-m9-mstd0.5-inc1")
    p.add_argument("--smoothing", type=float, default=0.1)
    p.add_argument("--repeated-aug", action="store_true", default=True)
    p.add_argument("--no-repeated-aug", action="store_false",
                   dest="repeated_aug")
    p.add_argument("--reprob", type=float, default=0.25)
    p.add_argument("--synthetic-size", type=int, default=2048,
                   help="samples per epoch when --data-set SYNTHETIC")
    p.add_argument("--min-crop-scale", type=float, default=0.08,
                   help="RandomResizedCrop scale lower bound")
    p.add_argument("--no-hflip", action="store_false", dest="hflip",
                   default=True)
    p.add_argument("--mixup", type=float, default=0.0)
    p.add_argument("--cutmix", type=float, default=0.0)
    p.add_argument("--cutmix-minmax", type=float, nargs="+", default=None,
                   help="cutmix min/max ratio (overrides alpha)")
    p.add_argument("--mixup-prob", type=float, default=1.0)
    p.add_argument("--mixup-switch-prob", type=float, default=0.5)
    p.add_argument("--mixup-mode", type=str, default="batch",
                   choices=["batch", "pair", "elem"])
    p.add_argument("--teacher-model", default="regnety_160", type=str)
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
    p.add_argument("--output_dir", default="runs/test")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--start_epoch", default=0, type=int)
    p.add_argument("--num_workers", default=4, type=int)
    p.add_argument("--w_head", default=0.5, type=float)
    p.add_argument("--w_embedding", default=0.5, type=float)
    p.add_argument("--w_mlp", default=0.5, type=float)
    p.add_argument("--w_patch", default=0, type=float)
    p.add_argument("--w_flops", default=5, type=float)
    p.add_argument("--w_decoder", default=1, type=float)
    p.add_argument("--target_flops", default=1.0, type=float)
    p.add_argument("--compress-thresh", default=0.2, type=float,
                   help="cell-kill threshold of the compress passes")
    p.add_argument("--max_ratio", default=0.95, type=float)
    p.add_argument("--min_ratio", default=0.75, type=float)
    p.add_argument("--pretrained_path", default="", type=str,
                   help="a timm DeiT / ViT state dict to start from")
    p.add_argument("--head_search", action="store_true")
    p.add_argument("--channel_search", action="store_true")
    p.add_argument("--attn_search", action="store_true", default=True)
    p.add_argument("--mlp_search", action="store_true", default=True)
    p.add_argument("--embed_search", action="store_true", default=True)
    p.add_argument("--patch_search", action="store_true", default=True)
    p.add_argument("--freeze_weights", action="store_true")
    p.add_argument("--no-progressive", action="store_true")
    p.add_argument("--no-entropy", action="store_true")
    p.add_argument("--no-var", action="store_true")
    p.add_argument("--no-norm", action="store_true")
    p.add_argument("--norm_pix_loss", action="store_true", default=True)
    p.add_argument("--vis-score", action="store_true")
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--fused-augment", action="store_true", default=True,
                   help="run the train transform inside the train step")
    p.add_argument("--no-fused-augment", action="store_false",
                   dest="fused_augment")
    p.add_argument("--planned-epoch", action="store_true", default=False,
                   help="the epoch's plan on the device, each step one CUDA "
                        "graph replay (needs --cache-device)")
    p.add_argument("--no-planned-epoch", action="store_false",
                   dest="planned_epoch")
    p.add_argument("--cache-device", action="store_true",
                   help="decode the dataset once and keep the uint8 staging "
                        "set in device memory; epochs gather batches there")
    p.add_argument("--cache-device-max-gb", default=12.0, type=float,
                   help="refuse the device cache above this decoded size")
    p.add_argument("--eval-every", default=1, type=int)
    p.add_argument("--ckpt-every", default=1, type=int,
                   help="write running_ckpt every N epochs (the final and "
                        "fuse-point epochs always write)")
    p.add_argument("--tiny-test", action="store_true",
                   help="tiny model/images for smoke tests")
    p.add_argument("--tiny-dims", type=int, nargs=3, default=(32, 2, 2),
                   metavar=("EMBED", "DEPTH", "HEADS"),
                   help="tiny-test model geometry")
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda (the default) raises without a "
                        "card, cpu runs on the CPU")
    p.add_argument("--use-amp", action="store_true",
                   help="[compat] no-op: --compute-dtype sets the precision")
    p.add_argument("--gpu", default="", help="[compat] no-op")
    p.add_argument("--world_size", default=1, type=int,
                   help="[compat] no-op: the world is the launcher's")
    p.add_argument("--dist_url", default="env://", help="[compat] no-op")
    p.add_argument("--dist-eval", action="store_true", help="[compat] no-op")
    p.add_argument("--pin-mem", action="store_true", help="[compat] no-op")
    p.add_argument("--no-pin-mem", action="store_false", dest="pin_mem",
                   help="[compat] no-op")
    return p


def main(args):
    from ..config import (DataConfig, DistillationConfig, MixupConfig,
                          OptimFamilyConfig, ScheduleConfig, SearchConfig)
    from ..core import checkpoint as ckpt
    from ..core.engine import (evaluate, search_one_epoch,
                               search_one_epoch_planned)
    from ..core.optim import (PlateauTracker, build_search_optimizer,
                              make_trainable_mask, named_leaves,
                              set_lr_scale, with_lr_scale)
    from ..core.steps import (TrainState, make_eval_step,
                              make_planned_search_step, make_search_step)
    from ..data.datasets import build_dataset
    from ..data.pipeline import (build_device_cache, device_cache_feed,
                                 device_feed, epoch_plan, make_epoch_loader)
    from ..models.mim_vit import fuse_params
    from ..models.registry import create_model
    from ..ops.flops import model_flops, searched_params_count
    from ..parallel.distributed import reinit_state
    from ..utils.logging import RunLogger, master_print
    from .common import (device_cache_on, distributed_setup, epoch_generator,
                         epoch_seed, tiny_bundle)

    if args.planned_epoch and not (args.cache_device and args.fused_augment):
        raise SystemExit("--planned-epoch gathers its batches from the "
                         "device cache and augments them in the step: it "
                         "needs --cache-device and the fused augment")
    rank, world, dev = distributed_setup(args.device)
    compute = torch.bfloat16 if args.compute_dtype == "bfloat16" \
        else torch.float32

    sched = ScheduleConfig(sched=args.sched, warmup_lr=args.warmup_lr,
                           min_lr=args.min_lr,
                           warmup_epochs=args.warmup_epochs,
                           decay_rate=args.decay_rate)
    scfg = SearchConfig(
        model=args.model, epochs=args.epochs, accum_iter=args.accum_iter,
        fuse_point=args.fuse_point, seed=args.seed,
        start_epoch=args.start_epoch, output_dir=args.output_dir,
        drop=args.drop, drop_path=args.drop_path, mask_ratio=args.mask_ratio,
        mae=args.mae, attn_search=args.attn_search,
        mlp_search=args.mlp_search, embed_search=args.embed_search,
        patch_search=args.patch_search, head_search=args.head_search,
        channel_search=args.channel_search,
        freeze_weights=args.freeze_weights,
        w_head=args.w_head, w_mlp=args.w_mlp, w_patch=args.w_patch,
        w_embedding=args.w_embedding, w_flops=args.w_flops,
        w_decoder=args.w_decoder, target_flops=args.target_flops,
        progressive=not args.no_progressive, entropy=not args.no_entropy,
        var=not args.no_var, norm=not args.no_norm,
        max_ratio=args.max_ratio, min_ratio=args.min_ratio,
        optim_param=OptimFamilyConfig(lr=args.lr, blr=args.blr,
                                      eps=args.opt_eps,
                                      betas=tuple(args.opt_betas),
                                      weight_decay=args.weight_decay),
        optim_arch=OptimFamilyConfig(lr=args.lr_arch, blr=args.blr_arch,
                                     eps=args.opt_eps,
                                     betas=tuple(args.opt_betas_arch),
                                     weight_decay=args.weight_decay_arch),
        optim_decoder=OptimFamilyConfig(
            lr=args.lr_decoder, blr=args.blr_decoder, eps=args.opt_eps,
            betas=tuple(args.opt_betas),
            weight_decay=args.weight_decay_decoder),
        compress_thresh=args.compress_thresh,
        clip_grad=args.clip_grad, schedule=sched,
        model_ema=args.model_ema, model_ema_decay=args.model_ema_decay,
        data=DataConfig(data_path=args.data_path, data_set=args.data_set,
                        input_size=args.input_size,
                        num_workers=args.num_workers,
                        repeated_aug=args.repeated_aug,
                        batch_size=args.batch_size,
                        synthetic_size=args.synthetic_size),
        mixup=MixupConfig(mixup=args.mixup, cutmix=args.cutmix,
                          prob=args.mixup_prob,
                          switch_prob=args.mixup_switch_prob,
                          cutmix_minmax=tuple(args.cutmix_minmax)
                          if args.cutmix_minmax else None,
                          mode=args.mixup_mode,
                          label_smoothing=args.smoothing),
        distillation=DistillationConfig(
            teacher_model=args.teacher_model, teacher_path=args.teacher_path,
            distillation_type=args.distillation_type,
            alpha=args.distillation_alpha, tau=args.distillation_tau),
        resume=args.resume, checkpoint=args.checkpoint,
        pretrained_path=args.pretrained_path,
    ).resolve(world_size=world)

    master_print(scfg)
    np.random.seed(scfg.seed + rank)

    staging = 256 if not args.tiny_test else 40
    out_size = scfg.data.input_size if not args.tiny_test else 32
    ds_train, nb_classes = build_dataset(True, scfg.data, staging)
    ds_val, _ = build_dataset(False, scfg.data, staging)

    cache_train = cache_val = None
    use_cache = device_cache_on(args, world)
    planned = args.planned_epoch and use_cache
    if use_cache:
        t0 = time.time()
        max_bytes = int(args.cache_device_max_gb * 2**30)
        cache_train = build_device_cache(ds_train, max_bytes=max_bytes,
                                         device=dev)
        cache_val = build_device_cache(ds_val, max_bytes=max_bytes,
                                       device=dev)
        gb = (cache_train[0].nbytes + cache_val[0].nbytes) / 2**30
        master_print(f"device cache: {gb:.2f} GiB staged+uploaded "
                     f"in {time.time() - t0:.1f}s")

    if args.tiny_test:
        bundle = tiny_bundle(nb_classes, dev, dims=tuple(args.tiny_dims),
                             drop_path=args.drop_path,
                             patch_search=args.patch_search)
    else:
        bundle = create_model(
            args.model, device=dev, num_classes=nb_classes, mae=args.mae,
            img_size=args.input_size, attn_search=args.attn_search,
            mlp_search=args.mlp_search, embed_search=args.embed_search,
            patch_search=args.patch_search, head_search=args.head_search,
            channel_search=args.channel_search, mask_ratio=args.mask_ratio,
            drop_rate=args.drop, drop_path_rate=args.drop_path)
    cfg, space = bundle.cfg, bundle.space
    params, alphas, arch = bundle.init(scfg.seed)
    if scfg.pretrained_path:
        from ..models.torch_import import torch_state_dict_to_params
        sd = torch.load(scfg.pretrained_path, map_location="cpu",
                        weights_only=True)
        torch_state_dict_to_params(sd.get("model", sd), cfg, params)
        master_print(f"loaded pretrained weights from {scfg.pretrained_path}")

    batch = scfg.data.batch_size * scfg.accum_iter
    steps_per_epoch = len(make_epoch_loader(
        ds_train, epoch=0, rank=rank, world=world, batch_size=batch,
        repeated_aug=scfg.data.repeated_aug, train=True, seed=scfg.seed))
    total_micro = scfg.epochs * steps_per_epoch * scfg.accum_iter
    master_print(f"steps/epoch: {steps_per_epoch} (accum {scfg.accum_iter})")

    sched_arch = None
    if args.min_lr_arch is not None:
        import dataclasses as _dc
        sched_arch = _dc.replace(scfg.schedule, min_lr=args.min_lr_arch)
    tx, _ = build_search_optimizer(
        scfg.optim_param, scfg.optim_arch, scfg.optim_decoder, scfg.schedule,
        total_steps=total_micro,
        steps_per_epoch=steps_per_epoch * scfg.accum_iter,
        clip_grad=scfg.clip_grad, accum_iter=scfg.accum_iter,
        sched_arch=sched_arch)
    plateau = PlateauTracker(patience=args.patience_epochs,
                             decay_rate=args.decay_rate) \
        if args.sched == "plateau" else None
    if plateau is not None:
        tx = with_lr_scale(tx)

    ema = {n: p.detach().clone() for n, p in params.named_parameters()} \
        if scfg.model_ema else None
    state = TrainState(step=0, params=params, alphas=alphas, arch=arch,
                       opt_state=tx.init(named_leaves(params, alphas)),
                       ema_params=ema)

    start_epoch = scfg.start_epoch
    if scfg.resume and scfg.checkpoint:
        restored = ckpt.load_checkpoint(
            scfg.checkpoint, params=state.params, alphas=state.alphas,
            arch=state.arch, opt_state=state.opt_state, ema_params=ema)
        start_epoch = restored["meta"].get("epoch", -1) + 1
        master_print(f"resumed from {scfg.checkpoint} at epoch {start_epoch}")
    reinit_state(state)
    finish_search = state.arch.all_finished

    pmask, amask = make_trainable_mask(
        state.params, state.alphas, freeze_weights=scfg.freeze_weights,
        w_head=scfg.w_head, w_mlp=scfg.w_mlp, w_patch=scfg.w_patch,
        w_embedding=scfg.w_embedding)

    teacher_apply = None
    if scfg.distillation.distillation_type != "none":
        from ..models.teacher import build_teacher
        teacher_apply = build_teacher(
            scfg.distillation.teacher_model,
            teacher_path=scfg.distillation.teacher_path,
            num_classes=nb_classes, compute_dtype=compute, device=dev)

    def build_step(phase):
        common = dict(phase=phase, param_mask=pmask, alpha_mask=amask,
                      teacher_apply=teacher_apply, compute_dtype=compute,
                      use_randaug=bool(args.aa), re_prob=args.reprob,
                      crop_scale=(args.min_crop_scale, 1.0),
                      hflip=args.hflip, fused_model=bool(state.arch.fused),
                      device=dev)
        if planned:
            return make_planned_search_step(
                space, cfg, scfg, tx, steps_per_epoch=steps_per_epoch,
                **common)
        return make_search_step(space, cfg, scfg, tx,
                                fused_augment=args.fused_augment,
                                **common), None

    step_fn, step_keys = build_step("postsearch" if finish_search
                                    else "search")
    if planned:
        master_print("planned-epoch loop: the epoch's plan on the device, "
                     "one step call an iteration")
        plan_gen = torch.Generator(device=dev)
    eval_step = make_eval_step(space, cfg, compute_dtype=compute, device=dev)

    def make_val_feed():
        if cache_val is not None:
            return device_cache_feed(
                *cache_val, epoch=0, rank=rank, world=world,
                batch_size=scfg.data.batch_size, repeated_aug=False,
                train=False, seed=scfg.seed, out_size=out_size)
        vloader = make_epoch_loader(
            ds_val, epoch=0, rank=rank, world=world,
            batch_size=scfg.data.batch_size, repeated_aug=False,
            train=False, seed=scfg.seed)
        return device_feed(vloader, train=False, out_size=out_size,
                           device=dev)

    logger = RunLogger(scfg.output_dir)
    aug = dict(use_randaug=bool(args.aa), re_prob=args.reprob,
               crop_scale=(args.min_crop_scale, 1.0), hflip=args.hflip,
               raw=args.fused_augment)
    max_soft_acc = 0.0
    first_finish = not finish_search
    t_start = time.time()

    for epoch in range(start_epoch, scfg.epochs):
        if finish_search and first_finish:
            first_finish = False
            step_fn, step_keys = build_step("postsearch")
            max_soft_acc = 0.0
            master_print("== finish_search: PMIM off, decoder frozen, "
                         "mixup/cutmix on, soft-target CE ==")

        was_finished = finish_search
        if planned:
            # one generator for the run, reseeded each epoch: a captured
            # step draws from the generator it was captured with
            plan_gen.manual_seed(epoch_seed(scfg.seed, epoch))
            batches = epoch_plan(
                int(cache_train[0].shape[0]), epoch=epoch, rank=rank,
                world=world,
                batch_size=batch, repeated_aug=scfg.data.repeated_aug,
                train=True, seed=scfg.seed)
            state, train_stats, finish_search, pruned = \
                search_one_epoch_planned(
                    state, step_fn, step_keys, cache_train[0],
                    cache_train[1], batches, epoch=epoch, scfg=scfg,
                    space=space, generator=plan_gen,
                    finish_search=finish_search)
        else:
            gen = epoch_generator(dev, scfg.seed, epoch)
            if cache_train is not None:
                feed = device_cache_feed(
                    *cache_train, generator=gen, epoch=epoch, rank=rank,
                    world=world, batch_size=batch,
                    repeated_aug=scfg.data.repeated_aug, train=True,
                    seed=scfg.seed, accum_iter=scfg.accum_iter,
                    out_size=out_size, **aug)
            else:
                loader = make_epoch_loader(
                    ds_train, epoch=epoch, rank=rank, world=world,
                    batch_size=batch,
                    repeated_aug=scfg.data.repeated_aug, train=True,
                    seed=scfg.seed,
                    num_workers=scfg.data.num_workers if not args.tiny_test
                    else 0)
                feed = device_feed(loader, generator=gen, train=True,
                                   accum_iter=scfg.accum_iter,
                                   out_size=out_size, device=dev, **aug)
            state, train_stats, finish_search, pruned = search_one_epoch(
                state, step_fn, feed, epoch=epoch,
                steps_per_epoch=steps_per_epoch, scfg=scfg, space=space,
                generator=gen, finish_search=finish_search)
        if finish_search and not was_finished:
            first_finish = True

        if scfg.output_dir:
            meta = {"epoch": epoch, "finish_search": bool(finish_search),
                    "args": vars(args)}
            if finish_search and pruned:
                ckpt.save_checkpoint(
                    os.path.join(scfg.output_dir, "model_pruned"),
                    params=state.params, alphas=state.alphas,
                    arch=state.arch, meta=meta)
            if epoch % args.ckpt_every == 0 or epoch == scfg.epochs - 1 \
                    or epoch == scfg.fuse_point:
                ckpt.save_checkpoint(
                    os.path.join(scfg.output_dir, "running_ckpt"),
                    params=state.params, alphas=state.alphas, arch=state.arch,
                    opt_state=state.opt_state, ema_params=state.ema_params,
                    meta=meta, async_write=True)
            if args.vis_score and not finish_search:
                logger.save_score_maps(state.params, state.alphas,
                                       state.arch, space)

        if epoch % args.eval_every == 0 or epoch == scfg.epochs - 1:
            test_stats = evaluate(eval_step, make_val_feed(), state.params,
                                  state.alphas, state.arch)
            master_print(f"Soft accuracy: {test_stats['acc1']:.2f}% "
                         f"(max {max(max_soft_acc, test_stats['acc1']):.2f}%)")
            if test_stats["acc1"] >= max_soft_acc and scfg.output_dir:
                ckpt.save_checkpoint(
                    os.path.join(scfg.output_dir, "best"),
                    params=state.params, alphas=state.alphas,
                    arch=state.arch, ema_params=state.ema_params,
                    meta={"epoch": epoch, "acc1": test_stats["acc1"],
                          "finish_search": bool(finish_search),
                          "args": vars(args)})
            max_soft_acc = max(max_soft_acc, test_stats["acc1"])
            if plateau is not None:
                set_lr_scale(state.opt_state,
                             plateau.update(test_stats["acc1"]))
            with torch.no_grad():
                _, searched_p = searched_params_count(state.alphas,
                                                      state.arch, space, cfg)
                _, gflops = model_flops(state.alphas, state.arch, space, cfg)
            logger.log_epoch(epoch, train_stats, test_stats,
                             n_parameters=int(searched_p),
                             n_gflops=float(gflops))
            if not finish_search:
                logger.log_alphas(epoch, state.alphas)

        if epoch == scfg.fuse_point:
            master_print(f"breaking at fuse_point {scfg.fuse_point}")
            break

    # fuse the best checkpoint (when it was written after finish_search),
    # evaluate the fused net, save model_fused
    if finish_search:
        # every rank reads best/ as rank 0 wrote it
        ckpt.commit_saves("search best written")
        bparams, balphas, barch = (copy.deepcopy(state.params),
                                   copy.deepcopy(state.alphas),
                                   copy.deepcopy(state.arch))
        best_epoch = -1
        best_dir = os.path.join(scfg.output_dir, "best") \
            if scfg.output_dir else ""
        best_meta = ckpt.latest_meta(best_dir) if best_dir else None
        if best_meta is not None and best_meta.get("finish_search", False):
            ckpt.load_checkpoint(best_dir, params=bparams, alphas=balphas,
                                 arch=barch)
            best_epoch = best_meta.get("epoch", -1)
            master_print(f"fusing best checkpoint (epoch {best_epoch}, "
                         f"acc1 {best_meta.get('acc1', 0.0):.2f}%)")
        elif best_meta is not None:
            master_print("best checkpoint predates finish_search; "
                         "fusing final-epoch state instead")
        fparams, farch = fuse_params(bparams, barch, space, cfg)
        fused_eval = make_eval_step(space, cfg, compute_dtype=compute,
                                    fused=True, device=dev)
        fstats = evaluate(fused_eval, make_val_feed(), fparams, balphas,
                          farch, header="Fused:")
        if scfg.output_dir:
            ckpt.save_checkpoint(
                os.path.join(scfg.output_dir, "model_fused"),
                params=fparams, alphas=balphas, arch=farch,
                meta={"fused": True, "best_epoch": best_epoch,
                      "fused_acc1": fstats["acc1"]})
            master_print("saved model_fused")

    ckpt.commit_saves("search checkpoints committed")
    master_print(f"Training time "
                 f"{time.strftime('%H:%M:%S', time.gmtime(time.time() - t_start))}")
    return state


if __name__ == "__main__":
    from ..utils.resilience import run_with_auto_resume
    parser = argparse.ArgumentParser("OFB search (PyTorch port)",
                                     parents=[get_args_parser()])
    run_with_auto_resume(main, parser.parse_args())
