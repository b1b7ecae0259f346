"""OFB-Swin search CLI of the port: the flags and flow of
scripts/search_swin.py on one GPU.

Searches the gated Swin supernet (window attention and MLP widths per
block, with --embed_search the residual width of every stage) through the
classic epoch loop or, with --cache-device --planned-epoch, the planned
one (each step one CUDA graph replay on the card), with the compress
passes in the loop and the postsearch phase after the finish. Each epoch
writes running_ckpt (every --ckpt-every epochs, the last one and any with
a prune event) and, on a better soft accuracy, best/. --force-finish
converges what is still open by repeated compress(thresh=1.0) passes on
the best checkpoint; a finished search is exported (`model_exported`,
the sliced subnet, evaluated through the plain forward) and, with
--export-finetune-epochs N, finetuned for N epochs (`model_finetuned`,
the weights of its best eval). --resume (or an auto-resume after a
transient failure) continues from running_ckpt with the best accuracy
read from best/.

  python -m ofb_tpu_torch.cli.search_swin --data-set SYNTHETIC \\
      --tiny-test --device cpu --compute-dtype float32 --epochs 2 \\
      --batch-size 8 --output_dir runs/swin_smoke

--device defaults to cuda and raises without a card. Under `torchrun`
each process takes its rank's shard of the plan (--batch-size per process,
the learning rates scaled by the world), the steps average their gradients
over the ranks, every rank takes rank 0's compress decisions and rank 0
writes; --cache-device is single-process only.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import os
import time

import numpy as np
import torch


def get_args_parser():
    p = argparse.ArgumentParser("OFB Swin search (PyTorch port)",
                                add_help=False)
    p.add_argument("--batch-size", default=128, type=int)
    p.add_argument("--epochs", default=100, type=int)
    p.add_argument("--accum-iter", default=1, type=int)
    p.add_argument("--model", default="swin_tiny_patch4_window7_224_mim")
    p.add_argument("--input-size", default=224, type=int)
    p.add_argument("--drop-path", type=float, default=0.1)
    p.add_argument("--blr", type=float, default=2.5e-4)
    p.add_argument("--blr_arch", type=float, default=2.5e-4)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--warmup-lr", type=float, default=1e-6)
    p.add_argument("--min-lr", type=float, default=1e-5)
    p.add_argument("--min-lr-arch", type=float, default=None,
                   help="LR floor of the arch schedule only (absolute)")
    p.add_argument("--warmup-epochs", type=int, default=20)
    p.add_argument("--sched", default="cosine", type=str)
    p.add_argument("--weight-decay", type=float, default=1e-3)
    p.add_argument("--smoothing", type=float, default=0.1)
    p.add_argument("--aa", type=str, default="rand-m9-mstd0.5-inc1")
    p.add_argument("--reprob", type=float, default=0.25)
    p.add_argument("--min-crop-scale", type=float, default=0.08)
    p.add_argument("--no-hflip", action="store_false", dest="hflip",
                   default=True)
    p.add_argument("--repeated-aug", action="store_true", default=True)
    p.add_argument("--no-repeated-aug", action="store_false",
                   dest="repeated_aug")
    p.add_argument("--data-path", default="", type=str)
    p.add_argument("--data-set", default="IMNET",
                   choices=["CIFAR10", "CIFAR100", "IMNET", "IMNET100",
                            "INAT", "INAT19", "SYNTHETIC", "DIGITS"])
    p.add_argument("--synthetic-size", type=int, default=2048,
                   help="samples per epoch when --data-set SYNTHETIC")
    p.add_argument("--output_dir", default="runs/swin_search")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--num_workers", default=4, type=int)
    p.add_argument("--w_head", default=0.5, type=float)
    p.add_argument("--w_mlp", default=0.5, type=float)
    p.add_argument("--w_embedding", default=0.5, type=float)
    p.add_argument("--w_flops", default=5, type=float)
    p.add_argument("--target_flops", default=1.0, type=float)
    p.add_argument("--compress-thresh", default=0.2, type=float)
    p.add_argument("--attn_search", action="store_true", default=True)
    p.add_argument("--no-attn_search", action="store_false",
                   dest="attn_search")
    p.add_argument("--mlp_search", action="store_true", default=True)
    p.add_argument("--no-mlp_search", action="store_false",
                   dest="mlp_search")
    p.add_argument("--embed_search", action="store_true", default=False)
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--eval-every", default=1, type=int)
    p.add_argument("--ckpt-every", default=5, type=int,
                   help="write running_ckpt every N epochs (the final epoch "
                        "and any epoch with a prune event always write)")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint (default "
                        "<output_dir>/running_ckpt)")
    p.add_argument("--checkpoint", default="", type=str)
    p.add_argument("--auto-resume", default=2, type=int,
                   help="on a transient failure, re-exec with --resume "
                        "--checkpoint <output_dir>/running_ckpt up to N "
                        "times; 0 disables")
    p.add_argument("--tiny-test", action="store_true")
    p.add_argument("--cache-device", action="store_true",
                   help="decode the dataset once and keep the uint8 staging "
                        "set in device memory")
    p.add_argument("--cache-device-max-gb", default=12.0, type=float)
    p.add_argument("--planned-epoch", action="store_true", default=False,
                   help="with --cache-device: the epoch's plan on the "
                        "device, each step one CUDA graph replay")
    p.add_argument("--no-planned-epoch", action="store_false",
                   dest="planned_epoch")
    p.add_argument("--force-finish", action="store_true",
                   help="if the search has not converged by the last epoch, "
                        "force every module to its argmax cell by repeated "
                        "compress(1.0) passes so that the subnet exports")
    p.add_argument("--export-finetune-epochs", default=0, type=int,
                   help="finetune the exported subnet for N epochs")
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda (the default) raises without a "
                        "card, cpu runs on the CPU")
    return p


def main(args):
    from ..config import (DataConfig, MixupConfig, OptimFamilyConfig,
                          ScheduleConfig, SearchConfig)
    from ..core import checkpoint as ckpt
    from ..core.compress import compress
    from ..core.engine import (evaluate, search_one_epoch,
                               search_one_epoch_planned)
    from ..core.optim import build_search_optimizer, named_leaves
    from ..core.steps import TrainState
    from ..core.swin_steps import (make_planned_swin_search_step,
                                   make_swin_eval_step,
                                   make_swin_eval_step_dense,
                                   make_swin_search_step)
    from ..data.datasets import build_dataset
    from ..data.pipeline import (build_device_cache, device_cache_feed,
                                 device_feed, epoch_plan, make_epoch_loader)
    from ..models.swin_search import export_swin_subnet
    from ..parallel.distributed import reinit_state
    from ..utils.logging import RunLogger, master_print
    from .common import (device_cache_on, distributed_setup, epoch_generator,
                         epoch_seed, swin_supernet_bundle)

    if args.planned_epoch and not args.cache_device:
        raise SystemExit("--planned-epoch gathers its batches from the "
                         "device cache: it needs --cache-device")
    rank, world, dev = distributed_setup(args.device)
    compute = torch.bfloat16 if args.compute_dtype == "bfloat16" \
        else torch.float32

    sched = ScheduleConfig(sched=args.sched, warmup_lr=args.warmup_lr,
                           min_lr=args.min_lr,
                           warmup_epochs=args.warmup_epochs)
    scfg = SearchConfig(
        model=args.model, epochs=args.epochs, accum_iter=args.accum_iter,
        seed=args.seed, output_dir=args.output_dir, w_head=args.w_head,
        w_mlp=args.w_mlp, w_embedding=args.w_embedding, w_flops=args.w_flops,
        target_flops=args.target_flops, compress_thresh=args.compress_thresh,
        optim_param=OptimFamilyConfig(lr=args.lr, blr=args.blr,
                                      weight_decay=args.weight_decay),
        optim_arch=OptimFamilyConfig(lr=args.lr, blr=args.blr_arch,
                                     betas=(0.5, 0.999)),
        optim_decoder=OptimFamilyConfig(lr=args.lr, blr=args.blr),
        schedule=sched, mixup=MixupConfig(label_smoothing=args.smoothing),
        data=DataConfig(data_path=args.data_path, data_set=args.data_set,
                        input_size=args.input_size,
                        num_workers=args.num_workers,
                        repeated_aug=args.repeated_aug,
                        batch_size=args.batch_size,
                        synthetic_size=args.synthetic_size),
    ).resolve(world_size=world)
    np.random.seed(scfg.seed + rank)

    staging = 256 if not args.tiny_test else 40
    out_size = args.input_size if not args.tiny_test else 32
    scfg.data.input_size = out_size
    ds_train, nb_classes = build_dataset(True, scfg.data, staging)
    ds_val, _ = build_dataset(False, scfg.data, staging)
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

    bundle = swin_supernet_bundle(vars(args), args.model, nb_classes, dev)
    cfg, space = bundle.cfg, bundle.space
    params, alphas, arch = bundle.init(scfg.seed)

    batch = args.batch_size * scfg.accum_iter
    steps_per_epoch = len(make_epoch_loader(
        ds_train, epoch=0, rank=rank, world=world, batch_size=batch,
        repeated_aug=args.repeated_aug, train=True, seed=scfg.seed))
    total_micro = scfg.epochs * steps_per_epoch * scfg.accum_iter
    master_print(f"swin search: steps/epoch {steps_per_epoch} "
                 f"(accum {scfg.accum_iter})")
    sched_arch = None
    if args.min_lr_arch is not None:
        sched_arch = dataclasses.replace(scfg.schedule,
                                         min_lr=args.min_lr_arch)
    tx, _ = build_search_optimizer(
        scfg.optim_param, scfg.optim_arch, scfg.optim_decoder, scfg.schedule,
        total_steps=total_micro,
        steps_per_epoch=steps_per_epoch * scfg.accum_iter,
        accum_iter=scfg.accum_iter, sched_arch=sched_arch)
    state = TrainState(step=0, params=params, alphas=alphas, arch=arch,
                       opt_state=tx.init(named_leaves(params, alphas)))

    start_epoch = 0
    max_acc = 0.0
    if args.resume:
        rdir = args.checkpoint or os.path.join(scfg.output_dir,
                                               "running_ckpt")
        restored = ckpt.load_checkpoint(rdir, params=params, alphas=alphas,
                                        arch=arch, opt_state=state.opt_state)
        start_epoch = restored["meta"].get("epoch", -1) + 1
        state.step.fill_(start_epoch * steps_per_epoch * scfg.accum_iter)
        master_print(f"resumed from {rdir} at epoch {start_epoch}")
        # the best so far, so that the first eval after the resume cannot
        # overwrite best/ with worse weights
        bmeta = ckpt.latest_meta(os.path.join(scfg.output_dir, "best")) \
            if scfg.output_dir else None
        max_acc = float(bmeta["acc1"]) if bmeta and "acc1" in bmeta else 0.0
    reinit_state(state)

    aug = dict(use_randaug=bool(args.aa), re_prob=args.reprob,
               crop_scale=(args.min_crop_scale, 1.0), hflip=args.hflip)
    steps = {}

    def search_step(phase):
        if phase not in steps:
            if planned:
                steps[phase] = make_planned_swin_search_step(
                    space, cfg, scfg, tx, phase=phase,
                    steps_per_epoch=steps_per_epoch, compute_dtype=compute,
                    device=dev, **aug)
            else:
                steps[phase] = (make_swin_search_step(
                    space, cfg, scfg, tx, phase=phase, compute_dtype=compute,
                    device=dev), None)
        return steps[phase]

    if planned:
        master_print("planned-epoch loop: one step call an iteration")
        plan_gen = torch.Generator(device=dev)
    eval_step = make_swin_eval_step(space, cfg, compute_dtype=compute,
                                    device=dev)
    logger = RunLogger(scfg.output_dir)

    def train_feed(epoch, gen, *, batch, ra, accum):
        if cache_train is not None:
            return device_cache_feed(
                *cache_train, generator=gen, epoch=epoch, rank=rank,
                world=world, batch_size=batch, repeated_aug=ra, train=True,
                seed=scfg.seed, accum_iter=accum, out_size=out_size, **aug)
        loader = make_epoch_loader(
            ds_train, epoch=epoch, rank=rank, world=world,
            batch_size=batch, repeated_aug=ra, train=True, seed=scfg.seed,
            num_workers=args.num_workers if not args.tiny_test else 0)
        return device_feed(loader, generator=gen, train=True,
                           accum_iter=accum, out_size=out_size, device=dev,
                           **aug)

    def val_feed():
        if cache_val is not None:
            return device_cache_feed(
                *cache_val, epoch=0, rank=rank, world=world,
                batch_size=args.batch_size, repeated_aug=False, train=False,
                seed=scfg.seed, out_size=out_size)
        vloader = make_epoch_loader(ds_val, epoch=0, rank=rank, world=world,
                                    batch_size=args.batch_size,
                                    repeated_aug=False, train=False,
                                    seed=scfg.seed)
        return device_feed(vloader, train=False, out_size=out_size,
                           device=dev)

    def plan(n, epoch, batch, ra):
        return epoch_plan(n, epoch=epoch, rank=rank, world=world,
                          batch_size=batch, repeated_aug=ra, train=True,
                          seed=scfg.seed)

    run_meta = {"family": "swin", "args": vars(args),
                "model_cfg": dataclasses.asdict(cfg)}
    finish_search = state.arch.all_finished
    t0 = time.time()
    for epoch in range(start_epoch, scfg.epochs):
        step_fn, keys = search_step("postsearch" if finish_search
                                    else "search")
        if planned:
            plan_gen.manual_seed(epoch_seed(scfg.seed, epoch))
            state, stats, finish_search, pruned = search_one_epoch_planned(
                state, step_fn, keys, cache_train[0], cache_train[1],
                plan(int(cache_train[0].shape[0]), epoch, batch,
                     args.repeated_aug),
                epoch=epoch, scfg=scfg, space=space, generator=plan_gen,
                finish_search=finish_search)
        else:
            gen = epoch_generator(dev, scfg.seed, epoch)
            feed = train_feed(epoch, gen, batch=batch, ra=args.repeated_aug,
                              accum=scfg.accum_iter)
            state, stats, finish_search, pruned = search_one_epoch(
                state, step_fn, feed, epoch=epoch,
                steps_per_epoch=steps_per_epoch, scfg=scfg, space=space,
                generator=gen, finish_search=finish_search)

        if scfg.output_dir and (epoch % max(args.ckpt_every, 1) == 0
                                or epoch == scfg.epochs - 1 or pruned):
            ckpt.save_checkpoint(
                os.path.join(scfg.output_dir, "running_ckpt"),
                params=state.params, alphas=state.alphas, arch=state.arch,
                opt_state=state.opt_state,
                meta={"epoch": epoch, "finish_search": bool(finish_search),
                      **run_meta}, async_write=True)
        if epoch % args.eval_every == 0 or epoch == scfg.epochs - 1:
            test_stats = evaluate(eval_step, val_feed(), state.params,
                                  state.alphas, state.arch)
            if test_stats["acc1"] >= max_acc and scfg.output_dir:
                ckpt.save_checkpoint(
                    os.path.join(scfg.output_dir, "best"),
                    params=state.params, alphas=state.alphas,
                    arch=state.arch,
                    meta={"epoch": epoch, "acc1": test_stats["acc1"],
                          "finish_search": bool(finish_search), **run_meta})
            max_acc = max(max_acc, test_stats["acc1"])
            logger.log_epoch(epoch, stats, test_stats, 0, 0.0)

    if not finish_search and args.force_finish:
        # export from the best checkpoint, not the final epoch: late
        # arch-loss pressure degrades the classifier
        best_dir = os.path.join(scfg.output_dir, "best") \
            if scfg.output_dir else ""
        # every rank reads best/ as rank 0 wrote it
        ckpt.commit_saves("swin search best written")
        if best_dir and ckpt.latest_meta(best_dir) is not None:
            bmeta = ckpt.load_checkpoint(
                best_dir, params=state.params, alphas=state.alphas,
                arch=state.arch)["meta"]
            master_print(f"export from best (epoch {bmeta.get('epoch')}, "
                         f"acc1 {bmeta.get('acc1', 0.0):.2f}%)")
        guard = 0
        while not state.arch.all_finished and guard < 20:
            _, _, _, _, rep = compress(state.params, state.alphas,
                                       state.arch, None, space, thresh=1.0)
            guard += 1
            master_print("force-finish:",
                         "; ".join(rep.events) or "(no event)")
        finish_search = state.arch.all_finished

    if finish_search and scfg.output_dir:
        dense, dcfg, meta = export_swin_subnet(state.params, state.arch,
                                               space, cfg)
        dense_eval = make_swin_eval_step_dense(dcfg, compute_dtype=compute,
                                               device=dev)
        exp_stats = evaluate(dense_eval, val_feed(), dense)
        master_print(f"exported subnet acc1 {exp_stats['acc1']:.2f}% "
                     f"(supernet best {max_acc:.2f}%)")
        sub_meta = {"exported": True, "family": "swin",
                    "model_cfg": dataclasses.asdict(dcfg), **meta}
        ckpt.save_checkpoint(
            os.path.join(scfg.output_dir, "model_exported"), params=dense,
            meta={**sub_meta, "acc1": exp_stats["acc1"],
                  "supernet_best_acc1": max_acc})
        master_print("saved model_exported (sliced Swin subnet)")

        if args.export_finetune_epochs > 0:
            ft_best, ft_best_params = _finetune_subnet(
                args, dense, dcfg, steps_per_epoch * scfg.accum_iter,
                compute=compute, device=dev, world=world,
                planned=planned, cache_train=cache_train,
                train_feed=train_feed, val_feed=val_feed, plan=plan,
                dense_eval=dense_eval)
            master_print(f"finetuned subnet acc1 {ft_best:.2f}% "
                         f"(exported {exp_stats['acc1']:.2f}%, supernet "
                         f"best {max_acc:.2f}%)")
            ckpt.save_checkpoint(
                os.path.join(scfg.output_dir, "model_finetuned"),
                params=ft_best_params, meta={**sub_meta, "acc1": ft_best})

    ckpt.commit_saves("swin search checkpoints committed")
    master_print(f"Swin search time "
                 f"{time.strftime('%H:%M:%S', time.gmtime(time.time() - t0))}")
    return state


def _finetune_subnet(args, dense, dcfg, ft_steps_per_epoch, *, compute,
                     device, world, planned, cache_train, train_feed,
                     val_feed, plan, dense_eval):
    """The export finetune: cosine AdamW (weight decay 0.05, lr blr x
    batch x world / 256, warmup min(5, epochs // 4)) of the sliced subnet,
    one microbatch a step. Returns (best acc1, a copy of the weights that
    reached it)."""
    from ..config import ScheduleConfig
    from ..core.engine import (evaluate, train_one_epoch,
                               train_one_epoch_planned)
    from ..core.optim import adamw, cosine_schedule
    from ..core.steps import TrainState
    from ..core.swin_steps import (make_planned_swin_train_step,
                                   make_swin_train_step_dense)
    from .common import epoch_generator, epoch_seed

    epochs = args.export_finetune_epochs
    lr = (args.blr or 2.5e-4) * args.batch_size * world / 256
    sch = cosine_schedule(
        lr, ScheduleConfig(warmup_lr=1e-6, min_lr=1e-6,
                           warmup_epochs=min(5, epochs // 4)),
        epochs * ft_steps_per_epoch, ft_steps_per_epoch)
    ftx = adamw(sch, weight_decay=0.05)
    fstate = TrainState(step=0, params=dense, alphas=None, arch=None,
                        opt_state=ftx.init(dict(dense.named_parameters())))
    aug = dict(use_randaug=bool(args.aa), re_prob=args.reprob,
               crop_scale=(args.min_crop_scale, 1.0), hflip=args.hflip)
    if planned:
        ft_step = make_planned_swin_train_step(
            dcfg, ftx, smoothing=args.smoothing, compute_dtype=compute,
            device=device, **aug)
        gen = torch.Generator(device=device)
    else:
        ft_step = make_swin_train_step_dense(
            dcfg, ftx, smoothing=args.smoothing, compute_dtype=compute,
            device=device)
    best, best_params = 0.0, copy.deepcopy(dense)
    for fe in range(epochs):
        seed = args.seed + 777
        if planned:
            gen.manual_seed(epoch_seed(seed, fe))
            fstate, _ = train_one_epoch_planned(
                fstate, ft_step, cache_train[0], cache_train[1],
                plan(int(cache_train[0].shape[0]), fe, args.batch_size,
                     False), epoch=fe, generator=gen)
        else:
            g = epoch_generator(device, seed, fe)
            fstate, _ = train_one_epoch(
                fstate, ft_step, train_feed(fe, g, batch=args.batch_size,
                                            ra=False, accum=1),
                epoch=fe, steps_per_epoch=ft_steps_per_epoch, generator=g)
        if fe % max(args.eval_every, 1) == 0 or fe == epochs - 1:
            stats = evaluate(dense_eval, val_feed(), fstate.params)
            if stats["acc1"] >= best:
                # the weights that reached the recorded acc1
                best = stats["acc1"]
                best_params = copy.deepcopy(fstate.params)
    return best, best_params


if __name__ == "__main__":
    from ..utils.resilience import run_with_auto_resume
    parser = argparse.ArgumentParser("OFB Swin search (PyTorch port)",
                                     parents=[get_args_parser()])
    run_with_auto_resume(main, parser.parse_args())
