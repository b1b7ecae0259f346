"""Train, search and eval steps of the searchable Swin family.

Port of ofb_tpu/core/swin_steps.py: the gated supernet forward, CE, the
adaptive one-hot sparsity losses and the FLOPs target, the search
optimizer (its decoder family unused: the Swin search trains supervised,
without the PMIM decoder), gradient accumulation and the freeze of
converged alphas. Phase 'postsearch' drops the arch loss and mixes the
images (Mixup 0.8 / CutMix 1.0, soft-target CE). The steps share
`core/steps.py`'s state, accumulation, update and planned-step machinery
and update the state in place; randomness comes from a generator or is
handed in (`mixup_draws=`, `augment_draws=`).
"""

from __future__ import annotations

import torch

from ..config import SearchConfig
from ..device import resolve_device
from ..models.search_space import SearchSpace
from ..models.swin import SwinCfg, swin_forward
from ..models.swin_search import swin_model_flops, swin_search_forward
from . import losses as L
from .optim import named_leaves
from .steps import (PlannedStep, TrainState, _accumulate, _apply, _augmenter,
                    _averaged, _cls_metrics, _finished_alpha_names, _gather,
                    _mixed)

SWIN_METRIC_KEYS_SEARCH = ("loss_param", "loss_total", "loss_arch",
                           "searched_gflops", "grad_norm")
SWIN_METRIC_KEYS_POSTSEARCH = ("loss_param", "loss_total", "grad_norm")


def swin_arch_loss(params, alphas, arch, space: SearchSpace, cfg: SwinCfg,
                   *, target_flops: float, w_head: float, w_mlp: float,
                   w_embedding: float, w_flops: float, entropy=True,
                   var=True, norm=True):
    """Weighted arch loss over the Swin layout: (loss, {"searched_gflops"})."""
    total, searched = swin_model_flops(alphas, arch, space, cfg)
    fl = torch.square((searched - target_flops) / total)
    sp = L.sparsity_losses(params, alphas, arch, space, entropy=entropy,
                           var=var, norm=norm)
    arch_total = (w_head * sp["attn"] + w_mlp * sp["mlp"]
                  + w_embedding * sp["embed"] + w_flops * fl)
    return arch_total, {"searched_gflops": searched}


def make_swin_search_step(space: SearchSpace, cfg: SwinCfg,
                          scfg: SearchConfig, tx, *, phase: str = "search",
                          teacher_apply=None, compute_dtype=torch.bfloat16,
                          fused_augment: bool = False,
                          use_randaug: bool = True, re_prob: float = 0.25,
                          crop_scale=(0.08, 1.0), hflip: bool = True,
                          device="cuda"):
    """The Swin supernet's step on `device` (default "cuda"; raises without
    a card unless device="cpu" is asked for).

    Returns step(state, images (A, mb, H, W, 3), labels (A, mb),
    generator=None, keep_ratio=None, mixup_draws=None, augment_draws=None)
    -> (state, metrics). `keep_ratio` is taken and unused (the classic
    search loop hands every step the PMIM ratio; Swin has no PMIM).
    Drop-path draws from `generator` (none without one); `mixup_draws`
    (one per microbatch) replaces the postsearch phase's Mixup draws, and
    `fused_augment` / `augment_draws` are `core.steps.make_search_step`'s.
    `teacher_apply` (images -> fp32 logits) adds `scfg.distillation`'s
    loss on the images the student saw."""
    if phase not in ("search", "postsearch"):
        raise ValueError(f"phase {phase!r} (search | postsearch)")
    dev = resolve_device(device)
    augment = _augmenter(fused_augment, cfg.img_size, use_randaug, re_prob,
                         crop_scale, hflip)
    dcfg = scfg.distillation

    def loss_fn(state: TrainState, images, labels, generator, draws):
        soft = False
        if phase == "postsearch":
            images, labels = _mixed(
                images, labels, generator, draws, scfg.mixup,
                num_classes=cfg.num_classes, mixup_alpha=0.8,
                cutmix_alpha=1.0)
            soft = True
        logits = swin_search_forward(
            state.params, state.alphas, state.arch, images, cfg, space,
            train=True, generator=generator, compute_dtype=compute_dtype)
        base = L.base_criterion(logits, labels, soft_labels=soft,
                                smoothing=scfg.mixup.label_smoothing)
        if teacher_apply is not None and dcfg.distillation_type != "none":
            base = L.distillation_loss(
                base, logits, teacher_apply(images),
                kind=dcfg.distillation_type, alpha=dcfg.alpha, tau=dcfg.tau)
        metrics = {"loss_param": base}
        total = base
        if phase == "search":
            arch_loss, aux = swin_arch_loss(
                state.params, state.alphas, state.arch, space, cfg,
                target_flops=scfg.target_flops, w_head=scfg.w_head,
                w_mlp=scfg.w_mlp, w_embedding=scfg.w_embedding,
                w_flops=scfg.w_flops, entropy=scfg.entropy, var=scfg.var,
                norm=scfg.norm)
            total = total + arch_loss
            metrics.update(loss_arch=arch_loss,
                           searched_gflops=aux["searched_gflops"])
        metrics["loss_total"] = total
        return total, metrics

    def step(state: TrainState, images, labels, generator=None,
             keep_ratio=None, mixup_draws=None, augment_draws=None):
        A = images.shape[0]
        images = augment(images, generator, augment_draws, dev) \
            if augment is not None else images.to(dev)
        labels = labels.to(dev)
        leaves = named_leaves(state.params, state.alphas)

        def micro(a):
            return loss_fn(state, images[a], labels[a], generator,
                           mixup_draws[a] if mixup_draws is not None
                           else None)

        grads, metrics = _averaged(leaves, A, _accumulate(leaves, A, micro))
        wnorms = torch._foreach_norm(
            [g for n, g in grads.items() if not n.startswith("alphas.")])
        metrics["grad_norm"] = torch.linalg.vector_norm(torch.stack(wnorms))
        with torch.no_grad():
            updates, state.opt_state = tx.update(grads, state.opt_state,
                                                 leaves)
            for n, f in _finished_alpha_names(state.alphas, state.arch):
                updates[n] = updates[n] * (1.0 - f.float())
            _apply(leaves, updates, None, state.params, None)
        state.step += A
        return state, metrics

    return step


def make_swin_train_step_dense(cfg: SwinCfg, tx, *, smoothing: float = 0.1,
                               compute_dtype=torch.bfloat16,
                               fused_augment: bool = False,
                               use_randaug: bool = True,
                               re_prob: float = 0.25, crop_scale=(0.08, 1.0),
                               hflip: bool = True, device="cuda"):
    """Plain supervised step of a dense (gate-free) Swin, a stock one or an
    exported subnet: step(state, images (A, mb, H, W, 3), labels (A, mb),
    generator=None, augment_draws=None) -> (state, {"loss"}); label-
    smoothed CE, drop-path from `generator`."""
    dev = resolve_device(device)
    augment = _augmenter(fused_augment, cfg.img_size, use_randaug, re_prob,
                         crop_scale, hflip)

    def step(state: TrainState, images, labels, generator=None,
             augment_draws=None):
        A = images.shape[0]
        images = augment(images, generator, augment_draws, dev) \
            if augment is not None else images.to(dev)
        labels = labels.to(dev)
        leaves = dict(state.params.named_parameters())

        def micro(a):
            logits = swin_forward(state.params, images[a], cfg, train=True,
                                  generator=generator,
                                  compute_dtype=compute_dtype)
            loss = L.base_criterion(logits, labels[a], soft_labels=False,
                                    smoothing=smoothing)
            return loss, {"loss": loss}

        grads, metrics = _averaged(leaves, A, _accumulate(leaves, A, micro))
        with torch.no_grad():
            updates, state.opt_state = tx.update(grads, state.opt_state,
                                                 leaves)
            _apply(leaves, updates, None, state.params, None)
        state.step += A
        return state, metrics

    return step


def make_swin_eval_step(space: SearchSpace, cfg: SwinCfg, *,
                        compute_dtype=torch.bfloat16, fused: bool = False,
                        device="cuda"):
    """Supernet eval: step(params, alphas, arch, images, labels) ->
    `_cls_metrics` sums."""
    dev = resolve_device(device)

    @torch.no_grad()
    def step(params, alphas, arch, images, labels):
        logits = swin_search_forward(params, alphas, arch, images.to(dev),
                                     cfg, space, train=False, fused=fused,
                                     compute_dtype=compute_dtype)
        return _cls_metrics(logits, labels.to(dev))

    return step


def make_swin_eval_step_dense(cfg: SwinCfg, *, compute_dtype=torch.bfloat16,
                              device="cuda"):
    """Eval of a dense Swin (an exported subnet, shape-driven widths):
    step(params, images, labels) -> `_cls_metrics` sums."""
    dev = resolve_device(device)

    @torch.no_grad()
    def step(params, images, labels):
        logits = swin_forward(params, images.to(dev), cfg, train=False,
                              compute_dtype=compute_dtype)
        return _cls_metrics(logits, labels.to(dev))

    return step


def make_planned_swin_search_step(space: SearchSpace, cfg: SwinCfg,
                                  scfg: SearchConfig, tx, *, phase: str,
                                  steps_per_epoch: int, teacher_apply=None,
                                  compute_dtype=torch.bfloat16,
                                  use_randaug: bool = True,
                                  re_prob: float = 0.25,
                                  crop_scale=(0.08, 1.0), hflip: bool = True,
                                  device="cuda"):
    """The Swin search step over the device cache, as
    `core.steps.make_planned_search_step` (the same signature, so
    `engine.search_one_epoch_planned` drives it): the w_p anneal at the
    fraction of the epoch done, the iteration's cache rows and labels, the
    fused augment and `make_swin_search_step`'s step, the metrics packed
    in the keys' order. Swin has no PMIM, so no keep ratio. Returns
    (PlannedStep, metric keys); on the card the step is replayed as a CUDA
    graph."""
    from .compress import sync_w_p
    inner = make_swin_search_step(
        space, cfg, scfg, tx, phase=phase, teacher_apply=teacher_apply,
        compute_dtype=compute_dtype, fused_augment=True,
        use_randaug=use_randaug, re_prob=re_prob, crop_scale=crop_scale,
        hflip=hflip, device=device)
    keys = SWIN_METRIC_KEYS_SEARCH if phase == "search" \
        else SWIN_METRIC_KEYS_POSTSEARCH
    A = scfg.accum_iter
    micro = max(steps_per_epoch * A, 1)
    warm = scfg.schedule.warmup_epochs

    def step(state: TrainState, cache, idx_plan, labels_plan, generator,
             epoch_base, epoch):
        it = torch.div(state.step - epoch_base, A, rounding_mode="floor")
        frac = epoch.to(torch.float32) + (it * A).to(torch.float32) / micro
        sync_w_p(state.arch, frac, warm)
        imgs, lbls = _gather(cache, idx_plan, labels_plan, it, A)
        state, metrics = inner(state, imgs, lbls, generator)
        return state, torch.stack([metrics[k].float() for k in keys])

    return PlannedStep(step, resolve_device(device)), keys


def make_planned_swin_train_step(cfg: SwinCfg, tx, *, smoothing: float = 0.1,
                                 compute_dtype=torch.bfloat16,
                                 use_randaug: bool = True,
                                 re_prob: float = 0.25,
                                 crop_scale=(0.08, 1.0), hflip: bool = True,
                                 device="cuda"):
    """The dense Swin step over the device cache (one microbatch an
    iteration): step(state, cache, idx_plan, labels_plan, generator,
    epoch_base) -> (state, fp32 loss), as `core.steps.
    make_planned_train_step`; `engine.train_one_epoch_planned` drives it."""
    inner = make_swin_train_step_dense(
        cfg, tx, smoothing=smoothing, compute_dtype=compute_dtype,
        fused_augment=True, use_randaug=use_randaug, re_prob=re_prob,
        crop_scale=crop_scale, hflip=hflip, device=device)

    def step(state: TrainState, cache, idx_plan, labels_plan, generator,
             epoch_base):
        imgs, lbls = _gather(cache, idx_plan, labels_plan,
                             state.step - epoch_base, 1)
        state, metrics = inner(state, imgs, lbls, generator)
        return state, metrics["loss"].float()

    return PlannedStep(step, resolve_device(device))

