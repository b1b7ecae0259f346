"""The reference's finetune step: an exported subnet's planned train step,
one process, one rank.

A frozen copy of the program's step logic: the gather from the cache, the
fused augment, Mixup / CutMix, the dense ViT's forward and soft-target loss,
layer-decay AdamW and the EMA. It imports nothing of the program.
"""

from __future__ import annotations

import torch

from .. import inputs
from ..compare import UPDATES
from . import model as M
from .config import FinetuneConfig
from .mixup import apply_mixup, mixup_draws
from .optim import build_finetune_optimizer, make_schedule
from .steps import CellInputs, leaf_norms, grad_from_moments, model_cfg


def beta1(name: str) -> float:
    return FinetuneConfig().betas[0]


def run(cfg: dict, wl: dict, seed: int, device) -> dict:
    """The finetune cell's first `UPDATES` updates in the reference."""
    cell = CellInputs(cfg, wl, seed, device)
    if cell.world != 1 or cell.A != 1:
        raise ValueError("the finetune reference takes one rank and no "
                         "accumulation")
    mcfg = model_cfg(cfg)
    params = M.ViT(mcfg).to_empty(device=device)
    leaves = M.named_leaves(params)
    inputs.fill_weights(leaves, seed)
    p0 = {n: t.detach().clone() for n, t in leaves.items()}
    ema = {n: t.detach().clone() for n, t in leaves.items()}
    fcfg = FinetuneConfig()
    fcfg.data.batch_size = cell.mb
    fcfg = fcfg.resolve(1)
    schedule = make_schedule(fcfg.lr, fcfg.schedule, cell.epochs * cell.spe,
                             cell.spe)
    tx = build_finetune_optimizer(
        params, lr_schedule=schedule, betas=fcfg.betas, eps=fcfg.eps,
        weight_decay=fcfg.weight_decay, layer_decay=fcfg.layer_decay,
        num_layers=mcfg.depth, clip_grad=fcfg.clip_grad)
    opt_state = tx.init(leaves)
    opt_state.count.fill_(cell.epoch * cell.spe)
    mix = fcfg.mixup
    decay = fcfg.model_ema_decay
    losses, grads = [], None
    for it in range(UPDATES):
        u8, lbls = cell.microbatch(it, 0)
        imgs = cell.augment(u8, mcfg.img_size)
        B, H, W, _ = imgs.shape
        draws = mixup_draws(cell.gen, B, H, W, mixup_alpha=mix.mixup,
                            cutmix_alpha=mix.cutmix,
                            cutmix_minmax=mix.cutmix_minmax, prob=mix.prob,
                            switch_prob=mix.switch_prob, mode=mix.mode,
                            device=device)
        imgs, soft = apply_mixup(imgs, lbls, draws,
                                 num_classes=mcfg.num_classes,
                                 mode=mix.mode,
                                 label_smoothing=mix.label_smoothing)
        for p in leaves.values():
            p.grad = None
        logits = M.vit_forward(params, imgs, mcfg, generator=cell.gen)
        loss = M.soft_target_ce(logits, soft)
        loss.backward()
        losses.append(float(loss.detach()))
        g = {n: p.grad for n, p in leaves.items()}
        with torch.no_grad():
            updates, opt_state = tx.update(g, opt_state, leaves)
            names = list(leaves)
            torch._foreach_add_([leaves[n] for n in names],
                                [updates[n] for n in names])
            e = [ema[n] for n in names]
            torch._foreach_mul_(e, decay)
            torch._foreach_add_(e, [leaves[n] for n in names],
                                alpha=1.0 - decay)
        if it == 0:
            grads = grad_from_moments(tx, opt_state, leaves)
    names = list(leaves)
    change = dict(zip(names, leaf_norms(
        [leaves[n] - p0[n] for n in names])))
    change.update(zip([f"ema.{n}" for n in names], leaf_norms(
        [ema[n] - p0[n] for n in names])))
    return {"loss": losses, "grad": grads, "change": change}
