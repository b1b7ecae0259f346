"""The reference's search step: the OFB supernet's planned search step, one
process over the global batch (a data-parallel step's ranks taken one after
the other, as `rows` says).

A frozen copy of the program's step logic: the planned wrapper's w_p and
keep-ratio schedules, the gather from the cache, the fused augment, the PMIM
forward and its losses, the decoder weight of the global batch, the
accumulation, the five-family AdamW and the freeze of finished alphas. It
imports nothing of the program.
"""

from __future__ import annotations

import torch

from .. import inputs
from ..compare import UPDATES
from . import model as M
from .config import SearchConfig
from .optim import build_search_optimizer
from .rows import as_rank, local_rows
from .space import ArchState
from .steps import (CellInputs, anneal, finished_alphas, leaf_norms,
                    grad_from_moments, sync_w_p, model_cfg, search_space)


def beta1(name: str) -> float:
    """The arch family's b1 for alphas, the weights' otherwise."""
    c = SearchConfig()
    return (c.optim_arch if name.startswith("alphas.")
            else c.optim_param).betas[0]


def run(cfg: dict, wl: dict, seed: int, device) -> dict:
    """The search cell's first `UPDATES` updates in the reference."""
    cell = CellInputs(cfg, wl, seed, device)
    mcfg = model_cfg(cfg)
    space = search_space(cfg, mcfg)
    params = M.MimViT(mcfg, space).to_empty(device=device)
    alphas = M.Alphas(space).to_empty(device=device)
    leaves = M.named_leaves(params, alphas)
    inputs.fill_weights(leaves, seed)
    p0 = {n: t.detach().clone() for n, t in leaves.items()}
    arch = ArchState.create(space, device)
    rec = wl["recipe"]
    scfg = SearchConfig(accum_iter=cell.A, target_flops=rec["target_flops"])
    scfg.data.batch_size = cell.mb
    scfg = scfg.resolve(cell.world)
    A = cell.A
    tx, _ = build_search_optimizer(
        scfg.optim_param, scfg.optim_arch, scfg.optim_decoder,
        scfg.schedule, total_steps=cell.epochs * cell.spe * A,
        steps_per_epoch=cell.spe * A, clip_grad=scfg.clip_grad,
        accum_iter=A)
    opt_state = tx.init(leaves)
    opt_state.count.fill_(cell.epoch * cell.spe)
    epoch_t = torch.tensor(cell.epoch, dtype=torch.int64, device=device)
    micro_total = max(cell.spe * A, 1)
    warm = scfg.schedule.warmup_epochs
    smoothing = scfg.mixup.label_smoothing
    out_size = mcfg.img_size
    losses, grads = [], None

    def forward(imgs, lbls, keep):
        out = M.mim_forward(params, alphas, arch, imgs, mcfg, space,
                            keep_ratio=keep, generator=cell.gen)
        base = M.label_smoothing_ce(out.logits, lbls, smoothing)
        return base, out.decoder_loss

    for it in range(UPDATES):
        itt = torch.tensor(it, device=device)
        frac = epoch_t.to(torch.float32) + (itt * A).to(torch.float32) \
            / micro_total
        sync_w_p(arch, anneal(frac, warm, 0.99, 0.1))
        keep = anneal(frac, warm, scfg.max_ratio, scfg.min_ratio)
        batches = [cell.microbatch(it, a) for a in range(A)]
        images = [cell.augment(u8, out_size) for u8, _ in batches]
        for p in leaves.values():
            p.grad = None
        total_sum = torch.zeros((), device=device)
        for a in range(A):
            lbls = batches[a][1]
            start = cell.gen.get_state()
            w = cell.world
            if w > 1:                     # the ranks' mean (base, dec) first
                pairs = []
                with torch.no_grad():
                    for r in range(w):
                        cell.gen.set_state(start)
                        with as_rank(r, w):
                            pairs.append(torch.stack(forward(
                                local_rows(images[a], r, w),
                                local_rows(lbls, r, w), keep)))
                pair = torch.stack(pairs).mean(0)
            for r in range(w):
                cell.gen.set_state(start)
                with as_rank(r, w):
                    base, dec = forward(local_rows(images[a], r, w),
                                        local_rows(lbls, r, w), keep)
                    if w == 1:
                        pair = torch.stack([base, dec]).detach()
                    w_dec = torch.where(
                        pair[1] > 0, pair[0] / pair[1].clamp_min(1e-12), 0.0)
                    arch_loss = M.ofb_arch_loss(params, alphas, arch, space,
                                                mcfg, scfg)
                    total = base + arch_loss + w_dec * dec
                    total.backward()
                total_sum += total.detach()
        g = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             / float(A * cell.world) for n, p in leaves.items()}
        losses.append(float(total_sum / (A * cell.world)))
        with torch.no_grad():
            updates, opt_state = tx.update(g, opt_state, leaves)
            for n, f in finished_alphas(arch):
                updates[n] = updates[n] * (1.0 - f.float())
            names = list(leaves)
            torch._foreach_add_([leaves[n] for n in names],
                                [updates[n] for n in names])
        if it == 0:
            grads = grad_from_moments(tx, opt_state, leaves)
    change = dict(zip(leaves, leaf_norms(
        [leaves[n] - p0[n] for n in leaves])))
    return {"loss": losses, "grad": grads, "change": change}
