"""Train, search and eval steps.

Port of ofb_tpu/core/steps.py. `make_search_step` builds the supernet's
step; one call is one optimizer update over A accumulated microbatches:

  * per microbatch: the gated supernet forward, the loss families, then
    backward. Phase 'search': PMIM (token mask and decoder),
    label-smoothing CE, the arch loss (sparsity + FLOPs) and the decoder
    loss weighted by w_dec = base / dec (detached). Phase 'postsearch':
    MIM off, Mixup / CutMix with soft-target CE, no arch loss, the decoder
    and the mask token frozen;
  * gradients and metrics averaged over the A microbatches, `grad_norm` of
    the weight gradients;
  * the five-family AdamW, then the static update masks, the freeze of
    finished alphas and (postsearch) of the decoder, all applied to the
    updates after Adam moved every moment;
  * EMA of the weights when the state carries one; `step += A`.

`make_train_step` is the plain supervised step of the finetune stage on a
dense ViT (an exported subnet), `make_eval_step` / `make_eval_step_dense`
return the sums a caller averages over an epoch.

PyTorch runs eagerly, so the steps update the state's parameters, moments
and EMA in place (no copy of the model per step) and return the same
state. Randomness never has to come from the step: `token_masks=` replaces
the PMIM masks and `mixup_draws=` the Mixup parameters drawn from
`generator`. Fused augmentation, the teacher and the planned-epoch steps
are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import SearchConfig
from ..device import resolve_device
from ..models.mim_vit import Alphas, mim_forward
from ..models.search_space import ArchState, SearchSpace
from ..models.vit import ModelCfg, ViT, vit_forward
from ..ops.mixup import apply_mixup, mixup_draws as draw_mixup
from . import losses as L
from .optim import named_leaves

METRIC_KEYS_SEARCH = ("loss_param", "loss_total", "loss_arch",
                      "loss_decoder", "searched_gflops", "grad_norm")
METRIC_KEYS_POSTSEARCH = ("loss_param", "loss_total", "grad_norm")


@dataclass
class TrainState:
    step: int                          # micro-iteration counter
    params: ViT                        # MimViT in the search, ViT in finetune
    alphas: Optional[Alphas]
    arch: Optional[ArchState]
    opt_state: Any
    ema_params: Optional[Dict[str, torch.Tensor]] = None


def _finished_alpha_names(alphas: Alphas, arch: ArchState):
    """(alpha leaf name, finished flag) pairs: a converged module's alpha
    gets no update (the reference stops its gradient, which also stops
    weight decay from drifting it)."""
    yield "alphas.patch", arch.patch.finished
    yield "alphas.embed", arch.embed.finished
    for i, b in enumerate(arch.blocks):
        yield f"alphas.blocks.{i}.attn", b.attn.finished
        yield f"alphas.blocks.{i}.mlp", b.mlp.finished


def _is_decoder(name: str) -> bool:
    return name.startswith("decoder.") or name == "mask_token"


def _not_ported(teacher_apply, fused_augment):
    if teacher_apply is not None:
        raise NotImplementedError("the teacher is not ported yet")
    if fused_augment:
        raise NotImplementedError("fused augmentation is not ported yet")


def _mixed(images, labels, generator, draws, mix, *, num_classes,
           mixup_alpha, cutmix_alpha):
    """Mixup / CutMix of one microbatch: with the draws handed in, else
    with draws from `generator` (which must then be given)."""
    if draws is None:
        if generator is None:
            raise ValueError("Mixup needs a `generator` to draw from, or "
                             "`mixup_draws`")
        B, H, W, _ = images.shape
        draws = draw_mixup(generator, B, H, W, mixup_alpha=mixup_alpha,
                           cutmix_alpha=cutmix_alpha,
                           cutmix_minmax=mix.cutmix_minmax, prob=mix.prob,
                           switch_prob=mix.switch_prob, mode=mix.mode,
                           device=images.device)
    return apply_mixup(images, labels, draws, num_classes=num_classes,
                       mode=mix.mode, label_smoothing=mix.label_smoothing)


def _accumulate(leaves, A, micro):
    """Run `micro(a)` -> (loss, metrics) and backward for a in range(A);
    returns ({name: mean gradient}, {metric: mean}). A leaf no microbatch
    reached gets a zero gradient (Adam still decays its moments)."""
    for p in leaves.values():
        p.grad = None
    sums: Dict[str, torch.Tensor] = {}
    for a in range(A):
        total, m = micro(a)
        total.backward()
        for k, v in m.items():
            sums[k] = sums[k] + v.detach() if k in sums else v.detach()
    grads = dict(zip(leaves, torch._foreach_div(
        [p.grad if p.grad is not None else torch.zeros_like(p)
         for p in leaves.values()], float(A))))
    return grads, {k: v / A for k, v in sums.items()}


def _apply(leaves, updates, ema_params, params, ema_decay):
    """leaves += updates, clear the gradients, advance the EMA."""
    names = list(leaves)
    torch._foreach_add_(list(leaves.values()), [updates[n] for n in names])
    for p in leaves.values():
        p.grad = None
    if ema_params is not None and ema_decay is not None:
        ema, live = zip(*((ema_params[n], p)
                          for n, p in params.named_parameters()))
        torch._foreach_mul_(list(ema), ema_decay)
        torch._foreach_add_(list(ema), list(live), alpha=1.0 - ema_decay)


def make_search_step(space: SearchSpace, mcfg: ModelCfg, scfg: SearchConfig,
                     tx, *, phase: str = "search",
                     param_mask: Optional[Dict[str, float]] = None,
                     alpha_mask: Optional[Dict[str, float]] = None,
                     teacher_apply=None, compute_dtype=torch.bfloat16,
                     fused_augment: bool = False, fused_model: bool = False,
                     gate_fold: bool = True, device="cuda"):
    """Build the supernet's step on `device` (default "cuda"; raises
    without a card unless device="cpu" is asked for).

    Returns step(state, images (A, mb, H, W, C), labels (A, mb), generator,
    keep_ratio, token_masks=None, mixup_draws=None) -> (state, metrics).
    `token_masks` (A, mb, L), 1 = removed, replaces the PMIM masks drawn
    from `generator`; `mixup_draws`, one `ops.mixup.mixup_draws` result per
    microbatch, replaces the postsearch phase's Mixup draws. `param_mask` /
    `alpha_mask` are `make_trainable_mask`'s static 0/1 update masks;
    `fused_model` runs a post-fuse supernet (gates off)."""
    if phase not in ("search", "postsearch"):
        raise ValueError(f"phase {phase!r} (search | postsearch)")
    _not_ported(teacher_apply, fused_augment)
    dev = resolve_device(device)
    use_mim = phase == "search"
    smoothing = scfg.mixup.label_smoothing
    static_mask = {**(param_mask or {}), **(alpha_mask or {})}

    def loss_fn(state: TrainState, images, labels, generator, keep_ratio,
                token_mask, draws):
        soft = False
        if phase == "postsearch":
            # the finish_search transition turns on Mixup(0.8) / CutMix(1.0)
            # and the soft-target CE
            images, labels = _mixed(
                images, labels, generator, draws, scfg.mixup,
                num_classes=mcfg.num_classes, mixup_alpha=0.8,
                cutmix_alpha=1.0)
            soft = True
        out = mim_forward(state.params, state.alphas, state.arch, images,
                          mcfg, space, train=True, use_mim=use_mim,
                          fused=fused_model, keep_ratio=keep_ratio,
                          generator=generator, token_mask=token_mask,
                          gate_fold=gate_fold, compute_dtype=compute_dtype)
        if out.logits_dist is not None:
            base = L.distilled_pair_loss(out.logits, out.logits_dist, labels,
                                         soft_labels=soft,
                                         smoothing=smoothing)
        else:
            base = L.base_criterion(out.logits, labels, soft_labels=soft,
                                    smoothing=smoothing)
        metrics = {"loss_param": base}
        total = base
        if phase == "search":
            arch_loss, aux = L.ofb_arch_loss(
                state.params, state.alphas, state.arch, space, mcfg,
                target_flops=scfg.target_flops, w_head=scfg.w_head,
                w_mlp=scfg.w_mlp, w_patch=scfg.w_patch,
                w_embedding=scfg.w_embedding, w_flops=scfg.w_flops,
                entropy=scfg.entropy, var=scfg.var, norm=scfg.norm)
            dec = out.decoder_loss
            # dynamic decoder weight w = base / dec; its gradient flows
            # into the decoder loss only
            w_dec = torch.where(dec > 0, base / dec.clamp_min(1e-12),
                                0.0).detach()
            total = total + arch_loss + w_dec * dec
            metrics.update(loss_arch=arch_loss, loss_decoder=dec,
                           searched_gflops=aux["searched_gflops"])
        metrics["loss_total"] = total
        return total, metrics

    def step(state: TrainState, images, labels, generator=None,
             keep_ratio=None, token_masks=None, mixup_draws=None):
        A = images.shape[0]
        images = images.to(dev)
        labels = labels.to(dev)
        leaves = named_leaves(state.params, state.alphas)

        def micro(a):
            return loss_fn(
                state, images[a], labels[a], generator, keep_ratio,
                token_masks[a] if token_masks is not None else None,
                mixup_draws[a] if mixup_draws is not None else None)

        grads, metrics = _accumulate(leaves, A, micro)
        wnorms = torch._foreach_norm(
            [g for n, g in grads.items() if not n.startswith("alphas.")])
        metrics["grad_norm"] = torch.linalg.vector_norm(torch.stack(wnorms))

        with torch.no_grad():
            updates, state.opt_state = tx.update(grads, state.opt_state,
                                                 leaves)
            for n, m in static_mask.items():
                if m != 1.0:
                    updates[n] = updates[n] * m
            for n, f in _finished_alpha_names(state.alphas, state.arch):
                updates[n] = updates[n] * (1.0 - f.float())
            if phase == "postsearch":
                for n in updates:
                    if _is_decoder(n):
                        updates[n] = torch.zeros_like(updates[n])
            _apply(leaves, updates, state.ema_params, state.params,
                   scfg.model_ema_decay)
        state.step += A
        return state, metrics

    return step


def w_p_schedule(frac_epoch: float, warmup_epochs: float,
                 w_max: float = 0.99, w_min: float = 0.1) -> float:
    """Clamped bi-mask anneal value, w_max -> w_min over the warmup, in
    fp32 arithmetic (what `ArchState.w_p` holds)."""
    f32 = np.float32
    t = min(f32(frac_epoch) / f32(max(float(warmup_epochs), 1e-8)), f32(1.0))
    return float(f32(w_max) + f32(w_min - w_max) * t)


def keep_ratio_schedule(frac_epoch: float, scfg: SearchConfig,
                        arch: ArchState, space: SearchSpace):
    """PMIM keep ratio: the progressive linear anneal max -> min over the
    warmup (a float), or, non-progressive, the smallest active patch
    cell's ratio (a 0-d tensor computed from device state, no readback)."""
    if scfg.progressive:
        f32 = np.float32
        t = min(f32(frac_epoch) / f32(max(scfg.schedule.warmup_epochs, 1e-8)),
                f32(1.0))
        return float(f32(scfg.max_ratio)
                     + f32(scfg.min_ratio - scfg.max_ratio) * t)
    sw = arch.patch.switch
    ratios = torch.tensor(space.patch.ratios, dtype=torch.float32,
                          device=sw.device)
    return torch.where(sw, ratios, 1.0).min()


# ---------------------------------------------------------------------------
# Finetune / plain train step
# ---------------------------------------------------------------------------

def make_train_step(mcfg: ModelCfg, tx, *, num_classes: int, mixup_cfg=None,
                    smoothing: float = 0.1,
                    ema_decay: Optional[float] = None, teacher_apply=None,
                    distill=None, compute_dtype=torch.bfloat16,
                    fused_augment: bool = False, device="cuda"):
    """Plain supervised train step of the finetune stage, on `device`
    (default "cuda"; raises without a card unless device="cpu" is asked
    for).

    Returns step(state, images (A, mb, H, W, C), labels (A, mb),
    generator=None, mixup_draws=None) -> (state, {"loss": ...}); the state
    holds a dense `ViT` and no alphas. With `mixup_cfg` (mixup or cutmix
    above 0) the labels are soft; `mixup_draws` replaces the draws from
    `generator`."""
    _not_ported(teacher_apply, fused_augment)
    dev = resolve_device(device)
    mix_on = mixup_cfg is not None and (mixup_cfg.mixup > 0
                                        or mixup_cfg.cutmix > 0)

    def loss_fn(params, images, labels, generator, draws):
        soft = False
        if mix_on:
            images, labels = _mixed(
                images, labels, generator, draws, mixup_cfg,
                num_classes=num_classes, mixup_alpha=mixup_cfg.mixup,
                cutmix_alpha=mixup_cfg.cutmix)
            soft = True
        out = vit_forward(params, images, mcfg, train=True,
                          generator=generator, compute_dtype=compute_dtype)
        # a distilled model's second head is the teacher's: only the class
        # head enters the base criterion
        logits = out[0] if isinstance(out, tuple) else out
        base = L.base_criterion(logits, labels, soft_labels=soft,
                                smoothing=smoothing)
        return base, {"loss": base}

    def step(state: TrainState, images, labels, generator=None,
             mixup_draws=None):
        A = images.shape[0]
        images = images.to(dev)
        labels = labels.to(dev)
        leaves = dict(state.params.named_parameters())

        def micro(a):
            return loss_fn(state.params, images[a], labels[a], generator,
                           mixup_draws[a] if mixup_draws is not None
                           else None)

        grads, metrics = _accumulate(leaves, A, micro)
        with torch.no_grad():
            updates, state.opt_state = tx.update(grads, state.opt_state,
                                                 leaves)
            _apply(leaves, updates, state.ema_params, state.params,
                   ema_decay)
        state.step += A
        return state, metrics

    return step


# ---------------------------------------------------------------------------
# Eval steps
# ---------------------------------------------------------------------------

def _cls_metrics(logits, labels) -> Dict[str, torch.Tensor]:
    """Sums over the batch, as fp32 tensors on the logits' device: the CE
    loss, top-1 and top-5 hits and the count."""
    n = labels.shape[0]
    loss = L.cross_entropy(logits, labels)
    top1 = (logits.argmax(dim=-1) == labels).sum()
    k = min(5, logits.shape[-1])
    top5 = (logits.topk(k, dim=-1).indices == labels[:, None]).any(-1).sum()
    return {"loss_sum": loss * n, "top1": top1.float(), "top5": top5.float(),
            "count": torch.tensor(float(n), device=logits.device)}


def make_eval_step(space: SearchSpace, mcfg: ModelCfg, *,
                   compute_dtype=torch.bfloat16, fused: bool = False,
                   gate_fold: bool = True, device="cuda"):
    """Search-model eval: step(params, alphas, arch, images, labels) ->
    `_cls_metrics` sums. fused=True evaluates a post-fuse supernet (scores
    folded into the weights, gates off)."""
    dev = resolve_device(device)

    @torch.no_grad()
    def step(params, alphas, arch, images, labels):
        out = mim_forward(params, alphas, arch, images.to(dev), mcfg, space,
                          train=False, use_mim=False, fused=fused,
                          gate_fold=gate_fold, compute_dtype=compute_dtype)
        return _cls_metrics(out.logits, labels.to(dev))

    return step


def make_eval_step_dense(mcfg: ModelCfg, *, compute_dtype=torch.bfloat16,
                         device="cuda"):
    """Dense-model eval: step(params, images, labels) -> `_cls_metrics`
    sums."""
    dev = resolve_device(device)

    @torch.no_grad()
    def step(params, images, labels):
        logits = vit_forward(params, images.to(dev), mcfg, train=False,
                             compute_dtype=compute_dtype)
        return _cls_metrics(logits, labels.to(dev))

    return step
