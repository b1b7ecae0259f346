"""The search step.

Port of the search phase of ofb_tpu/core/steps.py `make_search_step`. One
call is one optimizer update over A accumulated microbatches:

  * per microbatch: the gated supernet forward with PMIM (token mask and
    decoder), label-smoothing CE, the arch loss (sparsity + FLOPs) and the
    decoder loss weighted by w_dec = base / dec (detached), then backward;
  * gradients and metrics averaged over the A microbatches, `grad_norm` of
    the weight gradients;
  * the five-family AdamW, then the freeze of finished alphas, applied to
    the updates after Adam moved every moment;
  * EMA of the weights when the state carries one; `step += A`.

PyTorch runs eagerly, so the step updates the state's parameters, moments
and EMA in place (no copy of the model per step) and returns the same
state. The postsearch phase (mixup, frozen decoder), the static update
masks, fused augmentation, the teacher and the planned-epoch step are
not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from ..config import SearchConfig
from ..device import resolve_device
from ..models.mim_vit import Alphas, MimViT, mim_forward
from ..models.search_space import ArchState, SearchSpace
from ..models.vit import ModelCfg
from . import losses as L
from .optim import AdamWState, SearchOptimizer, named_leaves

METRIC_KEYS_SEARCH = ("loss_param", "loss_total", "loss_arch",
                      "loss_decoder", "searched_gflops", "grad_norm")


@dataclass
class TrainState:
    step: int                          # micro-iteration counter
    params: MimViT
    alphas: Alphas
    arch: ArchState
    opt_state: AdamWState
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


def make_search_step(space: SearchSpace, mcfg: ModelCfg, scfg: SearchConfig,
                     tx: SearchOptimizer, *, phase: str = "search",
                     compute_dtype=torch.bfloat16, device="cuda"):
    """Build the search step on `device` (default "cuda"; raises without a
    card unless device="cpu" is asked for).

    Returns step(state, images (A, mb, H, W, C), labels (A, mb), generator,
    keep_ratio, token_masks=None) -> (state, metrics). `token_masks`
    (A, mb, L), 1 = removed, replaces the PMIM masks drawn from
    `generator`."""
    if phase != "search":
        raise NotImplementedError(f"phase {phase!r} is not ported yet")
    dev = resolve_device(device)

    def loss_fn(state: TrainState, images, labels, generator, keep_ratio,
                token_mask):
        out = mim_forward(state.params, state.alphas, state.arch, images,
                          mcfg, space, train=True, use_mim=True,
                          keep_ratio=keep_ratio, generator=generator,
                          token_mask=token_mask, compute_dtype=compute_dtype)
        if out.logits_dist is not None:
            raise NotImplementedError("distilled search is not ported yet")
        base = L.base_criterion(out.logits, labels, soft_labels=False,
                                smoothing=scfg.mixup.label_smoothing)
        arch_loss, aux = L.ofb_arch_loss(
            state.params, state.alphas, state.arch, space, mcfg,
            target_flops=scfg.target_flops, w_head=scfg.w_head,
            w_mlp=scfg.w_mlp, w_patch=scfg.w_patch,
            w_embedding=scfg.w_embedding, w_flops=scfg.w_flops,
            entropy=scfg.entropy, var=scfg.var, norm=scfg.norm)
        dec = out.decoder_loss
        # dynamic decoder weight w = base / dec; its gradient flows into
        # the decoder loss only
        w_dec = torch.where(dec > 0, base / dec.clamp_min(1e-12),
                            0.0).detach()
        total = base + arch_loss + w_dec * dec
        metrics = {"loss_param": base, "loss_total": total,
                   "loss_arch": arch_loss, "loss_decoder": dec,
                   "searched_gflops": aux["searched_gflops"]}
        return total, metrics

    def step(state: TrainState, images, labels, generator=None,
             keep_ratio=None, token_masks=None):
        A = images.shape[0]
        images = images.to(dev)
        labels = labels.to(dev)
        leaves = named_leaves(state.params, state.alphas)
        for p in leaves.values():
            p.grad = None
        sums: Dict[str, torch.Tensor] = {}
        for a in range(A):
            tm = token_masks[a] if token_masks is not None else None
            total, m = loss_fn(state, images[a], labels[a], generator,
                               keep_ratio, tm)
            total.backward()
            for k, v in m.items():
                sums[k] = sums[k] + v.detach() if k in sums else v.detach()
        metrics = {k: v / A for k, v in sums.items()}
        names = list(leaves)
        grads = dict(zip(names, torch._foreach_div(
            [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in leaves.values()], float(A))))
        wnorms = torch._foreach_norm(
            [g for n, g in grads.items() if not n.startswith("alphas.")])
        metrics["grad_norm"] = torch.linalg.vector_norm(torch.stack(wnorms))

        with torch.no_grad():
            updates, state.opt_state = tx.update(grads, state.opt_state,
                                                 leaves)
            for n, f in _finished_alpha_names(state.alphas, state.arch):
                updates[n] = updates[n] * (1.0 - f.float())
            torch._foreach_add_(list(leaves.values()),
                                [updates[n] for n in names])
            for p in leaves.values():
                p.grad = None
            if state.ema_params is not None:
                d = scfg.model_ema_decay
                ema, live = zip(*((state.ema_params[n], p) for n, p in
                                  state.params.named_parameters()))
                torch._foreach_mul_(list(ema), d)
                torch._foreach_add_(list(ema), list(live), alpha=1.0 - d)
        state.step += A
        return state, metrics

    return step
