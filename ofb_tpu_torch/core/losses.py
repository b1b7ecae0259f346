"""Loss stack of the search and finetune steps, as fp32 tensor functions.

Port of ofb_tpu/core/losses.py: classification criteria (CE, label
smoothing, soft-target CE), the teacher-distillation wrapper and the
distilled models' pair loss, and the OFB search losses (adaptive one-hot
sparsity per module plus the FLOPs loss).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.search_space import ArchState, SearchSpace
from ..models.vit import ModelCfg
from ..models.mim_vit import stack_blocks
from ..ops.flops import flops_loss
from ..ops.gates import masked_softmax


def cross_entropy(logits, labels) -> torch.Tensor:
    """Hard-label CE; labels int (B,)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels[:, None].long())[:, 0].mean()


def label_smoothing_ce(logits, labels, smoothing: float = 0.1) -> torch.Tensor:
    """timm LabelSmoothingCrossEntropy."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, labels[:, None].long())[:, 0]
    smooth = -logp.mean(dim=-1)
    return ((1.0 - smoothing) * nll + smoothing * smooth).mean()


def soft_target_ce(logits, target) -> torch.Tensor:
    """timm SoftTargetCrossEntropy; target (B, C) is a distribution."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return (-target * logp).sum(dim=-1).mean()


def base_criterion(logits, labels, *, soft_labels: bool, smoothing: float):
    """Soft-target CE with mixup labels, else label-smoothing CE (plain CE
    when smoothing == 0)."""
    if soft_labels:
        return soft_target_ce(logits, labels)
    if smoothing > 0.0:
        return label_smoothing_ce(logits, labels, smoothing)
    return cross_entropy(logits, labels)


def distillation_loss(base_loss, student_kd: Optional[torch.Tensor],
                      teacher_logits: Optional[torch.Tensor], *, kind: str,
                      alpha: float, tau: float) -> torch.Tensor:
    """Teacher KD wrapper: (1 - alpha) base + alpha kd, with kd the
    tau-softened KL (sum over the batch, times tau², over the element
    count) for 'soft' and CE against the teacher's argmax for 'hard'."""
    if kind == "none" or teacher_logits is None:
        return base_loss
    t = teacher_logits.detach().float()
    s = student_kd.float()
    if kind == "soft":
        logp_t = F.log_softmax(t / tau, dim=-1)
        logp_s = F.log_softmax(s / tau, dim=-1)
        kd = (logp_t.exp() * (logp_t - logp_s)).sum() * (tau * tau) / s.numel()
    elif kind == "hard":
        kd = cross_entropy(s, t.argmax(dim=-1))
    else:
        raise ValueError(kind)
    return base_loss * (1.0 - alpha) + kd * alpha


def distilled_pair_loss(logits, logits_dist, labels, *, soft_labels: bool,
                        smoothing: float) -> torch.Tensor:
    """Search-phase loss of a distilled model: CE(cls) + CE(dist) +
    batch-mean KL(cls || dist)."""
    base = base_criterion(logits, labels, soft_labels=soft_labels,
                          smoothing=smoothing)
    logp_d = F.log_softmax(logits_dist.float(), dim=-1)
    p_c = torch.softmax(logits.float(), dim=-1)
    kl = (p_c * (torch.log(p_c.clamp_min(1e-12)) - logp_d)).sum() \
        / logits.shape[0]
    dist_ce = base_criterion(logits_dist, labels, soft_labels=soft_labels,
                             smoothing=smoothing)
    return base + dist_ce + kl


# ---------------------------------------------------------------------------
# Adaptive one-hot sparsity loss
# ---------------------------------------------------------------------------

def _cell_loss(alpha, switch, *, entropy: bool, var: bool,
               divide_var_by_n: bool, batch_dims: int = 0) -> torch.Tensor:
    """Entropy + tan-variance over the active cells of one module (or of a
    stack of modules along `batch_dims` leading dims), fp32; sigma_prob is
    clipped to [1e-6, 1 - 1e-6], away from tan's asymptotes. 0 for a
    converged module (one active cell)."""
    sw = switch.flatten(batch_dims)
    n_active = sw.float().sum(dim=-1)
    p = masked_softmax(alpha, switch, batch_dims).flatten(batch_dims)
    loss = torch.zeros_like(n_active)
    if entropy:
        plogp = torch.where(sw, p * torch.log(p.clamp_min(1e-12)), 0.0)
        loss = loss - plogp.sum(dim=-1)
    if var:
        n = n_active.clamp_min(1.0)
        sigma = torch.where(sw, (p - 1.0 / n[..., None]).square(),
                            0.0).sum(dim=-1)
        target_sigma = 1.0 - 1.0 / n
        sigma_prob = (sigma / target_sigma.clamp_min(1e-12)).clamp(
            1e-6, 1.0 - 1e-6)
        tan_term = torch.tan(math.pi / 2.0 - math.pi * sigma_prob)
        if divide_var_by_n:
            tan_term = tan_term / n
        loss = loss + tan_term
    return torch.where(n_active > 1.0, loss, 0.0)


def _score_norm(score, hard_mask, weight: float,
                batch_dims: int = 0) -> torch.Tensor:
    """sum(sigmoid(score)) over surviving dims, times weight; a broadcast
    score shape ((H,1) / (1,d)) reduces the hard mask to match."""
    w = hard_mask
    for ax in range(batch_dims, score.dim()):
        if score.shape[ax] == 1 and w.shape[ax] != 1:
            w = w.amax(dim=ax, keepdim=True)
    return (torch.sigmoid(score.float()) * w).flatten(batch_dims).sum(
        dim=-1) * weight


def group_loss(alpha, switch, score, hard_mask, weight: float, bd: int, *,
               entropy: bool, var: bool, norm: bool) -> torch.Tensor:
    """Sparsity loss of one module, or summed over a stack of modules
    along `bd` leading dims: the divided cell loss plus, while more than
    one cell is active, the weighted score norm."""
    l = _cell_loss(alpha, switch, entropy=entropy, var=var,
                   divide_var_by_n=True, batch_dims=bd)
    if norm:
        live = switch.flatten(bd).sum(dim=-1) > 1
        l = l + torch.where(live, _score_norm(score, hard_mask, weight, bd),
                            0.0)
    return l.sum()


def _block_groups(params, n_blocks: int):
    """(block indices, block params) of each group of blocks that share one
    shape: all blocks of a ViT, each stage's of a Swin."""
    stages = getattr(params, "stages", None)
    if stages is None:
        return [(range(n_blocks), list(params.blocks))]
    groups, i = [], 0
    for stage in stages:
        groups.append((range(i, i + len(stage.blocks)), list(stage.blocks)))
        i += len(stage.blocks)
    return groups


def sparsity_losses(params, alphas, arch: ArchState, space: SearchSpace, *,
                    entropy: bool = True, var: bool = True, norm: bool = True
                    ) -> Dict[str, torch.Tensor]:
    """Grouped sparsity losses: attn, mlp, patch, embed. A Swin's per-stage
    widths join the embed group. The blocks' terms are computed on stacked
    tensors (`stack_blocks`), one stack for each group of same-shaped blocks
    (a ViT's all, a Swin stage's), and summed."""
    zero = torch.zeros((), dtype=torch.float32, device=alphas.embed.device)

    # patch: entropy + undivided tan-variance, no score term
    loss_patch = _cell_loss(alphas.patch, arch.patch.switch, entropy=True,
                            var=True, divide_var_by_n=False)

    def group(alpha, switch, score, hard_mask, weight, bd):
        return group_loss(alpha, switch, score, hard_mask, weight, bd,
                          entropy=entropy, var=var, norm=norm)

    loss_embed = zero
    if space.embed.searchable:
        loss_embed = group(alphas.embed, arch.embed.switch,
                           params.patch_embed.score, arch.embed.hard_mask,
                           1e-4, 0)
    for s, ds in enumerate(space.stage_embeds):
        if ds.searchable:
            ea = arch.stage_embeds[s]
            loss_embed = loss_embed + group(
                alphas.stage_embeds[s], ea.switch,
                params.stages[s].embed_score, ea.hard_mask, 1e-4, 0)
    loss_attn = loss_mlp = zero
    for idx, blocks in _block_groups(params, len(space.blocks)):
        b0 = space.blocks[idx[0]]
        if not (b0.attn.searchable or b0.mlp.searchable):
            continue
        bs = stack_blocks(alphas, arch, idx)
        if b0.attn.searchable:
            loss_attn = loss_attn + group(
                bs.attn_alpha, bs.attn_switch,
                torch.stack([b.attn.score for b in blocks]), bs.attn_hard,
                4e-4, 1)
        if b0.mlp.searchable:
            loss_mlp = loss_mlp + group(
                bs.mlp_alpha, bs.mlp_switch,
                torch.stack([b.mlp.score for b in blocks]), bs.mlp_hard,
                1e-4, 1)
    return {"attn": loss_attn, "mlp": loss_mlp, "patch": loss_patch,
            "embed": loss_embed}


def ofb_arch_loss(params, alphas, arch: ArchState, space: SearchSpace,
                  cfg: ModelCfg, *, target_flops: float, w_head: float,
                  w_mlp: float, w_patch: float, w_embedding: float,
                  w_flops: float, entropy=True, var=True, norm=True
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted arch loss; returns (loss, aux) with aux holding the
    searched GFLOPs and each term."""
    fl, searched = flops_loss(alphas, arch, space, cfg, target_flops)
    sp = sparsity_losses(params, alphas, arch, space, entropy=entropy,
                         var=var, norm=norm)
    total = (w_head * sp["attn"] + w_mlp * sp["mlp"] + w_patch * sp["patch"]
             + w_embedding * sp["embed"] + w_flops * fl)
    aux = {"loss_flops": fl, "searched_gflops": searched,
           **{f"loss_{k}": v for k, v in sp.items()}}
    return total, aux
