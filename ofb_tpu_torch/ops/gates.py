"""Bi-mask gate math, the core of the OFB search.

Port of ofb_tpu/ops/gates.py. For every searchable dimension the gate is

    g = w_p * sigmoid(score) + (1 - w_p) * rank_restore(weighted_mask)

where `weighted_mask` is the softmax(alpha)-weighted sum of the candidate
prefix masks over active cells, and `rank_restore` maps the sorted-domain
mask back to channel order by descending saliency score. Killed cells are
the boolean `switch` (masked softmax), dead channels the float
`hard_mask`; shapes never change. Sorts are stable, as `jnp.argsort` is:
ties are common (dead channels at -inf, all-ones scores).
"""

from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e30  # acts as -inf in the masked softmax without inf - inf NaNs


def masked_softmax(alpha: torch.Tensor, switch: torch.Tensor,
                   batch_dims: int = 0) -> torch.Tensor:
    """Softmax over active cells only, flattened over every dim after the
    leading `batch_dims` (a stack of modules); inactive cells get 0."""
    a = torch.where(switch, alpha.float(), NEG_INF)
    flat = torch.softmax(a.flatten(batch_dims), dim=-1)
    return torch.where(switch, flat.reshape(alpha.shape), 0.0)


# The gate functions below take one module's tensors or a stack of modules'
# (leading dims on every argument except the mask bank, shared by all).

def weighted_mask_1d(alpha, switch, mask_bank) -> torch.Tensor:
    """alpha (..., K), switch (..., K), mask_bank (K, D) -> sorted-domain
    mask (..., D)."""
    return masked_softmax(alpha, switch, alpha.dim() - 1) @ mask_bank


def weighted_mask_attn(alpha, switch, mask_bank) -> torch.Tensor:
    """alpha (..., Kh, Kc), switch (..., Kh, Kc), mask_bank (Kh, H, Kc, d)
    -> (..., H, d)."""
    p = masked_softmax(alpha, switch, alpha.dim() - 2)
    return torch.einsum("...ij,ihjd->...hd", p, mask_bank)


def _ranks(s: torch.Tensor) -> torch.Tensor:
    """Rank of each entry by descending s along the last dim (stable
    double argsort)."""
    order = torch.argsort(-s, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True)


def rank_restore_1d(sorted_vals, score, hard_mask) -> torch.Tensor:
    """restore[c] = sorted_vals[rank(c)], rank by descending score among
    channels with hard_mask > 0; hard-dead channels rank last."""
    s = torch.where(hard_mask > 0, score.float(), float("-inf"))
    return torch.gather(sorted_vals, -1, _ranks(s))


def rank_restore_attn(sorted_vals, score, hard_mask) -> torch.Tensor:
    """2-D restore: heads ranked by the sum of sigmoid(score) over alive
    channels, channels ranked within each head. sorted_vals (..., H, d),
    score (..., H, d) or broadcastable, hard_mask (..., H, d)."""
    score = score.float().expand(hard_mask.shape)
    alive = hard_mask > 0
    chan_ranks = _ranks(torch.where(alive, score, float("-inf")))
    head_score = (torch.sigmoid(score) * hard_mask).sum(dim=-1)
    hs = torch.where(alive.any(dim=-1), head_score, float("-inf"))
    head_ranks = _ranks(hs)[..., None].expand(hard_mask.shape)
    by_head = torch.gather(sorted_vals, -2, head_ranks)
    return torch.gather(by_head, -1, chan_ranks)


def bimask_gate_1d(score, alpha, switch, mask_bank, hard_mask, w_p, finished
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gate of a 1-D width: (gate, restore). While searching the gate is
    w_p*sigmoid(score) + (1-w_p)*restore on live channels; once the module
    is finished the score itself (rewritten at convergence) is the gate."""
    wm = weighted_mask_1d(alpha, switch, mask_bank)
    restore = rank_restore_1d(wm, score, hard_mask) * hard_mask
    sf = score.float()
    w_p = w_p[..., None]
    search_gate = (w_p * torch.sigmoid(sf) + (1.0 - w_p) * restore) * hard_mask
    return torch.where(finished[..., None], sf, search_gate), restore


def bimask_gate_attn(score, alpha, switch, mask_bank, hard_mask, w_p, finished
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gate of the attention head x channel space: (gate, restore), each
    (..., H, d)."""
    score_b = score.float().expand(hard_mask.shape)
    wm = weighted_mask_attn(alpha, switch, mask_bank)
    restore = rank_restore_attn(wm, score_b, hard_mask) * hard_mask
    w_p = w_p[..., None, None]
    search_gate = (w_p * torch.sigmoid(score_b)
                   + (1.0 - w_p) * restore) * hard_mask
    return torch.where(finished[..., None, None], score_b, search_gate), restore


def masked_layer_norm(x, mask, scale, bias, *, eps: float = 1e-6,
                      passthrough: str = "zero") -> torch.Tensor:
    """LayerNorm over the masked-in channels, in place (channel order kept),
    with masked moments.

    passthrough: 'zero' — dropped channels output 0 (patch-embed output,
    final norm); 'identity' — dropped channels pass through (block norms).
    """
    if passthrough not in ("zero", "identity"):
        raise ValueError(passthrough)
    xf = x.float()
    m = (mask > 0).float()
    cnt = m.sum().clamp_min(1.0)
    mean = (xf * m).sum(dim=-1, keepdim=True) / cnt
    var = ((xf - mean).square() * m).sum(dim=-1, keepdim=True) / cnt
    normed = (xf - mean) * torch.rsqrt(var + eps)
    normed = normed * scale.float() + bias.float()
    if passthrough == "zero":
        out = normed * m
    else:
        out = torch.where(m > 0, normed, xf)
    return out.to(x.dtype)


def layer_norm(x, scale, bias, *, eps: float = 1e-6) -> torch.Tensor:
    """Plain LayerNorm (biased variance) computed in fp32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)
