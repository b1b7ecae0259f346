"""Differentiable FLOPs model of the searched network.

Port of ofb_tpu/ops/flops.py (the reference's accounting at model,
attention, MLP and block-norm level). The searched FLOPs are a function of
the softmax(alpha)-weighted cell sizes, so the FLOPs loss reaches every
alpha. All arithmetic is fp32.

The JAX package loops over blocks; here the blocks' alphas and arch
tensors are stacked (`stack_blocks`) and every per-block term is one
batched op, which keeps the step's op count (and its host dispatch time)
from growing with depth.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..models.mim_vit import BlockStack, stack_blocks
from ..models.search_space import ArchState, SearchSpace, space_tensors
from ..models.vit import ModelCfg
from .gates import masked_softmax


def _wsum_1d(alpha, switch, sizes, batch_dims=0) -> torch.Tensor:
    """weighted_mask.sum() of a 1-D dim: sum_j p_j * size_j."""
    return masked_softmax(alpha, switch, batch_dims) @ sizes


def _block_wsums(bs: BlockStack, space: SearchSpace):
    """(sd, am), (G,) each: weighted qkv units and MLP width per block."""
    st = space_tensors(space, bs.attn_alpha.device)
    pa = masked_softmax(bs.attn_alpha, bs.attn_switch, batch_dims=1)
    sd = (pa * st.attn_sizes).sum(dim=(1, 2))
    am = _wsum_1d(bs.mlp_alpha, bs.mlp_switch, st.mlp_sizes, 1)
    return sd, am


def model_flops(alphas, arch: ArchState, space: SearchSpace, cfg: ModelCfg
                ) -> Tuple[float, torch.Tensor]:
    """(total GFLOPs of the dense supernet, a float; alpha-weighted
    searched GFLOPs, an fp32 scalar tensor)."""
    N = float(cfg.num_patches)
    D = float(cfg.embed_dim)
    H = float(cfg.num_heads)
    hd = float(cfg.hd)
    hid = float(cfg.hidden)
    C = float(cfg.num_classes)
    p2 = float(cfg.patch_size ** 2)
    head_mult = 2.0 if cfg.distilled else 1.0

    block_total = (2.0 * D * N
                   + N * (H * hd * (3 * H * hd)) + 3 * N * H * hd
                   + H * N * hd * N + H * N * N
                   + 5 * H * N * N
                   + H * N * N * hd
                   + N * (H * hd * (H * hd)) + N * H * hd
                   + (2.0 * (D * hid) + D + hid) * N)
    total = N * D * 3.0 * p2 + cfg.depth * block_total + head_mult * D * C

    st = space_tensors(space, alphas.embed.device)
    ae = _wsum_1d(alphas.embed, arch.embed.switch, st.embed_sizes)
    # active patches: the full N until the first patch prune event
    ap = _wsum_1d(alphas.patch, arch.patch.switch, st.patch_sizes)
    n = torch.where(arch.patch.pruned_once, ap, torch.full_like(ap, N))
    alive_e = arch.embed.hard_mask.sum()
    bs = stack_blocks(alphas, arch)
    sd, am = _block_wsums(bs, space)
    aH = bs.head_alive
    per_block = (2.0 * alive_e * n                               # norms
                 + n * (ae * (3.0 * sd)) + 3.0 * n * sd           # qkv
                 + n * n * sd + aH * n * n                        # q@k
                 + 5.0 * aH * n * n                               # softmax
                 + n * n * sd                                     # attn@v
                 + n * (sd * ae) + n * ae                         # proj
                 + (ae * am + am * ae + ae + am) * n)             # mlp
    searched = (N * ae * 3.0 * p2 + per_block.sum()
                + head_mult * ae * C)
    return total / 1e9, searched / 1e9


def flops_loss(alphas, arch: ArchState, space: SearchSpace, cfg: ModelCfg,
               target_gflops: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(((searched - target) / total)², searched GFLOPs)."""
    total, searched = model_flops(alphas, arch, space, cfg)
    return ((searched - target_gflops) / total).square(), searched


def searched_params_count(alphas, arch: ArchState, space: SearchSpace,
                          cfg: ModelCfg) -> Tuple[float, torch.Tensor]:
    """(total, alpha-weighted searched) parameter counts of the searchable
    modules."""
    D = float(cfg.embed_dim)
    H = float(cfg.num_heads)
    hd = float(cfg.hd)
    hid = float(cfg.hidden)
    k2 = float(cfg.patch_size ** 2)
    in_ch = float(cfg.in_chans)

    total = (in_ch * D * k2 + D + D * 2.0
             + cfg.depth * ((H * hd) * (H * hd) * 3 + (H * hd) * 3
                            + (H * hd) * (H * hd) + H * hd
                            + 2.0 * (D * hid) + D + hid))
    st = space_tensors(space, alphas.embed.device)
    ae = _wsum_1d(alphas.embed, arch.embed.switch, st.embed_sizes)
    sd, am = _block_wsums(stack_blocks(alphas, arch), space)
    per_block = (ae * sd * 3.0 + sd * 3.0 + sd * ae + ae
                 + 2.0 * (ae * am) + ae + am)
    return total, in_ch * ae * k2 + ae + ae * 2.0 + per_block.sum()
