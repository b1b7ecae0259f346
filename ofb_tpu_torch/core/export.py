"""Export: materialise the searched subnet as a physically small dense model.

Port of ofb_tpu/core/export.py, the one place where tensor shapes change:

  1. fuse the saliency scores into the weights if not already fused;
  2. slice every tensor by the hard masks (embed channels, per-block
     head x channel sets, MLP hidden units);
  3. emit a dense `ViT` and a `ModelCfg` with per-block dims.

The supernet keeps hard-dead dimensions at exactly zero, so the sliced
model computes what the gated supernet's eval forward computes. Weights are
in the port's layouts: a Linear's output units are its weight's rows, its
inputs the columns.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..models.mim_vit import MimViT, fuse_params
from ..models.search_space import ArchState, SearchSpace
from ..models.vit import ModelCfg, ViT
from ..parallel.mesh import gather_params
from .compress import fetch_host


def _idx(mask: np.ndarray) -> np.ndarray:
    return np.where(np.asarray(mask) > 0)[0]


def export_subnet(params: MimViT, arch: ArchState, space: SearchSpace,
                  cfg: ModelCfg, *, fuse: bool = True
                  ) -> Tuple[ViT, ModelCfg, Dict[str, Any]]:
    """Slice the (finished) supernet into a compact dense model on the
    supernet's device.

    Returns (dense_params, dense_cfg, meta). meta records the keep sets so
    a checkpoint can be re-expanded or audited. A tensor-parallel
    supernet's shards are gathered first (`parallel.mesh.gather_params`, a
    collective of the model group), so it exports what one process's
    search exports.
    """
    params = gather_params(params)
    masks = fetch_host([arch.fused, arch.embed.hard_mask]
                   + [m for b in arch.blocks
                      for m in (b.attn.hard_mask, b.mlp.hard_mask)])
    if fuse and not bool(masks[0]):
        params, arch = fuse_params(params, arch, space, cfg)
    dev = params.pos_embed.device

    def ix(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(dev)

    e_keep = _idx(masks[1])
    D = len(e_keep)

    block_dims, meta_blocks, picks = [], [], []
    for i in range(len(arch.blocks)):
        hard = masks[2 + 2 * i]                       # (H, d)
        H_full, hd_full = hard.shape
        head_keep = _idx(hard.sum(axis=1))
        Hp = len(head_keep)
        # per kept head, kept channel ids (every kept head keeps the same
        # count by construction of the grid)
        chan_per_head = [_idx(hard[h]) for h in head_keep]
        dp = len(chan_per_head[0]) if Hp else 0
        if any(len(c) != dp for c in chan_per_head):
            raise ValueError(f"block {i}: heterogeneous per-head channel "
                             f"counts {[len(c) for c in chan_per_head]}")
        # qkv output index: q/k/v segments, within each: head h's channels
        seg = np.concatenate([h * hd_full + c for h, c in
                              zip(head_keep, chan_per_head)]) \
            if Hp else np.zeros((0,), np.int64)
        qkv_rows = np.concatenate([k * H_full * hd_full + seg
                                   for k in range(3)])
        m_keep = _idx(masks[3 + 2 * i])
        picks.append((ix(qkv_rows), ix(seg), ix(m_keep)))
        block_dims.append((Hp, dp, len(m_keep)))
        meta_blocks.append({
            "head_keep": head_keep.tolist(),
            "chan_keep": [c.tolist() for c in chan_per_head],
            "mlp_keep": m_keep.tolist(),
        })

    dense_cfg = replace(
        cfg, embed_dim=D, block_overrides=tuple(block_dims),
        num_heads=block_dims[0][0] if block_dims else cfg.num_heads,
        head_dim=block_dims[0][1] if block_dims else cfg.hd,
        mlp_hidden=block_dims[0][2] if block_dims else cfg.hidden)

    out = ViT(dense_cfg, device=dev)
    e = ix(e_keep)

    def rows_cols(w, rows, cols):
        return w.index_select(0, rows).index_select(1, cols)

    def copy_norm(dst, src):
        dst.weight.copy_(src.weight.index_select(0, e))
        dst.bias.copy_(src.bias.index_select(0, e))

    with torch.no_grad():
        out.patch_embed.proj.weight.copy_(
            params.patch_embed.proj.weight.index_select(0, e))
        out.patch_embed.proj.bias.copy_(
            params.patch_embed.proj.bias.index_select(0, e))
        for name in ("cls_token", "pos_embed", "dist_token"):
            if hasattr(params, name):
                getattr(out, name).copy_(
                    getattr(params, name).index_select(-1, e))
        copy_norm(out.norm, params.norm)
        for name in ("head", "head_dist"):
            if hasattr(params, name):
                getattr(out, name).weight.copy_(
                    getattr(params, name).weight.index_select(1, e))
                getattr(out, name).bias.copy_(getattr(params, name).bias)
        for nb, bp, (qkv_rows, seg, m) in zip(out.blocks, params.blocks,
                                              picks):
            copy_norm(nb.norm1, bp.norm1)
            copy_norm(nb.norm2, bp.norm2)
            nb.attn.qkv.weight.copy_(rows_cols(bp.attn.qkv.weight, qkv_rows, e))
            if bp.attn.qkv.bias is not None:
                nb.attn.qkv.bias.copy_(
                    bp.attn.qkv.bias.index_select(0, qkv_rows))
            nb.attn.proj.weight.copy_(rows_cols(bp.attn.proj.weight, e, seg))
            nb.attn.proj.bias.copy_(bp.attn.proj.bias.index_select(0, e))
            nb.mlp.fc1.weight.copy_(rows_cols(bp.mlp.fc1.weight, m, e))
            nb.mlp.fc1.bias.copy_(bp.mlp.fc1.bias.index_select(0, m))
            nb.mlp.fc2.weight.copy_(rows_cols(bp.mlp.fc2.weight, e, m))
            nb.mlp.fc2.bias.copy_(bp.mlp.fc2.bias.index_select(0, e))

    meta = {
        "embed_keep": e_keep.tolist(),
        "blocks": meta_blocks,
        "embed_dim": D,
        "block_dims": block_dims,
    }
    return out, dense_cfg, meta


def exported_param_count(params: torch.nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())
