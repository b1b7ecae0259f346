"""Searchable MIM Vision Transformer, the OFB supernet.

Port of ofb_tpu/models/mim_vit.py. In its default gate-fold form the
bi-mask gates are multiplied into the qkv / fc1 / patch-embed weights (a
(D, 3HD) elementwise product instead of a (B, N, 3HD) one), and the 0/1
live-embed mask into the proj / fc2 output rows; `gate_fold=False` gates
the activations instead (the JAX package's OFB_GATE_FOLD=0, same math).
Weights keep their dense shapes for the whole search; prune events only
rewrite the small `ArchState` tensors, and a pruned channel is one whose
hard mask is 0, so it carries exactly 0 through the residual stream.
`fuse_params` folds the converged scores into the weights once the search
is over.

The blocks' gates depend only on alphas, scores and arch state, so
`mim_forward` computes all of them at once on block-stacked tensors
(`stack_blocks`) before the block loop: the op count, and the host time
that dispatches it, does not grow with depth.

`mim_forward` takes an optional `token_mask` so a caller (the tests) can
hand in the PMIM mask instead of drawing it.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import gates as G
from ..ops import pmim
from .search_space import (ArchState, SearchSpace, SpaceTensors,
                           space_tensors)
from .vit import (ModelCfg, ViT, _attend, dropout, drop_path, linear,
                  patch_embed, trunc_normal_)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class Decoder(nn.Module):
    """SimMIM one-layer decoder: a 1x1 conv to p*p*C channels."""

    def __init__(self, cfg: ModelCfg, generator, device):
        super().__init__()
        out_ch = cfg.patch_size ** 2 * cfg.in_chans
        self.conv = nn.Conv2d(cfg.embed_dim, out_ch, 1, device=device)
        with torch.no_grad():
            trunc_normal_(self.conv.weight, 0.02, generator)
            self.conv.bias.zero_()


def _score(shape, searchable: bool, generator, device) -> nn.Parameter:
    """Saliency score: N(0, 0.2) when searchable, else ones."""
    if not searchable:
        return nn.Parameter(torch.ones(shape, device=device))
    return nn.Parameter(0.2 * torch.randn(shape, generator=generator,
                                          device=device))


def attn_score_shape(attn_space, H: int, hd: int) -> Tuple[int, int]:
    """(H, 1) for head-only search, (1, hd) for channel-only, else (H, hd)."""
    if not attn_space.searchable:
        return (H, hd)
    if len(attn_space.chan_ratios) == 1 and len(attn_space.head_list) > 1:
        return (H, 1)
    if len(attn_space.head_list) == 1 and len(attn_space.chan_ratios) > 1:
        return (1, hd)
    return (H, hd)


class MimViT(ViT):
    """Dense ViT parameters plus saliency scores and the MIM decoder."""

    def __init__(self, cfg: ModelCfg, space: SearchSpace, mae: bool = True,
                 generator=None, device=None):
        super().__init__(cfg, generator, device)
        D, H, hd, hid = cfg.embed_dim, cfg.num_heads, cfg.hd, cfg.hidden
        self.patch_embed.score = _score((D,), space.embed.searchable,
                                        generator, device)
        for blk, bs in zip(self.blocks, space.blocks):
            blk.attn.score = _score(attn_score_shape(bs.attn, H, hd),
                                    bs.attn.searchable, generator, device)
            blk.mlp.score = _score((hid,), bs.mlp.searchable, generator,
                                   device)
        if mae:
            self.mask_token = nn.Parameter(trunc_normal_(
                torch.empty(1, 1, D, device=device), 0.02, generator))
            self.decoder = Decoder(cfg, generator, device)


class BlockAlphas(nn.Module):
    def __init__(self, attn: torch.Tensor, mlp: torch.Tensor):
        super().__init__()
        self.attn = nn.Parameter(attn)
        self.mlp = nn.Parameter(mlp)


class Alphas(nn.Module):
    """Architecture parameters, uniform(0, 1) like torch.rand."""

    def __init__(self, space: SearchSpace, generator=None, device=None):
        super().__init__()

        def rand(*shape):
            return torch.rand(shape, generator=generator, device=device)

        self.patch = nn.Parameter(rand(space.patch.num_cells))
        self.embed = nn.Parameter(rand(space.embed.num_cells))
        self.blocks = nn.ModuleList(
            BlockAlphas(rand(*b.attn.num_cells), rand(b.mlp.num_cells))
            for b in space.blocks)


class BlockStack(NamedTuple):
    """The blocks' alphas and arch tensors stacked along a leading depth
    axis (every block of a ViT search space has the same shapes)."""

    attn_alpha: torch.Tensor      # (G, Kh, Kc)
    attn_switch: torch.Tensor     # (G, Kh, Kc)
    attn_hard: torch.Tensor       # (G, H, d)
    attn_w_p: torch.Tensor        # (G,)
    attn_finished: torch.Tensor   # (G,)
    head_alive: torch.Tensor      # (G,) fp32
    mlp_alpha: torch.Tensor       # (G, K)
    mlp_switch: torch.Tensor      # (G, K)
    mlp_hard: torch.Tensor        # (G, hidden)
    mlp_w_p: torch.Tensor         # (G,)
    mlp_finished: torch.Tensor    # (G,)


def stack_blocks(alphas: "Alphas", arch: ArchState) -> BlockStack:
    a = [b.attn for b in arch.blocks]
    m = [b.mlp for b in arch.blocks]
    return BlockStack(
        attn_alpha=torch.stack([b.attn for b in alphas.blocks]),
        attn_switch=torch.stack([x.switch for x in a]),
        attn_hard=torch.stack([x.hard_mask for x in a]),
        attn_w_p=torch.stack([x.w_p for x in a]),
        attn_finished=torch.stack([x.finished for x in a]),
        head_alive=torch.stack([x.head_alive for x in a]).float(),
        mlp_alpha=torch.stack([b.mlp for b in alphas.blocks]),
        mlp_switch=torch.stack([x.switch for x in m]),
        mlp_hard=torch.stack([x.hard_mask for x in m]),
        mlp_w_p=torch.stack([x.w_p for x in m]),
        mlp_finished=torch.stack([x.finished for x in m]))


def init_mim_params(cfg: ModelCfg, space: SearchSpace, mae: bool = True, *,
                    generator=None, device=None) -> MimViT:
    return MimViT(cfg, space, mae, generator, device)


def init_alphas(space: SearchSpace, *, generator=None, device=None) -> Alphas:
    return Alphas(space, generator, device)


# ---------------------------------------------------------------------------
# Gated sub-layers
# ---------------------------------------------------------------------------

class EmbedGates(NamedTuple):
    gate: torch.Tensor       # (D,) multiplicative gate (weighted embedding)
    support: torch.Tensor    # (D,) 0/1: channels currently representable
    restore: torch.Tensor    # (D,) restore-ordered weighted mask values


def embed_gates(params: MimViT, alphas: Alphas, arch: ArchState,
                banks: SpaceTensors, fused: bool) -> EmbedGates:
    e = arch.embed
    if fused:
        return EmbedGates(gate=e.hard_mask, support=e.hard_mask,
                          restore=e.hard_mask)
    gate, restore = G.bimask_gate_1d(
        params.patch_embed.score, alphas.embed, e.switch, banks.embed_bank,
        e.hard_mask, e.w_p, e.finished)
    support = torch.where(e.finished, e.hard_mask, (restore > 0).float())
    return EmbedGates(gate=gate, support=support, restore=restore)


def _masked_out(p: nn.Linear, y: torch.Tensor, he: torch.Tensor):
    """y @ Wᵀ + b with the 0/1 live-embed mask folded into the output rows
    (exactly the same as masking the (B, N, D) output)."""
    he = he.to(y.dtype)
    return F.linear(y, p.weight.to(y.dtype) * he[:, None],
                    p.bias.to(y.dtype) * he)


def block_gates(params: MimViT, alphas: Alphas, arch: ArchState,
                banks: SpaceTensors):
    """(attention gates (G, H, hd), MLP gates (G, hidden)) of every block,
    computed on the stacked block tensors."""
    bs = stack_blocks(alphas, arch)
    attn, _ = G.bimask_gate_attn(
        torch.stack([b.attn.score for b in params.blocks]), bs.attn_alpha,
        bs.attn_switch, banks.attn_bank, bs.attn_hard, bs.attn_w_p,
        bs.attn_finished)
    mlp, _ = G.bimask_gate_1d(
        torch.stack([b.mlp.score for b in params.blocks]), bs.mlp_alpha,
        bs.mlp_switch, banks.mlp_bank, bs.mlp_hard, bs.mlp_w_p,
        bs.mlp_finished)
    return attn, mlp


def gated_attention(p, x, gate, arch_blk, hard_embed, cfg: ModelCfg, *,
                    train=False, generator=None, gate_fold: bool = True):
    """Gated attention: the block's (H, hd) bi-mask gate (None once fused)
    is folded into the qkv weights (or, with gate_fold off, multiplied
    onto q, k and v), q/k/v go to the fused kernels, the output writes only
    live embed channels."""
    a = arch_blk.attn
    B, N, _ = x.shape
    H, hd = a.hard_mask.shape
    w = p.qkv.weight.to(x.dtype)
    b = p.qkv.bias.to(x.dtype) if p.qkv.bias is not None else None
    if gate is not None and gate_fold:
        g3 = gate.reshape(-1).repeat(3).to(x.dtype)
        w = w * g3[:, None]
        b = b * g3 if b is not None else None
    qkv = F.linear(x, w, b).reshape(B, N, 3, H, hd)
    if gate is not None and not gate_fold:
        qkv = qkv * gate.to(qkv.dtype)
    y = _attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], a.scale,
                train=train, attn_drop=cfg.attn_drop_rate,
                generator=generator)
    y = _masked_out(p.proj, y.reshape(B, N, H * hd), hard_embed)
    return dropout(y, cfg.drop_rate, train, generator)


def gated_mlp(p, x, gate, hard_embed, cfg: ModelCfg, *, train=False,
              generator=None, gate_fold: bool = True):
    """Gated MLP: the block's hidden-width gate (None once fused) folded
    into fc1's output rows, or multiplied onto fc1's output with gate_fold
    off."""
    w = p.fc1.weight.to(x.dtype)
    b = p.fc1.bias.to(x.dtype)
    if gate is not None and gate_fold:
        g = gate.to(x.dtype)
        w = w * g[:, None]
        b = b * g
    h = F.linear(x, w, b)
    if gate is not None and not gate_fold:
        h = h * gate.to(x.dtype)
    h = F.gelu(h, approximate="none")
    h = dropout(h, cfg.drop_rate, train, generator)
    h = _masked_out(p.fc2, h, hard_embed)
    return dropout(h, cfg.drop_rate, train, generator)


# ---------------------------------------------------------------------------
# Full forward
# ---------------------------------------------------------------------------

class MimOutput(NamedTuple):
    logits: torch.Tensor                   # (B, classes) fp32
    logits_dist: Optional[torch.Tensor]    # distilled head or None
    decoder_loss: torch.Tensor             # scalar fp32 (0 when MIM is off)
    token_mask: Optional[torch.Tensor]     # (B, L) PMIM mask used, or None


def mim_forward(params: MimViT, alphas: Alphas, arch: ArchState,
                x: torch.Tensor, cfg: ModelCfg, space: SearchSpace, *,
                train: bool, use_mim: bool, fused: bool = False,
                keep_ratio=None, generator=None,
                token_mask: Optional[torch.Tensor] = None,
                gate_fold: bool = True,
                compute_dtype=torch.bfloat16) -> MimOutput:
    """Search-mode forward. x (B, H, W, C) NHWC. `train`, `use_mim` (PMIM
    masking + decoder, the search phase) and `fused` (post-fuse) select
    the path; `keep_ratio` is the annealed PMIM keep fraction. Random
    draws (token mask, drop-path, dropout) come from `generator`. Without
    one, drop-path and dropout are off, as in the JAX package without an
    rng, and a PMIM forward that is handed no `token_mask` either raises
    (the JAX package cannot run there at all): torch's global generator is
    never used. `token_mask` (B, L), 1 = removed, replaces the drawn mask.
    `gate_fold` picks where the gates multiply: the weights (default) or
    the activations."""
    masked = train and use_mim and hasattr(params, "mask_token")
    if masked and token_mask is None and generator is None:
        raise ValueError("a PMIM forward (train=True, use_mim=True) needs a "
                         "`generator` to draw the token mask from, or a "
                         "`token_mask`")
    imgs = x
    x = x.to(compute_dtype)
    B = x.shape[0]
    D, T = cfg.embed_dim, cfg.num_tokens
    banks = space_tensors(space, x.device)

    eg = embed_gates(params, alphas, arch, banks, fused)
    pe = params.patch_embed.proj
    if not fused:
        gs = eg.gate * eg.support
        if gate_fold:
            tok = patch_embed(pe.weight * gs[:, None, None, None],
                              pe.bias * gs, x)
        else:
            tok = patch_embed(pe.weight, pe.bias, x)
            tok = tok * gs.to(tok.dtype)
        we = eg.gate.to(tok.dtype)            # weighted embedding
    else:
        tok = patch_embed(pe.weight, pe.bias, x)
        we = None

    pos = params.pos_embed.to(tok.dtype)
    tok = tok + (pos[:, T:] * we if we is not None else pos[:, T:])

    # PMIM masking, after the pos add and before the cls concat
    mask = None
    if masked:
        if token_mask is None:
            L = cfg.num_patches
            mask = pmim.random_token_mask(B, L, pmim.keep_count(L, keep_ratio),
                                          generator=generator,
                                          device=x.device)
        else:
            mask = token_mask.to(device=x.device, dtype=torch.float32)
        tm = mask[..., None].to(tok.dtype)
        mt = params.mask_token.to(tok.dtype)
        fill = mt * we if we is not None else mt
        tok = tok * (1.0 - tm) + tm * fill

    cls = params.cls_token.to(tok.dtype) + pos[:, :1]
    if we is not None:
        cls = cls * we
    lead = [cls.expand(B, 1, D)]
    if cfg.distilled:
        dist = params.dist_token.to(tok.dtype) + pos[:, 1:T]
        if we is not None:
            dist = dist * we
        lead.append(dist.expand(B, 1, D))
    tok = torch.cat(lead + [tok], dim=1)
    tok = dropout(tok, cfg.drop_rate, train, generator)

    hard_e = arch.embed.hard_mask
    attn_gates = mlp_gates = [None] * cfg.depth
    if not fused:
        attn_gates, mlp_gates = block_gates(params, alphas, arch, banks)
    for i, (bp, dp) in enumerate(zip(params.blocks, cfg.drop_path_schedule())):
        h = G.masked_layer_norm(tok, eg.support, bp.norm1.weight,
                                bp.norm1.bias, eps=cfg.ln_eps,
                                passthrough="identity")
        h = gated_attention(bp.attn, h, attn_gates[i], arch.blocks[i], hard_e,
                            cfg, train=train, generator=generator,
                            gate_fold=gate_fold)
        tok = tok + drop_path(h, dp, train, generator)
        h = G.masked_layer_norm(tok, eg.support, bp.norm2.weight,
                                bp.norm2.bias, eps=cfg.ln_eps,
                                passthrough="identity")
        h = gated_mlp(bp.mlp, h, mlp_gates[i], hard_e, cfg, train=train,
                      generator=generator, gate_fold=gate_fold)
        tok = tok + drop_path(h, dp, train, generator)

    latent = G.masked_layer_norm(tok, eg.support, params.norm.weight,
                                 params.norm.bias, eps=cfg.ln_eps,
                                 passthrough="zero")

    # MIM decode branch: 1x1 conv (a matmul over channels) + pixel shuffle
    decoder_loss = torch.zeros((), dtype=torch.float32, device=x.device)
    if train and use_mim and mask is not None:
        g = cfg.grid
        zimg = latent[:, T:].reshape(B, g, g, D)
        conv = params.decoder.conv
        rec = F.linear(zimg, conv.weight[:, :, 0, 0].to(zimg.dtype),
                       conv.bias.to(zimg.dtype))
        x_rec = pmim.pixel_shuffle_nhwc(rec, cfg.patch_size)
        decoder_loss = pmim.mim_reconstruction_loss(
            imgs.float(), x_rec, mask, cfg.patch_size, cfg.in_chans)

    logits = linear(params.head, latent[:, 0]).float()
    logits_dist = None
    if cfg.distilled:
        logits_dist = linear(params.head_dist, latent[:, 1]).float()
        if not train:
            logits = (logits + logits_dist) / 2.0
            logits_dist = None
    return MimOutput(logits=logits, logits_dist=logits_dist,
                     decoder_loss=decoder_loss, token_mask=mask)


def fuse_params(params: MimViT, arch: ArchState, space: SearchSpace,
                cfg: ModelCfg) -> Tuple[MimViT, ArchState]:
    """Fold the saliency scores into the weights, once, after the search:
    tokens, pos_embed, mask_token and the patch-embed conv rows and bias
    times the embed score; qkv rows and bias times the attention score
    (broadcast to (H, hd), repeated for q, k and v); fc1 rows and bias
    times the MLP score. Needs every module finished (the scores are then
    the linear gates, zero on dead dims). Returns a new model and a new
    arch state with `fused` set; the ones handed in keep their values."""
    p = copy.deepcopy(params)
    with torch.no_grad():
        es = params.patch_embed.score
        p.patch_embed.proj.weight.mul_(es[:, None, None, None])
        p.patch_embed.proj.bias.mul_(es)
        for name in ("cls_token", "pos_embed", "dist_token", "mask_token"):
            if hasattr(p, name):
                getattr(p, name).mul_(es)
        for bp, ba in zip(p.blocks, arch.blocks):
            H, hd = ba.attn.hard_mask.shape
            qkv_scale = bp.attn.score.expand(H, hd).reshape(-1).repeat(3)
            bp.attn.qkv.weight.mul_(qkv_scale[:, None])
            if bp.attn.qkv.bias is not None:
                bp.attn.qkv.bias.mul_(qkv_scale)
            bp.mlp.fc1.weight.mul_(bp.mlp.score[:, None])
            bp.mlp.fc1.bias.mul_(bp.mlp.score)
    fused = torch.ones_like(arch.fused)
    return p, dataclasses.replace(arch, fused=fused)
