"""The plain reference's models and losses: the dense ViT, the gated OFB
supernet with its PMIM decoder, the classification losses and the OFB arch
loss (sparsity + FLOPs), in fp32 with plain softmax attention.

A frozen copy of the program's model code (its default paths: the gates
folded into the weights, no tensor parallelism, no distilled head), so
that a later change to the program cannot move the yardstick it is held
to. It imports nothing of the program. Parameters carry the program's
names, so the benchmark's seeded weights land on the same tensors on both
sides. Every matrix product goes through `numerics`, which the control
rounds to float8; every random draw goes through `rows.draw_rows`, in the
program's order, so a generator in the same state draws the same masks.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import gates as G
from . import numerics as num
from . import pmim
from .rows import draw_rows
from .space import ArchState, SearchSpace, space_tensors


@dataclass(frozen=True)
class ModelCfg:
    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    num_classes: int = 1000
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    head_dim: Optional[int] = None
    mlp_hidden: Optional[int] = None
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_path_rate: float = 0.0
    ln_eps: float = 1e-6
    block_overrides: Optional[Tuple[Tuple[int, int, int], ...]] = None

    def block_dims(self, i: int) -> Tuple[int, int, int]:
        if self.block_overrides is not None:
            return tuple(self.block_overrides[i])
        return (self.num_heads, self.hd, self.hidden)

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else (
            self.embed_dim // self.num_heads)

    @property
    def hidden(self) -> int:
        return self.mlp_hidden if self.mlp_hidden is not None else int(
            self.embed_dim * self.mlp_ratio)

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    num_tokens = 1

    def drop_path_schedule(self) -> Tuple[float, ...]:
        return tuple(np.linspace(0, self.drop_path_rate, self.depth).tolist())


# ---------------------------------------------------------------------------
# Parameters (the program's names; made on the meta device, filled by the
# benchmark's seeded weights)
# ---------------------------------------------------------------------------

class _Attn(nn.Module):
    def __init__(self, D, H, hd, bias):
        super().__init__()
        self.qkv = nn.Linear(D, 3 * H * hd, bias=bias, device="meta")
        self.proj = nn.Linear(H * hd, D, device="meta")


class _Mlp(nn.Module):
    def __init__(self, D, hidden):
        super().__init__()
        self.fc1 = nn.Linear(D, hidden, device="meta")
        self.fc2 = nn.Linear(hidden, D, device="meta")


class _Block(nn.Module):
    def __init__(self, cfg: ModelCfg, i: int):
        super().__init__()
        H, hd, hidden = cfg.block_dims(i)
        D = cfg.embed_dim
        self.norm1 = nn.LayerNorm(D, eps=cfg.ln_eps, device="meta")
        self.attn = _Attn(D, H, hd, cfg.qkv_bias)
        self.norm2 = nn.LayerNorm(D, eps=cfg.ln_eps, device="meta")
        self.mlp = _Mlp(D, hidden)


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: ModelCfg):
        super().__init__()
        self.proj = nn.Conv2d(cfg.in_chans, cfg.embed_dim, cfg.patch_size,
                              stride=cfg.patch_size, device="meta")


def _meta(*shape):
    return nn.Parameter(torch.empty(shape, device="meta"))


class ViT(nn.Module):
    def __init__(self, cfg: ModelCfg):
        super().__init__()
        D = cfg.embed_dim
        self.patch_embed = _PatchEmbed(cfg)
        self.cls_token = _meta(1, 1, D)
        self.pos_embed = _meta(1, cfg.num_patches + 1, D)
        self.blocks = nn.ModuleList(_Block(cfg, i) for i in range(cfg.depth))
        self.norm = nn.LayerNorm(D, eps=cfg.ln_eps, device="meta")
        self.head = nn.Linear(D, cfg.num_classes, device="meta")


class _Decoder(nn.Module):
    def __init__(self, cfg: ModelCfg):
        super().__init__()
        self.conv = nn.Conv2d(cfg.embed_dim,
                              cfg.patch_size ** 2 * cfg.in_chans, 1,
                              device="meta")


def attn_score_shape(attn_space, H: int, hd: int) -> Tuple[int, int]:
    if not attn_space.searchable:
        return (H, hd)
    if len(attn_space.chan_ratios) == 1 and len(attn_space.head_list) > 1:
        return (H, 1)
    if len(attn_space.head_list) == 1 and len(attn_space.chan_ratios) > 1:
        return (1, hd)
    return (H, hd)


class MimViT(ViT):
    def __init__(self, cfg: ModelCfg, space: SearchSpace):
        super().__init__(cfg)
        self.patch_embed.score = _meta(cfg.embed_dim)
        for blk, bs in zip(self.blocks, space.blocks):
            blk.attn.score = _meta(*attn_score_shape(bs.attn, cfg.num_heads,
                                                     cfg.hd))
            blk.mlp.score = _meta(cfg.hidden)
        self.mask_token = _meta(1, 1, cfg.embed_dim)
        self.decoder = _Decoder(cfg)


class _BlockAlphas(nn.Module):
    def __init__(self, attn_cells, mlp_cells):
        super().__init__()
        self.attn = _meta(*attn_cells)
        self.mlp = _meta(mlp_cells)


class Alphas(nn.Module):
    def __init__(self, space: SearchSpace):
        super().__init__()
        self.patch = _meta(space.patch.num_cells)
        self.embed = _meta(space.embed.num_cells)
        self.blocks = nn.ModuleList(
            _BlockAlphas(b.attn.num_cells, b.mlp.num_cells)
            for b in space.blocks)


# ---------------------------------------------------------------------------
# Forward primitives
# ---------------------------------------------------------------------------

def patch_embed(weight, bias, x):
    """(B, H, W, C) NHWC -> (B, N, D) by the strided convolution."""
    y = num.conv2d(x.permute(0, 3, 1, 2), weight, bias, weight.shape[-1])
    return y.flatten(2).transpose(1, 2)


def drop_path(x, rate: float, train: bool, generator):
    if not train or rate <= 0.0 or generator is None:
        return x
    tail = (1,) * (x.dim() - 1)
    keep = draw_rows(lambda n: torch.rand((n,) + tail, generator=generator,
                                          device=x.device),
                     x.shape[0]) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def _masked_out(p: nn.Linear, y, he):
    return num.linear(y, p.weight * he[:, None], p.bias * he)


class BlockStack(NamedTuple):
    attn_alpha: torch.Tensor
    attn_switch: torch.Tensor
    attn_hard: torch.Tensor
    attn_w_p: torch.Tensor
    attn_finished: torch.Tensor
    head_alive: torch.Tensor
    mlp_alpha: torch.Tensor
    mlp_switch: torch.Tensor
    mlp_hard: torch.Tensor
    mlp_w_p: torch.Tensor
    mlp_finished: torch.Tensor


def stack_blocks(alphas: Alphas, arch: ArchState) -> BlockStack:
    a = [b.attn for b in arch.blocks]
    m = [b.mlp for b in arch.blocks]
    al = list(alphas.blocks)
    return BlockStack(
        attn_alpha=torch.stack([b.attn for b in al]),
        attn_switch=torch.stack([x.switch for x in a]),
        attn_hard=torch.stack([x.hard_mask for x in a]),
        attn_w_p=torch.stack([x.w_p for x in a]),
        attn_finished=torch.stack([x.finished for x in a]),
        head_alive=torch.stack([x.head_alive for x in a]).float(),
        mlp_alpha=torch.stack([b.mlp for b in al]),
        mlp_switch=torch.stack([x.switch for x in m]),
        mlp_hard=torch.stack([x.hard_mask for x in m]),
        mlp_w_p=torch.stack([x.w_p for x in m]),
        mlp_finished=torch.stack([x.finished for x in m]))


class SearchOut(NamedTuple):
    logits: torch.Tensor
    decoder_loss: torch.Tensor


def mim_forward(params: MimViT, alphas: Alphas, arch: ArchState, x,
                cfg: ModelCfg, space: SearchSpace, *, keep_ratio,
                generator) -> SearchOut:
    """The search phase's training forward: the gated supernet, the PMIM
    token mask drawn from `generator`, the decoder's loss."""
    imgs = x
    B = x.shape[0]
    D, T = cfg.embed_dim, 1
    banks = space_tensors(space, x.device)
    e = arch.embed
    gate, restore = G.bimask_gate_1d(
        params.patch_embed.score, alphas.embed, e.switch, banks.embed_bank,
        e.hard_mask, e.w_p, e.finished)
    support = torch.where(e.finished, e.hard_mask, (restore > 0).float())
    pe = params.patch_embed.proj
    gs = gate * support
    tok = patch_embed(pe.weight * gs[:, None, None, None], pe.bias * gs, x)
    we = gate
    pos = params.pos_embed
    tok = tok + pos[:, T:] * we

    L = cfg.num_patches
    keep = pmim.keep_count(L, keep_ratio)
    mask = draw_rows(lambda n: pmim.random_token_mask(
        n, L, keep, generator=generator, device=x.device), B)
    tm = mask[..., None]
    tok = tok * (1.0 - tm) + tm * (params.mask_token * we)
    cls = (params.cls_token + pos[:, :1]) * we
    tok = torch.cat([cls.expand(B, 1, D), tok], dim=1)

    hard_e = arch.embed.hard_mask
    bs = stack_blocks(alphas, arch)
    attn_gates, _ = G.bimask_gate_attn(
        torch.stack([b.attn.score for b in params.blocks]), bs.attn_alpha,
        bs.attn_switch, banks.attn_bank, bs.attn_hard, bs.attn_w_p,
        bs.attn_finished)
    mlp_gates, _ = G.bimask_gate_1d(
        torch.stack([b.mlp.score for b in params.blocks]), bs.mlp_alpha,
        bs.mlp_switch, banks.mlp_bank, bs.mlp_hard, bs.mlp_w_p,
        bs.mlp_finished)

    for i, (bp, dp) in enumerate(zip(params.blocks,
                                     cfg.drop_path_schedule())):
        h = G.masked_layer_norm(tok, support, bp.norm1.weight, bp.norm1.bias,
                                eps=cfg.ln_eps, passthrough="identity")
        a = arch.blocks[i].attn
        N = h.shape[1]
        H, hd = a.hard_mask.shape
        g3 = attn_gates[i].reshape(-1).repeat(3)
        qkv = num.linear(h, bp.attn.qkv.weight * g3[:, None],
                         bp.attn.qkv.bias * g3).reshape(B, N, 3, H, hd)
        y = num.attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], a.scale)
        h = _masked_out(bp.attn.proj, y.reshape(B, N, H * hd), hard_e)
        tok = tok + drop_path(h, dp, True, generator)
        h = G.masked_layer_norm(tok, support, bp.norm2.weight, bp.norm2.bias,
                                eps=cfg.ln_eps, passthrough="identity")
        g = mlp_gates[i]
        h = num.linear(h, bp.mlp.fc1.weight * g[:, None], bp.mlp.fc1.bias * g)
        h = F.gelu(h, approximate="none")
        h = _masked_out(bp.mlp.fc2, h, hard_e)
        tok = tok + drop_path(h, dp, True, generator)

    latent = G.masked_layer_norm(tok, support, params.norm.weight,
                                 params.norm.bias, eps=cfg.ln_eps,
                                 passthrough="zero")
    g = cfg.grid
    zimg = latent[:, T:].reshape(B, g, g, D)
    conv = params.decoder.conv
    rec = num.linear(zimg, conv.weight[:, :, 0, 0], conv.bias)
    x_rec = pmim.pixel_shuffle_nhwc(rec, cfg.patch_size)
    dec = pmim.mim_reconstruction_loss(imgs.float(), x_rec, mask,
                                       cfg.patch_size, cfg.in_chans)
    logits = num.linear(latent[:, 0], params.head.weight, params.head.bias)
    return SearchOut(logits=logits.float(), decoder_loss=dec)


def vit_forward(params: ViT, x, cfg: ModelCfg, *, generator):
    """The dense ViT's training forward (drop-path drawn from
    `generator`); fp32 logits."""
    B = x.shape[0]
    tok = patch_embed(params.patch_embed.proj.weight,
                      params.patch_embed.proj.bias, x)
    D = tok.shape[-1]
    tok = torch.cat([params.cls_token.expand(B, 1, D), tok], dim=1) \
        + params.pos_embed
    for i, (bp, dp) in enumerate(zip(params.blocks,
                                     cfg.drop_path_schedule())):
        H, hd, _ = cfg.block_dims(i)
        h = G.layer_norm(tok, bp.norm1.weight, bp.norm1.bias, eps=cfg.ln_eps)
        N = h.shape[1]
        qkv = num.linear(h, bp.attn.qkv.weight, bp.attn.qkv.bias)
        qkv = qkv.reshape(B, N, 3, H, hd)
        y = num.attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                          hd ** -0.5)
        h = num.linear(y.reshape(B, N, H * hd), bp.attn.proj.weight,
                       bp.attn.proj.bias)
        tok = tok + drop_path(h, dp, True, generator)
        h = G.layer_norm(tok, bp.norm2.weight, bp.norm2.bias, eps=cfg.ln_eps)
        h = F.gelu(num.linear(h, bp.mlp.fc1.weight, bp.mlp.fc1.bias),
                   approximate="none")
        h = num.linear(h, bp.mlp.fc2.weight, bp.mlp.fc2.bias)
        tok = tok + drop_path(h, dp, True, generator)
    tok = G.layer_norm(tok, params.norm.weight, params.norm.bias,
                       eps=cfg.ln_eps)
    return num.linear(tok[:, 0], params.head.weight,
                      params.head.bias).float()


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def label_smoothing_ce(logits, labels, smoothing: float):
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, labels[:, None].long())[:, 0]
    smooth = -logp.mean(dim=-1)
    return ((1.0 - smoothing) * nll + smoothing * smooth).mean()


def soft_target_ce(logits, target):
    logp = F.log_softmax(logits.float(), dim=-1)
    return (-target * logp).sum(dim=-1).mean()


def _cell_loss(alpha, switch, *, entropy: bool, var: bool,
               divide_var_by_n: bool, batch_dims: int = 0):
    sw = switch.flatten(batch_dims)
    n_active = sw.float().sum(dim=-1)
    p = G.masked_softmax(alpha, switch, batch_dims).flatten(batch_dims)
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


def _score_norm(score, hard_mask, weight: float, batch_dims: int = 0):
    w = hard_mask
    for ax in range(batch_dims, score.dim()):
        if score.shape[ax] == 1 and w.shape[ax] != 1:
            w = w.amax(dim=ax, keepdim=True)
    return (torch.sigmoid(score.float()) * w).flatten(batch_dims).sum(
        dim=-1) * weight


def _group_loss(alpha, switch, score, hard_mask, weight: float, bd: int, *,
                entropy: bool, var: bool, norm: bool):
    loss = _cell_loss(alpha, switch, entropy=entropy, var=var,
                      divide_var_by_n=True, batch_dims=bd)
    if norm:
        live = switch.flatten(bd).sum(dim=-1) > 1
        loss = loss + torch.where(
            live, _score_norm(score, hard_mask, weight, bd), 0.0)
    return loss.sum()


def _wsum_1d(alpha, switch, sizes, batch_dims=0):
    return G.masked_softmax(alpha, switch, batch_dims) @ sizes


def searched_gflops(alphas, arch: ArchState, space: SearchSpace,
                    cfg: ModelCfg):
    """(the dense supernet's GFLOPs, a float; the alpha-weighted searched
    GFLOPs, an fp32 tensor): the search's FLOPs model."""
    N = float(cfg.num_patches)
    D = float(cfg.embed_dim)
    H = float(cfg.num_heads)
    hd = float(cfg.hd)
    hid = float(cfg.hidden)
    C = float(cfg.num_classes)
    p2 = float(cfg.patch_size ** 2)
    block_total = (2.0 * D * N
                   + N * (H * hd * (3 * H * hd)) + 3 * N * H * hd
                   + H * N * hd * N + H * N * N
                   + 5 * H * N * N
                   + H * N * N * hd
                   + N * (H * hd * (H * hd)) + N * H * hd
                   + (2.0 * (D * hid) + D + hid) * N)
    total = N * D * 3.0 * p2 + cfg.depth * block_total + D * C
    st = space_tensors(space, alphas.embed.device)
    ae = _wsum_1d(alphas.embed, arch.embed.switch, st.embed_sizes)
    ap = _wsum_1d(alphas.patch, arch.patch.switch, st.patch_sizes)
    n = torch.where(arch.patch.pruned_once, ap, torch.full_like(ap, N))
    alive_e = arch.embed.hard_mask.sum()
    bs = stack_blocks(alphas, arch)
    pa = G.masked_softmax(bs.attn_alpha, bs.attn_switch, batch_dims=1)
    sd = (pa * st.attn_sizes).sum(dim=(1, 2))
    am = _wsum_1d(bs.mlp_alpha, bs.mlp_switch, st.mlp_sizes, 1)
    aH = bs.head_alive
    per_block = (2.0 * alive_e * n
                 + n * (ae * (3.0 * sd)) + 3.0 * n * sd
                 + n * n * sd + aH * n * n
                 + 5.0 * aH * n * n
                 + n * n * sd
                 + n * (sd * ae) + n * ae
                 + (ae * am + am * ae + ae + am) * n)
    searched = N * ae * 3.0 * p2 + per_block.sum() + ae * C
    return total / 1e9, searched / 1e9


def ofb_arch_loss(params: MimViT, alphas: Alphas, arch: ArchState,
                  space: SearchSpace, cfg: ModelCfg, scfg) -> torch.Tensor:
    """w_head attn + w_mlp mlp + w_patch patch + w_embedding embed
    sparsity, plus w_flops ((searched - target) / total)²."""
    total, searched = searched_gflops(alphas, arch, space, cfg)
    fl = ((searched - scfg.target_flops) / total).square()
    kw = dict(entropy=scfg.entropy, var=scfg.var, norm=scfg.norm)
    zero = torch.zeros((), dtype=torch.float32, device=alphas.embed.device)
    loss_patch = _cell_loss(alphas.patch, arch.patch.switch, entropy=True,
                            var=True, divide_var_by_n=False)
    loss_embed = zero
    if space.embed.searchable:
        loss_embed = _group_loss(alphas.embed, arch.embed.switch,
                                 params.patch_embed.score,
                                 arch.embed.hard_mask, 1e-4, 0, **kw)
    loss_attn = loss_mlp = zero
    b0 = space.blocks[0]
    bs = stack_blocks(alphas, arch)
    if b0.attn.searchable:
        loss_attn = _group_loss(
            bs.attn_alpha, bs.attn_switch,
            torch.stack([b.attn.score for b in params.blocks]), bs.attn_hard,
            4e-4, 1, **kw)
    if b0.mlp.searchable:
        loss_mlp = _group_loss(
            bs.mlp_alpha, bs.mlp_switch,
            torch.stack([b.mlp.score for b in params.blocks]), bs.mlp_hard,
            1e-4, 1, **kw)
    return (scfg.w_head * loss_attn + scfg.w_mlp * loss_mlp
            + scfg.w_patch * loss_patch + scfg.w_embedding * loss_embed
            + scfg.w_flops * fl)


def named_leaves(params: nn.Module, alphas: Optional[nn.Module] = None
                 ) -> Dict[str, torch.Tensor]:
    out = dict(params.named_parameters())
    if alphas is not None:
        out.update({f"alphas.{n}": p for n, p in alphas.named_parameters()})
    return out
