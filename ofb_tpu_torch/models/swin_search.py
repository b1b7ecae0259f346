"""Searchable Swin: the OFB bi-mask search over window attention (head x
channel) and MLP hidden widths per block, and optionally the residual
width of each stage.

Port of ofb_tpu/models/swin_search.py. Swin's block widths differ from
stage to stage, so the search space records each block's own spaces and
the alphas and arch state list all stages' blocks in one flat list, as in
the JAX package. The gates of a stage's blocks (all of one shape) are
computed at once on stage-stacked tensors (`mim_vit.stack_blocks` over the
stage's block indices) before the stage's block loop.

The attention gate is folded into the qkv weight rows and the hard embed
mask into the proj / fc2 output rows, as the JAX package's default
gate-fold path does. With `embed_search` each stage has a residual-width
space whose weighted embedding is applied where the stage's stream starts
(after the patch-embed conv, or after the patch-merging reduction), whose
support masks the layer norms' moments (tiled 4x across the merging
concat) and whose hard mask masks the residual writes.

`fuse_swin_params` folds the converged scores into the weights for the
gate-free fused forward. `export_swin_subnet` slices the converged widths
into a dense `Swin`: the MLP hidden units per block and, with embed
search, the residual channels of every stage through the patch-merging
concat; the qkv width stays dense (dead channels are zero rows) with the
searched softmax scale folded into the q rows.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import gates as G
from .mim_vit import _masked_out, attn_score_shape, stack_blocks
from .search_space import (ArchState, AttnSpace, BlockSpace, DimSpace,
                           PatchSpace, SearchSpace, embed_ratio_grid)
from .swin import (Swin, SwinCfg, _rel_index, _shift_mask, merge_patches,
                   patch_conv, shifted_windows, window_softmax_attend)
from .vit import drop_path, linear


def build_swin_space(cfg: SwinCfg, *, attn_search=True, mlp_search=True,
                     head_search=False, channel_search=False,
                     embed_search=False) -> SearchSpace:
    """Per-block spaces across all stages; the global embed and patch slots
    are born finished. embed_search adds a residual-width DimSpace per
    stage."""
    blocks: List[BlockSpace] = []
    for s in range(cfg.num_stages):
        dim = cfg.stage_dim(s)
        heads = cfg.num_heads[s]
        hidden = int(dim * cfg.mlp_ratio)
        for _ in range(cfg.depths[s]):
            blocks.append(BlockSpace(
                attn=AttnSpace.build(heads, dim // heads, head_search,
                                     channel_search, attn_search),
                mlp=DimSpace(hidden,
                             tuple(i / hidden for i in
                                   range(hidden // 4, hidden + 1,
                                         hidden // 8)) if mlp_search
                             else (1.0,), mlp_search)))
    stage_embeds = tuple(
        DimSpace(cfg.stage_dim(s), embed_ratio_grid(cfg.stage_dim(s)), True)
        for s in range(cfg.num_stages)) if embed_search else ()
    return SearchSpace(embed=DimSpace(cfg.embed_dim, (1.0,), False),
                       blocks=tuple(blocks),
                       patch=PatchSpace(1, (1.0,), False),
                       stage_embeds=stage_embeds)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _randn(shape, generator, device) -> nn.Parameter:
    return nn.Parameter(0.2 * torch.randn(shape, generator=generator,
                                          device=device))


class SwinSearch(Swin):
    """Dense Swin parameters plus the saliency scores, N(0, 0.2): per
    block `attn.score` ((H, hd), (H, 1) or (1, hd) by the attention
    space) and `mlp.score`, and per stage `embed_score` with embed
    search."""

    def __init__(self, cfg: SwinCfg, space: SearchSpace, generator=None,
                 device=None):
        super().__init__(cfg, generator=generator, device=device)
        for s, stage in enumerate(self.stages):
            for i, blk in zip(cfg.stage_blocks(s), stage.blocks):
                a = space.blocks[i].attn
                blk.attn.score = _randn(
                    attn_score_shape(a, a.num_heads, a.head_dim), generator,
                    device)
                blk.mlp.score = _randn((space.blocks[i].mlp.dim,), generator,
                                       device)
            if space.stage_embeds:
                stage.embed_score = _randn((space.stage_embeds[s].dim,),
                                           generator, device)


class _BlockAlphas(nn.Module):
    def __init__(self, attn: torch.Tensor, mlp: torch.Tensor):
        super().__init__()
        self.attn = nn.Parameter(attn)
        self.mlp = nn.Parameter(mlp)


class SwinAlphas(nn.Module):
    """Architecture parameters: `patch` and `embed` ones (born finished),
    per block uniform(0, 1) `attn` and `mlp`, per stage `stage_embeds`
    with embed search."""

    def __init__(self, space: SearchSpace, generator=None, device=None):
        super().__init__()

        def rand(*shape):
            return torch.rand(shape, generator=generator, device=device)

        self.patch = nn.Parameter(torch.ones(1, device=device))
        self.embed = nn.Parameter(torch.ones(1, device=device))
        self.blocks = nn.ModuleList(
            _BlockAlphas(rand(*b.attn.num_cells), rand(b.mlp.num_cells))
            for b in space.blocks)
        if space.stage_embeds:
            self.stage_embeds = nn.ParameterList(
                rand(d.num_cells) for d in space.stage_embeds)


def init_swin_search(cfg: SwinCfg, space: SearchSpace, *, generator=None,
                     device=None):
    """(params, alphas, arch) of a Swin supernet."""
    return (SwinSearch(cfg, space, generator, device),
            SwinAlphas(space, generator, device),
            ArchState.create(space, device))


# ---------------------------------------------------------------------------
# Gates
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class StageTensors:
    """One stage's mask banks and cell sizes on one device (its blocks all
    share one space)."""
    attn_bank: torch.Tensor
    mlp_bank: torch.Tensor
    attn_sizes: torch.Tensor
    mlp_sizes: torch.Tensor
    embed_bank: Optional[torch.Tensor]
    embed_sizes: Optional[torch.Tensor]


@functools.lru_cache(maxsize=16)
def stage_tensors(space: SearchSpace, depths: Tuple[int, ...],
                  device: torch.device) -> Tuple[StageTensors, ...]:
    def t(a):
        return torch.from_numpy(a).to(device)

    out, start = [], 0
    for s, n in enumerate(depths):
        b0 = space.blocks[start]
        if any(b != b0 for b in space.blocks[start:start + n]):
            raise ValueError(f"the blocks of stage {s} differ in space")
        de = space.stage_embeds[s] if space.stage_embeds else None
        out.append(StageTensors(
            attn_bank=t(b0.attn.mask_bank), mlp_bank=t(b0.mlp.mask_bank),
            attn_sizes=t(b0.attn.cell_sizes), mlp_sizes=t(b0.mlp.cell_sizes),
            embed_bank=t(de.mask_bank) if de else None,
            embed_sizes=t(de.cell_sizes) if de else None))
        start += n
    return tuple(out)


def stage_block_gates(params: SwinSearch, alphas: SwinAlphas,
                      arch: ArchState, cfg: SwinCfg, s: int,
                      banks: StageTensors):
    """(attention gates (G, H, hd), MLP gates (G, hidden)) of stage s's G
    blocks, on stage-stacked tensors."""
    idx = cfg.stage_blocks(s)
    bs = stack_blocks(alphas, arch, idx)
    blocks = params.stages[s].blocks
    attn, _ = G.bimask_gate_attn(
        torch.stack([b.attn.score for b in blocks]), bs.attn_alpha,
        bs.attn_switch, banks.attn_bank, bs.attn_hard, bs.attn_w_p,
        bs.attn_finished)
    mlp, _ = G.bimask_gate_1d(
        torch.stack([b.mlp.score for b in blocks]), bs.mlp_alpha,
        bs.mlp_switch, banks.mlp_bank, bs.mlp_hard, bs.mlp_w_p,
        bs.mlp_finished)
    return attn, mlp


def stage_embed_gates(params: SwinSearch, alphas: SwinAlphas,
                      arch: ArchState, space: SearchSpace,
                      banks: Tuple[StageTensors, ...], fused: bool):
    """Per stage (gate, support, hard), or None without embed search: the
    gate is the weighted embedding applied where the stage's stream
    starts, the support masks the layer norms' moments, the hard mask the
    residual writes."""
    if not space.stage_embeds:
        return None
    out = []
    for s in range(len(space.stage_embeds)):
        ea = arch.stage_embeds[s]
        if fused:
            out.append((ea.hard_mask, ea.hard_mask, ea.hard_mask))
            continue
        gate, restore = G.bimask_gate_1d(
            params.stages[s].embed_score, alphas.stage_embeds[s], ea.switch,
            banks[s].embed_bank, ea.hard_mask, ea.w_p, ea.finished)
        support = torch.where(ea.finished, ea.hard_mask,
                              (restore > 0).float())
        out.append((gate, support, ea.hard_mask))
    return out


# ---------------------------------------------------------------------------
# Gated forward
# ---------------------------------------------------------------------------

def gated_window_attention(p, x, heads: int, rel_idx, mask, gate, scale,
                           hard_embed):
    """Window attention with the block's (H, hd) gate (None once fused)
    folded into the qkv weight rows and the 0/1 embed mask (or None) into
    the proj output rows. x (B*nW, w*w, C)."""
    w = p.qkv.weight.to(x.dtype)
    b = p.qkv.bias.to(x.dtype)
    if gate is not None:
        g3 = gate.reshape(-1).repeat(3).to(x.dtype)
        w = w * g3[:, None]
        b = b * g3
    y = window_softmax_attend(F.linear(x, w, b), heads, scale, p.rel_bias,
                              rel_idx, mask)
    if hard_embed is None:
        return linear(p.proj, y)
    return _masked_out(p.proj, y, hard_embed)


def _ln(x, norm, support, eps, passthrough="identity"):
    if support is None:
        return G.layer_norm(x, norm.weight, norm.bias, eps=eps)
    return G.masked_layer_norm(x, support, norm.weight, norm.bias, eps=eps,
                               passthrough=passthrough)


def swin_search_forward(params: SwinSearch, alphas: SwinAlphas,
                        arch: ArchState, x: torch.Tensor, cfg: SwinCfg,
                        space: SearchSpace, *, train: bool = False,
                        fused: bool = False, generator=None,
                        compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Gated Swin forward, x (B, H, W, 3) NHWC; returns fp32 logits.
    `fused` runs a supernet whose scores are final (gates off); drop-path
    draws from `generator` (none without one)."""
    x = x.to(compute_dtype)
    banks = stage_tensors(space, tuple(cfg.depths), x.device)
    eg = stage_embed_gates(params, alphas, arch, space, banks, fused)
    pe = params.patch_embed
    h = patch_conv(pe.proj.weight, pe.proj.bias, x)
    if eg is not None:
        g0, s0, _ = eg[0]
        if not fused:
            h = h * (g0 * s0).to(h.dtype)
        h = G.masked_layer_norm(h, s0, pe.norm.weight, pe.norm.bias,
                                eps=cfg.ln_eps, passthrough="zero")
    else:
        h = G.layer_norm(h, pe.norm.weight, pe.norm.bias, eps=cfg.ln_eps)

    w = cfg.window
    rel_idx = _rel_index(w, h.device)
    dps = cfg.drop_path_schedule()
    eps = cfg.ln_eps
    for s, stage in enumerate(params.stages):
        res = cfg.stage_res(s)
        heads = cfg.num_heads[s]
        support = eg[s][1] if eg is not None else None
        hard = eg[s][2] if eg is not None else None
        attn_g = mlp_g = [None] * cfg.depths[s]
        if not fused:
            attn_g, mlp_g = stage_block_gates(params, alphas, arch, cfg, s,
                                              banks[s])
        for b, (i, bp) in enumerate(zip(cfg.stage_blocks(s), stage.blocks)):
            shift = w // 2 if (b % 2 == 1 and res > w) else 0
            mask = _shift_mask(res, w, h.device) if shift else None
            scale = arch.blocks[i].attn.scale
            sc = _ln(h, bp.norm1, support, eps)
            att = shifted_windows(sc, w, shift, lambda win: (
                gated_window_attention(bp.attn, win, heads, rel_idx, mask,
                                       attn_g[b], scale, hard)))
            h = h + drop_path(att, dps[i], train, generator)

            y = _ln(h, bp.norm2, support, eps)
            fc1w = bp.mlp.fc1.weight.to(y.dtype)
            fc1b = bp.mlp.fc1.bias.to(y.dtype)
            if mlp_g[b] is not None:
                g = mlp_g[b].to(y.dtype)
                fc1w, fc1b = fc1w * g[:, None], fc1b * g
            y = F.gelu(F.linear(y, fc1w, fc1b), approximate="none")
            y = linear(bp.mlp.fc2, y) if hard is None \
                else _masked_out(bp.mlp.fc2, y, hard)
            h = h + drop_path(y, dps[i], train, generator)

        if hasattr(stage, "downsample"):
            ds = stage.downsample
            # channel c of stage s sits at j * C + c in the 2 x 2 concat,
            # so the support tiles 4x
            h = _ln(merge_patches(h), ds.norm,
                    support.repeat(4) if support is not None else None, eps,
                    passthrough="zero")
            h = F.linear(h, ds.reduction.weight.to(h.dtype))
            if eg is not None:
                # the reduction starts stage s+1's stream: its weighted
                # embedding
                g1, s1, _ = eg[s + 1]
                h = h * (s1 if fused else g1 * s1).to(h.dtype)

    h = _ln(h.flatten(1, 2), params.norm,
            eg[-1][1] if eg is not None else None, eps, passthrough="zero")
    return linear(params.head, h.mean(dim=1)).float()


# ---------------------------------------------------------------------------
# FLOPs model (differentiable in alpha, the ViT model's accounting)
# ---------------------------------------------------------------------------

def swin_model_flops(alphas: SwinAlphas, arch: ArchState, space: SearchSpace,
                     cfg: SwinCfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dense total, searched) GFLOPs as fp32 tensors, the searched count
    differentiable in the alphas. Each stage's blocks are summed on
    stage-stacked tensors."""
    from .swin import swin_dense_flops
    dev = alphas.embed.device
    banks = stage_tensors(space, tuple(cfg.depths), dev)

    def full(value):
        # a fill on the device, not a copy from the host: a captured step
        # may not copy
        return torch.full((), value, dtype=torch.float32, device=dev)

    def stage_de(s):
        if not space.stage_embeds:
            return full(float(cfg.stage_dim(s)))
        return (G.masked_softmax(alphas.stage_embeds[s],
                                 arch.stage_embeds[s].switch)
                * banks[s].embed_sizes).sum()

    p2 = float(cfg.patch_size ** 2)
    searched = cfg.stage_res(0) ** 2 * stage_de(0) * 3.0 * p2
    w2 = float(cfg.window ** 2)
    for s in range(cfg.num_stages):
        dim = float(cfg.stage_dim(s))
        de = stage_de(s)
        tokens = float(cfg.stage_res(s) ** 2)
        n_win = tokens / w2
        heads = float(cfg.num_heads[s])
        hd = dim / heads
        bs = stack_blocks(alphas, arch, cfg.stage_blocks(s))
        sd = (G.masked_softmax(bs.attn_alpha, bs.attn_switch, 1)
              * banks[s].attn_sizes).sum(dim=(1, 2))
        am = G.masked_softmax(bs.mlp_alpha, bs.mlp_switch, 1) \
            @ banks[s].mlp_sizes
        per_block = (2.0 * de * tokens
                     + tokens * de * 3.0 * sd / (heads * hd) * dim
                     + 3.0 * tokens * sd
                     + n_win * (sd / (heads * hd) * heads * w2 * hd * w2
                                * 2.0 + 6.0 * bs.head_alive * w2 * w2)
                     + tokens * sd * de + tokens * de
                     + (de * am + am * de + de + am) * tokens)
        searched = searched + per_block.sum()
        if s < cfg.num_stages - 1:
            t4 = tokens / 4.0
            searched = searched + t4 * 4.0 * de \
                + t4 * 4.0 * de * stage_de(s + 1)
    searched = searched + stage_de(cfg.num_stages - 1) * cfg.num_classes
    total = full(swin_dense_flops(cfg))
    return total, searched / 1e9


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------

def export_swin_subnet(params: SwinSearch, arch: ArchState,
                       space: SearchSpace, cfg: SwinCfg
                       ) -> Tuple[Swin, SwinCfg, Dict]:
    """Slice the converged widths into a dense `Swin` on the supernet's
    device: (model, cfg, meta). The scores (the linear gates after
    convergence) are folded into the qkv / fc1 rows and, with embed
    search, into where each stage's stream starts (the patch-embed conv
    rows, the reduction rows); the searched softmax scale into the q rows.
    meta holds each block's `mlp_hidden` and, with embed search, the
    `stage_dims`. The subnet runs through the plain `swin_forward`."""
    sd = {n: t.detach().float().clone() for n, t in
          params.state_dict().items()}
    meta: Dict = {"blocks": []}
    for s in range(cfg.num_stages):
        for b, i in enumerate(cfg.stage_blocks(s)):
            pre = f"stages.{s}.blocks.{b}."
            ba, bs = arch.blocks[i], space.blocks[i]
            H, hd = bs.attn.num_heads, bs.attn.head_dim
            qkv_scale = sd.pop(pre + "attn.score").expand(H, hd) \
                .reshape(-1).repeat(3)
            sd[pre + "attn.qkv.weight"] *= qkv_scale[:, None]
            sd[pre + "attn.qkv.bias"] *= qkv_scale
            m_score = sd.pop(pre + "mlp.score")
            sd[pre + "mlp.fc1.weight"] *= m_score[:, None]
            sd[pre + "mlp.fc1.bias"] *= m_score
            # the supernet attends with arch.scale (chan_cnt ** -0.5 after
            # a channel trim), the dense forward with hd ** -0.5
            ratio = float(ba.attn.scale) / (hd ** -0.5)
            if ratio != 1.0:
                sd[pre + "attn.qkv.weight"][:H * hd] *= ratio
                sd[pre + "attn.qkv.bias"][:H * hd] *= ratio
            keep = torch.nonzero(ba.mlp.hard_mask > 0).reshape(-1)
            for n in ("mlp.fc1.weight", "mlp.fc1.bias"):
                sd[pre + n] = sd[pre + n][keep]
            sd[pre + "mlp.fc2.weight"] = sd[pre + "mlp.fc2.weight"][:, keep]
            meta["blocks"].append({"mlp_hidden": int(keep.numel())})

    if space.stage_embeds:
        keeps = [torch.nonzero(e.hard_mask > 0).reshape(-1)
                 for e in arch.stage_embeds]
        scores = [sd.pop(f"stages.{s}.embed_score")
                  for s in range(cfg.num_stages)]
        k0, s0 = keeps[0], scores[0]
        sd["patch_embed.proj.weight"] = sd["patch_embed.proj.weight"][k0] \
            * s0[k0][:, None, None, None]
        sd["patch_embed.proj.bias"] = sd["patch_embed.proj.bias"][k0] * s0[k0]
        for n in ("patch_embed.norm.weight", "patch_embed.norm.bias"):
            sd[n] = sd[n][k0]
        for s in range(cfg.num_stages):
            ks = keeps[s]
            C = arch.stage_embeds[s].hard_mask.shape[0]
            for b in range(cfg.depths[s]):
                pre = f"stages.{s}.blocks.{b}."
                for n in ("norm1.weight", "norm1.bias", "norm2.weight",
                          "norm2.bias", "attn.proj.bias", "mlp.fc2.bias"):
                    sd[pre + n] = sd[pre + n][ks]
                for n in ("attn.qkv.weight", "mlp.fc1.weight"):
                    sd[pre + n] = sd[pre + n][:, ks]
                for n in ("attn.proj.weight", "mlp.fc2.weight"):
                    sd[pre + n] = sd[pre + n][ks]
            if s < cfg.num_stages - 1:
                tiled = torch.cat([ks + j * C for j in range(4)])
                pre = f"stages.{s}.downsample."
                for n in ("norm.weight", "norm.bias"):
                    sd[pre + n] = sd[pre + n][tiled]
                kn, sn = keeps[s + 1], scores[s + 1]
                sd[pre + "reduction.weight"] = \
                    sd[pre + "reduction.weight"][:, tiled][kn] * sn[kn][:, None]
        kl = keeps[-1]
        for n in ("norm.weight", "norm.bias"):
            sd[n] = sd[n][kl]
        sd["head.weight"] = sd["head.weight"][:, kl]
        meta["stage_dims"] = [int(k.numel()) for k in keeps]

    dev = next(params.parameters()).device
    dense = Swin(cfg, stage_dims=meta.get("stage_dims"),
                 mlp_hidden=[b["mlp_hidden"] for b in meta["blocks"]],
                 device=dev)
    dense.load_state_dict(sd, strict=True)
    return dense, cfg, meta


def fuse_swin_params(params: SwinSearch, arch: ArchState,
                     space: SearchSpace, cfg: SwinCfg
                     ) -> Tuple[SwinSearch, ArchState]:
    """Fold the converged scores into the weights: qkv rows and bias times
    the attention score, fc1 rows and bias times the MLP score and, with
    embed search, the rows that start each stage's stream (the patch-embed
    conv and bias, the previous stage's reduction) times the stage's embed
    score. Needs every module finished. Returns a new model and a new arch
    state with `fused` set, which `swin_search_forward(fused=True)` runs
    with the hard masks alone."""
    p = copy.deepcopy(params)
    with torch.no_grad():
        for s, stage in enumerate(p.stages):
            for i, bp in zip(cfg.stage_blocks(s), stage.blocks):
                a = space.blocks[i].attn
                qkv_scale = bp.attn.score.expand(a.num_heads, a.head_dim) \
                    .reshape(-1).repeat(3)
                bp.attn.qkv.weight.mul_(qkv_scale[:, None])
                bp.attn.qkv.bias.mul_(qkv_scale)
                bp.mlp.fc1.weight.mul_(bp.mlp.score[:, None])
                bp.mlp.fc1.bias.mul_(bp.mlp.score)
            if space.stage_embeds:
                es = stage.embed_score
                if s == 0:
                    p.patch_embed.proj.weight.mul_(es[:, None, None, None])
                    p.patch_embed.proj.bias.mul_(es)
                else:
                    p.stages[s - 1].downsample.reduction.weight.mul_(
                        es[:, None])
    return p, dataclasses.replace(arch, fused=torch.ones_like(arch.fused))
