"""Vision Transformer pieces of the port.

Port of ofb_tpu/models/vit.py: the static `ModelCfg`, the forward
primitives (patch embed, linear, attention, MLP, drop-path, dropout,
blocks) and the dense `vit_forward`. Parameters live in `nn.Module`s in
PyTorch layouts (Linear weight (out, in), conv weight OIHW) and stay fp32;
each use casts them to the compute dtype, as the JAX package does. Public
functions keep JAX's layouts: images NHWC, tokens (B, N, D), attention
q/k/v (B, N, H, d).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import fused_mha
from ..ops.gates import layer_norm


@dataclass(frozen=True)
class ModelCfg:
    """Static model hyper-parameters. `head_dim` / `mlp_hidden` may be set
    for exported subnets; `block_overrides` gives per-block
    (num_heads, head_dim, mlp_hidden) when blocks were pruned apart. The
    in21k pre-logits layer (`representation_size`) is not ported yet."""

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
    qk_scale: Optional[float] = None
    distilled: bool = False
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    ln_eps: float = 1e-6
    block_overrides: Optional[Tuple[Tuple[int, int, int], ...]] = None

    def block_dims(self, i: int) -> Tuple[int, int, int]:
        if self.block_overrides is not None:
            return self.block_overrides[i]
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

    @property
    def num_tokens(self) -> int:
        return 2 if self.distilled else 1

    def drop_path_schedule(self) -> Tuple[float, ...]:
        """Stochastic-depth decay rule: linspace(0, rate, depth)."""
        return tuple(np.linspace(0, self.drop_path_rate, self.depth).tolist())


# ---------------------------------------------------------------------------
# Parameter modules (DeiT init: trunc-normal .02, zero biases, LN ones)
# ---------------------------------------------------------------------------

def trunc_normal_(t: torch.Tensor, std: float, generator) -> torch.Tensor:
    """std * truncated_normal(-2, 2), in place."""
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


def _linear(d_in, d_out, bias, generator, device) -> nn.Linear:
    m = nn.Linear(d_in, d_out, bias=bias, device=device)
    with torch.no_grad():
        trunc_normal_(m.weight, 0.02, generator)
        if bias:
            m.bias.zero_()
    return m


def _ln(dim, eps, device) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=eps, device=device)   # ones / zeros


class Attention(nn.Module):
    def __init__(self, cfg: ModelCfg, H, hd, generator, device):
        super().__init__()
        D = cfg.embed_dim
        self.qkv = _linear(D, 3 * H * hd, cfg.qkv_bias, generator, device)
        self.proj = _linear(H * hd, D, True, generator, device)


class Mlp(nn.Module):
    def __init__(self, cfg: ModelCfg, hidden, generator, device):
        super().__init__()
        self.fc1 = _linear(cfg.embed_dim, hidden, True, generator, device)
        self.fc2 = _linear(hidden, cfg.embed_dim, True, generator, device)


class Block(nn.Module):
    def __init__(self, cfg: ModelCfg, i: int, generator, device):
        super().__init__()
        H, hd, hidden = cfg.block_dims(i)
        self.norm1 = _ln(cfg.embed_dim, cfg.ln_eps, device)
        self.attn = Attention(cfg, H, hd, generator, device)
        self.norm2 = _ln(cfg.embed_dim, cfg.ln_eps, device)
        self.mlp = Mlp(cfg, hidden, generator, device)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ModelCfg, generator, device):
        super().__init__()
        D, p = cfg.embed_dim, cfg.patch_size
        self.proj = nn.Conv2d(cfg.in_chans, D, p, stride=p, device=device)
        # initialised like nn.Linear over the flattened patch (xavier)
        limit = math.sqrt(6.0 / (p * p * cfg.in_chans + D))
        with torch.no_grad():
            self.proj.weight.uniform_(-limit, limit, generator=generator)
            self.proj.bias.zero_()


class ViT(nn.Module):
    """Parameters of the dense ViT (names follow the JAX tree: `kernel`
    becomes `weight`, LayerNorm `scale` becomes `weight`)."""

    def __init__(self, cfg: ModelCfg, generator=None, device=None):
        super().__init__()
        D = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg, generator, device)
        self.cls_token = nn.Parameter(trunc_normal_(
            torch.empty(1, 1, D, device=device), 0.02, generator))
        self.pos_embed = nn.Parameter(trunc_normal_(
            torch.empty(1, cfg.num_patches + cfg.num_tokens, D,
                        device=device), 0.02, generator))
        if cfg.distilled:
            self.dist_token = nn.Parameter(trunc_normal_(
                torch.empty(1, 1, D, device=device), 0.02, generator))
        self.blocks = nn.ModuleList(
            Block(cfg, i, generator, device) for i in range(cfg.depth))
        self.norm = _ln(D, cfg.ln_eps, device)
        if cfg.num_classes > 0:
            self.head = _linear(D, cfg.num_classes, True, generator, device)
        if cfg.distilled:
            self.head_dist = _linear(D, cfg.num_classes, True, generator,
                                     device)


# ---------------------------------------------------------------------------
# Forward primitives
# ---------------------------------------------------------------------------

def linear(p: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """x @ Wᵀ + b with the weights cast to x's dtype."""
    b = p.bias.to(x.dtype) if p.bias is not None else None
    return F.linear(x, p.weight.to(x.dtype), b)


def patch_embed(weight, bias, x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) NHWC image -> (B, N, D) tokens by the strided conv
    (weight OIHW)."""
    w = weight.to(x.dtype)
    p = w.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2), w, bias.to(x.dtype), stride=p)
    return y.flatten(2).transpose(1, 2)


def dropout(x, rate: float, train: bool, generator=None):
    """Inverted dropout; draws from `generator` (None: torch's default)."""
    if not train or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def drop_path(x, rate: float, train: bool, generator=None):
    """Stochastic depth: drop the whole residual branch per sample."""
    if not train or rate <= 0.0:
        return x
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    keep = torch.rand(shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def _attend(q, k, v, scale, *, train=False, attn_drop=0.0, generator=None):
    """Softmax attention over (B, N, H, hd). With attention dropout live
    (training, attn_drop > 0) the matrix must exist, so the plain path
    runs; every other call goes to the fused kernels."""
    if train and attn_drop > 0.0:
        attn = torch.einsum("bnhd,bmhd->bhnm", q, k).float()
        attn = torch.softmax(attn * scale, dim=-1).to(q.dtype)
        attn = dropout(attn, attn_drop, train, generator)
        return torch.einsum("bhnm,bmhd->bnhd", attn, v)
    return fused_mha(q, k, v, scale)


def attention(p: Attention, x, *, num_heads: int, scale, train=False,
              attn_drop=0.0, proj_drop=0.0, generator=None):
    """Standard MHA: one fused qkv projection, softmax in fp32."""
    B, N, _ = x.shape
    qkv = linear(p.qkv, x)
    hd = qkv.shape[-1] // (3 * num_heads)
    qkv = qkv.reshape(B, N, 3, num_heads, hd)
    y = _attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], scale, train=train,
                attn_drop=attn_drop, generator=generator)
    y = linear(p.proj, y.reshape(B, N, num_heads * hd))
    return dropout(y, proj_drop, train, generator)


def mlp(p: Mlp, x, *, train=False, drop=0.0, generator=None):
    y = F.gelu(linear(p.fc1, x), approximate="none")
    y = dropout(y, drop, train, generator)
    return dropout(linear(p.fc2, y), drop, train, generator)


def block_forward(p: Block, x, cfg: ModelCfg, dp_rate: float, *, train=False,
                  generator=None, block_idx: int = 0):
    num_heads, head_dim, _ = cfg.block_dims(block_idx)
    scale = cfg.qk_scale if cfg.qk_scale is not None else head_dim ** -0.5
    h = layer_norm(x, p.norm1.weight, p.norm1.bias, eps=cfg.ln_eps)
    h = attention(p.attn, h, num_heads=num_heads, scale=scale, train=train,
                  attn_drop=cfg.attn_drop_rate, proj_drop=cfg.drop_rate,
                  generator=generator)
    x = x + drop_path(h, dp_rate, train, generator)
    h = layer_norm(x, p.norm2.weight, p.norm2.bias, eps=cfg.ln_eps)
    h = mlp(p.mlp, h, train=train, drop=cfg.drop_rate, generator=generator)
    return x + drop_path(h, dp_rate, train, generator)


def vit_forward(params: ViT, x, cfg: ModelCfg, *, train: bool = False,
                generator=None, compute_dtype=torch.bfloat16):
    """Dense ViT forward; x (B, H, W, C) NHWC. Returns fp32 logits, or for
    distilled models in training (logits, logits_dist)."""
    x = x.to(compute_dtype)
    B = x.shape[0]
    tok = patch_embed(params.patch_embed.proj.weight,
                      params.patch_embed.proj.bias, x)
    D = tok.shape[-1]
    lead = [params.cls_token.to(tok.dtype).expand(B, 1, D)]
    if cfg.distilled:
        lead.append(params.dist_token.to(tok.dtype).expand(B, 1, D))
    tok = torch.cat(lead + [tok], dim=1) + params.pos_embed.to(tok.dtype)
    tok = dropout(tok, cfg.drop_rate, train, generator)
    for i, (bp, dp) in enumerate(zip(params.blocks, cfg.drop_path_schedule())):
        tok = block_forward(bp, tok, cfg, dp, train=train, generator=generator,
                            block_idx=i)
    tok = layer_norm(tok, params.norm.weight, params.norm.bias, eps=cfg.ln_eps)
    if cfg.distilled:
        logits = linear(params.head, tok[:, 0]).float()
        logits_d = linear(params.head_dist, tok[:, 1]).float()
        if train:
            return logits, logits_d
        return (logits + logits_d) / 2.0
    return linear(params.head, tok[:, 0]).float()


def dense_flops(cfg: ModelCfg) -> float:
    """Analytic GFLOPs of the dense model (the reference's accounting)."""
    N = cfg.num_patches
    D = cfg.embed_dim
    flops = N * D * 3 * cfg.patch_size ** 2                 # patch embed
    for i in range(cfg.depth):
        H, hd, hid = cfg.block_dims(i)
        flops += 2 * D * N                                  # norms
        flops += N * D * (3 * H * hd) + 3 * N * H * hd      # qkv
        flops += H * N * hd * N + H * N * N                 # q@k
        flops += 5 * H * N * N                              # softmax
        flops += H * N * N * hd                             # attn@v
        flops += N * (H * hd * D) + N * D                   # proj
        flops += (D * hid + hid * D + D + hid) * N          # mlp
    head_mult = 2 if cfg.distilled else 1
    flops += head_mult * D * cfg.num_classes
    return flops / 1e9
