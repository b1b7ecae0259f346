"""Dense Swin Transformer of the port.

Port of ofb_tpu/models/swin.py: the static `SwinCfg`, the window helpers
(pure reshapes and permutes), the relative-position index and the
shifted-window mask (numpy constants, copied to a device once), the
parameter modules and the dense `swin_forward`. Images and activations are
NHWC as in the JAX package; weights are in PyTorch layouts (Linear weight
(out, in), conv weight OIHW), fp32, cast to the compute dtype at each use.

Window attention (two products and an fp32 softmax over 49-token windows
with the relative-position bias and the shift mask, which the JAX package
computes as plain jnp outside any Pallas kernel) is the eager chain on a
CPU tensor and a hand-written CUDA kernel pair on the card
(ops/window_attention.py). Its widths are shape-driven: the qkv width
comes from the qkv output, so an exported subnet whose residual width was cut keeps the dense qkv inner
width and runs through the same forward.

The JAX package can pack G windows into one block-diagonal attention
(`OFB_SWIN_PACK`), a layout device for the TPU's matrix unit with the same
math; the port computes the unpacked form only.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.gates import layer_norm
from ..ops.window_attention import window_attention
from ..utils.profiling import span_begin, span_end
from .vit import drop_path, linear, trunc_normal_

NEG_INF = -1e9
WINDOW_ATTENTION_RANGE = "swin.window_attention"


@dataclass(frozen=True)
class SwinCfg:
    img_size: int = 224
    patch_size: int = 4
    in_chans: int = 3
    num_classes: int = 1000
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window: int = 7
    mlp_ratio: float = 4.0
    drop_rate: float = 0.0
    drop_path_rate: float = 0.1
    ln_eps: float = 1e-5

    @property
    def num_stages(self) -> int:
        return len(self.depths)

    def stage_dim(self, s: int) -> int:
        return self.embed_dim * (2 ** s)

    def stage_res(self, s: int) -> int:
        return self.img_size // self.patch_size // (2 ** s)

    def drop_path_schedule(self):
        return np.linspace(0, self.drop_path_rate, sum(self.depths)).tolist()

    def stage_blocks(self, s: int) -> range:
        """Indices of stage s's blocks in the flat block list."""
        start = sum(self.depths[:s])
        return range(start, start + self.depths[s])


# ---------------------------------------------------------------------------
# Window helpers
# ---------------------------------------------------------------------------

def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, w*w, C)"""
    B, H, W, C = x.shape
    x = x.reshape(B, H // w, w, W // w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, C)


def window_reverse(x: torch.Tensor, w: int, H: int, W: int) -> torch.Tensor:
    """(B*nW, w*w, C) -> (B, H, W, C)"""
    C = x.shape[-1]
    B = x.shape[0] // ((H // w) * (W // w))
    x = x.reshape(B, H // w, W // w, w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


def relative_position_index(w: int) -> np.ndarray:
    """(w*w, w*w) indices into the (2w-1)^2 relative bias table."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).astype(np.int32)


def shifted_window_mask(res: int, w: int, shift: int) -> np.ndarray:
    """Attention mask of cyclic-shifted windows: (nW, w*w, w*w), NEG_INF
    at pairs from different regions."""
    img = np.zeros((res, res), np.int32)
    cnt = 0
    slices = (slice(0, -w), slice(-w, -shift), slice(-shift, None))
    for hs in slices:
        for ws in slices:
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(res // w, w, res // w, w).transpose(0, 2, 1, 3)
    win = win.reshape(-1, w * w)
    mask = win[:, None, :] != win[:, :, None]
    return np.where(mask, NEG_INF, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _rel_index(w: int, device: torch.device) -> torch.Tensor:
    """The flat relative index on `device`, copied there once (a captured
    step may not copy from the host)."""
    return torch.from_numpy(relative_position_index(w).reshape(-1)
                            .astype(np.int64)).to(device)


@functools.lru_cache(maxsize=32)
def _shift_mask(res: int, w: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(shifted_window_mask(res, w, w // 2)).to(device)


# ---------------------------------------------------------------------------
# Parameters (trunc-normal .02 weights, zero biases, LayerNorm ones / zeros)
# ---------------------------------------------------------------------------

def _linear(d_in, d_out, generator, device, bias=True) -> nn.Linear:
    m = nn.Linear(d_in, d_out, bias=bias, device=device)
    with torch.no_grad():
        trunc_normal_(m.weight, 0.02, generator)
        if bias:
            m.bias.zero_()
    return m


class PatchEmbed(nn.Module):
    def __init__(self, cfg: SwinCfg, D: int, generator, device):
        super().__init__()
        p = cfg.patch_size
        self.proj = nn.Conv2d(cfg.in_chans, D, p, stride=p, device=device)
        with torch.no_grad():
            trunc_normal_(self.proj.weight, 0.02, generator)
            self.proj.bias.zero_()
        self.norm = nn.LayerNorm(D, eps=cfg.ln_eps, device=device)


class WindowAttention(nn.Module):
    def __init__(self, C: int, dim: int, heads: int, window: int, generator,
                 device):
        super().__init__()
        self.qkv = _linear(C, 3 * dim, generator, device)
        self.proj = _linear(dim, C, generator, device)
        self.rel_bias = nn.Parameter(trunc_normal_(
            torch.empty((2 * window - 1) ** 2, heads, device=device), 0.02,
            generator))


class Mlp(nn.Module):
    def __init__(self, C: int, hidden: int, generator, device):
        super().__init__()
        self.fc1 = _linear(C, hidden, generator, device)
        self.fc2 = _linear(hidden, C, generator, device)


class SwinBlock(nn.Module):
    def __init__(self, cfg: SwinCfg, s: int, C: int, hidden: int, generator,
                 device):
        super().__init__()
        dim = cfg.stage_dim(s)
        self.norm1 = nn.LayerNorm(C, eps=cfg.ln_eps, device=device)
        self.attn = WindowAttention(C, dim, cfg.num_heads[s], cfg.window,
                                    generator, device)
        self.norm2 = nn.LayerNorm(C, eps=cfg.ln_eps, device=device)
        self.mlp = Mlp(C, hidden, generator, device)


class PatchMerging(nn.Module):
    def __init__(self, C: int, C_next: int, eps: float, generator, device):
        super().__init__()
        self.norm = nn.LayerNorm(4 * C, eps=eps, device=device)
        self.reduction = _linear(4 * C, C_next, generator, device, bias=False)


class SwinStage(nn.Module):
    def __init__(self, blocks, downsample=None):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        if downsample is not None:
            self.downsample = downsample


class Swin(nn.Module):
    """Parameters of the dense Swin (names follow the JAX tree: `kernel`
    becomes `weight`, LayerNorm `scale` becomes `weight`). `stage_dims`
    (residual width per stage) and `mlp_hidden` (per block, flat over the
    stages) give an exported subnet's widths; the qkv and proj inner
    widths stay the dense stage width."""

    def __init__(self, cfg: SwinCfg, *,
                 stage_dims: Optional[Sequence[int]] = None,
                 mlp_hidden: Optional[Sequence[int]] = None,
                 generator=None, device=None):
        super().__init__()
        S = cfg.num_stages
        Cs = list(stage_dims) if stage_dims is not None \
            else [cfg.stage_dim(s) for s in range(S)]
        hid = list(mlp_hidden) if mlp_hidden is not None else [
            int(cfg.stage_dim(s) * cfg.mlp_ratio)
            for s in range(S) for _ in range(cfg.depths[s])]
        self.patch_embed = PatchEmbed(cfg, Cs[0], generator, device)
        stages = []
        for s in range(S):
            blocks = [SwinBlock(cfg, s, Cs[s], hid[i], generator, device)
                      for i in cfg.stage_blocks(s)]
            down = PatchMerging(Cs[s], Cs[s + 1], cfg.ln_eps, generator,
                                device) if s < S - 1 else None
            stages.append(SwinStage(blocks, down))
        self.stages = nn.ModuleList(stages)
        self.norm = nn.LayerNorm(Cs[-1], eps=cfg.ln_eps, device=device)
        self.head = _linear(Cs[-1], cfg.num_classes, generator, device)


def subnet_widths(meta) -> dict:
    """`Swin` keyword widths of an exported subnet from its meta (the
    JAX package's and the port's): `stage_dims` when the residual widths
    were searched, each block's `mlp_hidden`; none for a dense model."""
    out = {}
    if meta.get("stage_dims"):
        out["stage_dims"] = [int(c) for c in meta["stage_dims"]]
    if meta.get("blocks"):
        out["mlp_hidden"] = [int(b["mlp_hidden"]) for b in meta["blocks"]]
    return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def patch_conv(weight, bias, x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) NHWC -> (B, H/p, W/p, D) by the strided conv (weight
    OIHW), bias added after the conv in the compute dtype."""
    p = weight.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), stride=p)
    return y.permute(0, 2, 3, 1) + bias.to(x.dtype)


def window_softmax_chain(qkv: torch.Tensor, heads: int, scale,
                         rel_bias: torch.Tensor, rel_idx: torch.Tensor,
                         mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The eager chain of window attention, on any device: qkv (Bw, N,
    3 * heads * hd) -> (Bw, N, heads * hd), scores in fp32 times `scale`,
    plus the relative-position bias and the shift mask (nW, N, N) of
    consecutive windows, fp32 softmax, then p @ v in the compute dtype."""
    Bw, N, _ = qkv.shape
    hd = qkv.shape[-1] // (3 * heads)
    q, k, v = qkv.reshape(Bw, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
    attn = torch.matmul(q, k.transpose(-2, -1)).float() * scale
    bias = rel_bias.float()[rel_idx].reshape(N, N, heads).permute(2, 0, 1)
    attn = attn + bias
    if mask is not None:
        nW = mask.shape[0]
        attn = (attn.reshape(Bw // nW, nW, heads, N, N)
                + mask[None, :, None]).reshape(Bw, heads, N, N)
    attn = torch.softmax(attn, dim=-1).to(qkv.dtype)
    return torch.matmul(attn, v).transpose(1, 2).reshape(Bw, N, heads * hd)


def window_softmax_attend(qkv: torch.Tensor, heads: int, scale,
                          rel_bias: torch.Tensor, rel_idx: torch.Tensor,
                          mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Window attention (`window_softmax_chain`'s function): the eager chain
    on a CPU tensor, the window-attention kernel pair
    (ops/window_attention.py), which keeps the scores out of device memory,
    on a CUDA tensor. Runs inside the profiler range
    WINDOW_ATTENTION_RANGE, which `bench.py --profile` reads back from a
    step's trace, and, while the stream is captured, between the
    `window_attn` span marks of its forward and of its backward
    (`utils.profiling.span_begin`)."""
    with torch.profiler.record_function(WINDOW_ATTENTION_RANGE):
        qkv, rel_bias = span_begin("window_attn", qkv, rel_bias)
        attend = window_softmax_chain if qkv.device.type == "cpu" \
            else window_attention
        return span_end("window_attn", attend(qkv, heads, scale, rel_bias,
                                              rel_idx, mask))


def _window_attention(p: WindowAttention, x, heads: int, rel_idx, mask):
    """Dense window attention; x (B*nW, w*w, C)."""
    qkv = linear(p.qkv, x)
    hd = qkv.shape[-1] // (3 * heads)
    y = window_softmax_attend(qkv, heads, hd ** -0.5, p.rel_bias, rel_idx,
                              mask)
    return linear(p.proj, y)


def shifted_windows(h, w: int, shift: int, attend):
    """Roll by -shift, partition into windows, `attend` them, reverse and
    roll back (h NHWC)."""
    _, H_, W_, _ = h.shape
    if shift:
        h = torch.roll(h, (-shift, -shift), dims=(1, 2))
    y = window_reverse(attend(window_partition(h, w)), w, H_, W_)
    if shift:
        y = torch.roll(y, (shift, shift), dims=(1, 2))
    return y


def merge_patches(h: torch.Tensor) -> torch.Tensor:
    """2 x 2 neighbourhood concat in Swin's order (0,0), (1,0), (0,1),
    (1,1): (B, H, W, C) -> (B, H/2, W/2, 4C)."""
    B_, H_, W_, C_ = h.shape
    h = h.reshape(B_, H_ // 2, 2, W_ // 2, 2, C_).permute(0, 1, 3, 4, 2, 5)
    return h.reshape(B_, H_ // 2, W_ // 2, 4 * C_)


def swin_forward(params: Swin, x: torch.Tensor, cfg: SwinCfg, *,
                 train: bool = False, generator=None,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """(B, H, W, 3) NHWC -> (B, num_classes) fp32 logits. Drop-path draws
    from `generator` (none without one)."""
    x = x.to(compute_dtype)
    pe = params.patch_embed
    h = patch_conv(pe.proj.weight, pe.proj.bias, x)
    h = layer_norm(h, pe.norm.weight, pe.norm.bias, eps=cfg.ln_eps)
    w = cfg.window
    rel_idx = _rel_index(w, h.device)
    dps = cfg.drop_path_schedule()
    i = 0
    for s, stage in enumerate(params.stages):
        res = cfg.stage_res(s)
        heads = cfg.num_heads[s]
        for b, bp in enumerate(stage.blocks):
            shift = w // 2 if (b % 2 == 1 and res > w) else 0
            mask = _shift_mask(res, w, h.device) if shift else None
            sc = layer_norm(h, bp.norm1.weight, bp.norm1.bias, eps=cfg.ln_eps)
            att = shifted_windows(sc, w, shift, lambda win: _window_attention(
                bp.attn, win, heads, rel_idx, mask))
            h = h + drop_path(att, dps[i], train, generator)
            y = layer_norm(h, bp.norm2.weight, bp.norm2.bias, eps=cfg.ln_eps)
            y = linear(bp.mlp.fc2, F.gelu(linear(bp.mlp.fc1, y),
                                          approximate="none"))
            h = h + drop_path(y, dps[i], train, generator)
            i += 1
        if hasattr(stage, "downsample"):
            ds = stage.downsample
            h = layer_norm(merge_patches(h), ds.norm.weight, ds.norm.bias,
                           eps=cfg.ln_eps)
            h = F.linear(h, ds.reduction.weight.to(h.dtype))
    h = layer_norm(h.flatten(1, 2), params.norm.weight, params.norm.bias,
                   eps=cfg.ln_eps)
    return linear(params.head, h.mean(dim=1)).float()


def swin_dense_flops(cfg: SwinCfg) -> float:
    """GFLOPs (the JAX package's FLOPs model's `total`: multiply-adds and
    the elementwise terms) of the dense Swin."""
    total = 0.0
    p2 = float(cfg.patch_size ** 2)
    total += cfg.stage_res(0) ** 2 * cfg.embed_dim * 3.0 * p2
    w2 = float(cfg.window ** 2)
    for s in range(cfg.num_stages):
        dim = float(cfg.stage_dim(s))
        tokens = float(cfg.stage_res(s) ** 2)
        heads = float(cfg.num_heads[s])
        hd = dim / heads
        hidden = float(int(dim * cfg.mlp_ratio))
        for _ in range(cfg.depths[s]):
            total += 2.0 * dim * tokens
            total += tokens * dim * 3.0 * dim + 3.0 * tokens * dim
            total += tokens / w2 * (heads * w2 * hd * w2 * 2.0
                                    + 6.0 * heads * w2 * w2)
            total += tokens * dim * dim + tokens * dim
            total += (2.0 * dim * hidden + dim + hidden) * tokens
        if s < cfg.num_stages - 1:
            t4 = tokens / 4.0
            total += t4 * 4.0 * dim + t4 * 4.0 * dim * cfg.stage_dim(s + 1)
    total += cfg.stage_dim(cfg.num_stages - 1) * cfg.num_classes
    return total / 1e9

