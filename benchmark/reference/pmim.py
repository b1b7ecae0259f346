"""PMIM: the token mask, the locally normalised targets, the decoder loss.

A frozen copy of the program's code, so that a later change to the program
cannot move the yardstick it is held to. It imports nothing of the program.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def _band_matrix(n: int, k: int, device: torch.device) -> torch.Tensor:
    """(n, n) 0/1 matrix, B[i, j] = 1 iff j is in the SAME-padded k-window
    centred at i ((k-1)//2 before, k//2 after). Made once per device."""
    i = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    band = ((j >= i - (k - 1) // 2) & (j <= i + k // 2)).astype(np.float32)
    return torch.from_numpy(band).to(device)


@functools.lru_cache(maxsize=8)
def _window_counts(H: int, W: int, k: int, device: torch.device):
    """(1, H, W, 1) in-bounds pixel count of each k x k window."""
    half = k // 2

    def axis_counts(n):
        i = np.arange(n)
        return np.minimum(i + half, n - 1) - np.maximum(i - half, 0) + 1

    cnt = (axis_counts(H)[:, None] * axis_counts(W)[None, :]).astype(np.float32)
    return torch.from_numpy(cnt).to(device)[None, :, :, None]


def _window_sum(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k window sum, stride 1, SAME padding, NHWC: two banded
    matmuls (the JAX package's default form of the box filter)."""
    H, W = x.shape[1], x.shape[2]
    bh = _band_matrix(H, k, x.device)
    bw = _band_matrix(W, k, x.device)
    x = torch.einsum("gh,bhwc->bgwc", bh, x)
    return torch.einsum("gw,bhwc->bhgc", bw, x)


def norm_targets(targets: torch.Tensor, patch_size: int = 47) -> torch.Tensor:
    """Standardise each pixel by its k x k window's statistics: mean and
    square mean over in-bounds pixels, variance times cnt/(cnt-1) (the
    in-bounds count), clamped at 0, eps 1e-6. targets (B, H, W, C)."""
    if patch_size % 2 != 1:
        raise ValueError("norm_targets needs an odd window")
    x = targets.float()
    cnt = _window_counts(x.shape[1], x.shape[2], patch_size, x.device)
    mean = _window_sum(x, patch_size) / cnt
    sq_mean = _window_sum(x.square(), patch_size) / cnt
    var = (sq_mean - mean.square()) * (cnt / (cnt - 1.0).clamp_min(1.0))
    var = var.clamp_min(0.0)
    return (x - mean) / torch.sqrt(var + 1e-6)


def keep_count(num_tokens: int, keep_ratio):
    """floor(L * keep_ratio) in fp32, as the JAX package computes it: an
    int32 tensor for a tensor ratio, else a Python int (no device copy)."""
    if isinstance(keep_ratio, torch.Tensor):
        return torch.floor(num_tokens * keep_ratio.float()).to(torch.int32)
    return int(np.floor(np.float32(num_tokens) * np.float32(keep_ratio)))


def random_token_mask(batch: int, num_tokens: int, keep_count,
                      *, generator=None, device=None) -> torch.Tensor:
    """Per-sample random removal mask (B, L) fp32, 1 = removed: the keep set
    is the `keep_count` tokens (an int or a runtime tensor) with the
    smallest noise."""
    noise = torch.rand((batch, num_tokens), generator=generator, device=device)
    order = torch.argsort(noise, dim=1, stable=True)
    ranks = torch.argsort(order, dim=1, stable=True)
    return (ranks >= keep_count).float()


def pixel_shuffle_nhwc(x: torch.Tensor, r: int) -> torch.Tensor:
    """torch.nn.PixelShuffle in NHWC: (B, h, w, C*r*r) -> (B, h*r, w*r, C),
    channel layout c*r*r + i*r + j."""
    B, h, w, crr = x.shape
    C = crr // (r * r)
    x = x.reshape(B, h, w, C, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, h * r, w * r, C)


def patchify(imgs: torch.Tensor, p: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, L, p*p*C), per-patch pixels then channels."""
    B, H, W, C = imgs.shape
    h, w = H // p, W // p
    x = imgs.reshape(B, h, p, w, p, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, h * w, p * p * C)


def mim_reconstruction_loss(imgs, x_rec, token_mask, patch_size: int,
                            in_chans: int = 3) -> torch.Tensor:
    """Masked L1 against locally normalised targets. imgs, x_rec
    (B, H, W, C); token_mask (B, L), 1 = masked (removed)."""
    B, H, W, C = imgs.shape
    g = H // patch_size
    pix = token_mask.reshape(B, g, g)
    pix = pix.repeat_interleave(patch_size, dim=1) \
        .repeat_interleave(patch_size, dim=2)[..., None]
    targets = norm_targets(imgs, 47)
    l1 = (targets - x_rec.float()).abs()
    return (l1 * pix).sum() / (pix.sum() + 1e-5) / in_chans
