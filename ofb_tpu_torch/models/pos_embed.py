"""Positional-embedding utilities.

Port of ofb_tpu/models/pos_embed.py: the 2-D sin-cos tables and the resize
of a checkpoint's pos-embed grid to a new patch count.

The JAX package resizes with `jax.image.resize(method="bicubic")`: the Keys
cubic kernel with a = -0.5 at half-pixel centres, widened by the scale when
shrinking (anti-aliasing), its weights renormalised over the samples that
fall inside the grid. `torch.nn.functional.interpolate(mode="bicubic")` uses
a = -0.75 and clamps at the edges instead, so the resampling is written out
here as a weight matrix per axis.
"""

from __future__ import annotations

import numpy as np
import torch


def get_1d_sincos_pos_embed_from_grid(embed_dim: int, pos: np.ndarray
                                      ) -> np.ndarray:
    """(M,) positions -> (M, D) sin-cos embedding."""
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int,
                            cls_token: bool = False,
                            num_extra_tokens: int = 1) -> np.ndarray:
    """(grid*grid [+extra], D) 2-D sin-cos table."""
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.meshgrid(grid_w, grid_h)          # w goes first
    grid = np.stack(grid, axis=0).reshape(2, 1, grid_size, grid_size)
    emb_h = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[0])
    emb_w = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[1])
    pos = np.concatenate([emb_h, emb_w], axis=1)
    if cls_token:
        pos = np.concatenate(
            [np.zeros([num_extra_tokens, embed_dim]), pos], axis=0)
    return pos.astype(np.float32)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel, a = -0.5, on |x|."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of the anti-aliased bicubic resize of one
    axis: output j = sum_i w[i, j] input i."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float64)[:, None])
    w = _keys_cubic(x / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def interpolate_pos_embed(pos_embed: torch.Tensor, new_num_patches: int,
                          num_extra_tokens: int = 1) -> torch.Tensor:
    """Bicubic grid resize of a (1, T+N, D) pos-embed table to a new patch
    count; the T extra tokens pass unchanged."""
    tokens = pos_embed[:, :num_extra_tokens]
    grid_tok = pos_embed[:, num_extra_tokens:]
    n_old = grid_tok.shape[1]
    g_old = int(round(float(np.sqrt(n_old))))
    g_new = int(round(float(np.sqrt(new_num_patches))))
    if g_old == g_new:
        return pos_embed
    D = grid_tok.shape[-1]
    grid = grid_tok.reshape(1, g_old, g_old, D)
    w = torch.from_numpy(resize_weights(g_old, g_new)).to(grid)
    resized = torch.einsum("bhwd,hg->bgwd", grid, w)
    resized = torch.einsum("bgwd,wk->bgkd", resized, w)
    return torch.cat([tokens, resized.reshape(1, g_new * g_new, D)], dim=1)
