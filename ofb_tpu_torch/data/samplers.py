"""Epoch index generation: distributed and repeated-augmentation sampling.

A copy of ofb_tpu/data/samplers.py (pure numpy, bit-identical plans): the
reference's RASampler and torch DistributedSampler semantics as an index
plan per (epoch, rank) instead of a torch Sampler object.
"""

from __future__ import annotations

import math
import numpy as np


def distributed_indices(n: int, epoch: int, rank: int, world: int, *,
                        shuffle: bool = True, seed: int = 0,
                        drop_last: bool = False) -> np.ndarray:
    """torch.utils.data.DistributedSampler semantics: epoch-seeded shuffle,
    then either pad to a multiple of world (drop_last=False, the torch
    default) or drop the tail (drop_last=True), stride by rank."""
    g = np.random.RandomState(seed + epoch)
    idx = g.permutation(n) if shuffle else np.arange(n)
    if drop_last:
        # drop the tail so every rank gets exactly floor(n/world) samples
        total = (n // world) * world
        idx = idx[:total]
    else:
        # pad with wrapped-around indices up to a multiple of world
        total = int(math.ceil(n / world)) * world
        if total > n:
            idx = np.concatenate([idx, idx[: total - n]])
    return idx[rank::world]


def ra_indices(n: int, epoch: int, rank: int, world: int, *,
               num_repeats: int = 3, seed: int = 0) -> np.ndarray:
    """Repeated-augmentation sampling (reference samplers.py:8-59):
    each shuffled index is repeated `num_repeats` times consecutively,
    padded to a multiple of world, strided by rank, truncated to
    floor(n // 256 * 256 / world) selected samples."""
    g = np.random.RandomState(seed + epoch)
    idx = g.permutation(n)
    rep = np.repeat(idx, num_repeats)
    total = int(math.ceil(len(rep) / world)) * world
    if total > len(rep):
        rep = np.concatenate([rep, rep[: total - len(rep)]])
    mine = rep[rank::world]
    num_selected = int(math.floor(n // 256 * 256 / world))
    if num_selected > 0:
        mine = mine[:num_selected]
    return mine


def epoch_batches(indices: np.ndarray, batch_size: int, *,
                  drop_last: bool = True) -> np.ndarray:
    """(num_batches, batch_size) index matrix."""
    nb = len(indices) // batch_size
    if not drop_last and len(indices) % batch_size:
        pad = batch_size - len(indices) % batch_size
        indices = np.concatenate([indices, indices[:pad]])
        nb += 1
    return indices[: nb * batch_size].reshape(nb, batch_size)
