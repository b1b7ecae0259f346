"""What the benchmark makes from `--seed` and hands to both sides: the
weights, each rank's device cache of uint8 staging images, the epoch's index
plan with its labels, and the generator the step draws its randomness from.

The same seed gives the same inputs. Every stream has a seed of its own,
worked out from `--seed` by numpy's `SeedSequence`, so a large seed and its
neighbours give unrelated streams. Weights and images are made on the
device, in a few large calls.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

WEIGHTS, CACHE, PLAN, STEP = range(4)


def stream_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for stream `stream` of `seed`."""
    words = np.random.SeedSequence(
        [int(seed) % 2 ** 64, *stream]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def generator(seed: int, device, *stream: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, *stream))


def _kind(name: str, t: torch.Tensor) -> str:
    """How the leaf is drawn: the DeiT initialisation, by name and shape."""
    if name.startswith("alphas."):
        return "uniform"                 # architecture parameters
    if name.endswith("score"):
        return "score"                   # saliency scores, N(0, 0.2)
    if name.endswith("bias"):
        return "zeros"
    if t.dim() == 1 and name.endswith("weight"):
        return "ones"                    # layer-norm scales
    return "normal"                      # weights, tokens: N(0, .02) in 2 std


@torch.no_grad()
def fill_weights(leaves: Dict[str, torch.Tensor], seed: int) -> None:
    """Write the benchmark's weights into `leaves` ({name: tensor}, on one
    device), in place: one normal and one uniform draw over all leaves, cut
    in the order of the sorted names."""
    names = sorted(leaves)
    dev = leaves[names[0]].device
    kinds = {n: _kind(n, leaves[n]) for n in names}
    g = generator(seed, dev, WEIGHTS)
    count = {k: sum(leaves[n].numel() for n in names if kinds[n] == k)
             for k in ("normal", "score", "uniform")}
    normal = torch.randn(count["normal"] + count["score"], generator=g,
                         device=dev)
    uniform = torch.rand(count["uniform"], generator=g, device=dev)
    at = {"normal": 0, "score": count["normal"], "uniform": 0}
    for n in names:
        t, k = leaves[n], kinds[n]
        if k == "zeros":
            t.zero_()
        elif k == "ones":
            t.fill_(1.0)
        else:
            src = uniform if k == "uniform" else normal
            v = src[at[k]:at[k] + t.numel()].view(t.shape)
            at[k] += t.numel()
            if k == "normal":
                v = 0.02 * v.clamp(-2.0, 2.0)
            elif k == "score":
                v = 0.2 * v
            t.copy_(v)


def staging_cache(seed: int, rank: int, images: int, size: int,
                  device) -> torch.Tensor:
    """Rank `rank`'s device cache: `images` uint8 staging images (images,
    size, size, 3), as `cli.search --cache-device` holds them."""
    g = generator(seed, device, CACHE, rank)
    return torch.randint(0, 256, (images, size, size, 3), generator=g,
                         device=device, dtype=torch.uint8)


def epoch_plan(seed: int, rows: int, global_batch: int, cache_images: int,
               classes: int, world: int):
    """(index plan (rows, global_batch) into each rank's cache, labels
    (world, cache_images) of each rank's images). Rank r takes the columns
    [r, r + 1) * global_batch / world of every row."""
    rng = np.random.default_rng(stream_seed(seed, PLAN))
    idx = rng.integers(0, cache_images, (rows, global_batch))
    labels = rng.integers(0, classes, (world, cache_images))
    return idx, labels


def rank_columns(idx: np.ndarray, rank: int, world: int) -> np.ndarray:
    mb = idx.shape[1] // world
    return idx[:, rank * mb:(rank + 1) * mb]


def step_generator(seed: int, device) -> torch.Generator:
    """The generator the step draws from: the same on every rank, as the
    program's data-parallel draws need."""
    return generator(seed, device, STEP)
