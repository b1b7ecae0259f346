"""The OFB search space: ratio grids, mask banks and the arch state.

A frozen copy of the program's code, so that a later change to the program
cannot move the yardstick it is held to. It imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Ratio grids (the reference's integer grids)
# ---------------------------------------------------------------------------

def embed_ratio_grid(embed_dim: int) -> Tuple[float, ...]:
    """Patch-embed width grid: i/D for i in range(D//2, D+1, min(D//32, 12))."""
    step = max(min(embed_dim // 32, 12), 1)
    return tuple(i / embed_dim for i in range(embed_dim // 2, embed_dim + 1, step))


def head_num_grid(num_heads: int) -> Tuple[int, ...]:
    """Head-count grid: range(2, H+1, 2)."""
    return tuple(range(2, num_heads + 1, 2))


def qkv_channel_grid(head_dim: int) -> Tuple[float, ...]:
    """Per-head QKV channel grid: i/d for i in range(d//4, d+1, max(d//8, 1))."""
    step = max(head_dim // 8, 1)
    return tuple(i / head_dim for i in range(head_dim // 4, head_dim + 1, step))


def mlp_hidden_grid(hidden: int) -> Tuple[float, ...]:
    """MLP hidden-width grid: i/h for i in range(h//4, h+1, h//8)."""
    step = hidden // 8
    return tuple(i / hidden for i in range(hidden // 4, hidden + 1, step))


def patch_ratio_grid() -> Tuple[float, ...]:
    """Token-keep ratio grid: linspace(0.5, 1.0, 5)."""
    return tuple(np.linspace(0.5, 1.0, 5).tolist())


# ---------------------------------------------------------------------------
# Static spaces (mask banks live in the sorted domain: cell j covers ranks
# [0, size_j); the rank-restore gather maps them back to channel order)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DimSpace:
    """1-D searchable width (patch-embed channels or MLP hidden units)."""

    dim: int
    ratios: Tuple[float, ...]
    searchable: bool = True

    @property
    def num_cells(self) -> int:
        return len(self.ratios)

    @property
    def cell_sizes(self) -> np.ndarray:
        return np.array([int(r * self.dim) for r in self.ratios], np.float32)

    @property
    def mask_bank(self) -> np.ndarray:
        """(K, dim) prefix masks in the sorted domain."""
        bank = np.zeros((self.num_cells, self.dim), np.float32)
        for i, r in enumerate(self.ratios):
            bank[i, : int(r * self.dim)] = 1.0
        return bank


@dataclass(frozen=True)
class AttnSpace:
    """Joint head-count x per-head-channel space."""

    num_heads: int
    head_dim: int
    head_list: Tuple[int, ...]
    chan_ratios: Tuple[float, ...]
    searchable: bool = True

    @staticmethod
    def build(num_heads: int, head_dim: int, head_search: bool = False,
              channel_search: bool = False, searchable: bool = True
              ) -> "AttnSpace":
        if not searchable:
            return AttnSpace(num_heads, head_dim, (num_heads,), (1.0,), False)
        if head_search:
            return AttnSpace(num_heads, head_dim, head_num_grid(num_heads),
                             (1.0,), True)
        if channel_search:
            return AttnSpace(num_heads, head_dim, (num_heads,),
                             qkv_channel_grid(head_dim), True)
        return AttnSpace(num_heads, head_dim, head_num_grid(num_heads),
                         qkv_channel_grid(head_dim), True)

    @property
    def num_cells(self) -> Tuple[int, int]:
        return (len(self.head_list), len(self.chan_ratios))

    @property
    def chan_counts(self) -> Tuple[int, ...]:
        return tuple(int(r * self.head_dim) for r in self.chan_ratios)

    @property
    def cell_sizes(self) -> np.ndarray:
        """(Kh, Kc) active qkv units per cell = heads_i * chans_j."""
        h = np.array(self.head_list, np.float32)[:, None]
        c = np.array(self.chan_counts, np.float32)[None, :]
        return h * c

    @property
    def mask_bank(self) -> np.ndarray:
        """(Kh, H, Kc, d) joint masks."""
        kh, kc = self.num_cells
        bank = np.zeros((kh, self.num_heads, kc, self.head_dim), np.float32)
        for i, n in enumerate(self.head_list):
            for j, cnt in enumerate(self.chan_counts):
                bank[i, :n, j, :cnt] = 1.0
        return bank


@dataclass(frozen=True)
class PatchSpace:
    """Token-count space."""

    num_patches: int
    ratios: Tuple[float, ...]
    searchable: bool = True

    @property
    def num_cells(self) -> int:
        return len(self.ratios)

    @property
    def cell_sizes(self) -> np.ndarray:
        return np.array([int(r * self.num_patches) for r in self.ratios],
                        np.float32)


@dataclass(frozen=True)
class BlockSpace:
    attn: AttnSpace
    mlp: DimSpace


@dataclass(frozen=True)
class SearchSpace:
    """Whole-model static search space (`stage_embeds` is for hierarchical
    models and empty for ViT)."""

    embed: DimSpace
    blocks: Tuple[BlockSpace, ...]
    patch: PatchSpace
    stage_embeds: Tuple[DimSpace, ...] = ()

    @staticmethod
    def build(embed_dim: int, depth: int, num_heads: int, mlp_hidden: int,
              num_patches: int, *, attn_search=True, mlp_search=True,
              embed_search=True, patch_search=True, head_search=False,
              channel_search=False, mask_ratio: float = 1.0) -> "SearchSpace":
        head_dim = embed_dim // num_heads
        embed = DimSpace(embed_dim,
                         embed_ratio_grid(embed_dim) if embed_search else (1.0,),
                         embed_search)
        blocks = tuple(
            BlockSpace(
                attn=AttnSpace.build(num_heads, head_dim, head_search,
                                     channel_search, attn_search),
                mlp=DimSpace(mlp_hidden,
                             mlp_hidden_grid(mlp_hidden) if mlp_search else (1.0,),
                             mlp_search),
            )
            for _ in range(depth)
        )
        patch = PatchSpace(num_patches,
                           patch_ratio_grid() if patch_search else (mask_ratio,),
                           patch_search)
        return SearchSpace(embed=embed, blocks=blocks, patch=patch)


@dataclass(frozen=True)
class SpaceTensors:
    """The static space's mask banks and cell sizes as tensors on one
    device, made once so a step copies nothing from the host. Every block
    of a ViT space is the same, so one bank serves all blocks."""

    embed_bank: torch.Tensor
    attn_bank: torch.Tensor
    mlp_bank: torch.Tensor
    embed_sizes: torch.Tensor
    patch_sizes: torch.Tensor
    attn_sizes: torch.Tensor
    mlp_sizes: torch.Tensor


@functools.lru_cache(maxsize=16)
def space_tensors(space: SearchSpace, device: torch.device) -> SpaceTensors:
    b0 = space.blocks[0]
    if any(b != b0 for b in space.blocks):
        raise ValueError("the blocks of a search space must be identical")

    def t(a):
        return torch.from_numpy(a).to(device)
    return SpaceTensors(
        embed_bank=t(space.embed.mask_bank), attn_bank=t(b0.attn.mask_bank),
        mlp_bank=t(b0.mlp.mask_bank), embed_sizes=t(space.embed.cell_sizes),
        patch_sizes=t(space.patch.cell_sizes),
        attn_sizes=t(b0.attn.cell_sizes), mlp_sizes=t(b0.mlp.cell_sizes))


# ---------------------------------------------------------------------------
# Dynamic arch state: dataclasses of small tensors
# ---------------------------------------------------------------------------

def _to(obj, device):
    """A copy of an arch dataclass with every tensor moved to `device`."""
    vals = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            v = v.to(device)
        elif isinstance(v, tuple):
            v = tuple(_to(x, device) for x in v)
        elif dataclasses.is_dataclass(v):
            v = _to(v, device)
        vals[f.name] = v
    return dataclasses.replace(obj, **vals)


@dataclass
class DimArch:
    """State of a 1-D searchable width."""

    switch: torch.Tensor         # bool (K,)   active cells
    hard_mask: torch.Tensor      # f32 (dim,)  1 = channel still in play
    finished: torch.Tensor       # bool scalar
    w_p: torch.Tensor            # f32 scalar, annealed 0.99 -> 0.1

    @staticmethod
    def create(space: DimSpace, device=None) -> "DimArch":
        return DimArch(
            switch=torch.ones(space.num_cells, dtype=torch.bool, device=device),
            hard_mask=torch.ones(space.dim, dtype=torch.float32, device=device),
            finished=torch.tensor(not space.searchable, device=device),
            w_p=torch.tensor(0.99, dtype=torch.float32, device=device),
        )


@dataclass
class AttnArch:
    switch: torch.Tensor         # bool (Kh, Kc)
    hard_mask: torch.Tensor      # f32 (H, d)
    finished: torch.Tensor       # bool scalar
    w_p: torch.Tensor            # f32 scalar
    scale: torch.Tensor          # f32 scalar softmax scale; rewritten at
                                 # prune events, never compiled in
    head_alive: torch.Tensor     # i32 scalar count of heads in play

    @staticmethod
    def create(space: AttnSpace, device=None) -> "AttnArch":
        kh, kc = space.num_cells
        return AttnArch(
            switch=torch.ones((kh, kc), dtype=torch.bool, device=device),
            hard_mask=torch.ones((space.num_heads, space.head_dim),
                                 dtype=torch.float32, device=device),
            finished=torch.tensor(not space.searchable, device=device),
            w_p=torch.tensor(0.99, dtype=torch.float32, device=device),
            scale=torch.tensor(space.head_dim ** -0.5, dtype=torch.float32,
                               device=device),
            head_alive=torch.tensor(space.num_heads, dtype=torch.int32,
                                    device=device),
        )


@dataclass
class BlockArch:
    attn: AttnArch
    mlp: DimArch


@dataclass
class PatchArch:
    switch: torch.Tensor         # bool (Kp,)
    finished: torch.Tensor       # bool scalar
    pruned_once: torch.Tensor    # bool scalar: the patch weighted mask enters
                                 # the FLOPs model only after the first
                                 # patch prune event

    @staticmethod
    def create(space: PatchSpace, device=None) -> "PatchArch":
        return PatchArch(
            switch=torch.ones(space.num_cells, dtype=torch.bool, device=device),
            finished=torch.tensor(not space.searchable, device=device),
            pruned_once=torch.tensor(False, device=device),
        )


@dataclass
class ArchState:
    embed: DimArch
    blocks: Tuple[BlockArch, ...]
    patch: PatchArch
    fused: torch.Tensor          # bool scalar: scores folded into weights
    stage_embeds: Tuple[DimArch, ...] = ()

    @staticmethod
    def create(space: SearchSpace, device=None) -> "ArchState":
        return ArchState(
            embed=DimArch.create(space.embed, device),
            blocks=tuple(
                BlockArch(attn=AttnArch.create(b.attn, device),
                          mlp=DimArch.create(b.mlp, device))
                for b in space.blocks
            ),
            patch=PatchArch.create(space.patch, device),
            fused=torch.tensor(False, device=device),
            stage_embeds=tuple(DimArch.create(d, device)
                               for d in space.stage_embeds),
        )

    def to(self, device) -> "ArchState":
        return _to(self, device)

    @property
    def all_finished(self) -> bool:
        """finish_search of the whole model (one host read)."""
        flags = [self.embed.finished, self.patch.finished]
        flags += [d.finished for d in self.stage_embeds]
        flags += [m.finished for b in self.blocks for m in (b.attn, b.mlp)]
        return bool(torch.stack(flags).all())
