"""The table of peaks the shares are taken against."""

from __future__ import annotations

from typing import NamedTuple


class Peak(NamedTuple):
    name: str
    bf16_flops: float         # dense, without sparsity
    hbm_bytes_s: float


# NVIDIA's data sheet for the H100 SXM at its full 700 W power limit; a
# card set lower reads lower against it (the run prints the card's limit)
H100 = Peak("NVIDIA H100 SXM", 989e12, 3.35e12)
