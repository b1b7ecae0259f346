"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch.device for `device` (default "cuda"). Raises when CUDA is
    asked for and there is none: entry points never fall back to the CPU
    on their own; a caller that wants the CPU says device="cpu". Under a
    process group, a "cuda" without an index is this process's card,
    cuda:LOCAL_RANK."""
    from .parallel.distributed import group_active, local_rank
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is None and group_active():
        dev = torch.device("cuda", local_rank())
    return dev
