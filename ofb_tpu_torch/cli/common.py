"""Pieces the port's CLIs share: the process's place in the world (rank,
world and card, from the launcher's process group), the tiny test
geometries (ViT and Swin), rebuilding a supernet from a search run's
recorded args, the per-epoch random source, and a CLI run in this process
with its printed text kept."""

from __future__ import annotations

import argparse
import contextlib
import sys
from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..models.registry import ModelBundle, create_model
from ..models.search_space import SearchSpace
from ..models.vit import ModelCfg
from ..parallel.distributed import group_active, init_distributed
from ..utils.logging import master_print

# class counts of the datasets whose size a checkpoint's args name
DATASET_CLASSES = {"DIGITS": 10, "CIFAR10": 10, "CIFAR100": 100,
                   "IMNET100": 100, "IMNET": 1000}


def tiny_cfg(num_classes: int, dims=(32, 2, 2), drop_path: float = 0.0
             ) -> ModelCfg:
    """The --tiny-test geometry: 32x32 images, patch 8, MLP ratio 2."""
    embed, depth, heads = dims
    return ModelCfg(img_size=32, patch_size=8, num_classes=num_classes,
                    embed_dim=embed, depth=depth, num_heads=heads,
                    mlp_ratio=2.0, drop_path_rate=drop_path)


def tiny_bundle(num_classes: int, device, dims=(32, 2, 2),
                drop_path: float = 0.0, patch_search: bool = True
                ) -> ModelBundle:
    cfg = tiny_cfg(num_classes, dims, drop_path)
    space = SearchSpace.build(cfg.embed_dim, cfg.depth, cfg.num_heads,
                              cfg.hidden, cfg.num_patches,
                              patch_search=patch_search)
    return ModelBundle(name="tiny", cfg=cfg, space=space, device=device)


def supernet_bundle(saved_args: Dict[str, Any], model: str, num_classes: int,
                    device) -> ModelBundle:
    """The supernet a search run trained, from the args its checkpoint
    recorded (the tiny geometry or a registry name)."""
    if saved_args.get("tiny_test"):
        return tiny_bundle(num_classes, device,
                           dims=tuple(saved_args.get("tiny_dims",
                                                     (32, 2, 2))))
    return create_model(saved_args.get("model", model), device=device,
                        num_classes=num_classes)


def swin_tiny_cfg(num_classes: int, drop_path: float = 0.1):
    """The Swin CLIs' --tiny-test geometry (the JAX CLIs'): 32x32 images,
    patch 2, D 24, one block in each of two stages, heads (2, 4),
    window 4."""
    from ..models.swin import SwinCfg
    return SwinCfg(img_size=32, patch_size=2, num_classes=num_classes,
                   embed_dim=24, depths=(1, 1), num_heads=(2, 4), window=4,
                   mlp_ratio=2.0, drop_path_rate=drop_path)


def swin_supernet_bundle(saved_args: Dict[str, Any], model: str,
                         num_classes: int, device, *,
                         embed_search: bool = False) -> ModelBundle:
    """The Swin supernet a search run trained, from the args its
    checkpoint recorded (the tiny geometry or a registry name; without
    recorded args, `model` and `embed_search`)."""
    from ..models.swin_search import build_swin_space
    flags = dict(attn_search=saved_args.get("attn_search", True),
                 mlp_search=saved_args.get("mlp_search", True),
                 embed_search=saved_args.get("embed_search", embed_search))
    drop_path = saved_args.get("drop_path", 0.1)
    if saved_args.get("tiny_test"):
        cfg = swin_tiny_cfg(num_classes, drop_path)
        return ModelBundle(name="swin_tiny_test", cfg=cfg,
                           space=build_swin_space(cfg, **flags),
                           device=device, kind="swin_mim")
    return create_model(saved_args.get("model", model), device=device,
                        num_classes=num_classes,
                        img_size=saved_args.get("input_size", 224),
                        drop_path_rate=drop_path, **flags)


def classes_from_args(saved_args: Dict[str, Any]) -> int:
    """The class count of the dataset a search run recorded (1000 if
    unknown)."""
    name = str(saved_args.get("data_set", "")).upper()
    if name in DATASET_CLASSES:
        return DATASET_CLASSES[name]
    if name == "SYNTHETIC":
        return saved_args.get("synthetic_num_classes", 1000)
    return 1000


def epoch_seed(seed: int, epoch: int) -> int:
    """The seed of one epoch's augmentation, Mixup and PMIM draws: a
    function of (seed, epoch) alone, so a resumed run draws what the
    uninterrupted run would have drawn."""
    return (seed + 1234) * 100003 + epoch


def epoch_generator(device: torch.device, seed: int, epoch: int
                    ) -> torch.Generator:
    """A generator on `device` seeded with `epoch_seed` (the classic loops
    make one each epoch; the planned loops reseed one for the run)."""
    return torch.Generator(device=device).manual_seed(epoch_seed(seed, epoch))


def distributed_setup(device: str) -> Tuple[int, int, torch.device]:
    """(rank, world, device) of this CLI process. Under a launcher
    (`torchrun`, or the JAX package's COORDINATOR_ADDRESS contract) it
    joins the process group (`parallel.distributed.init_distributed`:
    NCCL on the card, gloo on the CPU) and takes cuda:LOCAL_RANK; without
    one it is rank 0 of a world of 1. `--world_size` is not read: the world
    is the launcher's. Prints the rank, world, backend and device."""
    rank, world = init_distributed(device=device)
    dev = resolve_device(device)
    backend = dist.get_backend() if group_active() else "none"
    print(f"distributed: rank {rank} of world {world}, backend {backend}, "
          f"device {dev}", flush=True)
    return rank, world, dev


def device_cache_on(args, world: int) -> bool:
    """Whether --cache-device takes effect: it is single-process only, as
    in the JAX CLIs, so a larger world falls back to the host loader."""
    if args.cache_device and world > 1:
        master_print("--cache-device is single-process only; "
                     "falling back to the host loader")
        return False
    return bool(args.cache_device)


class _Tee:
    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s):
        self.parts.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def run_main(module, argv):
    """Run CLI `module`'s `main` on `argv` in this process, its output still
    printed; returns (what main returned, the text it printed)."""
    args = argparse.ArgumentParser(parents=[module.get_args_parser()]) \
        .parse_args(argv)
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        out = module.main(args)
    return out, "".join(tee.parts)
