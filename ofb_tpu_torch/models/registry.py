"""Model registry: named DeiT search supernets.

Port of the DeiT MIM half of ofb_tpu/models/registry.py. `create_model`
returns a `ModelBundle` (static config, search space, device) whose
`init` builds the parameters, alphas and arch state. Other families
(dense finetune models, ViT variants, Swin) are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import torch

from ..device import resolve_device
from .mim_vit import Alphas, MimViT
from .search_space import ArchState, SearchSpace
from .vit import ModelCfg

_REGISTRY: Dict[str, Callable[..., "ModelBundle"]] = {}


@dataclass
class ModelBundle:
    name: str
    cfg: ModelCfg
    space: SearchSpace
    device: torch.device
    mae: bool = True

    def init(self, seed: int = 0):
        """(params, alphas, arch) on the bundle's device. Weights are drawn
        on the CPU from `seed` and moved, so a seed gives the same model on
        every device."""
        g = torch.Generator().manual_seed(seed)
        params = MimViT(self.cfg, self.space, self.mae, generator=g)
        alphas = Alphas(self.space, generator=g)
        arch = ArchState.create(self.space)
        return (params.to(self.device), alphas.to(self.device),
                arch.to(self.device))


def list_models():
    return sorted(_REGISTRY)


def create_model(name: str, *, device="cuda", **kwargs) -> ModelBundle:
    """The named supernet on `device` (default "cuda"; raises without a
    card unless device="cpu" is asked for)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; known: {list_models()}")
    return _REGISTRY[name](device=resolve_device(device), **kwargs)


_DEIT_DIMS = {
    "tiny": dict(embed_dim=192, num_heads=3),
    "small": dict(embed_dim=384, num_heads=6),
    "base": dict(embed_dim=768, num_heads=12),
}


def _deit_cfg(size: str, img_size=224, num_classes=1000, distilled=False,
              drop_rate=0.0, drop_path_rate=0.1) -> ModelCfg:
    return ModelCfg(img_size=img_size, patch_size=16, num_classes=num_classes,
                    depth=12, mlp_ratio=4.0, distilled=distilled,
                    drop_rate=drop_rate, drop_path_rate=drop_path_rate,
                    **_DEIT_DIMS[size])


def _mim_factory(size: str):
    def factory(*, device: torch.device, num_classes=1000, img_size=224,
                mae=True, attn_search=True, mlp_search=True,
                embed_search=True, patch_search=True, head_search=False,
                channel_search=False, mask_ratio=1.0, drop_rate=0.0,
                drop_path_rate=0.1, distilled=False) -> ModelBundle:
        cfg = _deit_cfg(size, img_size, num_classes, distilled, drop_rate,
                        drop_path_rate)
        space = SearchSpace.build(
            cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.hidden,
            cfg.num_patches, attn_search=attn_search, mlp_search=mlp_search,
            embed_search=embed_search, patch_search=patch_search,
            head_search=head_search, channel_search=channel_search,
            mask_ratio=mask_ratio)
        return ModelBundle(name=f"deit_{size}_patch16_{img_size}_mim",
                           cfg=cfg, space=space, device=device, mae=mae)
    return factory


for _size in ("tiny", "small", "base"):
    _REGISTRY[f"deit_{_size}_patch16_224_mim"] = _mim_factory(_size)
