"""Model registry: named DeiT search supernets and dense DeiT models.

Port of the DeiT half of ofb_tpu/models/registry.py. `create_model`
returns a `ModelBundle` (static config, search space, device) whose
`init` builds the parameters (and, for a supernet, alphas and arch
state). The dense factories take the dims of an exported subnet as
overrides. Other families (stock ViT variants, Swin) are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, Optional

import torch

from ..device import resolve_device
from .mim_vit import Alphas, MimViT
from .search_space import ArchState, SearchSpace
from .vit import ModelCfg, ViT

_REGISTRY: Dict[str, Callable[..., "ModelBundle"]] = {}


@dataclass
class ModelBundle:
    name: str
    cfg: ModelCfg
    space: Optional[SearchSpace]
    device: torch.device
    mae: bool = True
    kind: str = "mim"               # 'mim' (searchable) | 'dense'

    def init(self, seed: int = 0, *, with_arch: bool = True):
        """A supernet's (params, alphas, arch), or only its params with
        with_arch=False; a dense model's params. On the bundle's device.
        Weights are drawn on the CPU from `seed` and moved, so a seed gives
        the same model on every device."""
        g = torch.Generator().manual_seed(seed)
        if self.kind == "dense":
            return ViT(self.cfg, generator=g).to(self.device)
        params = MimViT(self.cfg, self.space, self.mae, generator=g)
        if not with_arch:
            return params.to(self.device)
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


def _dense_factory(size: str, img_size=224, distilled=False):
    def factory(*, device: torch.device, num_classes=1000, drop_rate=0.0,
                drop_path_rate=0.1, embed_dim=None, num_heads=None,
                head_dim=None, mlp_hidden=None, qk_scale=None) -> ModelBundle:
        cfg = _deit_cfg(size, img_size, num_classes, distilled, drop_rate,
                        drop_path_rate)
        # exported (pruned) subnets override dims explicitly
        over = dict(embed_dim=embed_dim, num_heads=num_heads,
                    head_dim=head_dim, mlp_hidden=mlp_hidden,
                    qk_scale=qk_scale)
        cfg = replace(cfg, **{k: v for k, v in over.items() if v is not None})
        return ModelBundle(name=f"deit_{size}_patch16_{img_size}", cfg=cfg,
                           space=None, device=device, kind="dense")
    return factory


# searchable MIM supernets
for _size in ("tiny", "small", "base"):
    _REGISTRY[f"deit_{_size}_patch16_224_mim"] = _mim_factory(_size)

# plain / finetune models and their distilled forms
for _size in ("tiny", "small", "base"):
    for _img in (224, 384):
        for _dist in (False, True):
            _suffix = "_distilled" if _dist else ""
            _REGISTRY[f"deit_{_size}{_suffix}_patch16_{_img}"] = \
                _dense_factory(_size, _img, _dist)
            _REGISTRY[f"deit_{_size}_patch16_{_img}_finetune"] = \
                _REGISTRY[f"deit_{_size}_patch16_{_img}"]


def add_search_params(bundle: ModelBundle, *, attn_search=True,
                      mlp_search=True, embed_search=True, patch_search=True,
                      head_search=False, channel_search=False,
                      mask_ratio=1.0) -> ModelBundle:
    """Turn a dense bundle into a searchable MIM bundle."""
    cfg = bundle.cfg
    space = SearchSpace.build(
        cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.hidden,
        cfg.num_patches, attn_search=attn_search, mlp_search=mlp_search,
        embed_search=embed_search, patch_search=patch_search,
        head_search=head_search, channel_search=channel_search,
        mask_ratio=mask_ratio)
    return ModelBundle(name=bundle.name + "_mim", cfg=cfg, space=space,
                       device=bundle.device, kind="mim")
