"""Model registry: named DeiT search supernets and dense ViT models.

Port of ofb_tpu/models/registry.py. `create_model` returns a
`ModelBundle` (static config, search space, device) whose `init` builds
the parameters (and, for a supernet, alphas and arch state). Registered:
the DeiT supernets, the dense DeiT models (whose factories take the dims
of an exported subnet as overrides) and the stock ViTs of the JAX package,
its in21k models (tanh pre-logits), the MIIL models (no qkv bias), the
`vit_deit_*` aliases and the Swin family: `swin_{tiny,small,base}_patch4_
window7_224` (dense, kind 'swin') and the same names with `_mim` (the
searchable Swin, kind 'swin_mim', whose factory takes the search flags,
`embed_search` among them). `register_model` adds a factory of the
caller's.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, Optional, Union

import torch

from ..device import resolve_device
from .mim_vit import Alphas, MimViT
from .search_space import ArchState, SearchSpace
from .swin import Swin, SwinCfg
from .swin_search import SwinAlphas, SwinSearch, build_swin_space
from .vit import ModelCfg, ViT

_REGISTRY: Dict[str, Callable[..., "ModelBundle"]] = {}


@dataclass
class ModelBundle:
    name: str
    cfg: Union[ModelCfg, SwinCfg]
    space: Optional[SearchSpace]
    device: torch.device
    mae: bool = True
    # 'mim' (searchable ViT) | 'dense' (ViT) | 'swin_mim' | 'swin'
    kind: str = "mim"

    def init(self, seed: int = 0, *, with_arch: bool = True):
        """A supernet's (params, alphas, arch), or only its params with
        with_arch=False; a dense model's params. On the bundle's device.
        Weights are drawn on the CPU from `seed` and moved, so a seed gives
        the same model on every device."""
        g = torch.Generator().manual_seed(seed)
        if self.kind == "dense":
            return ViT(self.cfg, generator=g).to(self.device)
        if self.kind == "swin":
            return Swin(self.cfg, generator=g).to(self.device)
        if self.kind == "swin_mim":
            params = SwinSearch(self.cfg, self.space, generator=g)
        else:
            params = MimViT(self.cfg, self.space, self.mae, generator=g)
        if not with_arch:
            return params.to(self.device)
        alphas = (SwinAlphas if self.kind == "swin_mim" else Alphas)(
            self.space, generator=g)
        arch = ArchState.create(self.space)
        return (params.to(self.device), alphas.to(self.device),
                arch.to(self.device))


def register_model(fn):
    """Register the factory `fn` under its name (a decorator, the JAX
    package's `register_model`): `create_model(fn.__name__, device=...,
    **kwargs)` calls `fn(device=<torch.device>, **kwargs)`, which returns
    a `ModelBundle`, and `list_models` lists it."""
    _REGISTRY[fn.__name__] = fn
    return fn


def list_models():
    return sorted(_REGISTRY)


def create_model(name: str, *, device="cuda", **kwargs) -> ModelBundle:
    """The named model on `device` (default "cuda"; raises without a card
    unless device="cpu" is asked for)."""
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


# stock ViT variants; vit_huge takes patch 14
_VIT_DIMS = {
    "vit_small": dict(embed_dim=768, depth=8, num_heads=8, mlp_ratio=3.0),
    "vit_base": dict(embed_dim=768, depth=12, num_heads=12, mlp_ratio=4.0),
    "vit_large": dict(embed_dim=1024, depth=24, num_heads=16, mlp_ratio=4.0),
    "vit_huge": dict(embed_dim=1280, depth=32, num_heads=16, mlp_ratio=4.0),
}


def _vit_factory(name: str, default_classes: int = 1000, **cfg_kw):
    def factory(*, device: torch.device, num_classes=default_classes,
                drop_rate=0.0, drop_path_rate=0.0) -> ModelBundle:
        cfg = ModelCfg(num_classes=num_classes, drop_rate=drop_rate,
                       drop_path_rate=drop_path_rate, **cfg_kw)
        return ModelBundle(name=name, cfg=cfg, space=None, device=device,
                           kind="dense")
    return factory


for _vname, _dims in _VIT_DIMS.items():
    for _patch in ((14,) if _vname == "vit_huge" else (16, 32)):
        for _img in (224, 384):
            _n = f"{_vname}_patch{_patch}_{_img}"
            _REGISTRY[_n] = _vit_factory(_n, img_size=_img,
                                         patch_size=_patch, **_dims)
        # in21k pretraining: 21843 classes and a tanh pre-logits layer
        # (no vit_small)
        if _vname != "vit_small":
            _n = f"{_vname}_patch{_patch}_224_in21k"
            _REGISTRY[_n] = _vit_factory(
                _n, 21843, img_size=224, patch_size=_patch,
                representation_size=_dims["embed_dim"], **_dims)

# MIIL: ViT-B/16 without the qkv bias
for _n, _classes in (("vit_base_patch16_224_miil_in21k", 11221),
                     ("vit_base_patch16_224_miil", 1000)):
    _REGISTRY[_n] = _vit_factory(_n, _classes, img_size=224, patch_size=16,
                                 qkv_bias=False, **_VIT_DIMS["vit_base"])

# vit_deit_*: the DeiT models under a second name
for _size in ("tiny", "small", "base"):
    for _img, _dist in ((224, False), (224, True), (384, False), (384, True)):
        if _img == 384 and _size != "base":
            continue
        _suffix = "_distilled" if _dist else ""
        _REGISTRY[f"vit_deit_{_size}{_suffix}_patch16_{_img}"] = \
            _REGISTRY[f"deit_{_size}{_suffix}_patch16_{_img}"]


# the Swin family: dense, and searchable with per-block attention / MLP
# spaces and optionally per-stage residual widths
_SWIN_DIMS = {
    "tiny": dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24)),
    "small": dict(embed_dim=96, depths=(2, 2, 18, 2),
                  num_heads=(3, 6, 12, 24)),
    "base": dict(embed_dim=128, depths=(2, 2, 18, 2),
                 num_heads=(4, 8, 16, 32)),
}


def _swin_factory(size: str, search: bool):
    def factory(*, device: torch.device, num_classes=1000, img_size=224,
                attn_search=True, mlp_search=True, head_search=False,
                channel_search=False, embed_search=False,
                drop_path_rate=0.1, **_unused) -> ModelBundle:
        cfg = SwinCfg(img_size=img_size, num_classes=num_classes,
                      drop_path_rate=drop_path_rate, **_SWIN_DIMS[size])
        name = f"swin_{size}_patch4_window7_224" + ("_mim" if search else "")
        if not search:
            return ModelBundle(name=name, cfg=cfg, space=None, device=device,
                               kind="swin")
        space = build_swin_space(
            cfg, attn_search=attn_search, mlp_search=mlp_search,
            head_search=head_search, channel_search=channel_search,
            embed_search=embed_search)
        return ModelBundle(name=name, cfg=cfg, space=space, device=device,
                           kind="swin_mim")
    return factory


for _size in _SWIN_DIMS:
    _REGISTRY[f"swin_{_size}_patch4_window7_224"] = _swin_factory(_size,
                                                                   False)
    _REGISTRY[f"swin_{_size}_patch4_window7_224_mim"] = _swin_factory(_size,
                                                                       True)
