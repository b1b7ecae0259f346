"""Layer-wise learning-rate decay for finetune.

Port of ofb_tpu/core/lr_decay.py. BEiT-style per-layer scales, scale =
layer_decay ** (num_layers - layer id), multiply each parameter's finished
update: the same as a per-group learning rate. The finetune optimizer is
the functional AdamW of the `optim` module with a decay and a no-decay
family, one clip over all gradients before Adam, and the layer scale last.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..config import OptimFamilyConfig
from .optim import NO_DECAY_NAMES, Family, SearchOptimizer


def layer_id_for_vit(name: str, num_layers: int) -> int:
    """embeddings -> 0, blocks.i -> i + 1, everything else (final norm,
    head) -> num_layers."""
    if name.startswith(("cls_token", "dist_token", "pos_embed", "mask_token")):
        return 0
    if name.startswith("patch_embed"):
        return 0
    if name.startswith("blocks."):
        return int(name.split(".")[1]) + 1
    return num_layers


def layer_scale_tree(params: torch.nn.Module, layer_decay: float,
                     num_layers: int) -> Dict[str, float]:
    """{parameter name: layer scale}."""
    return {n: layer_decay ** (num_layers - layer_id_for_vit(n, num_layers))
            for n, _ in params.named_parameters()}


def _decay_label(name: str, ndim: int) -> str:
    nd = (ndim <= 1 or name.endswith("bias")
          or any(k in name for k in NO_DECAY_NAMES))
    return "nd" if nd else "d"


def build_finetune_optimizer(params: torch.nn.Module, *,
                             lr_schedule: Callable[[int], float],
                             betas=(0.9, 0.999), eps=1e-8, weight_decay=0.05,
                             layer_decay: Optional[float] = 0.95,
                             num_layers: int = 12,
                             clip_grad: Optional[float] = None
                             ) -> SearchOptimizer:
    """AdamW + layer-wise lr decay + the no-decay skip list. In this order:
    clip by the global norm of all gradients, AdamW (`lr_schedule` of the
    update count), the per-layer scale of the update. `init` and `update`
    take `dict(params.named_parameters())`."""
    fam = OptimFamilyConfig(lr=None, eps=eps, betas=tuple(betas))
    scales = None
    if layer_decay is not None and layer_decay < 1.0:
        scales = layer_scale_tree(params, layer_decay, num_layers)
    return SearchOptimizer(
        {"nd": Family(fam, lr_schedule, 0.0),
         "d": Family(fam, lr_schedule, weight_decay)},
        clip_grad, accum_iter=1, label_fn=_decay_label, clip_global=True,
        leaf_scale=scales)
