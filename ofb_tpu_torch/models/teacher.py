"""The knowledge-distillation teacher of the search and finetune CLIs.

Port of ofb_tpu/models/teacher.py. A teacher is a frozen callable,
`teacher_apply(images (B, H, W, 3) float) -> fp32 logits`, computed in
`compute_dtype` without gradients, on the student's device:

  * a RegNetY name (`regnet.REGNET_CFGS`, the reference's default
    regnety_160): the port's convnet, from a timm state dict at
    `teacher_path` or a seeded random init;
  * a registry DeiT / ViT name: a dense ViT, from a timm state dict through
    `torch_import` or a seeded random init;
  * a registry dense Swin name: a Swin from a seeded random init, run
    through `swin.swin_forward` in eval mode;
  * a directory: a checkpoint of an exported model (its `model_cfg` in
    the meta), the port's or the JAX package's. A finetune's `best` holds
    the better of its raw and EMA weights as `params` (its meta names the
    `eval_winner`), and the teacher takes those; any other directory its
    EMA weights when it has them, else its params.

No weights are downloaded: without `teacher_path` the weights come from a
seed, as in the JAX package. The returned callable keeps its frozen model
as `teacher_apply.model`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

import torch

from ..device import resolve_device
from .regnet import REGNET_CFGS, init_regnet, torch_regnet_to_params
from .vit import ModelCfg, ViT, vit_forward

TEACHER_SEED = 7


def _frozen(params: torch.nn.Module, cfg, compute_dtype,
            forward=vit_forward) -> Callable:
    """teacher_apply(images) -> fp32 logits of `forward` (a dense ViT's or
    Swin's) in eval mode, without gradients."""
    params.requires_grad_(False)

    @torch.no_grad()
    def teacher_apply(images):
        return forward(params, images, cfg, train=False,
                       compute_dtype=compute_dtype)

    teacher_apply.model = params
    return teacher_apply


def _from_checkpoint(path: str, dev, compute_dtype) -> Callable:
    from ..core import checkpoint as ckpt
    meta = ckpt.latest_meta(path)
    if meta is None:
        raise SystemExit(f"teacher_path {path}: no checkpoint meta.json found")
    if meta.get("family") == "swin":
        raise SystemExit("swin teacher checkpoints are not supported "
                         "as KD teachers yet (vit/regnet only)")
    if "model_cfg" not in meta:
        raise SystemExit(f"teacher_path {path}: a teacher checkpoint is an "
                         "exported model with a model_cfg in its meta.json")
    cfg = ckpt.model_cfg_from_meta(meta["model_cfg"], ModelCfg)
    # the weights come from the checkpoint: built on the device, unseeded
    params = ViT(cfg, device=dev)
    ema = ViT(cfg, device=dev) if "ema" in meta.get("parts", []) else None
    restored = ckpt.load_checkpoint(path, params=params, ema_params=ema)
    use = "params" if "eval_winner" in meta or "ema" not in restored \
        else "ema"
    return _frozen(restored[use], cfg, compute_dtype)


def build_teacher(name: str, *, teacher_path: str = "", num_classes: int,
                  compute_dtype=torch.bfloat16, device="cuda") -> Callable:
    """teacher_apply(images) -> fp32 logits of a frozen teacher on `device`
    (default "cuda"; raises without a card unless device="cpu" is asked
    for)."""
    dev = resolve_device(device)
    if teacher_path and os.path.isdir(teacher_path):
        return _from_checkpoint(teacher_path, dev, compute_dtype)
    sd = None
    if teacher_path:
        sd = torch.load(teacher_path, map_location="cpu", weights_only=True)
        sd = sd.get("model", sd)
    if name in REGNET_CFGS:
        rcfg = dataclasses.replace(REGNET_CFGS[name], num_classes=num_classes)
        model = init_regnet(rcfg, TEACHER_SEED, device=dev,
                            compute_dtype=compute_dtype)
        if sd is not None:
            torch_regnet_to_params(sd, rcfg, model)
        return model
    from .registry import create_model
    from .torch_import import torch_state_dict_to_params
    try:
        bundle = create_model(name, num_classes=num_classes, device=dev)
    except KeyError as e:
        raise SystemExit(
            f"teacher model '{name}' is neither a RegNetY "
            f"({'/'.join(REGNET_CFGS)}) nor a registry ViT/DeiT") from e
    if bundle.kind not in ("dense", "swin"):
        raise SystemExit(f"teacher model '{name}' is a searchable supernet; "
                         "a teacher is a dense ViT/DeiT/Swin or a RegNetY")
    params = bundle.init(TEACHER_SEED)
    if bundle.kind == "swin":
        if sd is not None:
            raise SystemExit(f"teacher model '{name}': a Swin teacher comes "
                             "from its seed; a timm state dict is read for "
                             "a ViT/DeiT or a RegNetY only")
        from .swin import swin_forward
        return _frozen(params, bundle.cfg, compute_dtype, swin_forward)
    if sd is not None:
        torch_state_dict_to_params(sd, bundle.cfg, params)
    return _frozen(params, bundle.cfg, compute_dtype)
