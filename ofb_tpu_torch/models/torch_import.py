"""Import PyTorch DeiT / ViT checkpoints (timm state dicts) into the port's
models, and export them back.

Port of ofb_tpu/models/torch_import.py. The port keeps PyTorch's layouts and
timm's names (`blocks.0.attn.qkv.weight`, `patch_embed.proj.weight` OIHW,
LayerNorm `weight` / `bias`), so a state dict loads onto a `ViT` or a
`MimViT` name for name, without the JAX package's transposes. What stays is
the reference's handling of a checkpoint made for another model: a
pos-embed of another grid is resized (`pos_embed.interpolate_pos_embed`),
one of another width is skipped, a head of another class count is skipped,
and `strict` reports the keys the model did not take.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from .pos_embed import interpolate_pos_embed
from .vit import ModelCfg


def _f32(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(v, np.float32))


def torch_state_dict_to_params(sd: Dict[str, Any], cfg: ModelCfg,
                               params: nn.Module, *, strict: bool = False
                               ) -> nn.Module:
    """Copy a timm DeiT / ViT state dict into `params` (a `ViT` or
    `MimViT`), in place; returns `params`. Values may be tensors or numpy
    arrays. A pos-embed of another grid is resized, one of another width
    kept at init; a head or distillation head of another class count is
    kept at init. With `strict`, keys the model does not take (other than
    `pre_logits*`) raise KeyError."""
    sd = {k: _f32(v) for k, v in sd.items()}
    own = dict(params.named_parameters())

    def put(name, value):
        dst = own[name]
        if tuple(dst.shape) != tuple(value.shape):
            raise ValueError(f"{name}: checkpoint {tuple(value.shape)}, "
                             f"model {tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(value)

    def linear(prefix):
        for leaf in ("weight", "bias"):
            if prefix + "." + leaf in sd:
                put(prefix + "." + leaf, sd[prefix + "." + leaf])

    def ln(prefix):
        if prefix + ".weight" in sd:
            put(prefix + ".weight", sd[prefix + ".weight"])
            put(prefix + ".bias", sd[prefix + ".bias"])

    if "patch_embed.proj.weight" in sd:
        put("patch_embed.proj.weight", sd["patch_embed.proj.weight"])
        put("patch_embed.proj.bias", sd["patch_embed.proj.bias"])
    for name in ("cls_token", "dist_token", "mask_token"):
        if name in sd and name in own:
            put(name, sd[name])
    if "pos_embed" in sd:
        pe, want = sd["pos_embed"], tuple(own["pos_embed"].shape)
        if tuple(pe.shape) != want:
            pe = interpolate_pos_embed(pe, want[1] - cfg.num_tokens,
                                       cfg.num_tokens) \
                if pe.shape[-1] == want[-1] else None
        if pe is not None and tuple(pe.shape) == want:
            put("pos_embed", pe)
    depth = len(params.blocks)
    for i in range(depth):
        ln(f"blocks.{i}.norm1")
        ln(f"blocks.{i}.norm2")
        for mod in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"):
            linear(f"blocks.{i}.{mod}")
    ln("norm")
    # heads of another class count stay at init, as the reference pops them
    for head in ("head", "head_dist"):
        if head + ".weight" in own and head + ".weight" in sd \
                and sd[head + ".weight"].shape[0] == \
                own[head + ".weight"].shape[0]:
            linear(head)
    if strict:
        consumed = _consumed_keys(depth)
        missing = [k for k in sd if k not in consumed
                   and not k.startswith("pre_logits")]
        if missing:
            raise KeyError(f"unconsumed checkpoint keys: {missing[:10]}")
    return params


def _consumed_keys(depth: int):
    """The state-dict keys a ViT of `depth` blocks takes."""
    keys = {"patch_embed.proj.weight", "patch_embed.proj.bias", "cls_token",
            "dist_token", "mask_token", "pos_embed", "norm.weight",
            "norm.bias", "head.weight", "head.bias", "head_dist.weight",
            "head_dist.bias"}
    for i in range(depth):
        for mod in (f"blocks.{i}.norm1", f"blocks.{i}.norm2",
                    f"blocks.{i}.attn.qkv", f"blocks.{i}.attn.proj",
                    f"blocks.{i}.mlp.fc1", f"blocks.{i}.mlp.fc2"):
            keys.add(mod + ".weight")
            keys.add(mod + ".bias")
    return keys


def params_to_torch_state_dict(params: nn.Module) -> Dict[str, np.ndarray]:
    """The model's timm-layout state dict (numpy fp32): the keys
    `torch_state_dict_to_params` takes that the model has (the search
    scores, the decoder and the alphas are not part of it)."""
    keys = _consumed_keys(len(params.blocks))
    return {n: p.detach().to("cpu", torch.float32).numpy().copy()
            for n, p in params.named_parameters() if n in keys}
