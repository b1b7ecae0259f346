"""Carry weights and state between the JAX package and the port.

Inputs and outputs are plain numpy: a JAX parameter tree, alphas tree or
`ArchState` whose leaves were pulled to the host (`np.asarray`), or the
same trees as the JAX package's checkpoint files hold them (nested dicts
and lists, `core/msgpack.py`; a bfloat16 leaf is a torch tensor). Layout
rules (the JAX package's own torch import rules):

    Linear kernel (in, out)          <-> weight (out, in)       transpose
    Conv kernel HWIO (kh, kw, i, o)  <-> weight OIHW (o, i, kh, kw)
    LayerNorm scale (D,)             <-> weight (D,)
    everything else (bias, score, tokens, pos_embed, alphas) unchanged

Tree paths become module names: `blocks[3]["attn"]["qkv"]["kernel"]` is
`blocks.3.attn.qkv.weight`. A dense tree with per-block dims (an exported
subnet) loads into a `ViT` built from its config like any other tree.

The optimizers differ in how they name a leaf. The JAX search optimizer
runs over the pair (params, alphas), so its paths start with `0.` or `1.`
(`0.patch_embed.score`, `1.blocks.3.attn`), and the finetune optimizer's
over the params tree alone; the port's names are `patch_embed.score` and
`alphas.blocks.3.attn`. `leaf_name` / `jax_path` map between the two, and
`moments_from_jax`, `opt_tensors_from_jax` and `load_moments_from_jax` carry
Adam's moments across.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from .search_space import (ArchState, AttnArch, BlockArch, DimArch,
                           PatchArch)


def _walk(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (str(i),))
    else:
        yield prefix, tree


def torch_name(path) -> str:
    """Module name of a JAX tree path (a tuple of keys)."""
    path = list(path)
    if path and path[-1] in ("kernel", "scale"):
        path[-1] = "weight"
    return ".".join(path)


def leaf_name(jax_path: str) -> str:
    """The port's leaf name (as in `core.optim.named_leaves`) of a dotted
    JAX optimizer path: `0.<params path>` is a weight, `1.<alphas path>`
    an alpha, anything else a path in a params tree."""
    parts = jax_path.split(".")
    if parts[0] == "0":
        return torch_name(parts[1:])
    if parts[0] == "1":
        return "alphas." + ".".join(parts[1:])
    return torch_name(parts)


def jax_path(name: str, ndim: int = 2, *, pair: bool = True) -> str:
    """The dotted JAX optimizer path of a port leaf name (`ndim` tells a
    LayerNorm `scale` from a `kernel`); with pair=False the path in the
    params tree alone."""
    if name.startswith("alphas."):
        return "1." + name[len("alphas."):]
    parts = name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "scale" if ndim == 1 else "kernel"
    return ("0." if pair else "") + ".".join(parts)


def to_torch_layout(path, a: np.ndarray) -> np.ndarray:
    if path and path[-1] == "kernel":
        if a.ndim == 2:
            return a.T
        if a.ndim == 4:
            return a.transpose(3, 2, 0, 1)
    return a


def _f32(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().float().cpu().numpy()
    return np.asarray(leaf, dtype=np.float32)


def flatten_from_jax(tree) -> Dict[str, np.ndarray]:
    """{module name: array in the port's layout} for a JAX params-shaped
    tree. Leaves that are not arrays (optax's masked-out nodes) are
    skipped."""
    out = {}
    for path, leaf in _walk(tree):
        if not hasattr(leaf, "shape"):
            continue
        out[torch_name(path)] = np.array(to_torch_layout(path, _f32(leaf)),
                                         order="C")
    return out


def load_from_jax(module: nn.Module, tree) -> nn.Module:
    """Copy a JAX params (or alphas) tree into `module`'s parameters, in
    place. Raises if the two disagree on any name or shape."""
    flat = flatten_from_jax(tree)
    named = dict(module.named_parameters())
    if set(flat) != set(named):
        raise KeyError(f"JAX tree and module differ: only in JAX "
                       f"{sorted(set(flat) - set(named))[:8]}, only in the "
                       f"module {sorted(set(named) - set(flat))[:8]}")
    with torch.no_grad():
        for name, p in named.items():
            src = torch.from_numpy(flat[name])
            if src.shape != p.shape:
                raise ValueError(f"{name}: JAX {tuple(src.shape)} vs "
                                 f"port {tuple(p.shape)}")
            p.copy_(src.to(p.device))
    return module


def regnet_from_jax(tree, cfg, device=None, compute_dtype=torch.bfloat16):
    """The port's `RegNetY` holding a JAX RegNet params tree
    (`ofb_tpu.models.regnet`: HWIO kernels, folded-BN `scale` / `bias`,
    (in, out) SE and head kernels)."""
    from .regnet import RegNetY
    return load_from_jax(RegNetY(cfg, device=device,
                                 compute_dtype=compute_dtype), tree)


def to_jax(module: nn.Module) -> Dict[str, Any]:
    """A module's parameters as a nested JAX-layout tree of numpy arrays."""
    root: Dict[str, Any] = {}
    for name, t in module.named_parameters():
        a = t.detach().float().cpu().numpy()
        parts = name.split(".")
        if parts[-1] == "weight":
            if a.ndim == 1:
                parts[-1] = "scale"
            elif a.ndim == 2:
                parts[-1], a = "kernel", a.T
            elif a.ndim == 4:
                parts[-1], a = "kernel", a.transpose(2, 3, 1, 0)
        node = root
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = np.ascontiguousarray(a)
    return _lists(root)


def _lists(node):
    """Turn dicts keyed 0..n-1 into lists, as the JAX trees hold blocks."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


# ---------------------------------------------------------------------------
# ArchState
# ---------------------------------------------------------------------------

def _get(node, name):
    """A field of a JAX ArchState node, or the key of its state dict."""
    return node[name] if isinstance(node, dict) else getattr(node, name)


def _seq(node):
    """The items of a tuple field (a list once read from a file; flax
    writes an empty tuple as an empty map)."""
    return list(node.values()) if isinstance(node, dict) else list(node)


def _state_from(cls, src, device):
    vals = {}
    for f in dataclasses.fields(cls):
        v = _get(src, f.name)
        vals[f.name] = torch.tensor(np.asarray(v), device=device)
    return cls(**vals)


def arch_from_jax(jarch, device=None) -> ArchState:
    """The port's ArchState from a JAX ArchState (any leaf type that
    np.asarray takes), or from its state dict as a checkpoint file holds
    it."""
    return ArchState(
        embed=_state_from(DimArch, _get(jarch, "embed"), device),
        blocks=tuple(BlockArch(
            attn=_state_from(AttnArch, _get(b, "attn"), device),
            mlp=_state_from(DimArch, _get(b, "mlp"), device))
            for b in _seq(_get(jarch, "blocks"))),
        patch=_state_from(PatchArch, _get(jarch, "patch"), device),
        fused=torch.tensor(np.asarray(_get(jarch, "fused")), device=device),
        stage_embeds=tuple(_state_from(DimArch, d, device)
                           for d in _seq(_get(jarch, "stage_embeds"))),
    )


def arch_to_numpy(arch) -> Dict[str, np.ndarray]:
    """Every leaf of an ArchState (port or JAX) by dotted field path."""
    out = {}

    def walk(obj, prefix):
        if isinstance(obj, (tuple, list)):
            for i, x in enumerate(obj):
                walk(x, f"{prefix}.{i}")
        elif dataclasses.is_dataclass(obj):
            for f in dataclasses.fields(obj):
                walk(getattr(obj, f.name),
                     f"{prefix}.{f.name}" if prefix else f.name)
        else:
            out[prefix] = np.asarray(
                obj.cpu() if isinstance(obj, torch.Tensor) else obj)

    walk(arch, "")
    return out


# ---------------------------------------------------------------------------
# Adam moments
# ---------------------------------------------------------------------------

def _fields(node):
    """Children of an optax state node: NamedTuple fields, dict values,
    sequence items; None for a leaf."""
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [getattr(node, f) for f in node._fields]
    if isinstance(node, dict):
        return list(node.values())
    if isinstance(node, (tuple, list)):
        return list(node)
    return None


def _adam_states(node):
    """Every Adam state (a node with `mu`, `nu` and `count`) below `node`,
    at any nesting of optax's chain / multi_transform / masked states, as
    optax objects or as the state dicts a checkpoint file holds."""
    if isinstance(node, dict) and {"mu", "nu", "count"} <= set(node):
        yield node
        return
    if all(hasattr(node, f) for f in ("mu", "nu", "count")):
        yield node
        return
    for child in _fields(node) or ():
        yield from _adam_states(child)


def moments_from_jax(opt_state) -> Dict[str, Any]:
    """{"count": updates done, "mu": {leaf name: array}, "nu": {...}} of a
    JAX optimizer state, merged over its families, in the port's names and
    layouts. Works for the search optimizer (moments over (params, alphas))
    and the finetune optimizer (moments over params)."""
    out: Dict[str, Any] = {"count": None, "mu": {}, "nu": {}}
    for adam in _adam_states(opt_state):
        out["count"] = int(np.asarray(_get(adam, "count")))
        for which in ("mu", "nu"):
            for path, leaf in _walk(_get(adam, which)):
                if hasattr(leaf, "shape"):
                    out[which][leaf_name(".".join(path))] = np.array(
                        to_torch_layout(path, _f32(leaf)), order="C")
    return out


def _lr_scale(opt_state):
    """The plateau scale of a JAX `LrScaleState` (object or state dict),
    else None."""
    if isinstance(opt_state, dict):
        return opt_state.get("scale") if "inner" in opt_state else None
    return getattr(opt_state, "scale", None) \
        if hasattr(opt_state, "inner") else None


def opt_tensors_from_jax(opt_state) -> Dict[str, torch.Tensor]:
    """A JAX optimizer state as the port's flat optimizer part (the layout
    of a checkpoint's `opt_state.pt`): `count`, `scale` when it has a
    plateau scale, and `mu.<leaf>` / `nu.<leaf>` in the port's names and
    layouts, full tensors on the host."""
    got = moments_from_jax(opt_state)
    out = {"count": torch.tensor(got["count"], dtype=torch.int64)}
    scale = _lr_scale(opt_state)
    if scale is not None:
        out["scale"] = torch.as_tensor(_f32(scale))
    for which in ("mu", "nu"):
        out.update({f"{which}.{n}": torch.from_numpy(a)
                    for n, a in got[which].items()})
    return out


def load_moments_from_jax(state, opt_state):
    """Copy a JAX optimizer state's moments and update count into the
    port's `AdamWState` (or the `LrScaleState` around one, with its
    plateau scale), in place, as a checkpoint's optimizer part is
    restored (`core/checkpoint.py:restore_part`)."""
    from ..core.checkpoint import restore_part
    restore_part("opt_state", state, opt_tensors_from_jax(opt_state),
                 "the JAX optimizer state")
    return state
