"""Carry weights and state between the JAX package and the port.

Inputs and outputs are plain numpy: a JAX parameter tree, alphas tree or
`ArchState` whose leaves were pulled to the host (`np.asarray`). Layout
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
`moments_from_jax` / `load_moments_from_jax` carry Adam's moments across.
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


def flatten_from_jax(tree) -> Dict[str, np.ndarray]:
    """{module name: array in the port's layout} for a JAX params-shaped
    tree. Leaves that are not arrays (optax's masked-out nodes) are
    skipped."""
    out = {}
    for path, leaf in _walk(tree):
        if not hasattr(leaf, "shape"):
            continue
        out[torch_name(path)] = np.array(
            to_torch_layout(path, np.asarray(leaf, dtype=np.float32)),
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

def _state_from(cls, src, device):
    vals = {}
    for f in dataclasses.fields(cls):
        v = getattr(src, f.name)
        vals[f.name] = torch.tensor(np.asarray(v), device=device)
    return cls(**vals)


def arch_from_jax(jarch, device=None) -> ArchState:
    """The port's ArchState from a JAX ArchState (any leaf type that
    np.asarray takes)."""
    return ArchState(
        embed=_state_from(DimArch, jarch.embed, device),
        blocks=tuple(BlockArch(attn=_state_from(AttnArch, b.attn, device),
                               mlp=_state_from(DimArch, b.mlp, device))
                     for b in jarch.blocks),
        patch=_state_from(PatchArch, jarch.patch, device),
        fused=torch.tensor(np.asarray(jarch.fused), device=device),
        stage_embeds=tuple(_state_from(DimArch, d, device)
                           for d in jarch.stage_embeds),
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
    at any nesting of optax's chain / multi_transform / masked states."""
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
        out["count"] = int(np.asarray(adam.count))
        for which in ("mu", "nu"):
            for path, leaf in _walk(getattr(adam, which)):
                if hasattr(leaf, "shape"):
                    out[which][leaf_name(".".join(path))] = np.array(
                        to_torch_layout(path, np.asarray(leaf, np.float32)),
                        order="C")
    return out


def load_moments_from_jax(state, opt_state):
    """Copy a JAX optimizer state's moments and update count into the
    port's `AdamWState` (or the `LrScaleState` around one), in place."""
    adam = getattr(state, "inner", state)
    got = moments_from_jax(opt_state)
    if set(got["mu"]) != set(adam.mu):
        raise KeyError("JAX optimizer state and the port's differ in leaves: "
                       f"{sorted(set(got['mu']) ^ set(adam.mu))[:8]}")
    with torch.no_grad():
        for which in ("mu", "nu"):
            for name, dst in getattr(adam, which).items():
                dst.copy_(torch.from_numpy(got[which][name]).to(dst.device))
    adam.count = got["count"]
    return state
