"""Checkpoint and resume.

Port of ofb_tpu/core/checkpoint.py. Same directory layout and artifact set
(running_ckpt / best / model_pruned / model_fused, exported subnets), one
file per part plus `meta.json`:

    <part>.pt    torch.save of a flat {name: tensor} dict, for the parts
                 params, alphas, arch, opt_state and ema
    meta.json    {"format_version": 1, "parts": [...], **caller's meta},
                 written last, so a readable meta implies readable parts

Every file is written to a temporary name and moved into place with
`os.replace`.

A Swin checkpoint's meta says `family: "swin"`; an exported or dense one
holds its `SwinCfg` as `model_cfg` and, for a subnet, each block's
`mlp_hidden` (`blocks`) and the stages' residual widths (`stage_dims`),
from which `swin_from_meta` builds the module to restore into.

The JAX package writes `<part>.msgpack` (flax's msgpack) with the same
meta.json. `load_checkpoint` reads such a directory too: `core/msgpack.py`
decodes the parts and `models/from_jax.py` carries them into the port's
layouts. Two rules differ from the JAX package's
loader: a part the caller asks for that meta.json lists but whose file is
missing raises (JAX skips it), and the orbax backend is not read. The JAX
package never reads the port's format.

The steps update parameters, moments and EMA in place, so `save_checkpoint`
takes its snapshot (a copy to the host) before it returns, even with
async_write: only serialisation and file I/O run on the writer thread.
A tensor-parallel supernet's shards (and their EMA and Adam moments) are
gathered into the full tensors first, so its checkpoint is the
one-process format.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Any, Dict, Optional

import torch

from ..models.search_space import ArchState
from ..parallel.distributed import barrier_sync
from ..parallel.mesh import gather_named, tp_of
from ..utils.logging import is_main_process
from .msgpack import read_tree
from .optim import LrScaleState, set_count

FORMAT_VERSION = 1
PARTS = ("params", "alphas", "arch", "opt_state", "ema")

_PENDING: Dict[str, threading.Thread] = {}
_PENDING_LOCK = threading.Lock()


# ---------------------------------------------------------------------------
# Parts as flat {name: tensor} dicts, and back in place
# ---------------------------------------------------------------------------

def _arch_tensors(arch: ArchState, prefix: str = "") -> Dict[str, Any]:
    """Every tensor of an ArchState by dotted field path (live tensors)."""
    out = {}
    for f in dataclasses.fields(arch):
        v = getattr(arch, f.name)
        name = f"{prefix}{f.name}"
        if isinstance(v, torch.Tensor):
            out[name] = v
        elif isinstance(v, tuple):
            for i, x in enumerate(v):
                out.update(_arch_tensors(x, f"{name}.{i}."))
        elif dataclasses.is_dataclass(v):
            out.update(_arch_tensors(v, f"{name}."))
    return out


def _opt_tensors(opt_state) -> Dict[str, Any]:
    """An AdamWState (or the LrScaleState around one) as tensors; the
    update count as a 0-d int64 tensor."""
    out = {}
    adam = opt_state
    if isinstance(opt_state, LrScaleState):
        out["scale"] = opt_state.scale
        adam = opt_state.inner
    out["count"] = torch.tensor(int(adam.count), dtype=torch.int64)
    out.update({f"mu.{n}": t for n, t in adam.mu.items()})
    out.update({f"nu.{n}": t for n, t in adam.nu.items()})
    return out


def _live(name: str, obj) -> Dict[str, Any]:
    """The live tensors of one part, by name: a module's state dict, an
    {name: tensor} dict as it is (EMA weights), the arch state's or the
    optimizer state's tensors."""
    if isinstance(obj, torch.nn.Module):
        return obj.state_dict()
    if name == "arch":
        return _arch_tensors(obj)
    if name == "opt_state":
        return _opt_tensors(obj)
    return dict(obj)


def _snapshot(tensors: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {n: t.detach().to("cpu", copy=True) for n, t in tensors.items()}


def _restore(name: str, obj, saved: Dict[str, torch.Tensor], path: str):
    """Copy a saved part into the live object, in place; raises when the
    names or shapes differ."""
    if isinstance(obj, torch.nn.Module):
        obj.load_state_dict(saved, strict=True)
        return
    live = _live(name, obj)
    if set(live) != set(saved):
        raise KeyError(f"{path}: part {name!r} differs from the model: only "
                       f"saved {sorted(set(saved) - set(live))[:6]}, only "
                       f"live {sorted(set(live) - set(saved))[:6]}")
    with torch.no_grad():
        for n, t in live.items():
            if n == "count":
                continue
            if t.shape != saved[n].shape:
                raise ValueError(f"{path}: {name}.{n} saved "
                                 f"{tuple(saved[n].shape)}, live "
                                 f"{tuple(t.shape)}")
            t.copy_(saved[n])
    if name == "opt_state":
        adam = obj.inner if isinstance(obj, LrScaleState) else obj
        set_count(adam, int(saved["count"]))


# ---------------------------------------------------------------------------
# Save / load
# ---------------------------------------------------------------------------

def _write(path: str, parts: Dict[str, Dict[str, torch.Tensor]],
           meta: Optional[Dict[str, Any]]) -> None:
    for name, flat in parts.items():
        dst = os.path.join(path, name + ".pt")
        torch.save(flat, dst + ".tmp")
        os.replace(dst + ".tmp", dst)
    mdst = os.path.join(path, "meta.json")
    with open(mdst + ".tmp", "w") as f:
        json.dump({"format_version": FORMAT_VERSION, "parts": list(parts),
                   **(meta or {})}, f, indent=2)
    os.replace(mdst + ".tmp", mdst)


def save_checkpoint(path: str, *, params, alphas=None, arch=None,
                    opt_state=None, ema_params=None,
                    meta: Optional[Dict[str, Any]] = None,
                    async_write: bool = False) -> None:
    """Write a checkpoint directory (rank 0 only; with a tensor-parallel
    `params` every rank calls it, for the gather of the shards). The parts
    are copied to the host before this returns; with async_write,
    serialisation and file I/O then run on a background thread (writes to
    one directory run one after the other)."""
    layout = tp_of(params)
    if not is_main_process() and layout is None:
        return
    objs = dict(zip(PARTS, (params, alphas, arch, opt_state, ema_params)))
    parts = {name: _snapshot(gather_named(_live(name, obj), layout)
                             if name in ("params", "opt_state", "ema")
                             else _live(name, obj))
             for name, obj in objs.items() if obj is not None}
    if not is_main_process():
        return
    os.makedirs(path, exist_ok=True)
    if not async_write:
        _write(path, parts, meta)
        return
    norm = os.path.abspath(path)
    with _PENDING_LOCK:
        prev = _PENDING.get(norm)
    if prev is not None:
        prev.join()
    t = threading.Thread(target=_write, args=(path, parts, meta),
                         daemon=True)
    with _PENDING_LOCK:
        _PENDING[norm] = t
    t.start()


def wait_for_pending_saves():
    """Join outstanding async checkpoint writes (call before exit)."""
    with _PENDING_LOCK:
        pending = list(_PENDING.values())
        _PENDING.clear()
    for t in pending:
        t.join()


def commit_saves(name: str = "checkpoints committed") -> None:
    """Join the async writer, then fence the ranks: after this every rank
    may read what rank 0 wrote (a no-op fence without a process group)."""
    wait_for_pending_saves()
    barrier_sync(name)


def latest_meta(path: str) -> Optional[Dict[str, Any]]:
    p = os.path.join(path, "meta.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def is_jax_checkpoint(path: str, meta: Dict[str, Any]) -> bool:
    """Whether the directory holds the JAX package's parts (flax msgpack
    or orbax) rather than the port's `<part>.pt`."""
    return meta.get("backend") == "orbax" or any(
        os.path.exists(os.path.join(path, n + ".msgpack"))
        and not os.path.exists(os.path.join(path, n + ".pt"))
        for n in meta.get("parts", []))


def _read_meta(path: str) -> Dict[str, Any]:
    """meta.json of a checkpoint; raises without one (a writer that never
    finished) or when its format is newer than this build's."""
    meta = latest_meta(path)
    if meta is None:
        raise FileNotFoundError(f"no checkpoint at {path} (no meta.json)")
    ver = meta.get("format_version", 1)
    if ver > FORMAT_VERSION:
        raise ValueError(f"checkpoint format {ver} is newer than this build "
                         f"understands ({FORMAT_VERSION}): {path}")
    return meta


def load_checkpoint(path: str, *, params=None, alphas=None, arch=None,
                    opt_state=None, ema_params=None) -> Dict[str, Any]:
    """Restore the parts of the checkpoint at `path` into the live objects
    handed in (modules, ArchState, optimizer state, EMA dict), in place.
    Returns {"meta": meta, <part>: the object restored into, ...}; a part
    the checkpoint lacks, or no object was handed for, is left out. A
    directory the JAX package wrote is read with `core/msgpack.py` and
    carried over by `_restore_jax`; its orbax backend raises
    NotImplementedError.

    Raises FileNotFoundError without a meta.json (a directory whose writer
    never finished) or with a listed part missing that was asked for."""
    meta = _read_meta(path)
    jax = is_jax_checkpoint(path, meta)
    if jax:
        _refuse_orbax(path, meta)
    objs = dict(zip(PARTS, (params, alphas, arch, opt_state, ema_params)))
    out: Dict[str, Any] = {"meta": meta}
    for name in meta.get("parts", []):
        obj = objs.get(name)
        if obj is None:
            continue
        fpath = os.path.join(path, name + (".msgpack" if jax else ".pt"))
        if not os.path.exists(fpath):
            raise FileNotFoundError(f"part {name!r} listed in "
                                    f"{path}/meta.json but {fpath} is "
                                    "missing")
        if jax:
            _restore_jax(name, obj, read_tree(fpath), path)
        else:
            saved = torch.load(fpath, map_location="cpu", weights_only=True)
            _restore(name, obj, saved, path)
        out[name] = obj
    return out


# ---------------------------------------------------------------------------
# The JAX package's checkpoints
# ---------------------------------------------------------------------------

def _refuse_orbax(path: str, meta: Dict[str, Any]) -> None:
    if meta.get("backend") == "orbax":
        raise NotImplementedError(
            f"{path} was written by the JAX package's orbax backend, which "
            "the port does not read (ROADMAP Queue 1 item 17); save it with "
            "the default msgpack backend")


def load_checkpoint_raw(path: str) -> Dict[str, Any]:
    """The JAX package's `load_checkpoint_raw`: {"meta": meta, <part>: the
    part's tree of dicts, lists and arrays} for every part meta.json lists
    whose `<part>.msgpack` exists, shapes from the files; of the port's
    own directories, the flat {name: tensor} dict of each `<part>.pt`."""
    meta = _read_meta(path)
    _refuse_orbax(path, meta)
    out: Dict[str, Any] = {"meta": meta}
    for name in meta.get("parts", []):
        base = os.path.join(path, name)
        if os.path.exists(base + ".msgpack"):
            out[name] = read_tree(base + ".msgpack")
        elif os.path.exists(base + ".pt"):
            out[name] = torch.load(base + ".pt", map_location="cpu",
                                   weights_only=True)
    return out


def _restore_jax(name: str, obj, tree, path: str) -> None:
    """Copy one part of a JAX checkpoint (its decoded tree) into the live
    object, in place: a module through `load_from_jax`, an EMA dict by
    name, the ArchState's tensors through `arch_from_jax`, the moments,
    count and plateau scale through `load_moments_from_jax`."""
    from ..models.from_jax import (arch_from_jax, flatten_from_jax,
                                   load_from_jax, load_moments_from_jax)
    if name == "arch":
        _restore(name, obj, _arch_tensors(arch_from_jax(tree)), path)
    elif name == "opt_state":
        load_moments_from_jax(obj, tree)
    elif isinstance(obj, torch.nn.Module):
        load_from_jax(obj, tree)
    else:                                   # an EMA {name: tensor} dict
        _restore(name, obj, {n: torch.from_numpy(a) for n, a in
                             flatten_from_jax(tree).items()}, path)


def model_cfg_from_meta(cfg_dict: Dict[str, Any], cfg_cls):
    """Rebuild a frozen, tuple-field config dataclass from the JSON round
    trip of dataclasses.asdict: lists become tuples, nested ones too. A
    JAX package's config is taken as it stands, its `remat` with it."""
    def conv(v):
        if isinstance(v, list):
            return tuple(conv(x) for x in v)
        return v
    return cfg_cls(**{k: conv(v) for k, v in cfg_dict.items()})


def swin_from_meta(meta: Dict[str, Any], device=None):
    """(dense `Swin` with the widths of an exported subnet or a dense Swin
    checkpoint's meta, its `SwinCfg`), unseeded on `device`, to restore
    the checkpoint into; the JAX package's metas and the port's alike."""
    from ..models.swin import Swin, SwinCfg, subnet_widths
    cfg = model_cfg_from_meta(meta["model_cfg"], SwinCfg)
    return Swin(cfg, device=device, **subnet_widths(meta)), cfg
