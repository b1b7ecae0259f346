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

`load_checkpoint` restores into a tensor-parallel supernet too: it cuts
each saved full tensor of the sharded parts (params, the Adam moments, EMA)
down to this rank's shard of the live layout (`parallel/mesh.py:
shard_tensor`), the port's files and the JAX package's alike, so a
checkpoint saved at any mesh or by one process resumes on any model axis
the config splits over. This stands in for what the JAX package's orbax
backend gives it: "sharded templates restore to their shardings"
(`load_checkpoint_orbax`). Every rank reads the file that rank 0 wrote,
after `commit_saves` fenced them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Any, Callable, Dict, Optional

import torch

from ..models.search_space import ArchState
from ..parallel.distributed import barrier_sync
from ..parallel.mesh import (TPLayout, full_shape, gather_named, shard_kind,
                             shard_tensor, tp_of)
from ..utils.logging import is_main_process
from .msgpack import read_tree
from .optim import LrScaleState, set_count

FORMAT_VERSION = 1
PARTS = ("params", "alphas", "arch", "opt_state", "ema")
# the parts a tensor-parallel supernet holds as shards (alphas and the arch
# state are replicated)
SHARDED_PARTS = ("params", "opt_state", "ema")

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


def _cut(name: str, saved: Dict[str, torch.Tensor],
         live: Dict[str, torch.Tensor], layout: TPLayout,
         path: str) -> Dict[str, torch.Tensor]:
    """`saved` with each sharded leaf's full tensor cut down to this rank's
    shard of `layout`; raises ValueError, naming the leaf, when a saved
    full tensor is not the full shape of its live shard (another width or
    head count)."""
    out = dict(saved)
    for n, t in saved.items():
        if shard_kind(n) is None:
            continue
        want = full_shape(n, live[n].shape, layout)
        if tuple(t.shape) != want:
            raise ValueError(f"{path}: {name}.{n} saved {tuple(t.shape)}, "
                             f"live a shard {tuple(live[n].shape)} of "
                             f"{want}")
        out[n] = shard_tensor(n, t, layout)
    return out


def _checked(name: str, obj, saved: Dict[str, torch.Tensor], path: str,
             layout: Optional[TPLayout] = None) -> Callable[[], None]:
    """Check a saved part (a flat {name: tensor} dict, full tensors) against
    the live object and return the function that copies it in, in place,
    on the live tensors' devices; with `layout` (a sharded supernet's) the
    sharded parts' leaves are first cut to this rank's shards. Raises
    KeyError when the names differ (or one optimizer state has a plateau
    scale and the other not) and ValueError, naming the leaf, when a shape
    does."""
    if name == "opt_state" and \
            ("scale" in saved) != isinstance(obj, LrScaleState):
        raise KeyError(f"{path}: the saved optimizer state and the live one "
                       "differ: one has a plateau scale (with_lr_scale), the "
                       "other not")
    live = _live(name, obj)
    if set(live) != set(saved):
        raise KeyError(f"{path}: part {name!r} differs from the model: only "
                       f"saved {sorted(set(saved) - set(live))[:6]}, only "
                       f"live {sorted(set(live) - set(saved))[:6]}")
    if layout is not None and name in SHARDED_PARTS:
        saved = _cut(name, saved, live, layout, path)
    for n, t in live.items():
        if n != "count" and t.shape != saved[n].shape:
            raise ValueError(f"{path}: {name}.{n} saved "
                             f"{tuple(saved[n].shape)}, live "
                             f"{tuple(t.shape)}")

    def copy():
        with torch.no_grad():
            for n, t in live.items():
                if n != "count":
                    t.copy_(saved[n])
        if name == "opt_state":
            adam = obj.inner if isinstance(obj, LrScaleState) else obj
            set_count(adam, int(saved["count"]))

    return copy


def restore_part(name: str, obj, saved: Dict[str, torch.Tensor], path: str,
                 layout: Optional[TPLayout] = None) -> None:
    """Copy a saved part into the live object, in place, once `_checked`
    has passed it."""
    _checked(name, obj, saved, path, layout)()


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
                             if name in SHARDED_PARTS else _live(name, obj))
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
    carried over by `_from_jax`; its orbax backend raises
    NotImplementedError. Into a tensor-parallel `params` (`tp_of`) the
    params, the moments and EMA are restored as this rank's shards of the
    saved full tensors.

    Raises FileNotFoundError without a meta.json (a directory whose writer
    never finished) or with a listed part missing that was asked for, and
    KeyError or ValueError when a part does not fit its live object; every
    part is checked before any is restored, so then nothing is."""
    meta = _read_meta(path)
    jax = is_jax_checkpoint(path, meta)
    if jax:
        _refuse_orbax(path, meta)
    objs = dict(zip(PARTS, (params, alphas, arch, opt_state, ema_params)))
    layout = tp_of(params)
    out: Dict[str, Any] = {"meta": meta}
    copies = []
    for name in meta.get("parts", []):
        obj = objs.get(name)
        if obj is None:
            continue
        fpath = os.path.join(path, name + (".msgpack" if jax else ".pt"))
        if not os.path.exists(fpath):
            raise FileNotFoundError(f"part {name!r} listed in "
                                    f"{path}/meta.json but {fpath} is "
                                    "missing")
        saved = _from_jax(name, read_tree(fpath)) if jax else torch.load(
            fpath, map_location="cpu", weights_only=True)
        copies.append(_checked(name, obj, saved, path, layout))
        out[name] = obj
    # every part checked before any is copied: a checkpoint of another
    # width or head count changes nothing
    for copy in copies:
        copy()
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


def _from_jax(name: str, tree) -> Dict[str, torch.Tensor]:
    """One part of a JAX checkpoint (its decoded tree) as the port's flat
    part of full tensors, which `_checked` then cuts and copies like
    the port's own: params and EMA in the port's names and layouts
    (`flatten_from_jax`), the ArchState's tensors (`arch_from_jax`), the
    count, plateau scale and moments (`opt_tensors_from_jax`)."""
    from ..models.from_jax import (arch_from_jax, flatten_from_jax,
                                   opt_tensors_from_jax)
    if name == "arch":
        return _arch_tensors(arch_from_jax(tree))
    if name == "opt_state":
        return opt_tensors_from_jax(tree)
    return {n: torch.from_numpy(a) for n, a in flatten_from_jax(tree).items()}


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
