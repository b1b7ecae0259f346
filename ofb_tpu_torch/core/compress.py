"""Compress state machine: cell kill / trim / convergence, statically.

Port of ofb_tpu/core/compress.py. A prune event only rewrites the small
`ArchState` tensors, the alphas and (at convergence) the module's saliency
score, so the step never changes shape:

  event            effect
  ---------------  -------------------------------------------------------
  cell kill        switch cell off, its alpha zeroed
  trailing trim    hard mask zeroed beyond the new max ratio, in score-rank
                   order
  convergence      hard mask = the final keep set; score rewritten to
                   w_p * sigmoid(score) + (1 - w_p) there, zero elsewhere
  moments          Adam moments of the touched alpha / score zeroed

The decision math is numpy float64 on host copies, as in the JAX package.
Its inputs come to the host in one copy (`fetch_host`: on a GPU every separate
read is a synchronisation) and only the small rewritten tensors go back,
written in place under `no_grad`: the step and the optimizer state hold
references to these very tensors by name, so none is replaced.

The per-stage embed widths of hierarchical (Swin) models are not ported
yet: a search space with `stage_embeds` raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.search_space import (ArchState, AttnSpace, DimSpace,
                                   SearchSpace)
from .optim import zero_adam_moments


def fetch_host(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Host copies of small tensors through one device-to-host transfer
    (flattened to fp32 and concatenated; bools and small ints survive
    exactly), each in its own shape and type."""
    if not tensors:
        return []
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32)
                      for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        a = flat[at:at + n].reshape(tuple(t.shape))
        at += n
        if t.dtype == torch.bool:
            a = a > 0.5
        elif not t.dtype.is_floating_point:
            a = a.astype(np.int64)
        out.append(a)
    return out


def _put(dst: torch.Tensor, value) -> None:
    """dst[...] = value, in place, keeping dst's type and device."""
    with torch.no_grad():
        dst.copy_(torch.as_tensor(np.asarray(value)).to(dst.dtype))


def _masked_softmax_np(alpha: np.ndarray, switch: np.ndarray) -> np.ndarray:
    a = np.where(switch, alpha.astype(np.float64), -np.inf).reshape(-1)
    a = a - a.max()
    e = np.exp(a)
    p = e / e.sum()
    return np.where(switch.reshape(-1), p, 0.0).reshape(alpha.shape)


@dataclass
class CellEvent:
    pruned: bool = False
    converged: bool = False
    new_switch: Optional[np.ndarray] = None
    new_alpha: Optional[np.ndarray] = None
    killed: int = 0


def _kill_cells(alpha: np.ndarray, switch: np.ndarray, thresh: float
                ) -> CellEvent:
    """Cell-kill decision: softmax over the active cells; kill every cell
    with prob <= thresh / n_active; the alpha of killed cells is zeroed."""
    n_active = int(switch.sum())
    if n_active <= 1:
        return CellEvent()
    thr = thresh / n_active
    p_active = _masked_softmax_np(alpha, switch)
    p_min = p_active[switch].min()
    if p_min > thr:
        return CellEvent()
    new_switch = p_active > thr
    if new_switch.sum() == 0:          # numerical guard: keep the best cell
        best = np.unravel_index(np.argmax(p_active), p_active.shape)
        new_switch = np.zeros_like(switch)
        new_switch[best] = True
    new_alpha = np.where(new_switch, alpha, 0.0)
    return CellEvent(pruned=True, converged=int(new_switch.sum()) == 1,
                     new_switch=new_switch, new_alpha=new_alpha,
                     killed=n_active - int(new_switch.sum()))


def _topk_mask_1d(score: np.ndarray, hard: np.ndarray, k: int) -> np.ndarray:
    """0/1 mask keeping the top-k alive channels by score (ties in index
    order: a stable sort)."""
    s = np.where(hard > 0, score.reshape(-1).astype(np.float64), -np.inf)
    keep = np.argsort(-s, kind="stable")[:k]
    m = np.zeros_like(hard)
    m[keep] = 1.0
    return m


def _compress_dim(alpha, switch, score, hard, w_p, thresh: float,
                  space: DimSpace) -> Dict[str, Any]:
    """1-D width compress (embed / MLP hidden). Returns a dict of updates:
    {pruned, switch, alpha, finished, hard (opt), score (opt)}."""
    ev = _kill_cells(alpha, switch, thresh)
    if not ev.pruned:
        return {"pruned": False}
    out: Dict[str, Any] = {"pruned": True, "switch": ev.new_switch,
                           "alpha": ev.new_alpha, "finished": ev.converged}
    sizes = space.cell_sizes
    new_max = int(sizes[ev.new_switch.reshape(-1)].max())
    cur_alive = int((hard > 0).sum())
    if ev.converged:
        keep = int(sizes[np.argmax(ev.new_switch.reshape(-1))])
        new_hard = _topk_mask_1d(score, hard, keep)
        sig = 1.0 / (1.0 + np.exp(-score.astype(np.float64)))
        new_score = (w_p * sig + (1.0 - w_p)) * new_hard
        out.update(hard=new_hard, score=new_score.astype(np.float32))
    elif new_max < cur_alive:
        # trailing-cell trim
        out.update(hard=_topk_mask_1d(score, hard, new_max))
    return out


def _compress_attn(alpha, switch, score, hard, w_p, thresh: float,
                   space: AttnSpace) -> Dict[str, Any]:
    """Joint head x channel compress."""
    ev = _kill_cells(alpha, switch, thresh)
    if not ev.pruned:
        return {"pruned": False}
    out: Dict[str, Any] = {"pruned": True, "switch": ev.new_switch,
                           "alpha": ev.new_alpha, "finished": ev.converged}
    H, d = hard.shape
    rows = ev.new_switch.any(axis=1)
    cols = ev.new_switch.any(axis=0)
    head_cnt = int(space.head_list[int(np.where(rows)[0].max())])
    chan_cnt = int(space.chan_counts[int(np.where(cols)[0].max())])

    cur_heads = int((hard.sum(axis=1) > 0).sum())
    cur_chans = int(hard.sum(axis=1).max())
    need_trim = ev.converged or head_cnt < cur_heads or chan_cnt < cur_chans
    if need_trim:
        sb = np.broadcast_to(np.asarray(score, np.float64), (H, d))
        sig = 1.0 / (1.0 + np.exp(-sb))
        head_sal = (sig * hard).sum(axis=1)
        head_alive = hard.sum(axis=1) > 0
        hs = np.where(head_alive, head_sal, -np.inf)
        keep_heads = np.argsort(-hs, kind="stable")[:head_cnt]
        new_hard = np.zeros_like(hard)
        for h in keep_heads:
            s = np.where(hard[h] > 0, sb[h], -np.inf)
            keep_c = np.argsort(-s, kind="stable")[:chan_cnt]
            new_hard[h, keep_c] = 1.0
        out["hard"] = new_hard
        out["scale"] = float(chan_cnt) ** -0.5
        out["head_alive"] = head_cnt
        if ev.converged:
            score_np = np.asarray(score, np.float64)
            sig_s = 1.0 / (1.0 + np.exp(-score_np))
            # reduce hard to the stored score's (possibly broadcast) shape
            if score_np.shape == (H, d):
                hard_s = new_hard
            elif score_np.shape[0] == 1:       # channel search, (1, d)
                hard_s = new_hard[keep_heads[0]][None, :]
            else:                               # head search, (H, 1)
                hard_s = (new_hard.sum(axis=1, keepdims=True) > 0) * 1.0
            new_score = (w_p * sig_s + (1.0 - w_p)) * hard_s
            out.update(score=new_score.astype(np.float32))
    return out


@dataclass
class CompressReport:
    execute_prune: bool = False
    finish_search: bool = False
    events: List[str] = None

    def __post_init__(self):
        if self.events is None:
            self.events = []


@dataclass
class _Module:
    """One searchable dimension of a pass: its tensors on the device and,
    once fetched, their host copies."""
    label: str                   # as the report's events name it
    stem: str                    # alpha 'alphas.<stem>', score '<stem>.score'
    kind: str                    # 'patch' | 'dim' | 'attn'
    space: Any
    alpha: torch.Tensor
    arch: Any
    score: Optional[torch.Tensor] = None
    host: Optional[Dict[str, Any]] = None

    @property
    def score_name(self) -> str:
        return "patch_embed.score" if self.stem == "embed" \
            else self.stem + ".score"

    def device_tensors(self) -> List[torch.Tensor]:
        ts = [self.alpha, self.arch.switch, self.arch.finished]
        if self.kind != "patch":
            ts += [self.arch.hard_mask, self.arch.w_p, self.score]
        return ts

    def take(self, host) -> None:
        """Pull this module's host copies, in `device_tensors` order."""
        self.host = dict(alpha=next(host), switch=next(host),
                         finished=bool(next(host)))
        if self.kind != "patch":
            self.host.update(hard=next(host), w_p=float(next(host)),
                             score=next(host))


def _modules(params, alphas, arch: ArchState, space: SearchSpace):
    """Every searchable dimension, in the order of a pass."""
    yield _Module("patch", "patch", "patch", space.patch, alphas.patch,
                  arch.patch)
    yield _Module("embed", "embed", "dim", space.embed, alphas.embed,
                  arch.embed, params.patch_embed.score)
    for i, bs in enumerate(space.blocks):
        blk, ba, al = params.blocks[i], arch.blocks[i], alphas.blocks[i]
        yield _Module(f"block{i}.attn", f"blocks.{i}.attn", "attn", bs.attn,
                      al.attn, ba.attn, blk.attn.score)
        yield _Module(f"block{i}.mlp", f"blocks.{i}.mlp", "dim", bs.mlp,
                      al.mlp, ba.mlp, blk.mlp.score)


def compress(params, alphas, arch: ArchState, opt_state,
             space: SearchSpace, thresh: float = 0.2
             ) -> Tuple[Any, Any, ArchState, Any, CompressReport]:
    """Run one compression pass over every searchable dimension.

    Returns (params, alphas, arch, opt_state, report): the objects handed
    in, rewritten in place (alphas, arch tensors, converged scores, the
    Adam moments of the touched leaves; `opt_state` may be None). The
    decisions run on the host, on one bulk copy of the alphas, the arch
    state and the scores."""
    if space.stage_embeds:
        raise NotImplementedError(
            "per-stage embed widths (Swin) are not ported yet")
    report = CompressReport()
    zero_names: List[str] = []

    mods = list(_modules(params, alphas, arch, space))
    host = iter(fetch_host([t for m in mods for t in m.device_tensors()]))
    for m in mods:
        m.take(host)

    all_finished = True
    for m in mods:
        h, am = m.host, m.arch
        switch, finished = h["switch"], h["finished"]
        upd: Dict[str, Any] = {"pruned": False}
        if m.kind == "patch" and not finished:
            ev = _kill_cells(h["alpha"], switch, thresh)
            upd = {"pruned": ev.pruned, "switch": ev.new_switch,
                   "alpha": ev.new_alpha, "finished": ev.converged}
            suffix = f": killed {ev.killed} cells"
        elif m.kind != "patch" and m.space.searchable and not finished:
            fn = _compress_attn if m.kind == "attn" else _compress_dim
            upd = fn(h["alpha"], switch, h["score"], h["hard"], h["w_p"],
                     thresh, m.space)
            suffix = ": prune event"
        if upd["pruned"]:
            report.execute_prune = True
            report.events.append(
                m.label + suffix
                + (" (converged)" if upd["finished"] else ""))
            switch, finished = upd["switch"], bool(upd["finished"])
            _put(m.alpha, upd["alpha"])
            _put(am.switch, switch)
            zero_names.append("alphas." + m.stem)
            if m.kind == "patch":
                _put(am.pruned_once, True)
            if "hard" in upd:
                _put(am.hard_mask, upd["hard"])
                if m.kind == "attn":
                    _put(am.scale, upd["scale"])
                    _put(am.head_alive, upd["head_alive"])
            if "score" in upd:
                _put(m.score, upd["score"])
                zero_names.append(m.score_name)
        # a module whose switch has a single active cell is finished even
        # without a fresh prune event (see `_finish_singletons`)
        if not finished and int(switch.sum()) == 1:
            finished = True
        if finished != h["finished"]:
            _put(am.finished, finished)
        all_finished = all_finished and finished
    report.finish_search = all_finished

    if zero_names and opt_state is not None:
        hit = set(zero_names)
        zero_adam_moments(opt_state, lambda name: name in hit)
    return params, alphas, arch, opt_state, report


def _arch_modules(arch: ArchState, stage_embeds: bool = True):
    yield arch.embed
    for b in arch.blocks:
        yield b.attn
        yield b.mlp
    yield arch.patch
    if stage_embeds:
        yield from arch.stage_embeds


def _finish_singletons(arch: ArchState, space: SearchSpace) -> ArchState:
    """Modules whose switch has a single active cell are finished even
    without a fresh prune event. (Convergence *with* the score transform
    only happens through a prune event; a module born with one cell uses
    its identity score.) In place; returns `arch`."""
    mods = list(_arch_modules(arch))
    host = fetch_host([t for m in mods for t in (m.switch, m.finished)])
    for m, sw, fin in zip(mods, host[0::2], host[1::2]):
        if not bool(fin) and int(sw.sum()) == 1:
            _put(m.finished, True)
    return arch


def decompress(arch: ArchState) -> ArchState:
    """Re-open the search: clear `finished` on every module whose switch
    still has several options. Hard masks are not restored. In place;
    returns `arch`."""
    mods = list(_arch_modules(arch, stage_embeds=False))
    for m, sw in zip(mods, fetch_host([m.switch for m in mods])):
        if int(sw.sum()) > 1:
            _put(m.finished, False)
    return arch


def _set_w_p(arch: ArchState, val: float) -> ArchState:
    """w_p := val on every unfinished module, a few device ops and no host
    read (this runs every iteration of the loop); finished modules keep
    their last w_p."""
    mods = [m for m in _arch_modules(arch) if hasattr(m, "w_p")]
    w_p = [m.w_p for m in mods]
    new = torch.where(torch.stack([m.finished for m in mods]),
                      torch.stack(w_p), val)
    with torch.no_grad():
        torch._foreach_copy_(w_p, list(new.unbind()))
    return arch


def sync_w_p(arch: ArchState, frac_epoch: float,
             warmup_epochs: float) -> ArchState:
    """Set every unfinished module's w_p to the clamped schedule value
    (`steps.w_p_schedule`). In place; returns `arch`."""
    from .steps import w_p_schedule
    return _set_w_p(arch, w_p_schedule(frac_epoch, warmup_epochs))


def update_w_p(arch: ArchState, frac_epoch: float, warmup_epochs: float,
               w_max: float = 0.99, w_min: float = 0.1) -> ArchState:
    """Anneal w_p of every unfinished module while frac_epoch is within the
    warmup; after it nothing changes. In place; returns `arch`."""
    if frac_epoch > warmup_epochs:
        return arch
    return _set_w_p(arch, w_max + (w_min - w_max)
                    * (frac_epoch / max(warmup_epochs, 1e-8)))
