"""The reference's optimizers: the search's five AdamW families and the
finetune's layer-decay AdamW, with their per-iteration schedules.

A frozen copy of the program's optimizer code (its schedules, family
labels, functional AdamW and layer decay), so that a later change to the
program cannot move the yardstick it is held to. It imports nothing of the
program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Collection, Dict, List, Optional

import torch

from .config import OptimFamilyConfig, ScheduleConfig

Schedule = Callable[[Any], torch.Tensor]


def _f32(count) -> torch.Tensor:
    return torch.as_tensor(count).to(torch.float32)


def _warm(base_lr, sched, warmup_steps, count):
    return sched.warmup_lr + (base_lr - sched.warmup_lr) * (
        count / max(warmup_steps, 1))


def cosine_schedule(base_lr: float, sched: ScheduleConfig, total_steps: int,
                    steps_per_epoch: int) -> Schedule:
    """Linear warmup, then cosine base_lr -> min_lr, then flat."""
    warmup_steps = int(sched.warmup_epochs * steps_per_epoch)
    decay_steps = max(total_steps - warmup_steps, 1)

    def fn(count):
        count = _f32(count)
        t = ((count - warmup_steps) / decay_steps).clamp(0.0, 1.0)
        cos = sched.min_lr + (base_lr - sched.min_lr) * 0.5 * (
            1.0 + torch.cos(math.pi * t))
        return torch.where(count < warmup_steps,
                           _warm(base_lr, sched, warmup_steps, count), cos)

    return fn


NO_DECAY_NAMES = ("pos_embed", "cls_token", "dist_token", "mask_token",
                  "score")
FAMILIES = ("param_nd", "param_d", "dec_nd", "dec_d", "arch")


def make_schedule(base_lr: float, sched: ScheduleConfig, total_steps: int,
                  steps_per_epoch: int) -> Schedule:
    if sched.sched != "cosine":
        raise ValueError(f"the reference has the cosine schedule only, not "
                         f"{sched.sched!r}")
    return cosine_schedule(base_lr, sched, total_steps, steps_per_epoch)


def label_of(name: str, ndim: int) -> str:
    """Family of one weight by the JAX package's name rules."""
    nd = (ndim <= 1 or name.endswith("bias")
          or any(k in name for k in NO_DECAY_NAMES))
    if "decoder" in name:
        return "dec_nd" if nd else "dec_d"
    return "param_nd" if nd else "param_d"


@dataclass
class Family:
    cfg: OptimFamilyConfig
    schedule: Schedule
    weight_decay: float


@dataclass
class AdamWState:
    count: Any            # updates done: a 0-d int64 tensor (an int is taken)
    mu: Dict[str, torch.Tensor] = field(default_factory=dict)
    nu: Dict[str, torch.Tensor] = field(default_factory=dict)


def global_norm(g: List[torch.Tensor],
                sharded: Optional[List[bool]] = None) -> torch.Tensor:
    """optax.global_norm of the logical arrays that `g` holds: where
    `sharded` flags a tensor-parallel shard, its square sum is summed over
    the model group, and each replicated leaf counts once."""
    sharded = sharded or [False] * len(g)

    def sq(xs):
        return sum((x.float().square().sum() for x in xs),
                   torch.zeros((), device=g[0].device))

    return torch.sqrt(sq(g))


def _clip(g: List[torch.Tensor], max_norm: float,
          sharded: Optional[List[bool]] = None) -> List[torch.Tensor]:
    """optax's clip_by_global_norm over the list (of logical arrays, with
    `sharded` as in `global_norm`)."""
    gn = global_norm(g, sharded)
    keep = gn < max_norm
    return [torch.where(keep, x, x / gn * max_norm) for x in g]


def _search_label(name: str, ndim: int) -> str:
    return "arch" if name.startswith("alphas.") else label_of(name, ndim)


class SearchOptimizer:
    """Functional AdamW over named tensors, one hyper-parameter family per
    label. Names are '<params name>' for weights and 'alphas.<name>' for
    architecture parameters (see `named_leaves`). `label_fn(name, ndim)`
    gives a leaf's family; `clip_grad` clips each family by its own norm,
    or with `clip_global` all gradients by one norm; `leaf_scale`
    multiplies a leaf's finished update."""

    def __init__(self, families: Dict[str, Family],
                 clip_grad: Optional[float], accum_iter: int, *,
                 label_fn: Callable[[str, int], str] = _search_label,
                 clip_global: bool = False,
                 leaf_scale: Optional[Dict[str, float]] = None):
        self.families = families
        self.clip_grad = clip_grad
        self.accum_iter = accum_iter
        self.label_fn = label_fn
        self.clip_global = clip_global
        self.leaf_scale = leaf_scale

    def labels(self, leaves: Dict[str, torch.Tensor]) -> Dict[str, str]:
        return {n: self.label_fn(n, t.dim()) for n, t in leaves.items()}

    def init(self, leaves: Dict[str, torch.Tensor]) -> AdamWState:
        dev = next(iter(leaves.values())).device
        return AdamWState(
            count=torch.zeros((), dtype=torch.int64, device=dev),
            mu={n: torch.zeros_like(t, dtype=torch.float32)
                for n, t in leaves.items()},
            nu={n: torch.zeros_like(t, dtype=torch.float32)
                for n, t in leaves.items()})

    def lr(self, family: str, count) -> torch.Tensor:
        return self.families[family].schedule(count * self.accum_iter)

    def update(self, grads: Dict[str, torch.Tensor], state: AdamWState,
               params: Dict[str, torch.Tensor],
               sharded: Collection[str] = ()):
        """(updates, state). The moments and the count advance in place, and
        the count, the learning rates and the bias corrections are device
        tensors computed in fp32 (as optax does): the update reads no host
        number that changes from step to step, so a CUDA graph can replay
        it. `sharded` names the leaves held as tensor-parallel shards, whose
        square sums the clip sums over the model group."""
        dev = next(iter(params.values())).device
        if not isinstance(state.count, torch.Tensor):
            state.count = torch.tensor(int(state.count), dtype=torch.int64,
                                       device=dev)
        t = state.count
        tf = t.to(torch.float32) + 1.0
        if self.clip_grad is not None and self.clip_global:
            grads = dict(zip(grads, _clip(list(grads.values()),
                                          self.clip_grad,
                                          [n in sharded for n in grads])))
        by_family: Dict[str, List[str]] = {f: [] for f in self.families}
        for n, lab in self.labels(params).items():
            by_family[lab].append(n)
        lrs: Dict[int, torch.Tensor] = {}       # one value per schedule
        updates: Dict[str, torch.Tensor] = {}
        for fam_name, names in by_family.items():
            if not names:
                continue
            fam = self.families[fam_name]
            b1, b2 = fam.cfg.betas
            g = [grads[n] for n in names]
            if self.clip_grad is not None and not self.clip_global:
                g = _clip(g, self.clip_grad, [n in sharded for n in names])
            mu = [state.mu[n] for n in names]
            nu = [state.nu[n] for n in names]
            torch._foreach_lerp_(mu, g, 1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
            c1 = 1.0 - torch.pow(b1, tf)
            c2 = 1.0 - torch.pow(b2, tf)
            denom = torch._foreach_div(nu, c2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, fam.cfg.eps)
            u = torch._foreach_div(mu, c1)
            torch._foreach_div_(u, denom)
            if fam.weight_decay:
                torch._foreach_add_(u, [params[n] for n in names],
                                    alpha=fam.weight_decay)
            key = id(fam.schedule)
            if key not in lrs:
                lrs[key] = -torch.as_tensor(self.lr(fam_name, t),
                                            dtype=torch.float32, device=dev)
            torch._foreach_mul_(u, lrs[key])
            if self.leaf_scale is not None:
                torch._foreach_mul_(u, [self.leaf_scale[n] for n in names])
            updates.update(zip(names, u))
        t.add_(1)
        return updates, state


def build_search_optimizer(
    cfg_param: OptimFamilyConfig, cfg_arch: OptimFamilyConfig,
    cfg_dec: OptimFamilyConfig, sched: ScheduleConfig, *,
    total_steps: int, steps_per_epoch: int,
    clip_grad: Optional[float] = None, accum_iter: int = 1,
    sched_arch: Optional[ScheduleConfig] = None,
):
    """The three reference AdamW optimizers as one `SearchOptimizer`.
    Schedules count micro-iterations: each is evaluated at
    count * accum_iter. Returns (optimizer, {family group: schedule})."""
    sch_param = make_schedule(cfg_param.lr, sched, total_steps,
                              steps_per_epoch)
    sch_arch = make_schedule(cfg_arch.lr, sched_arch or sched, total_steps,
                             steps_per_epoch)
    sch_dec = make_schedule(cfg_dec.lr, sched, total_steps, steps_per_epoch)
    tx = SearchOptimizer({
        "param_nd": Family(cfg_param, sch_param, 0.0),
        "param_d": Family(cfg_param, sch_param, cfg_param.weight_decay),
        "dec_nd": Family(cfg_dec, sch_dec, 0.0),
        "dec_d": Family(cfg_dec, sch_dec, cfg_dec.weight_decay),
        "arch": Family(cfg_arch, sch_arch, cfg_arch.weight_decay),
    }, clip_grad, accum_iter)

    def scaled(fn):
        return lambda count: fn(count * accum_iter)

    return tx, {"param": scaled(sch_param), "arch": scaled(sch_arch),
                "decoder": scaled(sch_dec)}


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
