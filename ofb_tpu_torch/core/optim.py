"""The search optimizer: five AdamW families with per-iteration schedules.

Port of ofb_tpu/core/optim.py. The JAX package runs one
`optax.multi_transform` over (params, alphas) with five labels:

    param_nd   1-D tensors / biases / skip-list names, wd = 0
    param_d    other weights, wd = weight_decay
    dec_nd     decoder family, no decay
    dec_d      decoder family, decayed
    arch       every alpha, AdamW(betas=(0.5, 0.999), wd=1e-3)

Here it is one functional AdamW with optax's semantics, not
`torch.optim.AdamW`: `update(grads, state, params)` returns the updates
and advances the state, and the caller may still mask the updates (the
step freezes finished alphas after Adam has moved every moment, as the
JAX step does). Per leaf, with t the update count before this one:

    m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g²
    u = -lr(t * accum_iter) * (m / (1 - b1^(t+1)) / (sqrt(v / (1 - b2^(t+1))) + eps) + wd * p)

Each family has its own schedule and, with `clip_grad`, its own clip by
the global norm of that family's gradients. The finetune optimizer
(core/lr_decay.py) is the same class with two families, one clip over all
gradients and a per-leaf scale of the update.

Beside it: `PlateauTracker` with `with_lr_scale` / `set_lr_scale` (a
host-set factor on every update), `make_trainable_mask` (static 0/1 update
masks), `zero_adam_moments` (the moment reset of a prune event), `adamw`
(optax.adamw: one family) and `sgd` (optax.sgd without momentum).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Any, Callable, Collection, Dict, List, Optional, Tuple

import torch

from ..config import OptimFamilyConfig, ScheduleConfig
from ..parallel.tensor_parallel import model_sum

Schedule = Callable[[Any], torch.Tensor]


# ---------------------------------------------------------------------------
# Schedules (timm semantics), functions of the micro-iteration count: an int
# or a device tensor, evaluated in fp32 like optax's schedules; the result is
# a 0-d fp32 tensor on the count's device (float() of it on the host)
# ---------------------------------------------------------------------------

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


def step_schedule(base_lr: float, sched: ScheduleConfig,
                  steps_per_epoch: int) -> Schedule:
    decay_steps = int(sched.decay_epochs * steps_per_epoch)

    def fn(count):
        k = torch.floor(_f32(count) / max(decay_steps, 1))
        return base_lr * torch.pow(sched.decay_rate, k)

    return fn


def tanh_schedule(base_lr: float, sched: ScheduleConfig, total_steps: int,
                  steps_per_epoch: int, lb: float = -7.0, ub: float = 3.0
                  ) -> Schedule:
    warmup_steps = int(sched.warmup_epochs * steps_per_epoch)
    decay_steps = max(total_steps - warmup_steps, 1)

    def fn(count):
        count = _f32(count)
        t = ((count - warmup_steps) / decay_steps).clamp(0.0, 1.0)
        tanh_lr = sched.min_lr + (base_lr - sched.min_lr) * 0.5 * (
            1.0 - torch.tanh(lb + (ub - lb) * t))
        return torch.where(count < warmup_steps,
                           _warm(base_lr, sched, warmup_steps, count),
                           tanh_lr)

    return fn


def make_schedule(base_lr: float, sched: ScheduleConfig, total_steps: int,
                  steps_per_epoch: int) -> Schedule:
    if sched.sched == "cosine":
        return cosine_schedule(base_lr, sched, total_steps, steps_per_epoch)
    if sched.sched == "tanh":
        return tanh_schedule(base_lr, sched, total_steps, steps_per_epoch)
    if sched.sched == "step":
        return step_schedule(base_lr, sched, steps_per_epoch)
    if sched.sched in ("plateau", "constant"):
        warmup_steps = int(sched.warmup_epochs * steps_per_epoch)

        def fn(count):
            count = _f32(count)
            return torch.where(count < warmup_steps,
                               _warm(base_lr, sched, warmup_steps, count),
                               torch.full_like(count, base_lr))

        return fn
    raise ValueError(f"unknown scheduler '{sched.sched}' "
                     "(cosine | tanh | step | plateau | constant)")


class PlateauTracker:
    """Host-side plateau control of the learning rate: the scale is
    multiplied by decay_rate after `patience` epochs without a better
    metric. The scale reaches the step through `set_lr_scale`."""

    def __init__(self, patience: int = 10, decay_rate: float = 0.1,
                 mode: str = "max", min_scale: float = 1e-3):
        self.patience = patience
        self.decay_rate = decay_rate
        self.mode = mode
        self.best = None
        self.bad_epochs = 0
        self.scale = 1.0
        self.min_scale = min_scale

    def update(self, metric: float) -> float:
        better = (self.best is None
                  or (metric > self.best if self.mode == "max"
                      else metric < self.best))
        if better:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale = max(self.scale * self.decay_rate,
                                 self.min_scale)
                self.bad_epochs = 0
        return self.scale


# ---------------------------------------------------------------------------
# Labels
# ---------------------------------------------------------------------------

NO_DECAY_NAMES = ("pos_embed", "cls_token", "dist_token", "mask_token",
                  "score")
FAMILIES = ("param_nd", "param_d", "dec_nd", "dec_d", "arch")


def label_of(name: str, ndim: int) -> str:
    """Family of one weight by the JAX package's name rules."""
    nd = (ndim <= 1 or name.endswith("bias")
          or any(k in name for k in NO_DECAY_NAMES))
    if "decoder" in name:
        return "dec_nd" if nd else "dec_d"
    return "param_nd" if nd else "param_d"


def label_params(params: torch.nn.Module) -> Dict[str, str]:
    return {n: label_of(n, p.dim()) for n, p in params.named_parameters()}


def label_alphas(alphas: torch.nn.Module) -> Dict[str, str]:
    return {n: "arch" for n, _ in alphas.named_parameters()}


# ---------------------------------------------------------------------------
# The optimizer
# ---------------------------------------------------------------------------

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


def set_count(adam: AdamWState, value: int) -> None:
    """Write the update count, in place when it is already a tensor (a
    captured step reads that tensor)."""
    if isinstance(adam.count, torch.Tensor):
        adam.count.fill_(int(value))
    else:
        adam.count = int(value)


def global_norm(g: List[torch.Tensor],
                sharded: Optional[List[bool]] = None) -> torch.Tensor:
    """optax.global_norm of the logical arrays that `g` holds: where
    `sharded` flags a tensor-parallel shard, its square sum is summed over
    the model group, and each replicated leaf counts once."""
    sharded = sharded or [False] * len(g)

    def sq(xs):
        return sum((x.float().square().sum() for x in xs),
                   torch.zeros((), device=g[0].device))

    total = sq([x for x, s in zip(g, sharded) if not s])
    if any(sharded):
        total = total + model_sum(sq([x for x, s in zip(g, sharded) if s]))
    return torch.sqrt(total)


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


# ---------------------------------------------------------------------------
# Plateau scale: the tracker lives on the host; its scale is a slot in the
# optimizer state, multiplied onto every update (the same as scaling the
# learning rate, the decoupled weight decay included)
# ---------------------------------------------------------------------------

@dataclass
class LrScaleState:
    scale: torch.Tensor            # f32 scalar, set by the host between epochs
    inner: AdamWState


class _LrScaled:
    def __init__(self, tx: SearchOptimizer):
        self.tx = tx

    def __getattr__(self, name):
        return getattr(self.tx, name)

    def init(self, leaves: Dict[str, torch.Tensor]) -> LrScaleState:
        dev = next(iter(leaves.values())).device
        return LrScaleState(torch.ones((), dtype=torch.float32, device=dev),
                            self.tx.init(leaves))

    def update(self, grads, state: LrScaleState, params, sharded=()):
        updates, _ = self.tx.update(grads, state.inner, params, sharded)
        names = list(updates)
        scaled = torch._foreach_mul([updates[n] for n in names], state.scale)
        return dict(zip(names, scaled)), state


def with_lr_scale(tx: SearchOptimizer) -> _LrScaled:
    """Wrap an optimizer so that its updates are multiplied by a scalar held
    in the optimizer state, a device tensor the host rewrites."""
    return _LrScaled(tx)


def set_lr_scale(opt_state: LrScaleState, scale: float) -> LrScaleState:
    """Write the PlateauTracker's scale into the state, in place (a
    captured step reads the same tensor)."""
    opt_state.scale.fill_(float(scale))
    return opt_state


def named_leaves(params: torch.nn.Module, alphas: torch.nn.Module
                 ) -> Dict[str, torch.Tensor]:
    """Every trainable tensor of the search, by name: weights under their
    module names, architecture parameters under 'alphas.<name>'."""
    out = dict(params.named_parameters())
    out.update({f"alphas.{n}": p for n, p in alphas.named_parameters()})
    return out


def make_trainable_mask(params: torch.nn.Module, alphas: torch.nn.Module, *,
                        freeze_weights: bool,
                        searchable_score_paths: Optional[set] = None,
                        w_head: float = 0.5, w_mlp: float = 0.5,
                        w_patch: float = 0.0, w_embedding: float = 0.5
                        ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """Static 0/1 update masks, (param_mask, alpha_mask), by leaf name as in
    `named_leaves`:

    * scores outside `searchable_score_paths` (when given) are frozen;
    * `freeze_weights` keeps only alpha / score / norm / token / decoder /
      mask / head leaves trainable;
    * a zero loss weight freezes that dimension's alphas.
    """
    def pmask(name):
        if searchable_score_paths is not None and name.endswith("score") \
                and name not in searchable_score_paths:
            return 0.0
        if freeze_weights:
            keep = any(k in name for k in ("alpha", "score", "norm", "token",
                                           "decoder", "mask", "head"))
            return 1.0 if keep else 0.0
        return 1.0

    def amask(name):
        if "patch" in name and w_patch == 0:
            return 0.0
        if "embed" in name and w_embedding == 0:
            return 0.0
        if "attn" in name and w_head == 0:
            return 0.0
        if "mlp" in name and w_mlp == 0:
            return 0.0
        return 1.0

    return ({n: pmask(n) for n, _ in params.named_parameters()},
            {f"alphas.{n}": amask(n) for n, _ in alphas.named_parameters()})


def zero_adam_moments(opt_state: Any, predicate: Callable[[str], bool]):
    """Zero mu and nu, in place, of the leaves whose name (as in
    `named_leaves`) matches `predicate`; the count of updates stays. Takes
    an `AdamWState` or an `LrScaleState` around one."""
    adam = opt_state.inner if isinstance(opt_state, LrScaleState) \
        else opt_state
    hit = [m[n] for n in adam.mu if predicate(n) for m in (adam.mu, adam.nu)]
    if hit:
        torch._foreach_zero_(hit)
    return opt_state


def adamw(schedule: Schedule, *, weight_decay: float,
          betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8
          ) -> SearchOptimizer:
    """optax.adamw: one family over every leaf, decayed alike, no clip."""
    fam = OptimFamilyConfig(betas=betas, eps=eps, weight_decay=weight_decay)
    return SearchOptimizer({"all": Family(fam, schedule, weight_decay)},
                           None, 1, label_fn=lambda name, ndim: "all")


@dataclass
class SGDState:
    count: Any            # updates done: a 0-d int64 tensor (an int is taken)


def sgd(learning_rate):
    """optax.sgd without momentum: u = -lr(t) * g, with t the update count
    before this one; a float `learning_rate` is a constant schedule.
    Returns the `init` / `update` interface of `SearchOptimizer`."""

    def init(leaves: Dict[str, torch.Tensor]) -> SGDState:
        dev = next(iter(leaves.values())).device
        return SGDState(torch.zeros((), dtype=torch.int64, device=dev))

    def update(grads: Dict[str, torch.Tensor], state: SGDState,
               params: Dict[str, torch.Tensor], sharded: Collection[str] = ()):
        lr = learning_rate
        if callable(lr):
            lr = torch.as_tensor(lr(state.count), dtype=torch.float32,
                                 device=state.count.device)
        names = list(grads)
        u = torch._foreach_mul([grads[n] for n in names], -lr)
        state.count.add_(1)
        return dict(zip(names, u)), state

    return SimpleNamespace(init=init, update=update)


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
