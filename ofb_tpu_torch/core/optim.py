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
the global norm of that family's gradients.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from ..config import OptimFamilyConfig, ScheduleConfig

Schedule = Callable[[int], float]


# ---------------------------------------------------------------------------
# Schedules (timm semantics), functions of the micro-iteration count
# ---------------------------------------------------------------------------

def _warm(base_lr, sched, warmup_steps, count):
    return sched.warmup_lr + (base_lr - sched.warmup_lr) * (
        count / max(warmup_steps, 1))


def cosine_schedule(base_lr: float, sched: ScheduleConfig, total_steps: int,
                    steps_per_epoch: int) -> Schedule:
    """Linear warmup, then cosine base_lr -> min_lr, then flat."""
    warmup_steps = int(sched.warmup_epochs * steps_per_epoch)
    decay_steps = max(total_steps - warmup_steps, 1)

    def fn(count):
        if count < warmup_steps:
            return _warm(base_lr, sched, warmup_steps, count)
        t = min(max((count - warmup_steps) / decay_steps, 0.0), 1.0)
        return sched.min_lr + (base_lr - sched.min_lr) * 0.5 * (
            1.0 + math.cos(math.pi * t))

    return fn


def step_schedule(base_lr: float, sched: ScheduleConfig,
                  steps_per_epoch: int) -> Schedule:
    decay_steps = int(sched.decay_epochs * steps_per_epoch)

    def fn(count):
        return base_lr * sched.decay_rate ** math.floor(
            count / max(decay_steps, 1))

    return fn


def tanh_schedule(base_lr: float, sched: ScheduleConfig, total_steps: int,
                  steps_per_epoch: int, lb: float = -7.0, ub: float = 3.0
                  ) -> Schedule:
    warmup_steps = int(sched.warmup_epochs * steps_per_epoch)
    decay_steps = max(total_steps - warmup_steps, 1)

    def fn(count):
        if count < warmup_steps:
            return _warm(base_lr, sched, warmup_steps, count)
        t = min(max((count - warmup_steps) / decay_steps, 0.0), 1.0)
        return sched.min_lr + (base_lr - sched.min_lr) * 0.5 * (
            1.0 - math.tanh(lb + (ub - lb) * t))

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
            if count < warmup_steps:
                return _warm(base_lr, sched, warmup_steps, count)
            return base_lr

        return fn
    raise ValueError(f"unknown scheduler '{sched.sched}' "
                     "(cosine | tanh | step | plateau | constant)")


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
    count: int                                   # updates done
    mu: Dict[str, torch.Tensor] = field(default_factory=dict)
    nu: Dict[str, torch.Tensor] = field(default_factory=dict)


class SearchOptimizer:
    """Functional AdamW over named tensors, one hyper-parameter family per
    label. Names are '<params name>' for weights and 'alphas.<name>' for
    architecture parameters (see `named_leaves`)."""

    def __init__(self, families: Dict[str, Family],
                 clip_grad: Optional[float], accum_iter: int):
        self.families = families
        self.clip_grad = clip_grad
        self.accum_iter = accum_iter

    def labels(self, leaves: Dict[str, torch.Tensor]) -> Dict[str, str]:
        return {n: ("arch" if n.startswith("alphas.")
                    else label_of(n, t.dim())) for n, t in leaves.items()}

    def init(self, leaves: Dict[str, torch.Tensor]) -> AdamWState:
        return AdamWState(
            count=0,
            mu={n: torch.zeros_like(t, dtype=torch.float32)
                for n, t in leaves.items()},
            nu={n: torch.zeros_like(t, dtype=torch.float32)
                for n, t in leaves.items()})

    def lr(self, family: str, count: int) -> float:
        return self.families[family].schedule(count * self.accum_iter)

    def update(self, grads: Dict[str, torch.Tensor], state: AdamWState,
               params: Dict[str, torch.Tensor]):
        """(updates, new state); the moments are advanced in place."""
        t = state.count
        by_family: Dict[str, List[str]] = {f: [] for f in self.families}
        for n, lab in self.labels(params).items():
            by_family[lab].append(n)
        updates: Dict[str, torch.Tensor] = {}
        for fam_name, names in by_family.items():
            if not names:
                continue
            fam = self.families[fam_name]
            b1, b2 = fam.cfg.betas
            g = [grads[n] for n in names]
            if self.clip_grad is not None:
                gn = torch.sqrt(sum((x.float().square().sum() for x in g)))
                keep = gn < self.clip_grad
                g = [torch.where(keep, x, x / gn * self.clip_grad) for x in g]
            mu = [state.mu[n] for n in names]
            nu = [state.nu[n] for n in names]
            torch._foreach_lerp_(mu, g, 1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
            c1 = 1.0 - b1 ** (t + 1)
            c2 = 1.0 - b2 ** (t + 1)
            denom = torch._foreach_div(nu, c2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, fam.cfg.eps)
            u = torch._foreach_div(mu, c1)
            torch._foreach_div_(u, denom)
            if fam.weight_decay:
                torch._foreach_add_(u, [params[n] for n in names],
                                    alpha=fam.weight_decay)
            torch._foreach_mul_(u, -self.lr(fam_name, t))
            updates.update(zip(names, u))
        return updates, AdamWState(count=t + 1, mu=state.mu, nu=state.nu)


def named_leaves(params: torch.nn.Module, alphas: torch.nn.Module
                 ) -> Dict[str, torch.Tensor]:
    """Every trainable tensor of the search, by name: weights under their
    module names, architecture parameters under 'alphas.<name>'."""
    out = dict(params.named_parameters())
    out.update({f"alphas.{n}": p for n, p in alphas.named_parameters()})
    return out


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
