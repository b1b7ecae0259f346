"""The system under test, as a phase module builds it: the program's planned
step over the benchmark's device cache and epoch plan, and what the check
reads of its state.

A phase module (`phases/<phase>.py`) builds a `Program`; the harness calls
`call()` once an iteration, as the program's planned epoch loop
(`core/engine.py`) calls its step, and reads the loss it returns, the
trainable leaves and the optimizer's first moments. Nothing here computes
what the program computes: the weights, the images, the plan and the
generator are the benchmark's (`inputs`), handed to the program.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import torch

from . import inputs
from .compare import UPDATES


@dataclass
class Geometry:
    """A cell's batch and its place in the schedule."""
    world: int
    A: int                     # microbatches an update (accumulation)
    mb: int                    # a rank's microbatch
    spe: int                   # updates an epoch of the dataset
    epoch: int
    epochs: int

    @property
    def global_batch(self) -> int:
        return self.mb * self.A * self.world

    @classmethod
    def of(cls, wl: dict) -> "Geometry":
        world, A, mb = wl["chips"], wl["accum_iter"], wl["microbatch"]
        return cls(world=world, A=A, mb=mb,
                   spe=wl["dataset_images"] // (world * A * mb),
                   epoch=wl["epoch"], epochs=wl["epochs"])


class Program:
    """One rank's planned step of a cell, its state and its inputs.

    `pstep` is the program's `PlannedStep`; `state` its `TrainState`;
    `search` says whether the step takes the epoch (the search's does);
    `loss_index` is the loss's place in the step's output; `beta1(name)`
    is b1 of a leaf's AdamW family, by which its first moment after one
    update gives its gradient."""

    def __init__(self, pstep, state, geo: Geometry, cfg: dict, wl: dict,
                 seed: int, dev, rank: int, *, search: bool,
                 loss_index: int, beta1: Callable[[str], float],
                 leaves: Dict[str, torch.Tensor]):
        self.pstep, self.state, self.geo = pstep, state, geo
        self.search, self.loss_index, self.beta1 = search, loss_index, beta1
        self._leaves = leaves
        self.cache = inputs.staging_cache(seed, rank, wl["cache_images"],
                                          wl["staging"], dev)
        idx, labels = inputs.epoch_plan(seed, geo.spe, geo.global_batch,
                                        wl["cache_images"],
                                        cfg["num_classes"], geo.world)
        self.idx = inputs.rank_columns(idx, rank, geo.world)
        self.labels = labels[rank]
        self.gen = inputs.step_generator(seed, dev)
        self.row = 0
        self._load()

    def _load(self):
        self.plan = self.pstep.load_plan(self.idx, self.labels,
                                         self.geo.epoch, self.state.step)
        self.row = 0

    def call(self) -> torch.Tensor:
        """One iteration: one call of the planned step (a CUDA graph
        replay once captured). Returns the step's output. At the end of
        the epoch's plan the plan is loaded again, as the next epoch's
        would be."""
        if self.row == self.geo.spe:
            self._load()
        idx, lab, base, epoch = self.plan
        args = (self.state, self.cache, idx, lab, self.gen, base) \
            + ((epoch,) if self.search else ())
        self.state, out = self.pstep(*args)
        self.row += 1
        return out

    def loss(self, out: torch.Tensor) -> torch.Tensor:
        return out.reshape(-1)[self.loss_index]

    def leaves(self) -> Dict[str, torch.Tensor]:
        """Every tensor the update changes, by the reference's names (the
        finetune's EMA weights as `ema.<name>`)."""
        out = dict(self._leaves)
        if self.state.ema_params is not None:
            out.update({f"ema.{n}": t
                        for n, t in self.state.ema_params.items()})
        return out

    def first_gradient_norms(self) -> Dict[str, float]:
        """Each leaf's gradient norm as the optimizer got it in the first
        update: its first moment over (1 - b1)."""
        mu = self.state.opt_state.mu
        names = list(self._leaves)
        norms = torch.stack([mu[n].float().norm() for n in names]).cpu()
        return {n: float(v) / (1.0 - self.beta1(n))
                for n, v in zip(names, norms)}

    def free(self):
        self.pstep = self.state = self.cache = self._leaves = None
        self.plan = None


def change_norms(leaves: Dict[str, torch.Tensor], seed: int
                 ) -> Dict[str, float]:
    """Each leaf's distance from the benchmark's starting weights (EMA
    weights start at the weights)."""
    base = {n: t for n, t in leaves.items() if not n.startswith("ema.")}
    p0 = {n: torch.empty_like(t) for n, t in base.items()}
    inputs.fill_weights(p0, seed)
    names = list(leaves)
    norms = torch.stack([
        (leaves[n].detach().float()
         - p0[n[4:] if n.startswith("ema.") else n]).norm()
        for n in names]).cpu()
    return {n: float(v) for n, v in zip(names, norms)}


def first_updates(prog: Program, seed: int) -> dict:
    """The program's first `UPDATES` updates through the window's own call
    (the warm-up calls and the graph's capture among them): what the
    comparison reads, as `reference.steps.run` returns it."""
    losses, grads = [], None
    for k in range(UPDATES):
        losses.append(float(prog.loss(prog.call())))
        if k == 0:
            grads = prog.first_gradient_norms()
    return {"loss": losses, "grad": grads,
            "change": change_norms(prog.leaves(), seed)}
