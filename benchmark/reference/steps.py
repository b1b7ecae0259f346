"""The plain reference's training steps, common part: the cell's inputs, its
schedules, the readings; `run` takes a phase's reference steps from
`reference/<phase>.py` by name (`search`, `finetune`), in fp32 with TF32 off
or, for the control, with float8 products.

A frozen copy of the program's step logic (the planned wrapper's schedules,
the gather from the cache, the fused augment, the losses, the accumulation
and the optimizer update), so that a later change to the program cannot
move the yardstick. A data-parallel step is taken as its ranks take it: the
global batch's rows rank by rank, each rank's draws taken from the global
draw of a generator in the same state, the gradients and metrics averaged
over the ranks. It imports nothing of the program.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

import torch

from .. import inputs
from . import model as M
from . import numerics as num
from .augment import apply_train_augment, draw_train_augment
from .space import ArchState, SearchSpace


def anneal(frac, warmup_epochs: float, start: float, end: float):
    f = torch.as_tensor(frac).to(torch.float32)
    t = (f / max(float(warmup_epochs), 1e-8)).clamp_max(1.0)
    return torch.addcmul(torch.full_like(t, start), t,
                         torch.full_like(t, end - start))


def sync_w_p(arch: ArchState, val) -> None:
    mods = [arch.embed] + [m for b in arch.blocks for m in (b.attn, b.mlp)]
    with torch.no_grad():
        for m in mods:
            m.w_p.copy_(torch.where(m.finished, m.w_p, val))


def model_cfg(cfg: dict) -> M.ModelCfg:
    over = cfg.get("block_overrides")
    return M.ModelCfg(
        img_size=cfg["img_size"], patch_size=cfg["patch_size"],
        in_chans=cfg.get("in_chans", 3), num_classes=cfg["num_classes"],
        embed_dim=cfg["embed_dim"], depth=cfg["depth"],
        num_heads=cfg["num_heads"], head_dim=cfg.get("head_dim"),
        mlp_hidden=cfg.get("mlp_hidden"), mlp_ratio=cfg["mlp_ratio"],
        qkv_bias=cfg["qkv_bias"], drop_path_rate=cfg["drop_path_rate"],
        ln_eps=cfg["ln_eps"],
        block_overrides=tuple(tuple(b) for b in over) if over else None)


def search_space(cfg: dict, mcfg: M.ModelCfg) -> SearchSpace:
    s = cfg["search"]
    return SearchSpace.build(
        mcfg.embed_dim, mcfg.depth, mcfg.num_heads, mcfg.hidden,
        mcfg.num_patches, attn_search=s["attn"], mlp_search=s["mlp"],
        embed_search=s["embed"], patch_search=s["patch"])


class CellInputs:
    """The cell's batch geometry, position in the schedule and inputs."""

    def __init__(self, cfg: dict, wl: dict, seed: int, device):
        self.seed, self.device = seed, device
        self.world = wl["chips"]
        self.A = wl["accum_iter"]
        self.mb = wl["microbatch"]                  # a rank's microbatch
        self.global_batch = self.mb * self.A * self.world
        self.spe = wl["dataset_images"] // self.global_batch
        self.epoch = wl["epoch"]
        self.epochs = wl["epochs"]
        self.classes = cfg["num_classes"]
        self.idx, self.labels = inputs.epoch_plan(
            seed, self.spe, self.global_batch, wl["cache_images"],
            self.classes, self.world)
        self.caches = [inputs.staging_cache(seed, r, wl["cache_images"],
                                            wl["staging"], device)
                       for r in range(self.world)]
        self.gen = inputs.step_generator(seed, device)

    def microbatch(self, it: int, a: int):
        """(uint8 images, labels) of microbatch `a` of plan row `it`, the
        global microbatch: rank 0's rows, then rank 1's, ..."""
        imgs, lbls = [], []
        for r in range(self.world):
            cols = inputs.rank_columns(self.idx, r, self.world)[it]
            cols = cols[a * self.mb:(a + 1) * self.mb]
            sel = torch.as_tensor(cols, device=self.device)
            imgs.append(self.caches[r].index_select(0, sel))
            lbls.append(torch.as_tensor(self.labels[r][cols],
                                        device=self.device))
        return torch.cat(imgs), torch.cat(lbls)

    def augment(self, images_u8, out_size: int):
        d = draw_train_augment(self.gen, images_u8.shape[0],
                               images_u8.shape[1], out_size,
                               device=self.device)
        return apply_train_augment(images_u8, d, out_size=out_size)


def leaf_norms(ts: List[torch.Tensor]) -> List[float]:
    return [float(x) for x in torch.stack(
        [t.detach().float().norm() for t in ts]).cpu()]


def finished_alphas(arch: ArchState):
    """(alpha leaf, finished flag): a converged module's alpha gets no
    update."""
    yield "alphas.patch", arch.patch.finished
    yield "alphas.embed", arch.embed.finished
    for i, b in enumerate(arch.blocks):
        yield f"alphas.blocks.{i}.attn", b.attn.finished
        yield f"alphas.blocks.{i}.mlp", b.mlp.finished


def grad_from_moments(tx, opt_state, leaves) -> Dict[str, float]:
    labels = tx.labels(leaves)
    names = list(leaves)
    norms = leaf_norms([opt_state.mu[n] for n in names])
    return {n: v / (1.0 - tx.families[labels[n]].cfg.betas[0])
            for n, v in zip(names, norms)}


def run(phase: str, cfg: dict, wl: dict, seed: int, device, *,
        control: bool = False) -> dict:
    """The reference's readings of the cell's first `UPDATES` updates: each
    update's loss, each leaf's first gradient norm as the optimizer got it,
    each leaf's change after the last; with `control`, every matrix
    product in float8 (the control)."""
    mod = importlib.import_module(f"{__package__}.{phase}")
    with num.fp32_only():
        if control:
            with num.fp8():
                return mod.run(cfg, wl, seed, device)
        return mod.run(cfg, wl, seed, device)


def beta1_of(phase: str, name: str) -> float:
    """b1 of a leaf's AdamW family in `phase`."""
    return importlib.import_module(f"{__package__}.{phase}").beta1(name)
