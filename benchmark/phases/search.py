"""The search phase: the OFB supernet's planned search step
(`core.steps.make_planned_search_step`), one call an iteration as
`core.engine.search_one_epoch_planned` calls it, at the cell's place in a
search of `epochs` epochs over `dataset_images` images.

Its state is built from the benchmark's files and seed: the supernet's
sizes and search space by the model's registry name, checked against the
configuration file; the benchmark's weights; the five-family AdamW of the
search CLI at its learning rates for the cell's batch; the optimizer's count
and the step counter at the cell's epoch. bf16 compute, as the CLI's.
"""

from __future__ import annotations

import torch

from .. import inputs
from ..program import Geometry, Program
from ..reference.steps import beta1_of

SIZE_KEYS = ("img_size", "patch_size", "num_classes", "embed_dim", "depth",
             "num_heads", "mlp_ratio", "qkv_bias", "drop_path_rate",
             "ln_eps")


def build(cfg: dict, wl: dict, seed: int, dev, rank: int, *,
          compute_dtype=torch.bfloat16) -> Program:
    from ofb_tpu_torch.config import SearchConfig
    from ofb_tpu_torch.core.optim import (build_search_optimizer,
                                          named_leaves, set_count)
    from ofb_tpu_torch.core.steps import TrainState, make_planned_search_step
    from ofb_tpu_torch.models.mim_vit import Alphas, MimViT
    from ofb_tpu_torch.models.registry import create_model
    from ofb_tpu_torch.models.search_space import ArchState

    s = cfg["search"]
    bundle = create_model(cfg["model"], device=dev,
                          num_classes=cfg["num_classes"],
                          img_size=cfg["img_size"], attn_search=s["attn"],
                          mlp_search=s["mlp"], embed_search=s["embed"],
                          patch_search=s["patch"],
                          drop_path_rate=cfg["drop_path_rate"])
    mcfg, space = bundle.cfg, bundle.space
    for k in SIZE_KEYS:
        if getattr(mcfg, k) != cfg[k]:
            raise ValueError(f"{cfg['model']}: {k} is {getattr(mcfg, k)} in "
                             f"the program, {cfg[k]} in the configuration")
    geo = Geometry.of(wl)
    params = MimViT(mcfg, space, bundle.mae, device="meta").to_empty(
        device=dev)
    alphas = Alphas(space, device="meta").to_empty(device=dev)
    leaves = named_leaves(params, alphas)
    inputs.fill_weights(leaves, seed)
    arch = ArchState.create(space, dev)
    scfg = SearchConfig(accum_iter=geo.A,
                        target_flops=wl["recipe"]["target_flops"])
    scfg.data.batch_size = geo.mb
    scfg = scfg.resolve(geo.world)
    tx, _ = build_search_optimizer(
        scfg.optim_param, scfg.optim_arch, scfg.optim_decoder,
        scfg.schedule, total_steps=geo.epochs * geo.spe * geo.A,
        steps_per_epoch=geo.spe * geo.A, clip_grad=scfg.clip_grad,
        accum_iter=geo.A)
    state = TrainState(step=geo.epoch * geo.spe * geo.A, params=params,
                       alphas=alphas, arch=arch,
                       opt_state=tx.init(leaves))
    set_count(state.opt_state, geo.epoch * geo.spe)
    pstep, keys = make_planned_search_step(
        space, mcfg, scfg, tx, phase="search", steps_per_epoch=geo.spe,
        compute_dtype=compute_dtype, device=dev)
    return Program(pstep, state, geo, cfg, wl, seed, dev, rank, search=True,
                   loss_index=list(keys).index("loss_total"),
                   beta1=lambda n: beta1_of("search", n), leaves=leaves)
