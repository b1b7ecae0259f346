"""The finetune phase: an exported subnet's planned train step
(`core.steps.make_planned_train_step`), one call an iteration as the
finetune CLI's planned epoch calls it, at the cell's place in a finetune of
`epochs` epochs over `dataset_images` images.

Its state is built from the benchmark's files and seed: the dense ViT of
the configuration's sizes (its `block_overrides` as the export wrote them);
the benchmark's weights; `FinetuneConfig`'s defaults (layer decay 0.95,
weight decay 0.05, Mixup 0.8 / CutMix 1.0 with label smoothing, EMA) at the
learning rate for the cell's batch; the optimizer's count and the step
counter at the cell's epoch. bf16 compute, as the CLI's.
"""

from __future__ import annotations

import torch

from .. import inputs
from ..program import Geometry, Program
from ..reference.steps import beta1_of

CFG_KEYS = ("img_size", "patch_size", "in_chans", "num_classes", "embed_dim",
            "depth", "num_heads", "head_dim", "mlp_hidden", "mlp_ratio",
            "qkv_bias", "drop_path_rate", "ln_eps")


def build(cfg: dict, wl: dict, seed: int, dev, rank: int, *,
          compute_dtype=torch.bfloat16) -> Program:
    from ofb_tpu_torch.config import FinetuneConfig
    from ofb_tpu_torch.core.lr_decay import build_finetune_optimizer
    from ofb_tpu_torch.core.optim import make_schedule, set_count
    from ofb_tpu_torch.core.steps import TrainState, make_planned_train_step
    from ofb_tpu_torch.models.vit import ModelCfg, ViT

    over = cfg.get("block_overrides")
    mcfg = ModelCfg(**{k: cfg[k] for k in CFG_KEYS},
                    block_overrides=tuple(tuple(b) for b in over)
                    if over else None)
    geo = Geometry.of(wl)
    params = ViT(mcfg, device="meta").to_empty(device=dev)
    leaves = dict(params.named_parameters())
    inputs.fill_weights(leaves, seed)
    fcfg = FinetuneConfig()
    fcfg.data.batch_size = geo.mb
    fcfg.accum_iter = geo.A
    fcfg = fcfg.resolve(geo.world)
    A = geo.A
    schedule = make_schedule(fcfg.lr, fcfg.schedule, geo.epochs * geo.spe * A,
                             geo.spe * A)
    tx = build_finetune_optimizer(
        params, lr_schedule=lambda c: schedule(c * A), betas=fcfg.betas,
        eps=fcfg.eps, weight_decay=fcfg.weight_decay,
        layer_decay=fcfg.layer_decay, num_layers=mcfg.depth,
        clip_grad=fcfg.clip_grad)
    state = TrainState(step=geo.epoch * geo.spe * A, params=params,
                       alphas=None, arch=None, opt_state=tx.init(leaves),
                       ema_params={n: p.detach().clone()
                                   for n, p in leaves.items()})
    set_count(state.opt_state, geo.epoch * geo.spe)
    pstep = make_planned_train_step(
        mcfg, tx, num_classes=mcfg.num_classes, accum_iter=A,
        mixup_cfg=fcfg.mixup, smoothing=fcfg.mixup.label_smoothing,
        ema_decay=fcfg.model_ema_decay, compute_dtype=compute_dtype,
        device=dev)
    return Program(pstep, state, geo, cfg, wl, seed, dev, rank, search=False,
                   loss_index=0, beta1=lambda n: beta1_of("finetune", n),
                   leaves=leaves)
