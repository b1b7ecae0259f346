"""Minimal end-to-end OFB walkthrough with the library API. Port of
examples/minimal_search.py.

Builds a tiny searchable supernet, runs a few search steps with the real
five-family optimizer, fires the compress state machine, force-finishes,
exports the pruned subnet and runs one finetune step — the whole
search -> prune -> export -> finetune lifecycle, in fp32.

Run:  python -m ofb_tpu_torch.examples.minimal_search [--device cpu]
(on the card by default; without one it raises unless --device cpu asks
for the CPU. The JAX example picks the CPU by OFB_EXAMPLE_CPU instead.)
"""

from __future__ import annotations

import argparse

import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..config import OptimFamilyConfig, ScheduleConfig, SearchConfig
    from ..core.compress import compress
    from ..core.export import export_subnet, exported_param_count
    from ..core.lr_decay import build_finetune_optimizer
    from ..core.optim import build_search_optimizer, make_schedule, \
        named_leaves
    from ..core.steps import TrainState, make_search_step, make_train_step
    from ..device import resolve_device
    from ..models.registry import ModelBundle
    from ..models.search_space import SearchSpace
    from ..models.vit import ModelCfg
    from ..ops.flops import model_flops

    dev = resolve_device(args.device)

    # 1) a tiny searchable DeiT-style supernet
    cfg = ModelCfg(img_size=32, patch_size=8, num_classes=10, embed_dim=32,
                   depth=2, num_heads=2, mlp_ratio=2.0)
    space = SearchSpace.build(cfg.embed_dim, cfg.depth, cfg.num_heads,
                              cfg.hidden, cfg.num_patches, patch_search=True)
    bundle = ModelBundle(name="tiny_mim", cfg=cfg, space=space, device=dev,
                         kind="mim")
    params, alphas, arch = bundle.init(0)
    dense_g = float(model_flops(alphas, arch, space, cfg)[0])
    print(f"dense model: {dense_g * 1e3:.3f}e-3 GFLOPs")

    # 2) the search optimizer + search step
    scfg = SearchConfig(accum_iter=1, target_flops=dense_g * 0.6,
                        schedule=ScheduleConfig(warmup_epochs=0),
                        optim_param=OptimFamilyConfig(lr=1e-3),
                        optim_decoder=OptimFamilyConfig(lr=1e-3),
                        optim_arch=OptimFamilyConfig(lr=2e-3,
                                                     betas=(0.5, 0.999))
                        ).resolve(1)
    tx, _ = build_search_optimizer(
        scfg.optim_param, scfg.optim_arch, scfg.optim_decoder, scfg.schedule,
        total_steps=100, steps_per_epoch=10)
    state = TrainState(step=0, params=params, alphas=alphas, arch=arch,
                       opt_state=tx.init(named_leaves(params, alphas)))
    step = make_search_step(space, cfg, scfg, tx, phase="search",
                            compute_dtype=torch.float32, device=dev)

    gen = torch.Generator(device=dev).manual_seed(1)
    imgs = torch.rand((1, 8, 32, 32, 3), generator=gen, device=dev)
    lbls = torch.randint(0, 10, (1, 8), generator=gen, device=dev)
    for _ in range(5):
        state, metrics = step(state, imgs, lbls, gen, 0.85)
    print(f"after 5 search steps: "
          f"loss_total={metrics['loss_total'].item():.3f} "
          f"searched={metrics['searched_gflops'].item() * 1e3:.3f}e-3 G")

    # 3) compress events (here: force-finish like the reference's
    #    compress(1.0) pre-export, finetune.py:199-201), in place
    guard = 0
    while not state.arch.all_finished and guard < 20:
        *_, rep = compress(state.params, state.alphas, state.arch, None,
                           space, thresh=1.0)
        guard += 1
    print("converged; events from last pass:", rep.events[:3], "...")

    # 4) export the physically-small subnet
    dense, dense_cfg, meta = export_subnet(state.params, state.arch, space,
                                           cfg, fuse=True)
    print(f"exported: D={dense_cfg.embed_dim}, "
          f"blocks={dense_cfg.block_overrides}, "
          f"params={exported_param_count(dense) / 1e3:.1f}K")

    # 5) one finetune step on the exported model
    sched = make_schedule(1e-4, ScheduleConfig(warmup_epochs=0), 100, 10)
    ftx = build_finetune_optimizer(dense, lr_schedule=sched,
                                   layer_decay=0.95,
                                   num_layers=dense_cfg.depth)
    fstate = TrainState(step=0, params=dense, alphas=None, arch=None,
                        opt_state=ftx.init(dict(dense.named_parameters())))
    fstep = make_train_step(dense_cfg, ftx, num_classes=10,
                            compute_dtype=torch.float32, device=dev)
    fstate, fm = fstep(fstate, imgs, lbls,
                       torch.Generator(device=dev).manual_seed(2))
    print(f"finetune step on exported model: loss={fm['loss'].item():.3f}")
    print("OK")
    return fm["loss"].item()


if __name__ == "__main__":
    main()
