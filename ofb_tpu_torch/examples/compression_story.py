"""End-to-end OFB compression story: search a supernet to high accuracy on
an 8-class synthetic task (quadrant x dominant channel), with the compress
state machine pruning organically during training; force-finish and
export the physically small subnet; measure accuracy through hard pruning
and a short finetune. Port of examples/compression_story.py: the same
configs, seeds (as torch generators), sequence and printed lines.

The exported blocks have heterogeneous per-block dims, e.g. ((2, 24, 64),
(2, 20, 112), (2, 24, 112)): heads, head dim, MLP width. Head dims that
are not a multiple of 8 run, in bf16, through the unaligned attention body.

Run:  python -m ofb_tpu_torch.examples.compression_story [--steps 1500]
          [--finetune-steps 600] [--device cpu]
(on the card by default; without one it raises unless --device cpu asks
for the CPU. The JAX example picks the CPU by OFB_STORY_CPU=1 instead.)
"""

from __future__ import annotations

import argparse
import time

import torch
import torch.nn.functional as F

CFG = dict(img_size=32, patch_size=8, num_classes=8, embed_dim=64, depth=3,
           num_heads=2, mlp_ratio=2.0)


def make_batch_from(noise: torch.Tensor, lbl: torch.Tensor):
    """(images, labels) of the task from uniform noise (n, 32, 32, 3) in
    [0, 1) and labels (n,) in [0, 8): label = quadrant(4) x dominant
    channel(2); the label's quadrant gets +0.5 on channel 0 or 2 over the
    noise scaled to [0, 0.3)."""
    imgs = noise * 0.3
    q, ch = lbl // 2, (lbl % 2) * 2      # channel 0 or 2
    yy = torch.arange(32, device=noise.device)[None, :, None]
    xx = torch.arange(32, device=noise.device)[None, None, :]
    mask = (((yy // 16) == (q // 2)[:, None, None])
            & ((xx // 16) == (q % 2)[:, None, None]))
    bump = 0.5 * F.one_hot(ch, 3).to(imgs.dtype)[:, None, None, :]
    imgs = torch.where(mask[..., None], imgs + bump, imgs)
    return imgs.float(), lbl


def make_batch(generator, n: int, device):
    noise = torch.rand((n, 32, 32, 3), generator=generator, device=device)
    lbl = torch.randint(0, 8, (n,), generator=generator, device=device)
    return make_batch_from(noise, lbl)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--finetune-steps", type=int, default=600)
    ap.add_argument("--device", default="cuda")
    cli = ap.parse_args(argv)

    from ..config import OptimFamilyConfig, ScheduleConfig, SearchConfig
    from ..core.compress import compress, update_w_p
    from ..core.export import export_subnet, exported_param_count
    from ..core.lr_decay import build_finetune_optimizer
    from ..core.optim import build_search_optimizer, make_schedule, \
        named_leaves
    from ..core.steps import (TrainState, make_eval_step,
                              make_eval_step_dense, make_search_step,
                              make_train_step)
    from ..device import resolve_device
    from ..models.registry import ModelBundle
    from ..models.search_space import SearchSpace
    from ..models.vit import ModelCfg
    from ..ops.flops import model_flops

    dev = resolve_device(cli.device)
    cfg = ModelCfg(**CFG)
    space = SearchSpace.build(cfg.embed_dim, cfg.depth, cfg.num_heads,
                              cfg.hidden, cfg.num_patches, patch_search=True)
    bundle = ModelBundle(name="t", cfg=cfg, space=space, device=dev,
                         kind="mim")
    params, alphas, arch = bundle.init(0)
    dense_g = float(model_flops(alphas, arch, space, cfg)[0])

    scfg = SearchConfig(accum_iter=1, target_flops=dense_g * 0.55,
                        w_flops=5.0,
                        schedule=ScheduleConfig(warmup_epochs=3),
                        optim_param=OptimFamilyConfig(lr=1e-3),
                        optim_decoder=OptimFamilyConfig(lr=1e-3),
                        optim_arch=OptimFamilyConfig(lr=4e-3,
                                                     betas=(0.5, 0.999))
                        ).resolve(1)
    STEPS = cli.steps
    tx, _ = build_search_optimizer(scfg.optim_param, scfg.optim_arch,
                                   scfg.optim_decoder, scfg.schedule,
                                   total_steps=STEPS, steps_per_epoch=100)
    state = TrainState(step=0, params=params, alphas=alphas, arch=arch,
                       opt_state=tx.init(named_leaves(params, alphas)))
    step = make_search_step(space, cfg, scfg, tx, phase="search",
                            compute_dtype=torch.bfloat16, device=dev)
    ev = make_eval_step(space, cfg, compute_dtype=torch.bfloat16, device=dev)
    VI, VL = make_batch(torch.Generator(device=dev).manual_seed(999), 1024,
                        dev)

    def sup_acc(st):
        m = ev(st.params, st.alphas, st.arch, VI, VL)
        return 100.0 * m["top1"].item() / 1024

    gen = torch.Generator(device=dev).manual_seed(7)
    t0 = time.time()
    finish = False
    for it in range(STEPS):
        frac = it / 100.0
        update_w_p(state.arch, frac, 3.0)
        keep = 0.95 - 0.2 * min(frac / 3.0, 1.0)
        imgs, lbl = make_batch(gen, 128, dev)
        state, m = step(state, imgs[None], lbl[None], gen, keep)
        if not finish and (it + 1) % 33 == 0:
            *_, rep = compress(state.params, state.alphas, state.arch,
                               state.opt_state, space, 0.2)
            finish = rep.finish_search
            if rep.events:
                print(f"it {it+1}: {len(rep.events)} prune events "
                      f"({rep.events[0]} ...)", flush=True)
        if (it + 1) % 300 == 0:
            sg = model_flops(state.alphas, state.arch, space, cfg)[1].detach()
            print(f"it {it+1}: supernet acc {sup_acc(state):.1f}% "
                  f"searched {sg.item()/dense_g*100:.0f}% of dense "
                  f"loss {m['loss_param'].item():.3f}", flush=True)

    acc_supernet = sup_acc(state)
    print(f"\nsupernet acc after search: {acc_supernet:.1f}% "
          f"(wall {time.time()-t0:.0f}s)", flush=True)

    # force-finish + export
    p, a, ar = state.params, state.alphas, state.arch
    g = 0
    while not ar.all_finished and g < 20:
        compress(p, a, ar, None, space, thresh=1.0)
        g += 1
    n_full = sum(t.numel() for n, t in p.named_parameters()
                 if not (n.startswith("decoder.") or n == "mask_token"))
    dense, dense_cfg, _ = export_subnet(p, ar, space, cfg, fuse=True)
    sg = model_flops(a, ar, space, cfg)[1].detach().item()
    n_small = exported_param_count(dense)
    print(f"exported: D={dense_cfg.embed_dim} "
          f"blocks={dense_cfg.block_overrides} "
          f"params {n_full/1e3:.0f}K -> {n_small/1e3:.0f}K "
          f"flops {sg/dense_g*100:.0f}% of dense", flush=True)

    evd = make_eval_step_dense(dense_cfg, compute_dtype=torch.bfloat16,
                               device=dev)

    def dense_acc(pp):
        m = evd(pp, VI, VL)
        return 100.0 * m["top1"].item() / 1024
    acc_exported = dense_acc(dense)
    print(f"exported (no finetune): {acc_exported:.1f}%", flush=True)

    # finetune the exported subnet
    sched = make_schedule(5e-4, ScheduleConfig(warmup_epochs=0), 600, 100)
    ftx = build_finetune_optimizer(dense, lr_schedule=sched,
                                   layer_decay=0.95,
                                   num_layers=dense_cfg.depth)
    fstate = TrainState(step=0, params=dense, alphas=None, arch=None,
                        opt_state=ftx.init(dict(dense.named_parameters())))
    fstep = make_train_step(dense_cfg, ftx, num_classes=8,
                            compute_dtype=torch.bfloat16, device=dev)
    for it in range(cli.finetune_steps):
        imgs, lbl = make_batch(gen, 128, dev)
        fstate, fm = fstep(fstate, imgs[None], lbl[None], gen)
    acc_ft = dense_acc(fstate.params)
    print(f"exported + {cli.finetune_steps} finetune steps: {acc_ft:.1f}%",
          flush=True)
    flops_pct = sg / dense_g * 100
    print(f"\nSTORY: supernet {acc_supernet:.1f}% -> hard-pruned "
          f"{acc_exported:.1f}% -> finetuned {acc_ft:.1f}% at "
          f"{flops_pct:.0f}% FLOPs", flush=True)
    return {"supernet": acc_supernet, "exported": acc_exported,
            "finetuned": acc_ft, "flops_pct": flops_pct,
            "blocks": dense_cfg.block_overrides, "cfg": dense_cfg,
            "embed_dim": dense_cfg.embed_dim, "params": (n_full, n_small),
            "wall_s": time.time() - t0}


if __name__ == "__main__":
    main()
