"""Accuracy-vs-FLOPs compression-level ladder — the OFB-DeiT-A..E analog.

Port of scripts/ladder.py. The reference's headline deliverable is a
LADDER of operating points: the same search run at different
`target_flops` yields OFB-DeiT-A..E at 0.9 -> 8.7 GFLOPs / 75.0 -> 81.7%
top-1 (reference README.md:19-25, run_exp.sh:10, search.py:206). This
script reproduces that deliverable shape on sklearn's digits (DIGITS needs
scikit-learn) through the real CLI paths, in this process: ONE dense
baseline, then for each FLOPs target

    search CLI (--target_flops T)  ->  finetune CLI (export inside)

and one table: target -> exported dims -> params -> GFLOPs -> top-1.

Usage:
  python -m ofb_tpu_torch.scripts.ladder --out runs/ladder [--cpu] \
      --targets 0.40 0.60 0.80 [--model-dims 48 3 2]
"""

from __future__ import annotations

import argparse
import json
import os

from .digits_story import dense_vit_gflops, device_flags, save_dense_init


def count_params(tree) -> int:
    """Elements of every tensor or array in a module's parameters, a
    {name: tensor} dict (the port's checkpoint parts) or a nested tree of
    dicts, lists and arrays (the JAX package's, as
    `core.checkpoint.load_checkpoint_raw` decodes them)."""
    import numpy as np
    import torch
    if isinstance(tree, torch.nn.Module):
        return sum(p.numel() for p in tree.parameters())
    total = 0
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        elif isinstance(node, torch.Tensor):
            total += node.numel()
        elif node is not None:
            total += int(np.asarray(node).size)
    return total


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="runs/ladder")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--targets", type=float, nargs="+",
                    default=[0.40, 0.60, 0.80],
                    help="FLOPs targets as fractions of the dense model")
    ap.add_argument("--model-dims", type=int, nargs=3, default=(48, 3, 2),
                    metavar=("EMBED", "DEPTH", "HEADS"))
    ap.add_argument("--dense-epochs", type=int, default=80)
    ap.add_argument("--search-epochs", type=int, default=100)
    ap.add_argument("--ft-epochs", type=int, default=120)
    ap.add_argument("--w-flops", type=float, default=25.0)
    ap.add_argument("--batch-size", type=int, default=128)
    args = ap.parse_args()

    from ..cli import finetune as ft
    from ..cli import search as se
    from ..core import checkpoint as ckpt
    from ..models.vit import ModelCfg

    os.makedirs(args.out, exist_ok=True)
    md, mdep, mh = args.model_dims
    cfg = ModelCfg(img_size=32, patch_size=8, num_classes=10, embed_dim=md,
                   depth=mdep, num_heads=mh, mlp_ratio=2.0)
    dense_g = dense_vit_gflops(cfg)

    # small-data recipe (see digits_story.py: the ImageNet DeiT recipe
    # leaves this 1,280-image supernet at chance)
    common = ["--data-set", "DIGITS", "--tiny-test", "--batch-size",
              str(args.batch_size), "--accum-iter", "1", "--num_workers",
              "0", "--seed", "0"] + device_flags(args.cpu)
    ft_recipe = ["--mixup", "0", "--cutmix", "0", "--reprob", "0",
                 "--aa", "", "--blr", "4e-3", "--layer-decay", "1.0",
                 "--smoothing", "0.0", "--drop-path", "0.0",
                 "--min-crop-scale", "0.55", "--no-hflip"]
    search_recipe = ["--aa", "", "--reprob", "0", "--min-crop-scale",
                     "0.55", "--no-hflip", "--smoothing", "0.0",
                     "--blr", "2e-3", "--blr_decoder", "2e-3"]
    fp = ft.get_args_parser()
    sp = se.get_args_parser()

    rows = []

    # ---- dense baseline (once) -----------------------------------------
    dense_init = os.path.join(args.out, "dense_init")
    dense_params = save_dense_init(dense_init, cfg)
    dense_out = os.path.join(args.out, "dense_ft")
    if not os.path.exists(os.path.join(dense_out, "best", "meta.json")):
        ft.main(fp.parse_args(common + ft_recipe + [
            "--finetune", dense_init, "--epochs", str(args.dense_epochs),
            "--output_dir", dense_out, "--warmup-epochs", "5"]))
    dmeta = ckpt.latest_meta(os.path.join(dense_out, "best"))
    dense_row = {"name": "dense", "target_frac": 1.0,
                 "gflops": dense_g, "acc1": dmeta["acc1"],
                 "params": count_params(dense_params),
                 "embed_dim": md, "blocks": None}
    rows.append(dense_row)
    print(json.dumps({"stage": "dense", **dense_row}), flush=True)

    # ---- one search + finetune per target ------------------------------
    for i, frac in enumerate(args.targets):
        tag = chr(ord("A") + i)
        tgt = dense_g * frac
        sdir = os.path.join(args.out, f"search_{tag}")
        if not os.path.exists(os.path.join(sdir, "best", "meta.json")):
            se.main(sp.parse_args(common + search_recipe + [
                "--tiny-dims", str(md), str(mdep), str(mh),
                "--epochs", str(args.search_epochs), "--output_dir", sdir,
                "--target_flops", str(tgt), "--w_flops", str(args.w_flops),
                "--fuse_point", str(args.search_epochs + 1),
                "--warmup-epochs", str(max(args.search_epochs // 2, 1))]))
        fdir = os.path.join(args.out, f"ft_{tag}")
        if not os.path.exists(os.path.join(fdir, "best", "meta.json")):
            ft.main(fp.parse_args(common + ft_recipe + [
                "--finetune", os.path.join(sdir, "best"),
                "--epochs", str(args.ft_epochs), "--output_dir", fdir,
                "--warmup-epochs", "5"]))
        fmeta = ckpt.latest_meta(os.path.join(fdir, "best"))
        sub_cfg = ckpt.model_cfg_from_meta(
            ckpt.latest_meta(os.path.join(fdir, "running_ckpt"))["model_cfg"],
            ModelCfg)
        sub_params = ckpt.load_checkpoint_raw(
            os.path.join(fdir, "best"))["params"]
        row = {"name": f"OFB-{tag}", "target_frac": frac,
               "target_gflops": tgt,
               "gflops": dense_vit_gflops(sub_cfg), "acc1": fmeta["acc1"],
               "params": count_params(sub_params),
               "embed_dim": sub_cfg.embed_dim,
               "blocks": sub_cfg.block_overrides}
        rows.append(row)
        print(json.dumps({"stage": f"ladder_{tag}", **row}), flush=True)

    # ---- final table ----------------------------------------------------
    with open(os.path.join(args.out, "ladder.json"), "w") as f:
        json.dump(rows, f, indent=2)
    hdr = (f"{'name':<8} {'target':>7} {'GFLOPs':>10} {'%dense':>7} "
           f"{'params':>8} {'embed':>6} {'top-1':>7}")
    print(hdr, flush=True)
    for r in rows:
        print(f"{r['name']:<8} {r['target_frac']:>7.2f} "
              f"{r['gflops']:>10.3e} {r['gflops'] / dense_g:>7.1%} "
              f"{r['params']:>8d} {r['embed_dim']:>6d} {r['acc1']:>7.2f}",
              flush=True)


if __name__ == "__main__":
    main()
