"""End-to-end real-image accuracy story: dense vs OFB-searched subnet.

Port of scripts/digits_story.py. The story runs on sklearn's bundled
handwritten digits (1,797 genuine 8x8 scans, 10 classes; DIGITS needs
scikit-learn) through the same CLI code paths a user would run on ImageNet
(reference run_exp.sh):

  1. dense baseline: finetune CLI from a fresh dense init
  2. search CLI: OFB bi-mask search to --target_flops (PMIM pretraining,
     compress state machine, fuse-at-best)
  3. finetune CLI from the searched checkpoint (export/intersect inside)

Prints one JSON line per stage and a final summary table. Usage:
  python -m ofb_tpu_torch.scripts.digits_story --out /tmp/digits_story [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os


def dense_vit_gflops(cfg) -> float:
    """MAC count of the (possibly exported) tiny ViT, same accounting as
    ops/flops.py (matmul MACs + norms/bias)."""
    n = cfg.num_patches + cfg.num_tokens
    d = cfg.embed_dim
    p2 = cfg.patch_size ** 2
    total = cfg.num_patches * d * 3 * p2
    over = cfg.block_overrides or [(cfg.num_heads, cfg.hd,
                                    cfg.hidden)] * cfg.depth
    for (h, hd, hid) in over:
        ae = h * hd
        total += 2 * d * n
        total += n * d * 3 * ae + 3 * n * ae          # qkv
        total += h * n * hd * n * 2 + 6 * h * n * n   # attention
        total += n * ae * d + n * d                   # proj
        total += (d * hid + hid * d + d + hid) * n    # mlp
    total += d * cfg.num_classes
    return total / 1e9


def device_flags(cpu: bool):
    """The CLIs' device and compute type: the CPU in fp32 with --cpu, else
    the card in bf16."""
    return ["--device", "cpu" if cpu else "cuda", "--compute-dtype",
            "float32" if cpu else "bfloat16"]


def save_dense_init(path: str, cfg, seed: int = 0):
    """A dense ViT drawn from `seed`, saved as an exported checkpoint the
    finetune CLI takes with --finetune. Returns the model."""
    import dataclasses

    import torch

    from ..core import checkpoint as ckpt
    from ..models.vit import ViT
    model = ViT(cfg, generator=torch.Generator().manual_seed(seed))
    ckpt.save_checkpoint(path, params=model,
                         meta={"exported": True,
                               "model_cfg": dataclasses.asdict(cfg)})
    return model


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="runs/digits_story")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--dense-epochs", type=int, default=60)
    ap.add_argument("--search-epochs", type=int, default=40)
    ap.add_argument("--ft-epochs", type=int, default=60)
    ap.add_argument("--model-dims", type=int, nargs=3, default=(32, 2, 2),
                    metavar=("EMBED", "DEPTH", "HEADS"),
                    help="tiny model geometry for both stages")
    ap.add_argument("--target-flops", type=float, default=0.00015)
    ap.add_argument("--w-flops", type=float, default=None,
                    help="FLOPs-loss weight override (stronger pressure "
                         "discovers smaller subnets, the OFB-DeiT-A..E "
                         "compression-level analog)")
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--registry-model", default=None,
                    help="run the story at REGISTRY geometry (e.g. "
                         "'deit_tiny') instead of the bespoke tiny model: "
                         "full 224px supernet through the same CLIs "
                         "(search uses <name>_patch16_224_mim)")
    ap.add_argument("--target-frac", type=float, default=None,
                    help="target_flops as a fraction of the dense model "
                         "(overrides --target-flops)")
    args = ap.parse_args()

    from ..cli import finetune as ft
    from ..cli import search as se
    from ..core import checkpoint as ckpt
    from ..models.vit import ModelCfg

    os.makedirs(args.out, exist_ok=True)
    results = {}

    # ---- 1. dense baseline: finetune from a fresh dense init ------------
    if args.registry_model:
        from ..models.registry import create_model
        cfg = create_model(f"{args.registry_model}_patch16_224",
                           device="cpu", num_classes=10).cfg
    else:
        md, mdep, mh = args.model_dims
        cfg = ModelCfg(img_size=32, patch_size=8, num_classes=10,
                       embed_dim=md, depth=mdep, num_heads=mh,
                       mlp_ratio=2.0)
    if args.target_frac is not None:
        args.target_flops = args.target_frac * dense_vit_gflops(cfg)
    dense_dir = os.path.join(args.out, "dense_init")
    save_dense_init(dense_dir, cfg)
    common = ["--data-set", "DIGITS", "--batch-size",
              str(args.batch_size), "--accum-iter", "1", "--num_workers",
              "0", "--seed", "0"] + device_flags(args.cpu)
    if not args.registry_model:
        common.append("--tiny-test")
    # 1,280 train images of upscaled 8x8 digits: the ImageNet DeiT recipe
    # (RandAugment m9 + mixup/cutmix + erasing + blr 1.5e-4) destroys
    # learning at this scale — use a mild recipe and a real LR instead
    ft_recipe = ["--mixup", "0", "--cutmix", "0", "--reprob", "0",
                 "--aa", "", "--blr", "4e-3", "--layer-decay", "1.0",
                 "--smoothing", "0.0", "--drop-path", "0.0",
                 "--min-crop-scale", "0.55", "--no-hflip"]
    fp = ft.get_args_parser()
    dense_out = os.path.join(args.out, "dense_ft")
    fargs = fp.parse_args(common + ft_recipe + [
        "--finetune", dense_dir, "--epochs", str(args.dense_epochs),
        "--output_dir", dense_out, "--warmup-epochs", "5"])
    ft.main(fargs)
    dmeta = ckpt.latest_meta(os.path.join(dense_out, "best"))
    results["dense"] = {"acc1": dmeta["acc1"],
                        "gflops": dense_vit_gflops(cfg)}
    print(json.dumps({"stage": "dense", **results["dense"]}), flush=True)

    # ---- 2. OFB search to the FLOPs target ------------------------------
    # same mild-augment reasoning as the finetune recipe: the ImageNet
    # search recipe (RandAugment m9 + erasing + blr 2.5e-4) leaves the
    # supernet at chance accuracy on 1,280 tiny images, which makes the
    # best-checkpoint selection meaningless
    search_recipe = ["--aa", "", "--reprob", "0", "--min-crop-scale",
                     "0.55", "--no-hflip", "--smoothing", "0.0",
                     "--blr", "2e-3", "--blr_decoder", "2e-3"]
    sp = se.get_args_parser()
    search_out = os.path.join(args.out, "search")
    extra = ["--w_flops", str(args.w_flops)] \
        if args.w_flops is not None else []
    if args.registry_model:
        extra += ["--model", f"{args.registry_model}_patch16_224_mim"]
    else:
        extra += ["--tiny-dims", str(md), str(mdep), str(mh)]
    sargs = sp.parse_args(common + search_recipe + extra + [
        "--epochs", str(args.search_epochs), "--output_dir", search_out,
        "--target_flops", str(args.target_flops),
        "--fuse_point", str(args.search_epochs + 1),
        "--warmup-epochs", str(max(args.search_epochs // 2, 1))])
    se.main(sargs)
    smeta = ckpt.latest_meta(os.path.join(search_out, "best"))
    print(json.dumps({"stage": "search", "acc1": smeta["acc1"],
                      "finish_search": smeta.get("finish_search")}),
          flush=True)

    # ---- 3. finetune the searched subnet (export inside) ----------------
    ft_out = os.path.join(args.out, "subnet_ft")
    fargs = fp.parse_args(common + ft_recipe + [
        "--finetune", os.path.join(search_out, "best"),
        "--epochs", str(args.ft_epochs), "--output_dir", ft_out,
        "--warmup-epochs", "5"])
    ft.main(fargs)
    fmeta = ckpt.latest_meta(os.path.join(ft_out, "best"))
    sub_cfg = ckpt.model_cfg_from_meta(
        ckpt.latest_meta(os.path.join(ft_out, "running_ckpt"))["model_cfg"],
        ModelCfg)
    results["subnet"] = {"acc1": fmeta["acc1"],
                         "gflops": dense_vit_gflops(sub_cfg),
                         "embed_dim": sub_cfg.embed_dim,
                         "blocks": sub_cfg.block_overrides}
    print(json.dumps({"stage": "subnet", **results["subnet"]}), flush=True)

    d, s = results["dense"], results["subnet"]
    summary = {
        "dense_acc1": d["acc1"], "dense_gflops": round(d["gflops"], 6),
        "subnet_acc1": s["acc1"], "subnet_gflops": round(s["gflops"], 6),
        "flops_ratio": round(s["gflops"] / d["gflops"], 4),
        "acc_delta": round(s["acc1"] - d["acc1"], 3),
    }
    print(json.dumps({"stage": "summary", **summary}), flush=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)


if __name__ == "__main__":
    main()
