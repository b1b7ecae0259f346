"""Re-evaluate the IMNET ladder's finetuned models on harder val sets.

Port of scripts/ladder_hard_eval.py. The ladder's training val set
(make_imagefolder --noise 0.35) saturates: even the most-compressed rung
reaches ~100% top-1 within two finetune epochs, so the ladder table's
accuracy column cannot separate capacities. This script restores the
accuracy axis by evaluating every exported + finetuned rung (and the dense
comparator) on *held-out* val sets drawn from the same class patterns at
higher noise — a generalization probe where model capacity actually shows
(the reference's ladder uses real ImageNet-1k val for the same purpose,
README.md:19-25).

Each target gets the port's dense eval step of its geometry
(`make_eval_step_dense`, or `make_swin_eval_step_dense` for the Swin
layout); checkpoints are read through the port's core/checkpoint.py, the
JAX package's msgpack directories as well as the port's own.

For `final` (running_ckpt) targets BOTH the raw params and the EMA slot
are evaluated and the max reported, mirroring the finetune loop's
best-of-raw/EMA selection (cli/finetune.py) — otherwise final rows
would compare raw-only weights against the best rows' winner weights.

Usage:
  python -m ofb_tpu_torch.scripts.make_imagefolder \
      --root /tmp/imf_hard_n060 --classes 100 --per-class 0 \
      --val-per-class 25 --noise 0.60 --seed 7
  python -m ofb_tpu_torch.scripts.ladder_hard_eval \
      --root runs/ladder_imnet_r3 \
      --val-roots /tmp/imfolder /tmp/imf_hard_n060 /tmp/imf_hard_n090

Writes <root>/hard_eval.json and prints one table row per model.
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def eval_params_on(params, cfg, eval_step, val_roots, batch_size,
                   device="cuda"):
    """Top-1 of one weight set on each val root."""
    from ..config import DataConfig
    from ..core.engine import evaluate
    from ..data.datasets import build_dataset
    from ..data.pipeline import device_feed, make_epoch_loader

    accs = {}
    for vroot in val_roots:
        dcfg = DataConfig(data_path=vroot, data_set="IMNET",
                          input_size=cfg.img_size, batch_size=batch_size)
        ds_val, _ = build_dataset(False, dcfg, staging=256)
        loader = make_epoch_loader(ds_val, epoch=0, rank=0, world=1,
                                   batch_size=batch_size,
                                   repeated_aug=False, train=False)
        feed = device_feed(loader, train=False, out_size=cfg.img_size,
                           device=device)
        stats = evaluate(eval_step, feed, params)
        accs[vroot] = stats["acc1"]
    return accs


def load_target(best_dir: str, device="cuda"):
    """(params, ema_or_None, cfg, meta) for an exported checkpoint dir.
    Handles both families: ViT (the ModelCfg of its meta) and Swin (the
    sliced per-block widths its meta records, `core.checkpoint.
    swin_from_meta`). Raises SystemExit when the directory is not an
    exported checkpoint or its params part is missing; a missing EMA part
    gives ema None."""
    from ..core import checkpoint as ckpt
    from ..models.vit import ModelCfg, ViT

    meta = ckpt.latest_meta(best_dir)
    if meta is None or not (meta.get("exported") or meta.get("from_scratch")):
        raise SystemExit(f"{best_dir}: not an exported checkpoint")

    def build():
        """(an unseeded model of the checkpoint's widths, its config)"""
        if meta.get("family") == "swin":
            return ckpt.swin_from_meta(meta, device)
        cfg = ckpt.model_cfg_from_meta(meta["model_cfg"], ModelCfg)
        return ViT(cfg, device=device), cfg

    params, cfg = build()
    try:
        restored = ckpt.load_checkpoint(best_dir, params=params)
    except FileNotFoundError as e:
        raise SystemExit(f"{best_dir}: params part missing from checkpoint "
                         f"({e}; incomplete clone or gitignored blob?)")
    if "params" not in restored:
        raise SystemExit(f"{best_dir}: params part missing from checkpoint")
    ema = None
    if "ema" in meta.get("parts", []):
        ema = build()[0]
        try:
            ema = ckpt.load_checkpoint(best_dir, ema_params=ema).get("ema")
        except FileNotFoundError:
            ema = None
    return params, ema, cfg, meta


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="runs/ladder_imnet_r3")
    ap.add_argument("--val-roots", nargs="+",
                    default=["/tmp/imfolder", "/tmp/imf_hard_n060",
                             "/tmp/imf_hard_n090", "/tmp/imf_hard_n120"])
    ap.add_argument("--batch-size", type=int, default=250)
    ap.add_argument("--compute-dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--family", default="vit", choices=["vit", "swin"],
                    help="vit: ladder_imnet.sh layout (t*/ft/{best,"
                         "running_ckpt} + dense_ft). swin: ladder_swin.sh "
                         "layout (t*/{model_finetuned,model_exported})")
    ap.add_argument("--out", default="",
                    help="output json path (default <root>/hard_eval.json); "
                         "set when re-probing so prior artifacts survive")
    ap.add_argument("--seed-summary", action="store_true",
                    help="group val roots that differ only by a _s<seed> "
                         "suffix and print mean +/- half-range per group "
                         "(the error bar for the beats-dense claim)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda (the default) raises without a "
                         "card, cpu runs on the CPU")
    args = ap.parse_args()

    import torch

    from ..core.steps import make_eval_step_dense
    from ..core.swin_steps import make_swin_eval_step_dense
    from ..device import resolve_device

    dev = resolve_device(args.device)
    compute = torch.bfloat16 if args.compute_dtype == "bfloat16" \
        else torch.float32
    make_step = make_swin_eval_step_dense if args.family == "swin" \
        else make_eval_step_dense

    # Under a saturated training val set, "best" snapshots the FIRST epoch
    # to hit the ceiling (early weights); the final-epoch weights live in
    # running_ckpt. Evaluate both so the hard-val columns compare
    # fully-trained models, with the best-ckpt rows as the early-stop view.
    targets = []
    if args.family == "swin":
        dense_dir = os.path.join(args.root, "dense_ft", "model_finetuned")
        if os.path.exists(os.path.join(dense_dir, "meta.json")):
            targets.append(("dense/ft", "best", dense_dir))
        for t in sorted(glob.glob(os.path.join(args.root, "t*"))):
            name = os.path.basename(t)
            for kind, sub in (("ft", "model_finetuned"),
                              ("exported", "model_exported")):
                d = os.path.join(t, sub)
                if os.path.exists(os.path.join(d, "meta.json")):
                    targets.append((f"{name}/{kind}", "best", d))
    else:
        for name, ftdir in [("dense", os.path.join(args.root, "dense_ft"))] \
                + [(os.path.basename(t), os.path.join(t, "ft"))
                   for t in sorted(glob.glob(os.path.join(args.root, "t*")))]:
            for kind, sub in (("best", "best"), ("final", "running_ckpt")):
                d = os.path.join(ftdir, sub)
                if os.path.exists(os.path.join(d, "meta.json")):
                    targets.append((f"{name}/{kind}", kind, d))

    # record the probe configuration alongside the numbers (each val root's
    # generator manifest if present, else just the path)
    probe_cfg = {}
    for vroot in args.val_roots:
        man = os.path.join(vroot, "manifest.json")
        if os.path.exists(man):
            with open(man) as f:
                probe_cfg[vroot] = json.load(f)
        else:
            probe_cfg[vroot] = {"path": vroot}

    rows = []
    for name, kind, best in targets:
        try:
            params, ema, cfg, meta = load_target(best, dev)
        except SystemExit as e:
            # a model whose big weight blobs are not in the checkout
            # (gitignored) or a placeholder meta must not abort the whole
            # sweep — report and keep evaluating the rest
            print(f"  SKIP {name}: {e}", flush=True)
            continue
        step = make_step(cfg, compute_dtype=compute, device=dev)
        accs = eval_params_on(params, cfg, step, args.val_roots,
                              args.batch_size, dev)
        # `best` checkpoints already store the raw/EMA winner as params;
        # `final` running_ckpts store raw params + the live EMA — evaluate
        # both and keep the max, as the finetune eval loop would.
        if kind == "final" and ema is not None:
            ema_accs = eval_params_on(ema, cfg, step, args.val_roots,
                                      args.batch_size, dev)
            accs = {k: max(accs[k], ema_accs[k]) for k in accs}
        for vroot in args.val_roots:
            print(f"  {name} @ {vroot}: acc1={accs[vroot]:.2f}", flush=True)
        rows.append({"name": name, "checkpoint": best, "acc1": accs,
                     "train_val_acc1": meta.get("acc1")})

    out = args.out or os.path.join(args.root, "hard_eval.json")
    with open(out, "w") as f:
        json.dump({"probe_cfg": probe_cfg, "rows": rows}, f, indent=2)

    names = [os.path.basename(v) for v in args.val_roots]
    print(f"{'model':>12} " + " ".join(f"{n:>16}" for n in names), flush=True)
    for r in rows:
        print(f"{r['name']:>12} " + " ".join(
            f"{r['acc1'][v]:>16.2f}" for v in args.val_roots), flush=True)

    if args.seed_summary:
        import re
        groups = {}
        for v in args.val_roots:
            groups.setdefault(
                re.sub(r"_s\d+$", "", os.path.basename(v)), []).append(v)
        print(f"\n{'model':>12} " + " ".join(
            f"{g + ' mean+-hr':>20}" for g in groups), flush=True)
        for r in rows:
            cells = []
            for g, roots in groups.items():
                vals = [r["acc1"][v] for v in roots]
                mean = sum(vals) / len(vals)
                hr = (max(vals) - min(vals)) / 2
                cells.append(f"{mean:>13.2f} +-{hr:>4.2f}")
            print(f"{r['name']:>12} " + " ".join(cells), flush=True)

    print(f"wrote {out}", flush=True)


if __name__ == "__main__":
    main()
