"""Summarize the registry-geometry IMNET ladder into one table.

Port of scripts/ladder_imnet_summary.py. Reads each
``runs/ladder_imnet/t<frac>/`` directory produced by ladder_imnet.sh (the
port's or the JAX package's: two-stage search + finetune at one FLOPs target,
the OFB-DeiT-A..E analog — reference README.md:19-25, run_exp.sh:10) and
prints the accuracy-vs-FLOPs table:

    target -> exported dims -> params -> GFLOPs -> top-1

Sources per target directory:
  search stage:  log.txt (JSON lines; last row = converged searched GFLOPs),
                 best/meta.json (search-time soft acc)
  finetune stage: ft/best/meta.json (final top-1),
                 ft/running_ckpt/meta.json model_cfg (exported geometry),
                 ft/best params (exported parameter count)
Checkpoints are read through the port's core/checkpoint.py, which reads the
JAX package's msgpack directories as well as the port's own.

Usage: python -m ofb_tpu_torch.scripts.ladder_imnet_summary \
    [--root runs/ladder_imnet]
Writes <root>/ladder.json and prints the table.
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def last_log_row(path):
    row = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("{"):
                row = json.loads(line)
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="runs/ladder_imnet")
    ap.add_argument("--dense-gflops", type=float, default=4.600,
                    help="model_flops() of the dense deit_small supernet")
    args = ap.parse_args()

    from ..core import checkpoint as ckpt
    from ..models.vit import ModelCfg
    from .digits_story import dense_vit_gflops
    from .ladder import count_params

    rows = []
    # dense comparator: same finetune recipe from a fresh dense init
    # (after_ladder queue writes it to <root>/dense_ft)
    dense_best = os.path.join(args.root, "dense_ft", "best")
    if os.path.exists(os.path.join(dense_best, "meta.json")):
        dmeta = ckpt.latest_meta(dense_best)
        drow = {"name": "dense", "target_frac": 1.0,
                "target_gflops": args.dense_gflops,
                "acc1": dmeta.get("acc1")}
        if "model_cfg" in dmeta:
            dcfg = ckpt.model_cfg_from_meta(dmeta["model_cfg"], ModelCfg)
            drow["embed_dim"] = dcfg.embed_dim
            drow["gflops"] = dense_vit_gflops(dcfg)
        drow["params"] = count_params(
            ckpt.load_checkpoint_raw(dense_best)["params"])
        rows.append(drow)
        print(json.dumps(drow), flush=True)
    for tdir in sorted(glob.glob(os.path.join(args.root, "t*"))):
        frac = float(os.path.basename(tdir)[1:])
        row = {"name": os.path.basename(tdir), "target_frac": frac,
               "target_gflops": round(args.dense_gflops * frac, 3)}
        slog = last_log_row(os.path.join(tdir, "log.txt"))
        if slog:
            row["searched_gflops"] = slog.get("n_gflops")
            row["search_params"] = slog.get("n_parameters")
            row["search_epochs_done"] = slog.get("epoch")
        ft_best = os.path.join(tdir, "ft", "best")
        if os.path.exists(os.path.join(ft_best, "meta.json")):
            fmeta = ckpt.latest_meta(ft_best)
            row["acc1"] = fmeta.get("acc1")
            rmeta_path = os.path.join(tdir, "ft", "running_ckpt", "meta.json")
            mcfg_src = rmeta_path if os.path.exists(rmeta_path) else ft_best
            mcfg_meta = ckpt.latest_meta(os.path.dirname(mcfg_src)
                                         if mcfg_src.endswith("meta.json")
                                         else mcfg_src)
            if "model_cfg" in mcfg_meta:
                sub = ckpt.model_cfg_from_meta(mcfg_meta["model_cfg"],
                                               ModelCfg)
                row["embed_dim"] = sub.embed_dim
                row["blocks"] = sub.block_overrides
                row["gflops"] = dense_vit_gflops(sub)
            row["params"] = count_params(
                ckpt.load_checkpoint_raw(ft_best)["params"])
        rows.append(row)
        print(json.dumps(row), flush=True)

    # merge hard-val generalization rows (ladder_hard_eval) when
    # present: the training val saturates, so hard-val is the accuracy axis
    # that actually orders capacities
    he_path = os.path.join(args.root, "hard_eval.json")
    hard_cols = []
    if os.path.exists(he_path):
        with open(he_path) as f:
            he = json.load(f)
        he_rows = he["rows"] if isinstance(he, dict) else he
        by_name = {r["name"]: r["acc1"] for r in he_rows}
        hard_cols = sorted({k for a in by_name.values() for k in a})
        for r in rows:
            name = r["name"]
            for kind in ("best", "final"):
                accs = by_name.get(f"{name}/{kind}")
                if accs:
                    r[f"hard_{kind}"] = accs

    out = os.path.join(args.root, "ladder.json")
    with open(out, "w") as f:
        json.dump(rows, f, indent=2)

    hdr = (f"{'target':>7} {'tgt G':>7} {'srch G':>7} {'exp G':>7} "
           f"{'%dense':>7} {'params':>10} {'embed':>6} {'top-1':>7}")
    for c in hard_cols:
        hdr += f" {os.path.basename(c)[-10:]:>10}"
    print(hdr, flush=True)
    for r in rows:
        g = r.get("gflops") or r.get("searched_gflops") or float("nan")
        line = (f"{r['target_frac']:>7.2f} {r['target_gflops']:>7.3f} "
                f"{r.get('searched_gflops') or float('nan'):>7.3f} "
                f"{r.get('gflops') or float('nan'):>7.3f} "
                f"{g / args.dense_gflops:>7.1%} "
                f"{r.get('params') or 0:>10d} "
                f"{r.get('embed_dim') or 0:>6d} "
                f"{r.get('acc1') or float('nan'):>7.2f}")
        hb = r.get("hard_best") or r.get("hard_final") or {}
        for c in hard_cols:
            line += f" {hb.get(c, float('nan')):>10.2f}"
        print(line, flush=True)


if __name__ == "__main__":
    main()
