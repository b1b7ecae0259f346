#!/usr/bin/env python
"""Merge ladder/hard-eval artifacts from multiple run roots into ONE
accuracy-vs-FLOPs frontier table (the cross-run view of the reference's
README.md:19-31 ladder: OFB-DeiT-A..E + OFB-Swin-A..C from one recipe).

Port of scripts/frontier.py. Each root is a ladder-style directory
holding `hard_eval.json` (written by ladder_hard_eval) and, for the ViT
family, `ladder.json` (ladder_imnet_summary). Rows are joined per rung,
preferring the fully-trained `final` checkpoints, and sorted by exported
GFLOPs.

Usage:
  python -m ofb_tpu_torch.scripts.frontier \
      --spec force=runs/ladder_imnet_r3 organic=runs/ladder_organic \
             base=runs/ladder_organic_b swin=runs/ladder_swin_r4:swin \
      --out runs/frontier.json

Prints a markdown table; writes the merged rows as JSON for BENCH.md.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def load_root(label: str, root: str, family: str):
    he_path = os.path.join(root, "hard_eval.json")
    if not os.path.exists(he_path):
        print(f"-- {label}: no hard_eval.json under {root}, skipping",
              file=sys.stderr)
        return []
    with open(he_path) as f:
        he = json.load(f)
    ladder = {}
    lpath = os.path.join(root, "ladder.json")
    if os.path.exists(lpath):
        with open(lpath) as f:
            ladder = {r["name"]: r for r in json.load(f)}

    # prefer fully-trained rows: vit 'final' (running_ckpt, raw/EMA max),
    # swin 'ft' (model_finetuned); fall back to whatever exists
    pref = {"vit": ("final", "best"), "swin": ("ft", "exported")}[family]
    by_rung = {}
    for row in he["rows"]:
        rung, _, kind = row["name"].partition("/")
        cur = by_rung.get(rung)
        rank = pref.index(kind) if kind in pref else len(pref)
        if cur is None or rank < cur[0]:
            by_rung[rung] = (rank, kind, row)

    out = []
    for rung, (_, kind, row) in sorted(by_rung.items()):
        lrow = ladder.get(rung, {})
        gflops = lrow.get("gflops")
        params = lrow.get("params")
        if gflops is None or params is None:
            meta = _ckpt_meta(row.get("checkpoint"))
            gflops = gflops if gflops is not None else meta.get("gflops")
            params = params if params is not None else meta.get("params")
        out.append({
            "label": f"{label}/{rung}" if rung else label,
            "family": family, "kind": kind,
            "gflops": gflops, "params": params,
            "acc1": row["acc1"],
            "checkpoint": row.get("checkpoint"),
        })
    return out


def _ckpt_meta(ckpt_dir):
    """gflops/params from a checkpoint meta (swin exports record them; as
    a last resort derive from model_cfg for the vit family)."""
    if not ckpt_dir or not os.path.exists(os.path.join(ckpt_dir,
                                                       "meta.json")):
        return {}
    with open(os.path.join(ckpt_dir, "meta.json")) as f:
        meta = json.load(f)
    out = {k: meta[k] for k in ("gflops", "params", "n_gflops",
                                "n_parameters") if k in meta}
    if "n_gflops" in out:
        out.setdefault("gflops", out.pop("n_gflops"))
    if "n_parameters" in out:
        out.setdefault("params", out.pop("n_parameters"))
    if "gflops" not in out and meta.get("model_cfg") \
            and meta.get("family") != "swin":
        from ..core import checkpoint as ckpt
        from ..models.vit import ModelCfg
        from .digits_story import dense_vit_gflops
        cfg = ckpt.model_cfg_from_meta(meta["model_cfg"], ModelCfg)
        out["gflops"] = dense_vit_gflops(cfg)
    if "params" not in out:
        try:
            from ..core import checkpoint as ckpt
            from .ladder import count_params
            raw = ckpt.load_checkpoint_raw(ckpt_dir)
            if raw.get("params") is not None:
                out["params"] = count_params(raw["params"])
        except (OSError, ValueError, KeyError, NotImplementedError,
                RuntimeError):
            pass                    # no count: the column shows '?'
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spec", nargs="+", required=True,
                    help="label=root[:family] (family vit|swin, "
                         "default vit)")
    ap.add_argument("--out", default=None, help="write merged rows JSON")
    args = ap.parse_args()

    rows = []
    for spec in args.spec:
        label, _, rootspec = spec.partition("=")
        root, _, family = rootspec.partition(":")
        rows.extend(load_root(label, root, family or "vit"))

    if not rows:
        raise SystemExit("no rows found in any root")
    # every hard_eval shares the probe val roots; order columns as found
    val_roots = list(rows[0]["acc1"].keys())
    names = [os.path.basename(v) for v in val_roots]
    rows.sort(key=lambda r: -(r["gflops"] or 0.0))

    head = f"| {'model':28s} | {'GFLOPs':>7s} | {'params':>8s} | " \
        + " | ".join(f"{n:>13s}" for n in names) + " |"
    print(head)
    print("|" + "-" * 30 + "|" + "|".join(["-" * 9, "-" * 10]
          + ["-" * 15] * len(names)) + "|")
    for r in rows:
        g = f"{r['gflops']:.2f}" if r["gflops"] else "?"
        p = f"{r['params']/1e6:.2f}M" if r["params"] else "?"
        accs = " | ".join(
            f"{r['acc1'].get(v, float('nan')):>13.1f}" for v in val_roots)
        print(f"| {r['label']:28s} | {g:>7s} | {p:>8s} | {accs} |")

    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=2)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
