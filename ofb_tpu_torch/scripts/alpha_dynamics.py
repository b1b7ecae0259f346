#!/usr/bin/env python
"""Measure how fast the bi-mask search's alpha distributions sharpen, and
project the step count at which the first organic cell kill would fire.
Port of scripts/alpha_dynamics.py.

The kill rule (core/compress.py:_kill_cells, reference models/layers.py:
224-243) zeroes a cell when its masked-softmax probability drops below
thresh/n_active (thresh 0.2 => 5x below uniform).  This tool reads the
per-epoch alpha traces (alpha.txt written by the search CLI's --output_dir)
and reports, per module family and for the global worst cell:

  r(t) = p_min(t) * n_active      (1.0 = uniform, kill at r <= thresh)

plus a log-linear fit of min-over-modules r(t) => projected first-kill epoch
at the observed drift rate.  Usage:

  python -m ofb_tpu_torch.scripts.alpha_dynamics \
      runs/ladder_imnet_r3/t0.45/alpha.txt \
      [--thresh 0.2]
"""
from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np


def softmax_ratio(a: np.ndarray) -> float:
    """p_min * n for an active alpha vector (switch all-on assumed; zeroed
    alphas from past kills are still counted — kills never happened in the
    runs this tool targets)."""
    a = np.asarray(a, np.float64).reshape(-1)
    a = a - a.max()
    p = np.exp(a)
    p = p / p.sum()
    return float(p.min() * p.size)


def per_epoch_stats(rec: dict) -> dict:
    out = {"epoch": rec["epoch"]}
    fams = {}
    if "attn" in rec:
        fams["attn"] = [softmax_ratio(v) for v in rec["attn"]]
    if "mlp" in rec:
        fams["mlp"] = [softmax_ratio(v) for v in rec["mlp"]]
    for key in ("embed", "patch"):
        if key in rec:
            fams[key] = [softmax_ratio(rec[key])]
    for k, v in fams.items():
        out[k] = min(v)
    out["min"] = min(min(v) for v in fams.values())
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("trace")
    ap.add_argument("--thresh", type=float, default=0.2)
    ap.add_argument("--steps-per-epoch", type=int, default=78)
    args = ap.parse_args()

    rows = []
    with open(args.trace) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(per_epoch_stats(json.loads(line)))
            except (json.JSONDecodeError, KeyError):
                continue
    if len(rows) < 3:
        sys.exit("need >=3 epochs of alpha traces")

    print(f"{'epoch':>6} " + " ".join(f"{k:>8}" for k in rows[0] if k != "epoch"))
    stride = max(1, len(rows) // 12)
    for r in rows[::stride] + ([rows[-1]] if (len(rows) - 1) % stride else []):
        print(f"{r['epoch']:>6} " + " ".join(
            f"{r[k]:>8.4f}" for k in r if k != "epoch"))

    # log-linear drift fit on the global min ratio (skip the first few
    # epochs: w_p warmup changes the gradient scale)
    e = np.array([r["epoch"] for r in rows], np.float64)
    m = np.array([r["min"] for r in rows], np.float64)
    lo = max(3, len(rows) // 5)
    k, b = np.polyfit(e[lo:], np.log(np.maximum(m[lo:], 1e-12)), 1)
    if k >= -1e-9:
        print(f"\nno downward drift (slope {k:+.2e}/epoch) — at this rate the "
              f"kill threshold {args.thresh} is never reached")
        return
    target = math.log(args.thresh)
    epoch_kill = (target - b) / k
    print(f"\nglobal min ratio: {m[0]:.4f} (e{int(e[0])}) -> {m[-1]:.4f} "
          f"(e{int(e[-1])}); log-slope {k:+.3e}/epoch")
    print(f"projected first kill (ratio<={args.thresh}): epoch "
          f"{epoch_kill:.0f}  (~{epoch_kill * args.steps_per_epoch:,.0f} "
          f"steps at {args.steps_per_epoch}/epoch)")
    print("arch-lr scaling: alpha drift is ~linear in lr while the softmax "
          "stays near-uniform, so k*lr_mult reaches the threshold "
          f"~{epoch_kill:.0f}/lr_mult epochs; e.g. 8x lr => epoch "
          f"{epoch_kill / 8:.0f}")


if __name__ == "__main__":
    main()
