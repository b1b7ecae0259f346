#!/usr/bin/env python
"""Per-module convergence-tail analysis (VERDICT r4 weak #3 / ask #8).
Port of scripts/alpha_tail.py.

alpha_dynamics.py answers "when does the FIRST kill fire" from the global
min ratio; this tool answers "why do specific modules flatline above the
kill threshold while their siblings converge".  It reads the same per-epoch
alpha traces (alpha.txt) and, per module, reports:

  n_active(t)   live cells (killed cells are stored as exact 0.0 in the
                trace — core/compress zeroes them; live alphas are random
                init + drift and are never exactly 0 in practice)
  ratio(t)      p_min * n_active over LIVE cells (kill fires at <= thresh,
                core/compress.py _kill_cells; reference layers.py:224-243)
  gap(t)        alpha_top1 - alpha_top2 over live cells: for a 2-cell
                module the kill condition ratio<=0.2 is exactly
                gap >= ln((1-0.1)/0.1) = 2.197 — "competitive pair" shows
                as a gap plateau below that line

and classifies every still-open module at the final epoch:

  SLOW-DRIFT    ratio still descending (negative log-slope over the last
                third) — a longer tail / un-decayed arch LR would kill it
  COMPETITIVE   n_active small and gap flat below the kill line — the
                surviving cells are genuinely balanced (benign: export
                collapse stays <2.5% when <=1 module is open, BENCH.md)
  STALLED       ratio flat and far above thresh — no selection pressure

Usage:
  python -m ofb_tpu_torch.scripts.alpha_tail runs/organic_a8/alpha.txt \
      [--thresh 0.2]
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def live_mask(a: np.ndarray) -> np.ndarray:
    return a != 0.0


def module_rows(rec: dict):
    """Yield (name, alpha_vector) for every searchable module in a record."""
    for i, v in enumerate(rec.get("attn", [])):
        yield f"block{i}.attn", np.asarray(v, np.float64)
    for i, v in enumerate(rec.get("mlp", [])):
        yield f"block{i}.mlp", np.asarray(v, np.float64)
    if "embed" in rec:
        yield "embed", np.asarray(rec["embed"], np.float64).reshape(-1)
    if "patch" in rec:
        yield "patch", np.asarray(rec["patch"], np.float64).reshape(-1)


def stats(a: np.ndarray):
    m = live_mask(a)
    n = int(m.sum())
    if n <= 1:
        return n, 0.0, float("inf")
    live = np.sort(a[m])[::-1]
    p = np.exp(live - live.max())
    p = p / p.sum()
    return n, float(p.min() * n), float(live[0] - live[1])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("trace")
    ap.add_argument("--thresh", type=float, default=0.2)
    ap.add_argument("--show", type=int, default=4,
                    help="also print this many converged siblings' tracks")
    args = ap.parse_args()

    rows = [json.loads(l) for l in open(args.trace) if l.strip()]
    if len(rows) < 3:
        raise SystemExit("need >=3 epochs of alpha traces")

    names = [n for n, _ in module_rows(rows[0])]
    track = {n: {"n": [], "ratio": [], "gap": []} for n in names}
    epochs = []
    for rec in rows:
        epochs.append(rec["epoch"])
        for n, a in module_rows(rec):
            k, r, g = stats(a)
            track[n]["n"].append(k)
            track[n]["ratio"].append(r)
            track[n]["gap"].append(g)
    e = np.asarray(epochs, np.float64)

    # 2-cell kill line: gap needed so that ratio<=thresh at n_active=2
    pmin = args.thresh / 2.0
    gap_kill_2 = float(np.log((1 - pmin) / pmin))

    open_mods, closed = [], []
    for n in names:
        (open_mods if track[n]["n"][-1] > 1 else closed).append(n)

    print(f"{len(closed)}/{len(names)} modules converged by epoch "
          f"{int(e[-1])}; open: {', '.join(open_mods) or '(none)'}")
    print(f"2-cell kill line: top1-top2 alpha gap >= {gap_kill_2:.3f}\n")

    def classify(n):
        r = np.asarray(track[n]["ratio"], np.float64)
        tail = slice(max(3, 2 * len(r) // 3), None)
        k, _ = np.polyfit(e[tail], np.log(np.maximum(r[tail], 1e-12)), 1)
        r_end = r[-1]
        n_end = track[n]["n"][-1]
        if r_end <= args.thresh * 1.5 and k < -1e-3:
            label = "SLOW-DRIFT"
            note = (f"still descending (log-slope {k:+.1e}/ep); would cross "
                    f"{args.thresh} at epoch "
                    f"{(np.log(args.thresh) - np.log(r_end)) / k + e[-1]:.0f} "
                    "at the tail rate")
        elif n_end <= 3 and abs(k) < 2e-3:
            label = "COMPETITIVE"
            note = (f"{n_end} live cells, gap {track[n]['gap'][-1]:.2f} "
                    f"vs kill line {gap_kill_2:.2f}, flat "
                    f"(log-slope {k:+.1e}/ep)")
        elif k < -1e-3:
            label = "SLOW-DRIFT"
            note = f"descending (log-slope {k:+.1e}/ep), ratio {r_end:.2f}"
        else:
            label = "STALLED"
            note = f"flat at ratio {r_end:.2f} (log-slope {k:+.1e}/ep)"
        return label, note

    for n in open_mods:
        label, note = classify(n)
        print(f"{n:>14}  {label:<11} {note}")
        stride = max(1, len(e) // 10)
        idx = list(range(0, len(e), stride)) + [len(e) - 1]
        print("        epoch " + " ".join(f"{int(e[i]):>6}" for i in idx))
        print("     n_active " + " ".join(
            f"{track[n]['n'][i]:>6}" for i in idx))
        print("        ratio " + " ".join(
            f"{track[n]['ratio'][i]:>6.3f}" for i in idx))
        print("     top2 gap " + " ".join(
            f"{min(track[n]['gap'][i], 99.0):>6.2f}" for i in idx))
        print()

    if closed and args.show:
        print("converged siblings (final-kill epoch = first epoch at "
              "n_active==1):")
        for n in closed[:args.show]:
            narr = track[n]["n"]
            done = int(e[narr.index(1)]) if 1 in narr else -1
            print(f"{n:>14}  converged at epoch {done}")


if __name__ == "__main__":
    main()
