#!/usr/bin/env python
"""Extract the organic prune-event timeline from search CLI logs.

Port of scripts/prune_timeline.py. Reads a search log (the search CLI's
stdout tee: the port's `core/engine.py` prints the same lines as the JAX
package's) and correlates each
"Start Compression" pass's event lines with the surrounding epoch/step
markers and the per-epoch searched GFLOPs (log.txt JSON lines), printing
a timeline table plus a JSON summary:

  python -m ofb_tpu_torch.scripts.prune_timeline runs/organic_a8/search1.log \
      [more logs...] --log-txt runs/organic_a8/log.txt

The reference's searches kill cells through the same thresholding
(models/layers.py:224-243, engine.py:201-213); this table is the evidence
that the rebuild's search dynamics do the same at registry geometry.
"""
from __future__ import annotations

import argparse
import json
import re
import sys

EPOCH_RE = re.compile(r"Epoch \[(\d+)\] \[(\d+)/(\d+)\]")
EVENT_RE = re.compile(
    r"^\s+((?:block\d+\.(?:attn|mlp)|embed|patch|stage\d+\.embed)): "
    r"(prune event|killed (\d+) cells)( \(converged\))?")


def parse_log(path: str, events: list) -> None:
    cur_epoch, cur_it, steps = -1, -1, 1
    with open(path) as f:
        for line in f:
            m = EPOCH_RE.search(line)
            if m:
                cur_epoch, cur_it, steps = (int(m.group(1)), int(m.group(2)),
                                            int(m.group(3)))
                continue
            m = EVENT_RE.match(line.rstrip())
            if m:
                events.append({
                    "module": m.group(1),
                    "converged": bool(m.group(4)),
                    "killed": int(m.group(3)) if m.group(3) else None,
                    "epoch": cur_epoch,
                    "frac_epoch": round(cur_epoch + cur_it / max(steps, 1), 2),
                    "log": path,
                })


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("logs", nargs="+")
    ap.add_argument("--log-txt", default=None,
                    help="per-epoch JSON-lines log for searched GFLOPs")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--no-dedup", action="store_true",
                    help="keep replayed events from crash+resume overlaps")
    args = ap.parse_args()

    events: list = []
    for p in args.logs:
        parse_log(p, events)

    # a crash+resume replays the tail of the previous log deterministically
    # (identical decisions from the replicated host-side compress), so the
    # same physical event can appear in two logs — merge by (module,
    # fractional epoch, converged) and keep one, then sort into one
    # timeline. --no-dedup shows the raw per-log stream instead.
    if not args.no_dedup:
        seen, unique = set(), []
        for e in sorted(events, key=lambda e: (e["frac_epoch"],
                                               e["module"])):
            key = (e["module"], e["frac_epoch"], e["converged"])
            if key in seen:
                continue
            seen.add(key)
            unique.append(e)
        if len(unique) < len(events):
            print(f"deduped {len(events) - len(unique)} replayed events "
                  "(crash+resume overlap)")
        events = unique

    gflops = {}
    if args.log_txt:
        with open(args.log_txt) as f:
            for line in f:
                if line.startswith("{"):
                    r = json.loads(line)
                    gflops[r["epoch"]] = r.get("train_searched_gflops")

    if not events:
        print("no prune events found")
        sys.exit(0)

    print(f"{'epoch':>7} {'module':>14} {'conv':>5} {'searched G':>11}")
    for e in events:
        g = gflops.get(e["epoch"])
        e["searched_gflops"] = round(g, 4) if g else None
        print(f"{e['frac_epoch']:>7.2f} {e['module']:>14} "
              f"{'yes' if e['converged'] else '':>5} "
              f"{g if g is not None else float('nan'):>11.4f}")

    n_conv = sum(1 for e in events if e["converged"])
    summary = {"n_events": len(events), "n_converged": n_conv,
               "first_event_epoch": events[0]["frac_epoch"],
               "modules": sorted({e["module"] for e in events})}
    print(json.dumps(summary))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"events": events, "summary": summary}, f, indent=2)


if __name__ == "__main__":
    main()
