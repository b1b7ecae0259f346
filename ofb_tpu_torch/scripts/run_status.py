#!/usr/bin/env python
"""Write a STATUS.json manifest per ladder rung (and for the root).

Port of scripts/run_status.py. A ladder root (ladder_imnet.sh /
ladder_swin.sh output, the port's or the JAX package's) mixes
finished, in-flight and aborted rungs; this tool records, per rung, the
stage reached, epochs completed, and where a resume should pick up — so a
later run (or a reader) can tell at a glance without log forensics.

  python -m ofb_tpu_torch.scripts.run_status --root runs/ladder_imnet_r3

Stages: search1 (to fuse_point) -> search2 (resumed to --epochs) ->
finetune. Each stage's progress comes from the stage's checkpoint meta
(running_ckpt/meta.json) and the JSON-lines log (log.txt / ft/log.txt);
"resumable_from" points at the newest usable running_ckpt.
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def _meta(path):
    p = os.path.join(path, "meta.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def _last_json_line(path):
    if not os.path.exists(path):
        return None
    row = None
    with open(path) as f:
        for line in f:
            if line.startswith("{"):
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    pass
    return row


def rung_status(tdir: str) -> dict:
    st = {"dir": tdir, "stage": "not_started", "resumable_from": None}

    smeta = _meta(os.path.join(tdir, "running_ckpt"))
    slog = _last_json_line(os.path.join(tdir, "log.txt"))
    if smeta is not None:
        sargs = smeta.get("args", {})
        total = sargs.get("epochs")
        fuse = sargs.get("fuse_point")
        st["stage"] = "search2" if (fuse == total or smeta.get(
            "finish_search")) else "search1"
        st["search_epoch"] = smeta.get("epoch")
        st["search_epochs_total"] = total
        st["finish_search"] = smeta.get("finish_search")
        st["target_flops"] = sargs.get("target_flops")
        st["resumable_from"] = os.path.join(tdir, "running_ckpt")
        if slog:
            st["searched_gflops"] = slog.get("n_gflops")
        done = (smeta.get("epoch") is not None and total is not None
                and smeta["epoch"] >= total - 1)
        st["search_done"] = bool(done)

    # Swin-ladder layout: export/finetune artifacts live at the rung root
    # (model_exported/, model_finetuned/) rather than under ft/.
    emeta = _meta(os.path.join(tdir, "model_exported"))
    if emeta is not None:
        st["stage"] = "exported"
        st["search_done"] = True
        st["exported_acc1"] = emeta.get("acc1")
    ftmeta = _meta(os.path.join(tdir, "model_finetuned"))
    if ftmeta is not None:
        st["stage"] = "complete"
        st["search_done"] = True
        st["finetuned_acc1"] = ftmeta.get("acc1")

    fmeta = _meta(os.path.join(tdir, "ft", "running_ckpt"))
    fbest = _meta(os.path.join(tdir, "ft", "best"))
    if fmeta is not None or fbest is not None:
        st["stage"] = "finetune"
        if fmeta is not None:
            st["ft_epoch"] = fmeta.get("epoch")
            st["resumable_from"] = os.path.join(tdir, "ft", "running_ckpt")
        if fbest is not None:
            st["ft_best_acc1"] = fbest.get("acc1")
            st["ft_best_epoch"] = fbest.get("epoch")
        flog = _last_json_line(os.path.join(tdir, "ft", "log.txt"))
        if flog:
            st["ft_gflops"] = flog.get("n_gflops")
            st["ft_params"] = flog.get("n_parameters")
    return st


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="runs/ladder_imnet_r3")
    args = ap.parse_args()

    statuses = []
    for tdir in sorted(glob.glob(os.path.join(args.root, "t*"))):
        if not os.path.isdir(tdir):
            continue
        st = rung_status(tdir)
        with open(os.path.join(tdir, "STATUS.json"), "w") as f:
            json.dump(st, f, indent=2)
        statuses.append(st)

    dense = os.path.join(args.root, "dense_ft")
    if os.path.isdir(dense):
        st = {"dir": dense, "stage": "finetune"}
        fmeta = _meta(os.path.join(dense, "running_ckpt"))
        fbest = _meta(os.path.join(dense, "best"))
        if fmeta:
            st["ft_epoch"] = fmeta.get("epoch")
            st["resumable_from"] = os.path.join(dense, "running_ckpt")
        if fbest:
            st["ft_best_acc1"] = fbest.get("acc1")
        dmeta = _meta(os.path.join(dense, "model_finetuned"))
        if dmeta:
            st["stage"] = "complete"
            st["finetuned_acc1"] = dmeta.get("acc1")
        statuses.append(st)

    root_status = {"rungs": statuses,
                   "hard_eval": os.path.exists(
                       os.path.join(args.root, "hard_eval.json")),
                   "summary": os.path.exists(
                       os.path.join(args.root, "ladder.json"))}
    with open(os.path.join(args.root, "STATUS.json"), "w") as f:
        json.dump(root_status, f, indent=2)
    for st in statuses:
        print(json.dumps(st), flush=True)


if __name__ == "__main__":
    main()
