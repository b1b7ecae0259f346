"""The port's tools over run roots (ofb_tpu_torch/scripts/) against the JAX
package's scripts/ on the same inputs, on the CPU.

* `run_status` on copies of every committed `runs/*` root and on
  tests/test_run_status.py's fixture: the same STATUS.json files (as JSON,
  each copy's root path in place of the other's) and the same printout;
* `frontier` over copies of the committed ladder roots and on
  tests/test_frontier.py's fixtures: the same merged JSON and table;
* `prune_timeline`, `alpha_dynamics` and `alpha_tail` on the committed
  `runs/**/search*.log` and `alpha.txt`: the same printout, exit and JSON;
  `prune_timeline` also on the log of a tiny port `cli.search` run whose
  compress threshold fires events (non-empty);
* `make_imagefolder` with the same arguments and seed: byte-identical
  JPEGs and manifest.json;
* `ladder_hard_eval` (vit and swin layouts) and `ladder_imnet_summary` on a
  root of JAX-written checkpoints of seeded tiny models (best; running_ckpt
  with EMA; a target without its params part, which both SKIP; a Swin
  model_finetuned / model_exported) and a tiny ImageFolder: each top-1 in
  fp32 within one image of the val set of JAX's, ladder.json rows field
  for field.

Every committed root is copied to tmp_path first: run_status writes into
the root it is given.
"""

import contextlib
import dataclasses
import glob
import io
import json
import os
import runpy
import shutil
import sys

import jax
import pytest
import torch

from ofb_tpu.core import checkpoint as JCk
from ofb_tpu.models import vit as jvit
from ofb_tpu_torch.cli import search
from ofb_tpu_torch.cli.common import run_main
from ofb_tpu_torch.models import swin as S
from ofb_tpu_torch.models.from_jax import to_jax
from ofb_tpu_torch.scripts import (alpha_dynamics, alpha_tail, frontier,
                                   ladder_hard_eval, ladder_imnet_summary,
                                   make_imagefolder, prune_timeline,
                                   run_status)
from test_torch_port_ladder import jax_vit_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = os.path.join(REPO, "runs")
ROOTS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(RUNS, "*"))
               if os.path.isdir(p))
LOGS = sorted(os.path.relpath(p, REPO) for p in
              glob.glob(os.path.join(RUNS, "**", "search*.log"),
                        recursive=True))
ALPHAS = sorted(os.path.relpath(p, REPO) for p in
                glob.glob(os.path.join(RUNS, "**", "alpha.txt"),
                          recursive=True))

torch.set_num_threads(1)


def _call(fn, argv):
    """(exit code, stdout, stderr) of fn() run as `prog argv`."""
    out, err = io.StringIO(), io.StringIO()
    saved = sys.argv
    sys.argv = ["prog"] + [str(a) for a in argv]
    code = 0
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            fn()
    except SystemExit as e:
        if e.code is None or isinstance(e.code, int):
            code = e.code or 0
        else:                               # sys.exit("message")
            code = 1
            err.write(str(e.code))
    finally:
        sys.argv = saved
    return code, out.getvalue(), err.getvalue()


def jax_tool(name, argv):
    """The JAX package's scripts/<name>.py run as __main__ in process."""
    return _call(lambda: runpy.run_path(
        os.path.join(REPO, "scripts", name + ".py"), run_name="__main__"),
        argv)


def port_tool(module, argv):
    return _call(module.main, argv)


def _tree_files(root, name):
    return sorted(os.path.relpath(p, root) for p in
                  glob.glob(os.path.join(root, "**", name), recursive=True))


def _json(path, root=None):
    with open(path) as f:
        text = f.read()
    return json.loads(text.replace(str(root), "<root>") if root else text)


# ---------------------------------------------------------------------------
# run_status
# ---------------------------------------------------------------------------

def _status_fixture(root):
    """tests/test_run_status.py's ladder: a rung in stage 1, a rung in its
    finetune, the dense comparator."""
    def write(rel, obj):
        os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
        with open(os.path.join(root, rel), "w") as f:
            json.dump(obj, f)
    write("t0.25/running_ckpt/meta.json",
          {"epoch": 12, "finish_search": False,
           "args": {"epochs": 100, "fuse_point": 50, "target_flops": 1.15}})
    with open(os.path.join(root, "t0.25/log.txt"), "w") as f:
        f.write(json.dumps({"epoch": 12, "n_gflops": 2.0}) + "\n")
    write("t0.45/running_ckpt/meta.json",
          {"epoch": 99, "finish_search": False,
           "args": {"epochs": 100, "fuse_point": 100, "target_flops": 2.07}})
    write("t0.45/ft/running_ckpt/meta.json", {"epoch": 30})
    write("t0.45/ft/best/meta.json", {"epoch": 28, "acc1": 91.0})
    write("dense_ft/best/meta.json", {"epoch": 50, "acc1": 95.0})


@pytest.mark.parametrize("name", ROOTS + ["test_run_status_fixture"])
def test_run_status_matches_jax(tmp_path, name):
    roots = {}
    for side in ("jax", "port"):
        roots[side] = str(tmp_path / side / name)
        if name in ROOTS:
            shutil.copytree(os.path.join(RUNS, name), roots[side])
        else:
            _status_fixture(roots[side])
    want = jax_tool("run_status", ["--root", roots["jax"]])
    got = port_tool(run_status, ["--root", roots["port"]])
    assert want[0] == got[0] == 0
    assert got[1].replace(roots["port"], "<root>") == \
        want[1].replace(roots["jax"], "<root>")
    files = _tree_files(roots["jax"], "STATUS.json")
    assert files and files == _tree_files(roots["port"], "STATUS.json")
    for f in files:
        assert _json(os.path.join(roots["port"], f), roots["port"]) == \
            _json(os.path.join(roots["jax"], f), roots["jax"]), f


# ---------------------------------------------------------------------------
# frontier
# ---------------------------------------------------------------------------

def _frontier_both(tmp_path, spec):
    outs = {}
    for side, fn in (("jax", lambda a: jax_tool("frontier", a)),
                     ("port", lambda a: port_tool(frontier, a))):
        out = tmp_path / f"frontier_{side}.json"
        code, text, err = fn(["--spec", *spec, "--out", out])
        outs[side] = (code, text.replace(str(out), "<out>"), err,
                      json.loads(out.read_text()) if out.exists() else None)
    return outs


def test_frontier_over_the_committed_ladders_matches_jax(tmp_path):
    spec = []
    for label, name, fam in (("force", "ladder_imnet_r3", ""),
                             ("organic", "ladder_organic", ""),
                             ("base", "ladder_organic_b", ""),
                             ("swin", "ladder_swin_r5", ":swin")):
        shutil.copytree(os.path.join(RUNS, name), tmp_path / name)
        spec.append(f"{label}={tmp_path / name}{fam}")
    outs = _frontier_both(tmp_path, spec)
    assert outs["port"] == outs["jax"]
    assert outs["port"][0] == 0 and len(outs["port"][3]) >= 7
    assert "no hard_eval.json" in outs["port"][2]


def _frontier_root(tmp_path, name, rows, ladder=None):
    """tests/test_frontier.py's roots."""
    root = tmp_path / name
    root.mkdir()
    (root / "hard_eval.json").write_text(json.dumps(
        {"probe_cfg": {}, "rows": rows}))
    if ladder is not None:
        (root / "ladder.json").write_text(json.dumps(ladder))
    return root


def test_frontier_on_the_jax_tests_fixtures_matches_jax(tmp_path):
    acc = {"/v/easy": 100.0, "/v/hard": 90.0}
    vit = _frontier_root(
        tmp_path, "r",
        rows=[{"name": "dense/best", "acc1": {**acc, "/v/hard": 95.0},
               "checkpoint": "x"},
              {"name": "dense/final", "acc1": {**acc, "/v/hard": 94.0},
               "checkpoint": "x"},
              {"name": "t0.25/final", "acc1": acc, "checkpoint": "x"}],
        ladder=[{"name": "dense", "gflops": 4.6, "params": 22_000_000},
                {"name": "t0.25", "gflops": 0.8, "params": 3_800_000}])
    swin = _frontier_root(
        tmp_path, "s",
        rows=[{"name": "t0.45/exported", "acc1": {"/v/hard": 80.0},
               "checkpoint": "x"},
              {"name": "t0.45/ft", "acc1": {"/v/hard": 85.0},
               "checkpoint": "x"}])
    for spec in ([f"lad={vit}"], [f"swin={swin}:swin"],
                 [f"lad={vit}", f"swin={swin}:swin"]):
        outs = _frontier_both(tmp_path, spec)
        assert outs["port"] == outs["jax"]
        assert outs["port"][0] == 0


# ---------------------------------------------------------------------------
# the search-dynamics tools on the committed logs
# ---------------------------------------------------------------------------

def _both(name, module, argv_of, tmp_path):
    res = {}
    for side in ("jax", "port"):
        out = tmp_path / f"{side}.json"
        argv = argv_of(out)
        res[side] = (jax_tool(name, argv) if side == "jax"
                     else port_tool(module, argv))
        res[side] += (out.read_text() if out.exists() else None,)
        res[side] = tuple(x.replace(str(out), "<out>")
                          if isinstance(x, str) else x for x in res[side])
    assert res["port"] == res["jax"]
    return res["port"]


@pytest.mark.parametrize("log", LOGS + ["runs/organic_a8/search*.log"])
def test_prune_timeline_on_the_committed_logs_matches_jax(tmp_path, log):
    logs = sorted(glob.glob(os.path.join(REPO, log)))
    txt = os.path.join(os.path.dirname(logs[0]), "log.txt")
    extra = ["--log-txt", txt] if os.path.exists(txt) else []
    for dedup in ([], ["--no-dedup"]):
        _both("prune_timeline", prune_timeline,
              lambda out: [*logs, *extra, "--json-out", out, *dedup],
              tmp_path)


@pytest.mark.parametrize("trace", ALPHAS)
def test_alpha_tools_on_the_committed_traces_match_jax(tmp_path, trace):
    path = os.path.join(REPO, trace)
    for name, module, extra in (("alpha_dynamics", alpha_dynamics, []),
                                ("alpha_dynamics", alpha_dynamics,
                                 ["--thresh", "0.5",
                                  "--steps-per-epoch", "39"]),
                                ("alpha_tail", alpha_tail, []),
                                ("alpha_tail", alpha_tail,
                                 ["--thresh", "0.3", "--show", "2"])):
        _both(name, module, lambda out: [path, *extra], tmp_path)


def test_prune_timeline_reads_a_port_search_log(tmp_path):
    """The port's search CLI prints the lines the tools read: a tiny run
    whose compress threshold 1.0 kills cells every pass."""
    out = tmp_path / "search"
    _, text = run_main(search, [
        "--data-set", "SYNTHETIC", "--tiny-test", "--device", "cpu",
        "--compute-dtype", "float32", "--synthetic-size", "64",
        "--batch-size", "16", "--accum-iter", "1", "--num_workers", "0",
        "--epochs", "2", "--compress-thresh", "1.0",
        "--output_dir", str(out)])
    log = tmp_path / "search1.log"
    log.write_text(text)
    code, printed, _, js = _both(
        "prune_timeline", prune_timeline,
        lambda o: [log, "--log-txt", out / "log.txt", "--json-out", o],
        tmp_path)
    assert code == 0 and json.loads(js)["summary"]["n_events"] > 0


# ---------------------------------------------------------------------------
# make_imagefolder
# ---------------------------------------------------------------------------

def test_make_imagefolder_writes_the_same_files(tmp_path):
    argv = ["--classes", "3", "--per-class", "2", "--val-per-class", "2",
            "--min-size", "40", "--max-size", "72", "--noise", "0.2",
            "--quality", "80", "--seed", "5"]
    want = jax_tool("make_imagefolder", ["--root", tmp_path / "jax", *argv])
    got = port_tool(make_imagefolder, ["--root", tmp_path / "port", *argv])
    assert got[0] == want[0] == 0
    assert got[1].replace(str(tmp_path / "port"), "<root>") == \
        want[1].replace(str(tmp_path / "jax"), "<root>")
    files = _tree_files(tmp_path / "jax", "*.*")
    assert len(files) == 3 * 4 + 1
    assert files == _tree_files(tmp_path / "port", "*.*")
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f


# ---------------------------------------------------------------------------
# ladder_hard_eval and ladder_imnet_summary on JAX-written checkpoints
# ---------------------------------------------------------------------------

VAL_IMAGES = 4 * 6                     # classes x val images a class
DENSE = dict(img_size=32, patch_size=8, num_classes=4, embed_dim=32,
             depth=2, num_heads=2, mlp_ratio=2.0)
SUB = dict(DENSE, embed_dim=24, block_overrides=((2, 8, 48), (1, 16, 32)))
SWIN = dict(img_size=32, patch_size=2, num_classes=4, embed_dim=24,
            depths=(2, 2), num_heads=(2, 4), window=4, mlp_ratio=2.0,
            drop_path_rate=0.0)


def _val_roots(tmp_path):
    """Two val sets of the same classes (seeds 1 and 2)."""
    roots = []
    for seed in (1, 2):
        root = tmp_path / f"imf_s{seed}"
        port_tool(make_imagefolder, [
            "--root", root, "--classes", "4", "--per-class", "0",
            "--val-per-class", "6", "--min-size", "40", "--max-size", "64",
            "--noise", "0.3", "--seed", seed])
        roots.append(str(root))
    return roots


def _vit_tree(cfg_kw, seed):
    """A JAX ViT tree of the config (each block at its own dims), its
    weights scaled 3x so that the logits separate."""
    cfg = jvit.ModelCfg(**cfg_kw)
    return cfg, jax.tree_util.tree_map(
        lambda a: a * 3.0 if a.ndim >= 2 else a, jax_vit_tree(cfg, seed))


def _save_vit(path, cfg_kw, seed, **meta):
    cfg, tree = _vit_tree(cfg_kw, seed)
    _, ema = _vit_tree(cfg_kw, seed + 100)
    JCk.save_checkpoint(str(path), params=tree, ema_params=ema, meta={
        "exported": True, "model_cfg": json.loads(json.dumps(
            dataclasses.asdict(cfg))), **meta})


def _vit_root(root):
    """dense_ft and one rung, best and running_ckpt each, written by the
    JAX package; a second rung whose running_ckpt lacks its params."""
    _save_vit(root / "dense_ft" / "best", DENSE, 1, epoch=3, acc1=60.0,
              eval_winner="ema", from_scratch=True)
    _save_vit(root / "dense_ft" / "running_ckpt", DENSE, 2, epoch=4,
              from_scratch=True)
    _save_vit(root / "t0.45" / "ft" / "best", SUB, 3, epoch=2, acc1=55.0,
              eval_winner="raw")
    _save_vit(root / "t0.45" / "ft" / "running_ckpt", SUB, 4, epoch=4)
    with open(root / "t0.45" / "log.txt", "w") as f:
        for e in range(3):
            f.write(json.dumps({"epoch": e, "n_gflops": 0.01 - e * 1e-3,
                                "n_parameters": 9000 - e}) + "\n")
    lost = root / "t0.70" / "ft" / "running_ckpt"
    os.makedirs(lost)
    (root / "t0.70" / "log.txt").write_text(json.dumps(
        {"epoch": 0, "n_gflops": 0.02, "n_parameters": 12000}) + "\n")
    (lost / "meta.json").write_text(json.dumps(
        {"parts": ["params"], "epoch": 1, "exported": True,
         "model_cfg": dataclasses.asdict(jvit.ModelCfg(**SUB))}))


def _swin_root(root):
    """A dense Swin (dense_ft/model_finetuned) and an exported subnet's
    model_exported / model_finetuned, written by the JAX package."""
    cfg = S.SwinCfg(**SWIN)
    widths = {"blocks": [{"mlp_hidden": h} for h in (24, 12, 48, 72)],
              "stage_dims": [18, 36]}
    for sub, meta, seed in (
            ("dense_ft/model_finetuned", {"from_scratch": True}, 1),
            ("t0.45/model_exported", widths, 2),
            ("t0.45/model_finetuned", dict(widths, acc1=40.0), 3)):
        model = S.Swin(cfg, generator=torch.Generator().manual_seed(seed),
                       **S.subnet_widths(meta))
        with torch.no_grad():
            for p in model.parameters():
                if p.dim() >= 2:
                    p.mul_(3.0)
        JCk.save_checkpoint(str(root / sub), params=to_jax(model), meta={
            "exported": True, "family": "swin",
            "model_cfg": json.loads(json.dumps(dataclasses.asdict(cfg))),
            **meta})


def _hard_eval_both(root, vals, tmp_path, family):
    argv = ["--root", root, "--val-roots", *vals, "--family", family,
            "--compute-dtype", "float32", "--batch-size", "10",
            "--seed-summary"]
    res = {}
    for side in ("jax", "port"):
        out = tmp_path / f"hard_{family}_{side}.json"
        code, text, _ = jax_tool("ladder_hard_eval", argv + ["--out", out]) \
            if side == "jax" else port_tool(
                ladder_hard_eval, argv + ["--out", out, "--device", "cpu"])
        assert code == 0, text
        res[side] = (text, json.loads(out.read_text()))
    (jtext, jhe), (ptext, phe) = res["jax"], res["port"]
    assert phe["probe_cfg"] == jhe["probe_cfg"]
    assert [(r["name"], r["checkpoint"], r["train_val_acc1"])
            for r in phe["rows"]] == \
        [(r["name"], r["checkpoint"], r["train_val_acc1"])
         for r in jhe["rows"]]
    for p, j in zip(phe["rows"], jhe["rows"]):
        assert p["acc1"].keys() == j["acc1"].keys()
        for v in vals:
            assert abs(p["acc1"][v] - j["acc1"][v]) <= 100.0 / VAL_IMAGES \
                + 1e-9, (p["name"], v, p["acc1"][v], j["acc1"][v])
    def skipped(text):
        return [ln.split(":")[0].strip() for ln in text.splitlines()
                if ln.strip().startswith("SKIP ")]
    assert skipped(ptext) == skipped(jtext)
    return jhe, phe, jtext, ptext


def test_hard_eval_and_summary_vit_layout_match_jax(tmp_path):
    vals = _val_roots(tmp_path)
    base = tmp_path / "ladder"
    _vit_root(base)
    jhe, phe, jtext, ptext = _hard_eval_both(str(base), vals, tmp_path,
                                             "vit")
    names = ["dense/best", "dense/final", "t0.45/best", "t0.45/final"]
    assert [r["name"] for r in phe["rows"]] == names
    for text in (jtext, ptext):
        assert "  SKIP t0.70/final: " in text and "imf mean+-hr" in text

    # the summary of two copies, each with JAX's hard_eval.json merged in
    rows = {}
    for side, run in (("jax", lambda a: jax_tool("ladder_imnet_summary", a)),
                      ("port", lambda a: port_tool(ladder_imnet_summary,
                                                   a))):
        root = tmp_path / f"summary_{side}"
        shutil.copytree(base, root)
        (root / "hard_eval.json").write_text(json.dumps(jhe))
        code, text, _ = run(["--root", root])
        assert code == 0
        rows[side] = (json.loads((root / "ladder.json").read_text()),
                      text.replace(str(root), "<root>"))
    assert rows["port"] == rows["jax"]
    table = rows["port"][0]
    assert [r["name"] for r in table] == ["dense", "t0.45", "t0.70"]
    assert table[0]["params"] > table[1]["params"] > 0
    assert table[1]["hard_best"] and table[1]["hard_final"]


def test_hard_eval_swin_layout_matches_jax(tmp_path):
    vals = _val_roots(tmp_path)
    root = tmp_path / "swin"
    _swin_root(root)
    _, phe, _, _ = _hard_eval_both(str(root), vals, tmp_path, "swin")
    assert [r["name"] for r in phe["rows"]] == \
        ["dense/ft", "t0.45/ft", "t0.45/exported"]
