"""The port's ladder scripts (ofb_tpu_torch/scripts/) on the CPU.

* `dense_vit_gflops` and `count_params` against the JAX scripts' own
  (scripts/digits_story.py, scripts/ladder.py) on the same configs: DeiT-T,
  -S and -B, the digits ladder's tiny geometry and every `block_overrides`
  a committed `runs/**/ft/best/meta.json` records (rel 1e-12); the count
  of a port checkpoint's `.pt` part equals the JAX count of the same
  weights in msgpack;
* the ladder scripts, port only (randomness does not cross frameworks, so a
  trained ladder cannot be compared number for number): `ladder.py` on
  DIGITS at tiny dims writes the JAX script's row keys; `ladder_imnet.sh`
  (DEVICE=cpu, DATA_SET=SYNTHETIC, a tiny geometry through SEARCH_EXTRA /
  FINETUNE_EXTRA) runs a rung end to end, skips every stage on a second
  run with ladder.json byte-identical, and resumes stage 1 from a
  running_ckpt below the fuse point; `run_exp.sh` runs its three stages;
  `ladder_swin.sh` runs a rung, its hard eval and its prune timeline;
* nothing under ofb_tpu_torch/scripts/ imports JAX, the JAX package or
  the root `scripts` package.
"""

import dataclasses
import glob
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from ofb_tpu.core import checkpoint as JCk
from ofb_tpu.models import registry as JR
from ofb_tpu.models import vit as jvit
from ofb_tpu_torch.cli import search
from ofb_tpu_torch.cli.common import run_main
from ofb_tpu_torch.core import checkpoint as ck
from ofb_tpu_torch.models import registry as R
from ofb_tpu_torch.models.from_jax import load_from_jax
from ofb_tpu_torch.models.vit import ModelCfg, ViT
from ofb_tpu_torch.scripts import ladder
from ofb_tpu_torch.scripts.digits_story import dense_vit_gflops
from scripts import digits_story as jdigits
from scripts import ladder as jladder
from test_torch_port_from_jax import np_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "ofb_tpu_torch", "scripts")
TINY = "--tiny-test --compute-dtype float32 --num_workers 0"
SYNTH = TINY + " --synthetic-size 16"

torch.set_num_threads(1)


def _recorded_overrides():
    """(path, model_cfg) of every committed finetune's best/ meta with
    block_overrides."""
    out = []
    for p in sorted(glob.glob(os.path.join(REPO, "runs", "**", "ft", "best",
                                           "meta.json"), recursive=True)):
        with open(p) as f:
            cfg = json.load(f).get("model_cfg", {})
        if cfg.get("block_overrides"):
            out.append((os.path.relpath(p, REPO), cfg))
    return out


CONFIGS = [(f"deit_{s}", ("registry", f"deit_{s}_patch16_224"))
           for s in ("tiny", "small", "base")] \
    + [("digits_48_3_2", ("dict", dict(img_size=32, patch_size=8,
                                       num_classes=10, embed_dim=48,
                                       depth=3, num_heads=2,
                                       mlp_ratio=2.0)))] \
    + [(p, ("dict", cfg)) for p, cfg in _recorded_overrides()]


def _cfgs(spec):
    kind, v = spec
    if kind == "registry":
        return JR.create_model(v).cfg, R.create_model(v, device="cpu").cfg
    jcfg = JCk.model_cfg_from_meta(v, jvit.ModelCfg)
    return jcfg, ck.model_cfg_from_meta(v, ModelCfg)


def jax_vit_tree(jcfg, seed=0, shapes_only=False):
    """The JAX package's parameter tree of `jcfg`: `init_vit_params`, whose
    blocks take the config's uniform dims, with each block of a
    `block_overrides` config drawn by `init_block` at its own (heads, head
    dim, hidden), the shapes the JAX export gives a subnet. With
    `shapes_only`, zero arrays of the tree's shapes (traced, not drawn)."""
    def init(key):
        tree = jvit.init_vit_params(key, jcfg)
        if jcfg.block_overrides:
            tree["blocks"] = [
                jvit.init_block(k, dataclasses.replace(
                    jcfg, num_heads=h, head_dim=hd, mlp_hidden=hid,
                    block_overrides=None))
                for k, (h, hd, hid) in zip(jax.random.split(key, jcfg.depth),
                                           jcfg.block_overrides)]
        return tree

    key = jax.random.PRNGKey(seed)
    if not shapes_only:
        return init(key)
    return jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                  jax.eval_shape(init, key))


@pytest.mark.parametrize("spec", [c[1] for c in CONFIGS],
                         ids=[c[0] for c in CONFIGS])
def test_flops_and_param_counts_match_the_jax_scripts(spec):
    jcfg, cfg = _cfgs(spec)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    want_g, got_g = jdigits.dense_vit_gflops(jcfg), dense_vit_gflops(cfg)
    assert abs(got_g - want_g) <= 1e-12 * want_g
    want_n = jladder.count_params(jax_vit_tree(jcfg, shapes_only=True))
    got_n = ladder.count_params(ViT(cfg, device="meta"))
    assert abs(got_n - want_n) <= 1e-12 * want_n


def test_count_params_of_checkpoints_port_and_jax(tmp_path):
    """The same weights saved by the JAX package (msgpack) and by the port
    (.pt) count the same through the port's load_checkpoint_raw."""
    jcfg, cfg = _cfgs(("dict", dict(
        CONFIGS[3][1][1], block_overrides=[[2, 8, 48], [1, 16, 32],
                                           [2, 4, 16]])))
    tree = jax_vit_tree(jcfg, shapes_only=True)
    JCk.save_checkpoint(str(tmp_path / "jax"), params=tree,
                        meta={"exported": True})
    model = load_from_jax(ViT(cfg), np_tree(tree))
    ck.save_checkpoint(str(tmp_path / "port"), params=model,
                       meta={"exported": True})
    want = jladder.count_params(JCk.load_checkpoint_raw(
        str(tmp_path / "jax"))["params"])
    for d in ("jax", "port"):
        raw = ck.load_checkpoint_raw(str(tmp_path / d))
        assert ladder.count_params(raw["params"]) == want, d
    assert ladder.count_params(model) == want


# ---------------------------------------------------------------------------
# the ladder scripts
# ---------------------------------------------------------------------------

# the keys of the JAX script's rows (scripts/ladder.py:109-112, :140-145)
DENSE_KEYS = {"name", "target_frac", "gflops", "acc1", "params",
              "embed_dim", "blocks"}
RUNG_KEYS = DENSE_KEYS | {"target_gflops"}


def test_ladder_py_on_digits(tmp_path, monkeypatch):
    out = tmp_path / "ladder"
    monkeypatch.setattr(sys, "argv", [
        "ladder", "--out", str(out), "--cpu", "--targets", "0.5",
        "--model-dims", "16", "1", "2", "--dense-epochs", "1",
        "--search-epochs", "1", "--ft-epochs", "1", "--batch-size", "256"])
    ladder.main()
    rows = json.loads((out / "ladder.json").read_text())
    assert [r["name"] for r in rows] == ["dense", "OFB-A"]
    assert set(rows[0]) == DENSE_KEYS and set(rows[1]) == RUNG_KEYS
    for r, d in zip(rows, ("dense_ft", "ft_A")):
        cfg = ck.model_cfg_from_meta(ck.latest_meta(
            str(out / d / "running_ckpt"))["model_cfg"], ModelCfg)
        assert r["gflops"] == dense_vit_gflops(cfg)
        assert r["params"] == ladder.count_params(ck.load_checkpoint_raw(
            str(out / d / "best"))["params"])
        assert 0.0 <= r["acc1"] <= 100.0


def _sh(script, root, **env):
    """Run a shell script of the port; returns its output (raises on a
    non-zero exit)."""
    full = dict(os.environ, DEVICE="cpu", DATA_SET="SYNTHETIC", **env)
    p = subprocess.run(["bash", os.path.join(SCRIPTS, script), str(root)],
                       env=full, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    return p.stdout


def _epochs(text):
    return [int(e) for e in re.findall(r"Epoch \[(\d+)\] total", text)]


LADDER = dict(EPOCHS="3", FUSE_POINT="1", FT_EPOCHS="1", BATCH="8",
              SEARCH_EXTRA=SYNTH, FINETUNE_EXTRA=SYNTH)


def test_ladder_imnet_sh_runs_skips_and_resumes(tmp_path):
    root = tmp_path / "ladder"
    out = _sh("ladder_imnet.sh", root, TARGETS="0.45", **LADDER)
    rung = root / "t0.45"
    s1, s2 = (rung / "search1.log").read_text(), \
        (rung / "search2.log").read_text()
    # stage 1 breaks after the fuse-point epoch; stage 2 resumes after it
    assert _epochs(s1) == [0, 1] and "breaking at fuse_point 1" in s1
    assert _epochs(s2) == [2]
    assert f"resumed from {rung}/running_ckpt at epoch 2" in s2
    for d in ("ft/best", "ft/running_ckpt", "best"):
        assert (rung / d / "meta.json").exists(), d
    assert (root / "dense_ft" / "best" / "meta.json").exists()
    rows = json.loads((root / "ladder.json").read_text())
    assert [r["name"] for r in rows] == ["dense", "t0.45"]
    sub = ck.model_cfg_from_meta(ck.latest_meta(
        str(rung / "ft" / "running_ckpt"))["model_cfg"], ModelCfg)
    assert rows[1]["gflops"] == dense_vit_gflops(sub)
    st = json.loads((rung / "STATUS.json").read_text())
    assert st["stage"] == "finetune" and st["search_done"] \
        and st["ft_epoch"] == 0
    assert json.loads((root / "STATUS.json").read_text())["summary"]
    assert "=== ladder complete" in out

    # the same command again: every stage skipped, the table unchanged
    table = (root / "ladder.json").read_bytes()
    logs = {p: p.read_bytes() for p in sorted(root.rglob("*.log"))
            if p.name != "summary.log"}
    out = _sh("ladder_imnet.sh", root, TARGETS="0.45", **LADDER)
    for what in ("stage 1 complete (epoch 2)", "stage 2 complete (epoch 2)",
                 "finetune complete (epoch 0)"):
        assert what in out
    assert not _epochs(out)
    assert (root / "ladder.json").read_bytes() == table
    assert {p: p.read_bytes() for p in logs} == logs

    # a rung whose running_ckpt lies below the fuse point resumes stage 1
    rung = root / "t0.70"
    run_main(search, ["--data-set", "SYNTHETIC", "--device", "cpu",
                      "--batch-size", "8", "--accum-iter", "1",
                      "--epochs", "1", "--output_dir", str(rung)]
             + SYNTH.split())
    assert ck.latest_meta(str(rung / "running_ckpt"))["epoch"] == 0
    out = _sh("ladder_imnet.sh", root, TARGETS="0.70",
              **dict(LADDER, FUSE_POINT="2"))
    s1 = (rung / "search1.log").read_text()
    assert "--- stage 1 resuming from epoch 0" in out
    assert f"resumed from {rung}/running_ckpt at epoch 1" in s1
    assert _epochs(s1) == [1, 2] and "breaking at fuse_point 2" in s1
    assert "stage 2 complete (epoch 2)" in out
    assert [r["name"] for r in json.loads(
        (root / "ladder.json").read_text())] == ["dense", "t0.45", "t0.70"]


def test_run_exp_sh_runs_its_three_stages(tmp_path):
    exp = tmp_path / "exp"
    _sh("run_exp.sh", exp, EPOCHS="3", FUSE_POINT="1", BATCH="8",
        SEARCH_EXTRA=SYNTH, FINETUNE_EXTRA=SYNTH + " --epochs 1")
    log = (tmp_path / "exp-Search.log").read_text()
    assert _epochs(log) == [0, 1, 2] and "breaking at fuse_point 1" in log
    assert f"resumed from {exp}/running_ckpt at epoch 2" in log
    assert ck.latest_meta(str(exp / "exported"))["exported"]
    assert _epochs((tmp_path / "exp-Finetune.log").read_text()) == [0]
    assert (tmp_path / "exp-ft" / "best" / "meta.json").exists()


def test_ladder_swin_sh_runs_a_rung_and_its_hard_eval(tmp_path):
    val = tmp_path / "val"
    subprocess.run([sys.executable, "-m",
                    "ofb_tpu_torch.scripts.make_imagefolder", "--root",
                    str(val), "--classes", "3", "--per-class", "0",
                    "--val-per-class", "3", "--min-size", "40",
                    "--max-size", "48"], check=True, cwd=REPO,
                   capture_output=True)
    root = tmp_path / "swin"
    out = _sh("ladder_swin.sh", root, TARGETS="0.45", EPOCHS="1",
              FT_EPOCHS="1", BATCH="8", SEARCH_EXTRA=SYNTH,
              HARD_EVAL_EXTRA=f"--val-roots {val} --compute-dtype float32")
    rung = root / "t0.45"
    for d in ("model_exported", "model_finetuned"):
        assert ck.latest_meta(str(rung / d))["family"] == "swin", d
    he = json.loads((root / "hard_eval.json").read_text())
    assert [r["name"] for r in he["rows"]] == ["t0.45/ft", "t0.45/exported"]
    assert all(0.0 <= a <= 100.0 for r in he["rows"]
               for a in r["acc1"].values())
    assert "=== swin ladder complete" in out


def test_no_jax_imports_under_scripts():
    pat = re.compile(r"^\s*(?:import|from)\s+(jax\b|ofb_tpu\b(?!_)|scripts\b)"
                     r"|^\s*from\s+ofb_tpu\.", re.M)
    files = sorted(glob.glob(os.path.join(SCRIPTS, "*.py")))
    examples = sorted(glob.glob(os.path.join(SCRIPTS, "..", "examples",
                                             "*.py")))
    assert len(files) == 16 and len(examples) == 3
    files += examples
    for f in files:
        with open(f) as fh:
            assert not pat.search(fh.read()), f
    for f in glob.glob(os.path.join(SCRIPTS, "*.sh")):
        with open(f) as fh:
            text = fh.read()
        assert "scripts/" not in re.sub(r"ofb_tpu_torch/scripts/|^#.*$", "",
                                        text, flags=re.M), f
        assert not re.search(r"python\s+scripts/", text), f
