"""The port's CLIs (ofb_tpu_torch/cli) on the CPU, against the JAX package's
scripts with the same flags.

* `cli.search --tiny-test --data-set SYNTHETIC --device cpu --compute-dtype
  float32 --compress-thresh 1.0` converges, fuses and writes the artifact
  set of `scripts/search.py` run with the same flags: the same directories,
  the same parts in each meta, the same meta keys, the same log.txt and
  alpha.txt keys (the values differ: randomness does not cross);
* `--resume` continues at the next epoch;
* `scripts/prune_timeline.py` and `scripts/run_status.py`, unchanged, read
  the port's printed log and run directory;
* `cli.export` -> `cli.finetune --epochs 1` -> `cli.eval` run;
* a JAX-initialised tiny supernet, exported by the JAX package, evaluated by
  `scripts/eval.py` and, carried over by `from_jax.py` and saved with the
  port's checkpoint, by `cli.eval` on the same SYNTHETIC val set, fp32:
  loss rel 1e-4 (the eval resize sums in another order), top-1 within one
  image of 2048;
* --world_size > 1 (the multi-GPU slice, not ported yet) raises
  NotImplementedError; --distillation-type, --planned-epoch and
  --pretrained_path each run a --tiny-test epoch; the default --device
  cuda raises without a card.

The JAX runs start as subprocesses when the module's fixture starts, and
run while the port's do.
"""

import argparse
import ast
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ofb_tpu.core import checkpoint as JCk
from ofb_tpu.core import compress as JC
from ofb_tpu.core import export as JEx
from ofb_tpu.core import steps as JS
from ofb_tpu_torch.cli import eval as eval_cli
from ofb_tpu_torch.cli import export, finetune, search
from ofb_tpu_torch.cli.common import run_main as _port
from ofb_tpu_torch.core import checkpoint as ck
from ofb_tpu_torch.models.from_jax import load_from_jax
from ofb_tpu_torch.models.vit import ModelCfg, ViT
from test_torch_port_from_jax import jax_supernet, np_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEARCH = ["--data-set", "SYNTHETIC", "--tiny-test", "--compute-dtype",
          "float32", "--compress-thresh", "1.0", "--synthetic-size", "256",
          "--batch-size", "128", "--accum-iter", "1", "--num_workers", "0",
          "--seed", "0"]
TINY = dict(img_size=32, patch_size=8, num_classes=1000, embed_dim=32,
            depth=2, num_heads=2, mlp_ratio=2.0, drop_path_rate=0.0)


def _jax_script(script, argv):
    code = (f"import sys; sys.argv = {[script] + argv!r}; "
            "import jax; jax.config.update('jax_platforms', 'cpu'); "
            "import runpy; "
            f"runpy.run_path({script!r}, run_name='__main__')")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    return subprocess.Popen([sys.executable, "-c", code], env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _jax_exported(root):
    """A JAX-initialised tiny supernet, force-finished and exported by the
    JAX package; saved by it (msgpack) and, carried over, by the port."""
    cfg, space, params, alphas, arch = jax_supernet(TINY, seed=7)
    for _ in range(20):
        if arch.all_finished:
            break
        params, alphas, arch, _, _ = JC.compress(params, alphas, arch, None,
                                                 space, thresh=1.0)
    dense, dcfg, _ = JEx.export_subnet(params, arch, space, cfg)
    meta = {"exported": True, "model_cfg": dataclasses.asdict(dcfg)}
    JCk.save_checkpoint(os.path.join(root, "jax_exported"), params=dense,
                        meta=meta)
    # the port's ModelCfg has every field of the JAX package's, its
    # rematerialisation switch (not set here) among them
    known = {f.name for f in dataclasses.fields(ModelCfg)}
    fields = json.loads(json.dumps(meta["model_cfg"]))
    assert {k: v for k, v in fields.items() if k not in known} == {}
    assert fields["remat"] is False
    pcfg = ck.model_cfg_from_meta(fields, ModelCfg)
    assert pcfg.remat is False
    port = load_from_jax(ViT(pcfg), np_tree(dense))
    ck.save_checkpoint(os.path.join(root, "port_exported"), params=port,
                       meta={"exported": True,
                             "model_cfg": dataclasses.asdict(pcfg)})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli"))
    jdir = os.path.join(root, "jax")
    _jax_exported(root)
    # two epochs: a search epoch, then the epoch whose third compress pass
    # converges the search, and the fuse
    jsearch = _jax_script("scripts/search.py", SEARCH + [
        "--epochs", "2", "--output_dir", jdir])
    jeval = _jax_script("scripts/eval.py", [
        "--checkpoint", os.path.join(root, "jax_exported"), "--data-set",
        "SYNTHETIC", "--compute-dtype", "float32", "--batch-size", "512"])
    pdir = os.path.join(root, "ladder", "t1.0")
    out = {"root": root, "jdir": jdir, "pdir": pdir}
    try:
        _, out["search_log"] = _port(search, SEARCH + [
            "--device", "cpu", "--epochs", "3", "--output_dir", pdir])
        with open(os.path.join(root, "port_search.log"), "w") as f:
            f.write(out["search_log"])
        _, out["resume_log"] = _port(search, SEARCH + [
            "--device", "cpu", "--epochs", "4", "--output_dir", pdir,
            "--resume", "--checkpoint", os.path.join(pdir, "running_ckpt")])
        out["port_eval"], _ = _port(eval_cli, [
            "--checkpoint", os.path.join(root, "port_exported"),
            "--data-set", "SYNTHETIC", "--compute-dtype", "float32",
            "--batch-size", "512", "--device", "cpu"])
        stdout, stderr = jsearch.communicate(timeout=600)
        assert jsearch.returncode == 0, stderr[-3000:]
        out["jax_search_log"] = stdout
        stdout, stderr = jeval.communicate(timeout=600)
        assert jeval.returncode == 0, stderr[-3000:]
        out["jax_eval"] = ast.literal_eval(stdout.strip().splitlines()[-1])
    finally:
        for p in (jsearch, jeval):
            if p.poll() is None:
                p.kill()
    return out


def _tree(d):
    """{subdir: (sorted parts, sorted meta keys)} and the top-level files of
    a run directory, extensions dropped."""
    out = {}
    for name in sorted(os.listdir(d)):
        p = os.path.join(d, name)
        if os.path.isdir(p) and os.path.exists(os.path.join(p, "meta.json")):
            meta = json.load(open(os.path.join(p, "meta.json")))
            out[name] = (sorted(meta["parts"]), sorted(meta))
        elif os.path.isfile(p):
            out[name] = "file"
    return out


def _jsonl(path):
    return [json.loads(x) for x in open(path) if x.startswith("{")]


def test_search_converges_fuses_and_writes_jax_artifacts(runs):
    log, jlog = runs["search_log"], runs["jax_search_log"]
    for text in (log, jlog):
        assert "fusing best checkpoint" in text and "saved model_fused" in text
    assert "== finish_search" in log        # the port's run went on to a
                                            # postsearch epoch
    mine, theirs = _tree(runs["pdir"]), _tree(runs["jdir"])
    for d in (mine, theirs):
        assert {"running_ckpt", "best", "model_fused", "log.txt",
                "alpha.txt"} <= set(d)
    # the resumed epoch re-wrote the same artifacts
    assert mine == theirs
    fused = json.load(open(os.path.join(runs["pdir"], "model_fused",
                                        "meta.json")))
    assert fused["fused"] is True and 0.0 <= fused["fused_acc1"] <= 100.0
    rows, jrows = (_jsonl(os.path.join(d, "log.txt"))
                   for d in (runs["pdir"], runs["jdir"]))
    assert [r["epoch"] for r in rows] == [0, 1, 2, 3]
    assert [r["epoch"] for r in jrows] == [0, 1]
    # search epochs: the JAX run's keys; postsearch epochs: those of the
    # JAX postsearch step's metrics
    assert [set(r) for r in rows[:2]] == [set(r) for r in jrows]
    tail = {k for k in jrows[0] if not k.startswith("train_")} | {
        "train_epoch_time_s", "train_img_s"}
    post = tail | {f"train_{k}" for k in JS.METRIC_KEYS_POSTSEARCH}
    assert [set(r) for r in rows[2:]] == [post, post]
    assert all(np.isfinite(r["train_loss_total"]) for r in rows)
    a, ja = (_jsonl(os.path.join(d, "alpha.txt"))
             for d in (runs["pdir"], runs["jdir"]))
    assert a and ja and set(a[0]) == set(ja[0])
    assert [len(x) for x in a[0]["attn"]] == [len(x) for x in ja[0]["attn"]]
    assert len(a[0]["embed"][0]) == len(ja[0]["embed"][0])


def test_resume_continues_at_the_next_epoch(runs):
    log = runs["resume_log"]
    assert "resumed from" in log and "at epoch 3" in log
    assert "Epoch [3]" in log and "Epoch [2]" not in log
    meta = json.load(open(os.path.join(runs["pdir"], "running_ckpt",
                                       "meta.json")))
    assert meta["epoch"] == 3 and meta["finish_search"] is True
    assert meta["args"]["tiny_test"] is True


def test_prune_timeline_and_run_status_read_port_runs(runs):
    def timeline(log, txt):
        r = subprocess.run(
            [sys.executable, "scripts/prune_timeline.py", log, "--log-txt",
             txt], cwd=REPO, capture_output=True, text=True, check=True)
        return json.loads(r.stdout.strip().splitlines()[-1])
    jlog = os.path.join(runs["root"], "jax_search.log")
    with open(jlog, "w") as f:
        f.write(runs["jax_search_log"])
    mine = timeline(os.path.join(runs["root"], "port_search.log"),
                    os.path.join(runs["pdir"], "log.txt"))
    theirs = timeline(jlog, os.path.join(runs["jdir"], "log.txt"))
    assert mine["n_events"] > 0 and mine["n_converged"] == 6
    assert mine["modules"] == theirs["modules"] == [
        "block0.attn", "block0.mlp", "block1.attn", "block1.mlp", "embed",
        "patch"]
    root = os.path.dirname(runs["pdir"])
    subprocess.run([sys.executable, "scripts/run_status.py", "--root", root],
                   cwd=REPO, capture_output=True, text=True, check=True)
    st = json.load(open(os.path.join(runs["pdir"], "STATUS.json")))
    assert st["stage"] == "search2" and st["search_epoch"] == 3
    assert st["finish_search"] is True and st["search_done"]


def test_export_finetune_eval_chain(runs):
    pdir, xdir = runs["pdir"], os.path.join(runs["root"], "exported")
    (dense, dcfg), text = _port(export, [
        "--checkpoint", os.path.join(pdir, "best"), "--out", xdir,
        "--device", "cpu"])
    meta = json.load(open(os.path.join(xdir, "meta.json")))
    assert meta["exported"] is True and meta["parts"] == ["params"]
    assert ck.model_cfg_from_meta(meta["model_cfg"], ModelCfg) == dcfg
    fdir = os.path.join(pdir, "ft")
    state, text = _port(finetune, [
        "--data-set", "SYNTHETIC", "--tiny-test", "--finetune", xdir,
        "--epochs", "1", "--batch-size", "256", "--device", "cpu",
        "--compute-dtype", "float32", "--num_workers", "0",
        "--output_dir", fdir])
    assert "Test[raw]:" in text and "Test[ema]:" in text
    row = _jsonl(os.path.join(fdir, "log.txt"))[-1]
    assert np.isfinite(row["train_loss"]) and "soft_test_ema_acc1" in row
    best = json.load(open(os.path.join(fdir, "best", "meta.json")))
    assert best["eval_winner"] in ("raw", "ema")
    assert best["parts"] == ["params", "ema"]
    stats, text = _port(eval_cli, [
        "--checkpoint", os.path.join(fdir, "best"), "--data-set",
        "SYNTHETIC", "--device", "cpu", "--compute-dtype", "float32",
        "--batch-size", "512", "--use-ema"])
    assert 0.0 <= stats["acc1"] <= 100.0 and np.isfinite(stats["loss"])
    # the soft accuracy of a searched supernet checkpoint too
    stats, _ = _port(eval_cli, [
        "--checkpoint", os.path.join(pdir, "best"), "--data-set",
        "SYNTHETIC", "--device", "cpu", "--compute-dtype", "float32",
        "--batch-size", "512"])
    assert 0.0 <= stats["acc1"] <= 100.0


def test_eval_matches_jax_eval_script(runs):
    mine, theirs = runs["port_eval"], runs["jax_eval"]
    assert mine["loss"] == pytest.approx(theirs["loss"], rel=1e-4)
    assert abs(mine["acc1"] - theirs["acc1"]) <= 100.0 / 2048 + 1e-9
    assert abs(mine["acc5"] - theirs["acc5"]) <= 100.0 / 2048 + 1e-9


@pytest.mark.parametrize("flag", [["--world_size", "2"]])
def test_unported_flags_raise(flag, tmp_path, monkeypatch):
    """--world_size raised while the multi-GPU slice was missing; it is now
    the JAX CLIs' [compat] no-op: without a launcher the world is one
    process, whatever the flag says."""
    for k in ("RANK", "WORLD_SIZE", "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    _, text = _port(search, SEARCH + ["--device", "cpu", "--epochs", "1",
                                      "--output_dir", str(tmp_path / "s")]
                    + flag)
    assert "rank 0 of world 1, backend none" in text
    assert len(ck_epoch_lines(text)) == 1
    _, text = _port(finetune, ["--data-set", "SYNTHETIC", "--tiny-test",
                               "--synthetic-size", "64", "--epochs", "1",
                               "--batch-size", "32", "--compute-dtype",
                               "float32", "--num_workers", "0",
                               "--device", "cpu", "--output_dir",
                               str(tmp_path / "f")] + flag)
    assert "rank 0 of world 1, backend none" in text
    assert len(ck_epoch_lines(text)) == 1


def _pretrained(path):
    """A timm-layout state dict of the tiny supernet, from a seed."""
    from ofb_tpu_torch.cli.common import tiny_bundle
    from ofb_tpu_torch.models.torch_import import params_to_torch_state_dict
    params = tiny_bundle(1000, torch.device("cpu")).init(11)[0]
    torch.save({"model": {k: torch.from_numpy(v) for k, v in
                          params_to_torch_state_dict(params).items()}}, path)
    return params


@pytest.mark.parametrize("flag", [
    ["--distillation-type", "soft", "--teacher-model", "regnety_040"],
    ["--planned-epoch", "--cache-device"],
    ["--pretrained_path", "weights.pth"]])
def test_flags_that_raised_now_run(flag, runs, tmp_path):
    """Each flag that raised before the teacher, the planned steps and the
    timm import were ported runs a --tiny-test epoch on the CPU."""
    if flag[0] == "--pretrained_path":
        flag = [flag[0], str(tmp_path / flag[1])]
        want = _pretrained(flag[1])
    state, text = _port(search, SEARCH + [
        "--device", "cpu", "--epochs", "1", "--output_dir",
        str(tmp_path / "s")] + flag)
    lines = ck_epoch_lines(text)
    assert len(lines) == 1 and lines[0]["img_s"] > 0
    row = _jsonl(str(tmp_path / "s" / "log.txt"))[-1]
    assert np.isfinite(row["train_loss_total"])
    if flag[0] == "--pretrained_path":
        assert "loaded pretrained weights" in text
        # the load itself: a run that trains no epoch returns its weights
        state, _ = _port(search, SEARCH + [
            "--device", "cpu", "--epochs", "1", "--start_epoch", "1",
            "--output_dir", str(tmp_path / "p")] + flag)
        got = dict(state.params.named_parameters())
        for n, p in want.named_parameters():
            if "score" not in n and "decoder" not in n:
                torch.testing.assert_close(got[n], p, rtol=0, atol=0)
        return
    if flag[0] == "--planned-epoch":
        assert "planned-epoch loop" in text
        with pytest.raises(SystemExit, match="cache-device"):
            _port(search, SEARCH + ["--device", "cpu", "--epochs", "1",
                                    "--planned-epoch", "--output_dir",
                                    str(tmp_path / "x")])
    state, text = _port(finetune, [
        "--data-set", "SYNTHETIC", "--tiny-test", "--finetune",
        os.path.join(runs["root"], "port_exported"), "--epochs", "1",
        "--batch-size", "256", "--device", "cpu", "--compute-dtype",
        "float32", "--num_workers", "0", "--output_dir",
        str(tmp_path / "f")] + flag)
    assert len(ck_epoch_lines(text)) == 1
    row = _jsonl(str(tmp_path / "f" / "log.txt"))[-1]
    assert np.isfinite(row["train_loss"])


def ck_epoch_lines(text):
    from ofb_tpu_torch.core.engine import epoch_lines
    return epoch_lines(text)


@pytest.mark.parametrize("module,argv", [
    (search, SEARCH), (finetune, ["--tiny-test"]),
    (export, ["--checkpoint", "x", "--out", "y"]),
    (eval_cli, ["--checkpoint", "x"])])
def test_cuda_is_the_default_device(module, argv):
    args = argparse.ArgumentParser(parents=[module.get_args_parser()]) \
        .parse_args(argv)
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            module.main(args)


def test_synthetic_size_sets_the_finetune_and_eval_sets(tmp_path):
    """--synthetic-size of cli.finetune and cli.eval (as cli.search's)
    sizes SYNTHETIC's train and val sets."""
    state, text = _port(finetune, [
        "--from-scratch", "--tiny-test", "--data-set", "SYNTHETIC",
        "--synthetic-size", "512", "--batch-size", "256", "--epochs", "1",
        "--device", "cpu", "--compute-dtype", "float32", "--num_workers",
        "0", "--no-model-ema", "--output_dir", str(tmp_path / "f")])
    assert int(state.step) == 2 and "Epoch [0] [1/2]" in text
    stats, _ = _port(eval_cli, [
        "--checkpoint", str(tmp_path / "f" / "best"), "--data-set",
        "SYNTHETIC", "--synthetic-size", "256", "--batch-size", "128",
        "--device", "cpu", "--compute-dtype", "float32"])
    # accuracies in steps of one image in 256
    for k in ("acc1", "acc5"):
        assert stats[k] * 256 / 100 == pytest.approx(
            round(stats[k] * 256 / 100), abs=1e-6)
