"""The port's Swin CLIs on the CPU: `cli.search_swin`, `cli.eval` of Swin
checkpoints and `cli.train_swin_dense`, beside the JAX package's
scripts/search_swin.py and scripts/eval.py.

* `cli.search_swin --tiny-test --embed_search` for two epochs (classic loop, --force-finish, --export-finetune-epochs 1): the
  JAX CLI's artifacts (running_ckpt, best, model_exported,
  model_finetuned, log.txt), a Swin meta with the subnet's widths that
  equal the exported tensors; a resumed third epoch; the planned loop
  (--cache-device --planned-epoch) through the same flow;
* `cli.eval` of the port's best/ (gated), model_exported and
  model_finetuned; of the JAX CLI's model_exported and model_finetuned
  against scripts/eval.py on the same directories (loss rel 1e-4, top-1 /
  top-5 within one image in 2048); of a JAX-format Swin-T best/ without
  recorded args (the model from --model, embed search from its alphas);
* `cli.train_swin_dense`: two epochs, then a resume whose later evals are
  worse than the best recorded: the final model is the best/ weights
  restored at the resume (the JAX trainer keeps them in memory only).
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ofb_tpu.core import checkpoint as JCk
from ofb_tpu.models import search_space as JSs
from ofb_tpu.models import swin_search as jss
from ofb_tpu_torch.cli import eval as eval_cli
from ofb_tpu_torch.cli import search_swin, train_swin_dense
from ofb_tpu_torch.cli.common import run_main
from ofb_tpu_torch.core import checkpoint as ck
from ofb_tpu_torch.core.engine import epoch_lines
from ofb_tpu_torch.models import registry as R
from ofb_tpu_torch.models import swin as S
from ofb_tpu_torch.models.from_jax import to_jax

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = ["--data-set", "SYNTHETIC", "--synthetic-size", "64", "--tiny-test",
        "--batch-size", "8", "--num_workers", "0",
        "--compute-dtype", "float32", "--device", "cpu", "--seed", "0"]
SEARCH = PORT + ["--embed_search", "--force-finish",
                 "--export-finetune-epochs", "1", "--ckpt-every", "1"]
EVAL = ["--data-set", "SYNTHETIC", "--compute-dtype", "float32",
        "--batch-size", "512"]


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


def _wait(proc, timeout=900):
    stdout, stderr = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, stderr[-3000:]
    return stdout


def _jax_swin_t_best(path):
    """A JAX-format best/ of a Swin-T supernet with per-stage widths and no
    recorded args (weights drawn by the port, written by the JAX package's
    checkpoint writer)."""
    bundle = R.create_model("swin_tiny_patch4_window7_224_mim", device="cpu",
                            num_classes=1000, embed_search=True)
    params, alphas, _ = bundle.init(3)
    jspace = jss.build_swin_space(jss.SwinCfg(), embed_search=True)
    JCk.save_checkpoint(path, params=to_jax(params), alphas=to_jax(alphas),
                        arch=JSs.ArchState.create(jspace),
                        meta={"epoch": 0, "acc1": 0.0,
                              "finish_search": False, "family": "swin"})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("swin_cli"))
    jdir, pdir = os.path.join(root, "jax"), os.path.join(root, "port")
    jsearch = _jax_script("scripts/search_swin.py", [
        "--data-set", "SYNTHETIC", "--tiny-test", "--epochs", "1",
        "--batch-size", "64", "--compute-dtype", "float32",
        "--compress-thresh", "1.5", "--num_workers", "0", "--embed_search",
        "--force-finish", "--export-finetune-epochs", "1", "--output_dir",
        jdir])
    out = {"root": root, "jdir": jdir, "pdir": pdir, "evals": {}}
    procs = [jsearch]
    try:
        _, out["search_log"] = run_main(search_swin, SEARCH + [
            "--epochs", "2", "--output_dir", pdir])
        _, out["resume_log"] = run_main(search_swin, SEARCH + [
            "--epochs", "3", "--output_dir", pdir, "--resume"])
        _, out["planned_log"] = run_main(search_swin, SEARCH + [
            "--epochs", "1", "--cache-device", "--planned-epoch",
            "--output_dir", os.path.join(root, "planned")])
        for part in ("best", "model_exported", "model_finetuned"):
            out["evals"][part], _ = run_main(eval_cli, EVAL + [
                "--checkpoint", os.path.join(pdir, part), "--device", "cpu",
                "--batch-size", "16", "--synthetic-size", "64"])
        _jax_swin_t_best(os.path.join(root, "jax_swin_t", "best"))
        out["swin_t_eval"], _ = run_main(eval_cli, [
            "--checkpoint", os.path.join(root, "jax_swin_t", "best"),
            "--model", "swin_tiny_patch4_window7_224_mim", "--data-set",
            "SYNTHETIC", "--synthetic-size", "2", "--batch-size", "2",
            "--compute-dtype", "float32", "--device", "cpu"])
        out["jax_search_log"] = _wait(jsearch)
        for part in ("model_exported", "model_finetuned"):
            ckdir = os.path.join(jdir, part)
            jeval = _jax_script("scripts/eval.py", EVAL + [
                "--checkpoint", ckdir])
            procs.append(jeval)
            mine, _ = run_main(eval_cli, EVAL + ["--checkpoint", ckdir,
                                                 "--device", "cpu"])
            theirs = ast.literal_eval(_wait(jeval).strip().splitlines()[-1])
            out["evals"]["jax_" + part] = (mine, theirs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return out


def test_search_swin_writes_the_jax_cli_artifacts(runs):
    pdir, jdir = runs["pdir"], runs["jdir"]
    for d in ("running_ckpt", "best", "model_exported", "model_finetuned"):
        mine, theirs = ck.latest_meta(os.path.join(pdir, d)), \
            ck.latest_meta(os.path.join(jdir, d))
        assert mine["family"] == theirs["family"] == "swin", d
        assert mine["parts"] == theirs["parts"], d
        assert set(theirs) <= set(mine), (d, set(theirs) - set(mine))
    log = [json.loads(line) for line in open(os.path.join(pdir, "log.txt"))]
    jlog = [json.loads(line) for line in open(os.path.join(jdir, "log.txt"))]
    assert set(log[0]) == set(jlog[0])
    assert [r["epoch"] for r in log] == [0, 1, 2]
    text = runs["search_log"]
    assert "force-finish:" in text and "saved model_exported" in text
    assert "finetuned subnet acc1" in text
    for line in epoch_lines(text):
        assert line["img_s"] > 0


def test_exported_meta_holds_the_subnet_widths(runs):
    path = os.path.join(runs["pdir"], "model_exported")
    meta = ck.latest_meta(path)
    assert len(meta["blocks"]) == 2 and len(meta["stage_dims"]) == 2
    model, cfg = ck.swin_from_meta(meta)
    assert cfg.depths == (1, 1)
    ck.load_checkpoint(path, params=model)
    assert model.patch_embed.proj.weight.shape[0] == meta["stage_dims"][0]
    assert [b.mlp.fc1.weight.shape[0] for st in model.stages
            for b in st.blocks] == [b["mlp_hidden"] for b in meta["blocks"]]
    sup = ck.latest_meta(os.path.join(runs["pdir"], "best"))
    assert sup["args"]["embed_search"] and sup["model_cfg"]["depths"] == [1, 1]


def test_resume_continues_at_the_next_epoch(runs):
    text = runs["resume_log"]
    assert "at epoch 2" in text
    # the search epoch 2, then the export finetune's epoch 0
    assert [line["epoch"] for line in epoch_lines(text)] == [2, 0]
    assert ck.latest_meta(os.path.join(runs["pdir"], "running_ckpt"))[
        "epoch"] == 2


def test_planned_epoch_runs_the_same_flow(runs):
    text = runs["planned_log"]
    assert "planned-epoch loop" in text and "saved model_exported" in text
    assert len(epoch_lines(text)) == 2       # the search epoch, the finetune
    meta = ck.latest_meta(os.path.join(runs["root"], "planned",
                                       "model_finetuned"))
    assert meta["exported"] and len(meta["stage_dims"]) == 2


@pytest.mark.parametrize("part", ["best", "model_exported",
                                  "model_finetuned"])
def test_eval_reads_the_port_swin_checkpoints(runs, part):
    stats = runs["evals"][part]
    assert np.isfinite(stats["loss"]) and 0.0 <= stats["acc1"] <= 100.0
    assert stats["acc1"] <= stats["acc5"]


@pytest.mark.parametrize("part", ["model_exported", "model_finetuned"])
def test_eval_matches_jax_eval_script_on_jax_swin_runs(runs, part):
    mine, theirs = runs["evals"]["jax_" + part]
    assert mine["loss"] == pytest.approx(theirs["loss"], rel=1e-4)
    assert abs(mine["acc1"] - theirs["acc1"]) <= 100.0 / 2048 + 1e-9
    assert abs(mine["acc5"] - theirs["acc5"]) <= 100.0 / 2048 + 1e-9


def test_eval_reads_a_jax_swin_t_best_without_args(runs):
    stats = runs["swin_t_eval"]
    assert np.isfinite(stats["loss"])


def test_train_swin_dense_resume_restores_best(tmp_path):
    out = str(tmp_path / "dense")
    argv = PORT + ["--eval-every", "1", "--ckpt-every", "1", "--output_dir",
                   out]
    run_main(train_swin_dense, argv + ["--epochs", "2"])
    for d in ("running_ckpt", "best", "model_finetuned"):
        meta = ck.latest_meta(os.path.join(out, d))
        assert meta["family"] == "swin" and meta["from_scratch"], d
    # a best/ that no later epoch can beat, with weights of its own
    cfg = ck.swin_from_meta(ck.latest_meta(os.path.join(out, "best")))[1]
    best = S.Swin(cfg, generator=torch.Generator().manual_seed(123))
    ck.save_checkpoint(os.path.join(out, "best"), params=best, meta={
        **ck.latest_meta(os.path.join(out, "best")), "acc1": 100.0})
    rmeta = os.path.join(out, "running_ckpt", "meta.json")
    meta = json.load(open(rmeta))
    json.dump({**meta, "best_acc1": 100.0}, open(rmeta, "w"))

    (state, final), text = run_main(train_swin_dense,
                                    argv + ["--epochs", "3", "--resume"])
    assert "resumed" in text and "at epoch 2" in text
    assert [line["epoch"] for line in epoch_lines(text)] == [2]
    saved = S.Swin(cfg)
    ck.load_checkpoint(os.path.join(out, "model_finetuned"), params=saved)
    for (n, a), b, c in zip(best.named_parameters(), final.parameters(),
                            saved.parameters()):
        assert torch.equal(a, b) and torch.equal(a, c), n
    assert ck.latest_meta(os.path.join(out, "model_finetuned"))["acc1"] \
        == 100.0
    # the trained weights are not the best ones
    assert not torch.equal(state.params.head.weight, best.head.weight)
    stats, _ = run_main(eval_cli, EVAL + [
        "--checkpoint", os.path.join(out, "model_finetuned"), "--device",
        "cpu", "--batch-size", "16", "--synthetic-size", "64"])
    assert np.isfinite(stats["loss"])


@pytest.mark.parametrize("module,argv", [
    (search_swin, ["--data-set", "SYNTHETIC", "--tiny-test"]),
    (train_swin_dense, ["--data-set", "SYNTHETIC", "--tiny-test"])])
def test_cuda_is_the_default_device(module, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_main(module, argv + ["--output_dir", ""])
