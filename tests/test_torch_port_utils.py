"""The port's run utilities (ofb_tpu_torch/utils) against ofb_tpu/utils on
the CPU: the log.txt / alpha.txt lines and the score-map dumps of the same
model state (from_jax carries it over), the metric logger's text, and the
auto-resume wrapper's decisions and re-exec command line.

log.txt and alpha.txt lines are equal as parsed JSON (float32 alphas, the
same values); score maps rtol 1e-6 (fp32 softmax / sigmoid on both sides).
"""

import errno
import json
import os
import signal
import sys
import types

import numpy as np
import pytest
import torch

from ofb_tpu.utils import logging as JL
from ofb_tpu.utils import metrics as JM
from ofb_tpu_torch.utils import logging as L
from ofb_tpu_torch.utils import metrics as M
from ofb_tpu_torch.utils import resilience as R
from test_torch_port_from_jax import (TINY, jax_supernet, np_tree,
                                      port_supernet, pruned_arch)

torch.set_num_threads(1)


def test_log_epoch_and_alphas_lines_match_jax(tmp_path):
    _, _, jp, ja, jarch = jax_supernet(TINY, seed=3)
    _, _, params, alphas, arch = port_supernet(TINY, jp, ja, jarch)
    mine, theirs = L.RunLogger(str(tmp_path / "p")), \
        JL.RunLogger(str(tmp_path / "j"))
    train = {"loss_total": 1.5, "img_s": 123.0}
    test = {"loss": 2.0, "acc1": 10.0, "acc5": 50.0}
    for lg, a in ((mine, alphas), (theirs, np_tree(ja))):
        lg.log_epoch(4, train, test, n_parameters=1234, n_gflops=0.5)
        lg.log_alphas(4, a)
    for name in ("log.txt", "alpha.txt"):
        a = [json.loads(x) for x in open(tmp_path / "p" / name)]
        b = [json.loads(x) for x in open(tmp_path / "j" / name)]
        assert a == b, name


def test_score_maps_match_jax(tmp_path):
    jcfg, jspace, jp, ja, jarch = jax_supernet(TINY, seed=4)
    jarch = pruned_arch(jarch)
    cfg, space, params, alphas, arch = port_supernet(TINY, jp, ja, jarch)
    for _ in range(2):                         # the second save is deduped
        L.RunLogger(str(tmp_path / "p")).save_score_maps(params, alphas,
                                                         arch, space)
        JL.RunLogger(str(tmp_path / "j")).save_score_maps(
            np_tree(jp), np_tree(ja), jarch, jspace)
    for name in ("saliency", "sparsity", "joint"):
        a = np.load(tmp_path / "p" / f"{name}.npy", allow_pickle=True).item()
        b = np.load(tmp_path / "j" / f"{name}.npy", allow_pickle=True).item()
        assert set(a) == set(b) == set(range(1 + 2 * TINY["depth"]))
        for k in b:
            assert len(a[k]) == len(b[k]) == 1
            np.testing.assert_allclose(a[k][0], b[k][0], rtol=1e-6,
                                       atol=1e-7, err_msg=f"{name}[{k}]")


def test_metric_logger_text_matches_jax():
    mine, theirs = M.MetricLogger(), JM.MetricLogger()
    for i in range(25):
        for lg in (mine, theirs):
            lg.update(loss=1.0 / (i + 1), acc=float(i))
    assert str(mine) == str(theirs)
    assert mine.averages() == theirs.averages()
    assert mine.meters["loss"].median == theirs.meters["loss"].median


def _run_dir(tmp_path, with_ckpt=True):
    out = tmp_path / "run"
    if with_ckpt:
        (out / "running_ckpt").mkdir(parents=True)
        (out / "running_ckpt" / "meta.json").write_text('{"epoch": 3}')
    return types.SimpleNamespace(output_dir=str(out), auto_resume=2)


def _capture_exec(monkeypatch, module):
    calls = {}

    def fake_execve(path, argv, env):
        calls.update(path=path, argv=argv, env=env)
        raise SystemExit(0)
    monkeypatch.setattr(os, "execve", fake_execve)
    monkeypatch.delenv(R._ENV_LEFT, raising=False)
    main = types.SimpleNamespace(__spec__=types.SimpleNamespace(
        name=module) if module else None)
    monkeypatch.setitem(sys.modules, "__main__", main)
    monkeypatch.setattr(R.sys, "argv", [
        "/repo/ofb_tpu_torch/cli/search.py" if module else "run.py",
        "--epochs", "3", "--resume", "--checkpoint", "old", "--output_dir",
        "x"])
    return calls


def _transient(args):
    raise RuntimeError("DataLoader worker (pid(s) 4242) exited unexpectedly")


class _KilledWorker(torch.utils.data.Dataset):
    """A decode worker that the OOM killer takes."""

    def __len__(self):
        return 4

    def __getitem__(self, i):
        os.kill(os.getpid(), signal.SIGKILL)


def test_auto_resume_fires_on_a_killed_decode_worker(tmp_path, monkeypatch):
    calls = _capture_exec(monkeypatch, "ofb_tpu_torch.cli.search")
    args = _run_dir(tmp_path)

    def run(a):
        list(torch.utils.data.DataLoader(_KilledWorker(), num_workers=1))
    with pytest.raises(SystemExit):
        R.run_with_auto_resume(run, args)
    assert calls["argv"][-3:] == [
        "--resume", "--checkpoint", os.path.join(args.output_dir,
                                                 "running_ckpt")]


@pytest.mark.parametrize("exc, transient", [
    (RuntimeError("DataLoader worker (pid 77) is killed by signal: Killed."),
     True),
    (RuntimeError("CUDA error: uncorrectable ECC error encountered"), True),
    (RuntimeError("CUDA error: CUDA-capable device(s) is/are busy or "
                  "unavailable"), True),
    (OSError(errno.ESTALE, os.strerror(errno.ESTALE), "ckpt/meta.json"),
     True),
    (OSError(errno.ETIMEDOUT, os.strerror(errno.ETIMEDOUT)), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     False),
    (RuntimeError("Caught ValueError in DataLoader worker process 0."),
     False),
    (RuntimeError("backend UNAVAILABLE"), False),
    (KeyError("params"), False),
])
def test_transient_markers(exc, transient):
    assert R.is_transient(exc) is transient


@pytest.mark.parametrize("module", ["ofb_tpu_torch.cli.search", None])
def test_auto_resume_reexecs_the_same_program(tmp_path, monkeypatch,
                                              module):
    calls = _capture_exec(monkeypatch, module)
    args = _run_dir(tmp_path)
    with pytest.raises(SystemExit):
        R.run_with_auto_resume(_transient, args)
    head = ["-m", module] if module else ["run.py"]
    rck = os.path.join(args.output_dir, "running_ckpt")
    assert calls["argv"] == [sys.executable] + head + [
        "--epochs", "3", "--resume", "--checkpoint", "old", "--output_dir",
        "x", "--resume", "--checkpoint", rck]
    assert calls["env"][R._ENV_LEFT] == "1"
    # without a running_ckpt: a fresh start, stale --resume flags stripped
    calls = _capture_exec(monkeypatch, module)
    with pytest.raises(SystemExit):
        R.run_with_auto_resume(_transient, _run_dir(tmp_path / "b", False))
    assert calls["argv"] == [sys.executable] + head + [
        "--epochs", "3", "--output_dir", "x"]


def test_auto_resume_leaves_other_failures_alone(tmp_path, monkeypatch):
    calls = _capture_exec(monkeypatch, "ofb_tpu_torch.cli.search")
    args = _run_dir(tmp_path)
    with pytest.raises(ValueError):
        R.run_with_auto_resume(
            lambda a: (_ for _ in ()).throw(ValueError("bad shape")), args)
    with pytest.raises(SystemExit) as ei:       # the NaN halt
        R.run_with_auto_resume(lambda a: sys.exit(1), args)
    assert ei.value.code == 1
    monkeypatch.setenv(R._ENV_LEFT, "0")        # budget spent
    with pytest.raises(RuntimeError, match="exited unexpectedly"):
        R.run_with_auto_resume(_transient, args)
    assert "argv" not in calls
    R.run_with_auto_resume(lambda a: None, args)
    assert not R._multi_process()
