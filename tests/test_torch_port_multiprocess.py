"""The port's data parallelism across real processes: two ranks of a gloo
process group on the CPU (ofb_tpu_torch/parallel/, the all-reduce of
`core/steps.py:_accumulate`, compress consensus, the rank-sharded
`evaluate`, the CLIs under a group), mirroring tests/test_multiprocess.py.
Each rank is a subprocess (`tests/torch_multiproc_worker.py`,
`tests/torch_multiproc_cli_worker.py`) that meets the other through a
`file://` store under tmp_path, so concurrent test workers never share a
port; every wait has a timeout.

* consensus and full-set eval: two ranks, different halves of a global
  batch of 8, K = 2 search steps (A = 2 microbatches, explicit token
  masks, no Mixup); their parameters, alphas and EMA are bit-identical and
  match JAX's one-process `make_search_step` on the concatenated batch
  (the same weights through `from_jax`; fp32, params atol 2e-5 as in
  test_torch_port_step.py, metrics rel 1e-5, grad_norm 1e-4); a compress
  pass where only rank 0 holds a converged alpha gives both ranks rank
  0's digest, the same as one process; the rank-sharded eval reports the
  whole val set's statistics on both ranks, equal to one process's
  (top-1 / top-5 exactly, loss rel 1e-6);
* Mixup across ranks: K = 2 postsearch steps (Mixup 'elem', drop-path,
  the fused augment, every draw from one seeded generator) on two ranks
  equal the same steps in one process on the global batch (atol 2e-5,
  metrics rel 1e-5): each image's partner is its mirror in the global
  batch, on the other rank;
* the CLIs: `cli.search` (2 epochs, converged in the first, postsearch
  and the fuse of best/) then `cli.finetune`, and `cli.search_swin` with
  per-stage widths, each rank made to write its own directories: the
  compress lines and every checkpoint file are rank-identical.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_multiproc_worker as W
from ofb_tpu import config as JC
from ofb_tpu.core import optim as JO
from ofb_tpu.core import steps as JS
from ofb_tpu_torch.models.from_jax import flatten_from_jax
from test_torch_port_from_jax import (TINY, jax_supernet, jax_token_mask,
                                      np_tree)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 600
MB, KEEP = 8, 0.75                 # the global microbatch, 4 on each rank


def _spawn(script, args, tmp_path):
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    for k in ("MASTER_ADDR", "MASTER_PORT", "COORDINATOR_ADDRESS"):
        env.pop(k, None)
    return subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", script), *map(str, args)],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _two_ranks(script, case, tmp_path, *extra):
    rdzv = tmp_path / f"rdzv_{case}"
    procs = [_spawn(script, [case, r, 2, rdzv, *extra], tmp_path)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, (err[-3000:], out[-1500:])
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _last_json(out):
    for line in reversed(out.strip().splitlines()):
        try:
            return json.loads(line)
        except ValueError:
            continue
    raise AssertionError(f"no JSON line in: {out[-1500:]}")


def _weights(cfg_kw, seed):
    """The JAX supernet's (pieces, {npz key: weights in the port's
    layout})."""
    jcfg, jspace, jp, ja, jarch = jax_supernet(cfg_kw, seed=seed)
    data = {"p." + n: a for n, a in flatten_from_jax(np_tree(jp)).items()}
    data.update({"a." + n: a
                 for n, a in flatten_from_jax(np_tree(ja)).items()})
    data["cfg"] = json.dumps(cfg_kw)
    return (jcfg, jspace, jp, ja, jarch), data


def _assert_states_close(got, want, atol=2e-5):
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=0, atol=atol,
                                   err_msg=n)


def _metrics_close(mine, theirs):
    for k, (m, t) in enumerate(zip(mine, theirs)):
        assert set(m) == set(t), k
        for n, v in t.items():
            rel = 1e-4 if n == "grad_norm" else 1e-5
            assert m[n] == pytest.approx(v, rel=rel), (k, n)


def _rank_states(tmp_path):
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]


def test_two_process_consensus_and_full_set_eval(tmp_path):
    (jcfg, jspace, jp, ja, jarch), data = _weights(TINY, seed=5)
    rng = np.random.default_rng(11)
    data["images"] = rng.uniform(0, 1, (W.K, W.A, MB, 32, 32, 3)) \
        .astype(np.float32)
    data["labels"] = rng.integers(0, TINY["num_classes"], (W.K, W.A, MB))
    data["val_images"] = rng.uniform(0, 1, (32, 32, 32, 3)) \
        .astype(np.float32)
    data["val_labels"] = rng.integers(0, TINY["num_classes"], (32,))
    data["keep"] = np.float32(KEEP)
    keys = [jax.random.PRNGKey(200 + k) for k in range(W.K)]
    data["masks"] = np.stack([np.stack([
        jax_token_mask(jax.random.split(r, 3)[1], jcfg, MB, KEEP)
        for r in jax.random.split(key, W.A)]) for key in keys])
    npz = tmp_path / "data.npz"
    np.savez(npz, **data)
    procs = [_spawn("torch_multiproc_worker.py",
                    ["search", r, 2, tmp_path / "rdzv", npz, tmp_path],
                    tmp_path) for r in range(2)]

    # meanwhile: JAX's one-process step on the concatenated batch
    jscfg = W.search_cfg(JC)
    jtx, _ = W.build_tx(JO, jscfg)
    jstate = JS.TrainState(step=jnp.asarray(0, jnp.int32), params=jp,
                           alphas=ja, arch=jarch,
                           opt_state=jtx.init((jp, ja)), ema_params=jp)
    jstep = JS.make_search_step(jspace, jcfg, jscfg, jtx, phase="search",
                                compute_dtype=jnp.float32, donate=False)
    jmetrics = []
    for k in range(W.K):
        jstate, m = jstep(jstate, data["images"][k], data["labels"][k],
                          keys[k], jnp.float32(KEEP))
        jmetrics.append({n: float(v) for n, v in m.items()})
    want = flatten_from_jax(np_tree(jstate.params))
    want.update({"alphas." + n: a for n, a in
                 flatten_from_jax(np_tree(jstate.alphas)).items()})
    want.update({"ema." + n: a for n, a in
                 flatten_from_jax(np_tree(jstate.ema_params)).items()})
    want["step"] = np.asarray(int(jstate.step))

    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, (err[-3000:], out[-1500:])
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    r0, r1 = (_last_json(o) for o in outs)
    s0, s1 = _rank_states(tmp_path)

    # the two ranks hold one state, bit for bit
    assert set(s0) == set(s1)
    for n in s0:
        assert np.array_equal(s0[n], s1[n]), n
    assert r0["metrics"] == r1["metrics"]
    # and it is JAX's one-process step on the global batch
    _assert_states_close(s0, want)
    _metrics_close(r0["metrics"], jmetrics)

    # compress: rank 1 took rank 0's decisions
    assert r0["digest"] == r1["digest"]
    assert r0["events"] == r1["events"]
    # full-set eval statistics on both ranks
    assert r0["eval"] == r1["eval"]

    # the same in one process, no group, on the whole batch
    single, rs = W.run("search", np.load(npz))
    _assert_states_close(single, s0)
    assert rs["digest"] == r0["digest"]
    assert rs["eval"]["acc1"] == r0["eval"]["acc1"]
    assert rs["eval"]["acc5"] == r0["eval"]["acc5"]
    assert rs["eval"]["loss"] == pytest.approx(r0["eval"]["loss"], rel=1e-6)


def test_two_process_mixup_pairs_across_ranks(tmp_path):
    cfg_kw = dict(TINY, drop_path_rate=0.1)
    _, data = _weights(cfg_kw, seed=6)
    rng = np.random.default_rng(12)
    data["images"] = rng.integers(0, 256, (W.K, W.A, MB, 40, 40, 3),
                                  dtype=np.uint8)
    data["labels"] = rng.integers(0, TINY["num_classes"], (W.K, W.A, MB))
    npz = tmp_path / "data.npz"
    np.savez(npz, **data)
    outs = _two_ranks("torch_multiproc_worker.py", "mixup", tmp_path, npz,
                      tmp_path)
    r0, r1 = (_last_json(o) for o in outs)
    s0, s1 = _rank_states(tmp_path)
    for n in s0:
        assert np.array_equal(s0[n], s1[n]), n
    single, rs = W.run("mixup", np.load(npz))
    _assert_states_close(s0, single)
    _metrics_close(r0["metrics"], rs["metrics"])
    # the step moved the weights: the comparison is not of the start
    start = data["p.blocks.0.mlp.fc1.weight"]
    assert np.abs(s0["blocks.0.mlp.fc1.weight"] - start).max() > 1e-5


@pytest.mark.parametrize("case", ["vit", "swin"])
def test_two_process_cli_search_and_finetune(case, tmp_path):
    outs = _two_ranks("torch_multiproc_cli_worker.py", case, tmp_path,
                      tmp_path / "cli")

    def digests(out):
        for ln in out.splitlines():
            if ln.startswith("CLI_DIGEST "):
                return json.loads(ln[len("CLI_DIGEST "):])
        raise AssertionError(f"no CLI_DIGEST line: {out[-1500:]}")

    d0, d1 = digests(outs[0]), digests(outs[1])
    for r, d in enumerate((d0, d1)):
        lines = d.pop("world_lines")
        assert lines and all(f"rank {r} of world 2, backend gloo" in ln
                             for ln in lines), lines
    assert d0["compress_lines"], "the search compressed"
    if case == "swin":
        # the per-stage residual widths took decisions too
        assert any("stage0.embed" in ln for ln in d0["compress_lines"]), \
            d0["compress_lines"]
    assert d0 == d1
    for part, files in d0.items():
        if part != "compress_lines":
            assert any(f.endswith(".pt") for f in files), (part, files)
