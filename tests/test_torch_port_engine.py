"""The port's epoch loops (ofb_tpu_torch/core/engine.py) against
ofb_tpu/core/engine.py on the CPU.

`search_one_epoch` on both sides runs over the same feed with the step
stubbed (it records the keep ratio and the w_p it was handed) and
`compress` observed (it records where it ran, kills a patch cell and
reports finish_search at its third pass): the same keep ratio and w_p per
iteration (rel 1e-6, fp32 schedules), compress at the same iterations, the
same finish_search and the same progress lines. The NaN halt runs the
real tiny search step, and `evaluate` is held against JAX's on the same
logits (rel 1e-6).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofb_tpu.config import ScheduleConfig as JSched
from ofb_tpu.config import SearchConfig as JSearchConfig
from ofb_tpu.core import compress as JC
from ofb_tpu.core import engine as JE
from ofb_tpu.core import steps as JS
from ofb_tpu_torch.config import ScheduleConfig, SearchConfig
from ofb_tpu_torch.core import checkpoint as ck
from ofb_tpu_torch.core import compress as C
from ofb_tpu_torch.core import engine as E
from ofb_tpu_torch.core import steps as S
from ofb_tpu_torch.core.optim import build_search_optimizer, named_leaves
from test_torch_port_from_jax import TINY, jax_supernet, port_supernet

torch.set_num_threads(1)
A, MB, STEPS = 2, 3, 7


def cfgs(progressive):
    kw = dict(accum_iter=A, compress_per_epoch=3, progressive=progressive,
              max_ratio=0.95, min_ratio=0.75)
    return (JSearchConfig(schedule=JSched(warmup_epochs=2), **kw),
            SearchConfig(schedule=ScheduleConfig(warmup_epochs=2), **kw))


def run_both(epoch, progressive, monkeypatch, finish_search=False):
    jscfg, scfg = cfgs(progressive)
    _, jspace, jp, ja, jarch = jax_supernet(TINY)
    _, space, params, alphas, arch = port_supernet(TINY, jp, ja, jarch)
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (STEPS, A, MB, 4, 4, 3)).astype(np.float32)
    labels = rng.integers(0, 10, (STEPS, A, MB))
    out = {}
    for side in ("jax", "port"):
        rec, passes, lines = [], [], []

        def note(keep, w_p, loss):
            rec.append((float(keep), float(w_p)))
            return loss * (len(rec) % 3 + 1)

        if side == "jax":
            def step(state, x, y, key, keep):
                v = note(keep, state.arch.embed.w_p, 0.5)
                return state, {"loss_total": jnp.float32(v),
                               "loss_param": jnp.float32(v / 2)}

            def compress(p, a, ar, o, sp, thresh):
                passes.append(len(rec))
                ar = ar.replace(patch=ar.patch.replace(
                    switch=ar.patch.switch.at[len(passes) - 1].set(False)))
                return p, a, ar, o, JC.CompressReport(
                    execute_prune=True, finish_search=len(passes) == 3,
                    events=[f"patch: killed 1 cells"])
            monkeypatch.setattr(JE, "compress", compress)
            state = JS.TrainState(step=jnp.asarray(0), params=jp, alphas=ja,
                                  arch=jarch, opt_state=None)
            feed = ((jnp.asarray(x), jnp.asarray(y))
                    for x, y in zip(images, labels))
            state, stats, fin, pruned = JE.search_one_epoch(
                state, step, feed, epoch=epoch, steps_per_epoch=STEPS,
                scfg=jscfg, space=jspace, rng=jax.random.PRNGKey(0),
                finish_search=finish_search, log_every=3,
                print_fn=lines.append)
        else:
            def step(state, x, y, generator, keep):
                v = note(keep, state.arch.embed.w_p, 0.5)
                return state, {"loss_total": torch.tensor(v),
                               "loss_param": torch.tensor(v / 2)}

            def compress(p, a, ar, o, sp, thresh):
                passes.append(len(rec))
                with torch.no_grad():
                    ar.patch.switch[len(passes) - 1] = False
                return p, a, ar, o, C.CompressReport(
                    execute_prune=True, finish_search=len(passes) == 3,
                    events=[f"patch: killed 1 cells"])
            monkeypatch.setattr(E, "compress", compress)
            state = S.TrainState(0, params, alphas, arch, None)
            feed = ((torch.from_numpy(x), torch.from_numpy(y))
                    for x, y in zip(images, labels))
            state, stats, fin, pruned = E.search_one_epoch(
                state, step, feed, epoch=epoch, steps_per_epoch=STEPS,
                scfg=scfg, space=space, generator=None,
                finish_search=finish_search, log_every=3,
                print_fn=lines.append)
        out[side] = dict(rec=rec, passes=passes, stats=stats, fin=fin,
                         pruned=pruned, lines=lines)
    return out["jax"], out["port"]


@pytest.mark.parametrize("epoch,progressive", [(0, True), (1, True),
                                               (3, True), (1, False)])
def test_search_epoch_matches_jax(epoch, progressive, monkeypatch):
    j, p = run_both(epoch, progressive, monkeypatch)
    assert len(p["rec"]) == len(j["rec"]) == STEPS
    for (k, w), (jk, jw) in zip(p["rec"], j["rec"]):
        assert k == pytest.approx(jk, rel=1e-6)
        assert w == pytest.approx(jw, rel=1e-6)
    # compress every 7 // 3 = 2 iterations until it reports the finish
    assert p["passes"] == j["passes"] == [2, 4, 6]
    assert p["fin"] is j["fin"] is True and p["pruned"] == j["pruned"]
    for k in ("loss_total", "loss_param"):
        assert p["stats"][k] == pytest.approx(j["stats"][k], rel=1e-6)
    assert {"epoch_time_s", "img_s"} <= set(p["stats"])
    # the progress lines of the JAX CLI, word for word (the epoch's closing
    # line and the compress pass's timing line carry times)
    def progress(lines):
        return [x for x in lines if "total" not in x
                and "compress pass" not in x]
    assert progress(p["lines"]) == progress(j["lines"])
    assert sum("Start Compression" in x for x in p["lines"]) == 3
    if not progressive:
        # the keep ratio follows the first active patch cell as compress
        # kills cells
        assert len({k for k, _ in p["rec"]}) == 4


def test_finished_search_runs_no_compress(monkeypatch):
    j, p = run_both(1, True, monkeypatch, finish_search=True)
    assert p["passes"] == j["passes"] == []
    assert p["fin"] is True and p["pruned"] is False


def tiny_search(seed=0):
    _, _, jp, ja, jarch = jax_supernet(TINY, seed=seed)
    cfg, space, params, alphas, arch = port_supernet(TINY, jp, ja, jarch)
    scfg = SearchConfig(accum_iter=1, target_flops=0.0002, epochs=1,
                        compress_per_epoch=1).resolve(1)
    tx, _ = build_search_optimizer(
        scfg.optim_param, scfg.optim_arch, scfg.optim_decoder, scfg.schedule,
        total_steps=100, steps_per_epoch=10)
    state = S.TrainState(0, params, alphas, arch,
                         tx.init(named_leaves(params, alphas)))
    step = S.make_search_step(space, cfg, scfg, tx, phase="search",
                              compute_dtype=torch.float32, device="cpu")
    return cfg, space, scfg, state, step


def test_nan_halts_within_log_window(tmp_path):
    """A loss that is not finite ends the epoch at the window's readback
    (SystemExit 1) and leaves the last checkpoint byte-identical."""
    cfg, space, scfg, state, step = tiny_search()
    cdir = str(tmp_path / "running_ckpt")
    ck.save_checkpoint(cdir, params=state.params, meta={"epoch": 0})
    before = {f: open(os.path.join(cdir, f), "rb").read()
              for f in sorted(os.listdir(cdir))}
    rs = np.random.RandomState(0)
    good = torch.from_numpy(rs.rand(1, 8, 32, 32, 3).astype(np.float32))
    poison = good.clone()
    poison[0, 0, 0, 0, 0] = float("nan")
    lbls = torch.from_numpy(rs.randint(0, 10, (1, 8)))
    seen = []

    def feed():
        for i in range(6):
            seen.append(i)
            yield (poison if i == 1 else good), lbls
    lines = []
    with pytest.raises(SystemExit) as ei:
        E.search_one_epoch(state, step, feed(), epoch=0, steps_per_epoch=6,
                           scfg=scfg, space=space,
                           generator=torch.Generator().manual_seed(2),
                           finish_search=True, log_every=3,
                           print_fn=lines.append)
    assert ei.value.code == 1
    # the window of iterations 1..3 is read back at 3: the run stops there
    assert seen == [0, 1, 2, 3] and lines[-1].startswith("Loss is nan")
    after = {f: open(os.path.join(cdir, f), "rb").read()
             for f in sorted(os.listdir(cdir))}
    assert after == before


def test_train_epoch_runs_and_halts_on_nan():
    lines = []

    def step(state, x, y, generator):
        return state, {"loss": x.sum()}
    good = (torch.ones(1, 2, 1), torch.zeros(1, 2))
    state, stats = E.train_one_epoch(None, step, [good] * 4, epoch=0,
                                     steps_per_epoch=4, generator=None,
                                     print_fn=lines.append)
    assert stats["loss"] == 2.0 and stats["img_s"] > 0
    assert any(x.startswith("Epoch [0] [3/4]") for x in lines)
    bad = (torch.full((1, 2, 1), float("inf")), torch.zeros(1, 2))
    with pytest.raises(SystemExit):
        E.train_one_epoch(None, step, [good, bad], epoch=0,
                          steps_per_epoch=2, generator=None,
                          print_fn=lines.append)


def test_epoch_lines_read_back_what_the_epoch_printed():
    lines = []

    def step(state, x, y, generator):
        return state, {"loss": x.sum()}
    batch = (torch.ones(1, 2, 1), torch.zeros(1, 2))
    for epoch in (3, 4):
        _, stats = E.train_one_epoch(None, step, [batch] * 2, epoch=epoch,
                                     steps_per_epoch=2, generator=None,
                                     print_fn=lines.append)
    got = E.epoch_lines("\n".join(lines + ["Epoch [5] [0/2] loss: 1.0"]))
    assert [e["epoch"] for e in got] == [3, 4]
    assert got[1]["img_s"] == pytest.approx(stats["img_s"], abs=0.05)
    assert all(set(e) == {"epoch", "img_s", "feed_s", "dispatch_s",
                          "readback_s", "compress_s"} for e in got)


def test_evaluate_matches_jax_on_the_same_logits():
    rng = np.random.default_rng(4)
    batches = [(rng.normal(0, 3, (10, 12)).astype(np.float32),
                rng.integers(0, 12, (10,))) for _ in range(3)]
    batches.append((rng.normal(0, 3, (7, 12)).astype(np.float32),
                    rng.integers(0, 12, (7,))))
    jlines, lines = [], []
    jstats = JE.evaluate(JS._cls_metrics,
                         ((jnp.asarray(x), jnp.asarray(y))
                          for x, y in batches), print_fn=jlines.append)
    stats = E.evaluate(S._cls_metrics,
                       ((torch.from_numpy(x), torch.from_numpy(y))
                        for x, y in batches), print_fn=lines.append)
    for k in ("loss", "acc1", "acc5"):
        assert stats[k] == pytest.approx(jstats[k], rel=1e-6)
    assert lines == jlines
