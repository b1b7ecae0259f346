"""The port's planned steps and loops (ofb_tpu_torch/core/steps.py
`make_planned_search_step` / `make_planned_train_step`, core/engine.py
`search_one_epoch_planned` / `train_one_epoch_planned`) against
ofb_tpu/core/steps.py and engine.py and against the port's own classic
composition, on the CPU (where a planned step runs eagerly; the CUDA graph
replay runs only on the card, in chip_smoke.py phase 9).

* The device-counter schedules: with the inner step stubbed to report what
  it is handed, the port's planned step and JAX's hand over the same w_p
  and PMIM keep ratio (progressive and not) at every iteration of three
  epochs, exactly in fp32, and gather the same plan rows and labels.
* K planned search steps equal the classic composition (sync_w_p, keep
  schedule, host gather, fused-augment `make_search_step`) drawing from a
  generator with the same seed: metrics rel 1e-5, params and alphas atol
  2e-5 (the same arithmetic on both sides).
* The planned loop against the classic composition over three epochs with
  a compress after every step, crafted kills and a checkpoint resume:
  ArchState bit-identical at every epoch boundary, params and alphas atol
  2e-5, and the same prune events at the same iterations as JAX's
  `search_one_epoch_planned` with the same kills.
* The planned train step against the classic one, and the NaN halt.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofb_tpu.config import OptimFamilyConfig as JFam
from ofb_tpu.config import ScheduleConfig as JSched
from ofb_tpu.config import SearchConfig as JSearchConfig
from ofb_tpu.core import engine as JE
from ofb_tpu.core import optim as JO
from ofb_tpu.core import steps as JS
from ofb_tpu.data.samplers import epoch_batches
from ofb_tpu_torch.config import OptimFamilyConfig, ScheduleConfig, SearchConfig
from ofb_tpu_torch.core import checkpoint as ck
from ofb_tpu_torch.core import compress as C
from ofb_tpu_torch.core import engine as E
from ofb_tpu_torch.core import optim as O
from ofb_tpu_torch.core import steps as S
from ofb_tpu_torch.core.lr_decay import build_finetune_optimizer
from ofb_tpu_torch.models.from_jax import arch_to_numpy, load_from_jax
from ofb_tpu_torch.models.vit import ViT, ModelCfg
from test_torch_port_from_jax import jax_supernet, np_tree, port_supernet

torch.set_num_threads(1)
CFG = dict(img_size=16, patch_size=4, num_classes=4, embed_dim=32, depth=1,
           num_heads=2, mlp_ratio=2.0, drop_path_rate=0.0)
STAGING = 20            # the cache's staging size, above the input size
N, BS, STEPS, A = 32, 8, 4, 2
AUG = dict(use_randaug=False, re_prob=0.0, hflip=True)


def cfgs(**kw):
    common = dict(accum_iter=A, target_flops=0.0002, **kw)
    j = JSearchConfig(schedule=JSched(warmup_epochs=2),
                      optim_param=JFam(lr=1e-3), optim_decoder=JFam(lr=1e-3),
                      optim_arch=JFam(lr=1e-3, betas=(0.5, 0.999)), **common)
    p = SearchConfig(schedule=ScheduleConfig(warmup_epochs=2),
                     optim_param=OptimFamilyConfig(lr=1e-3),
                     optim_decoder=OptimFamilyConfig(lr=1e-3),
                     optim_arch=OptimFamilyConfig(lr=1e-3, betas=(0.5, 0.999)),
                     **common)
    return j.resolve(1), p.resolve(1)


def tx_of(mod, scfg):
    return mod.build_search_optimizer(
        scfg.optim_param, scfg.optim_arch, scfg.optim_decoder, scfg.schedule,
        total_steps=1000, steps_per_epoch=STEPS * A, accum_iter=A)[0]


def data(seed=3):
    rng = np.random.default_rng(seed)
    cache = rng.integers(0, 256, (N, STAGING, STAGING, 3)).astype(np.uint8)
    labels = rng.integers(0, CFG["num_classes"], (N,)).astype(np.int64)
    batches = np.stack(epoch_batches(np.arange(N), BS, drop_last=True)[:STEPS])
    return cache, labels, batches


def port_state(jp, ja, jarch, scfg):
    cfg, space, params, alphas, arch = port_supernet(CFG, jp, ja, jarch)
    tx = tx_of(O, scfg)
    state = S.TrainState(step=0, params=params, alphas=alphas, arch=arch,
                         opt_state=tx.init(O.named_leaves(params, alphas)))
    return cfg, space, tx, state


def epoch_seed(epoch):
    return 100 + epoch


# ---------------------------------------------------------------------------
# schedules and gather, inner step stubbed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("progressive", [True, False])
def test_schedules_and_gather_match_jax_every_iteration(progressive,
                                                        monkeypatch):
    jscfg, pscfg = cfgs(progressive=progressive, max_ratio=0.9,
                        min_ratio=0.6)
    jcfg, jspace, jp, ja, jarch = jax_supernet(CFG)
    cfg, space, tx, state = port_state(jp, ja, jarch, pscfg)
    cache, labels, batches = data()
    # what each side's inner step is handed, packed into the metrics
    pos = np.arange(BS).reshape(A, BS // A)

    def jinner(st, imgs, lbls, key, keep):
        return st.replace(step=st.step + A), {
            "loss_param": jnp.asarray(keep, jnp.float32),
            "loss_total": st.arch.embed.w_p,
            "loss_arch": st.arch.blocks[0].attn.w_p,
            "loss_decoder": jnp.sum(lbls * pos).astype(jnp.float32),
            "searched_gflops": jnp.sum(imgs.astype(jnp.float32)),
            "grad_norm": jnp.float32(0.0)}

    seen = []

    def pinner(st, imgs, lbls, generator, keep):
        seen.append((imgs.clone(), lbls.clone()))
        st.step += A
        return st, {"loss_param": torch.as_tensor(keep, dtype=torch.float32),
                    "loss_total": st.arch.embed.w_p,
                    "loss_arch": st.arch.blocks[0].attn.w_p,
                    "loss_decoder": (lbls * torch.from_numpy(pos)).sum()
                    .float(),
                    "searched_gflops": imgs.float().sum(),
                    "grad_norm": torch.tensor(0.0)}

    monkeypatch.setattr(JS, "make_search_step", lambda *a, **k: jinner)
    monkeypatch.setattr(S, "make_search_step", lambda *a, **k: pinner)
    jstep, jkeys = JS.make_planned_search_step(
        jspace, jcfg, jscfg, None, phase="search", steps_per_epoch=STEPS,
        compute_dtype=jnp.float32, **AUG)
    pstep, keys = S.make_planned_search_step(
        space, cfg, pscfg, tx, phase="search", steps_per_epoch=STEPS,
        compute_dtype=torch.float32, device="cpu", **AUG)
    assert keys == jkeys == JS.METRIC_KEYS_SEARCH

    jstate = JS.TrainState(step=jnp.asarray(0, jnp.int32), params=jp,
                           alphas=ja, arch=jarch, opt_state=None)
    jcache = jnp.asarray(cache)
    jidx = jnp.asarray(batches.astype(np.int32))
    jlab = jnp.asarray(labels[batches].astype(np.int32))
    pcache = torch.from_numpy(cache)
    for epoch in range(3):
        if epoch == 1:
            # a killed patch cell moves the non-progressive keep ratio
            jstate = jstate.replace(arch=jstate.arch.replace(
                patch=jstate.arch.patch.replace(
                    switch=jstate.arch.patch.switch.at[0].set(False))))
            with torch.no_grad():
                state.arch.patch.switch[0] = False
        jbase = jstate.step
        plan = pstep.load_plan(batches, labels, epoch, state.step)
        for it in range(STEPS):
            jstate, jpacked = jstep(jstate, jcache, jidx, jlab,
                                    jax.random.PRNGKey(0), jbase,
                                    jnp.asarray(epoch, jnp.int32))
            state, packed = pstep(state, pcache, plan[0], plan[1], None,
                                  plan[2], plan[3])
            np.testing.assert_array_equal(packed.numpy(),
                                          np.asarray(jpacked),
                                          err_msg=f"epoch {epoch} it {it}")
            imgs, lbls = seen[-1]
            want = cache[batches[it]].reshape(A, BS // A, STAGING, STAGING, 3)
            np.testing.assert_array_equal(imgs.numpy(), want)
            np.testing.assert_array_equal(
                lbls.numpy(), labels[batches[it]].reshape(A, BS // A))
    assert int(state.step) == int(jstate.step) == 3 * STEPS * A
    # the anneal reached its floor (warmup 2 epochs), the keep ratio moved
    assert float(state.arch.embed.w_p) == pytest.approx(0.1, abs=1e-6)


# ---------------------------------------------------------------------------
# planned == the classic composition
# ---------------------------------------------------------------------------

def classic_epoch(state, cstep, cache, labels, batches, scfg, space, epoch,
                  generator, compress_every=None):
    """One planned epoch written out with the classic step: the host's
    w_p sync and keep schedule, the host gather, the fused-augment step;
    the planned loop's compress cadence and boundary syncs. Returns
    (state, prune events, packed metrics)."""
    warm = scfg.schedule.warmup_epochs
    micro = len(batches) * A
    events, packed = [], []
    for it in range(len(batches)):
        frac = epoch + (it * A) / micro
        C.sync_w_p(state.arch, frac, warm)
        keep = S.keep_ratio_schedule(frac, scfg, state.arch, space)
        b = batches[it]
        imgs = torch.from_numpy(cache[b].reshape(A, BS // A, *cache.shape[1:]))
        lbls = torch.from_numpy(labels[b].reshape(A, BS // A))
        state, m = cstep(state, imgs, lbls, generator, keep)
        packed.append(torch.stack([m[k].float()
                                   for k in JS.METRIC_KEYS_SEARCH]))
        if compress_every and (it + 1) % compress_every == 0:
            C.sync_w_p(state.arch, epoch + ((it + 1) * A) / micro, warm)
            p, a, ar, o, rep = C.compress(state.params, state.alphas,
                                          state.arch, state.opt_state, space,
                                          scfg.compress_thresh)
            events.extend(rep.events)
    C.sync_w_p(state.arch, epoch + 1.0, warm)
    return state, events, packed


def test_planned_search_step_matches_classic_composition():
    _, pscfg = cfgs()
    _, _, jp, ja, jarch = jax_supernet(CFG, seed=1)
    cache, labels, batches = data()
    runs = []
    for planned in (True, False):
        cfg, space, tx, state = port_state(jp, ja, jarch, pscfg)
        gen = torch.Generator().manual_seed(11)
        if planned:
            step, keys = S.make_planned_search_step(
                space, cfg, pscfg, tx, phase="search", steps_per_epoch=STEPS,
                compute_dtype=torch.float32, device="cpu", **AUG)
            plan = step.load_plan(batches, labels, 0, state.step)
            packed = []
            for _ in range(STEPS):
                state, p = step(state, torch.from_numpy(cache), plan[0],
                                plan[1], gen, plan[2], plan[3])
                packed.append(p)
        else:
            cstep = S.make_search_step(space, cfg, pscfg, tx, phase="search",
                                       compute_dtype=torch.float32,
                                       fused_augment=True, device="cpu",
                                       **AUG)
            state, _, packed = classic_epoch(state, cstep, cache, labels,
                                             batches, pscfg, space, 0, gen)
        runs.append((state, packed))
    (ps, pp), (cs, cp) = runs
    for a, b in zip(pp, cp):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5)
    assert all(np.isfinite(p.numpy()).all() for p in pp)
    for (n, a), (_, b) in zip(O.named_leaves(ps.params, ps.alphas).items(),
                              O.named_leaves(cs.params, cs.alphas).items()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=0, atol=2e-5, err_msg=n)
    assert int(ps.step) == int(cs.step) == STEPS * A
    assert int(ps.opt_state.count) == STEPS


def _kill_jax(state, module, cell):
    if module == "mlp0":
        al = np.asarray(state.alphas["blocks"][0]["mlp"]).copy()
        al.reshape(-1)[cell] = -8.0
        blocks = list(state.alphas["blocks"])
        blocks[0] = dict(blocks[0], mlp=jnp.asarray(al))
        return state.replace(alphas=dict(state.alphas, blocks=blocks))
    al = np.asarray(state.alphas["embed"]).copy()
    al.reshape(-1)[cell] = -8.0
    return state.replace(alphas=dict(state.alphas, embed=jnp.asarray(al)))


def _kill_port(state, module, cell):
    t = state.alphas.blocks[0].mlp if module == "mlp0" \
        else state.alphas.embed
    with torch.no_grad():
        t.view(-1)[cell] = -8.0


def _prune_lines(lines):
    return [x.strip() for x in lines
            if isinstance(x, str) and "prune event" in x]


def test_planned_loop_equals_classic_across_compress_and_resume(tmp_path):
    jscfg, pscfg = cfgs()
    jscfg = dataclasses.replace(jscfg, compress_per_epoch=STEPS)
    pscfg = dataclasses.replace(pscfg, compress_per_epoch=STEPS)
    jcfg, jspace, jp, ja, jarch = jax_supernet(CFG, seed=2)
    cache, labels, batches = data(4)

    # JAX's planned loop with the same crafted kills: the reference events
    jtx = tx_of(JO, jscfg)
    jstate = JS.TrainState(step=jnp.asarray(0, jnp.int32), params=jp,
                           alphas=ja, arch=jarch,
                           opt_state=jtx.init((jp, ja)))
    jstep, jkeys = JS.make_planned_search_step(
        jspace, jcfg, jscfg, jtx, phase="search", steps_per_epoch=STEPS,
        compute_dtype=jnp.float32, **AUG)
    jstate = _kill_jax(jstate, "mlp0", 0)
    jevents = []
    for epoch in range(3):
        if epoch == 2:
            jstate = _kill_jax(jstate, "embed", 1)
        lines = []
        jstate, _, _, _ = JE.search_one_epoch_planned(
            jstate, jstep, jkeys, jnp.asarray(cache), labels.astype(np.int32),
            list(batches), epoch=epoch, scfg=jscfg, space=jspace,
            rng=jax.random.PRNGKey(100 + epoch), finish_search=False,
            log_every=2, print_fn=lines.append)
        jevents.append(_prune_lines(lines))

    cfg, space, tx, pstate = port_state(jp, ja, jarch, pscfg)
    _, _, ctx, cstate = port_state(jp, ja, jarch, pscfg)
    pstep, keys = S.make_planned_search_step(
        space, cfg, pscfg, tx, phase="search", steps_per_epoch=STEPS,
        compute_dtype=torch.float32, device="cpu", **AUG)
    cstep = S.make_search_step(space, cfg, pscfg, ctx, phase="search",
                               compute_dtype=torch.float32,
                               fused_augment=True, device="cpu", **AUG)
    for st in (pstate, cstate):
        _kill_port(st, "mlp0", 0)
    gen = torch.Generator()             # the planned run's, reseeded
    pcache = torch.from_numpy(cache)
    for epoch in range(3):
        if epoch == 2:
            # resume in the middle: the planned state through a checkpoint,
            # loaded back into the live objects; then crafted kill 2
            d = str(tmp_path / "ck")
            ck.save_checkpoint(d, params=pstate.params, alphas=pstate.alphas,
                               arch=pstate.arch, opt_state=pstate.opt_state,
                               meta={"epoch": epoch})
            ck.load_checkpoint(d, params=pstate.params, alphas=pstate.alphas,
                               arch=pstate.arch, opt_state=pstate.opt_state)
            for st in (pstate, cstate):
                _kill_port(st, "embed", 1)
        lines = []
        gen.manual_seed(epoch_seed(epoch))
        pstate, _, fin, _ = E.search_one_epoch_planned(
            pstate, pstep, keys, pcache, labels, batches, epoch=epoch,
            scfg=pscfg, space=space, generator=gen, finish_search=False,
            log_every=2, print_fn=lines.append)
        cstate, cevents, _ = classic_epoch(
            cstate, cstep, cache, labels, batches, pscfg, space, epoch,
            torch.Generator().manual_seed(epoch_seed(epoch)),
            compress_every=1)
        # the same prune events, at the same iterations, as JAX's loop
        assert _prune_lines(lines) == jevents[epoch]
        assert [e.strip() for e in cevents if "prune event" in e] == \
            jevents[epoch]
        # ArchState bit-identical at the epoch boundary
        pa, ca = arch_to_numpy(pstate.arch), arch_to_numpy(cstate.arch)
        assert set(pa) == set(ca)
        for n in pa:
            np.testing.assert_array_equal(pa[n], ca[n], err_msg=n)
        for (n, a), (_, b) in zip(
                O.named_leaves(pstate.params, pstate.alphas).items(),
                O.named_leaves(cstate.params, cstate.alphas).items()):
            np.testing.assert_allclose(a.detach().numpy(),
                                       b.detach().numpy(), rtol=0, atol=2e-5,
                                       err_msg=f"epoch {epoch} {n}")
    assert any("mlp" in e for e in jevents[0])
    assert any("embed" in e for e in jevents[2])
    assert int(pstate.step) == 3 * STEPS * A


def test_planned_loop_nan_halts():
    """A loss that is not finite in any step's packed metrics ends the run
    (exit code 1), as in the classic loop: uint8 inputs cannot carry a NaN,
    so a weight is poisoned."""
    _, pscfg = cfgs()
    _, _, jp, ja, jarch = jax_supernet(CFG)
    cfg, space, tx, state = port_state(jp, ja, jarch, pscfg)
    cache, labels, batches = data()
    step, keys = S.make_planned_search_step(
        space, cfg, pscfg, tx, phase="search", steps_per_epoch=STEPS,
        compute_dtype=torch.float32, device="cpu", **AUG)
    with torch.no_grad():
        state.params.cls_token.fill_(float("nan"))
    lines = []
    with pytest.raises(SystemExit) as ei:
        E.search_one_epoch_planned(
            state, step, keys, torch.from_numpy(cache), labels, batches,
            epoch=0, scfg=pscfg, space=space,
            generator=torch.Generator().manual_seed(0), finish_search=True,
            log_every=2, print_fn=lines.append)
    assert ei.value.code == 1
    assert any(x.startswith("Loss is nan") for x in lines)


def test_planned_loop_reports_the_classic_epoch_line():
    _, pscfg = cfgs()
    _, _, jp, ja, jarch = jax_supernet(CFG)
    cfg, space, tx, state = port_state(jp, ja, jarch, pscfg)
    cache, labels, batches = data()
    step, keys = S.make_planned_search_step(
        space, cfg, pscfg, tx, phase="search", steps_per_epoch=STEPS,
        compute_dtype=torch.float32, device="cpu", **AUG)
    lines = []
    state, stats, fin, _ = E.search_one_epoch_planned(
        state, step, keys, torch.from_numpy(cache), labels, batches,
        epoch=0, scfg=pscfg, space=space,
        generator=torch.Generator().manual_seed(0), finish_search=False,
        log_every=2, print_fn=lines.append)
    got = E.epoch_lines("\n".join(lines))
    assert len(got) == 1 and got[0]["epoch"] == 0 and got[0]["feed_s"] == 0
    assert np.isfinite(stats["loss_total"]) and stats["img_s"] > 0
    # the epoch-final w_p is the schedule's at the end of the epoch
    assert float(state.arch.embed.w_p) == S.w_p_schedule(1.0, 2)
    # a plan of another shape is refused
    with pytest.raises(ValueError, match="shape"):
        step.load_plan(batches[:2], labels, 1, state.step)


# ---------------------------------------------------------------------------
# planned train step
# ---------------------------------------------------------------------------

def test_planned_train_step_matches_classic():
    from ofb_tpu.models import vit as jvit
    jparams = np_tree(jvit.init_vit_params(jax.random.PRNGKey(0),
                                           jvit.ModelCfg(**CFG)))
    cache, labels, batches = data(5)
    cfg = ModelCfg(**CFG)
    common = dict(num_classes=CFG["num_classes"], smoothing=0.1,
                  compute_dtype=torch.float32, device="cpu", **AUG)
    runs = []
    for planned in (True, False):
        params = load_from_jax(ViT(cfg), jparams)
        tx = build_finetune_optimizer(
            params, lr_schedule=lambda c: 1e-3 * (0.5 ** c), num_layers=1,
            clip_grad=1.0)
        state = S.TrainState(
            step=0, params=params, alphas=None, arch=None,
            opt_state=tx.init(dict(params.named_parameters())))
        gen = torch.Generator().manual_seed(21)
        losses = []
        if planned:
            pstep = S.make_planned_train_step(cfg, tx, accum_iter=A, **common)
            plan = pstep.load_plan(batches, labels, 0, state.step)
            for _ in range(STEPS):
                state, loss = pstep(state, torch.from_numpy(cache), plan[0],
                                    plan[1], gen, plan[2])
                losses.append(float(loss))
        else:
            step = S.make_train_step(cfg, tx, fused_augment=True, **common)
            for b in batches:
                state, m = step(state, torch.from_numpy(
                    cache[b].reshape(A, BS // A, STAGING, STAGING, 3)),
                    torch.from_numpy(labels[b].reshape(A, BS // A)), gen)
                losses.append(float(m["loss"]))
        runs.append((state, losses))
    (ps, pl), (cs, cl) = runs
    np.testing.assert_allclose(pl, cl, rtol=1e-5)
    for (n, a), (_, b) in zip(ps.params.named_parameters(),
                              cs.params.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=0, atol=2e-5, err_msg=n)
    # the loop drives the same step on: a second epoch from where it stood
    lines = []
    state, stats = E.train_one_epoch_planned(
        ps, pstep, torch.from_numpy(cache), labels, batches, epoch=1,
        generator=torch.Generator().manual_seed(2), log_every=2,
        print_fn=lines.append)
    assert np.isfinite(stats["loss"]) and stats["img_s"] > 0
    assert len(E.epoch_lines("\n".join(lines))) == 1
    assert int(state.step) == 2 * STEPS * A
