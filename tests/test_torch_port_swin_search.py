"""The port's searchable Swin (ofb_tpu_torch/models/swin_search.py,
core/swin_steps.py and the Swin branch of core/compress.py) against
ofb_tpu's on the CPU, from the same weights, alphas and arch state
(test_torch_port_swin.py's tiny geometry: two stages of two blocks, so
both stages shift windows and one patch merging joins them).

* The search spaces; the gated forward and every weight's and alpha's
  gradient, with embed search off and on and with head or channel search,
  on an arch state after a compress pass (trimmed and killed cells, a
  converged MLP, w_p mid-anneal), against JAX with its window packing on
  (the default 2) and the forward also with packing off (1);
* the FLOPs model and the arch loss, values and alpha gradients;
* several compress passes with per-stage widths, as
  test_torch_port_compress.py: the same events, alphas, arch state,
  rewritten scores and zeroed moments;
* 3 search steps of 2 accumulated microbatches, then a postsearch step on
  JAX's own Mixup draws, then the gated eval step;
* the planned Swin step: its w_p anneal and gather against JAX's planned
  step with the inner step stubbed (exactly), and the planned step run
  eagerly against the classic composition;
* after forced convergence: the export against JAX's (tensors, stage_dims,
  block meta), gated == fused == sliced, the subnet against JAX's sliced
  forward;
* the two TPU searches of runs/ladder_swin_r5 (alphas and arch state
  only; params from a seed), force-finished by compress(1.0) passes and
  exported to the widths their model_exported/meta.json records.

Tolerances: fp32. Logits and gradients rtol 1e-5 with atol 1e-5 of the
largest magnitude; FLOPs and losses rel 1e-5; compress decisions exactly
(float64 numpy on both sides), rewritten scores rtol 1e-6; the steps as
test_torch_port_step.py's: losses rel 1e-5, grad_norm rel 1e-4,
parameters atol 2e-5, moments rtol 1e-3 + 1e-4 of the leaf's largest
magnitude; the export's tensors rtol 1e-6; gated, fused and sliced logits
atol 3e-4 of the largest magnitude (the JAX package's own export test's).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofb_tpu.core import compress as JC
from ofb_tpu.core import optim as JO
from ofb_tpu.core import steps as JS
from ofb_tpu.core import swin_steps as JSS
from ofb_tpu.models import swin as js
from ofb_tpu.models import swin_search as jss
from ofb_tpu_torch.core import checkpoint as ck
from ofb_tpu_torch.core import compress as C
from ofb_tpu_torch.core import optim as O
from ofb_tpu_torch.core import swin_steps as SS
from ofb_tpu_torch.core.steps import TrainState
from ofb_tpu_torch.models import registry as R
from ofb_tpu_torch.models import swin as S
from ofb_tpu_torch.models import swin_search as SWS
from ofb_tpu_torch.models.from_jax import flatten_from_jax, load_from_jax
from ofb_tpu_torch.ops.mixup import MixupDraws
from test_torch_port_compress import Pair, low, onehot, optimizers
from test_torch_port_from_jax import np_tree
from test_torch_port_mixup import jax_draws
from test_torch_port_step import build_tx, jax_moments, search_cfgs
from test_torch_port_swin import (CFG, close, images, jax_swin_supernet,
                                  port_swin_supernet)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {"joint": {}, "embed": dict(embed_search=True),
            "head": dict(head_search=True, embed_search=True),
            "channel": dict(channel_search=True)}


def _np_alphas(ja):
    return jax.tree_util.tree_map(np.array, ja)


def _pruned_jax(kw, seed=1):
    """A JAX supernet after one compress pass over crafted alphas: trailing
    cells killed (channel, head and width trims), block 0's MLP converged,
    then w_p moved mid-anneal."""
    jcfg, jspace, jp, ja, jarch = jax_swin_supernet(seed=seed, **kw)
    t = _np_alphas(ja)
    for i, b in enumerate(t["blocks"]):
        if b["attn"].size > 1:
            low(b["attn"], np.unravel_index(b["attn"].size - 1,
                                            b["attn"].shape))
        if i == 0:
            onehot(b["mlp"], 2)
        else:
            low(b["mlp"], -1)
    for e in t.get("stage_embeds", []):
        low(e, slice(-2, None))
    ja = jax.tree_util.tree_map(jnp.asarray, t)
    jp, ja, jarch, _, rep = JC.compress(jp, ja, jarch, None, jspace, 0.2)
    assert rep.execute_prune
    jarch = JC.sync_w_p(jarch, 5.0, 20)
    return jcfg, jspace, jp, ja, jarch


def _grad(p):
    """A leaf's gradient; zeros for one no loss reaches (the born-finished
    patch and embed alphas), as jax.grad gives them."""
    return p.grad.numpy() if p.grad is not None else np.zeros(p.shape,
                                                              np.float32)


# ---------------------------------------------------------------------------
# spaces, gated forward and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
def test_spaces_match_jax(variant):
    jspace = jss.build_swin_space(js.SwinCfg(**CFG), **VARIANTS[variant])
    space = SWS.build_swin_space(S.SwinCfg(**CFG), **VARIANTS[variant])
    assert dataclasses.asdict(space) == dataclasses.asdict(jspace)
    np.testing.assert_array_equal(space.blocks[2].attn.mask_bank,
                                  jspace.blocks[2].attn.mask_bank)


@pytest.mark.parametrize("variant", VARIANTS)
def test_gated_forward_and_gradients_match_jax(variant, monkeypatch):
    kw = VARIANTS[variant]
    jcfg, jspace, jp, ja, jarch = _pruned_jax(kw)
    cfg, space, params, alphas, arch = port_swin_supernet(jp, ja, jarch,
                                                          **kw)
    x = images(4, seed=2)
    w = np.random.default_rng(4).normal(size=(4, 10)).astype(np.float32)

    def jfwd(p, a):
        return jss.swin_search_forward(p, a, jarch, jnp.asarray(x), jcfg,
                                       jspace, compute_dtype=jnp.float32)

    monkeypatch.setenv("OFB_SWIN_PACK", "1")
    unpacked = np.asarray(jfwd(jp, ja))
    monkeypatch.setenv("OFB_SWIN_PACK", "2")
    (_, jlogits), (gp, ga) = jax.value_and_grad(
        lambda p, a: (jnp.sum(jfwd(p, a) * w), jfwd(p, a)), argnums=(0, 1),
        has_aux=True)(jp, ja)
    logits = SWS.swin_search_forward(params, alphas, arch,
                                     torch.from_numpy(x), cfg, space,
                                     compute_dtype=torch.float32)
    (logits * torch.from_numpy(w)).sum().backward()
    got = logits.detach().numpy()
    close(got, np.asarray(jlogits), "logits (packed)")
    close(got, unpacked, "logits (unpacked)")
    for module, tree in ((params, gp), (alphas, ga)):
        want = flatten_from_jax(np_tree(tree))
        grads = {n: _grad(p) for n, p in module.named_parameters()}
        assert set(grads) == set(want)
        for n, g in want.items():
            close(grads[n], g, n)
    # the pruned state is really in play
    assert float(arch.blocks[0].mlp.finished) == 1.0
    assert 0.1 < float(arch.blocks[1].mlp.w_p) < 0.99
    if space.stage_embeds:
        assert arch.stage_embeds[0].hard_mask.sum() < 24


@pytest.mark.parametrize("variant", ["joint", "embed"])
def test_flops_and_arch_loss_match_jax(variant):
    kw = VARIANTS[variant]
    jcfg, jspace, jp, ja, jarch = _pruned_jax(kw, seed=3)
    cfg, space, params, alphas, arch = port_swin_supernet(jp, ja, jarch,
                                                          **kw)
    lw = dict(target_flops=0.002, w_head=0.5, w_mlp=0.7, w_embedding=0.3,
              w_flops=5.0)

    def jloss(a):
        loss, aux = JSS.swin_arch_loss(jp, a, jarch, jspace, jcfg, **lw)
        return loss, aux["searched_gflops"]
    (jl, jsearched), jg = jax.value_and_grad(jloss, has_aux=True)(ja)
    jtotal, _ = jss.swin_model_flops(ja, jarch, jspace, jcfg)
    loss, aux = SS.swin_arch_loss(params, alphas, arch, space, cfg, **lw)
    loss.backward()
    total, searched = SWS.swin_model_flops(alphas, arch, space, cfg)
    assert float(total) == pytest.approx(float(jtotal), rel=1e-6)
    assert searched.item() == pytest.approx(float(jsearched), rel=1e-5)
    assert aux["searched_gflops"].item() == searched.item()
    assert loss.item() == pytest.approx(float(jl), rel=1e-5)
    want = flatten_from_jax(np_tree(jg))
    for n, p in alphas.named_parameters():
        close(_grad(p), want[n], n)
    assert float(searched) < float(total)


# ---------------------------------------------------------------------------
# compress with per-stage widths
# ---------------------------------------------------------------------------

class SwinPair(Pair):
    """test_torch_port_compress.py's pair on the Swin supernet."""

    def __init__(self, seed=0, **space_kw):
        self.jcfg, self.jspace, jp, self.ja, self.jarch = jax_swin_supernet(
            seed, **space_kw)
        # ties in every ranking
        self.jp = jax.tree_util.tree_map_with_path(
            lambda path, a: jnp.round(a * 5) / 5
            if path[-1].key in ("score", "embed_score") else a, jp)
        jtx, tx = optimizers()
        self.jopt = jax.tree_util.tree_map(
            lambda x: jnp.ones_like(x), jtx.init((self.jp, self.ja)))
        self.cfg, self.space, self.params, self.alphas, self.arch = \
            port_swin_supernet(self.jp, self.ja, self.jarch, **space_kw)
        self.opt = tx.init(O.named_leaves(self.params, self.alphas))
        for t in list(self.opt.mu.values()) + list(self.opt.nu.values()):
            t.fill_(1.0)
        self.opt.count = 1

    def leaf_objects(self):
        return super().leaf_objects() + [
            t for m in self.arch.stage_embeds for t in vars(m).values()]


def test_compress_passes_with_stage_widths_match_jax():
    pair = SwinPair(embed_search=True, head_search=False)
    jrep, rep = pair.compress()
    assert rep.events == [] and pair.check(jrep, rep) == set()

    # pass 1: trims of stage 0's width, block 2's heads (stage 1: 4 heads),
    # block 0's channels and block 1's MLP; a kill in the middle of stage
    # 1's width
    def craft1(t):
        low(t["stage_embeds"][0], slice(-3, None))
        low(t["stage_embeds"][1], 3)
        low(t["blocks"][0]["attn"], (slice(None), slice(-2, None)))
        low(t["blocks"][2]["attn"], (1, slice(None)))
        low(t["blocks"][1]["mlp"], slice(-2, None))
    pair.craft(craft1)
    pair.jarch = JC.update_w_p(pair.jarch, 3.0, 20)
    C.update_w_p(pair.arch, 3.0, 20)
    jrep, rep = pair.compress()
    assert len(rep.events) == 5 and rep.events[0].startswith("stage0.embed")
    assert not any("converged" in e for e in rep.events)
    assert pair.check(jrep, rep) == {
        "alphas.stage_embeds.0", "alphas.stage_embeds.1",
        "alphas.blocks.0.attn", "alphas.blocks.2.attn",
        "alphas.blocks.1.mlp"}
    assert pair.arch.stage_embeds[0].hard_mask.sum() < 24
    assert int(pair.arch.blocks[2].attn.head_alive) == 2

    # pass 2: convergence of stage 0's width, block 0's attention and block
    # 3's MLP at another w_p (it enters the rewritten scores)
    def craft2(t):
        onehot(t["stage_embeds"][0], 2)
        onehot(t["blocks"][0]["attn"], (0, 3))
        onehot(t["blocks"][3]["mlp"], 1)
    pair.craft(craft2)
    pair.remoment()
    pair.jarch = JC.sync_w_p(pair.jarch, 11.5, 20)
    C.sync_w_p(pair.arch, 11.5, 20)
    jrep, rep = pair.compress()
    assert sum("converged" in e for e in rep.events) == 3
    zeroed = pair.check(jrep, rep)
    assert {"stages.0.embed_score", "stages.0.blocks.0.attn.score",
            "stages.1.blocks.1.mlp.score"} <= zeroed

    # pass 3: everything converges
    def craft3(t):
        for e in t["stage_embeds"]:
            onehot(e, 1)
        for b in t["blocks"]:
            onehot(b["attn"], np.unravel_index(1, b["attn"].shape))
            onehot(b["mlp"], 0)
    pair.craft(craft3)
    jrep, rep = pair.compress()
    pair.check(jrep, rep)
    assert rep.finish_search and pair.arch.all_finished


# ---------------------------------------------------------------------------
# search, postsearch and eval steps
# ---------------------------------------------------------------------------

K, A, MB = 3, 2, 4


@pytest.fixture(scope="module")
def steps():
    jscfg, pscfg = search_cfgs()
    kw = VARIANTS["embed"]
    jcfg, jspace, jp, ja, jarch = jax_swin_supernet(seed=5, **kw)
    cfg, space, params, alphas, arch = port_swin_supernet(jp, ja, jarch,
                                                          **kw)
    # stage 1's width converged: its alpha must stay put
    t = _np_alphas(ja)
    onehot(t["stage_embeds"][1], 4)
    ja = jax.tree_util.tree_map(jnp.asarray, t)
    load_from_jax(alphas, t)
    jp, ja, jarch, _, _ = JC.compress(jp, ja, jarch, None, jspace, 0.2)
    C.compress(params, alphas, arch, None, space, 0.2)
    frozen = alphas.stage_embeds[1].detach().clone()

    jtx, _ = build_tx(JO, jscfg)
    tx, _ = build_tx(O, pscfg)
    jstate = JS.TrainState(step=jnp.asarray(0, jnp.int32), params=jp,
                           alphas=ja, arch=jarch, opt_state=jtx.init((jp, ja)))
    state = TrainState(step=0, params=params, alphas=alphas, arch=arch,
                       opt_state=tx.init(O.named_leaves(params, alphas)))
    rng = np.random.default_rng(9)
    out = {"metrics": [], "frozen": frozen}
    for phase in ("search", "postsearch"):
        jstep = JSS.make_swin_search_step(jspace, jcfg, jscfg, jtx,
                                          phase=phase,
                                          compute_dtype=jnp.float32)
        step = SS.make_swin_search_step(space, cfg, pscfg, tx, phase=phase,
                                        compute_dtype=torch.float32,
                                        device="cpu")
        for k in range(K if phase == "search" else 1):
            x = rng.uniform(0, 1, (A, MB, 32, 32, 3)).astype(np.float32)
            y = rng.integers(0, 10, (A, MB))
            key = jax.random.PRNGKey(100 + k + (50 if phase != "search"
                                                else 0))
            draws = None
            if phase == "postsearch":
                draws = [MixupDraws(*map(torch.from_numpy, jax_draws(
                    jax.random.split(r)[1], MB, 32, 32)))
                    for r in jax.random.split(key, A)]
            jstate, jm = jstep(jstate, x, y, key)
            state, m = step(state, torch.from_numpy(x), torch.from_numpy(y),
                            mixup_draws=draws)
            out["metrics"].append((phase, {n: v.item() for n, v in m.items()},
                                   {n: float(v) for n, v in jm.items()}))
        if phase == "search":
            out["after_search"] = {
                n: p.detach().clone()
                for n, p in O.named_leaves(params, alphas).items()}
            out["jafter_search"] = (np_tree(jstate.params),
                                    np_tree(jstate.alphas))
    x, y = images(6, seed=8), np.arange(6) % 10
    out["eval"] = (
        SS.make_swin_eval_step(space, cfg, compute_dtype=torch.float32,
                               device="cpu")(
            state.params, state.alphas, state.arch, torch.from_numpy(x),
            torch.from_numpy(y)),
        JSS.make_swin_eval_step(jspace, jcfg, compute_dtype=jnp.float32)(
            jstate.params, jstate.alphas, jstate.arch, x, y))
    out.update(state=state, jstate=jstate)
    return out


def test_search_and_postsearch_metrics_match_every_step(steps):
    assert [p for p, _, _ in steps["metrics"]] == ["search"] * K + [
        "postsearch"]
    for k, (phase, mine, theirs) in enumerate(steps["metrics"]):
        keys = SS.SWIN_METRIC_KEYS_SEARCH if phase == "search" \
            else SS.SWIN_METRIC_KEYS_POSTSEARCH
        assert set(mine) == set(theirs) == set(keys)
        for n, v in theirs.items():
            rel = 1e-4 if n == "grad_norm" else 1e-5
            assert mine[n] == pytest.approx(v, rel=rel), (k, n)


def _leaves_match(mine, jparams, jalphas):
    want = flatten_from_jax(jparams)
    want.update({f"alphas.{n}": a for n, a in
                 flatten_from_jax(jalphas).items()})
    assert set(mine) == set(want)
    for n, p in mine.items():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0,
                                   atol=2e-5, err_msg=n)


def test_params_alphas_and_moments_match(steps):
    _leaves_match(steps["after_search"], *steps["jafter_search"])
    st, jst = steps["state"], steps["jstate"]
    assert int(st.step) == int(jst.step) == (K + 1) * A
    _leaves_match(O.named_leaves(st.params, st.alphas), np_tree(jst.params),
                  np_tree(jst.alphas))
    want = jax_moments(jst.opt_state)
    assert set(want) == set(st.opt_state.mu)
    for n, (mu, nu) in want.items():
        for got, ref in ((st.opt_state.mu[n], mu), (st.opt_state.nu[n], nu)):
            np.testing.assert_allclose(
                got.numpy(), ref, rtol=1e-3,
                atol=1e-4 * float(np.abs(ref).max()) + 1e-30, err_msg=n)


def test_finished_stage_width_alpha_is_frozen(steps):
    st = steps["state"]
    assert bool(st.arch.stage_embeds[1].finished)
    assert torch.equal(st.alphas.stage_embeds[1].detach(), steps["frozen"])
    np.testing.assert_array_equal(
        steps["frozen"].numpy(),
        np.asarray(steps["jstate"].alphas["stage_embeds"][1]))
    # an open width's alpha moved
    assert (st.alphas.stage_embeds[0].detach()
            - steps["after_search"]["alphas.stage_embeds.0"]).abs().max() > 0


def test_gated_eval_step_matches_jax(steps):
    mine, theirs = steps["eval"]
    for k in ("loss_sum", "top1", "top5", "count"):
        assert mine[k].item() == pytest.approx(float(theirs[k]), rel=1e-5), k


# ---------------------------------------------------------------------------
# planned Swin step
# ---------------------------------------------------------------------------

STAGING, N, BS, STEPS = 40, 32, 8, 4
AUG = dict(use_randaug=False, re_prob=0.0, hflip=True)


def _plan_data(seed=3):
    rng = np.random.default_rng(seed)
    cache = rng.integers(0, 256, (N, STAGING, STAGING, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, (N,))
    batches = np.stack([rng.permutation(N)[:BS] for _ in range(STEPS)])
    return cache, labels, batches


def test_planned_swin_step_schedule_and_gather_match_jax(monkeypatch):
    jscfg, pscfg = search_cfgs()
    jscfg = dataclasses.replace(jscfg, schedule=dataclasses.replace(
        jscfg.schedule, warmup_epochs=2))
    pscfg = dataclasses.replace(pscfg, schedule=dataclasses.replace(
        pscfg.schedule, warmup_epochs=2))
    kw = VARIANTS["embed"]
    jcfg, jspace, jp, ja, jarch = jax_swin_supernet(**kw)
    cfg, space, params, alphas, arch = port_swin_supernet(jp, ja, jarch,
                                                          **kw)
    cache, labels, batches = _plan_data()
    pos = np.arange(BS).reshape(A, BS // A)

    def jinner(st, imgs, lbls, key):
        return st.replace(step=st.step + A), {
            "loss_param": st.arch.stage_embeds[1].w_p,
            "loss_total": st.arch.blocks[3].mlp.w_p,
            "loss_arch": jnp.sum(lbls * pos).astype(jnp.float32),
            "searched_gflops": jnp.sum(imgs.astype(jnp.float32)),
            "grad_norm": st.arch.blocks[0].attn.w_p}

    seen = []

    def pinner(st, imgs, lbls, generator):
        seen.append(imgs.clone())
        st.step += A
        return st, {"loss_param": st.arch.stage_embeds[1].w_p,
                    "loss_total": st.arch.blocks[3].mlp.w_p,
                    "loss_arch": (lbls * torch.from_numpy(pos)).sum().float(),
                    "searched_gflops": imgs.float().sum(),
                    "grad_norm": st.arch.blocks[0].attn.w_p}

    monkeypatch.setattr(JSS, "make_swin_search_step", lambda *a, **k: jinner)
    monkeypatch.setattr(SS, "make_swin_search_step", lambda *a, **k: pinner)
    jstep, jkeys = JSS.make_planned_swin_search_step(
        jspace, jcfg, jscfg, None, phase="search", steps_per_epoch=STEPS,
        compute_dtype=jnp.float32, **AUG)
    pstep, keys = SS.make_planned_swin_search_step(
        space, cfg, pscfg, None, phase="search", steps_per_epoch=STEPS,
        compute_dtype=torch.float32, device="cpu", **AUG)
    assert keys == jkeys == SS.SWIN_METRIC_KEYS_SEARCH
    state = TrainState(step=0, params=params, alphas=alphas, arch=arch,
                       opt_state=None)
    jstate = JS.TrainState(step=jnp.asarray(0, jnp.int32), params=jp,
                           alphas=ja, arch=jarch, opt_state=None)
    jidx = jnp.asarray(batches.astype(np.int32))
    jlab = jnp.asarray(labels[batches].astype(np.int32))
    for epoch in range(3):
        jbase = jstate.step
        plan = pstep.load_plan(batches, labels, epoch, state.step)
        for it in range(STEPS):
            jstate, jpacked = jstep(jstate, jnp.asarray(cache), jidx, jlab,
                                    jax.random.PRNGKey(0), jbase,
                                    jnp.asarray(epoch, jnp.int32))
            state, packed = pstep(state, torch.from_numpy(cache), plan[0],
                                  plan[1], None, plan[2], plan[3])
            np.testing.assert_array_equal(packed.numpy(),
                                          np.asarray(jpacked),
                                          err_msg=f"epoch {epoch} it {it}")
            np.testing.assert_array_equal(
                seen[-1].numpy(),
                cache[batches[it]].reshape(A, BS // A, STAGING, STAGING, 3))
    assert float(state.arch.stage_embeds[1].w_p) == pytest.approx(0.1,
                                                                  abs=1e-6)


def test_planned_swin_step_matches_classic_composition():
    _, pscfg = search_cfgs()
    kw = VARIANTS["embed"]
    _, _, jp, ja, jarch = jax_swin_supernet(seed=2, **kw)
    cache, labels, batches = _plan_data()
    runs = []
    for planned in (True, False):
        cfg, space, params, alphas, arch = port_swin_supernet(jp, ja, jarch,
                                                              **kw)
        tx, _ = build_tx(O, pscfg)
        state = TrainState(step=0, params=params, alphas=alphas, arch=arch,
                           opt_state=tx.init(O.named_leaves(params, alphas)))
        gen = torch.Generator().manual_seed(11)
        packed = []
        if planned:
            step, keys = SS.make_planned_swin_search_step(
                space, cfg, pscfg, tx, phase="search", steps_per_epoch=STEPS,
                compute_dtype=torch.float32, device="cpu", **AUG)
            plan = step.load_plan(batches, labels, 0, state.step)
            for _ in range(STEPS):
                state, p = step(state, torch.from_numpy(cache), plan[0],
                                plan[1], gen, plan[2], plan[3])
                packed.append(p)
        else:
            cstep = SS.make_swin_search_step(
                space, cfg, pscfg, tx, phase="search",
                compute_dtype=torch.float32, fused_augment=True,
                device="cpu", **AUG)
            micro = STEPS * A
            for it in range(STEPS):
                C.sync_w_p(state.arch, (it * A) / micro,
                           pscfg.schedule.warmup_epochs)
                b = batches[it]
                state, m = cstep(state, torch.from_numpy(
                    cache[b].reshape(A, BS // A, *cache.shape[1:])),
                    torch.from_numpy(labels[b].reshape(A, BS // A)), gen)
                packed.append(torch.stack(
                    [m[k].float() for k in SS.SWIN_METRIC_KEYS_SEARCH]))
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


# ---------------------------------------------------------------------------
# export, fuse, sliced subnet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["embed", "channel"])
def test_export_fuse_and_sliced_match_jax(variant):
    kw = VARIANTS[variant]
    jcfg, jspace, jp, ja, jarch = jax_swin_supernet(seed=6, **kw)
    t = _np_alphas(ja)
    for b in t["blocks"]:
        onehot(b["attn"], np.unravel_index(min(2, b["attn"].size - 1),
                                           b["attn"].shape))
        onehot(b["mlp"], 3)
    for s, e in enumerate(t.get("stage_embeds", [])):
        onehot(e, e.size // 2 - s)
    ja = jax.tree_util.tree_map(jnp.asarray, t)
    cfg, space, params, alphas, arch = port_swin_supernet(jp, ja, jarch,
                                                          **kw)
    jp, ja, jarch, _, jrep = JC.compress(jp, ja, jarch, None, jspace, 0.2)
    *_, rep = C.compress(params, alphas, arch, None, space, 0.2)
    assert rep.finish_search and rep.events == jrep.events

    jdense, _, jmeta = jss.export_swin_subnet(jp, jarch, jspace, jcfg)
    dense, dcfg, meta = SWS.export_swin_subnet(params, arch, space, cfg)
    assert meta == jmeta and dcfg == cfg
    if variant == "embed":
        assert meta["stage_dims"] == [int(a.hard_mask.sum())
                                      for a in arch.stage_embeds]
        assert meta["stage_dims"][0] < 24
    want = flatten_from_jax(np_tree(jdense))
    got = dict(dense.named_parameters())
    assert set(got) == set(want)
    for n, p in got.items():
        assert tuple(p.shape) == want[n].shape, n
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=1e-6,
                                   atol=1e-7, err_msg=n)

    x = images(3, seed=9)
    xt = torch.from_numpy(x)
    f32 = dict(compute_dtype=torch.float32)
    gated = SWS.swin_search_forward(params, alphas, arch, xt, cfg, space,
                                    **f32).detach().numpy()
    fp, farch = SWS.fuse_swin_params(params, arch, space, cfg)
    fused = SWS.swin_search_forward(fp, alphas, farch, xt, cfg, space,
                                    fused=True, **f32).detach().numpy()
    sliced = S.swin_forward(dense, xt, dcfg, **f32).detach().numpy()
    jsliced = np.asarray(js.swin_forward(jdense, jnp.asarray(x), jcfg,
                                         compute_dtype=jnp.float32))
    close(fused, gated, "fused", rtol=1e-3, atol=3e-4)
    close(sliced, gated, "sliced", rtol=1e-3, atol=3e-4)
    close(sliced, jsliced, "sliced vs JAX")
    assert not bool(arch.fused) and bool(farch.fused)


# ---------------------------------------------------------------------------
# the committed TPU searches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("run", ["t0.45", "t0.70"])
def test_ladder_searches_export_to_their_committed_widths(run):
    root = os.path.join(REPO, "runs", "ladder_swin_r5", run)
    bundle = R.create_model("swin_tiny_patch4_window7_224_mim", device="cpu",
                            embed_search=True)
    params, alphas, arch = bundle.init(0)
    with pytest.raises(FileNotFoundError):
        # listed in meta.json, not committed
        ck.load_checkpoint(os.path.join(root, "best"), params=params)
    ck.load_checkpoint(os.path.join(root, "best"), alphas=alphas, arch=arch)
    assert not arch.all_finished
    passes = 0
    while not arch.all_finished and passes < 20:
        C.compress(params, alphas, arch, None, bundle.space, thresh=1.0)
        passes += 1
    dense, dcfg, meta = SWS.export_swin_subnet(params, arch, bundle.space,
                                               bundle.cfg)
    want = ck.latest_meta(os.path.join(root, "model_exported"))
    assert meta["stage_dims"] == want["stage_dims"]
    assert meta["blocks"] == want["blocks"]
    assert dataclasses.asdict(dcfg) == {
        k: tuple(v) if isinstance(v, list) else v
        for k, v in want["model_cfg"].items()}
    # the subnet module has those widths
    assert dense.stages[0].blocks[0].norm1.weight.shape[0] == \
        want["stage_dims"][0]
    assert dense.head.weight.shape[1] == want["stage_dims"][-1]
    assert [b.mlp.fc1.weight.shape[0] for st in dense.stages
            for b in st.blocks] == [b["mlp_hidden"] for b in want["blocks"]]
