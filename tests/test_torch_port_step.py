"""(h) The slice: the port's search step against the JAX package's.

K = 3 calls of `make_search_step` with accum_iter = 2 (microbatches of 4)
from the same weights, alphas, arch state and data, with JAX's PMIM token
masks handed to the port, must end in JAX's params, alphas, Adam moments
and EMA, and report JAX's metrics at every step. The optimizer runs with
a warmup that ends mid-run, a cosine after it, and per-family gradient
clipping that triggers, so every branch of the update is exercised. Also
(g): every weight's optimizer family equals JAX's `label_params`.

Tolerance: fp32 on both sides. Losses and searched GFLOPs to rel 1e-5,
grad_norm to rel 1e-4. Adam divides each moment by its own scale, so
where a gradient is tiny its update is set by its sign and ratio and the
frameworks' summation orders can move it: parameters (which move ~1e-3
a step here) to atol 2e-5, moments to rtol 1e-3 + 1e-4 of the leaf's
largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ofb_tpu.config import OptimFamilyConfig as JFam
from ofb_tpu.config import ScheduleConfig as JSched
from ofb_tpu.config import SearchConfig as JSearchConfig
from ofb_tpu.core import optim as JO
from ofb_tpu.core import steps as JS
from ofb_tpu_torch.config import OptimFamilyConfig, ScheduleConfig, SearchConfig
from ofb_tpu_torch.core import optim as O
from ofb_tpu_torch.core.steps import TrainState, make_search_step
from ofb_tpu_torch.models.from_jax import flatten_from_jax, to_jax
from test_torch_port_from_jax import (TINY, jax_supernet, jax_token_mask,
                                      np_tree, port_supernet)

torch.set_num_threads(1)
K, A, MB, KEEP = 3, 2, 4, 0.75


def search_cfgs():
    common = dict(accum_iter=A, target_flops=0.0002, clip_grad=1.0,
                  w_patch=0.3, model_ema=True, model_ema_decay=0.9)
    sched = dict(warmup_epochs=1, warmup_lr=1e-4, min_lr=1e-5)
    fam = dict(blr=0.05)
    arch = dict(blr=0.5, betas=(0.5, 0.999))
    j = JSearchConfig(optim_param=JFam(**fam), optim_decoder=JFam(**fam),
                      optim_arch=JFam(**arch), schedule=JSched(**sched),
                      **common)
    p = SearchConfig(optim_param=OptimFamilyConfig(**fam),
                     optim_decoder=OptimFamilyConfig(**fam),
                     optim_arch=OptimFamilyConfig(**arch),
                     schedule=ScheduleConfig(**sched), **common)
    for c in (j, p):
        c.data.batch_size = MB
    return j.resolve(1), p.resolve(1)


def build_tx(mod, scfg):
    return mod.build_search_optimizer(
        scfg.optim_param, scfg.optim_arch, scfg.optim_decoder, scfg.schedule,
        total_steps=40, steps_per_epoch=4, clip_grad=scfg.clip_grad,
        accum_iter=scfg.accum_iter)


def find_adam(state):
    if isinstance(state, optax.ScaleByAdamState):
        return state
    if isinstance(state, (tuple, list)):
        for s in state:
            found = find_adam(s)
            if found is not None:
                return found
    return None


def jax_moments(opt_state):
    """{port name: (mu, nu)} merged over the five optax families."""
    out = {}
    for st in opt_state.inner_states.values():
        adam = find_adam(st.inner_state)
        for which, tree in ((0, adam.mu), (1, adam.nu)):
            for prefix, sub in (("", tree[0]), ("alphas.", tree[1])):
                for name, a in flatten_from_jax(np_tree(sub)).items():
                    out.setdefault(prefix + name, [None, None])[which] = a
    return out


@pytest.fixture(scope="module")
def runs():
    jscfg, pscfg = search_cfgs()
    jcfg, jspace, jp, ja, jarch = jax_supernet(TINY, seed=5)
    cfg, space, params, alphas, arch = port_supernet(TINY, jp, ja, jarch)
    init = {n: p.detach().clone() for n, p in
            O.named_leaves(params, alphas).items()}

    rng = np.random.default_rng(9)
    images = rng.uniform(0, 1, (K, A, MB, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, TINY["num_classes"], (K, A, MB))

    jtx, _ = build_tx(JO, jscfg)
    jstate = JS.TrainState(step=jnp.asarray(0, jnp.int32), params=jp,
                           alphas=ja, arch=jarch,
                           opt_state=jtx.init((jp, ja)), ema_params=jp)
    jstep = JS.make_search_step(jspace, jcfg, jscfg, jtx, phase="search",
                                compute_dtype=jnp.float32, donate=False)
    jmetrics, masks = [], []
    for k in range(K):
        key = jax.random.PRNGKey(100 + k)
        masks.append(np.stack([
            jax_token_mask(jax.random.split(r, 3)[1], jcfg, MB, KEEP)
            for r in jax.random.split(key, A)]))
        jstate, m = jstep(jstate, images[k], labels[k], key,
                          jnp.float32(KEEP))
        jmetrics.append({n: float(v) for n, v in m.items()})

    tx, _ = build_tx(O, pscfg)
    state = TrainState(step=0, params=params, alphas=alphas, arch=arch,
                       opt_state=tx.init(O.named_leaves(params, alphas)),
                       ema_params={n: p.detach().clone()
                                   for n, p in params.named_parameters()})
    step = make_search_step(space, cfg, pscfg, tx, compute_dtype=torch.float32,
                            device="cpu")
    metrics = []
    for k in range(K):
        state, m = step(state, torch.from_numpy(images[k]),
                        torch.from_numpy(labels[k]), None, KEEP,
                        token_masks=torch.from_numpy(masks[k]))
        metrics.append({n: v.item() for n, v in m.items()})
    return dict(jstate=jstate, jmetrics=jmetrics, state=state,
                metrics=metrics, init=init, masks=masks)


def test_metrics_match_every_step(runs):
    for k, (mine, theirs) in enumerate(zip(runs["metrics"], runs["jmetrics"])):
        assert set(mine) == set(theirs) == set(JS.METRIC_KEYS_SEARCH)
        for n, v in theirs.items():
            rel = 1e-4 if n == "grad_norm" else 1e-5
            assert mine[n] == pytest.approx(v, rel=rel), (k, n)
    assert all(0 < m.sum() < m.size for m in runs["masks"])
    # clipping triggers for the weights (their gradient norm is above 1)
    assert runs["metrics"][0]["grad_norm"] > 1.0


def test_params_alphas_and_ema_match(runs):
    st, jst = runs["state"], runs["jstate"]
    assert st.step == int(jst.step) == K * A
    mine = O.named_leaves(st.params, st.alphas)
    want = flatten_from_jax(np_tree(jst.params))
    want.update({f"alphas.{n}": a for n, a in
                 flatten_from_jax(np_tree(jst.alphas)).items()})
    assert set(mine) == set(want)
    moved = 0
    for n, p in mine.items():
        got = p.detach().numpy()
        np.testing.assert_allclose(got, want[n], rtol=0, atol=2e-5,
                                   err_msg=n)
        moved += int(np.abs(got - runs["init"][n].numpy()).max() > 1e-4)
    assert moved > 0.9 * len(mine)           # the updates are not negligible
    ema = flatten_from_jax(np_tree(jst.ema_params))
    for n, e in st.ema_params.items():
        np.testing.assert_allclose(e.numpy(), ema[n], rtol=0, atol=2e-5,
                                   err_msg=n)


def test_adam_moments_match(runs):
    st = runs["state"]
    want = jax_moments(runs["jstate"].opt_state)
    assert st.opt_state.count == K
    assert set(want) == set(st.opt_state.mu)
    for n, (mu, nu) in want.items():
        for got, ref in ((st.opt_state.mu[n], mu), (st.opt_state.nu[n], nu)):
            np.testing.assert_allclose(
                got.numpy(), ref, rtol=1e-3,
                atol=1e-4 * float(np.abs(ref).max()) + 1e-30, err_msg=n)


def test_optimizer_families_match_label_params():
    """(g) every weight's family equals JAX's label_params / label_alphas."""
    _, _, jp, ja, jarch = jax_supernet(TINY)
    _, _, params, alphas, _ = port_supernet(TINY, jp, ja, jarch)
    want = {}
    for tree, labels, prefix in ((jp, JO.label_params(jp), ""),
                                 (ja, JO.label_alphas(ja), "alphas.")):
        paths = [n for n in flatten_from_jax(np_tree(tree))]
        leaves = jax.tree_util.tree_leaves(labels)
        want.update({prefix + n: lab for n, lab in zip(paths, leaves)})
    tx, _ = build_tx(O, search_cfgs()[1])
    got = tx.labels(O.named_leaves(params, alphas))
    assert got == want
    assert set(got.values()) == set(O.FAMILIES)
    assert O.label_params(params) == {n: v for n, v in want.items()
                                      if not n.startswith("alphas.")}


@pytest.mark.parametrize("sched", ["cosine", "tanh", "step", "constant"])
def test_schedules_match(sched):
    cfg = JSched(sched=sched, warmup_epochs=2)
    pcfg = ScheduleConfig(sched=sched, warmup_epochs=2)
    jf = JO.make_schedule(1e-3, cfg, 500, 20)
    pf = O.make_schedule(1e-3, pcfg, 500, 20)
    for c in (0, 7, 39, 40, 41, 200, 499, 600):
        assert pf(c) == pytest.approx(float(jf(c)), rel=1e-5, abs=1e-12), c


def test_params_round_trip_after_steps(runs):
    """to_jax of the stepped port model has the JAX tree's structure."""
    back = to_jax(runs["state"].params)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(np_tree(runs["jstate"].params))


def test_step_without_a_random_source_raises():
    """The search phase needs PMIM masks and the postsearch phase Mixup
    draws: from a generator or handed in, never from torch's global
    generator."""
    _, pscfg = search_cfgs()
    _, _, jp, ja, jarch = jax_supernet(TINY)
    cfg, space, params, alphas, arch = port_supernet(TINY, jp, ja, jarch)
    tx, _ = build_tx(O, pscfg)
    state = TrainState(step=0, params=params, alphas=alphas, arch=arch,
                       opt_state=tx.init(O.named_leaves(params, alphas)))
    x = torch.zeros(A, MB, 32, 32, 3)
    y = torch.zeros(A, MB, dtype=torch.long)
    before = torch.get_rng_state()
    for phase in ("search", "postsearch"):
        step = make_search_step(space, cfg, pscfg, tx, phase=phase,
                                compute_dtype=torch.float32, device="cpu")
        with pytest.raises(ValueError, match="generator"):
            step(state, x, y, None, KEEP)
    assert torch.equal(before, torch.get_rng_state())
    assert state.step == 0 and state.opt_state.count == 0
    # with a generator both phases run
    g = torch.Generator().manual_seed(0)
    x = torch.rand(A, MB, 32, 32, 3, generator=g)
    for phase, keys in (("search", JS.METRIC_KEYS_SEARCH),
                        ("postsearch", JS.METRIC_KEYS_POSTSEARCH)):
        step = make_search_step(space, cfg, pscfg, tx, phase=phase,
                                compute_dtype=torch.float32, device="cpu")
        state, m = step(state, x, y, g, KEEP)
        assert set(m) == set(keys)
        assert all(torch.isfinite(v) for v in m.values())


def test_options_that_are_not_ported_raise():
    _, pscfg = search_cfgs()
    cfg, space, _, _, _ = port_supernet(TINY, *jax_supernet(TINY)[2:])
    tx, _ = build_tx(O, pscfg)
    # the teacher is ported: a step with one (and distillation on) runs
    import dataclasses
    from ofb_tpu_torch.config import DistillationConfig
    dcfg = dataclasses.replace(pscfg, distillation=DistillationConfig(
        distillation_type="hard"))
    _, _, jp, ja, jarch = jax_supernet(TINY)
    _, _, params, alphas, arch = port_supernet(TINY, jp, ja, jarch)
    seen = []

    def teacher(images):
        seen.append(images.shape)
        return torch.zeros(images.shape[0], TINY["num_classes"])

    state = TrainState(step=0, params=params, alphas=alphas, arch=arch,
                       opt_state=tx.init(O.named_leaves(params, alphas)))
    state, m = make_search_step(space, cfg, dcfg, tx, device="cpu",
                                teacher_apply=teacher,
                                compute_dtype=torch.float32)(
        state, torch.rand(A, MB, 32, 32, 3), torch.zeros(A, MB,
                                                         dtype=torch.long),
        torch.Generator().manual_seed(0), KEEP)
    assert seen == [(MB, 32, 32, 3)] * A and torch.isfinite(m["loss_total"])
    # fused augmentation is ported: without a generator or draws it raises
    fused = make_search_step(space, cfg, pscfg, tx, device="cpu",
                             fused_augment=True)
    with pytest.raises(ValueError, match="generator"):
        fused(None, torch.zeros(1, 2, 40, 40, 3, dtype=torch.uint8),
              torch.zeros(1, 2, dtype=torch.long))
    with pytest.raises(ValueError, match="phase"):
        make_search_step(space, cfg, pscfg, tx, phase="finetune",
                         device="cpu")


def test_distilled_search_step_matches():
    """A distilled supernet takes the pair loss (CE + CE + KL); one
    accumulated search step against JAX's."""
    jscfg, pscfg = search_cfgs()
    kw = dict(TINY, distilled=True)
    jcfg, jspace, jp, ja, jarch = jax_supernet(kw, seed=8)
    cfg, space, params, alphas, arch = port_supernet(kw, jp, ja, jarch)
    rng = np.random.default_rng(10)
    images = rng.uniform(0, 1, (A, MB, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, TINY["num_classes"], (A, MB))
    jtx, _ = build_tx(JO, jscfg)
    jstate = JS.TrainState(step=jnp.asarray(0, jnp.int32), params=jp,
                           alphas=ja, arch=jarch,
                           opt_state=jtx.init((jp, ja)))
    key = jax.random.PRNGKey(77)
    masks = np.stack([jax_token_mask(jax.random.split(r, 3)[1], jcfg, MB,
                                     KEEP) for r in jax.random.split(key, A)])
    jstate, jm = JS.make_search_step(
        jspace, jcfg, jscfg, jtx, phase="search", compute_dtype=jnp.float32,
        donate=False)(jstate, images, labels, key, jnp.float32(KEEP))
    tx, _ = build_tx(O, pscfg)
    state = TrainState(step=0, params=params, alphas=alphas, arch=arch,
                       opt_state=tx.init(O.named_leaves(params, alphas)))
    state, m = make_search_step(
        space, cfg, pscfg, tx, compute_dtype=torch.float32, device="cpu")(
        state, torch.from_numpy(images), torch.from_numpy(labels), None,
        KEEP, token_masks=torch.from_numpy(masks))
    for n, v in jm.items():
        assert m[n].item() == pytest.approx(
            float(v), rel=1e-4 if n == "grad_norm" else 1e-5), n
    want = flatten_from_jax(np_tree(jstate.params))
    for n, p in state.params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0,
                                   atol=2e-5, err_msg=n)
    assert params.head_dist.weight.grad is None      # cleared by the step


@pytest.mark.parametrize("progressive", [True, False])
def test_keep_ratio_schedule_matches(progressive):
    from ofb_tpu_torch.core.steps import keep_ratio_schedule
    jscfg, pscfg = search_cfgs()
    jscfg.progressive = pscfg.progressive = progressive
    _, jspace, jp, ja, jarch = jax_supernet(TINY)
    jarch = jarch.replace(patch=jarch.patch.replace(
        switch=jarch.patch.switch.at[0].set(False)))
    _, space, _, _, arch = port_supernet(TINY, jp, ja, jarch)
    for frac in (0.0, 0.37, 1.0, 5.0):
        got = keep_ratio_schedule(frac, pscfg, arch, space)
        want = JS.keep_ratio_schedule(frac, jscfg, jarch, jspace)
        assert float(got) == float(want), frac
    assert isinstance(got, torch.Tensor) != progressive


def test_steps_take_both_gating_forms():
    """`gate_fold=False` in the search and eval steps is the same math as
    the default: one search step and one eval from equal states agree
    (loss rel 1e-5, params atol 2e-5)."""
    import copy
    from ofb_tpu_torch.core.steps import make_eval_step
    _, pscfg = search_cfgs()
    _, _, jp, ja, jarch = jax_supernet(TINY, seed=4)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(0, 1, (A, MB, 32, 32, 3)).astype(
        np.float32))
    y = torch.from_numpy(rng.integers(0, TINY["num_classes"], (A, MB)))
    masks = (torch.rand(A, MB, 16, generator=torch.Generator().manual_seed(1))
             < 0.25).float()
    got = []
    for fold in (True, False):
        cfg, space, params, alphas, arch = port_supernet(TINY, jp, ja, jarch)
        tx, _ = build_tx(O, pscfg)
        state = TrainState(step=0, params=params, alphas=alphas, arch=arch,
                           opt_state=tx.init(O.named_leaves(params, alphas)))
        step = make_search_step(space, cfg, pscfg, tx, gate_fold=fold,
                                compute_dtype=torch.float32, device="cpu")
        state, m = step(state, x, y, None, KEEP, token_masks=masks)
        ev = make_eval_step(space, cfg, gate_fold=fold, device="cpu",
                            compute_dtype=torch.float32)(
            params, alphas, arch, x[0], y[0])
        got.append((m, ev, copy.deepcopy(params.state_dict())))
    (m1, e1, p1), (m2, e2, p2) = got
    for k in m1:
        assert m1[k].item() == pytest.approx(m2[k].item(), rel=1e-5), k
    assert e1["loss_sum"].item() == pytest.approx(e2["loss_sum"].item(),
                                                  rel=1e-5)
    for n in p1:
        np.testing.assert_allclose(p1[n].numpy(), p2[n].numpy(), rtol=0,
                                   atol=2e-5, err_msg=n)
