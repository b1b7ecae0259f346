"""The finetune stage of the port against the JAX package's: the dense
train step on an exported subnet (`make_train_step`), the layer-decay
optimizer (core/lr_decay.py), the eval steps, and the optimizer extras
(`PlateauTracker`, `with_lr_scale`, `make_trainable_mask`), the dense
registry factories and `FinetuneConfig`.

The train step: K = 3 calls with accum_iter = 2 (microbatches of 4) on a
subnet of mixed head geometry, Mixup / CutMix on with JAX's own draws
handed to the port, a clip that triggers, layer decay 0.75 and EMA; the
port must end in JAX's params, moments and EMA and report JAX's loss at
every step. Tolerances as in the search-step test: loss rel 1e-5, params
atol 2e-5, moments rtol 1e-3 + 1e-4 of the leaf's largest magnitude.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofb_tpu import config as JCfg
from ofb_tpu.core import export as JE
from ofb_tpu.core import lr_decay as JL
from ofb_tpu.core import optim as JO
from ofb_tpu.core import steps as JS
from ofb_tpu.models import registry as JR
from ofb_tpu_torch import config as Cfg
from ofb_tpu_torch.core import lr_decay as LD
from ofb_tpu_torch.core import optim as O
from ofb_tpu_torch.core import steps as S
from ofb_tpu_torch.core.export import export_subnet
from ofb_tpu_torch.models import registry as R
from ofb_tpu_torch.models.from_jax import (flatten_from_jax, jax_path,
                                           leaf_name, load_moments_from_jax,
                                           moments_from_jax)
from ofb_tpu_torch.models.mim_vit import fuse_params
from ofb_tpu_torch.ops.mixup import MixupDraws
from test_torch_port_export import CASES, converged_pair
from test_torch_port_from_jax import TINY, jax_supernet, np_tree, port_supernet
from test_torch_port_mixup import jax_draws

torch.set_num_threads(1)
K, A, MB = 3, 2, 4


def schedule(count):
    return 2e-3 * (0.5 ** count)


def jschedule(count):
    return 2e-3 * (0.5 ** jnp.asarray(count, jnp.float32))


OPT = dict(betas=(0.9, 0.95), eps=1e-8, weight_decay=0.05, layer_decay=0.75,
           clip_grad=0.5)


def subnets(case, seed=0):
    cfg_kw, cells, distilled = CASES[case]
    (jcfg, jspace, jp, ja, jarch), (cfg, space, params, alphas, arch) = \
        converged_pair(cfg_kw, cells, seed=seed, distilled=distilled)
    jdense, jdcfg, _ = JE.export_subnet(jp, jarch, jspace, jcfg)
    dense, dcfg, _ = export_subnet(params, arch, space, cfg)
    return jdense, jdcfg, dense, dcfg


@pytest.fixture(scope="module", params=["tiny4", "tiny4_distilled"])
def runs(request):
    jdense, jdcfg, dense, dcfg = subnets(request.param)
    init = {n: p.detach().clone() for n, p in dense.named_parameters()}
    nc = dcfg.num_classes
    rng = np.random.default_rng(7)
    images = rng.uniform(0, 1, (K, A, MB, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, nc, (K, A, MB))
    jmix = JCfg.MixupConfig(mixup=0.8, cutmix=1.0, mode="elem", prob=0.9)
    mix = Cfg.MixupConfig(mixup=0.8, cutmix=1.0, mode="elem", prob=0.9)

    jtx = JL.build_finetune_optimizer(jdense, lr_schedule=jschedule,
                                      num_layers=jdcfg.depth, **OPT)
    jstate = JS.TrainState(step=jnp.asarray(0, jnp.int32), params=jdense,
                           alphas=None, arch=None, opt_state=jtx.init(jdense),
                           ema_params=jdense)
    jstep = JS.make_train_step(jdcfg, jtx, num_classes=nc, mixup_cfg=jmix,
                               smoothing=0.1, ema_decay=0.9,
                               compute_dtype=jnp.float32, donate=False)
    jlosses, draws = [], []
    for k in range(K):
        key = jax.random.PRNGKey(40 + k)
        draws.append([MixupDraws(*map(torch.from_numpy, jax_draws(
            jax.random.split(r)[1], MB, 32, 32, mixup_alpha=0.8,
            cutmix_alpha=1.0, mode="elem", prob=0.9)))
            for r in jax.random.split(key, A)])
        jstate, m = jstep(jstate, images[k], labels[k], key)
        jlosses.append(float(m["loss"]))

    tx = LD.build_finetune_optimizer(dense, lr_schedule=schedule,
                                     num_layers=dcfg.depth, **OPT)
    leaves = dict(dense.named_parameters())
    state = S.TrainState(step=0, params=dense, alphas=None, arch=None,
                         opt_state=tx.init(leaves),
                         ema_params={n: p.detach().clone()
                                     for n, p in leaves.items()})
    step = S.make_train_step(dcfg, tx, num_classes=nc, mixup_cfg=mix,
                             smoothing=0.1, ema_decay=0.9,
                             compute_dtype=torch.float32, device="cpu")
    losses = []
    for k in range(K):
        state, m = step(state, torch.from_numpy(images[k]),
                        torch.from_numpy(labels[k]), None,
                        mixup_draws=draws[k])
        assert set(m) == {"loss"}
        losses.append(m["loss"].item())
    return dict(jstate=jstate, state=state, jlosses=jlosses, losses=losses,
                init=init, dcfg=dcfg, jdcfg=jdcfg, draws=draws)


def test_train_step_losses_match_every_step(runs):
    for k, (mine, theirs) in enumerate(zip(runs["losses"], runs["jlosses"])):
        assert mine == pytest.approx(theirs, rel=1e-5), k
    lam = torch.cat([d.lam for ds in runs["draws"] for d in ds])
    assert (lam < 1).any() and len(lam) == K * A * MB


def test_train_step_params_and_ema_match(runs):
    st, jst = runs["state"], runs["jstate"]
    assert st.step == int(jst.step) == K * A
    want = flatten_from_jax(np_tree(jst.params))
    ema = flatten_from_jax(np_tree(jst.ema_params))
    moved = 0
    for n, p in st.params.named_parameters():
        got = p.detach().numpy()
        np.testing.assert_allclose(got, want[n], rtol=0, atol=2e-5, err_msg=n)
        np.testing.assert_allclose(st.ema_params[n].numpy(), ema[n], rtol=0,
                                   atol=2e-5, err_msg=n)
        moved += int(np.abs(got - runs["init"][n].numpy()).max() > 1e-5)
    assert moved > 0.9 * len(want)


def test_train_step_moments_match_and_load(runs):
    st = runs["state"]
    want = moments_from_jax(runs["jstate"].opt_state)
    assert st.opt_state.count == want["count"] == K
    for which in ("mu", "nu"):
        assert set(want[which]) == set(getattr(st.opt_state, which))
        for n, ref in want[which].items():
            np.testing.assert_allclose(
                getattr(st.opt_state, which)[n].numpy(), ref, rtol=1e-3,
                atol=1e-4 * float(np.abs(ref).max()) + 1e-30, err_msg=n)
    # and the other way: JAX's moments loaded into a fresh port state
    fresh = O.AdamWState(count=0, mu={n: torch.zeros_like(t) for n, t in
                                      st.opt_state.mu.items()},
                         nu={n: torch.zeros_like(t) for n, t in
                             st.opt_state.nu.items()})
    load_moments_from_jax(fresh, runs["jstate"].opt_state)
    assert fresh.count == K
    for n, ref in want["nu"].items():
        np.testing.assert_array_equal(fresh.nu[n].numpy(), ref)


def test_eval_steps_match(runs):
    dcfg, jdcfg = runs["dcfg"], runs["jdcfg"]
    rng = np.random.default_rng(8)
    x = rng.uniform(0, 1, (16, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, dcfg.num_classes, (16,))
    jm = JS.make_eval_step_dense(jdcfg, compute_dtype=jnp.float32)(
        runs["jstate"].params, x, y)
    m = S.make_eval_step_dense(dcfg, compute_dtype=torch.float32,
                               device="cpu")(runs["state"].params,
                                             torch.from_numpy(x),
                                             torch.from_numpy(y))
    assert set(m) == set(jm) == {"loss_sum", "top1", "top5", "count"}
    assert all(isinstance(v, torch.Tensor) and v.dtype == torch.float32
               for v in m.values())
    assert m["loss_sum"].item() == pytest.approx(float(jm["loss_sum"]),
                                                 rel=1e-4)
    for k in ("top1", "top5", "count"):
        assert m[k].item() == float(jm[k]), k
    assert m["count"].item() == 16 and m["top5"] >= m["top1"]


@pytest.mark.parametrize("fused", [False, True])
def test_supernet_eval_step_matches(fused):
    from ofb_tpu.models import mim_vit as jmim
    cfg_kw, cells, _ = CASES["tiny4"]
    (jcfg, jspace, jp, ja, jarch), (cfg, space, params, alphas, arch) = \
        converged_pair(cfg_kw, cells, seed=2)
    if fused:
        jp, jarch = jmim.fuse_params(jp, jarch, jspace, jcfg)
        params, arch = fuse_params(params, arch, space, cfg)
    rng = np.random.default_rng(9)
    x = rng.uniform(0, 1, (8, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, cfg.num_classes, (8,))
    jm = JS.make_eval_step(jspace, jcfg, compute_dtype=jnp.float32,
                           fused=fused)(jp, ja, jarch, x, y)
    m = S.make_eval_step(space, cfg, compute_dtype=torch.float32,
                         fused=fused, device="cpu")(
        params, alphas, arch, torch.from_numpy(x), torch.from_numpy(y))
    assert m["loss_sum"].item() == pytest.approx(float(jm["loss_sum"]),
                                                 rel=1e-4)
    for k in ("top1", "top5", "count"):
        assert m[k].item() == float(jm[k]), k


def test_cls_metrics_on_known_logits():
    logits = torch.tensor([[9., 1, 2, 3, 4, 5, 0], [0, 9, 1, 2, 3, 4, 5],
                           [0, 1, 2, 3, 4, 5, 9]])
    labels = torch.tensor([0, 0, 1])
    m = S._cls_metrics(logits, labels)
    jm = JS._cls_metrics(jnp.asarray(logits.numpy()),
                         jnp.asarray(labels.numpy()))
    assert m["top1"].item() == float(jm["top1"]) == 1
    assert m["top5"].item() == float(jm["top5"]) == 1
    assert m["loss_sum"].item() == pytest.approx(float(jm["loss_sum"]),
                                                 rel=1e-6)
    two = S._cls_metrics(torch.tensor([[1., 2.], [3., 0.]]),
                         torch.tensor([0, 0]))
    assert two["top5"].item() == 2 and two["top1"].item() == 1


# ---------------------------------------------------------------------------
# layer decay, plateau scale, masks
# ---------------------------------------------------------------------------

def test_layer_ids_and_scales_match():
    jdense, jdcfg, dense, dcfg = subnets("tiny4_distilled")
    names = {n: p.dim() for n, p in dense.named_parameters()}
    for n, ndim in names.items():
        jn = jax_path(n, ndim, pair=False)
        assert LD.layer_id_for_vit(n, 3) == JL.layer_id_for_vit(jn, 3), n
    assert LD.layer_id_for_vit("cls_token", 12) == 0
    assert LD.layer_id_for_vit("patch_embed.proj.weight", 12) == 0
    assert LD.layer_id_for_vit("blocks.11.mlp.fc2.bias", 12) == 12
    assert LD.layer_id_for_vit("norm.weight", 12) == 12
    assert LD.layer_id_for_vit("head.bias", 12) == 12
    want = flatten_from_jax(np_tree(JL.layer_scale_tree(jdense, 0.75, 3)))
    got = LD.layer_scale_tree(dense, 0.75, 3)
    assert set(got) == set(want)
    for n, s in got.items():
        assert s == pytest.approx(float(want[n]), rel=1e-6), n
    assert got["blocks.0.norm1.weight"] == 0.75 ** 2
    assert got["head.weight"] == 1.0


@pytest.mark.parametrize("layer_decay,clip", [(0.75, 0.5), (None, None),
                                              (1.0, 100.0)])
def test_finetune_optimizer_update_with_lr_scale_matches(layer_decay, clip):
    """One update of the wrapped optimizer from the same gradients, the
    plateau scale set to 0.3: updates to rtol 1e-5 / atol 1e-9."""
    jdense, jdcfg, dense, dcfg = subnets("tiny4")
    kw = dict(OPT, layer_decay=layer_decay, clip_grad=clip)
    rng = np.random.default_rng(1)
    jgrads = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(0, 0.1, a.shape), jnp.float32),
        jdense)
    jtx = JO.with_lr_scale(JL.build_finetune_optimizer(
        jdense, lr_schedule=jschedule, num_layers=3, **kw))
    jst = JO.set_lr_scale(jtx.init(jdense), 0.3)
    jupd, jst = jtx.update(jgrads, jst, jdense)

    tx = O.with_lr_scale(LD.build_finetune_optimizer(
        dense, lr_schedule=schedule, num_layers=3, **kw))
    leaves = dict(dense.named_parameters())
    st = tx.init(leaves)
    scale_tensor = st.scale
    st = O.set_lr_scale(st, 0.3)
    assert st.scale is scale_tensor and st.scale.item() == \
        pytest.approx(0.3)
    grads = {n: torch.from_numpy(a) for n, a in
             flatten_from_jax(np_tree(jgrads)).items()}
    with torch.no_grad():
        upd, st = tx.update(grads, st, leaves)
    want = flatten_from_jax(np_tree(jupd))
    assert isinstance(st, O.LrScaleState) and st.inner.count == 1
    for n, u in upd.items():
        np.testing.assert_allclose(u.numpy(), want[n], rtol=1e-5, atol=1e-9,
                                   err_msg=n)
    assert tx.labels(leaves)["blocks.0.attn.qkv.weight"] == "d"
    assert tx.labels(leaves)["pos_embed"] == "nd"
    # zero_adam_moments reaches through the wrapper
    O.zero_adam_moments(st, lambda n: n == "head.weight")
    assert not st.inner.mu["head.weight"].any()
    assert st.inner.mu["head.bias"].any() and st.inner.count == 1


def test_plateau_tracker_matches_on_a_metric_sequence():
    seq = [70.0, 71.0, 70.5, 70.9, 71.0, 70.2, 72.0, 71.0, 71.5, 71.9, 71.0,
           60.0, 61.0, 59.0, 58.0]
    for kw in (dict(patience=2, decay_rate=0.5),
               dict(patience=1, decay_rate=0.1, min_scale=0.05),
               dict(patience=3, decay_rate=0.5, mode="min")):
        mine, theirs = O.PlateauTracker(**kw), JO.PlateauTracker(**kw)
        got = [mine.update(m) for m in seq]
        assert got == [theirs.update(m) for m in seq]
        assert (mine.best, mine.bad_epochs) == (theirs.best, theirs.bad_epochs)
    assert got[-1] < 1.0


@pytest.mark.parametrize("kw", [
    dict(freeze_weights=False), dict(freeze_weights=True),
    dict(freeze_weights=False, w_head=0.0, w_patch=0.3),
    dict(freeze_weights=True, w_mlp=0.0, w_embedding=0.0),
    dict(freeze_weights=False, searchable_score_paths={
        "patch_embed.score", "blocks.1.mlp.score"})])
def test_trainable_masks_match(kw):
    _, _, jp, ja, jarch = jax_supernet(TINY)
    _, _, params, alphas, _ = port_supernet(TINY, jp, ja, jarch)
    jpm, jam = JO.make_trainable_mask(jp, ja, **kw)
    pm, am = O.make_trainable_mask(params, alphas, **kw)
    want = {leaf_name("0." + JO._path_str(path)): v for path, v in
            jax.tree_util.tree_leaves_with_path(jpm)}
    want_a = {leaf_name("1." + JO._path_str(path)): v for path, v in
              jax.tree_util.tree_leaves_with_path(jam)}
    assert pm == want and am == want_a
    assert set(pm) | set(am) == set(O.named_leaves(params, alphas))


# ---------------------------------------------------------------------------
# registry and config
# ---------------------------------------------------------------------------

def test_dense_factories_and_add_search_params_match():
    names = [n for n in R.list_models() if not n.endswith("_mim")]
    assert len(names) == 18
    for n in names:
        assert n in JR.list_models()
        for kw in (dict(), dict(num_classes=10, embed_dim=336, num_heads=4,
                                head_dim=40, mlp_hidden=960, qk_scale=0.2,
                                drop_path_rate=0.0)):
            b = R.create_model(n, device="cpu", **kw)
            jb = JR.create_model(n, **kw)
            assert b.kind == jb.kind == "dense" and b.space is None
            jd = dataclasses.asdict(jb.cfg)
            assert dataclasses.asdict(b.cfg) == {
                k: jd[k] for k in dataclasses.asdict(b.cfg)}, n
    b = R.create_model("deit_tiny_distilled_patch16_224", device="cpu",
                       num_classes=10)
    model = b.init(0)
    assert type(model).__name__ == "ViT" and hasattr(model, "head_dist")
    sb = R.add_search_params(b, patch_search=False, head_search=True)
    jsb = JR.add_search_params(JR.create_model(
        "deit_tiny_distilled_patch16_224", num_classes=10),
        patch_search=False, head_search=True)
    assert sb.kind == jsb.kind == "mim" and sb.name == jsb.name
    assert sb.space.blocks[0].attn.num_cells == jsb.space.blocks[0].attn.num_cells
    assert sb.space.patch.ratios == jsb.space.patch.ratios
    params = sb.init(0, with_arch=False)
    assert hasattr(params.patch_embed, "score")
    assert len(sb.init(0)) == 3


def test_finetune_config_matches():
    mine, theirs = Cfg.FinetuneConfig(), JCfg.FinetuneConfig()
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    mine.data.batch_size = theirs.data.batch_size = 64
    mine.accum_iter = theirs.accum_iter = 2
    assert mine.resolve(4).lr == theirs.resolve(4).lr == 1.5e-4 * 512 / 256
    assert mine.lr is None


def test_not_ported_options_raise():
    _, jdcfg, dense, dcfg = subnets("tiny4")
    tx = LD.build_finetune_optimizer(dense, lr_schedule=schedule)
    for kw in (dict(fused_augment=True), dict(teacher_apply=lambda x: x)):
        with pytest.raises(NotImplementedError):
            S.make_train_step(dcfg, tx, num_classes=16, device="cpu", **kw)
    step = S.make_train_step(dcfg, tx, num_classes=16, device="cpu",
                             mixup_cfg=Cfg.MixupConfig(mixup=0.8),
                             compute_dtype=torch.float32)
    state = S.TrainState(0, dense, None, None,
                         tx.init(dict(dense.named_parameters())))
    with pytest.raises(ValueError, match="generator"):
        step(state, torch.zeros(1, 2, 32, 32, 3),
             torch.zeros(1, 2, dtype=torch.long))
