"""The search lifecycle end to end, the port against the JAX package:

    2 search steps -> crafted alphas -> compress (a forced prune to
    convergence, moments zeroed) -> K = 3 postsearch steps (Mixup on,
    decoder frozen) -> fuse_params -> fused eval -> export_subnet ->
    3 dense train steps (layer-decay AdamW, Mixup, EMA) -> dense eval

run once with the static update masks off on a plain model and once with
them on (`freeze_weights`, a zero loss weight) on a distilled model. Both
sides start from the same weights; JAX's PMIM masks and Mixup draws are
handed to the port. Each stage starts from the port's own previous stage,
so differences add up along the way.

Tolerance: fp32 on both sides. Metrics rel 1e-4 (grad_norm 1e-3); params,
alphas and EMA atol 5e-5 after the supernet steps and 1e-4 after the dense
steps (an Adam update is set by the gradient's sign where the gradient is
tiny, and the learning rates here are 1e-2 and up); moments rtol 1e-3 +
1e-3 of the leaf's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofb_tpu.core import compress as JC
from ofb_tpu.core import export as JE
from ofb_tpu.core import lr_decay as JL
from ofb_tpu.core import optim as JO
from ofb_tpu.core import steps as JS
from ofb_tpu.models import mim_vit as jmim
from ofb_tpu_torch.core import compress as C
from ofb_tpu_torch.core import lr_decay as LD
from ofb_tpu_torch.core import optim as O
from ofb_tpu_torch.core import steps as S
from ofb_tpu_torch.core.export import export_subnet
from ofb_tpu_torch.models.from_jax import (arch_to_numpy, flatten_from_jax,
                                           load_from_jax, moments_from_jax)
from ofb_tpu_torch.models.mim_vit import fuse_params
from ofb_tpu_torch.ops.mixup import MixupDraws
from test_torch_port_from_jax import (TINY, jax_supernet, jax_token_mask,
                                      np_tree, port_supernet)
from test_torch_port_mixup import jax_draws
from test_torch_port_step import build_tx, search_cfgs

torch.set_num_threads(1)
A, MB, KEEP = 2, 4, 0.75
TINY4 = dict(TINY, num_heads=4)
CELLS = [((0, 3), 4), ((1, 5), 1)]        # (attn cell, mlp cell) per block


def leaves_close(module, tree, atol, prefix=""):
    want = flatten_from_jax(np_tree(tree))
    for n, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0,
                                   atol=atol, err_msg=prefix + n)


def moments_close(opt_state, jopt_state):
    want = moments_from_jax(jopt_state)
    assert opt_state.count == want["count"]
    for which in ("mu", "nu"):
        for n, ref in want[which].items():
            np.testing.assert_allclose(
                getattr(opt_state, which)[n].numpy(), ref, rtol=1e-3,
                atol=1e-3 * float(np.abs(ref).max()) + 1e-30, err_msg=n)


def metrics_close(mine, theirs):
    assert set(mine) == set(theirs)
    for n, v in theirs.items():
        rel = 1e-3 if n == "grad_norm" else 1e-4
        assert mine[n].item() == pytest.approx(float(v), rel=rel), n


@pytest.fixture(scope="module", params=["masks_off", "masks_on_distilled"])
def life(request):
    masks_on = request.param != "masks_off"
    cfg_kw = dict(TINY4, distilled=masks_on)
    jscfg, pscfg = search_cfgs()
    jcfg, jspace, jp, ja, jarch = jax_supernet(cfg_kw, seed=6)
    cfg, space, params, alphas, arch = port_supernet(cfg_kw, jp, ja, jarch)
    jpm = jam = pm = am = None
    if masks_on:
        mk = dict(freeze_weights=True, w_mlp=0.0, w_patch=0.3)
        jpm, jam = JO.make_trainable_mask(jp, ja, **mk)
        pm, am = O.make_trainable_mask(params, alphas, **mk)
    rng = np.random.default_rng(12)
    nc = cfg.num_classes

    def data(k):
        return (rng.uniform(0, 1, (k, A, MB, 32, 32, 3)).astype(np.float32),
                rng.integers(0, nc, (k, A, MB)))

    jtx, _ = build_tx(JO, jscfg)
    tx, _ = build_tx(O, pscfg)
    jstate = JS.TrainState(step=jnp.asarray(0, jnp.int32), params=jp,
                           alphas=ja, arch=jarch,
                           opt_state=jtx.init((jp, ja)), ema_params=jp)
    state = S.TrainState(step=0, params=params, alphas=alphas, arch=arch,
                         opt_state=tx.init(O.named_leaves(params, alphas)),
                         ema_params={n: p.detach().clone()
                                     for n, p in params.named_parameters()})
    out = dict(cfg=cfg, space=space, masks_on=masks_on)

    # --- two search steps ------------------------------------------------
    jstep = JS.make_search_step(jspace, jcfg, jscfg, jtx, phase="search",
                                param_mask=jpm, alpha_mask=jam,
                                compute_dtype=jnp.float32, donate=False)
    step = S.make_search_step(space, cfg, pscfg, tx, phase="search",
                              param_mask=pm, alpha_mask=am,
                              compute_dtype=torch.float32, device="cpu")
    images, labels = data(2)
    for k in range(2):
        key = jax.random.PRNGKey(200 + k)
        masks = np.stack([jax_token_mask(jax.random.split(r, 3)[1], jcfg, MB,
                                         KEEP)
                          for r in jax.random.split(key, A)])
        jstate, jm = jstep(jstate, images[k], labels[k], key,
                           jnp.float32(KEEP))
        state, m = step(state, torch.from_numpy(images[k]),
                        torch.from_numpy(labels[k]), None, KEEP,
                        token_masks=torch.from_numpy(masks))
        metrics_close(m, jm)
    out["search_alphas"] = {n: p.detach().clone()
                            for n, p in alphas.named_parameters()}

    # --- crafted alphas, one compress pass to convergence ----------------
    tree = jax.tree_util.tree_map(np.array, jstate.alphas)

    def onehot(a, idx):
        a[...] = -8.0
        a[idx] = 8.0
    onehot(tree["embed"], 5)
    onehot(tree["patch"], 2)
    for b, (at, ml) in zip(tree["blocks"], CELLS):
        onehot(b["attn"], at)
        onehot(b["mlp"], ml)
    jstate = jstate.replace(alphas=jax.tree_util.tree_map(jnp.asarray, tree))
    load_from_jax(state.alphas, tree)
    jstate = jstate.replace(arch=JC.sync_w_p(jstate.arch, 7.0, 20))
    C.sync_w_p(state.arch, 7.0, 20)
    jp2, ja2, jarch2, jopt2, jrep = JC.compress(
        jstate.params, jstate.alphas, jstate.arch, jstate.opt_state, jspace)
    jstate = jstate.replace(params=jp2, alphas=ja2, arch=jarch2,
                            opt_state=jopt2)
    objects = [id(p) for p in O.named_leaves(params, alphas).values()]
    _, _, _, _, rep = C.compress(state.params, state.alphas, state.arch,
                                 state.opt_state, space)
    assert objects == [id(p) for p in
                       O.named_leaves(state.params, state.alphas).values()]
    out.update(rep=rep, jrep=jrep)
    out["after_compress"] = dict(
        arch=arch_to_numpy(state.arch), jarch=arch_to_numpy(jstate.arch),
        zero_mu={n for n, t in state.opt_state.mu.items() if not t.any()})
    moments_close(state.opt_state, jstate.opt_state)

    # --- K = 3 postsearch steps -------------------------------------------
    frozen = {n: p.detach().clone() for n, p in params.named_parameters()
              if n.startswith("decoder.") or n == "mask_token"}
    jstep = JS.make_search_step(jspace, jcfg, jscfg, jtx, phase="postsearch",
                                param_mask=jpm, alpha_mask=jam,
                                compute_dtype=jnp.float32, donate=False)
    step = S.make_search_step(space, cfg, pscfg, tx, phase="postsearch",
                              param_mask=pm, alpha_mask=am,
                              compute_dtype=torch.float32, device="cpu")
    images, labels = data(3)
    out["post_metrics"] = []
    for k in range(3):
        key = jax.random.PRNGKey(300 + k)
        draws = [MixupDraws(*map(torch.from_numpy, jax_draws(
            jax.random.split(r, 3)[2], MB, 32, 32)))
            for r in jax.random.split(key, A)]
        jstate, jm = jstep(jstate, images[k], labels[k], key,
                           jnp.float32(KEEP))
        state, m = step(state, torch.from_numpy(images[k]),
                        torch.from_numpy(labels[k]), None, KEEP,
                        mixup_draws=draws)
        out["post_metrics"].append((m, jm))
    out.update(state=state, jstate=jstate, frozen=frozen)

    # --- fuse, fused and gated eval ----------------------------------------
    x = rng.uniform(0, 1, (8, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, nc, (8,))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    jfp, jfarch = jmim.fuse_params(jstate.params, jstate.arch, jspace, jcfg)
    fp, farch = fuse_params(state.params, state.arch, space, cfg)
    ev = dict(compute_dtype=torch.float32, device="cpu")
    out["eval_fused"] = (
        S.make_eval_step(space, cfg, fused=True, **ev)(fp, alphas, farch, xt,
                                                       yt),
        JS.make_eval_step(jspace, jcfg, compute_dtype=jnp.float32,
                          fused=True)(jfp, jstate.alphas, jfarch, x, y))
    out["eval_gated"] = S.make_eval_step(space, cfg, **ev)(
        state.params, alphas, state.arch, xt, yt)

    # --- export, 3 dense train steps, dense eval ---------------------------
    jdense, jdcfg, jmeta = JE.export_subnet(jstate.params, jstate.arch,
                                            jspace, jcfg)
    dense, dcfg, meta = export_subnet(state.params, state.arch, space, cfg)
    out.update(meta=meta, jmeta=jmeta, dcfg=dcfg,
               dense0={n: p.detach().clone()
                       for n, p in dense.named_parameters()},
               jdense0=jdense)
    out["eval_sliced"] = S.make_eval_step_dense(dcfg, **ev)(dense, xt, yt)
    opt = dict(weight_decay=0.05, layer_decay=0.75, clip_grad=1.0,
               num_layers=cfg.depth)
    jftx = JL.build_finetune_optimizer(
        jdense, lr_schedule=lambda c: 1e-2 * 0.7 ** jnp.asarray(
            c, jnp.float32), **opt)
    ftx = LD.build_finetune_optimizer(
        dense, lr_schedule=lambda c: 1e-2 * 0.7 ** c, **opt)
    from ofb_tpu import config as JCfg
    from ofb_tpu_torch import config as Cfg
    jft = JS.make_train_step(
        jdcfg, jftx, num_classes=nc,
        mixup_cfg=JCfg.MixupConfig(mixup=0.8, cutmix=1.0, mode="pair"),
        ema_decay=0.9, compute_dtype=jnp.float32, donate=False)
    ft = S.make_train_step(
        dcfg, ftx, num_classes=nc,
        mixup_cfg=Cfg.MixupConfig(mixup=0.8, cutmix=1.0, mode="pair"),
        ema_decay=0.9, compute_dtype=torch.float32, device="cpu")
    jfstate = JS.TrainState(step=jnp.asarray(0, jnp.int32), params=jdense,
                            alphas=None, arch=None,
                            opt_state=jftx.init(jdense), ema_params=jdense)
    dleaves = dict(dense.named_parameters())
    fstate = S.TrainState(0, dense, None, None, ftx.init(dleaves),
                          {n: p.detach().clone() for n, p in dleaves.items()})
    images, labels = data(3)
    out["train_losses"] = []
    for k in range(3):
        key = jax.random.PRNGKey(400 + k)
        draws = [MixupDraws(*map(torch.from_numpy, jax_draws(
            jax.random.split(r)[1], MB, 32, 32, mode="pair")))
            for r in jax.random.split(key, A)]
        jfstate, jm = jft(jfstate, images[k], labels[k], key)
        fstate, m = ft(fstate, torch.from_numpy(images[k]),
                       torch.from_numpy(labels[k]), None, mixup_draws=draws)
        out["train_losses"].append((m["loss"].item(), float(jm["loss"])))
    out.update(fstate=fstate, jfstate=jfstate)
    out["eval_dense"] = (
        S.make_eval_step_dense(dcfg, **ev)(fstate.params, xt, yt),
        JS.make_eval_step_dense(jdcfg, compute_dtype=jnp.float32)(
            jfstate.params, x, y))
    return out


def test_compress_converges_like_jax_and_zeroes_moments(life):
    rep, jrep = life["rep"], life["jrep"]
    assert rep.events == jrep.events and len(rep.events) == 6
    assert rep.finish_search and jrep.finish_search
    mine, theirs = life["after_compress"]["arch"], \
        life["after_compress"]["jarch"]
    assert set(mine) == set(theirs)
    for k in theirs:
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
    want = {"alphas.embed", "alphas.patch", "patch_embed.score"}
    for i in range(2):
        want |= {f"alphas.blocks.{i}.attn", f"alphas.blocks.{i}.mlp",
                 f"blocks.{i}.attn.score", f"blocks.{i}.mlp.score"}
    assert life["after_compress"]["zero_mu"] == want


def test_postsearch_steps_match(life):
    for m, jm in life["post_metrics"]:
        assert set(m) == set(JS.METRIC_KEYS_POSTSEARCH)
        metrics_close(m, jm)
    st, jst = life["state"], life["jstate"]
    assert st.step == int(jst.step) == 5 * A
    leaves_close(st.params, jst.params, 5e-5)
    leaves_close(st.alphas, jst.alphas, 5e-5, "alphas.")
    ema = flatten_from_jax(np_tree(jst.ema_params))
    for n, e in st.ema_params.items():
        np.testing.assert_allclose(e.numpy(), ema[n], rtol=0, atol=5e-5,
                                   err_msg=n)
    moments_close(st.opt_state, jst.opt_state)
    # the decoder and the mask token are bit-identical across postsearch,
    # while their moments went on decaying
    assert len(life["frozen"]) == 3
    for n, before in life["frozen"].items():
        assert torch.equal(dict(st.params.named_parameters())[n], before), n
    # finished alphas hold still: they are the crafted, compressed values
    for n, p in st.alphas.named_parameters():
        assert set(p.detach().unique().tolist()) <= {0.0, 8.0}, n


def test_static_masks_freeze_what_they_name(life):
    """With freeze_weights the matmul weights never move; without, they
    do. (Alphas of a zero loss weight are frozen from the first step.)"""
    w = life["state"].params.blocks[0].mlp.fc1.weight.detach()
    _, _, jp, _, _ = jax_supernet(dict(TINY4, distilled=life["masks_on"]),
                                  seed=6)
    w0 = np.asarray(jp["blocks"][0]["mlp"]["fc1"]["kernel"]).T
    assert np.array_equal(w.numpy(), w0) == life["masks_on"]
    n0 = life["state"].params.blocks[0].norm1.weight.detach().numpy()
    assert not np.array_equal(n0, np.ones_like(n0))
    a = life["search_alphas"]["blocks.0.mlp"].numpy()
    a0 = np.asarray(jax_supernet(dict(TINY4, distilled=life["masks_on"]),
                                 seed=6)[3]["blocks"][0]["mlp"])
    assert np.array_equal(a, a0) == life["masks_on"]


def test_gated_fused_and_sliced_evals_agree(life):
    fused, jfused = life["eval_fused"]
    metrics_close(fused, jfused)
    for other in (life["eval_gated"], life["eval_sliced"]):
        assert other["loss_sum"].item() == pytest.approx(
            fused["loss_sum"].item(), rel=1e-4)
        assert other["top1"] == fused["top1"]
        assert other["top5"] == fused["top5"]


def test_export_matches_after_the_supernet_steps(life):
    assert life["meta"] == life["jmeta"]
    assert life["dcfg"].block_overrides == ((2, 5, 48), (4, 7, 24))
    want = flatten_from_jax(np_tree(life["jdense0"]))
    assert set(want) == set(life["dense0"])
    for n, p in life["dense0"].items():
        np.testing.assert_allclose(p.numpy(), want[n], rtol=0, atol=5e-5,
                                   err_msg=n)


def test_dense_train_steps_and_eval_match(life):
    for mine, theirs in life["train_losses"]:
        assert mine == pytest.approx(theirs, rel=1e-4)
    st, jst = life["fstate"], life["jfstate"]
    assert st.step == int(jst.step) == 3 * A
    leaves_close(st.params, jst.params, 1e-4)
    ema = flatten_from_jax(np_tree(jst.ema_params))
    for n, e in st.ema_params.items():
        np.testing.assert_allclose(e.numpy(), ema[n], rtol=0, atol=1e-4,
                                   err_msg=n)
    moments_close(st.opt_state, jst.opt_state)
    moved = sum(int(not torch.equal(p.detach(), life["dense0"][n]))
                for n, p in st.params.named_parameters())
    # all but a distilled model's second head bias: that head is outside
    # the finetune loss, and a zero bias without weight decay stays zero
    assert moved >= len(life["dense0"]) - 1
    metrics_close(*life["eval_dense"])
