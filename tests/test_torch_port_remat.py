"""Per-block rematerialisation (`ModelCfg.remat`, models/vit.py:remat_block)
against the steps without it and against the JAX package's `remat=True`
steps (`jax.checkpoint` of each block), on the CPU in fp32:

* with drop-path on and every draw from one seeded generator, the remat
  search step and the remat dense train step end in the same state, bit
  for bit, as the same steps without remat: the recompute replays the
  block's draws (`DrawTape`) instead of drawing again from a generator
  that has moved on;
* without drop-path (randomness never crosses between the frameworks), 2
  accumulated search steps and 2 dense train steps with remat equal JAX's
  with remat=True (params atol 2e-5, loss rel 1e-5, as the step tests);
* `model_cfg_from_meta` keeps `remat` from a meta's config.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_multiproc_worker as W
from ofb_tpu import config as JC
from ofb_tpu.core import optim as JO
from ofb_tpu.core import steps as JS
from ofb_tpu.models import vit as jvit
from ofb_tpu_torch import config as C
from ofb_tpu_torch.core import checkpoint as ck
from ofb_tpu_torch.core import optim as O
from ofb_tpu_torch.core import steps as S
from ofb_tpu_torch.models.from_jax import flatten_from_jax, load_from_jax
from ofb_tpu_torch.models.vit import ModelCfg, ViT
from test_torch_port_from_jax import (TINY, jax_supernet, jax_token_mask,
                                      np_tree, port_supernet)

torch.set_num_threads(1)
K, MB, KEEP = 2, 4, 0.75


def _search_run(cfg_kw, *, generator_seed=None, masks=None, images=None,
                labels=None, seed=3):
    """K search steps of the port from a JAX-initialised supernet; the
    leaves after them and the metrics."""
    jcfg, jspace, jp, ja, jarch = jax_supernet(
        {k: v for k, v in cfg_kw.items() if k != "remat"}, seed=seed)
    cfg, space, params, alphas, arch = port_supernet(cfg_kw, jp, ja, jarch)
    scfg = W.search_cfg(C)
    tx, _ = W.build_tx(O, scfg)
    state = S.TrainState(step=0, params=params, alphas=alphas, arch=arch,
                         opt_state=tx.init(O.named_leaves(params, alphas)),
                         ema_params={n: p.detach().clone()
                                     for n, p in params.named_parameters()})
    step = S.make_search_step(space, cfg, scfg, tx, phase="search",
                              compute_dtype=torch.float32, device="cpu")
    g = torch.Generator().manual_seed(generator_seed) \
        if generator_seed is not None else None
    metrics = []
    for k in range(K):
        state, m = step(state, torch.from_numpy(images[k]),
                        torch.from_numpy(labels[k]), g, KEEP,
                        token_masks=None if masks is None
                        else torch.from_numpy(masks[k]))
        metrics.append({n: v.item() for n, v in m.items()})
    leaves = {n: p.detach().clone() for n, p in
              O.named_leaves(state.params, state.alphas).items()}
    return leaves, metrics


def _batches(num_classes, seed=4):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (K, W.A, MB, 32, 32, 3)).astype(np.float32),
            rng.integers(0, num_classes, (K, W.A, MB)))


def test_remat_search_step_equals_the_plain_step_with_drop_path():
    kw = dict(TINY, drop_path_rate=0.2)
    images, labels = _batches(kw["num_classes"])
    plain, pm = _search_run(kw, generator_seed=5, images=images,
                            labels=labels)
    remat, rm = _search_run(dict(kw, remat=True), generator_seed=5,
                            images=images, labels=labels)
    assert pm == rm
    for n, t in plain.items():
        assert torch.equal(remat[n], t), n
    # drop-path took effect: the same run without it ends elsewhere
    other, _ = _search_run(TINY, generator_seed=5, images=images,
                           labels=labels)
    assert not torch.equal(other["blocks.0.mlp.fc1.weight"],
                           plain["blocks.0.mlp.fc1.weight"])


def test_remat_search_step_equals_jax_remat():
    kw = dict(TINY, remat=True)
    jcfg, jspace, jp, ja, jarch = jax_supernet(kw, seed=3)
    assert jcfg.remat
    images, labels = _batches(kw["num_classes"])
    keys = [jax.random.PRNGKey(70 + k) for k in range(K)]
    masks = np.stack([np.stack([
        jax_token_mask(jax.random.split(r, 3)[1], jcfg, MB, KEEP)
        for r in jax.random.split(key, W.A)]) for key in keys])
    jscfg = W.search_cfg(JC)
    jtx, _ = W.build_tx(JO, jscfg)
    jstate = JS.TrainState(step=jnp.asarray(0, jnp.int32), params=jp,
                           alphas=ja, arch=jarch,
                           opt_state=jtx.init((jp, ja)), ema_params=jp)
    jstep = JS.make_search_step(jspace, jcfg, jscfg, jtx, phase="search",
                                compute_dtype=jnp.float32, donate=False)
    jmetrics = []
    for k in range(K):
        jstate, m = jstep(jstate, images[k], labels[k], keys[k],
                          jnp.float32(KEEP))
        jmetrics.append({n: float(v) for n, v in m.items()})
    got, metrics = _search_run(kw, masks=masks, images=images,
                               labels=labels)
    want = flatten_from_jax(np_tree(jstate.params))
    want.update({"alphas." + n: a for n, a in
                 flatten_from_jax(np_tree(jstate.alphas)).items()})
    assert set(got) == set(want)
    for n, a in want.items():
        np.testing.assert_allclose(got[n].numpy(), a, rtol=0, atol=2e-5,
                                   err_msg=n)
    for m, jm in zip(metrics, jmetrics):
        assert m["loss_total"] == pytest.approx(jm["loss_total"], rel=1e-5)


DENSE = dict(img_size=32, patch_size=8, num_classes=16, embed_dim=32,
             depth=2, num_heads=2, mlp_ratio=2.0)


def _train_run(cfg, jparams, images, labels, generator_seed=None):
    """K dense train steps of the port (adamw, no Mixup) from JAX's
    weights; the params after them and the losses."""
    dense = load_from_jax(ViT(cfg), np_tree(jparams))
    tx = O.adamw(lambda c: 1e-3 * (0.5 ** torch.as_tensor(c, dtype=torch.float32)),
                 weight_decay=0.05)
    leaves = dict(dense.named_parameters())
    state = S.TrainState(step=0, params=dense, alphas=None, arch=None,
                         opt_state=tx.init(leaves))
    step = S.make_train_step(cfg, tx, num_classes=cfg.num_classes,
                             smoothing=0.1, compute_dtype=torch.float32,
                             device="cpu")
    g = torch.Generator().manual_seed(generator_seed) \
        if generator_seed is not None else None
    losses = []
    for k in range(K):
        state, m = step(state, torch.from_numpy(images[k]),
                        torch.from_numpy(labels[k]), g)
        losses.append(m["loss"].item())
    return {n: p.detach().clone() for n, p in dense.named_parameters()}, \
        losses


def test_remat_train_step_equals_the_plain_step_with_drop_path():
    kw = dict(DENSE, drop_path_rate=0.2)
    jp = jvit.init_vit_params(jax.random.PRNGKey(8), jvit.ModelCfg(**kw))
    images, labels = _batches(kw["num_classes"], seed=9)
    plain, pl = _train_run(ModelCfg(**kw), jp, images, labels, 6)
    remat, rl = _train_run(ModelCfg(**kw, remat=True), jp, images, labels,
                           6)
    assert pl == rl
    for n, t in plain.items():
        assert torch.equal(remat[n], t), n
    other, _ = _train_run(ModelCfg(**DENSE), jp, images, labels, 6)
    assert not torch.equal(other["blocks.1.mlp.fc2.weight"],
                           plain["blocks.1.mlp.fc2.weight"])


def test_remat_train_step_equals_jax_remat():
    jcfg = jvit.ModelCfg(**DENSE, remat=True)
    jp = jvit.init_vit_params(jax.random.PRNGKey(8), jcfg)
    images, labels = _batches(DENSE["num_classes"], seed=9)
    import optax
    jtx = optax.adamw(lambda c: 1e-3 * (0.5 ** jnp.asarray(c, jnp.float32)),
                      weight_decay=0.05)
    jstate = JS.TrainState(step=jnp.asarray(0, jnp.int32), params=jp,
                           alphas=None, arch=None, opt_state=jtx.init(jp))
    jstep = JS.make_train_step(jcfg, jtx, num_classes=DENSE["num_classes"],
                               smoothing=0.1, compute_dtype=jnp.float32,
                               donate=False)
    jlosses = []
    for k in range(K):
        jstate, m = jstep(jstate, images[k], labels[k],
                          jax.random.PRNGKey(k))
        jlosses.append(float(m["loss"]))
    got, losses = _train_run(ModelCfg(**DENSE, remat=True), jp, images,
                             labels)
    for n, a in flatten_from_jax(np_tree(jstate.params)).items():
        np.testing.assert_allclose(got[n].numpy(), a, rtol=0, atol=2e-5,
                                   err_msg=n)
    for mine, theirs in zip(losses, jlosses):
        assert mine == pytest.approx(theirs, rel=1e-5)


def test_model_cfg_from_meta_keeps_remat():
    for remat in (False, True):
        cfg = ModelCfg(**DENSE, remat=remat)
        meta = json.loads(json.dumps(dataclasses.asdict(cfg)))
        assert meta["remat"] is remat
        assert ck.model_cfg_from_meta(meta, ModelCfg) == cfg
    # a JAX package's config, field for field
    jcfg = jvit.ModelCfg(**DENSE, remat=True)
    back = ck.model_cfg_from_meta(
        json.loads(json.dumps(dataclasses.asdict(jcfg))), ModelCfg)
    assert dataclasses.asdict(back) == dataclasses.asdict(jcfg)
