"""`fuse_params` and the activation-gating form of the supernet forward
(ofb_tpu_torch/models/mim_vit.py) against the JAX package's.

`fuse_params`: every leaf of the fused model equals JAX's fused tree (one
fp32 multiply per element on both sides: rtol 1e-6), the model handed in
keeps its weights, and the `fused=True` forward of the fused model agrees
with JAX's (rtol 1e-4 / atol 1e-5, chained matmuls in other orders).

Gate fold: with `gate_fold=False` the port gates activations, as the JAX
package does with OFB_GATE_FOLD=0; the JAX side is switched by patching
its module flag inside the test. Both forms are held against JAX in the
same form, values and gradients, and against each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofb_tpu.core import compress as jcompress
from ofb_tpu.models import mim_vit as jmim
from ofb_tpu_torch.models.from_jax import flatten_from_jax
from ofb_tpu_torch.models.mim_vit import fuse_params, mim_forward
from test_torch_port_from_jax import (DEIT_S1, TINY, jax_supernet,
                                      jax_token_mask, np_tree, port_supernet,
                                      pruned_arch)

torch.set_num_threads(1)


def jax_converged(cfg_kw, seed=0, cells=(5, (0, 3), 4, 2)):
    """A JAX supernet whose every module converged in one compress pass on
    crafted alphas (embed cell, attn cell, mlp cell, patch cell)."""
    cfg, space, jp, ja, jarch = jax_supernet(cfg_kw, seed)
    # biases start at zero; give them values so that their fusing shows
    rng = np.random.default_rng(seed)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(rng.normal(0, 0.02, a.shape), a.dtype)
        if path[-1].key == "bias" else a, jp)

    def onehot(shape, idx):
        a = np.full(shape, -8.0, np.float32)
        a[idx] = 8.0
        return jnp.asarray(a)

    e, at, m, pt = cells
    ja = dict(ja)
    ja["embed"] = onehot(ja["embed"].shape, e)
    ja["patch"] = onehot(ja["patch"].shape, pt)
    ja["blocks"] = [{"attn": onehot(b["attn"].shape, at),
                     "mlp": onehot(b["mlp"].shape, m)} for b in ja["blocks"]]
    jp, ja, jarch, _, report = jcompress.compress(jp, ja, jarch, None, space)
    assert report.finish_search
    return cfg, space, jp, ja, jarch


@pytest.mark.parametrize("cfg_kw", [TINY, DEIT_S1], ids=["tiny", "deit_s1"])
def test_fuse_params_leaf_by_leaf(cfg_kw):
    jcfg, jspace, jp, ja, jarch = jax_converged(cfg_kw)
    cfg, space, params, alphas, arch = port_supernet(cfg_kw, jp, ja, jarch)
    before = {n: p.detach().clone() for n, p in params.named_parameters()}
    fused, farch = fuse_params(params, arch, space, cfg)
    jfused, jfarch = jmim.fuse_params(jp, jarch, jspace, jcfg)
    want = flatten_from_jax(np_tree(jfused))
    got = dict(fused.named_parameters())
    assert set(got) == set(want)
    changed = 0
    for n, p in got.items():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=1e-6,
                                   atol=0, err_msg=n)
        changed += int(not torch.equal(p, before[n]))
    assert changed >= 5 + 4 * cfg.depth      # tokens, conv, qkv and fc1
    assert bool(farch.fused) and bool(jfarch.fused)
    # the live model and its arch state are untouched
    assert not bool(arch.fused)
    for n, p in params.named_parameters():
        assert torch.equal(p, before[n]), n
    assert farch.embed.hard_mask is arch.embed.hard_mask


@pytest.mark.parametrize("cfg_kw", [TINY, DEIT_S1], ids=["tiny", "deit_s1"])
def test_fused_forward_matches_jax_and_the_gated_forward(cfg_kw):
    jcfg, jspace, jp, ja, jarch = jax_converged(cfg_kw, seed=1)
    cfg, space, params, alphas, arch = port_supernet(cfg_kw, jp, ja, jarch)
    fused, farch = fuse_params(params, arch, space, cfg)
    jfused, jfarch = jmim.fuse_params(jp, jarch, jspace, jcfg)
    x = np.random.default_rng(2).uniform(
        0, 1, (3, cfg.img_size, cfg.img_size, 3)).astype(np.float32)
    jout = jmim.mim_forward(jfused, ja, jfarch, x, jcfg, jspace, train=False,
                            use_mim=False, fused=True,
                            compute_dtype=jnp.float32)
    kw = dict(train=False, use_mim=False, compute_dtype=torch.float32)
    with torch.no_grad():
        out = mim_forward(fused, alphas, farch, torch.from_numpy(x), cfg,
                          space, fused=True, **kw)
        gated = mim_forward(params, alphas, arch, torch.from_numpy(x), cfg,
                            space, fused=False, **kw)
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(jout.logits),
                               rtol=1e-4, atol=1e-5)
    # a finished module's gate is its score on live dims: fused == gated
    np.testing.assert_allclose(out.logits.numpy(), gated.logits.numpy(),
                               rtol=1e-4, atol=1e-5)


def _loss_and_grads_jax(jp, ja, jarch, x, jcfg, jspace, key, keep):
    def f(p, a):
        out = jmim.mim_forward(p, a, jarch, x, jcfg, jspace, train=True,
                               use_mim=True, keep_ratio=jnp.float32(keep),
                               rng=key, compute_dtype=jnp.float32)
        return jnp.mean(out.logits ** 2) + out.decoder_loss, out
    (loss, out), grads = jax.value_and_grad(f, argnums=(0, 1),
                                            has_aux=True)(jp, ja)
    return out, grads


@pytest.mark.parametrize("fold", [True, False], ids=["fold", "activation"])
@pytest.mark.parametrize("pruned", [False, True], ids=["fresh", "pruned"])
def test_gate_fold_forms_match_jax(monkeypatch, fold, pruned):
    """Values and gradients of both gating forms against JAX in the same
    form. Gradients to rtol 1e-3 / atol 1e-6 of fp32 sums in other orders."""
    monkeypatch.setattr(jmim, "_GATE_FOLD", fold)
    jcfg, jspace, jp, ja, jarch = jax_supernet(TINY, seed=3)
    if pruned:
        jarch = pruned_arch(jarch)
    x = np.random.default_rng(4).uniform(0, 1, (4, 32, 32, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(11)
    jout, (gp, ga) = _loss_and_grads_jax(jp, ja, jarch, x, jcfg, jspace, key,
                                         0.75)
    mask = jax_token_mask(key, jcfg, 4, 0.75)
    cfg, space, params, alphas, arch = port_supernet(TINY, jp, ja, jarch)
    out = mim_forward(params, alphas, arch, torch.from_numpy(x), cfg, space,
                      train=True, use_mim=True, keep_ratio=0.75,
                      token_mask=torch.from_numpy(mask), gate_fold=fold,
                      compute_dtype=torch.float32)
    (out.logits.square().mean() + out.decoder_loss).backward()
    np.testing.assert_allclose(out.logits.detach().numpy(),
                               np.asarray(jout.logits), rtol=1e-4, atol=1e-5)
    assert out.decoder_loss.item() == pytest.approx(float(jout.decoder_loss),
                                                    rel=1e-4)
    for module, tree in ((params, gp), (alphas, ga)):
        want = flatten_from_jax(np_tree(tree))
        for n, p in module.named_parameters():
            # a leaf the forward does not read (the patch alpha) has no
            # gradient here and a zero one in JAX
            got = p.grad.numpy() if p.grad is not None else np.zeros(
                p.shape, np.float32)
            np.testing.assert_allclose(got, want[n], rtol=1e-3, atol=1e-6,
                                       err_msg=n)


def test_gate_fold_forms_agree_with_each_other():
    jcfg, jspace, jp, ja, jarch = jax_supernet(DEIT_S1, seed=5)
    cfg, space, params, alphas, arch = port_supernet(DEIT_S1, jp, ja, jarch)
    x = torch.from_numpy(np.random.default_rng(6).uniform(
        0, 1, (2, 224, 224, 3)).astype(np.float32))
    mask = (torch.rand(2, 196, generator=torch.Generator().manual_seed(0))
            < 0.25).float()
    outs = [mim_forward(params, alphas, arch, x, cfg, space, train=True,
                        use_mim=True, token_mask=mask, gate_fold=fold,
                        compute_dtype=torch.float32) for fold in (True, False)]
    np.testing.assert_allclose(outs[0].logits.detach().numpy(),
                               outs[1].logits.detach().numpy(), rtol=1e-4,
                               atol=1e-5)
    assert outs[0].decoder_loss.item() == pytest.approx(
        outs[1].decoder_loss.item(), rel=1e-5)
