"""(e) The port's gated supernet forward (models/mim_vit.py) against the JAX
package's, from the same weights and with JAX's PMIM token mask handed in:
logits and decoder loss, on the tiny config and at deit_small widths.

Tolerance: fp32 on both sides, with JAX's default (gate-fold) path and the
port's kernel twins on the CPU. Twelve-plus chained matmuls and masked
layer norms sum in other orders: logits to rtol 1e-4 / atol 1e-5 (their
scale is ~1), the decoder loss to rel 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofb_tpu.models import mim_vit as jmim
from ofb_tpu.models import vit as jvit
from ofb_tpu_torch.models.from_jax import load_from_jax
from ofb_tpu_torch.models.mim_vit import mim_forward
from ofb_tpu_torch.models.vit import ModelCfg, ViT, dense_flops, vit_forward
from test_torch_port_from_jax import (DEIT_S1, TINY, jax_supernet,
                                      jax_token_mask, np_tree, port_supernet,
                                      pruned_arch)

torch.set_num_threads(1)


def run_both(cfg_kw, batch, keep, arch_fn=lambda a: a, seed=0, fused=False):
    jcfg, jspace, jp, ja, jarch = jax_supernet(cfg_kw, seed)
    jarch = arch_fn(jarch)
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (batch, jcfg.img_size, jcfg.img_size, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(seed + 7)
    jout = jmim.mim_forward(jp, ja, jarch, x, jcfg, jspace, train=True,
                            use_mim=True, fused=fused,
                            keep_ratio=jnp.float32(keep), rng=key,
                            compute_dtype=jnp.float32)
    mask = jax_token_mask(key, jcfg, batch, keep)
    cfg, space, params, alphas, arch = port_supernet(cfg_kw, jp, ja, jarch)
    out = mim_forward(params, alphas, arch, torch.from_numpy(x), cfg, space,
                      train=True, use_mim=True, fused=fused, keep_ratio=keep,
                      token_mask=torch.from_numpy(mask),
                      compute_dtype=torch.float32)
    return jout, out, mask


@pytest.mark.parametrize("pruned,fused", [(False, False), (True, False),
                                          (True, True)])
def test_tiny_forward_matches(pruned, fused):
    """Gated (JAX's default gate-fold path) and post-fuse (no gates, the
    hard masks only) forwards."""
    jout, out, mask = run_both(TINY, 4, 0.75,
                               pruned_arch if pruned else (lambda a: a),
                               fused=fused)
    assert 0 < mask.sum() < mask.size
    np.testing.assert_allclose(out.logits.detach().numpy(),
                               np.asarray(jout.logits), rtol=1e-4, atol=1e-5)
    assert out.decoder_loss.item() == pytest.approx(
        float(jout.decoder_loss), rel=1e-4)
    assert out.decoder_loss.item() > 0


def test_deit_small_width_forward_matches():
    jout, out, _ = run_both(DEIT_S1, 2, 0.75)
    assert out.logits.shape == (2, 1000)
    np.testing.assert_allclose(out.logits.detach().numpy(),
                               np.asarray(jout.logits), rtol=1e-4, atol=1e-5)
    assert out.decoder_loss.item() == pytest.approx(
        float(jout.decoder_loss), rel=1e-4)


def test_keep_ratio_one_gives_zero_decoder_loss():
    _, out, mask = run_both(TINY, 2, 1.0)
    assert mask.sum() == 0
    assert out.decoder_loss.item() == 0.0


def test_drawn_mask_and_eval_mode():
    """Without an injected mask the port draws its own with the annealed
    keep count; eval mode runs no MIM branch."""
    _, _, jp, ja, jarch = jax_supernet(TINY)
    cfg, space, params, alphas, arch = port_supernet(TINY, jp, ja, jarch)
    x = torch.rand(3, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    out = mim_forward(params, alphas, arch, x, cfg, space, train=True,
                      use_mim=True, keep_ratio=0.75,
                      generator=torch.Generator().manual_seed(1),
                      compute_dtype=torch.float32)
    assert ((1 - out.token_mask).sum(1) == 12).all()        # floor(16 * .75)
    ev = mim_forward(params, alphas, arch, x, cfg, space, train=False,
                     use_mim=False, compute_dtype=torch.float32)
    assert ev.token_mask is None and ev.decoder_loss.item() == 0.0
    assert torch.isfinite(ev.logits).all()


@pytest.mark.parametrize("distilled", [False, True])
def test_dense_vit_forward_matches(distilled):
    """The dense ViT (models/vit.py: patch embed, blocks, attention through
    the kernel twins, exact GELU, distilled heads) against JAX's."""
    kw = dict(TINY, distilled=distilled)
    jcfg = jvit.ModelCfg(**kw)
    jp = jvit.init_vit_params(jax.random.PRNGKey(3), jcfg)
    x = np.random.default_rng(3).uniform(0, 1, (3, 32, 32, 3)).astype(
        np.float32)
    cfg = ModelCfg(**kw)
    params = load_from_jax(ViT(cfg), np_tree(jp))
    got = vit_forward(params, torch.from_numpy(x), cfg,
                      compute_dtype=torch.float32)
    want = jvit.vit_forward(jp, x, jcfg, compute_dtype=jnp.float32)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    assert dense_flops(cfg) == jvit.dense_flops(jcfg)


@pytest.mark.parametrize("case", ["mim_unmasked", "mim_token_mask", "vit"])
def test_train_without_generator_draws_nothing(case):
    """train=True with drop rates > 0 but no random source: the JAX package
    applies no drop-path and no dropout (rng None), and so must the port
    (generator None), without touching torch's global generator.
    mim_unmasked: both packages, drop_path_rate 0.1, no rng, no PMIM mask
    (JAX cannot draw one without an rng). mim_token_mask: the port at
    drop_path_rate 0.1 with an explicit token mask and no generator against
    JAX at drop_path_rate 0.0 with the rng that drew that mask. vit: the
    dense forward, drop_path_rate and drop_rate 0.1, no rng."""
    live = dict(TINY, drop_path_rate=0.1)
    x = np.random.default_rng(11).uniform(0, 1, (3, 32, 32, 3)).astype(
        np.float32)
    if case == "vit":
        kw = dict(live, drop_rate=0.1)
        jcfg = jvit.ModelCfg(**kw)
        jp = jvit.init_vit_params(jax.random.PRNGKey(5), jcfg)
        want = jvit.vit_forward(jp, x, jcfg, train=True, rng=None,
                                compute_dtype=jnp.float32)
        cfg = ModelCfg(**kw)
        params = load_from_jax(ViT(cfg), np_tree(jp))
        before = torch.get_rng_state()
        got = vit_forward(params, torch.from_numpy(x), cfg, train=True,
                          compute_dtype=torch.float32)
    else:
        use_mim = case == "mim_token_mask"
        jcfg, jspace, jp, ja, jarch = jax_supernet(TINY if use_mim else live)
        key = jax.random.PRNGKey(18) if use_mim else None
        jout = jmim.mim_forward(jp, ja, jarch, x, jcfg, jspace, train=True,
                                use_mim=use_mim, keep_ratio=jnp.float32(0.75),
                                rng=key, compute_dtype=jnp.float32)
        mask = torch.from_numpy(jax_token_mask(key, jcfg, 3, 0.75)) \
            if use_mim else None
        cfg, space, params, alphas, arch = port_supernet(live, jp, ja, jarch)
        assert cfg.drop_path_rate == 0.1
        before = torch.get_rng_state()
        out = mim_forward(params, alphas, arch, torch.from_numpy(x), cfg,
                          space, train=True, use_mim=use_mim, keep_ratio=0.75,
                          token_mask=mask, compute_dtype=torch.float32)
        if use_mim:
            assert out.decoder_loss.item() == pytest.approx(
                float(jout.decoder_loss), rel=1e-4)
        got, want = out.logits, jout.logits
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    assert torch.equal(torch.get_rng_state(), before)
