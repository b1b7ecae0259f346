"""Mixup / CutMix (ofb_tpu_torch/ops/mixup.py) against the JAX package's.

Randomness does not cross frameworks: the tests take JAX's own draws (the
same `jax.random` calls on the same keys as `mixup_cutmix` makes, through
the JAX package's own box functions) and feed them to the port's
deterministic `apply_mixup`; JAX's `mixup_cutmix` on the same key is the
reference. Images and labels to rtol 1e-6 / atol 1e-6 (one fp32 blend).
The port's own draws are held to their ranges and shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofb_tpu.ops import mixup as JM
from ofb_tpu_torch.ops import mixup as M

torch.set_num_threads(1)


def jax_draws(rng, B, H, W, *, mixup_alpha=0.8, cutmix_alpha=1.0,
              cutmix_minmax=None, prob=1.0, switch_prob=0.5, mode="batch"):
    """(lam (n,), box (n, H, W)) as `JM.mixup_cutmix` computes them from
    `rng` before it mixes."""
    r_apply, r_switch, r_lam_m, r_lam_c, r_box = jax.random.split(rng, 5)
    use_mix = mixup_alpha > 0.0
    use_cut = cutmix_alpha > 0.0 or cutmix_minmax is not None
    n = {"batch": 1, "pair": B // 2, "elem": B}[mode]
    apply = jax.random.uniform(r_apply, (n,)) < prob
    if use_mix and use_cut:
        do_cut = jax.random.uniform(r_switch, (n,)) < switch_prob
    else:
        do_cut = jnp.full((n,), use_cut)
    lam_m = jax.random.beta(r_lam_m, mixup_alpha, mixup_alpha, (n,)) \
        if use_mix else jnp.ones((n,))
    if cutmix_minmax is not None:
        box, lam_c_adj = JM._rand_bbox_minmax(r_box, H, W, n, cutmix_minmax)
    else:
        lam_c = jax.random.beta(r_lam_c, cutmix_alpha, cutmix_alpha, (n,)) \
            if use_cut else jnp.ones((n,))
        box, lam_c_adj = JM._rand_bbox(r_box, H, W, lam_c)
    lam = jnp.where(do_cut, lam_c_adj, lam_m)
    box = box * do_cut[:, None, None]
    lam = jnp.where(apply, lam, 1.0)
    box = box * apply[:, None, None]
    return np.array(lam, np.float32), np.array(box, np.float32)


def as_draws(lam, box):
    return M.MixupDraws(torch.from_numpy(lam), torch.from_numpy(box))


def batch(B, seed=0, S=16, classes=10):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (B, S, S, 3)).astype(np.float32),
            rng.integers(0, classes, (B,)))


CASES = [
    dict(mode="batch"), dict(mode="pair"), dict(mode="elem"),
    dict(mode="elem", prob=0.5), dict(mode="pair", switch_prob=1.0),
    dict(mode="elem", cutmix_alpha=0.0), dict(mode="elem", mixup_alpha=0.0),
    dict(mode="elem", cutmix_minmax=(0.2, 0.8)),
    dict(mode="batch", cutmix_minmax=(0.3, 0.6), mixup_alpha=0.0),
]


@pytest.mark.parametrize("B", [8, 7])
@pytest.mark.parametrize("kw", CASES, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_apply_mixup_on_jax_draws(kw, B):
    images, labels = batch(B, seed=B)
    seen_cut = seen_mix = False
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        jim, jy = JM.mixup_cutmix(key, jnp.asarray(images),
                                  jnp.asarray(labels), num_classes=10,
                                  label_smoothing=0.1, **kw)
        lam, box = jax_draws(key, B, 16, 16, **kw)
        im, y = M.apply_mixup(torch.from_numpy(images),
                              torch.from_numpy(labels), as_draws(lam, box),
                              num_classes=10, mode=kw["mode"],
                              label_smoothing=0.1)
        np.testing.assert_allclose(im.numpy(), np.asarray(jim), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(y.sum(-1).numpy(), 1.0, atol=1e-5)
        seen_cut |= bool(box.max() > 0)
        seen_mix |= bool(((lam < 1) & (box.max(axis=(1, 2)) == 0)).any())
    if kw.get("mixup_alpha", 0.8) > 0 and kw.get("switch_prob", 0.5) < 1:
        assert seen_mix
    if kw.get("cutmix_alpha", 1.0) > 0 or "cutmix_minmax" in kw:
        assert seen_cut


def test_no_mixup_gives_smoothed_one_hot_and_the_images():
    images, labels = batch(4)
    draws = M.mixup_draws(None, 4, 16, 16, mixup_alpha=0.0, cutmix_alpha=0.0)
    assert draws is None
    im, y = M.apply_mixup(torch.from_numpy(images), torch.from_numpy(labels),
                          draws, num_classes=10, label_smoothing=0.1)
    assert im.data_ptr() == torch.from_numpy(images).data_ptr()
    want = JM.one_hot_smooth(jnp.asarray(labels), 10, 0.1)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-6)
    jim, jy = JM.mixup_cutmix(jax.random.PRNGKey(0), jnp.asarray(images),
                              jnp.asarray(labels), num_classes=10,
                              mixup_alpha=0.0, cutmix_alpha=0.0)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-6)


def test_box_mask_matches():
    y1, y2 = np.array([0, 3, 5]), np.array([4, 3, 16])
    x1, x2 = np.array([2, 0, 15]), np.array([9, 16, 16])
    want = JM._box_mask(16, 12, *(jnp.asarray(a) for a in (y1, y2, x1, x2)))
    got = M._box_mask(16, 12, *(torch.from_numpy(a) for a in (y1, y2, x1, x2)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode,n", [("batch", 1), ("pair", 4), ("elem", 9)])
@pytest.mark.parametrize("minmax", [None, (0.2, 0.8)])
def test_own_draws_are_in_range(mode, n, minmax):
    g = torch.Generator().manual_seed(0)
    H, W = 16, 12
    lams, cuts = [], 0
    for _ in range(20):
        d = M.mixup_draws(g, 9, H, W, mode=mode, cutmix_minmax=minmax,
                          prob=0.9)
        assert d.lam.shape == (n,) and d.box.shape == (n, H, W)
        assert ((d.lam >= 0) & (d.lam <= 1)).all()
        assert set(d.box.unique().tolist()) <= {0.0, 1.0}
        area = d.box.sum(dim=(1, 2))
        cut = area > 0
        # a CutMix draw's weight is the share of the image outside its box
        np.testing.assert_allclose(d.lam[cut].numpy(),
                                   (1 - area[cut] / (H * W)).numpy(),
                                   rtol=1e-6)
        if minmax is not None and cut.any():
            rows = d.box[cut].amax(dim=2).sum(dim=1)
            assert (rows >= int(H * minmax[0])).all()
            assert (rows < max(int(H * minmax[1]), 1)).all()
        lams += d.lam.tolist()
        cuts += int(cut.sum())
    assert 0 < cuts < 20 * n                  # both kinds were drawn
    assert 0.2 < np.mean(lams) < 0.9          # Beta(0.8) / box areas, not 1s
    # the same seed gives the same draws
    a = M.mixup_draws(torch.Generator().manual_seed(5), 9, H, W, mode=mode)
    b = M.mixup_draws(torch.Generator().manual_seed(5), 9, H, W, mode=mode)
    assert torch.equal(a.lam, b.lam) and torch.equal(a.box, b.box)


def test_mixup_cutmix_composes_draws_and_apply():
    images, labels = batch(6)
    im, lb = torch.from_numpy(images), torch.from_numpy(labels)
    got = M.mixup_cutmix(torch.Generator().manual_seed(3), im, lb,
                         num_classes=10, mode="elem")
    draws = M.mixup_draws(torch.Generator().manual_seed(3), 6, 16, 16,
                          mode="elem")
    want = M.apply_mixup(im, lb, draws, num_classes=10, mode="elem")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError):
        M.apply_mixup(im, lb, draws, num_classes=10, mode="rows")
