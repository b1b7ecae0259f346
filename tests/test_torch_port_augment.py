"""ofb_tpu_torch/ops/augment.py against ofb_tpu/ops/augment.py on the CPU.

Randomness never crosses: each test computes JAX's own draws from a key,
in JAX's split order and inside jit + vmap as `train_augment_batch` draws
them, and hands them to the port's deterministic functions.

Tolerances, in the 0..255 domain for the single ops and in normalised
units (after `normalize`) for the whole transforms:

  * photometric ops 1e-3 (fp32 means, sums and divisions in another
    order); the shift passes, the bilinear sampler, the affine warp and
    erasing exactly the same samples, 1e-4;
  * the crop and the eval resize 5e-3 (sums of up to 256 fp32 products of
    values up to 255 in another order);
  * the train transform, RandAugment off: max 2e-4, no pixel share above
    1e-4. RandAugment on: its shear passes round to uint8, and a value
    within fp32 rounding of .5 may round the other way, one uint8 step
    (1 / 255 / std, 0.0176), which the second layer's photometric op may
    amplify (enhance factors reach 1.9): max four uint8 steps, mean 3e-5,
    at most 0.2% of pixels above 1e-4.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofb_tpu.ops import augment as JA
from ofb_tpu_torch.ops import augment as A

torch.set_num_threads(1)
LSB = 1.0 / 255.0 / min(A.IMAGENET_STD)


def images(seed, B=4, S=32, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        return rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8)
    return rng.uniform(0, 255, (B, S, S, 3)).astype(np.float32)


def jax_augment_draws(key, B, S, O, *, use_randaug=True, re_prob=0.25,
                      crop_scale=(0.08, 1.0), hflip=True):
    """JAX's draws of `train_augment_batch(key, ...)` as `AugmentDraws`."""
    def one(r):
        k_crop, k_flip, k_aug, k_er = jax.random.split(r, 4)
        d = {"crop": jnp.stack(JA._sample_crop_box(k_crop, S, S,
                                                   crop_scale)),
             "flip": jax.random.bernoulli(k_flip, 0.5) & hflip}
        if use_randaug:
            rng, cols = k_aug, []
            for _ in range(2):
                rng, k_op, k_m, k_sign, k_apply = jax.random.split(rng, 5)
                cols.append((
                    jax.random.randint(k_op, (), 0, JA.NUM_OPS),
                    jnp.clip(9.0 + 0.5 * jax.random.normal(k_m), 0.0, 10.0),
                    jnp.where(jax.random.bernoulli(k_sign, 0.5), 1.0, -1.0),
                    jax.random.bernoulli(k_apply, 0.5)))
            for i, k in enumerate(("op", "mag", "sign", "on")):
                d[k] = jnp.stack([c[i] for c in cols])
        else:
            d["jit"] = jnp.stack([jax.random.uniform(k, (), minval=0.6,
                                                     maxval=1.4)
                                  for k in jax.random.split(k_aug, 3)])
        k_apply, k_area, k_ratio, k_y, k_x, k_noise = jax.random.split(k_er,
                                                                       6)
        a = jax.random.uniform(k_area, (), minval=0.02, maxval=1 / 3) * O * O
        r = jnp.exp(jax.random.uniform(k_ratio, (), minval=math.log(0.3),
                                       maxval=math.log(3.3)))
        h = jnp.clip(jnp.sqrt(a * r), 1.0, O)
        w = jnp.clip(jnp.sqrt(a / r), 1.0, O)
        d["erase"] = jax.random.bernoulli(k_apply, re_prob)
        d["ebox"] = jnp.stack([jax.random.uniform(k_y, ()) * (O - h),
                               jax.random.uniform(k_x, ()) * (O - w), h, w])
        d["noise"] = jax.random.normal(k_noise, (O, O, 3),
                                       jnp.bfloat16).astype(jnp.float32)
        return d

    d = {k: torch.from_numpy(np.array(v)) for k, v in
         jax.jit(jax.vmap(one))(jax.random.split(key, B)).items()}
    ra = use_randaug
    return A.AugmentDraws(
        crop=d["crop"], flip=d["flip"],
        ra_op=d["op"].long() if ra else None, ra_mag=d.get("mag"),
        ra_sign=d.get("sign"), ra_on=d.get("on"), jitter=d.get("jit"),
        erase=d["erase"], erase_box=d["ebox"], noise=d["noise"])


# ---------------------------------------------------------------------------
# single ops
# ---------------------------------------------------------------------------

FACTORS = np.array([0.1, 0.6, 1.0, 1.9], np.float32)
PHOTO = {
    "autocontrast": None, "equalize": None, "invert": None,
    "brightness": FACTORS, "contrast": FACTORS, "color": FACTORS,
    "sharpness": FACTORS,
    "posterize": np.array([1, 2, 3, 4], np.int32),
    "solarize": np.array([0.0, 64.0, 128.5, 256.0], np.float32),
    "solarize_add": np.array([0.0, 11.0, 55.0, 110.0], np.float32),
}


@pytest.mark.parametrize("op", sorted(PHOTO))
def test_photometric_op_matches_jax(op):
    x = images(1)
    x[0, :4] = 7.0                                 # a flat patch
    f = PHOTO[op]
    jop, pop = getattr(JA, op), getattr(A, op)
    if f is None:
        want = jax.vmap(jop)(jnp.asarray(x))
        got = pop(torch.from_numpy(x))
    else:
        want = jax.vmap(jop)(jnp.asarray(x), jnp.asarray(f))
        got = pop(torch.from_numpy(x), torch.from_numpy(f))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-3)


def test_autocontrast_leaves_a_flat_image():
    x = np.full((2, 8, 8, 3), 99.0, np.float32)
    assert torch.equal(A.autocontrast(torch.from_numpy(x)),
                       torch.from_numpy(x))


@pytest.mark.parametrize("axis", ["row", "col"])
def test_shift_passes_match_jax(axis):
    x = images(2, S=24)
    x[..., 0] = np.round(x[..., 0]) + 0.25          # off the .5 boundary
    shift = np.random.default_rng(3).uniform(-140, 140, (4, 24)).astype(
        np.float32)
    shift[0] = 0.0
    shift[1] = 3.0                                 # integer shifts
    jfn = JA._row_shift_frac if axis == "row" else JA._col_shift_frac
    pfn = A._row_shift_frac if axis == "row" else A._col_shift_frac
    want = jax.vmap(lambda i, s: jfn(i, s, 128.0))(jnp.asarray(x),
                                                   jnp.asarray(shift))
    got = pfn(torch.from_numpy(x), torch.from_numpy(shift))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_bilinear_sample_matches_jax():
    x = images(4, S=20)
    rng = np.random.default_rng(5)
    sy = rng.uniform(-2, 22, (4, 12, 16)).astype(np.float32)
    sx = rng.uniform(-2, 22, (4, 12, 16)).astype(np.float32)
    want = jax.vmap(JA.bilinear_sample)(jnp.asarray(x), jnp.asarray(sy),
                                        jnp.asarray(sx))
    got = A.bilinear_sample(*map(torch.from_numpy, (x, sy, sx)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_affine_warp_matches_jax():
    x = images(6, S=24)
    mats = []
    for th, sh, tx, m00 in ((0.0, 0.0, 0.0, None), (0.5, 0.0, 3.5, None),
                            (-0.3, 0.25, -7.0, None), (0.2, 0.1, 1.0, 0.1)):
        c, s = math.cos(th), math.sin(th)
        m = np.array([[c, -s + sh, tx], [s, c, -tx / 2]], np.float32)
        if m00 is not None:
            m[0, 0] = m00                      # held at 0.25 by the warp
        mats.append(m)
    mats = np.stack(mats)
    want = jax.vmap(JA.affine_warp)(jnp.asarray(x), jnp.asarray(mats))
    got = A.affine_warp(torch.from_numpy(x), torch.from_numpy(mats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("S,O,scale", [(40, 32, (0.08, 1.0)),
                                       (64, 56, (0.5, 1.0)),
                                       (24, 32, (0.08, 1.0))])
def test_random_resized_crop_matches_jax(S, O, scale):
    """JAX's own box; S < O upsamples (no anti-aliasing widening)."""
    x = images(7, S=S)
    keys = jax.random.split(jax.random.PRNGKey(8), 4)
    want = jax.vmap(lambda k, i: JA.random_resized_crop(
        k, i, O, scale=scale))(keys, jnp.asarray(x))
    boxes = jax.vmap(lambda k: jnp.stack(JA._sample_crop_box(
        k, S, S, scale)))(keys)
    got = A.random_resized_crop(torch.from_numpy(x),
                                torch.from_numpy(np.array(boxes)), O)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=5e-3)


def test_random_erasing_matches_jax():
    x = np.random.default_rng(9).normal(0, 1, (8, 32, 32, 3)).astype(
        np.float32)
    keys = jax.random.split(jax.random.PRNGKey(10), 8)
    want = jax.jit(jax.vmap(lambda k, i: JA.random_erasing(
        k, i, prob=0.5)))(keys, jnp.asarray(x))
    erase, box, noise = jax_erasing_draws(keys, 32, 0.5)
    got = A.random_erasing(torch.from_numpy(x), erase, box, noise)
    assert bool(erase.any()) and not bool(erase.all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def jax_erasing_draws(keys, O, prob):
    """(erase, box, noise) of `random_erasing(k, img, prob)` per key."""
    def one(k):
        k_apply, k_area, k_ratio, k_y, k_x, k_noise = jax.random.split(k, 6)
        a = jax.random.uniform(k_area, (), minval=0.02, maxval=1 / 3) * O * O
        r = jnp.exp(jax.random.uniform(k_ratio, (), minval=math.log(0.3),
                                       maxval=math.log(3.3)))
        h = jnp.clip(jnp.sqrt(a * r), 1.0, O)
        w = jnp.clip(jnp.sqrt(a / r), 1.0, O)
        return (jax.random.bernoulli(k_apply, prob),
                jnp.stack([jax.random.uniform(k_y, ()) * (O - h),
                           jax.random.uniform(k_x, ()) * (O - w), h, w]),
                jax.random.normal(k_noise, (O, O, 3), jnp.bfloat16).astype(
                    jnp.float32))
    return tuple(torch.from_numpy(np.array(t))
                 for t in jax.jit(jax.vmap(one))(keys))


def test_normalize_matches_jax():
    x = images(11)
    np.testing.assert_allclose(A.normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(JA.normalize(jnp.asarray(x))),
                               rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# whole transforms
# ---------------------------------------------------------------------------

TRAIN_CASES = [
    # S, O, use_randaug, hflip, crop_scale
    (40, 32, True, True, (0.08, 1.0)),
    (40, 32, True, True, (0.5, 1.0)),
    (40, 32, False, False, (0.5, 1.0)),
    (64, 56, True, False, (0.5, 1.0)),
    (64, 56, True, True, (0.08, 1.0)),
    (64, 56, False, True, (0.08, 1.0)),
]


@pytest.mark.parametrize("S,O,randaug,hflip,crop_scale", TRAIN_CASES)
def test_train_augment_matches_jax(S, O, randaug, hflip, crop_scale):
    errs = []
    for seed in range(3):
        x = images(20 + seed, S=S, integer=True)
        key = jax.random.PRNGKey(30 + seed)
        kw = dict(use_randaug=randaug, crop_scale=crop_scale, hflip=hflip)
        want = np.asarray(JA.train_augment_batch(
            key, jnp.asarray(x), out_size=O, re_prob=0.5, **kw))
        draws = jax_augment_draws(key, 4, S, O, re_prob=0.5, **kw)
        if not hflip:
            assert not draws.flip.any()
        got = A.apply_train_augment(torch.from_numpy(x), draws,
                                    out_size=O).numpy()
        assert got.shape == (4, O, O, 3) and got.dtype == np.float32
        errs.append(np.abs(got - want))
    e = np.concatenate([x.ravel() for x in errs])
    share = float((e > 1e-4).mean())
    if randaug:
        assert e.max() <= 4 * LSB and e.mean() <= 3e-5 and share <= 2e-3, \
            (e.max(), e.mean(), share)
    else:
        assert e.max() <= 2e-4 and share == 0.0, (e.max(), share)


@pytest.mark.parametrize("S,O", [(40, 32), (256, 224)])
def test_eval_preprocess_matches_jax(S, O):
    x = images(40, B=2, S=S, integer=True)
    want = np.asarray(JA.eval_preprocess_batch(jnp.asarray(x), out_size=O))
    got = A.eval_preprocess_batch(torch.from_numpy(x), O).numpy()
    assert got.shape == (2, O, O, 3)
    # 5e-3 in the 0..255 domain
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-3 / 255 / 0.224)
    if S == 256:
        # 256 -> 224 is a centre crop, no resample
        assert np.array_equal(got, A.normalize(torch.from_numpy(
            x[:, 16:240, 16:240].astype(np.float32))).numpy())


@pytest.mark.parametrize("randaug", [True, False])
def test_draws_shapes_ranges_and_determinism(randaug):
    def draw(seed, **kw):
        g = torch.Generator().manual_seed(seed)
        return A.draw_train_augment(g, 64, 40, 32, use_randaug=randaug,
                                    crop_scale=(0.3, 1.0), **kw)
    d = draw(0)
    y0, x0, h, w = d.crop.unbind(1)
    assert (h >= 8).all() and (h <= 40).all() and (w >= 8).all()
    assert (y0 >= 0).all() and (y0 + h <= 40 + 1e-4).all()
    assert (x0 >= 0).all() and (x0 + w <= 40 + 1e-4).all()
    assert d.noise.shape == (64, 32, 32, 3)
    assert torch.equal(d.noise, d.noise.to(torch.bfloat16).float())
    if randaug:
        assert d.jitter is None and d.ra_op.shape == (64, 2)
        assert (d.ra_op >= 0).all() and (d.ra_op < A.NUM_OPS).all()
        assert (d.ra_mag >= 0).all() and (d.ra_mag <= 10).all()
        assert set(d.ra_sign.unique().tolist()) <= {-1.0, 1.0}
    else:
        assert d.ra_op is None and d.jitter.shape == (64, 3)
        assert (d.jitter >= 0.6).all() and (d.jitter <= 1.4).all()
    again = draw(0)
    for a, b in zip(d, again):
        assert (a is None and b is None) or torch.equal(a, b)
    assert not draw(1, hflip=False).flip.any()
    assert draw(0).flip.any()
    x = torch.from_numpy(images(0, B=64, S=40, integer=True))
    out = A.apply_train_augment(x, d, out_size=32)
    assert out.shape == (64, 32, 32, 3) and torch.isfinite(out).all()
